"""HBM capacity estimator: how many TPU chips does a model need?

TPU-native analogue of the reference node estimator
(``pkg/workspace/estimator/nodesestimator/estimator.go:70``
EstimateNodeCount and the formula doc
``presets/workspace/generator/model-sku-calculation.md``).  The
reference computes a per-GPU memory budget
``gpuMem*0.84 - (2.3GiB + maxModelLen*bytesPerToken/gpuCount)`` and
divides expanded weights by it; we do the same accounting against a
chip's HBM, with TPU-appropriate constants, and round the answer up to
a *valid slice topology* instead of a VM count.

Differences from the reference, by design:

- XLA preallocates and manages HBM without torch/CUDA fragmentation, so
  the utilization cap is higher (0.92 vs 0.84).
- The fixed overhead covers the XLA runtime + compiled executables +
  collective scratch, not CUDA context + torch allocator slack.
- The answer is a topology (``"4x4"``) because TPUs provision in slice
  shapes, not node counts.

A copy of ``kaito_tpu.estimator.estimator`` with a GPU half.  For a
:class:`~kaito_tpu_torch.sku.catalog.GPUCardSpec` the same functions
size the port's engine on one node of cards:

- a card's budget is the engine's own sizing rule
  (``InferenceEngine._derive_max_pages``): its total less the reserve
  ``max(total x _RESERVE_FRACTION, _RESERVE_MIN_BYTES)``, imported from
  the engine so the two cannot drift, and less the CUDA context
  (:data:`CUDA_CONTEXT_BYTES`, measured on the card);
- weights are the bytes the engine holds, leaf by leaf from the model's
  own parameter specs (:func:`engine_weight_bytes`): int8 / int4 codes
  and their fp32 scales for the quantized projections under a
  ``quantization``, bf16 for everything else and, without one, for every
  parameter (a preset's own ``quantization``, mxfp4 for gpt-oss, is not
  what the port's engine loads);
- a token of KV costs what a page of the engine's pool costs, int8
  pages with their fp32 scale rows, and the pool holds whole pages;
- the answer is a card count of one node, 1, 2, 4 or 8, served at tensor
  parallelism over all of them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import _RESERVE_FRACTION, _RESERVE_MIN_BYTES
from kaito_tpu_torch.engine.kv_cache import scale_bytes_per_page
from kaito_tpu_torch.models.metadata import ModelMetadata
from kaito_tpu_torch.sku.catalog import GPUCardSpec, TPUChipSpec, topology_chips

GiB = 2**30

# TPU estimator constants (counterparts of estimator.go:34-59).
HBM_UTILIZATION = 0.92          # fraction of HBM the engine may plan for
WEIGHT_EXPANSION = 1.02         # loaded weights vs on-disk size
PER_CHIP_OVERHEAD_BYTES = int(1.25 * GiB)  # XLA runtime + programs + scratch
WEIGHT_OVERHEAD_FACTOR = 0.03   # proportional slack (buffers, donation gaps)

# Bytes per weight for supported quantization schemes.  Served int4
# (engine/quant.py) is packed nibbles + fp32 per-group scales at
# g=128: 0.5 + 4/128 = 0.53125 — same density as mxfp4's 4.25
# bits/weight, by coincidence of constants.
_QUANT_BYTES = {"": 2.0, "bf16": 2.0, "fp16": 2.0, "int8": 1.0, "fp8": 1.0,
                "mxfp4": 0.53125, "int4": 0.53125}


def weight_bytes(md: ModelMetadata, quantization: Optional[str] = None) -> int:
    """Loaded-weight bytes including expansion factor."""
    quant = md.quantization if quantization is None else quantization
    per_weight = _QUANT_BYTES.get(quant.lower(), 2.0)
    params = md.arch.param_count()
    return int(params * per_weight * WEIGHT_EXPANSION * (1 + WEIGHT_OVERHEAD_FACTOR))


@dataclass(frozen=True)
class SliceEstimate:
    """Result of sizing a model onto a chip generation."""

    chip: TPUChipSpec
    topology: str
    num_chips: int
    weights_bytes: int            # total, all chips
    kv_bytes_per_token: int       # all layers, un-sharded
    per_chip_budget: int          # usable HBM per chip
    kv_budget_bytes: int          # slice-wide bytes left for KV cache
    max_kv_tokens: int            # total KV tokens the slice can hold

    @property
    def per_chip_weights(self) -> int:
        return self.weights_bytes // max(self.num_chips, 1)


def _per_chip_budget(chip: TPUChipSpec) -> int:
    return int(chip.hbm_bytes * HBM_UTILIZATION) - PER_CHIP_OVERHEAD_BYTES


def estimate_chip_count(
    md: ModelMetadata,
    chip: TPUChipSpec,
    *,
    max_model_len: Optional[int] = None,
    kv_dtype_bytes: int = 2,
    quantization: Optional[str] = None,
) -> int:
    """Minimum chips such that weights (sharded) plus the KV cache of at
    least one max-length sequence fit (reference requirement:
    ``estimator.go:153`` — a GPU must hold its weight shard AND its share
    of one full-context KV)."""
    if isinstance(chip, GPUCardSpec):
        return _gpu_fit(md, chip, max_model_len or md.max_model_len,
                        kv_dtype_bytes, quantization or "", 1)[0]
    budget = _per_chip_budget(chip)
    if budget <= 0:
        raise ValueError(f"chip {chip.generation} has no usable HBM budget")
    w = weight_bytes(md, quantization)
    ctx = max_model_len or md.max_model_len
    kv_one_seq = ctx * md.kv_bytes_per_token(kv_dtype_bytes)
    chips = math.ceil((w + kv_one_seq) / budget)
    return max(chips, 1)


def estimate_slice(
    md: ModelMetadata,
    chip: TPUChipSpec,
    *,
    max_model_len: Optional[int] = None,
    kv_dtype_bytes: int = 2,
    quantization: Optional[str] = None,
    min_chips: int = 1,
) -> SliceEstimate:
    """Size the model onto the smallest valid slice topology of ``chip``.

    Raises if no topology of this generation can hold the model (the
    reference errors when a model cannot distribute; we do the same
    rather than silently spilling to host memory).
    """
    if isinstance(chip, GPUCardSpec):
        return _estimate_gpu_slice(md, chip, max_model_len or md.max_model_len,
                                   kv_dtype_bytes, quantization or "", min_chips)
    need = max(min_chips, estimate_chip_count(
        md, chip, max_model_len=max_model_len,
        kv_dtype_bytes=kv_dtype_bytes, quantization=quantization))
    topology = chip.topology_for_chips(need)
    if topology is None:
        raise ValueError(
            f"model {md.name!r} needs {need} {chip.generation} chips; largest "
            f"valid slice is {chip.valid_topologies[-1]} "
            f"({topology_chips(chip.valid_topologies[-1])} chips)"
        )
    n = topology_chips(topology)
    budget = _per_chip_budget(chip)
    w = weight_bytes(md, quantization)
    kv_budget = n * budget - w
    bpt = md.kv_bytes_per_token(kv_dtype_bytes)
    return SliceEstimate(
        chip=chip,
        topology=topology,
        num_chips=n,
        weights_bytes=w,
        kv_bytes_per_token=bpt,
        per_chip_budget=budget,
        kv_budget_bytes=max(kv_budget, 0),
        max_kv_tokens=max(kv_budget, 0) // bpt if bpt else 0,
    )


def max_kv_tokens(
    md: ModelMetadata,
    chip: TPUChipSpec,
    num_chips: int,
    *,
    kv_dtype_bytes: int = 2,
    quantization: Optional[str] = None,
) -> int:
    """KV token capacity of a given chip count (drives the engine's page
    pool size and the benchmark probe's concurrency derivation, the way
    the reference reads vLLM's KV-capacity gauges)."""
    if isinstance(chip, GPUCardSpec):
        return _gpu_kv_tokens(md, chip, num_chips, kv_dtype_bytes, quantization or "")
    budget = num_chips * _per_chip_budget(chip) - weight_bytes(md, quantization)
    bpt = md.kv_bytes_per_token(kv_dtype_bytes)
    return max(budget, 0) // bpt if bpt else 0


# ----------------------------------------------------------------------
# The GPU half: the port's engine on one node of cards
# ----------------------------------------------------------------------

#: device memory an engine's process holds beside its weights when the
#: engine sizes its pool: the CUDA context (``total - free - reserved``
#: after a fresh process's first allocation: 648937472 bytes) with the
#: kernels and libraries it has loaded, and the engine's other tensors.
#: All told 930226176 bytes for TinyLlama-1.1B with int8 weights in a
#: fresh process; 914743296 (Llama-3.1-8B bf16, phase 4) to 1326653440
#: (TinyLlama int8, phase 18, the last) in ``chip_smoke.py``'s whole
#: run, whose context grows with every kernel it loads; rounded up.
#: NVIDIA H100 80GB HBM3 at 700 W, torch 2.11.0+cu128 (PERF.md)
CUDA_CONTEXT_BYTES = 3 * GiB // 2

_PARAM_BYTES = 2        # bf16


def gpu_card_budget(card: GPUCardSpec) -> int:
    """What one card leaves for weights and KV: the engine's reserve and
    the CUDA context come off its total."""
    total = card.hbm_bytes
    reserve = max(int(total * _RESERVE_FRACTION), _RESERVE_MIN_BYTES)
    return total - reserve - CUDA_CONTEXT_BYTES


_WEIGHT_BYTES: dict[tuple, int] = {}


def engine_weight_bytes(md: ModelMetadata, quantization: str = "", tp: int = 1) -> int:
    """Bytes of parameters one card of a ``tp``-way engine holds for
    ``md`` under ``quantization`` ("" bf16, "int8", "int4"): every leaf
    of the model's parameter specs, the quantized projections as codes
    plus fp32 scales (:mod:`engine.quant`), a tensor-parallel leaf cut
    as ``shard_leaf`` cuts it (the embedding and the norms whole on every
    card).  At ``tp`` = 1 it equals ``model.param_bytes()`` of the loaded
    engine."""
    key = (repr(md.arch), quantization, tp)
    if key not in _WEIGHT_BYTES:
        _WEIGHT_BYTES[key] = _engine_weight_bytes(md, quantization, tp)
    return _WEIGHT_BYTES[key]


def _engine_weight_bytes(md: ModelMetadata, quantization: str, tp: int) -> int:
    import torch

    from kaito_tpu_torch.engine.model import (
        _REPLICATED, LOGICAL_AXES, TransformerLM, _shard_dim)
    from kaito_tpu_torch.engine.quant import (
        INT4_GROUP, is_quantized_leaf, qtensor_logical_axes)

    spec = TransformerLM(md.arch, dtype=torch.bfloat16, device="cpu")

    def part(count: int, el: float, logical: tuple, whole: bool = False) -> float:
        if whole or tp == 1 or _shard_dim(logical) is None:
            return count * el
        return count * el / tp

    total = 0.0
    for name, shape in spec._top_specs().items():
        total += part(math.prod(shape), _PARAM_BYTES, LOGICAL_AXES[name],
                      whole=name in _REPLICATED)
    for g in spec.groups:
        for name, shape in spec._layer_specs(g.moe).items():
            full = (g.count,) + tuple(shape)
            ax = ("layers",) + LOGICAL_AXES[name]
            n = math.prod(full)
            if not (quantization and is_quantized_leaf(g.name, name)):
                total += part(n, _PARAM_BYTES, ax)
                continue
            axes = qtensor_logical_axes(ax, quantization)
            k, out = full[-2], full[-1]
            lead = n // (k * out)
            if quantization == "int8":
                total += part(n, 1, axes["q8"]) + part(lead * out, 4, axes["scale"])
            else:
                groups = k // INT4_GROUP if k % INT4_GROUP == 0 else 1
                total += part(n, 0.5, axes["q4"]) + part(lead * groups * out, 4,
                                                        axes["scale"])
    return int(math.ceil(total))


def gpu_page_bytes(md: ModelMetadata, kv_dtype_bytes: int = 2,
                   page_size: int = EngineConfig.page_size) -> int:
    """Device bytes of one page of the engine's KV pool, all layers and
    KV heads: int8 pages carry their fp32 scale rows."""
    page = md.kv_bytes_per_token(kv_dtype_bytes) * page_size
    if kv_dtype_bytes == 1:
        page += scale_bytes_per_page(md.arch)
    return page


def _gpu_kv_tokens(md: ModelMetadata, card: GPUCardSpec, n: int,
                   kv_dtype_bytes: int, quantization: str) -> int:
    """KV tokens ``n`` cards hold after their weights, in whole pages of
    the engine's default page size (each card holds 1/n of every page)."""
    room = n * (gpu_card_budget(card) - engine_weight_bytes(md, quantization, n))
    page = gpu_page_bytes(md, kv_dtype_bytes)
    return max(room, 0) // page * EngineConfig.page_size


def _gpu_fit(md: ModelMetadata, card: GPUCardSpec, ctx: int, kv_dtype_bytes: int,
             quantization: str, min_chips: int) -> tuple[int, str]:
    """(cards, topology) of the fewest cards of ``card``'s node, at least
    ``min_chips``, whose per-card weights and share of one ``ctx``-token
    sequence's pages fit each card's budget."""
    budget = gpu_card_budget(card)
    page = gpu_page_bytes(md, kv_dtype_bytes)
    one_seq = -(-ctx // EngineConfig.page_size) * page
    for topo in sorted(card.valid_topologies, key=topology_chips):
        n = topology_chips(topo)
        if n < min_chips:
            continue
        if engine_weight_bytes(md, quantization, n) + -(-one_seq // n) <= budget:
            return n, topo
    largest = max(card.valid_topologies, key=topology_chips)
    raise ValueError(
        f"model {md.name!r} needs more than the {topology_chips(largest)} "
        f"{card.generation} cards of one node; serving across nodes is not "
        f"ported (ROADMAP queue 1, M19 multi-GPU)")


def _estimate_gpu_slice(md: ModelMetadata, card: GPUCardSpec, ctx: int,
                        kv_dtype_bytes: int, quantization: str,
                        min_chips: int) -> SliceEstimate:
    n, topo = _gpu_fit(md, card, ctx, kv_dtype_bytes, quantization, min_chips)
    budget = gpu_card_budget(card)
    w = engine_weight_bytes(md, quantization, n)
    return SliceEstimate(
        chip=card, topology=topo, num_chips=n, weights_bytes=w * n,
        kv_bytes_per_token=gpu_page_bytes(md, kv_dtype_bytes) // EngineConfig.page_size,
        per_chip_budget=budget, kv_budget_bytes=max(n * (budget - w), 0),
        max_kv_tokens=_gpu_kv_tokens(md, card, n, kv_dtype_bytes, quantization))
