"""Parallelism planner: model + chip generation → JAX device mesh spec.

The TPU-native redesign of the reference's parallelism tiering
(``pkg/model/interface.go:500`` configureParallelism): where the
reference picks ``--data-parallel-size``/``--tensor-parallel-size``/
``--pipeline-parallel-size`` flags for vLLM and bootstraps Ray, we emit
a named device-mesh spec (data/fsdp/expert/sequence/tensor axes, plus a
pipeline axis over DCN for multi-slice) that the engine and trainer jit
over with GSPMD shardings.

Tiering, TPU-first (SURVEY.md §2.3 "TPU-native mapping"):

1. model fits one chip           -> pure DP (data axis = chips)
2. model fits one slice          -> TP over ICI across the whole slice
                                    (TPU ICI makes slice-wide TP viable
                                    where GPUs needed PP between hosts)
3. model exceeds largest slice   -> PP over DCN between slices, TP inside
4. long-context training/serving -> sequence axis (ring attention over ICI)
5. MoE                           -> expert axis carved out of the TP group

A copy of ``kaito_tpu.parallel.plan`` with a GPU half: a plan on a
:class:`~kaito_tpu_torch.sku.catalog.GPUCardSpec` is one that the port's
server accepts.  Its cards are 1, 2, 4 or 8 of one node, the fewest that
hold the model (the estimator's GPU half), with the tensor axis over all
of them and every other axis 1: the port refuses a data, pipeline,
sequence or expert degree above 1 (``engine.check_ported``).  A model
that needs more than one node, or a tensor degree the engine refuses
(``engine.model.check_tensor_parallel``: MoE or MLA at TP >= 2, widths
that do not divide), is a ValueError at plan time naming its ROADMAP
item, so a Workspace fails its plan instead of crash-looping a pod.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

from kaito_tpu_torch.estimator.estimator import SliceEstimate, estimate_slice, weight_bytes
from kaito_tpu_torch.models.metadata import ModelMetadata
from kaito_tpu_torch.sku.catalog import GPUCardSpec, TPUChipSpec, topology_chips

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_EXPERT = "expert"
AXIS_SEQUENCE = "sequence"
AXIS_TENSOR = "tensor"
AXIS_PIPELINE = "pipeline"

# Mesh axis order: outermost (DCN-adjacent) first, tensor innermost so
# TP collectives ride the fastest contiguous ICI rings.
MESH_AXIS_ORDER = (AXIS_PIPELINE, AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_SEQUENCE, AXIS_TENSOR)


@dataclass(frozen=True)
class MeshSpec:
    """Named logical mesh. Sizes multiply to the device count."""

    axes: tuple[tuple[str, int], ...]

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self.axes)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(s for _, s in self.axes)

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)

    def size(self, name: str) -> int:
        for n, s in self.axes:
            if n == name:
                return s
        return 1

    def __str__(self) -> str:
        return "x".join(f"{n}:{s}" for n, s in self.axes)


def make_mesh_spec(**sizes: int) -> MeshSpec:
    """Build a MeshSpec in canonical axis order, keeping size-1 axes so
    jitted code can reference every axis name unconditionally."""
    axes = tuple((name, int(sizes.get(name, 1))) for name in MESH_AXIS_ORDER)
    return MeshSpec(axes=axes)


@dataclass(frozen=True)
class ParallelPlan:
    """Everything the workload generator and engine need to lay the
    model out on TPU hardware."""

    model: str
    chip: TPUChipSpec
    topology: str                # topology of ONE slice
    num_slices: int              # >1 => pipeline over DCN
    mesh: MeshSpec               # global mesh including pipeline axis
    estimate: SliceEstimate
    max_model_len: int
    workload: str                # "serve" | "train"
    notes: tuple[str, ...] = ()

    @property
    def chips_per_slice(self) -> int:
        return topology_chips(self.topology)

    @property
    def total_chips(self) -> int:
        return self.chips_per_slice * self.num_slices

    @property
    def num_hosts(self) -> int:
        return self.chip.hosts_for_topology(self.topology) * self.num_slices


def _largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of n that is <= cap."""
    best = 1
    for d in range(1, int(math.isqrt(n)) + 1):
        if n % d == 0:
            for cand in (d, n // d):
                if cand <= cap and cand > best:
                    best = cand
    return best


def _choose_tp(md: ModelMetadata, chips: int, needed: int) -> tuple[int, bool]:
    """Smallest TP degree that (a) divides the chip count, (b) gives the
    model enough HBM (>= ``needed`` chips per group), preferring degrees
    that divide the query-head count.  Returns (tp, padded_heads)."""
    heads = md.arch.num_heads
    divisors = [d for d in range(1, chips + 1) if chips % d == 0]
    for d in divisors:
        if d >= needed and heads % d == 0:
            return d, False
    for d in divisors:  # model must fit: accept head padding
        if d >= needed:
            return d, True
    return chips, heads % chips != 0


def plan_parallelism(
    md: ModelMetadata,
    chip: TPUChipSpec,
    *,
    workload: str = "serve",
    max_model_len: Optional[int] = None,
    target_chips: Optional[int] = None,
    kv_dtype_bytes: int = 2,
    quantization: Optional[str] = None,
    max_pipeline_stages: int = 8,
    cp_autocarve: bool = False,
) -> ParallelPlan:
    """Plan mesh + slice shape for a model on a chip generation.

    ``target_chips`` (user's requested capacity, the analogue of the
    Workspace ``resource.count`` x instance size) raises the floor; the
    planner never returns fewer chips than the model needs.

    ``cp_autocarve`` opts the SERVE path into carving a sequence axis
    (ring-attention context-parallel prefill) at >= 32k context.  It
    defaults OFF on measured evidence: BENCH_r05 shows
    ``cp_speedup_seq4_vs_chunked = 0.68`` — CP prefill LOSES to chunked
    prefill on the current kernel, so auto-carving would spend chips to
    get slower.  Flip the default only once a benchmark round measures
    ``cp_speedup_vs_chunked >= 1.0`` on real hardware (the train-path
    carve is unaffected: ring attention there overlaps with grad
    compute and is not subject to this evidence gate).
    """
    ctx = max_model_len or md.max_model_len
    if isinstance(chip, GPUCardSpec):
        return _plan_gpu(md, chip, workload=workload, ctx=ctx,
                         target_chips=target_chips, kv_dtype_bytes=kv_dtype_bytes,
                         quantization=quantization)
    notes: list[str] = []

    single = None
    try:
        single = estimate_slice(
            md, chip, max_model_len=ctx, kv_dtype_bytes=kv_dtype_bytes,
            quantization=quantization, min_chips=target_chips or 1)
    except ValueError:
        pass

    if single is not None:
        num_slices = 1
        est = single
    else:
        # Tier 3: pipeline over DCN. Each stage holds layers/k, so the
        # per-slice requirement shrinks ~linearly in the stage count.
        est = None
        num_slices = 0
        for k in range(2, max_pipeline_stages + 1):
            if md.arch.num_layers % k != 0:
                continue
            stage_md = md.with_overrides(
                arch=_scale_layers(md.arch, md.arch.num_layers // k))
            try:
                est = estimate_slice(
                    stage_md, chip, max_model_len=ctx,
                    kv_dtype_bytes=kv_dtype_bytes, quantization=quantization)
                num_slices = k
                notes.append(f"pipeline over DCN: {k} stages of {md.arch.num_layers // k} layers")
                break
            except ValueError:
                continue
        if est is None:
            raise ValueError(
                f"model {md.name!r} does not fit {max_pipeline_stages} "
                f"pipeline stages of the largest {chip.generation} slice")

    chips = est.num_chips
    # TP degree is driven by what the model *needs*, not by total
    # capacity: surplus chips become data parallelism (tier 1) instead of
    # widening TP past its useful point (reference tiering:
    # interface.go:500-532 picks DP when the model fits a fraction of the
    # hardware).
    if num_slices == 1:
        from kaito_tpu_torch.estimator.estimator import estimate_chip_count

        needed = estimate_chip_count(
            md, chip, max_model_len=ctx, kv_dtype_bytes=kv_dtype_bytes,
            quantization=quantization)
    else:
        needed = chips
    tp, padded = _choose_tp(md, chips, min(chips, needed))
    if padded:
        notes.append(f"tp={tp} does not divide {md.arch.num_heads} heads: engine pads heads")
    leftover = chips // tp

    expert = 1
    seq = 1
    if workload == "train":
        # FSDP everything that is not TP; carve sequence axis for long ctx.
        if ctx >= 32768 and leftover >= 2:
            seq = 2
            while seq * 2 <= leftover and ctx // (seq * 2) >= 8192:
                seq *= 2
            leftover //= seq
            notes.append(f"sequence parallelism (ring attention) degree {seq}")
        if md.arch.num_experts > 0 and leftover >= 2:
            expert = _largest_divisor_leq(leftover, min(leftover, md.arch.num_experts))
            leftover //= expert
            notes.append(f"expert parallelism degree {expert}")
        mesh = make_mesh_spec(pipeline=num_slices, fsdp=leftover, expert=expert,
                              sequence=seq, tensor=tp)
    else:
        # Serving: long contexts first carve a sequence axis (ring
        # attention CP prefill — TTFT for a 32k+ prompt scales ~1/seq
        # while decode stays TP); the rest becomes independent
        # data-parallel engine replicas (tier 1 when tp == 1).
        # (single-slice only: the pipeline serving executor owns its
        # mesh and has no sequence axis — carving one there would
        # reserve chips the engine never uses)
        # opt-in only (cp_autocarve): see the evidence gate in the
        # docstring — BENCH_r05 measured CP prefill at 0.68x chunked
        if cp_autocarve and ctx >= 32768 and leftover >= 2 \
                and num_slices == 1 \
                and md.arch.attention_kind.value != "MLA":
            seq = 2
            while seq * 2 <= leftover and ctx // (seq * 2) >= 8192:
                seq *= 2
            leftover //= seq
            notes.append(f"context-parallel prefill (ring attention) degree {seq}")
        mesh = make_mesh_spec(pipeline=num_slices, data=leftover,
                              sequence=seq, tensor=tp)
        if leftover > 1:
            notes.append(f"data parallel serving: {leftover} engine groups of tp={tp}")

    if tp > md.arch.num_kv_heads and md.arch.num_kv_heads > 0:
        notes.append(
            f"tp={tp} exceeds kv_heads={md.arch.num_kv_heads}: KV heads replicate "
            f"{tp // md.arch.num_kv_heads}x")

    return ParallelPlan(
        model=md.name,
        chip=chip,
        topology=est.topology,
        num_slices=num_slices,
        mesh=mesh,
        estimate=est,
        max_model_len=ctx,
        workload=workload,
        notes=tuple(notes),
    )


def _plan_gpu(md: ModelMetadata, card: GPUCardSpec, *, workload: str, ctx: int,
              target_chips: Optional[int], kv_dtype_bytes: int,
              quantization: Optional[str]) -> ParallelPlan:
    """The port's engine on the fewest cards of one node that hold the
    model (at least ``target_chips``), tensor-parallel over all of them;
    the trainer on one card."""
    from kaito_tpu_torch.engine.model import check_tensor_parallel

    est = estimate_slice(md, card, max_model_len=ctx, kv_dtype_bytes=kv_dtype_bytes,
                         quantization=quantization, min_chips=target_chips or 1)
    n = est.num_chips
    if workload == "train":
        if n > 1:
            raise ValueError(
                f"model {md.name!r} needs {n} {card.generation} cards to train; the "
                f"port's trainer runs on one card (ROADMAP queue 1, M19: the "
                f"trainer on a mesh)")
        mesh = make_mesh_spec()
        notes = ("one card",)
    else:
        try:
            check_tensor_parallel(md.arch, n, quantization or "")
        except (NotImplementedError, ValueError) as e:
            raise ValueError(f"model {md.name!r} needs {n} {card.generation} "
                             f"cards: {e}") from None
        mesh = make_mesh_spec(tensor=n)
        notes = (f"tensor parallel over {n} card(s) of one node",)
    return ParallelPlan(model=md.name, chip=card, topology=est.topology, num_slices=1,
                        mesh=mesh, estimate=est, max_model_len=ctx,
                        workload=workload, notes=notes)


def _scale_layers(arch, num_layers: int):
    from dataclasses import replace

    return replace(arch, num_layers=num_layers)
