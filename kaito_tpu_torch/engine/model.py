"""Config-driven transformer LM: dense GQA, MLA and token-choice MoE families.

Counterpart of ``kaito_tpu.engine.model``.  Parameters keep the JAX
package's stacked layout — one ``[num_layers, ...]`` tensor per layer
weight, ``[in, out]`` projections — held in an ``nn.Module``; the JAX
layer scan becomes a Python loop over layers that reads each layer as a
view of the stack and writes the KV page pools in place.

Attention goes through the kernel wrappers of ``engine.ops``: the
Hopper kernels for tensors on the card, their plain versions for
tensors on the CPU.  Prompt chunks that follow earlier chunks use
``attention.paged_context_attention``, which has no kernel.

Under weight quantization (``engine.quant``) each layer stack's
projections are QTensor dicts ``{"q8"|"q4": int8, "scale": fp32}`` that
``nn.linear`` routes to the fused dequant matmul; with an int8 KV cache
the page writes take their quantizing ``_q`` forms and attention reads
the pages with their scales.

A MoE layer group (``_layer_groups``: all layers, or the layers from
``moe_layer_start`` on after a dense group) replaces the MLP with routed
expert stacks ``[L, X, in, out]`` (``nn.moe_mlp_ragged``).  How the
expert products run is :data:`TransformerLM.moe_impl`, fixed by device
and dtype (:func:`moe_impl_for`).

MLA (DeepSeek-style latent attention, ``arch.kv_lora_rank`` set)
replaces q/k/v with the latent projections of ``_layer_specs``: one
latent stream ``[c_kv ; k_rope]`` is written to the pool and attention
runs through the three ``attention.mla_*`` functions (plain torch, as
the JAX package computes them), with rope tables over
``qk_rope_head_dim``.  Its prompts never segment-pack.

Prompt scoring (:meth:`TransformerLM.score`, the JAX engine's
cache-less ``"train"`` forward) runs every layer over one fresh row,
its attention through the flash prefill kernel (MLA: the plain
``attention.mla_prefill_attention``), and writes no page.

Training (:meth:`TransformerLM.forward_train`, mode ``"train"``) is the
JAX model's ``forward_train``: a cache-less forward whose attention is
the differentiable ``attention.prefill_attention`` (never the flash
kernel, which has no backward), whose projections add the
training-form LoRA update of ``{t}_lora_a`` / ``{t}_lora_b`` stacks
(``tuning.lora.add_lora_params``) times ``lora_scaling``, whose MoE
layers take the dense form (the JAX trainer's), and whose layers are
rematerialized in the backward (``torch.utils.checkpoint``).  As in the
JAX package, MLA's attention projections take no LoRA update there.

Rope takes the linear, llama3, yarn and longrope scalings.  A longrope
model with factor lists picks its table per position (``_rope_select``):
positions past ``original_max_position_embeddings`` take the long
factors, by a ``torch.where`` on the positions tensor, so a decode
window captured in a CUDA graph switches tables as its sequences grow.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch
from torch import nn as tnn
from torch.utils.checkpoint import checkpoint

from kaito_tpu_torch.device import resolve_device
from kaito_tpu_torch.engine import attention as attn
from kaito_tpu_torch.engine import nn
from kaito_tpu_torch.engine.devprof import profiler_range
from kaito_tpu_torch.engine.kv_cache import (
    KVCache, write_decode_tokens, write_decode_tokens_q,
    write_packed_prefill_tokens, write_packed_prefill_tokens_q,
    write_prefill_tokens, write_prefill_tokens_q)
from kaito_tpu_torch.engine.ops.decode_attention import \
    paged_decode_attention_cuda
from kaito_tpu_torch.engine.ops.flash_prefill import (
    flash_prefill_attention_cuda, flash_prefill_packed_cuda)
from kaito_tpu_torch.engine.ops.overlap_collectives import (
    ag_matmul_eligible, all_gather_matmul, overlap_linear, psum_linear)
from kaito_tpu_torch.engine.quant import (INT4_GROUP, is_qtensor,
                                          is_quantized_leaf,
                                          qtensor_logical_axes, quantize_weight)
from kaito_tpu_torch.engine.sampler import chosen_logprob
from kaito_tpu_torch.models.metadata import AttentionKind, ModelArch
from kaito_tpu_torch.parallel.mesh import AXIS_TENSOR, Mesh
from kaito_tpu_torch.parallel.sharding import SERVE_RULES

VOCAB_ALIGN = 128
_BIG_WINDOW = 1 << 30
# positions a scoring forward projects onto the vocabulary at a time, so
# its [T, V] fp32 logits never exist whole
SCORE_CHUNK = 128


def _name_salt(name: str) -> int:
    """Stable per-parameter seed salt (Python's hash() is salted per
    process)."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


@dataclass(frozen=True)
class LayerGroup:
    name: str          # "dense" | "moe"
    start: int
    count: int
    moe: bool


def _layer_groups(arch: ModelArch) -> tuple[LayerGroup, ...]:
    if arch.num_experts > 0 and arch.moe_layer_start > 0:
        k = arch.moe_layer_start
        return (LayerGroup("dense", 0, k, False),
                LayerGroup("moe", k, arch.num_layers - k, True))
    if arch.num_experts > 0:
        return (LayerGroup("moe", 0, arch.num_layers, True),)
    return (LayerGroup("dense", 0, arch.num_layers, False),)


def moe_impl_for(device: torch.device, dtype: torch.dtype) -> str:
    """How a MoE layer computes its expert products, with the JAX
    engine's ragged semantics (``moe_impl="ragged"`` at
    ``expert_parallel == 1``), in prefill and decode alike:

    - the CPU: "ragged", one fp32 product per non-empty group, sized on
      the host (:func:`nn.moe_mlp_ragged`), the JAX package's numbers;
    - the card in bf16: "grouped", one ``torch._grouped_mm`` over groups
      whose bounds stay on the device, so a captured decode window holds
      it and a decode step reads only the experts its active rows chose
      (PERF.md times it against the dense form at gpt-oss-20b's rows);
    - the card in fp32: "dense" (:func:`nn.moe_mlp`), every token through
      every expert: ``torch._grouped_mm`` takes bf16 only on the card,
      and in fp32 the dense form's numbers are the ragged form's up to
      the order of sums."""
    if device.type == "cpu":
        return "ragged"
    return "grouped" if dtype == torch.bfloat16 else "dense"


def _to_torch(a) -> torch.Tensor:
    """numpy array (bfloat16 included, via its bits) -> CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(np_tree: dict, arch: ModelArch) -> dict:
    """The JAX param pytree, passed as numpy arrays (``jax.tree.map(
    np.asarray, params)``), as this port's parameter tree: the same
    names and the same stacked groups of ``_layer_groups``, as CPU
    tensors.  A tree from ``quantize_params`` keeps its QTensor dicts:
    int8 codes stay int8 and scales fp32.  The per-request adapter stacks
    (``serve_lora``: {group: {f"{t}_a": [L, lanes, in, rmax], f"{t}_b":
    [L, lanes, rmax, out]}}) come along as they are.  Feed it to
    :meth:`TransformerLM.load_params`."""
    out: dict = {}
    for key, val in np_tree.items():
        if isinstance(val, dict):
            out[key] = {n: ({k: _to_torch(x) for k, x in a.items()}
                            if isinstance(a, dict) else _to_torch(a))
                        for n, a in val.items()}
        else:
            out[key] = _to_torch(val)
    names = {g.name for g in _layer_groups(arch)}
    missing = names - set(out)
    if missing:
        raise KeyError(f"param tree lacks layer groups {sorted(missing)}")
    return out


def _check_qtensor(name: str, w: dict, full: tuple) -> None:
    """A QTensor for a ``full`` = [L, ..., in, out] weight (a layer stack
    [L, in, out] or an expert stack [L, X, in, out]): int8 codes of the
    full shape ("q8") or [..., in/2, out] ("q4"), fp32 scales
    [..., out] or [..., G, out] over whole groups."""
    lead, K, N = tuple(full[:-2]), full[-2], full[-1]
    if "q8" in w:
        codes, want, sshape = w["q8"], tuple(full), lead + (N,)
    else:
        codes, want = w["q4"], lead + (K // 2, N)
        G = w["scale"].shape[-2] if w["scale"].dim() == len(full) else 0
        sshape = lead + (G, N) if G and K % G == 0 and (K // G) % 2 == 0 else None
    if codes.dtype != torch.int8 or tuple(codes.shape) != want \
            or w["scale"].dtype != torch.float32 or sshape is None \
            or tuple(w["scale"].shape) != sshape:
        raise ValueError(
            f"param {name!r}: QTensor codes {codes.dtype} {tuple(codes.shape)}, "
            f"scale {w['scale'].dtype} {tuple(w['scale'].shape)} do not fit "
            f"the weight {full}")


# logical axes of every parameter (layer-stack names without the leading
# "layers" axis), as the JAX package's _top_specs/_layer_specs name them
LOGICAL_AXES: dict[str, tuple] = {
    "embed": ("vocab", "embed"), "lm_head": ("vocab", "embed"),
    "final_norm": ("embed",), "final_norm_bias": ("embed",),
    "attn_norm": ("embed",), "attn_norm_bias": ("embed",),
    "mlp_norm": ("embed",), "mlp_norm_bias": ("embed",),
    "post_attn_norm": ("embed",), "post_mlp_norm": ("embed",),
    "q": ("embed", "heads"), "k": ("embed", "kv_heads"),
    "v": ("embed", "kv_heads"), "o": ("heads", "embed"),
    "q_bias": ("heads",), "k_bias": ("kv_heads",), "v_bias": ("kv_heads",),
    "o_bias": ("embed",), "q_norm": (None,), "k_norm": (None,),
    "gate": ("embed", "intermediate"), "up": ("embed", "intermediate"),
    "down": ("intermediate", "embed"), "up_bias": ("intermediate",),
    "down_bias": ("embed",),
    "router": ("embed", "expert"),
    "experts_gate": ("expert", "embed", "intermediate"),
    "experts_up": ("expert", "embed", "intermediate"),
    "experts_down": ("expert", "intermediate", "embed"),
    "shared_gate": ("embed", "intermediate"),
    "shared_up": ("embed", "intermediate"), "shared_down": ("intermediate", "embed"),
    "q_a": ("embed", None), "q_a_norm": (None,), "q_b": (None, "heads"),
    "kv_a": ("embed", None), "kv_a_norm": (None,),
    "kv_b_k": (None, "heads"), "kv_b_v": (None, "heads"),
}

# the embedding stays replicated on every shard: the lookup is exact
# either way, and a vocab-sharded table would need a gather per token
_REPLICATED = ("embed",)

# per-request LoRA targets: every projection of a dense layer, the
# attention projections of a MoE layer (its experts have no sites); an
# MLA layer has none (``kaito_tpu.engine.adapters``)
LORA_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")
LORA_TARGETS_MOE = ("q", "k", "v", "o")
# row-parallel targets (their A splits on its in rows under tensor
# parallelism); the others are column-parallel (their B splits on out)
_LORA_ROW = ("o", "down")


def lora_shard(t: str, which: str, x: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """Shard ``r`` of ``n`` of a LoRA factor of target ``t`` (``which`` "a"
    [..., in, rank] or "b" [..., rank, out]): a column-parallel target's
    B by out columns, a row-parallel target's A by in rows, the other
    factor whole."""
    if n == 1:
        return x
    if which == "b" and t not in _LORA_ROW:
        return x.chunk(n, dim=-1)[r]
    if which == "a" and t in _LORA_ROW:
        return x.chunk(n, dim=-2)[r]
    return x


def local_arch(arch: ModelArch, n: int) -> ModelArch:
    """The architecture one of ``n`` tensor-parallel shards computes:
    heads, KV heads and the intermediate width divided by ``n``; hidden
    size, head_dim and vocabulary unchanged."""
    for what, v in (("num_heads", arch.num_heads),
                    ("num_kv_heads", arch.num_kv_heads),
                    ("intermediate_size", arch.intermediate_size)):
        if v % n:
            raise ValueError(f"tensor_parallel={n} does not divide "
                             f"{what}={v}")
    return replace(arch, num_heads=arch.num_heads // n,
                   num_kv_heads=arch.num_kv_heads // n,
                   intermediate_size=arch.intermediate_size // n)


def check_tensor_parallel(arch: ModelArch, n: int, quantization: str = "") -> None:
    """Raise ValueError when ``n`` shards cannot split this model: heads,
    KV heads, intermediate width and the padded vocabulary must divide,
    and under int4 every shard of the row-parallel o and down weights
    must own whole groups of ``INT4_GROUP`` in-rows.  An MLA or MoE
    model at ``n`` > 1 raises NotImplementedError: the latent pool and
    the expert stacks have no split yet."""
    if n > 1 and arch.attention_kind == AttentionKind.MLA:
        raise NotImplementedError(
            f"tensor_parallel={n} with MLA attention: the latent pool and its "
            f"heads have no tensor-parallel split yet (ROADMAP queue 1, M17 "
            f"item 40: MLA at TP >= 2)")
    if n > 1 and arch.num_experts > 0:
        raise NotImplementedError(
            f"tensor_parallel={n} with a MoE model: the expert stacks have no "
            f"tensor-parallel split yet (ROADMAP queue 1, M17 item 38: MoE at "
            f"TP >= 2 and the expert axis)")
    local_arch(arch, n)
    vp = -(-arch.vocab_size // VOCAB_ALIGN) * VOCAB_ALIGN
    if vp % n:
        raise ValueError(f"tensor_parallel={n} does not divide the padded "
                         f"vocabulary {vp}")
    if quantization == "int4":
        for name, k in (("o", arch.num_heads * arch.head_dim),
                        ("down", arch.intermediate_size)):
            if k % INT4_GROUP or (k // INT4_GROUP) % n:
                raise ValueError(
                    f"int4 weights at tensor_parallel={n}: each shard of "
                    f"{name!r} would hold {k // n} of its {k} in-rows, not "
                    f"whole groups of {INT4_GROUP}")


def _shard_dim(logical: tuple) -> Optional[int]:
    """The dim SERVE_RULES splits over the tensor axis, or None."""
    for i, a in enumerate(SERVE_RULES.spec(logical)):
        if a == AXIS_TENSOR or (isinstance(a, tuple) and AXIS_TENSOR in a):
            return i
    return None


def shard_leaf(group: Optional[str], name: str, t, n: int) -> list:
    """The ``n`` tensor-parallel shards of one leaf (plain or QTensor) of
    a full parameter tree, cut by SERVE_RULES: q/k/v/gate/up on their
    out dim, o/down on their contraction dim, lm_head on vocab; int8
    scales of the row-parallel weights replicated, int4 scale rows
    following their groups.  The embedding and the norms are
    replicated.  Shards are contiguous copies on ``t``'s device."""
    ax = LOGICAL_AXES[name] if group is None else ("layers",) + LOGICAL_AXES[name]
    if group is None and name in _REPLICATED:
        return [t] * n
    if is_qtensor(t):
        axes = qtensor_logical_axes(ax, "int4" if "q4" in t else "int8")
        parts = {k: _shard_tensor(v, axes[k], n) for k, v in t.items()}
        return [{k: parts[k][r] for k in t} for r in range(n)]
    return _shard_tensor(t, ax, n)


def _shard_tensor(t: torch.Tensor, logical: tuple, n: int) -> list:
    dim = _shard_dim(logical)
    if dim is None:
        return [t] * n
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} ({logical[dim]}) does "
                         f"not split into {n} shards")
    return [c.contiguous() for c in t.chunk(n, dim=dim)]


def shard_params(tree: dict, mesh: Mesh) -> list[dict]:
    """A full parameter tree (plain or QTensor-quantized, in the names
    and stacked shapes of :meth:`TransformerLM.init_params`) cut into one
    tree per device of the mesh's tensor axis, each in the shapes of a
    :class:`TransformerLM` over ``local_arch(arch, n)`` with
    ``vocab_shard=(rank, n)``.  A quantized tree must be quantized whole
    before it is cut, so codes and scales equal the unsharded ones."""
    n = mesh.size(AXIS_TENSOR)
    out: list[dict] = [{} for _ in range(n)]
    for group, name, leaf in _leaves(tree):
        for r, piece in enumerate(shard_leaf(group, name, leaf, n)):
            (out[r].setdefault(group, {}) if group else out[r])[name] = piece
    return out


def _leaves(tree: dict):
    """(layer group or None, name, leaf) of a parameter tree; a QTensor
    is one leaf."""
    for key, val in tree.items():
        if isinstance(val, dict) and not is_qtensor(val):
            for name, leaf in val.items():
                yield key, name, leaf
        else:
            yield None, key, val


class TransformerLM(tnn.Module):
    """GQA or MLA transformer, dense or MoE; parameters live in the
    module, KV pools in an explicit :class:`KVCache` written in place.

    ``moe_impl`` is how MoE layers compute: "dense" (:func:`nn.moe_mlp`),
    "ragged" or "grouped" (:func:`nn.moe_mlp_ragged` sized on the host or
    on the device), set from the device and dtype by
    :func:`moe_impl_for`."""

    def __init__(self, arch: ModelArch, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda",
                 vocab_shard: tuple[int, int] = (0, 1)):
        super().__init__()
        self.is_mla = arch.attention_kind == AttentionKind.MLA
        self.arch = arch
        self.dtype = dtype
        self.device = resolve_device(device)
        self.groups = _layer_groups(arch)
        self.moe_impl = moe_impl_for(self.device, dtype)
        self.vocab_padded = -(-arch.vocab_size // VOCAB_ALIGN) * VOCAB_ALIGN
        # (rank, n): this model's rows of the logits head when it is one
        # shard of a TensorParallelLM; (0, 1) holds the whole head
        self.vocab_shard = vocab_shard
        # MLA ropes only its qk_rope_head_dim slice, at full rotation
        rope_arch = (replace(arch, head_dim=arch.qk_rope_head_dim or 64,
                             partial_rotary_factor=1.0) if self.is_mla else arch)
        self._inv_freq_global = nn.rope_frequencies(rope_arch, self.device)
        self._rope_mscale = nn.rope_attention_factor(arch)
        # longrope (phi-3 family): per-position short/long table switch
        self._longrope = None if self.is_mla else nn.longrope_tables(arch, self.device)
        self._inv_freq_local = self._inv_freq_global
        # the embedding multiplier as a device scalar, made once: a copy
        # from the host per call would block and could not be captured
        self._embed_scale = (torch.tensor(arch.embedding_multiplier, dtype=dtype,
                                          device=self.device)
                             if arch.embedding_multiplier else None)
        if arch.sliding_window_pattern and arch.sliding_window:
            # gemma-3 sliding layers use unscaled theta=10k rope
            local = replace(arch, rope_theta=10000.0, rope_scaling=None)
            self._inv_freq_local = nn.rope_frequencies(local, self.device)
        self.top = tnn.ParameterDict()
        # per layer group: plain leaves, and one ParameterDict per QTensor
        self.stacks = tnn.ModuleDict()
        self.qstacks = tnn.ModuleDict()
        # per-request adapter lanes {group: {f"{t}_a": [L, lanes, in, r],
        # f"{t}_b": [L, lanes, r, out]}} (lane 0 the base's zeros),
        # written in place by the adapter cache; {} serves no adapter
        self.lora: dict[str, dict[str, torch.Tensor]] = {}
        # the scaling of a merged adapter (tuning.lora.merge_lora)
        self.lora_scaling = 0.0

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def _mla_dims(self) -> tuple[int, int, int, int]:
        """(qk_nope_head_dim, qk_rope_head_dim, v_head_dim, kv_lora_rank)
        with the JAX package's defaults."""
        a = self.arch
        return (a.qk_nope_head_dim or a.head_dim, a.qk_rope_head_dim or 64,
                a.v_head_dim or a.head_dim, a.kv_lora_rank or 512)

    def _layer_specs(self, moe: bool = False) -> dict[str, tuple[int, ...]]:
        a = self.arch
        E, H, Hkv, D, I = (a.hidden_size, a.num_heads, a.num_kv_heads,
                           a.head_dim, a.intermediate_size)
        if self.is_mla:
            dn, dr, dv, dl = self._mla_dims()
            specs = {"attn_norm": (E,), "kv_a": (E, dl + dr), "kv_a_norm": (dl,),
                     "kv_b_k": (dl, H * dn), "kv_b_v": (dl, H * dv),
                     "o": (H * dv, E)}
            if a.q_lora_rank:
                specs.update({"q_a": (E, a.q_lora_rank), "q_a_norm": (a.q_lora_rank,),
                              "q_b": (a.q_lora_rank, H * (dn + dr))})
            else:
                specs["q"] = (E, H * (dn + dr))
        else:
            specs = {
                "attn_norm": (E,),
                "q": (E, H * D),
                "k": (E, Hkv * D),
                "v": (E, Hkv * D),
                "o": (H * D, E),
            }
        if a.qkv_bias or a.linear_bias:
            specs.update({"q_bias": (H * D,), "k_bias": (Hkv * D,),
                          "v_bias": (Hkv * D,)})
        if a.linear_bias:
            specs["o_bias"] = (E,)
        if a.qk_norm:
            specs["q_norm"] = (D,)
            specs["k_norm"] = (D,)
        if a.norm_type == "layernorm":
            specs["attn_norm_bias"] = (E,)
        if not a.parallel_residual:
            specs["mlp_norm"] = (E,)
            if a.norm_type == "layernorm":
                specs["mlp_norm_bias"] = (E,)
        if a.pre_post_norm:
            specs["post_attn_norm"] = (E,)
            specs["post_mlp_norm"] = (E,)
        if moe:
            X, Im = a.num_experts, a.moe_intermediate_size or I
            specs.update({"router": (E, X), "experts_gate": (X, E, Im),
                          "experts_up": (X, E, Im), "experts_down": (X, Im, E)})
            if a.num_shared_experts:
                Is = Im * a.num_shared_experts
                specs.update({"shared_gate": (E, Is), "shared_up": (E, Is),
                              "shared_down": (Is, E)})
            return specs
        if a.gated_mlp:
            specs["gate"] = (E, I)
        specs["up"] = (E, I)
        specs["down"] = (I, E)
        if a.linear_bias:
            specs["up_bias"] = (I,)
            specs["down_bias"] = (E,)
        return specs

    def _top_specs(self) -> dict[str, tuple[int, ...]]:
        a = self.arch
        E = a.hidden_size
        specs = {"embed": (self.vocab_padded, E), "final_norm": (E,)}
        if a.norm_type == "layernorm":
            specs["final_norm_bias"] = (E,)
        if not a.tie_word_embeddings:
            specs["lm_head"] = (self.vocab_padded // self.vocab_shard[1], E)
        return specs

    def param_logical_axes(self) -> dict:
        """Tree matching :meth:`init_params` with the logical axis names of
        every dim (the layer stacks lead with "layers")."""
        axes: dict = {name: LOGICAL_AXES[name] for name in self._top_specs()}
        for g in self.groups:
            axes[g.name] = {name: ("layers",) + LOGICAL_AXES[name]
                            for name in self._layer_specs(g.moe)}
        return axes

    def init_params(self, seed: int = 0, quantization: str = "") -> None:
        """Synthetic weights with the JAX package's shapes and scales:
        0.02 normal for the top level, 1/sqrt(fan_in) normal per layer,
        ones for norms (zeros with a norm offset), zeros for biases.
        Each tensor draws from its own seeded ``torch.Generator`` on the
        target device, so values do not depend on draw order.  Under
        ``quantization`` each stacked projection is quantized right after
        it is drawn, so the device holds the quantized tree plus at most
        one full-precision leaf."""
        tree: dict = {}
        for group, name, t in self.synthetic_leaves(seed, quantization):
            (tree.setdefault(group, {}) if group else tree)[name] = t
        self.load_params(tree)

    def synthetic_leaves(self, seed: int = 0, quantization: str = ""):
        """The leaves of :meth:`init_params`, one at a time, as (layer
        group or None, name, tensor on the model's device)."""
        gen = torch.Generator(device=self.device)

        def normal(shape, std, salt):
            gen.manual_seed((seed * 1_000_003 + salt) & 0x7FFF_FFFF_FFFF_FFFF)
            t = torch.empty(shape, dtype=self.dtype, device=self.device)
            return t.normal_(0.0, std, generator=gen)

        def norm_fill(shape):
            fill = 0.0 if self.arch.norm_offset else 1.0
            return torch.full(shape, fill, dtype=self.dtype, device=self.device)

        for name, shape in self._top_specs().items():
            if "norm" in name:
                yield None, name, (torch.zeros(shape, dtype=self.dtype,
                                               device=self.device)
                                   if "bias" in name else norm_fill(shape))
            else:
                yield None, name, normal(shape, 0.02, _name_salt(name))
        for gi, g in enumerate(self.groups):
            for name, shape in self._layer_specs(g.moe).items():
                full = (g.count,) + shape
                if "norm" in name and "bias" not in name:
                    t = norm_fill(full)
                elif "bias" in name:
                    t = torch.zeros(full, dtype=self.dtype, device=self.device)
                else:
                    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                    t = normal(full, 1.0 / math.sqrt(fan_in),
                               _name_salt(name) + 7919 * (gi + 1))
                    if quantization and is_quantized_leaf(g.name, name):
                        t = quantize_weight(t, quantization)
                yield g.name, name, t

    def load_params(self, tree: dict, quantization: str = "") -> None:
        """Install a parameter tree (names and stacked shapes of
        :meth:`init_params`), moved to the model's device and dtype.
        QTensor leaves keep their own dtypes (int8 codes, fp32 scales);
        under ``quantization`` a plain projection is cast to the model
        dtype, then quantized, one tensor at a time."""
        def param(t, dtype=self.dtype):
            return tnn.Parameter(t.to(device=self.device, dtype=dtype),
                                 requires_grad=False)

        for name, shape in self._top_specs().items():
            if tuple(tree[name].shape) != shape:
                raise ValueError(f"param {name!r}: shape {tuple(tree[name].shape)} "
                                 f"!= {shape}")
            self.top[name] = param(tree[name])
        for g in self.groups:
            stack, qstack = tnn.ParameterDict(), tnn.ModuleDict()
            for name, shape in self._layer_specs(g.moe).items():
                full = (g.count,) + shape
                t = tree[g.name][name]
                if quantization and is_quantized_leaf(g.name, name) \
                        and not is_qtensor(t):
                    if tuple(t.shape) != full:
                        raise ValueError(f"param {g.name}.{name!r}: shape "
                                         f"{tuple(t.shape)} != {full}")
                    t = quantize_weight(t.to(device=self.device, dtype=self.dtype),
                                        quantization)
                if is_qtensor(t):
                    _check_qtensor(f"{g.name}.{name}", t, full)
                    qstack[name] = tnn.ParameterDict(
                        {k: param(x, x.dtype) for k, x in t.items()})
                    continue
                if tuple(t.shape) != full:
                    raise ValueError(f"param {g.name}.{name!r}: shape "
                                     f"{tuple(t.shape)} != {full}")
                stack[name] = param(t)
            self.stacks[g.name] = stack
            self.qstacks[g.name] = qstack
        if tree.get("serve_lora"):
            self.set_lora(tree["serve_lora"])

    # ------------------------------------------------------------------
    # Per-request adapter lanes
    # ------------------------------------------------------------------

    def lora_specs(self) -> dict[str, dict[str, tuple[int, int]]]:
        """{group: {target: (in, out)}} of the per-request LoRA sites:
        every projection of a dense group, q/k/v/o of a MoE group, none
        on MLA."""
        if self.is_mla:
            return {}
        out = {}
        for g in self.groups:
            specs = self._layer_specs(g.moe)
            out[g.name] = {t: specs[t] for t in
                           (LORA_TARGETS_MOE if g.moe else LORA_TARGETS)
                           if t in specs}
        return out

    def alloc_lora(self, lanes: int, rmax: int) -> None:
        """Zeroed lanes for every site, once: [L, lanes, in, rmax] and
        [L, lanes, rmax, out] in the model's dtype on its device."""
        self.lora, specs = {}, self.lora_specs()
        for g in self.groups:
            buf = {}
            for t, (i, o) in specs.get(g.name, {}).items():
                buf[f"{t}_a"] = torch.zeros((g.count, lanes, i, rmax), dtype=self.dtype,
                                            device=self.device)
                buf[f"{t}_b"] = torch.zeros((g.count, lanes, rmax, o), dtype=self.dtype,
                                            device=self.device)
            if buf:
                self.lora[g.name] = buf

    def set_lora(self, stacks: dict) -> None:
        """Install stacked lanes ({group: {f"{t}_a", f"{t}_b"}}, lane 0 the
        base's zeros), moved to the model's device and dtype."""
        self.lora = {g: {k: t.to(device=self.device, dtype=self.dtype).contiguous()
                         for k, t in buf.items()}
                     for g, buf in stacks.items() if buf}

    def write_lora_lane(self, lane: int, group: str, t: str, a: torch.Tensor,
                        b: torch.Tensor) -> None:
        """Overwrite lane ``lane`` of target ``t`` in place with a [L, in,
        rmax] and b [L, rmax, out] (host tensors in the model dtype): a
        copy in stream order, so a captured graph keeps its pointers."""
        buf = self.lora[group]
        buf[f"{t}_a"][:, lane].copy_(a)
        buf[f"{t}_b"][:, lane].copy_(b)

    def _lora_layer(self, g: "LayerGroup", i: int) -> Optional[dict]:
        buf = self.lora.get(g.name)
        return {k: t[i] for k, t in buf.items()} if buf else None

    def _lora_ids(self, adapter_ids) -> Optional[torch.Tensor]:
        """The rows' lanes as int64, or None when no adapter is served."""
        if adapter_ids is None or not self.lora:
            return None
        return adapter_ids.long()

    def param_tree(self) -> dict:
        """The parameters as a nested dict of tensors (QTensor dicts for
        quantized projections)."""
        tree = {k: v for k, v in self.top.items()}
        for g in self.groups:
            tree[g.name] = {k: v for k, v in self.stacks[g.name].items()}
            tree[g.name].update({k: dict(v.items())
                                 for k, v in self.qstacks[g.name].items()})
        return tree

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    # ------------------------------------------------------------------
    # Flags / rope tables
    # ------------------------------------------------------------------

    def _window(self, layer: int) -> Optional[int]:
        """Sliding window of ``layer`` (None for a model without one,
        _BIG_WINDOW for a global layer of a mixed model)."""
        a = self.arch
        if not a.sliding_window:
            return None
        if a.sliding_window_pattern and (layer + 1) % a.sliding_window_pattern == 0:
            return _BIG_WINDOW
        return int(a.sliding_window)

    def _rope_select(self, positions: torch.Tensor):
        """(inv_freq, mscale) of the global table at ``positions``
        [..., seq]: with longrope factor lists, per position (the long
        table and mscale from ``original_max_position_embeddings`` on),
        as ``[..., seq, half]`` and ``[..., seq, 1, 1]`` tensors chosen on
        the device; else the one table and its float mscale."""
        if self._longrope is None:
            return self._inv_freq_global, self._rope_mscale
        short, long, orig, short_m, long_m = self._longrope
        is_long = positions >= orig                                  # [..., seq]
        inv = torch.where(is_long[..., None], long, short)
        ms = torch.where(is_long, long_m, short_m)[..., None, None].float()
        return inv, ms

    @property
    def _scale(self) -> float:
        a = self.arch
        if self.is_mla:
            base = 1.0 / math.sqrt(self._mla_dims()[0] + (a.qk_rope_head_dim or 0))
            # deepseek-yarn: the all-dim mscale lands in the softmax scale
            # (squared: it applies to both q and k), while the
            # mscale/mscale_all_dim ratio rides the rope table
            s = a.rope_scaling or {}
            if nn._rope_type(a) == "yarn" and s.get("mscale_all_dim") is not None:
                m = nn.yarn_get_mscale(float(s.get("factor", 1.0)),
                                       float(s["mscale_all_dim"]))
                base *= m * m
            return base
        denom = a.query_pre_attn_scalar if a.query_pre_attn_scalar else a.head_dim
        return 1.0 / math.sqrt(denom)

    # ------------------------------------------------------------------
    # Layer body
    # ------------------------------------------------------------------

    def _norm(self, x, p, name):
        a = self.arch
        if a.norm_type == "layernorm":
            return nn.layer_norm(x, p[name], p.get(f"{name}_bias"), a.rms_norm_eps)
        return nn.rms_norm(x, p[name], a.rms_norm_eps, a.norm_offset)

    def _attn_qkv(self, x, p, positions, window, q_proj=None, lora=None, ids=None,
                  scaling=None):
        """q/k/v heads with norms and rope applied.  x: [B, T, E];
        positions: [B, T] absolute positions; ``q_proj``: the q
        projection when a collective already computed it; ``lora`` /
        ``ids``: the layer's adapter lanes and the rows' lanes;
        ``scaling``: the training-form LoRA scaling (None outside
        training)."""
        a = self.arch
        B, T, _ = x.shape
        q = nn.linear(x, p["q"]) if q_proj is None else q_proj
        q = nn.plus_lora(nn.plus_delta(q, x, lora, "q", ids), x, p, "q", scaling)
        k = nn.plus_lora(nn.plus_delta(nn.linear(x, p["k"]), x, lora, "k", ids),
                         x, p, "k", scaling)
        v = nn.plus_lora(nn.plus_delta(nn.linear(x, p["v"]), x, lora, "v", ids),
                         x, p, "v", scaling)
        if "q_bias" in p:
            q, k, v = q + p["q_bias"], k + p["k_bias"], v + p["v_bias"]
        q = q.reshape(B, T, a.num_heads, a.head_dim)
        k = k.reshape(B, T, a.num_kv_heads, a.head_dim)
        v = v.reshape(B, T, a.num_kv_heads, a.head_dim)
        if a.qk_norm:
            q = nn.rms_norm(q, p["q_norm"], a.rms_norm_eps, a.norm_offset)
            k = nn.rms_norm(k, p["k_norm"], a.rms_norm_eps, a.norm_offset)
        if window is None or self._inv_freq_local is self._inv_freq_global:
            inv_freq, mscale = self._rope_select(positions)
        elif window >= _BIG_WINDOW:
            inv_freq, mscale = self._inv_freq_global, self._rope_mscale
        else:
            # gemma-3's sliding layers: the unscaled 10k table with no
            # magnitude correction (no supported arch mixes sliding
            # windows with longrope)
            inv_freq, mscale = self._inv_freq_local, 1.0
        q = nn.apply_rope(q, positions, inv_freq, a.head_dim, mscale=mscale)
        k = nn.apply_rope(k, positions, inv_freq, a.head_dim, mscale=mscale)
        return q, k, v

    def _layer(self, x, p, cache: KVCache, li: int, mode: str, moe: bool,
               lora=None, ids=None, **kw):
        """One transformer block over layer ``li`` of the pools; ``lora``
        / ``ids`` the layer's adapter lanes and the rows' lanes (None:
        no adapter sites run).  Mode "train" adds the training-form LoRA
        updates of ``p`` (none on MLA's attention, as in the JAX
        package)."""
        train = mode == "train"
        scaling = self.lora_scaling if train else None
        h = self._norm(x, p, "attn_norm")
        if self.is_mla:
            o_in = self._mla_attention(h, p, cache, li, mode, **kw)
        else:
            o_in = self._attention(h, p, cache, li, mode, lora=lora, ids=ids,
                                   scaling=scaling, **kw)
        o = nn.plus_delta(nn.linear(o_in, p["o"]), o_in, lora, "o", ids)
        if not self.is_mla:
            o = nn.plus_lora(o, o_in, p, "o", scaling)
        x, h2 = self._attn_residual(x, h, o, p)
        return self._mlp_residual(
            x, self._mlp(h2, p, moe, kw["active"], lora, ids, train=train), p)

    def _mlp(self, x, p, moe: bool, active=None, lora=None, ids=None,
             train: bool = False):
        """The layer's MLP: dense (with its adapter sites, and in training
        its training-form LoRA updates), or its MoE by ``moe_impl``
        (training: the dense form, as the JAX trainer runs it).
        ``active`` (decode's active rows, else None) keeps the grouped
        form's inactive rows out of every expert group."""
        if not moe:
            return nn.mlp(x, p, self.arch, lora=lora, lora_ids=ids,
                          lora_scaling=self.lora_scaling if train else None)
        B, T, E = x.shape
        x2 = x.reshape(B * T, E)
        if self.moe_impl == "dense" or train:
            y = nn.moe_mlp(x2, p, self.arch)
        else:
            valid = None if active is None else active.repeat_interleave(T)
            y = nn.moe_mlp_ragged(x2, p, self.arch,
                                  grouped=self.moe_impl == "grouped", valid=valid)
        return y.reshape(B, T, E)

    def _attention(self, h, p, cache: KVCache, li: int, mode: str, *,
                   positions, page_tables, lengths, true_lens, active,
                   start_pos=None, packed=None, q_proj=None, lora=None, ids=None,
                   scaling=None):
        """q/k/v of the normed input ``h``, their page writes and the
        attention over layer ``li`` of the pools: the attention-out
        projection's input [B, T, H * D]."""
        a = self.arch
        B, T, _ = h.shape
        window = self._window(li)
        win = window if window is not None else _BIG_WINDOW
        q, k_new, v_new = self._attn_qkv(h, p, positions, window, q_proj, lora, ids,
                                         scaling)
        if mode == "train":
            # training: the differentiable plain attention (the flash
            # kernel has no backward), as the JAX training layer runs it
            out = attn.prefill_attention(q, k_new, v_new, scale=self._scale,
                                         sliding_window=window,
                                         logit_softcap=a.attn_logit_softcap,
                                         true_len=true_lens)
            return out.reshape(B, T, a.num_heads * a.head_dim)
        if mode == "score":
            # the cache-less forward of prompt scoring: the fresh row
            # attends over itself and writes no page
            with profiler_range("attention"):
                out = flash_prefill_attention_cuda(q, k_new, v_new, true_lens, win,
                                                   scale=self._scale,
                                                   softcap=a.attn_logit_softcap)
            return out.reshape(B, T, a.num_heads * a.head_dim)
        ck, cv = cache.k, cache.v
        ks, vs = cache.k_scale, cache.v_scale      # None unless int8 pools
        ps = ck.shape[2]
        softcap = a.attn_logit_softcap

        if mode == "prefill_packed":
            seg_ids, tok_pages, pack_pages, tok_pgslot = packed
            offsets = positions[0] % ps
            if ks is not None:
                write_packed_prefill_tokens_q(ck, ks, k_new, pack_pages, tok_pgslot,
                                              offsets, layer=li)
                write_packed_prefill_tokens_q(cv, vs, v_new, pack_pages, tok_pgslot,
                                              offsets, layer=li)
            else:
                write_packed_prefill_tokens(ck, k_new, tok_pages, offsets, layer=li)
                write_packed_prefill_tokens(cv, v_new, tok_pages, offsets, layer=li)
            with profiler_range("attention"):
                out = flash_prefill_packed_cuda(
                    q, k_new, v_new, seg_ids, positions, win,
                    scale=self._scale, softcap=softcap)
        elif mode == "prefill":
            start = (start_pos if start_pos is not None
                     else torch.zeros((B,), dtype=torch.int32, device=h.device))
            if ks is not None:
                write_prefill_tokens_q(ck, ks, k_new, page_tables, start, true_lens,
                                       ps, layer=li)
                write_prefill_tokens_q(cv, vs, v_new, page_tables, start, true_lens,
                                       ps, layer=li)
            else:
                write_prefill_tokens(ck, k_new, page_tables, start, true_lens, ps,
                                     layer=li)
                write_prefill_tokens(cv, v_new, page_tables, start, true_lens, ps,
                                     layer=li)
            if start_pos is not None:
                # chunk attends over earlier chunks + itself
                out = attn.paged_context_attention(
                    q, ck, cv, page_tables, start, true_lens, scale=self._scale,
                    sliding_window=window, logit_softcap=softcap, layer=li,
                    k_scale=ks, v_scale=vs)
            else:
                with profiler_range("attention"):
                    out = flash_prefill_attention_cuda(
                        q, k_new, v_new, true_lens, win, scale=self._scale,
                        softcap=softcap)
        else:
            pos0 = positions[:, 0]
            if ks is not None:
                write_decode_tokens_q(ck, ks, k_new[:, 0], page_tables, pos0, ps,
                                      active, layer=li)
                write_decode_tokens_q(cv, vs, v_new[:, 0], page_tables, pos0, ps,
                                      active, layer=li)
            else:
                write_decode_tokens(ck, k_new[:, 0], page_tables, pos0, ps, active,
                                    layer=li)
                write_decode_tokens(cv, v_new[:, 0], page_tables, pos0, ps, active,
                                    layer=li)
            with profiler_range("attention"):
                out = paged_decode_attention_cuda(
                    q[:, 0], ck, cv, page_tables, lengths, win,
                    scale=self._scale, softcap=softcap, layer=li,
                    k_scale=ks, v_scale=vs)[:, None]
        return out.reshape(B, T, a.num_heads * a.head_dim)

    def _mla_attention(self, h, p, cache: KVCache, li: int, mode: str, *,
                       positions, page_tables, lengths, true_lens, active,
                       start_pos=None):
        """Latent attention (``kaito_tpu.engine.model._mla_attention``):
        q through ``q_a``/``q_b`` (or ``q``), the latent ``[c_kv ; k_rope]``
        through ``kv_a``, written to layer ``li`` of the latent pool (the
        int8 write folds one scale a page over the whole row); a fresh
        chunk attends with K/V expanded from its own latent, a later
        chunk and decode over the paged latent in the absorbed form.
        Returns the attention-out projection's input [B, T, H * dv]."""
        a = self.arch
        B, T, _ = h.shape
        H = a.num_heads
        dn, dr, dv, dl = self._mla_dims()
        if "q_a" in p:
            q_lat = nn.rms_norm(nn.linear(h, p["q_a"]), p["q_a_norm"],
                                a.rms_norm_eps, False)
            q = nn.linear(q_lat, p["q_b"])
        else:
            q = nn.linear(h, p["q"])
        q = q.reshape(B, T, H, dn + dr)
        q_nope = q[..., :dn]
        q_rope = nn.apply_rope(q[..., dn:], positions, self._inv_freq_global, dr,
                               mscale=self._rope_mscale)
        kv = nn.linear(h, p["kv_a"])                              # [B, T, dl+dr]
        c_kv = nn.rms_norm(kv[..., :dl], p["kv_a_norm"], a.rms_norm_eps, False)
        k_rope = nn.apply_rope(kv[..., dl:][:, :, None, :], positions,
                               self._inv_freq_global, dr,
                               mscale=self._rope_mscale)[:, :, 0]
        wk, wv = p["kv_b_k"], p["kv_b_v"]
        if mode in ("score", "train"):
            out = attn.mla_prefill_attention(q_nope, q_rope, c_kv, k_rope, wk, wv,
                                             scale=self._scale, true_len=true_lens)
            return out.reshape(B, T, H * dv)
        latent = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]  # [B, T, 1, dl+dr]
        ck, ks = cache.k, cache.k_scale     # one stream; ks None unless int8
        ps = ck.shape[2]
        if mode == "prefill":
            start = (start_pos if start_pos is not None
                     else torch.zeros((B,), dtype=torch.int32, device=h.device))
            if ks is not None:
                write_prefill_tokens_q(ck, ks, latent, page_tables, start, true_lens,
                                       ps, layer=li)
            else:
                write_prefill_tokens(ck, latent, page_tables, start, true_lens, ps,
                                     layer=li)
            if start_pos is not None:
                out = attn.mla_paged_context_attention(
                    q_nope, q_rope, ck, page_tables, start, true_lens, wk, wv,
                    scale=self._scale, kv_lora_rank=dl, layer=li, latent_scale=ks)
            else:
                out = attn.mla_prefill_attention(q_nope, q_rope, c_kv, k_rope, wk, wv,
                                                 scale=self._scale, true_len=true_lens)
        elif mode == "decode":
            pos0 = positions[:, 0]
            if ks is not None:
                write_decode_tokens_q(ck, ks, latent[:, 0], page_tables, pos0, ps,
                                      active, layer=li)
            else:
                write_decode_tokens(ck, latent[:, 0], page_tables, pos0, ps, active,
                                    layer=li)
            out = self._mla_decode(cache, q_nope[:, 0], q_rope[:, 0], page_tables,
                                   lengths, p, li)[:, None]
        else:
            raise NotImplementedError(f"MLA attention has no {mode!r} mode")
        return out.reshape(B, T, H * dv)

    def _mla_decode(self, cache: KVCache, q_nope, q_rope, page_tables, lengths, p,
                    li: int):
        return attn.mla_paged_decode_attention(
            q_nope, q_rope, cache.k, page_tables, lengths, p["kv_b_k"], p["kv_b_v"],
            scale=self._scale, kv_lora_rank=self._mla_dims()[3], layer=li,
            latent_scale=cache.k_scale)

    def mla_decode_attention(self, cache: KVCache, q_nope, q_rope, page_tables,
                             lengths, layer: int = 0):
        """Layer ``layer``'s MLA decode attention over the latent pool of
        ``cache``, as a decode step runs it: queries q_nope [B, H, dn] and
        q_rope [B, H, dr] (rope applied), page tables [B, pmax], lengths
        [B] -> [B, H, dv]."""
        g = next(g for g in self.groups if g.start <= layer < g.start + g.count)
        return self._mla_decode(cache, q_nope, q_rope, page_tables, lengths,
                                self._layer_params(g, layer - g.start), layer)

    def _attn_residual(self, x, h, attn_out, p):
        """The residual after attention: (x, the MLP's input)."""
        a = self.arch
        if "o_bias" in p:
            attn_out = attn_out + p["o_bias"]
        if a.parallel_residual:
            return x + attn_out, h
        if a.pre_post_norm:
            attn_out = self._norm(attn_out, p, "post_attn_norm")
        x = x + attn_out
        return x, self._norm(x, p, "mlp_norm")

    def _mlp_residual(self, x, mlp_out, p):
        a = self.arch
        if a.pre_post_norm and not a.parallel_residual:
            mlp_out = self._norm(mlp_out, p, "post_mlp_norm")
        return x + mlp_out

    def _layer_params(self, g: LayerGroup, i: int) -> dict:
        """Layer ``i`` of group ``g``: views of the stacks; a QTensor's
        layer is {"q8"|"q4": codes[i], "scale": scale[i]}."""
        p = {name: t[i] for name, t in self.stacks[g.name].items()}
        p.update({name: {k: t[i] for k, t in qt.items()}
                  for name, qt in self.qstacks[g.name].items()})
        return p

    def _run_layers(self, cache: KVCache, x, mode, ids=None, **kw):
        for g in self.groups:
            for i in range(g.count):
                lora = self._lora_layer(g, i) if ids is not None else None
                x = self._layer(x, self._layer_params(g, i), cache, g.start + i,
                                mode, g.moe, lora=lora, ids=ids, **kw)
        return x

    # ------------------------------------------------------------------
    # Forward passes
    # ------------------------------------------------------------------

    def _embed(self, tokens):
        x = self.top["embed"][tokens.long()].to(self.dtype)
        if self._embed_scale is not None:
            x = x * self._embed_scale
        return x

    def _logits_local(self, x2):
        """fp32 logits [N, rows] of this model's rows of the head (all of
        them unless it is one shard of a TensorParallelLM): bf16 inputs,
        fp32 accumulation and output, as the JAX package's dot_general
        with preferred_element_type=float32."""
        if self.arch.tie_word_embeddings:
            r, n = self.vocab_shard
            rows = self.vocab_padded // n
            head = self.top["embed"][r * rows:(r + 1) * rows]
        else:
            head = self.top["lm_head"]
        if x2.dtype == torch.float32:
            return x2 @ head.t()
        if x2.is_cuda:
            if torch.is_grad_enabled() and (x2.requires_grad or head.requires_grad):
                return _HeadLogits.apply(x2, head)
            return torch.mm(x2, head.t(), out_dtype=torch.float32)
        return x2.float() @ head.float().t()

    def _logits(self, x):
        """fp32 logits [..., vocab_size]."""
        logits = self._logits_local(x.reshape(-1, x.shape[-1]))
        return _finish_logits(logits, self.arch, x.shape[:-1])

    def _prefill_in(self, tokens, true_lens, page_tables, start_pos):
        """(embedded tokens, layer inputs) of :meth:`prefill`."""
        B, T = tokens.shape
        rel = torch.arange(T, dtype=torch.int32, device=tokens.device)
        rel = rel[None, :].expand(B, T)
        positions = rel if start_pos is None else rel + start_pos[:, None]
        return self._embed(tokens), dict(
            positions=positions, page_tables=page_tables, lengths=true_lens,
            true_lens=true_lens, active=None, start_pos=start_pos)

    def _prefill_out(self, x, true_lens):
        """The final-normed hidden state of each row's last token."""
        x = self._norm(x, self.top, "final_norm")
        idx = (true_lens.long() - 1).clamp_min(0)
        return x[torch.arange(x.shape[0], device=x.device), idx]

    def _packed_in(self, tokens, seg_ids, positions, tok_pages, pack_pages,
                   tok_pgslot):
        return self._embed(tokens), dict(
            positions=positions, page_tables=None, lengths=None, true_lens=None,
            active=None, packed=(seg_ids, tok_pages, pack_pages, tok_pgslot))

    def _packed_out(self, x, last_idx):
        return self._norm(x, self.top, "final_norm")[0, last_idx.long()]

    def _decode_in(self, tokens, positions, page_tables, active):
        pos2 = positions[:, None].to(torch.int32)
        lengths = (positions + 1).to(torch.int32)
        if active is not None:
            lengths = torch.where(active, lengths, 0).to(torch.int32)
        return self._embed(tokens[:, None]), dict(
            positions=pos2, page_tables=page_tables, lengths=lengths,
            true_lens=None, active=active)

    def _decode_out(self, x):
        return self._norm(x, self.top, "final_norm")[:, 0]

    def _score_in(self, tokens, true_len):
        B, T = tokens.shape
        positions = torch.arange(T, dtype=torch.int32, device=tokens.device)
        return self._embed(tokens), dict(
            positions=positions[None, :].expand(B, T), page_tables=None,
            lengths=None, true_lens=true_len, active=None)

    def prefill(self, cache: KVCache, tokens, true_lens, page_tables,
                start_pos=None, adapter_ids=None):
        """Prompts (or prompt suffixes when ``start_pos`` marks earlier
        chunks already in the pages).  tokens: [B, T] padded chunks;
        true_lens: [B] int32 valid new tokens; page_tables: [B, pmax]
        int32; adapter_ids: [B] int32 each row's adapter lane (None: the
        base for every row).  Returns (cache, last_logits [B, V] fp32,
        last_hidden [B, E]); the cache is written in place."""
        if start_pos is not None:
            page_tables = attn.history_pages(page_tables, start_pos, true_lens,
                                             cache.k.shape[2])
        x, kw = self._prefill_in(tokens, true_lens, page_tables, start_pos)
        last = self._prefill_out(self._run_layers(cache, x, "prefill",
                                                  self._lora_ids(adapter_ids), **kw),
                                 true_lens)
        return cache, self._logits(last), last

    def prefill_packed(self, cache: KVCache, tokens, seg_ids, positions,
                       tok_pages, last_idx, pack_pages=None, tok_pgslot=None,
                       adapter_ids=None):
        """Segment-packed prefill: S fresh prompts in ONE padded row.
        tokens/seg_ids/positions: [1, T] int32 (segment -1 = pad,
        positions within the segment); tok_pages: [T] page per token;
        last_idx: [S] packed index of each segment's final token.  An
        int8 cache also needs pack_pages ([n_pg] the segments' pages)
        and tok_pgslot ([T] each token's index into them, n_pg for
        pads).  Every segment runs one adapter: ``adapter_ids`` is [1]
        (or None for the base).  Returns (cache, last_logits [S, V] fp32,
        last_hidden [S, E])."""
        if self.is_mla:
            raise NotImplementedError(
                "segment-packed prefill is not implemented for MLA attention; "
                "the engine batches fresh MLA prompts on the batch axis instead")
        if cache.quantized and (pack_pages is None or tok_pgslot is None):
            raise ValueError("an int8 KV cache needs pack_pages and tok_pgslot")
        x, kw = self._packed_in(tokens, seg_ids, positions, tok_pages, pack_pages,
                                tok_pgslot)
        last = self._packed_out(self._run_layers(cache, x, "prefill_packed",
                                                 self._lora_ids(adapter_ids), **kw),
                                last_idx)
        return cache, self._logits(last), last

    def verify_window_logits(self, cache: KVCache, tokens, true_lens, page_tables,
                             start_pos, adapter_ids=None):
        """Speculative verification forward
        (``kaito_tpu.engine.model.TransformerLM.verify_window_logits``):
        a window of proposed tokens through the chunked-prefill path
        (paged history + causal window attention, KV written in place),
        and the fp32 logits at EVERY window position.  tokens: [B, W]
        (the last emitted token, then the proposal, padded); true_lens:
        [B] valid window tokens (0 skips a row: its writes go to the null
        page); start_pos: [B] absolute position of the window start.
        ``page_tables`` are passed whole: nothing here reads a length
        back to the host, so a CUDA graph can hold the call.
        ``adapter_ids`` [B] (or None) are the rows' adapter lanes.  Returns
        (cache, logits [B, W, V] fp32)."""
        x, kw = self._prefill_in(tokens, true_lens, page_tables, start_pos)
        x = self._norm(self._run_layers(cache, x, "prefill",
                                        self._lora_ids(adapter_ids), **kw),
                       self.top, "final_norm")
        return cache, self._logits(x)

    def decode(self, cache: KVCache, tokens, positions, page_tables,
               active=None, adapter_ids=None):
        """One decode step.  tokens: [B] last sampled token; positions:
        [B] int32 their positions (lengths after the write are
        positions + 1).  Rows that ``active`` marks off write to the
        null page and attend over nothing (length 0; their logits are
        meaningless), so their positions need not fit ``page_tables``.
        ``adapter_ids`` [B] (or None) are the rows' adapter lanes.
        Returns (cache, logits [B, V] fp32)."""
        x, kw = self._decode_in(tokens, positions, page_tables, active)
        x = self._decode_out(self._run_layers(cache, x, "decode",
                                              self._lora_ids(adapter_ids), **kw))
        return cache, self._logits(x)

    def score(self, tokens, true_len):
        """log p(token[t+1] | tokens[:t+1]) of one prompt, the JAX
        engine's ``_score_fn``: one cache-less causal forward over tokens
        [1, T] (T a multiple of :data:`SCORE_CHUNK`, the prompt padded;
        true_len [1] int32 its length), the final norm and the vocabulary
        projection in chunks of :data:`SCORE_CHUNK` positions.  Returns
        [T - 1] fp32 (entries from true_len - 1 on are padding's)."""
        x, kw = self._score_in(tokens, true_len)
        x = self._run_layers(None, x, "score", **kw)[0]
        return _score_logprobs(tokens[0], lambda a, b: self._logits(
            self._norm(x[a:b], self.top, "final_norm")))

    def forward_train(self, tokens, mask=None, remat: bool = True) -> torch.Tensor:
        """The training forward (``kaito_tpu.engine.model.TransformerLM.
        forward_train``): tokens [B, T] -> fp32 logits [B, T, vocab].
        ``mask`` [B, T] (1 for a token, 0 for padding) sets each row's
        attended length to its sum; None attends over all T.  With
        ``remat`` each layer's activations are recomputed in the backward
        (non-reentrant ``checkpoint``), so a step holds one layer's."""
        B, T = tokens.shape
        positions = torch.arange(T, dtype=torch.int32, device=tokens.device)
        true_lens = (mask.sum(-1).to(torch.int32) if mask is not None else
                     torch.full((B,), T, dtype=torch.int32, device=tokens.device))
        kw = dict(positions=positions[None, :].expand(B, T), page_tables=None,
                  lengths=None, true_lens=true_lens, active=None)
        x = self._embed(tokens)
        for g in self.groups:
            for i in range(g.count):
                if remat:
                    x = checkpoint(self._train_layer, x, g, i, kw, use_reentrant=False)
                else:
                    x = self._train_layer(x, g, i, kw)
        return self._logits(self._norm(x, self.top, "final_norm"))

    def _train_layer(self, x, g: LayerGroup, i: int, kw: dict):
        return self._layer(x, self._layer_params(g, i), None, g.start + i, "train",
                           g.moe, **kw)


class _HeadLogits(torch.autograd.Function):
    """bf16 hidden states times the bf16 logits head with fp32 output
    (``torch.mm(out_dtype=float32)``, the JAX package's dot_general with
    preferred_element_type=float32) under autograd: the gradients run in
    the inputs' dtype with fp32 accumulation."""

    @staticmethod
    def forward(ctx, x2: torch.Tensor, head: torch.Tensor):
        ctx.save_for_backward(x2, head)
        return torch.mm(x2, head.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x2, head = ctx.saved_tensors
        g = g.to(x2.dtype)
        dx = g @ head if ctx.needs_input_grad[0] else None
        dhead = g.t() @ x2 if ctx.needs_input_grad[1] else None
        return dx, dhead


def greedy_targets(logits: torch.Tensor, grammar_rows: Optional[torch.Tensor] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The argmax of fp32 logits [B, W, V] (plus the 0 / -inf
    ``grammar_rows`` [B, W, V] when given) and its logprob under the
    unmodified distribution: (targets [B, W] int32, lps [B, W] fp32)."""
    B, W, V = logits.shape
    masked = logits if grammar_rows is None else logits + grammar_rows
    targets = torch.argmax(masked, dim=-1).to(torch.int32)
    lps = chosen_logprob(logits.reshape(B * W, V), targets.reshape(B * W))
    return targets, lps.reshape(B, W)


def _score_logprobs(tokens, logits_of) -> torch.Tensor:
    """The log p of each next token of ``tokens`` [T]: ``logits_of(a, b)``
    gives the fp32 logits of positions [a, b), taken
    :data:`SCORE_CHUNK` at a time.  Returns [T - 1] fp32."""
    T = tokens.shape[0]
    targets = torch.cat([tokens[1:], tokens.new_zeros(1)]).long()
    lp = [chosen_logprob(logits_of(c, c + SCORE_CHUNK), targets[c:c + SCORE_CHUNK])
          for c in range(0, T, SCORE_CHUNK)]
    return torch.cat(lp)[:T - 1]


def _finish_logits(logits, arch: ModelArch, lead) -> torch.Tensor:
    """Padded-vocab fp32 logits [N, vocab_padded] -> softcapped
    [*lead, vocab_size]."""
    logits = nn.softcap(logits, arch.final_logit_softcap)
    return logits.reshape(*lead, -1)[..., : arch.vocab_size]


class TensorParallelLM:
    """Tensor-parallel serving over a mesh's ``tensor`` axis, driven from
    one process (the counterpart of the JAX engine's GSPMD model on a
    TP mesh).

    Every device of the mesh holds one shard: a :class:`TransformerLM`
    over ``local_arch(arch, n)`` (its heads, KV heads and intermediate
    columns, and its rows of the logits head) whose kernel wrappers run
    unchanged.  The shards run in lockstep, one layer at a time; the two
    row-parallel projections (attention-out and MLP-down) reduce their
    partial sums across the shards: ``psum_linear`` in prefill and in
    decode with the comm-overlap gate off, the pipelined ring
    (``overlap_linear``, and ``all_gather_matmul`` for the plain
    column-parallel q/gate/up) in decode with it on.  Quantized o/down
    then take layer (i + 1) mod L's slab as their prefetch (K6): the JAX
    model's rolled ``_prefetch_stack`` is an index here.  Logits are
    each shard's vocabulary rows, gathered on the first shard's device.

    The forward passes take and return the same things as
    TransformerLM's, with a list of per-shard :class:`KVCache` for the
    cache; inputs are copied to every shard's device.
    """

    def __init__(self, arch: ModelArch, mesh: Mesh,
                 dtype: torch.dtype = torch.bfloat16):
        self.arch, self.mesh, self.dtype = arch, mesh, dtype
        self.n = mesh.size(AXIS_TENSOR)
        check_tensor_parallel(arch, self.n)
        self.device = mesh.devices[0]
        local = local_arch(arch, self.n)
        self.shards = [TransformerLM(local, dtype, dev, vocab_shard=(r, self.n))
                       for r, dev in enumerate(mesh.devices)]
        # the full-width model: names, shapes and synthetic draws (no
        # weights of its own)
        self.spec = TransformerLM(arch, dtype, self.device)
        self.is_mla = self.spec.is_mla
        self.groups = self.spec.groups
        self.vocab_padded = self.spec.vocab_padded
        self.overlap = False       # the engine's comm-overlap gate
        self.lora_scaling = 0.0

    def _layer_specs(self, moe: bool = False) -> dict[str, tuple[int, ...]]:
        return self.spec._layer_specs(moe)

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def _install(self, leaves, quantization: str = "") -> None:
        """Cut each full leaf into its shards as it comes (quantizing a
        plain projection whole first, on the first device) and install
        the shard trees: at most one full leaf is held at a time."""
        trees: list[dict] = [{} for _ in self.shards]
        for group, name, t in leaves:
            if quantization and group and is_quantized_leaf(group, name) \
                    and not is_qtensor(t):
                t = quantize_weight(t.to(device=self.device, dtype=self.dtype),
                                    quantization)
            for r, piece in enumerate(shard_leaf(group, name, t, self.n)):
                dev = self.mesh.devices[r]
                piece = ({k: v.to(dev) for k, v in piece.items()}
                         if isinstance(piece, dict) else piece.to(dev))
                (trees[r].setdefault(group, {}) if group else trees[r])[name] = piece
            del t
        for shard, tree in zip(self.shards, trees):
            shard.load_params(tree)

    def init_params(self, seed: int = 0, quantization: str = "") -> None:
        """The synthetic weights of a single-device TransformerLM on the
        first device, each leaf cut into its shards as it is drawn."""
        self._install(self.spec.synthetic_leaves(seed, quantization))

    def load_params(self, tree: dict, quantization: str = "") -> None:
        """A full tree (plain or quantized, as
        :meth:`TransformerLM.load_params` takes it), quantized whole under
        ``quantization`` and cut into the shards; ``serve_lora`` stacks are
        split with :meth:`set_lora`."""
        lora = tree.get("serve_lora")
        self._install(_leaves({k: v for k, v in tree.items() if k != "serve_lora"}),
                      quantization)
        if lora:
            self.set_lora(lora)

    def param_bytes(self) -> int:
        return sum(m.param_bytes() for m in self.shards)

    # ------------------------------------------------------------------
    # Per-request adapter lanes: each shard holds its split of every lane
    # ------------------------------------------------------------------

    def lora_specs(self) -> dict:
        return self.spec.lora_specs()

    @property
    def lora(self) -> list[dict]:
        return [m.lora for m in self.shards]

    def alloc_lora(self, lanes: int, rmax: int) -> None:
        """Each shard's lanes at its local widths: column-parallel targets
        hold their out columns of B, row-parallel ones their in rows of A
        (:func:`lora_shard`)."""
        for m in self.shards:
            m.alloc_lora(lanes, rmax)

    def set_lora(self, stacks: dict) -> None:
        for r, m in enumerate(self.shards):
            m.set_lora({g: {k: lora_shard(k[:-2], k[-1], x, r, self.n)
                            for k, x in buf.items()}
                        for g, buf in stacks.items()})

    def write_lora_lane(self, lane: int, group: str, t: str, a, b) -> None:
        for r, m in enumerate(self.shards):
            m.write_lora_lane(lane, group, t, lora_shard(t, "a", a, r, self.n),
                              lora_shard(t, "b", b, r, self.n))

    # ------------------------------------------------------------------
    # Lockstep execution
    # ------------------------------------------------------------------

    def _rep(self, t):
        """``t`` on every shard's device (one copy per distinct device)."""
        if t is None:
            return [None] * self.n
        on: dict = {}
        for d in self.mesh.devices:
            if d not in on:
                on[d] = t.to(d)
        return [on[d] for d in self.mesh.devices]

    def _each(self, method: str, *args) -> list:
        """``shard.method(*args)`` on every shard, each with the args on its
        device."""
        reps = [self._rep(a) for a in args]
        return [getattr(m, method)(*(r[i] for r in reps))
                for i, m in enumerate(self.shards)]

    def _prefetch(self, g: LayerGroup, i: int) -> dict:
        """Each shard's layer (i + 1) mod L slab of the quantized o and
        down weights ({} for plain weights)."""
        j = (i + 1) % g.count
        out = {}
        for name in ("o", "down"):
            if name in self.shards[0].qstacks[g.name]:
                out[name] = [{k: t[j] for k, t in m.qstacks[g.name][name].items()}
                             for m in self.shards]
        return out

    def _layer(self, xs, ps, caches, li, mode, kws, ov, pf, loras, ids):
        sh, mesh, n = self.shards, self.mesh, self.n
        hs = [m._norm(x, p, "attn_norm") for m, x, p in zip(sh, xs, ps)]
        qs = [None] * n
        if ov and ag_matmul_eligible(hs[0], ps[0]["q"], n):
            qs = all_gather_matmul(hs, [p["q"] for p in ps], mesh)
        o_in = [m._attention(h, p, c, li, mode, q_proj=q, lora=lo, ids=d, **kw)
                for m, h, p, c, q, kw, lo, d in zip(sh, hs, ps, caches, qs, kws,
                                                    loras, ids)]
        wo = [p["o"] for p in ps]
        # each shard's o delta (its rows of A) joins its partial sum
        add = [nn.multi_lora_delta(o, lo, "o", d) for o, lo, d in zip(o_in, loras, ids)]
        add = add if any(a is not None for a in add) else None
        attn = (overlap_linear(o_in, wo, mesh, prefetch=pf.get("o"), add=add) if ov
                else psum_linear(o_in, wo, mesh, add=add))
        res = [m._attn_residual(x, h, a, p)
               for m, x, h, a, p in zip(sh, xs, hs, attn, ps)]
        outs = nn.mlp([r[1] for r in res], ps, self.arch, mesh=mesh, overlap=ov,
                      pf_down=pf.get("down"), lora=loras, lora_ids=ids)
        return [m._mlp_residual(r[0], o, p) for m, r, o, p in zip(sh, res, outs, ps)]

    def _run_layers(self, caches, ins, mode, adapter_ids=None):
        """``ins``: each shard's (embedded input, layer inputs);
        ``adapter_ids`` [B] or None."""
        xs, kws = [x for x, _ in ins], [kw for _, kw in ins]
        ov = self.overlap and mode == "decode"
        ids = [None] * self.n
        if adapter_ids is not None and self.shards[0].lora:
            ids = self._rep(adapter_ids.long())
        for g in self.groups:
            for i in range(g.count):
                ps = [m._layer_params(g, i) for m in self.shards]
                pf = self._prefetch(g, i) if ov else {}
                loras = [m._lora_layer(g, i) if d is not None else None
                         for m, d in zip(self.shards, ids)]
                xs = self._layer(xs, ps, caches, g.start + i, mode, kws, ov, pf,
                                 loras, ids)
        return xs

    def _logits(self, xs):
        """Every shard's vocabulary rows, gathered on the first device."""
        x = xs[0]
        parts = [m._logits_local(xi.reshape(-1, xi.shape[-1])).to(self.device)
                 for m, xi in zip(self.shards, xs)]
        return _finish_logits(torch.cat(parts, dim=-1), self.arch, x.shape[:-1])

    # ------------------------------------------------------------------
    # Forward passes (TransformerLM's, over per-shard caches)
    # ------------------------------------------------------------------

    def prefill(self, caches: list, tokens, true_lens, page_tables,
                start_pos=None, adapter_ids=None):
        if start_pos is not None:
            page_tables = attn.history_pages(page_tables, start_pos, true_lens,
                                             caches[0].k.shape[2])
        ins = self._each("_prefill_in", tokens, true_lens, page_tables, start_pos)
        xs = self._run_layers(caches, ins, "prefill", adapter_ids)
        lasts = self._each_out("_prefill_out", xs, true_lens)
        return caches, self._logits(lasts), lasts[0]

    def prefill_packed(self, caches: list, tokens, seg_ids, positions,
                       tok_pages, last_idx, pack_pages=None, tok_pgslot=None,
                       adapter_ids=None):
        if caches[0].quantized and (pack_pages is None or tok_pgslot is None):
            raise ValueError("an int8 KV cache needs pack_pages and tok_pgslot")
        ins = self._each("_packed_in", tokens, seg_ids, positions, tok_pages,
                         pack_pages, tok_pgslot)
        xs = self._run_layers(caches, ins, "prefill_packed", adapter_ids)
        lasts = self._each_out("_packed_out", xs, last_idx)
        return caches, self._logits(lasts), lasts[0]

    def verify_window_logits(self, caches: list, tokens, true_lens, page_tables,
                             start_pos, adapter_ids=None):
        ins = self._each("_prefill_in", tokens, true_lens, page_tables, start_pos)
        xs = self._run_layers(caches, ins, "prefill", adapter_ids)
        return caches, self._logits([m._norm(x, m.top, "final_norm")
                                     for m, x in zip(self.shards, xs)])

    def decode(self, caches: list, tokens, positions, page_tables, active=None,
               adapter_ids=None):
        ins = self._each("_decode_in", tokens, positions, page_tables, active)
        xs = self._run_layers(caches, ins, "decode", adapter_ids)
        return caches, self._logits([m._decode_out(x)
                                     for m, x in zip(self.shards, xs)])

    def score(self, tokens, true_len):
        """TransformerLM.score over the shards: each shard's heads and
        columns, the row-parallel sums reduced as in prefill, the
        vocabulary rows of every shard gathered a chunk at a time."""
        ins = self._each("_score_in", tokens, true_len)
        xs = [x[0] for x in self._run_layers([None] * self.n, ins, "score")]
        return _score_logprobs(tokens[0].to(self.device), lambda a, b: self._logits(
            [m._norm(x[a:b], m.top, "final_norm") for m, x in zip(self.shards, xs)]))

    def _each_out(self, method: str, xs, t):
        return [getattr(m, method)(x, ti)
                for m, x, ti in zip(self.shards, xs, self._rep(t))]
