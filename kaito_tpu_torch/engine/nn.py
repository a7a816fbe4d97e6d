"""Neural-net building blocks for the config-driven transformer.

Plain functions over tensors, the counterpart of ``kaito_tpu.engine.nn``.
Weights keep the JAX package's ``[in, out]`` layout, so a projection is
``x @ w``.  Compute runs in the weights' dtype (bf16 on the card) with
fp32 norms, rope and activations' inputs where the JAX package has them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from kaito_tpu_torch.device import resolve_device
from kaito_tpu_torch.engine.ops.overlap_collectives import (
    ag_matmul_eligible, all_gather_matmul, overlap_linear, psum_linear)
from kaito_tpu_torch.engine.ops.quant_matmul import quant_linear
from kaito_tpu_torch.engine.quant import dequant_weight
from kaito_tpu_torch.models.metadata import ModelArch
from kaito_tpu_torch.parallel.mesh import Mesh


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a plain ``[in, out]`` weight; a QTensor dict
    (``engine.quant``) goes through the fused dequant matmul."""
    if isinstance(w, dict):
        return quant_linear(x, w)
    return x @ w


def lora_delta(x: torch.Tensor, p: dict, name: str,
               scaling: float) -> Optional[torch.Tensor]:
    """The low-rank update ``(x @ A) @ B * scaling`` when the layer
    carries lora factors for ``name`` (``{name}_lora_a`` [in, r],
    ``{name}_lora_b`` [r, out]); None when it does not."""
    a = p.get(f"{name}_lora_a")
    if a is None:
        return None
    return ((x @ a) @ p[f"{name}_lora_b"]) * scaling


def plus_lora(y: torch.Tensor, x: torch.Tensor, p: dict, name: str,
              scaling: Optional[float]) -> torch.Tensor:
    """``y`` plus the training-form update :func:`lora_delta` of ``x`` for
    ``name`` (``y`` itself when ``scaling`` is None, outside training, or
    the layer carries no factors for ``name``)."""
    d = None if scaling is None else lora_delta(x, p, name, scaling)
    return y if d is None else y + d


def multi_lora_delta(x: torch.Tensor, lora: Optional[dict], name: str,
                     ids: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Per-request batched LoRA: every row of the batch applies its own
    adapter's low-rank update (lane 0 is the base's zeros).  x: [B, T,
    E]; ``lora[f"{name}_a"]`` [lanes, E, r] and ``lora[f"{name}_b"]``
    [lanes, r, out] are this layer's lanes (scaling folded into B);
    ids: [B] int64 lanes.  The two products run as batched matmuls over
    each row's gathered lane (``kaito_tpu.engine.nn.multi_lora_delta``'s
    einsums).  None without lanes for ``name`` or without ids."""
    if lora is None or ids is None:
        return None
    a = lora.get(f"{name}_a")
    if a is None:
        return None
    return torch.bmm(torch.bmm(x, a[ids]), lora[f"{name}_b"][ids])


def plus_delta(y: torch.Tensor, x: torch.Tensor, lora: Optional[dict], name: str,
               ids: Optional[torch.Tensor]) -> torch.Tensor:
    """``y`` plus the multi-LoRA delta of ``x`` for ``name`` (``y`` itself
    when there is none)."""
    d = multi_lora_delta(x, lora, name, ids)
    return y if d is None else y + d


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             offset: bool) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = scale.float()
    if offset:
        w = 1.0 + w
    return (y * w).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def apply_norm(x: torch.Tensor, params: dict, arch: ModelArch) -> torch.Tensor:
    if arch.norm_type == "layernorm":
        return layer_norm(x, params["scale"], params.get("bias"),
                          arch.rms_norm_eps)
    return rms_norm(x, params["scale"], arch.rms_norm_eps, arch.norm_offset)


# ---------------------------------------------------------------------------
# Rotary position embedding (linear, llama3, yarn and longrope scaling)
# ---------------------------------------------------------------------------

def _rope_type(arch: ModelArch) -> str:
    scaling = arch.rope_scaling or {}
    return str(scaling.get("rope_type", scaling.get("type", ""))).lower()


def _rot_dim(arch: ModelArch) -> int:
    rot_dim = int(arch.head_dim * arch.partial_rotary_factor)
    return rot_dim - rot_dim % 2


def _base_inv_freq(arch: ModelArch, device: torch.device) -> torch.Tensor:
    rot_dim = _rot_dim(arch)
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                            device=device) / rot_dim
    return 1.0 / (arch.rope_theta ** exponent)


def _yarn_find_correction_dim(num_rotations: float, dim: int, base: float,
                              max_pos: float) -> float:
    return (dim * math.log(max_pos / (num_rotations * 2 * math.pi))
            ) / (2 * math.log(base))


def yarn_get_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN attention-magnitude correction (0.1·m·ln(s)+1)."""
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def rope_frequencies(arch: ModelArch,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """Per-pair inverse frequencies, fp32 ``[rot_dim // 2]`` on
    ``device``, with the linear, llama3, yarn (NTK-by-parts) or longrope
    (per-dim factors) scaling applied."""
    rope_type = _rope_type(arch)
    device = resolve_device(device)
    rot_dim = _rot_dim(arch)
    inv_freq = _base_inv_freq(arch, device)

    scaling = arch.rope_scaling or {}
    if rope_type == "linear":
        inv_freq = inv_freq / float(scaling.get("factor", 1.0))
    elif rope_type == "llama3":
        # Llama-3.1 frequency-dependent scaling: low-frequency components
        # are stretched by `factor`, high-frequency kept, mid smoothed.
        factor = float(scaling.get("factor", 8.0))
        low = float(scaling.get("low_freq_factor", 1.0))
        high = float(scaling.get("high_freq_factor", 4.0))
        old_len = float(scaling.get("original_max_position_embeddings", 8192))
        wavelen = 2.0 * math.pi / inv_freq
        low_wl = old_len / low
        high_wl = old_len / high
        smooth = ((old_len / wavelen - low) / (high - low)).clamp(0.0, 1.0)
        inv_freq = torch.where(
            wavelen > low_wl, inv_freq / factor,
            torch.where(wavelen < high_wl, inv_freq,
                        (1 - smooth) * inv_freq / factor + smooth * inv_freq))
    elif rope_type == "yarn":
        # exact NTK-by-parts: high-frequency pairs keep the base table,
        # low-frequency pairs interpolate by `factor`, with a linear ramp
        # between the beta_fast/beta_slow correction dims
        factor = float(scaling.get("factor", 1.0))
        orig = float(scaling.get("original_max_position_embeddings",
                                 arch.max_position_embeddings))
        low = math.floor(_yarn_find_correction_dim(
            float(scaling.get("beta_fast", 32.0)), rot_dim, arch.rope_theta, orig))
        high = math.ceil(_yarn_find_correction_dim(
            float(scaling.get("beta_slow", 1.0)), rot_dim, arch.rope_theta, orig))
        low, high = max(low, 0), min(high, rot_dim - 1)
        if low == high:
            high += 0.001
        ramp = ((torch.arange(rot_dim // 2, dtype=torch.float32, device=device)
                 - low) / (high - low)).clamp(0.0, 1.0)
        extrap_mask = 1.0 - ramp
        inv_freq = (inv_freq / factor) * (1.0 - extrap_mask) + inv_freq * extrap_mask
    elif rope_type in ("longrope", "su"):
        # phi-3 family: per-dim rescale factors, long vs short chosen by
        # whether the model runs past its original trained length
        orig = float(scaling.get("original_max_position_embeddings",
                                 arch.max_position_embeddings))
        use_long = arch.max_position_embeddings > orig
        factors = scaling.get("long_factor" if use_long else "short_factor")
        if factors is not None:
            inv_freq = inv_freq / torch.tensor(factors, dtype=torch.float32,
                                               device=device)[: rot_dim // 2]
        else:
            inv_freq = inv_freq / float(scaling.get("factor", 1.0))
    return inv_freq


def longrope_tables(arch: ModelArch, device: str | torch.device = "cuda"):
    """Per-position longrope state for archs carrying factor lists:
    ``(short_inv_freq, long_inv_freq, orig_len, short_mscale,
    long_mscale)`` with the tables fp32 ``[rot_dim // 2]`` on ``device``;
    None otherwise.  Positions past the original trained length take the
    long table (the vLLM Phi3LongRoPE cache semantics), so a batch mixing
    short and long sequences gives each row its own."""
    scaling = arch.rope_scaling or {}
    if _rope_type(arch) not in ("longrope", "su") or "long_factor" not in scaling:
        return None
    device = resolve_device(device)
    base = _base_inv_freq(arch, device)
    half = _rot_dim(arch) // 2

    def table(key):
        return base / torch.tensor(scaling.get(key), dtype=torch.float32,
                                   device=device)[:half]

    orig = float(scaling.get("original_max_position_embeddings",
                             arch.max_position_embeddings))
    s = arch.max_position_embeddings / orig
    default_m = (math.sqrt(1.0 + math.log(s) / math.log(orig))
                 if s > 1.0 else 1.0)
    short_m = float(scaling.get("short_mscale") or default_m)
    long_m = float(scaling.get("long_mscale") or default_m)
    return table("short_factor"), table("long_factor"), orig, short_m, long_m


def rope_attention_factor(arch: ModelArch) -> float:
    """Magnitude correction multiplying the rotated dims' cos/sin (HF
    attention_scaling): an explicit ``attention_factor``; yarn's mscale
    (or the mscale/mscale_all_dim ratio when both are set, deepseek
    style, where the all-dim part moves into the softmax scale); and
    longrope's sqrt(1 + ln(s)/ln(orig))."""
    scaling = arch.rope_scaling or {}
    rope_type = _rope_type(arch)
    if scaling.get("attention_factor") is not None:
        return float(scaling["attention_factor"])
    if rope_type == "yarn":
        factor = float(scaling.get("factor", 1.0))
        mscale = float(scaling.get("mscale", 1.0))
        mad = scaling.get("mscale_all_dim")
        if mad is not None:
            return yarn_get_mscale(factor, mscale) / yarn_get_mscale(factor, float(mad))
        return yarn_get_mscale(factor, mscale)
    if rope_type in ("longrope", "su"):
        orig = float(scaling.get("original_max_position_embeddings",
                                 arch.max_position_embeddings))
        s = arch.max_position_embeddings / orig
        if s <= 1.0:
            return 1.0
        return math.sqrt(1.0 + math.log(s) / math.log(orig))
    return 1.0


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor, head_dim: int,
               mscale=1.0) -> torch.Tensor:
    """Rotate the first ``2*len(inv_freq)`` dims of each head.

    x: [..., seq, heads, head_dim]; positions: [..., seq].  ``inv_freq``
    is a plain ``[half]`` table or per position ``[..., seq, half]`` (the
    longrope short/long switch).  ``mscale``, a float or a tensor
    ``[..., seq, 1, 1]``, multiplies the rotated output; pass-through
    dims stay unscaled.
    """
    rot = 2 * inv_freq.shape[-1]
    angles = positions[..., :, None].float() * inv_freq     # [..., seq, rot/2]
    cos = torch.cos(angles)[..., :, None, :] * mscale
    sin = torch.sin(angles)[..., :, None, :] * mscale
    x_rot = x[..., :rot].float()
    x_pass = x[..., rot:]
    x1, x2 = x_rot.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def activation(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="none")
    if name in ("gelu_tanh", "gelu_new"):
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def _hidden(g: Optional[torch.Tensor], u: torch.Tensor, p: dict,
            arch: ModelArch) -> torch.Tensor:
    """The MLP's hidden activation from the gate (None for a classic MLP)
    and up projections."""
    if arch.gated_mlp:
        return activation(g, arch.hidden_act) * u
    if "up_bias" in p:
        u = u + p["up_bias"]
    return activation(u, arch.hidden_act)


def _down_bias(out: torch.Tensor, p: dict) -> torch.Tensor:
    return out + p["down_bias"] if "down_bias" in p else out


def mlp(x, p, arch: ModelArch, mesh: Optional[Mesh] = None,
        overlap: bool = False, pf_down: Optional[list] = None,
        lora=None, lora_ids=None, lora_scaling: Optional[float] = None):
    """Gated (SwiGLU/GeGLU) or classic 2-matrix MLP.

    ``lora`` and ``lora_ids`` are the layer's multi-LoRA lanes and the
    rows' lane ids (:func:`multi_lora_delta`): gate, up and down each
    add their delta when the lanes carry them.  ``lora_scaling`` (in
    training) adds the training-form update (:func:`plus_lora`) of
    ``p``'s factors at each of them (one device only).

    With a tensor-parallel ``mesh``, ``x`` and ``p`` are lists with one
    entry per shard (the replicated input, each shard's parameters), and
    so is the result (and ``lora`` / ``lora_ids``, when given).  gate/up
    are column-parallel and need no collective; the row-parallel down
    projection's partial sums are reduced by ``psum_linear``, each
    shard's down delta (its rows of A) added to its partial sum before
    the reduction.  ``overlap`` (the comm-overlap decode step) routes
    gate/up through the pipelined all-gather + matmul ring where
    ``ag_matmul_eligible`` holds, and down through ``overlap_linear``
    with ``pf_down`` (each shard's next-layer down slab, or None) as its
    layer-ahead prefetch."""
    if mesh is None:
        def proj(v, name):
            y = plus_delta(linear(v, p[name]), v, lora, name, lora_ids)
            return plus_lora(y, v, p, name, lora_scaling)

        g = proj(x, "gate") if arch.gated_mlp else None
        h = _hidden(g, proj(x, "up"), p, arch)
        return _down_bias(proj(h, "down"), p)
    n = len(x)
    lora = lora if lora is not None else [None] * n
    ids = lora_ids if lora_ids is not None else [None] * n

    def col(name):
        ws = [pi[name] for pi in p]
        if overlap and ag_matmul_eligible(x[0], ws[0], n):
            ys = all_gather_matmul(x, ws, mesh)
        else:
            ys = [linear(xi, wi) for xi, wi in zip(x, ws)]
        return [plus_delta(y, xi, li, name, d) for y, xi, li, d in zip(ys, x, lora, ids)]

    gs = col("gate") if arch.gated_mlp else [None] * n
    h = [_hidden(g, u, pi, arch) for g, u, pi in zip(gs, col("up"), p)]
    wd = [pi["down"] for pi in p]
    add = [multi_lora_delta(hi, li, "down", d) for hi, li, d in zip(h, lora, ids)]
    add = add if any(a is not None for a in add) else None
    down = (overlap_linear(h, wd, mesh, prefetch=pf_down, add=add) if overlap
            else psum_linear(h, wd, mesh, add=add))
    return [_down_bias(d, pi) for d, pi in zip(down, p)]


# ---------------------------------------------------------------------------
# Token-choice mixture of experts
# ---------------------------------------------------------------------------

def _route(x: torch.Tensor, router: torch.Tensor, k: int):
    """fp32 router logits, the top ``k`` experts of each token and a
    softmax over their k logits: (weights [T, k] fp32, experts [T, k]).
    ``jax.lax.top_k`` breaks a tie toward the lower expert index;
    ``torch.topk`` does not promise that, so tied router logits may pick
    another expert than the JAX package."""
    logits = x.float() @ router.float()
    weights, idx = torch.topk(logits, k, dim=-1, sorted=True)
    return torch.softmax(weights, dim=-1), idx


def _shared_experts(y, x, p, arch):
    if "shared_gate" not in p:
        return y
    shared = {"gate": p["shared_gate"], "up": p["shared_up"],
              "down": p["shared_down"]}
    return y + mlp(x, shared, arch)


def _expert_weight(w, dtype) -> torch.Tensor:
    """An expert stack [X, in, out] in ``dtype`` for a product whose
    int8 scale is applied after it: a plain stack as it is, int8 codes
    widened unscaled, int4 dequantized whole (its per-group scales do not
    fold after the product), as the JAX package's ``moe_mlp`` does."""
    if not isinstance(w, dict):
        return w
    if "q8" in w:
        return w["q8"].to(dtype)
    return dequant_weight(w, dtype)


def moe_mlp(x: torch.Tensor, p: dict, arch: ModelArch) -> torch.Tensor:
    """Token-choice MoE with dense expert compute (``kaito_tpu.engine.nn.
    moe_mlp``): every token through every expert, weighted by a dense
    [T, X] routing matrix that holds its top-k softmax weights.  x:
    [T, E].  Static shapes and exact, at X / k times the ragged form's
    products; the products round to x's dtype, the weighted sum runs in
    fp32."""
    T = x.shape[0]
    weights, idx = _route(x, p["router"], arch.num_experts_per_tok)
    route = torch.zeros((T, arch.num_experts), dtype=torch.float32,
                        device=x.device).scatter(1, idx, weights)

    def expert_dot(lhs, w):
        """lhs [X, T, in] (or [T, in], the same for every expert) @ each
        expert's [in, out] -> [X, T, out] in lhs's dtype."""
        out = torch.matmul(lhs, _expert_weight(w, lhs.dtype))
        if isinstance(w, dict) and "q8" in w:
            out = out * w["scale"][:, None, :].to(lhs.dtype)
        return out

    gate = expert_dot(x, p["experts_gate"])
    up = expert_dot(x, p["experts_up"])
    h = activation(gate, arch.hidden_act) * up
    out = expert_dot(h, p["experts_down"])                    # [X, T, E]
    y = torch.einsum("xte,tx->te", out.float(), route).to(x.dtype)
    return _shared_experts(y, x, p, arch)


def moe_mlp_ragged(x: torch.Tensor, p: dict, arch: ModelArch,
                   grouped: bool = False,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-choice MoE through grouped products (``kaito_tpu.engine.nn.
    moe_mlp_ragged``): the (token, slot) rows sort by expert and each
    expert multiplies its own contiguous group, so the products scale
    with k, not with the expert count.  x: [T, E].

    The group boundaries stay on the device.  ``grouped=False`` reads
    them on the host and runs one fp32 product per non-empty group, as
    ``lax.ragged_dot(preferred_element_type=float32)`` does: the form of
    the CPU, whose results match the JAX package's.  ``grouped=True``
    hands them to one ``torch._grouped_mm`` call, which no host read
    precedes, so a CUDA graph can hold it; on the card it takes bf16
    only, and its products round to bf16 before the activation.

    ``valid`` [T] (the decode batch's active rows) sends the rows of the
    other tokens into no group: they multiply nothing and read no
    expert's weights, and their routed share comes out zero.  Rows of
    valid tokens do not change.

    The combine gathers each token's k rows back through the inverse of
    the sort and sums them in slot order, in fp32: no atomics, so two
    runs on the card give the same bits (the JAX package's
    ``.at[token_of].add`` sums in sorted order)."""
    T, E = x.shape
    X, k = arch.num_experts, arch.num_experts_per_tok
    weights, idx = _route(x, p["router"], k)
    flat = idx.reshape(-1)                                  # [T * k]
    if valid is not None:
        flat = torch.where(valid.repeat_interleave(k), flat, X)
    order = torch.argsort(flat, stable=True)
    expert_of_row = flat[order]
    x_sorted = x[order // k]
    # each expert's group ends here in the sorted rows; rows past the
    # last end belong to no group
    ends = torch.searchsorted(expert_of_row,
                              torch.arange(X, device=x.device, dtype=flat.dtype),
                              right=True)
    rows_expert = expert_of_row.clamp(max=X - 1)
    bounds = None if grouped else [0] + ends.tolist()

    def products(lhs, w):
        wt = _expert_weight(w, lhs.dtype)
        if grouped:
            out = torch._grouped_mm(lhs, wt, offs=ends.to(torch.int32)).float()
        else:
            out = torch.zeros((lhs.shape[0], wt.shape[-1]), dtype=torch.float32,
                              device=lhs.device)
            for e in range(X):
                lo, hi = bounds[e], bounds[e + 1]
                if hi > lo:
                    out[lo:hi] = lhs[lo:hi].float() @ wt[e].float()
        if isinstance(w, dict) and "q8" in w:
            out = out * w["scale"][rows_expert]
        return out

    gate = products(x_sorted, p["experts_gate"])
    up = products(x_sorted, p["experts_up"])
    h = (activation(gate, arch.hidden_act) * up).to(x.dtype)
    out = products(h, p["experts_down"])                      # [T * k, E]
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=x.device)
    y = (out[inverse].reshape(T, k, E) * weights[..., None]).sum(dim=1)
    if valid is not None:
        y = torch.where(valid[:, None], y, 0.0)
    return _shared_experts(y.to(x.dtype), x, p, arch)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap
