"""Weight-only quantization (int8 / packed int4) for serving.

Counterpart of ``kaito_tpu.engine.quant``, with the same QTensor
convention and bit-identical layouts, so a tree quantized by either
package serves in the other and the committed int8 / int4 goldens apply:

``int8`` — per-out-channel symmetric: ``[.., in, out]`` becomes
``{"q8": int8[.., in, out], "scale": f32[.., out]}`` with
``scale = absmax/127``.

``int4`` — per-group per-out-channel symmetric (g = 128 in-rows, or one
whole-column group when ``in % 128 != 0``): ``[.., in, out]`` becomes
``{"q4": int8[.., in/2, out], "scale": f32[.., G, out]}``.  Byte ``i``
packs two ADJACENT in-rows, row ``2i`` in the low nibble and ``2i+1`` in
the high nibble, each stored biased by +8, with codes clipped to
[-7, 7].

``torch.round`` rounds half to even, as ``jnp.round`` does.  The JAX
engine quantizes under ``jit``, where XLA turns the division of the
absmax by the constant 127 (or 7) into a multiplication by its fp32
reciprocal; the port multiplies by the same reciprocal, so the codes and
scales equal the JAX engine's bit for bit (and the goldens apply).

Dequantization happens on use: ``nn.linear`` routes QTensors through
``engine.ops.quant_matmul``.  Embeddings, norms, biases and the lm_head
stay in the model dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from kaito_tpu_torch.models.metadata import ModelArch

# layer-stack keys whose matmuls dequantize on use: dense attention and
# MLP, MLA's latent projections (kv_b_k / kv_b_v stay plain), expert
# stacks, which quantize per (layer, expert, out column) of [L, X, in,
# out], and shared experts
QUANT_KEYS = (
    "q", "k", "v", "o", "gate", "up", "down",
    "q_a", "q_b", "kv_a",
    "experts_gate", "experts_up", "experts_down",
    "shared_gate", "shared_up", "shared_down",
)

# weight-quantization schemes the engine can serve
QUANT_SCHEMES = ("int8", "int4")

# int4 group size: 128 in-rows share a scale row
INT4_GROUP = 128

# fp32 reciprocals of the code ranges (see the module docstring)
INV_127 = float(np.float32(1.0 / 127.0))
_INV_7 = float(np.float32(1.0 / 7.0))


def supports_quantization(arch: ModelArch, scheme: str = "int8") -> bool:
    """Whether ``scheme`` can quantize every QUANT_KEYS matmul of this
    family: int4 packs two in-rows per byte, so in-dims must be even."""
    if scheme not in QUANT_SCHEMES:
        return False
    if scheme == "int4":
        return arch.hidden_size % 2 == 0
    return True


def is_quantized_leaf(group: str, name: str) -> bool:
    """Whether :func:`quantize_params` turns params[group][name] into a
    QTensor (adapter stacks never quantize)."""
    return group != "serve_lora" and name in QUANT_KEYS


def is_qtensor(w) -> bool:
    return isinstance(w, dict) and ("q8" in w or "q4" in w)


def qtensor_kind(w) -> str:
    """'int8' / 'int4' for a QTensor dict, '' for anything else."""
    if isinstance(w, dict):
        if "q8" in w:
            return "int8"
        if "q4" in w:
            return "int4"
    return ""


def int4_group_size(w: dict) -> int:
    """The group size of an int4 QTensor, from its shapes (the
    quantizer only emits uniform groups)."""
    return (2 * w["q4"].shape[-2]) // w["scale"].shape[-2]


def qtensor_logical_axes(ax: tuple, scheme: str = "int8") -> dict:
    """Logical axes of the QTensor quantized from a weight whose axes are
    ``ax``.  int8: q8 keeps the weight's axes; the per-out-channel scale
    drops the contracted (in, second-to-last) dim.  int4: q4 keeps the
    weight's axes (the packed dim is still the in axis, at half length),
    and the scale's GROUP dim takes the in axis's assignment, so a TP
    shard of packed rows owns exactly its groups' scale rows.

    That holds only when every shard owns whole groups of
    ``INT4_GROUP`` in-rows: a row-parallel weight's in-dim over the TP
    degree must be a multiple of 128 (or the weight a single group).
    The engine refuses a TP degree where it is not."""
    if scheme == "int4":
        return {"q4": ax, "scale": ax[:-2] + (ax[-2],) + ax[-1:]}
    return {"q8": ax, "scale": ax[:-2] + ax[-1:]}


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[.., in, out] integer nibbles in [-8, 7] -> [.., in/2, out] int8:
    byte i = (row 2i + 8) | ((row 2i+1 + 8) << 4)."""
    lo = (q[..., 0::2, :] + 8).to(torch.uint8)
    hi = (q[..., 1::2, :] + 8).to(torch.uint8)
    return (lo | (hi << 4)).view(torch.int8)


def unpack_int4(q4: torch.Tensor) -> torch.Tensor:
    """[.., in/2, out] int8 -> [.., in, out] int32 values in [-8, 7]
    (the exact inverse of :func:`_pack_int4`)."""
    p = q4.to(torch.int32) & 0xFF          # drop the int8 sign extension
    lo = (p & 0xF) - 8
    hi = ((p >> 4) & 0xF) - 8
    stacked = torch.stack([lo, hi], dim=-2)   # [.., in/2, 2, out]
    return stacked.reshape(*q4.shape[:-2], 2 * q4.shape[-2], q4.shape[-1])


def quantize_weight_int8(w: torch.Tensor) -> dict:
    """[.., in, out] -> {"q8": int8, "scale": f32[.., out]}.  The result
    is allocated before the fp32 temporaries (see :func:`quantize_weight`)."""
    q8 = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((*w.shape[:-2], w.shape[-1]), dtype=torch.float32,
                        device=w.device)
    w32 = w.float()
    torch.mul(w32.abs().amax(dim=-2), INV_127, out=scale).clamp_min_(1e-8)
    q8.copy_(torch.round(w32 / scale[..., None, :]).clamp_(-127, 127))
    return {"q8": q8, "scale": scale}


def quantize_weight_int4(w: torch.Tensor, group: int = INT4_GROUP) -> dict:
    """[.., in, out] -> {"q4": int8[.., in/2, out], "scale": f32[.., G, out]}.

    Nibbles are symmetric [-7, 7] (scale = group absmax / 7); -8 never
    occurs in the quantizer's output."""
    K, N = w.shape[-2], w.shape[-1]
    if K % 2:
        raise ValueError(f"int4 packs two in-rows per byte; in-dim {K} is odd")
    g = group if K % group == 0 else K
    lead = w.shape[:-2]
    q4 = torch.empty((*lead, K // 2, N), dtype=torch.int8, device=w.device)
    scale = torch.empty((*lead, K // g, N), dtype=torch.float32, device=w.device)
    grouped = w.float().reshape(*lead, K // g, g, N)
    torch.mul(grouped.abs().amax(dim=-2), _INV_7, out=scale).clamp_min_(1e-8)
    q = torch.round(grouped / scale[..., None, :]).clamp_(-7, 7)
    q4.copy_(_pack_int4(q.to(torch.int32).reshape(*lead, K, N)))
    return {"q4": q4, "scale": scale}


def quantize_weight(w: torch.Tensor, scheme: str = "int8") -> dict:
    """``w`` quantized under ``scheme``.  On the card the caching
    allocator's free blocks go back first, so the result, allocated
    before the temporaries, takes fresh segments: carved out of an
    earlier leaf's freed temporary, it would pin that temporary's whole
    segment, room the KV pool sized after the weights could not take
    (PERF.md)."""
    if w.is_cuda:
        torch.cuda.empty_cache()
    if scheme == "int8":
        return quantize_weight_int8(w)
    if scheme == "int4":
        return quantize_weight_int4(w)
    raise ValueError(f"unknown quantization scheme {scheme!r} "
                     f"(known: {', '.join(QUANT_SCHEMES)})")


def dequant_weight(w: dict, dtype: torch.dtype) -> torch.Tensor:
    """A QTensor back to a full-precision ``[.., in, out]`` tensor."""
    if "q8" in w:
        return (w["q8"].float() * w["scale"][..., None, :]).to(dtype)
    g = int4_group_size(w)
    q = unpack_int4(w["q4"]).float()
    scale = w["scale"].repeat_interleave(g, dim=-2)
    return (q * scale).to(dtype)


def quantize_params(params: dict, scheme: str = "int8") -> dict:
    """A new parameter tree whose layer-group QUANT_KEYS are QTensors;
    other leaves, top-level params and adapter stacks pass through.
    Unknown schemes raise: a mistyped scheme never serves bf16."""
    if scheme not in QUANT_SCHEMES:
        raise ValueError(f"unknown quantization scheme {scheme!r} "
                         f"(known: {', '.join(QUANT_SCHEMES)})")
    out = dict(params)
    for group, sub in params.items():
        if not isinstance(sub, dict):
            continue
        out[group] = {key: (quantize_weight(w, scheme)
                            if is_quantized_leaf(group, key) and not is_qtensor(w)
                            else w)
                      for key, w in sub.items()}
    return out
