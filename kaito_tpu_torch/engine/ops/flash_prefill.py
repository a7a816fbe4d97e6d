"""Flash attention for prefill chunks: the CUDA kernels and their plain
versions.

Counterpart of ``kaito_tpu.engine.ops.flash_prefill``.  One CUDA source
(``kaito_tpu_torch/csrc/flash_prefill.cu``) holds both kernels, with the
mask mode as a template parameter:

- :func:`flash_prefill_attention_cuda` replaces the Pallas TPU kernel
  ``flash_prefill_attention``: causal attention over a fresh chunk,
  masked by ``true_len``, a sliding window and an optional softcap;
- :func:`flash_prefill_packed_cuda` replaces ``flash_prefill_packed``:
  many fresh prompts packed into one row, attending only within their
  own segment (pads carry segment id -1).

Each wrapper launches its kernel for tensors on the card and runs its
plain version for tensors on the CPU; a CUDA tensor it cannot take
raises.  ``launches`` on each wrapper counts kernel launches.  The
kernels mask the ragged tail themselves, so T needs no block multiple.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from kaito_tpu_torch.ops import build

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _flash_plain(q, k, v, mask, scale, softcap):
    """Shared plain arithmetic: q pre-scaled in q's dtype, fp32 scores
    and softmax, P rounded to the input dtype before the PV product,
    normalised after it.  ``mask`` is [B, T, T] (query, key)."""
    B, T, H, D = q.shape
    G = H // k.shape[2]
    qs = (q * scale).to(q.dtype).float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bthd,bshd->bhts", qs, kf)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask[:, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhts,bshd->bhtd", p.to(v.dtype).float(), vf.float())
    out = pv / l.clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


def flash_prefill_attention_plain(
    q: torch.Tensor,            # [B, T, H, D]
    k: torch.Tensor,            # [B, T, Hkv, D]
    v: torch.Tensor,
    true_len: torch.Tensor,     # [B] int32
    window: int,                # huge == global
    *,
    scale: float,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    T = q.shape[1]
    pos = torch.arange(T, device=q.device)
    qp, kp = pos[:, None], pos[None, :]
    mask = (kp <= qp) & (kp > qp - window)
    mask = mask[None] & (kp[None] < true_len.long()[:, None, None])
    return _flash_plain(q, k, v, mask, scale, softcap)


def flash_prefill_packed_plain(
    q: torch.Tensor,            # [B, T, H, D] segment-packed row(s)
    k: torch.Tensor,            # [B, T, Hkv, D]
    v: torch.Tensor,
    seg_ids: torch.Tensor,      # [B, T] int32 (-1 = pad)
    positions: torch.Tensor,    # [B, T] int32 within-segment positions
    window: int,
    *,
    scale: float,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    sq, sk = seg_ids[:, :, None], seg_ids[:, None, :]
    pq, pk = positions[:, :, None], positions[:, None, :]
    mask = (sq == sk) & (sq >= 0) & (pk <= pq) & (pk > pq - window)
    return _flash_plain(q, k, v, mask, scale, softcap)


# (q, k, v, out, *index tensors, B, T, H, Hkv, D, window, scale, softcap,
#  dtype, stream) for each C entry point
_TAIL = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                              ctypes.c_void_p]
_ARGTYPES = {"kaito_flash_prefill": [ctypes.c_void_p] * 5 + _TAIL,
             "kaito_flash_prefill_packed": [ctypes.c_void_p] * 6 + _TAIL}


@functools.cache
def _kernel(symbol: str):
    return build.bind("flash_prefill", symbol, _ARGTYPES[symbol])


def _check_qkv(q, k, v):
    B, T, H, D = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash kernels take float32 or bfloat16, got {q.dtype}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in {SUPPORTED_HEAD_DIMS}, "
                         f"got {D}")
    Hkv = k.shape[2]
    if k.shape != (B, T, Hkv, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share dtype and device")
    return B, T, H, Hkv, D


def _int32(t: torch.Tensor, shape, device, name):
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) \
            or t.device != device:
        raise ValueError(f"{name} must be int32 {tuple(shape)} on {device}")
    return t.contiguous()


def flash_prefill_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    true_len: torch.Tensor,
    window: int,
    *,
    scale: float,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Causal flash attention over fresh chunks (contract of
    :func:`flash_prefill_attention_plain`)."""
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, k, v, true_len, window,
                                             scale=scale, softcap=softcap)
    B, T, H, Hkv, D = _check_qkv(q, k, v)
    true_len = _int32(true_len, (B,), q.device, "true_len")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    rc = build.launch(
        q.device, _kernel("kaito_flash_prefill"),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        true_len.data_ptr(), B, T, H, Hkv, D, int(min(window, 2**31 - 1)),
        float(scale), float(softcap or 0.0), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "kaito_flash_prefill")
    flash_prefill_attention_cuda.launches += 1
    return out


def flash_prefill_packed_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seg_ids: torch.Tensor,
    positions: torch.Tensor,
    window: int,
    *,
    scale: float,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Segment-packed flash attention (contract of
    :func:`flash_prefill_packed_plain`)."""
    if q.device.type == "cpu":
        return flash_prefill_packed_plain(q, k, v, seg_ids, positions, window,
                                          scale=scale, softcap=softcap)
    B, T, H, Hkv, D = _check_qkv(q, k, v)
    seg_ids = _int32(seg_ids, (B, T), q.device, "seg_ids")
    positions = _int32(positions, (B, T), q.device, "positions")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    rc = build.launch(
        q.device, _kernel("kaito_flash_prefill_packed"),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        seg_ids.data_ptr(), positions.data_ptr(), B, T, H, Hkv, D,
        int(min(window, 2**31 - 1)), float(scale), float(softcap or 0.0),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "kaito_flash_prefill_packed")
    flash_prefill_packed_cuda.launches += 1
    return out


flash_prefill_attention_cuda.launches = 0
flash_prefill_packed_cuda.launches = 0
