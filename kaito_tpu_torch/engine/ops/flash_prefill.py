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

In bf16 both products run on the tensor cores (``wgmma``) and K/V tiles
arrive by TMA into a two-stage ring; the key tiles each 64-row query
tile visits, and the ones on which it evaluates the mask, follow
:func:`key_tile_range` and :func:`tile_fully_visible`, which the CUDA
source mirrors.  fp32 (the goldens) runs on the CUDA cores.  TMA reads
q, k and v from 16-byte aligned addresses: a view that is not gets
copied first.  Head dims 80 and 96 run the bf16 kernel at a compute
width of 128 (TMA fills the columns past D with zeros); 32, 64, 128 and
256 at their own.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from kaito_tpu_torch.ops import build

NEG_INF = -1e30
BIG_WINDOW = 2**31 - 1
SUPPORTED_HEAD_DIMS = (32, 64, 80, 96, 128, 256)
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


def fresh_mask(T: int, true_len: torch.Tensor, window: int) -> torch.Tensor:
    """[B, T, T] (query, key) visibility over fresh chunks: causal, inside
    the window, keys below ``true_len``."""
    pos = torch.arange(T, device=true_len.device)
    qp, kp = pos[:, None], pos[None, :]
    mask = (kp <= qp) & (kp > qp - window)
    return mask[None] & (kp[None] < true_len.long()[:, None, None])


def packed_mask(seg_ids: torch.Tensor, positions: torch.Tensor,
                window: int) -> torch.Tensor:
    """[B, T, T] visibility over segment-packed rows: same segment (not a
    pad), causal on within-segment positions, inside the window."""
    sq, sk = seg_ids[:, :, None], seg_ids[:, None, :]
    pq, pk = positions[:, :, None], positions[:, None, :]
    return (sq == sk) & (sq >= 0) & (pk <= pq) & (pk > pq - window)


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
    return _flash_plain(q, k, v, fresh_mask(q.shape[1], true_len, window),
                        scale, softcap)


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
    return _flash_plain(q, k, v, packed_mask(seg_ids, positions, window),
                        scale, softcap)


# Tile schedule of the bf16 kernels (csrc/flash_prefill.cu mirrors both
# functions): a CTA owns BLOCK_Q query rows and visits key tiles of BLOCK_K.
BLOCK_Q = 64
BLOCK_K = 64


def key_tile_range(mode: str, q_start: int, block_q: int, block_k: int, T: int,
                   true_len: int = 0, window: int = BIG_WINDOW,
                   seg_ids=None) -> tuple[int, int]:
    """(first, last) key tile, inclusive, that the query tile starting at
    ``q_start`` visits; ``last < first`` when it visits none (its rows
    are written as zeros).

    ``mode="fresh"``: keys up to the tile's last row and below
    ``true_len``, and none below ``q_start - window + 1`` (the first
    row's window).  ``mode="packed"``: ``seg_ids`` is one row's [T]
    segment ids (-1 = pad); keys from the first token of the segment of
    the tile's first valid row, found from ``seg_ids`` alone, up to the
    tile's last valid row.  Segments are contiguous and ordered along
    the row, as the Pallas kernel's own causal skip assumes."""
    q_end = min(q_start + block_q, T)
    if mode == "fresh":
        lo = max(0, q_start - window + 1)
        hi = min(q_end, true_len, T)          # exclusive
    else:
        rows = [t for t in range(q_start, q_end) if int(seg_ids[t]) >= 0]
        if not rows:
            return 0, -1
        lo, s0 = rows[0], int(seg_ids[rows[0]])
        while lo > 0 and int(seg_ids[lo - 1]) == s0:
            lo -= 1
        hi = rows[-1] + 1
    if hi <= lo:
        return 0, -1
    return lo // block_k, (hi - 1) // block_k


def tile_fully_visible(mode: str, q_start: int, k_start: int, block_q: int,
                       block_k: int, T: int, true_len: int = 0,
                       window: int = BIG_WINDOW, seg_ids=None,
                       positions=None) -> bool:
    """True when every (query, key) pair of the tile pair is visible, so
    the kernel skips the per-element mask there.  Rows and keys at or
    past T never count as visible.  In packed mode positions are taken
    to rise along the row within a segment."""
    q_end, k_end = min(q_start + block_q, T), k_start + block_k
    if k_end > T:
        return False
    if mode == "fresh":
        return (k_end - 1 <= q_start and k_end <= true_len
                and k_start > q_end - 1 - window)
    s = int(seg_ids[q_start])
    return (s >= 0 and all(int(seg_ids[i]) == s
                           for i in (q_end - 1, k_start, k_end - 1))
            and int(positions[k_end - 1]) <= int(positions[q_start])
            and int(positions[k_start]) > int(positions[q_end - 1]) - window)


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (a TMA rule)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
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
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
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
