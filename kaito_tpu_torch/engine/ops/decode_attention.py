"""Paged decode attention: the CUDA kernel and its plain version.

Counterpart of ``kaito_tpu.engine.ops.decode_attention``.  The kernel
(``kaito_tpu_torch/csrc/decode_attention.cu``) replaces the Pallas TPU
kernel ``paged_decode_attention_pallas``: one query token per sequence
attends over its paged KV history in one layer of the stacked pool,
with GQA, a sliding window, an optional softcap and an fp32 online
softmax.  One launch per call: each sequence's live window is cut into
page-aligned splits across CTAs, and the last split of a (sequence, head
block) to finish merges them.  The grid and the scratch depend on the
batch, the heads and the card's SM count only (:func:`decode_plan`),
never on the page table's width.  Its header note says what bounds it on
the H100 and how it is laid out.

With ``k_scale``/``v_scale`` (int8 pools with fp32 per-page-per-head
scales) the same kernel runs over int8 pages (K1q, the Pallas kernel's
``quantized=True`` mode): sigma_k multiplies the fp32 scores after the
QK dot and sigma_v the probabilities after the running sum is updated.

:func:`paged_decode_attention_cuda` launches the kernel for tensors on
the card and runs :func:`paged_decode_attention_plain` for tensors on
the CPU; a CUDA tensor it cannot take raises.  Head dims 80 and 96 run
the bf16 kernel at a compute width of 128 (rows zero-padded in shared
memory); 32, 64, 128 and 256 at their own.  ``launches`` on the
wrapper counts K1's launches and ``launches_q`` K1q's.  The scratch and
the merge counters are allocated once per card, at the most any call on
that card can need (:func:`workspace_bounds`), and never replaced: a CUDA
graph that captures a call keeps their pointers, and a later call of any
batch writes into the same buffers.  Calls on one card must not run
concurrently on two streams.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from kaito_tpu_torch.ops import build

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 80, 96, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the launch plan of csrc/decode_attention.cu (DEC_* there)
HEADS_PER_CTA = 8          # query heads of one CTA: the mma's N
SLICE = 16                 # tokens of a warp slice: split starts are multiples
CTAS_PER_SM = 4            # grid target, CTAs an SM (the bf16 instances fit three at once)
MAX_SPLIT = 64


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    n_split: int           # splits per (sequence, head block): the grid's z
    head_blocks: int       # CTAs per KV head (G / 8, rounded up)
    ctas: int              # the whole grid
    scratch_floats: int    # fp32 partials: B * H * n_split * (D + 2), or 0
    counters: int          # int32 merge counters, one per (sequence, head block)


def decode_plan(B: int, H: int, Hkv: int, D: int, sms: int) -> DecodePlan:
    """The kernel's grid and scratch for a call (``dec_n_split`` and
    ``dec_scratch_floats`` in the source): a function of the batch, the
    heads and the card's SM count, never of the page table's width.  The
    wrapper sizes the scratch with it; it computes no output."""
    hb = -(-(H // Hkv) // HEADS_PER_CTA)
    pairs = max(B * Hkv * hb, 1)
    n_split = min(max(-(-CTAS_PER_SM * sms // pairs), 1), MAX_SPLIT)
    return DecodePlan(n_split=n_split, head_blocks=hb, ctas=B * Hkv * hb * n_split,
                      scratch_floats=B * H * n_split * (D + 2) if n_split > 1 else 0,
                      counters=B * Hkv * hb)


def workspace_bounds(sms: int) -> tuple[int, int]:
    """(scratch floats, merge counters) that cover every call on a card of
    ``sms`` SMs.  Only a plan of more than one split touches either, and
    that takes fewer than ``CTAS_PER_SM * sms`` (sequence, head block)
    pairs; each pair holds at most ``HEADS_PER_CTA`` query heads and
    ``D`` is at most 256."""
    target = CTAS_PER_SM * sms
    rows = max((p * min(-(-target // p), MAX_SPLIT) for p in range(1, target)),
               default=0)
    return HEADS_PER_CTA * rows * (max(SUPPORTED_HEAD_DIMS) + 2), max(target - 1, 0)


def decode_split(length: int, window: int, ps: int, n_split: int, split: int
                 ) -> tuple[int, int, int, int]:
    """(lo, t0, t1, n_live) of one split, as each CTA finds it on the
    device (``dec_split``): the window's first position ``lo``, the split's
    tokens [t0, t1) and how many splits of the sequence have work.  The
    live window, started at the multiple of lcm(ps, 16) at or below
    ``lo``, is cut into ``n_split`` pieces of whole such units."""
    low = ps & -ps
    unit = ps * (SLICE // min(low, SLICE))
    lo = length - window if window < length else 0
    base = lo // unit * unit
    span = length - base
    per = -(-(-(-max(span, 1) // n_split)) // unit) * unit
    n_live = -(-span // per) if length > 0 else 0
    t0 = base + split * per
    return lo, t0, min(t0 + per, length), n_live


def paged_decode_attention_plain(
    q: torch.Tensor,            # [B, H, D]
    cache_k: torch.Tensor,      # [P, ps, Hkv, D] or [Lg, P, ps, Hkv, D] with layer
    cache_v: torch.Tensor,
    page_tables: torch.Tensor,  # [B, pmax] int32
    lengths: torch.Tensor,      # [B] int32, tokens in cache including the new one
    window: int,                # huge == global attention
    *,
    scale: float,
    softcap: Optional[float] = None,
    layer: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,   # int8 pools: [P, Hkv] / [Lg, P, Hkv]
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: q pre-scaled in q's
    dtype, fp32 scores and softmax, P rounded to the cache dtype before
    the PV product, normalised after it.  A row of length 0 attends over
    nothing and comes out zero.

    With scales (K1q): int8 codes widened, sigma_k folded into the fp32
    scores, sigma_v into the probabilities after the sum ``l`` is taken,
    and P kept in fp32 against fp32 V (the quantized Pallas kernel does
    not round P)."""
    if layer is not None:
        cache_k, cache_v = cache_k[layer], cache_v[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    B, H, D = q.shape
    ps, Hkv = cache_k.shape[1], cache_k.shape[2]
    G = H // Hkv
    # pages past the longest sequence are fully masked: leave them out
    n_pg = max(1, -(-int(lengths.max()) // ps))
    pt = page_tables[:, :n_pg].long()
    S = n_pg * ps
    k = cache_k[pt].reshape(B, S, Hkv, D).float()
    v = cache_v[pt].reshape(B, S, Hkv, D)
    qs = (q * scale).to(q.dtype).float().reshape(B, Hkv, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qs, k)
    if k_scale is not None:
        # per token: the scale of its (page, KV head), [B, Hkv, 1, S]
        sk = k_scale[pt].repeat_interleave(ps, dim=1).transpose(1, 2)[:, :, None]
        s = s * sk
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(S, device=q.device)[None, :]
    ln = lengths.long()[:, None]
    mask = (pos < ln) & (pos >= ln - window)
    mask = mask[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    if k_scale is not None:
        sv = v_scale[pt].repeat_interleave(ps, dim=1).transpose(1, 2)[:, :, None]
        p = p * sv
    else:
        p = p.to(v.dtype)
    pv = torch.einsum("bkgs,bskd->bkgd", p.float(), v.float())
    out = pv / l.clamp_min(1e-30)
    return out.reshape(B, H, D).to(q.dtype)


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


@functools.cache
def _kernel():
    return build.bind("decode_attention", "kaito_decode_attention", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class _Workspace:
    """One card's scratch and merge counters, allocated on the first call
    at :func:`workspace_bounds` and kept for the process.  The counters
    are zeroed once; every call leaves them at zero."""

    def __init__(self):
        self.part: Optional[torch.Tensor] = None
        self.counters: Optional[torch.Tensor] = None

    def get(self, plan: DecodePlan, device: torch.device, sms: int):
        if self.part is None:
            if torch.cuda.is_current_stream_capturing():
                # the buffers would come from the graph's private pool
                raise RuntimeError(f"the decode kernel's workspace on {device} is "
                                   f"allocated by the first call, which must run "
                                   f"outside CUDA graph capture")
            floats, counters = workspace_bounds(sms)
            self.part = torch.empty(max(floats, 1), dtype=torch.float32, device=device)
            self.counters = torch.zeros(max(counters, 1), dtype=torch.int32, device=device)
        if plan.n_split > 1 and (plan.scratch_floats > self.part.numel()
                                 or plan.counters > self.counters.numel()):
            raise ValueError(f"decode plan {plan} exceeds the card's workspace")
        return self.part, self.counters


_WORKSPACES: dict[int, _Workspace] = {}


def workspace(device: torch.device) -> _Workspace:
    """The scratch and counters the kernel uses on ``device``."""
    return _WORKSPACES.setdefault(device.index, _Workspace())


def paged_decode_attention_cuda(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    page_tables: torch.Tensor,
    lengths: torch.Tensor,
    window: int,
    *,
    scale: float,
    softcap: Optional[float] = None,
    layer: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Paged decode attention (contract of
    :func:`paged_decode_attention_plain`).  On the card it launches the
    CUDA kernel (K1, or K1q with scales); on the CPU it is the plain
    version."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, cache_k, cache_v, page_tables, lengths, window, scale=scale,
            softcap=softcap, layer=layer, k_scale=k_scale, v_scale=v_scale)
    quantized = k_scale is not None
    if layer is not None:
        cache_k, cache_v = cache_k[layer], cache_v[layer]
        if quantized:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    B, H, D = q.shape
    P, ps, Hkv, Dk = cache_k.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"decode kernel takes float32 or bfloat16, got {q.dtype}")
    if D not in SUPPORTED_HEAD_DIMS or Dk != D:
        raise ValueError(f"decode kernel takes head_dim in {SUPPORTED_HEAD_DIMS}, "
                         f"got q {D} / cache {Dk}")
    if H % Hkv:
        raise ValueError(f"query heads {H} not a multiple of kv heads {Hkv}")
    kv_dtype = torch.int8 if quantized else q.dtype
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        if t.shape != cache_k.shape or t.dtype != kv_dtype or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous {kv_dtype} pool "
                             f"{tuple(cache_k.shape)} on {q.device}")
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t is None or t.dtype != torch.float32 or tuple(t.shape) != (P, Hkv) \
                    or not t.is_contiguous() or t.device != q.device:
                raise ValueError(f"{name} must be contiguous float32 {(P, Hkv)} "
                                 f"on {q.device}")
    for name, t, shape in (("page_tables", page_tables, (B, page_tables.shape[1])),
                           ("lengths", lengths, (B,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous int32 {shape} on {q.device}")
    q = q.contiguous()
    out = torch.empty_like(q)
    for t in (q, cache_k, cache_v, out):
        if _ptr(t) % 16:
            raise ValueError("decode kernel needs 16-byte aligned tensors")
    sms = _sms(q.device.index)
    part, counters = workspace(q.device).get(decode_plan(B, H, Hkv, D, sms), q.device, sms)
    rc = build.launch(
        q.device, _kernel(),
        _ptr(q), _ptr(cache_k), _ptr(cache_v), _ptr(out), _ptr(page_tables),
        _ptr(lengths), _ptr(part), _ptr(counters),
        _ptr(k_scale) if quantized else None,
        _ptr(v_scale) if quantized else None, B, H, Hkv, D, ps, page_tables.shape[1],
        int(min(window, 2**31 - 1)), float(scale), float(softcap or 0.0),
        _DTYPES[q.dtype], sms, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "kaito_decode_attention")
    if quantized:
        paged_decode_attention_cuda.launches_q += 1
    else:
        paged_decode_attention_cuda.launches += 1
    return out


# launches of K1 (bf16/fp32 pools) and of K1q (int8 pools)
paged_decode_attention_cuda.launches = 0
paged_decode_attention_cuda.launches_q = 0
