"""Paged KV cache.

The engine's KV memory is one page pool per layer stacked into
``[num_layers, num_pages, page_size, kv_heads, head_dim]`` and addressed
through per-sequence page tables, as in ``kaito_tpu.engine.kv_cache``.
The layout is page-major and token-major within a page: a page is one
contiguous ``[page_size, kv_heads, head_dim]`` block and a decode write
is one ``[kv_heads, head_dim]`` row, which the decode kernel reads back
row by row straight from the pool.

An MLA model caches one latent stream, ``[c_kv ; k_rope]`` of width
``kv_lora_rank + qk_rope_head_dim``, as a single head: ``k`` holds it
and ``v`` is a zero-size placeholder, as in the JAX package; every
write above then runs on ``k`` with ``Hkv = 1``.

Page 0 is the null page: unused page-table slots point at it, so reads
stay in bounds and masking is done by length; writes of padding tokens
and inactive rows land there.

Writes are IN PLACE (``index_put_`` on the pool or on a view of one
layer of it).  The JAX package's writes are functional and return a new
pool; these return the pool they were given, which is the same object.

Quantized mode (``int8`` pools): the pools hold int8 codes plus fp32
per-page-per-head scales ``[L, num_pages, kv_heads]``.  Writes quantize
with the JAX package's rescale-on-grow fold: the written tokens' absmax
is folded into the page scale (sigma_new = max(sigma_old, absmax/127),
the division taken as the JAX engine's jit takes it: a multiplication
by the fp32 reciprocal) and, when the scale grows, the page's existing
codes are requantized at the new scale, so ``code * sigma`` stays right
for every token a page holds.  The null page takes garbage codes and
scales, which reads mask by length; its scales stay finite.  Tokens the
JAX package routes to an
out-of-bounds scatter index (which JAX drops) go to a spare slot here
that is never written back, so no write needs a host sync.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence

import torch

from kaito_tpu_torch.device import resolve_device
from kaito_tpu_torch.engine.quant import INV_127
from kaito_tpu_torch.models.metadata import AttentionKind, ModelArch

NULL_PAGE = 0


@dataclass
class KVCache:
    """Stacked per-layer page pools, written in place."""

    k: torch.Tensor  # [L, num_pages, page_size, kv_heads, head_dim]
    v: torch.Tensor
    # fp32 [L, num_pages, kv_heads] dequantization scales of int8 pools;
    # None for bf16/fp32 pools
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def kv_cache_is_quantized(dtype: torch.dtype) -> bool:
    return dtype == torch.int8


def scale_bytes_per_page(arch: ModelArch) -> int:
    """Device bytes of the two fp32 scale rows one page carries."""
    return 2 * arch.num_layers * arch.kv_cache_heads * 4


def create_kv_cache(arch: ModelArch, num_pages: int, page_size: int,
                    dtype: torch.dtype = torch.bfloat16,
                    device: str | torch.device = "cuda") -> KVCache:
    """Zeroed pools on ``device`` (the card unless the CPU is asked for);
    int8 pools come with zero scales, which dequantize the zeroed pool to
    exact zeros and only grow as tokens land.  An MLA model gets its
    latent pool in ``k`` and a zero-size ``v``; an int8 latent pool
    keeps both scale pools, as the JAX package allocates them."""
    device = resolve_device(device)
    shape = (arch.num_layers, num_pages, page_size, arch.kv_cache_heads,
             arch.kv_cache_dim)
    k_scale = v_scale = None
    if kv_cache_is_quantized(dtype):
        sshape = (arch.num_layers, num_pages, arch.kv_cache_heads)
        k_scale = torch.zeros(sshape, dtype=torch.float32, device=device)
        v_scale = torch.zeros(sshape, dtype=torch.float32, device=device)
    vshape = shape[:-1] + (0,) if arch.attention_kind == AttentionKind.MLA else shape
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(vshape, dtype=dtype, device=device),
                   k_scale=k_scale, v_scale=v_scale)


def create_sharded_kv_cache(arch: ModelArch, devices: Sequence[torch.device],
                            num_pages: int, page_size: int,
                            dtype: torch.dtype = torch.bfloat16) -> list[KVCache]:
    """The pools of a tensor-parallel engine: one :class:`KVCache` per
    shard, on its device, holding that shard's ``num_kv_heads / n`` KV
    heads (and, for int8 pools, scale pools ``[L, P, Hkv / n]`` following
    them), as the JAX engine shards the pools' head axis over its
    ``tensor`` mesh axis.  Every shard addresses the same page ids."""
    n = len(devices)
    if arch.num_kv_heads % n:
        raise ValueError(f"{n} shards do not divide {arch.num_kv_heads} KV heads")
    local = replace(arch, num_kv_heads=arch.num_kv_heads // n)
    return [create_kv_cache(local, num_pages, page_size, dtype, d) for d in devices]


def kv_bytes(cache) -> int:
    """Device bytes of a cache, or of a list of shard caches: both pools
    (an MLA pool's ``v`` holds nothing) and their scales."""
    if isinstance(cache, list):
        return sum(kv_bytes(c) for c in cache)
    total = (cache.k.numel() + cache.v.numel()) * cache.k.element_size()
    if cache.quantized:
        total += (cache.k_scale.numel() + cache.v_scale.numel()) * 4
    return total


def _layer(cache: torch.Tensor, layer: Optional[int]) -> torch.Tensor:
    """The single-layer pool ``[P, ps, Hkv, D]``: ``cache`` itself, or a
    view of layer ``layer`` of the stacked group (writes go through)."""
    return cache if layer is None else cache[layer]


def write_prefill_tokens(
    cache_layer: torch.Tensor,    # [P, ps, Hkv, D] or, with ``layer``, [Lg, P, ps, Hkv, D]
    new: torch.Tensor,            # [B, T, Hkv, D]
    page_tables: torch.Tensor,    # [B, pages_per_seq] int32
    start_pos: torch.Tensor,      # [B] sequence position of new[:, 0]
    true_lens: torch.Tensor,      # [B] valid tokens per row; pad -> null page
    page_size: int,
    layer: Optional[int] = None,
) -> torch.Tensor:
    """Scatter a batch of prefill chunks into their pages."""
    B, T = new.shape[:2]
    pmax = page_tables.shape[1]
    t = torch.arange(T, device=new.device)[None, :]
    pos = start_pos.long()[:, None] + t                           # [B, T]
    slot = (pos // page_size).clamp(max=pmax - 1)
    page_idx = torch.gather(page_tables.long(), 1, slot)
    valid = t < true_lens.long()[:, None]
    page_idx = torch.where(valid, page_idx, NULL_PAGE)
    offset = pos % page_size
    flat = new.reshape(B * T, *new.shape[2:])
    _layer(cache_layer, layer).index_put_(
        (page_idx.reshape(-1), offset.reshape(-1)), flat)
    return cache_layer


def write_packed_prefill_tokens(
    cache_layer: torch.Tensor,    # [P, ps, Hkv, D] or, with ``layer``, [Lg, P, ps, Hkv, D]
    new: torch.Tensor,            # [1, T, Hkv, D] segment-packed row
    tok_pages: torch.Tensor,      # [T] page per token (pad -> null page)
    offsets: torch.Tensor,        # [T] slot within the page
    layer: Optional[int] = None,
) -> torch.Tensor:
    """Scatter a segment-packed prefill row: each token carries its own
    page and in-page offset, computed on the host from its segment's
    page table; pad tokens point at the null page."""
    _layer(cache_layer, layer).index_put_(
        (tok_pages.long(), offsets.long()), new[0])
    return cache_layer


def write_decode_tokens(
    cache_layer: torch.Tensor,    # [P, ps, Hkv, D] or, with ``layer``, [Lg, P, ps, Hkv, D]
    new: torch.Tensor,            # [B, Hkv, D] one token per sequence
    page_tables: torch.Tensor,    # [B, pages_per_seq]
    positions: torch.Tensor,      # [B] current position of each new token
    page_size: int,
    active: Optional[torch.Tensor] = None,  # [B] bool; inactive rows hit page 0
    layer: Optional[int] = None,
) -> torch.Tensor:
    pos = positions.long()
    pmax = page_tables.shape[1]
    slot = (pos // page_size).clamp(max=pmax - 1)
    page_idx = torch.gather(page_tables.long(), 1, slot[:, None])[:, 0]
    if active is not None:
        page_idx = torch.where(active, page_idx, NULL_PAGE)
    _layer(cache_layer, layer).index_put_((page_idx, pos % page_size), new)
    return cache_layer


# ---------------------------------------------------------------------------
# int8 pools
# ---------------------------------------------------------------------------

def _safe(s: torch.Tensor) -> torch.Tensor:
    """Guard divisions by a not-yet-grown (zero) page scale."""
    return torch.where(s > 0, s, torch.ones_like(s))


def dequantize_pages(pages: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """[..., ps, Hkv, D] int8 codes x [..., Hkv] scales -> fp32."""
    return pages.float() * scale[..., None, :, None]


def _requantize(pages: torch.Tensor, old: torch.Tensor,
                s_new: torch.Tensor) -> torch.Tensor:
    """Existing codes re-expressed at a grown page scale, as fp32 codes.
    ``old / s_new <= 1``, so they stay in [-127, 127]; a scale that did
    not grow gives a ratio of exactly 1.0 and the codes back unchanged."""
    ratio = torch.where(s_new > 0, old / _safe(s_new), torch.ones_like(s_new))
    scaled = pages.float() * ratio[..., None, :, None]
    return torch.round(scaled).clamp_(-127, 127)


def _quantize_tokens(new32: torch.Tensor, s_tok: torch.Tensor) -> torch.Tensor:
    """[..., Hkv, D] fp32 values at [..., Hkv] scales -> fp32 codes."""
    return torch.round(new32 / _safe(s_tok)[..., None]).clamp_(-127, 127)


def write_decode_tokens_q(
    cache_layer: torch.Tensor,    # int8 [P, ps, Hkv, D] or, with ``layer``, [Lg, P, ps, Hkv, D]
    scale_layer: torch.Tensor,    # fp32 [P, Hkv] or, with ``layer``, [Lg, P, Hkv]
    new: torch.Tensor,            # [B, Hkv, D] one token per sequence
    page_tables: torch.Tensor,    # [B, pages_per_seq]
    positions: torch.Tensor,      # [B]
    page_size: int,
    active: Optional[torch.Tensor] = None,  # [B] bool; inactive rows hit page 0
    layer: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantizing counterpart of :func:`write_decode_tokens`: gather each
    target page and its scale, fold the token's absmax into the scale
    (requantizing the page's codes if it grew), insert the token's codes
    and scatter both back."""
    pos = positions.long()
    pmax = page_tables.shape[1]
    slot = (pos // page_size).clamp(max=pmax - 1)
    page_idx = torch.gather(page_tables.long(), 1, slot[:, None])[:, 0]
    if active is not None:
        page_idx = torch.where(active, page_idx, NULL_PAGE)
    cache, scales = _layer(cache_layer, layer), _layer(scale_layer, layer)
    old = scales[page_idx]                                        # [B, Hkv]
    new32 = new.float()
    s_new = torch.maximum(old, new32.abs().amax(dim=-1) * INV_127)
    merged = _requantize(cache[page_idx], old, s_new)             # [B, ps, Hkv, D]
    rows = torch.arange(new.shape[0], device=new.device)
    merged[rows, pos % page_size] = _quantize_tokens(new32, s_new)
    cache.index_put_((page_idx,), merged.to(cache.dtype))
    scales.index_put_((page_idx,), s_new)
    return cache_layer, scale_layer


def write_prefill_tokens_q(
    cache_layer: torch.Tensor,    # int8 [P, ps, Hkv, D] or, with ``layer``, [Lg, P, ps, Hkv, D]
    scale_layer: torch.Tensor,    # fp32 [P, Hkv] or, with ``layer``, [Lg, P, Hkv]
    new: torch.Tensor,            # [B, T, Hkv, D]
    page_tables: torch.Tensor,    # [B, pages_per_seq]
    start_pos: torch.Tensor,      # [B]
    true_lens: torch.Tensor,      # [B]
    page_size: int,
    layer: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantizing counterpart of :func:`write_prefill_tokens`.  A T-token
    chunk starting mid-page spans at most ceil(T/ps)+1 page slots: gather
    that span, fold each page's valid tokens' absmax into its scales,
    requantize what the pages held, insert the new tokens and scatter the
    span back.  Padding tokens are left out of the fold and land in a
    spare span slot that is not written back."""
    B, T = new.shape[:2]
    ps = page_size
    n_pg = (T + ps - 1) // ps + 1
    dev = new.device
    t = torch.arange(T, device=dev)[None, :]
    pos = start_pos.long()[:, None] + t                           # [B, T]
    valid = t < true_lens.long()[:, None]
    first = start_pos.long() // ps                                # [B]
    seg = pos // ps - first[:, None]                              # [B, T] in [0, n_pg)
    pmax = page_tables.shape[1]
    slot_ids = first[:, None] + torch.arange(n_pg, device=dev)[None, :]
    span = torch.gather(page_tables.long(), 1, slot_ids.clamp(max=pmax - 1))
    span = torch.where(slot_ids < pmax, span, NULL_PAGE)          # [B, n_pg]

    cache, scales = _layer(cache_layer, layer), _layer(scale_layer, layer)
    old = scales[span]                                            # [B, n_pg, Hkv]
    new32 = new.float()
    tokmax = new32.abs().amax(dim=-1)                             # [B, T, Hkv]
    onehot = (seg[:, :, None] == torch.arange(n_pg, device=dev)) \
        & valid[:, :, None]                                       # [B, T, n_pg]
    cand = torch.where(onehot[..., None], tokmax[:, :, None, :], 0.0
                       ).amax(dim=1) * INV_127                     # [B, n_pg, Hkv]
    s_new = torch.maximum(old, cand)
    merged = _requantize(cache[span], old, s_new)                 # [B, n_pg, ps, Hkv, D]
    s_tok = torch.gather(s_new, 1, seg.clamp(0, n_pg - 1)[..., None].expand(
        B, T, s_new.shape[-1]))                                   # [B, T, Hkv]
    q_tok = _quantize_tokens(new32, s_tok)
    # padding goes to span slot n_pg, which is never scattered back
    merged = torch.cat([merged, torch.zeros_like(merged[:, :1])], dim=1)
    b_idx = torch.arange(B, device=dev)[:, None].expand(B, T)
    merged[b_idx, torch.where(valid, seg, n_pg), pos % ps] = q_tok
    flat = span.reshape(-1)
    cache.index_put_((flat,), merged[:, :n_pg].reshape(
        B * n_pg, *merged.shape[2:]).to(cache.dtype))
    scales.index_put_((flat,), s_new.reshape(B * n_pg, -1))
    return cache_layer, scale_layer


def write_packed_prefill_tokens_q(
    cache_layer: torch.Tensor,    # int8 [P, ps, Hkv, D] or, with ``layer``, [Lg, P, ps, Hkv, D]
    scale_layer: torch.Tensor,    # fp32 [P, Hkv] or, with ``layer``, [Lg, P, Hkv]
    new: torch.Tensor,            # [1, T, Hkv, D] segment-packed row
    pack_pages: torch.Tensor,     # [n_pg] pages of the pack's segments
    tok_pgslot: torch.Tensor,     # [T] index into pack_pages (n_pg = pad)
    offsets: torch.Tensor,        # [T] slot within the page
    layer: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantizing counterpart of :func:`write_packed_prefill_tokens`: the
    fold of :func:`write_prefill_tokens_q` over the union of every
    segment's pages, each token addressing its page through
    ``tok_pgslot``.  Segments start at position 0, so a page's fold sees
    the same tokens as the serial write and the codes come out the
    same.  Pad tokens (``tok_pgslot == n_pg``) are left out of the fold
    and land in a spare slot that is not written back."""
    n_pg = pack_pages.shape[0]
    dev = new.device
    pages = pack_pages.long()
    slot = tok_pgslot.long()
    cache, scales = _layer(cache_layer, layer), _layer(scale_layer, layer)
    old = scales[pages]                                           # [n_pg, Hkv]
    new32 = new[0].float()                                        # [T, Hkv, D]
    tokmax = new32.abs().amax(dim=-1)                             # [T, Hkv]
    onehot = slot[:, None] == torch.arange(n_pg, device=dev)[None, :]
    cand = torch.where(onehot[..., None], tokmax[:, None, :], 0.0
                       ).amax(dim=0) * INV_127                     # [n_pg, Hkv]
    s_new = torch.maximum(old, cand)
    merged = _requantize(cache[pages], old, s_new)                # [n_pg, ps, Hkv, D]
    q_tok = _quantize_tokens(new32, s_new[slot.clamp(max=n_pg - 1)])
    merged = torch.cat([merged, torch.zeros_like(merged[:1])])
    merged[slot.clamp(max=n_pg), offsets.long()] = q_tok
    cache.index_put_((pages,), merged[:n_pg].to(cache.dtype))
    scales.index_put_((pages,), s_new)
    return cache_layer, scale_layer
