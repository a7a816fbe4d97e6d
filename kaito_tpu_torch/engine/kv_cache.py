"""Paged KV cache.

The engine's KV memory is one page pool per layer stacked into
``[num_layers, num_pages, page_size, kv_heads, head_dim]`` and addressed
through per-sequence page tables, as in ``kaito_tpu.engine.kv_cache``.
The layout is page-major and token-major within a page: a page is one
contiguous ``[page_size, kv_heads, head_dim]`` block and a decode write
is one ``[kv_heads, head_dim]`` row, which the decode kernel reads back
row by row straight from the pool.

Page 0 is the null page: unused page-table slots point at it, so reads
stay in bounds and masking is done by length; writes of padding tokens
and inactive rows land there.

Writes are IN PLACE (``index_put_`` on the pool or on a view of one
layer of it).  The JAX package's writes are functional and return a new
pool; these return the pool they were given, which is the same object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from kaito_tpu_torch.device import resolve_device
from kaito_tpu_torch.models.metadata import AttentionKind, ModelArch

NULL_PAGE = 0


@dataclass
class KVCache:
    """Stacked per-layer page pools, written in place."""

    k: torch.Tensor  # [L, num_pages, page_size, kv_heads, head_dim]
    v: torch.Tensor

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[2]


def create_kv_cache(arch: ModelArch, num_pages: int, page_size: int,
                    dtype: torch.dtype = torch.bfloat16,
                    device: str | torch.device = "cuda") -> KVCache:
    """Zeroed pools on ``device`` (the card unless the CPU is asked for)."""
    if dtype == torch.int8:
        raise NotImplementedError(
            "kv_dtype='int8' is not ported yet (ROADMAP queue 1, M12)")
    if arch.attention_kind == AttentionKind.MLA:
        raise NotImplementedError(
            "MLA latent caches are not ported yet (ROADMAP queue 1, M17)")
    device = resolve_device(device)
    shape = (arch.num_layers, num_pages, page_size, arch.num_kv_heads,
             arch.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


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
