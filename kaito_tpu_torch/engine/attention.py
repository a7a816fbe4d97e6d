"""Attention: reference implementations in plain PyTorch.

Counterparts of ``kaito_tpu.engine.attention``, with the same
arguments and the same arithmetic: fp32 scores and softmax, normalised
probabilities cast to the value dtype before the PV product.  The
tests hold them against the JAX package, and the kernels of
``engine.ops`` against them.  Only :func:`paged_context_attention` is
on the model's path: it has no kernel in the JAX package either, and
serves prompt chunks that follow earlier chunks (prompts longer than
``max_prefill_tokens``) on the card as well.
"""

from __future__ import annotations

from typing import Optional

import torch

from kaito_tpu_torch.engine.kv_cache import dequantize_pages

NEG_INF = -1e30


def _gqa_expand(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[..., Hkv, D] -> [..., Hkv*groups, D]."""
    if groups == 1:
        return x
    return x.repeat_interleave(groups, dim=-2)


def _layer_view(cache: torch.Tensor, layer: Optional[int]) -> torch.Tensor:
    """The single-layer pool: ``cache`` or its layer ``layer`` (a view)."""
    return cache if layer is None else cache[layer]


def _dequant_gathered(pages: torch.Tensor, scale_pool: torch.Tensor,
                      page_tables: torch.Tensor, layer: Optional[int],
                      out_dtype: torch.dtype) -> torch.Tensor:
    """Gathered int8 pages ``[B, n_pg, ps, Hkv, D]`` times their
    per-page-per-head scales, gathered from the ``[P, Hkv]`` (or, with
    ``layer``, ``[Lg, P, Hkv]``) pool through the same page tables, in
    ``out_dtype``.  Null and garbage pages dequantize to finite values
    that the length mask drops."""
    s = _layer_view(scale_pool, layer)[page_tables]          # [B, n_pg, Hkv]
    return dequantize_pages(pages, s).to(out_dtype)


def _attend(q, k, v, mask, scale, logit_softcap):
    """softmax(q k^T * scale) v over [B, T, H, D] x [B, S, H, D] with a
    [B, T, S] mask."""
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)


def prefill_attention(
    q: torch.Tensor,            # [B, T, H, D]
    k: torch.Tensor,            # [B, T, Hkv, D]
    v: torch.Tensor,            # [B, T, Hkv, D]
    *,
    scale: float,
    sliding_window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    true_len: Optional[torch.Tensor] = None,   # [B]
) -> torch.Tensor:
    """Causal self-attention over a fresh chunk (positions 0..T-1)."""
    B, T, H, D = q.shape
    groups = H // k.shape[2]
    pos = torch.arange(T, device=q.device)
    t_pos, s_pos = pos[:, None], pos[None, :]
    mask = s_pos <= t_pos
    if sliding_window is not None:
        mask = mask & (s_pos > t_pos - sliding_window)
    mask = mask[None].expand(B, T, T)
    if true_len is not None:
        mask = mask & (s_pos[None] < true_len.long()[:, None, None])
    return _attend(q, _gqa_expand(k, groups), _gqa_expand(v, groups), mask,
                   scale, logit_softcap)


def packed_prefill_attention(
    q: torch.Tensor,            # [B, T, H, D]
    k: torch.Tensor,            # [B, T, Hkv, D]
    v: torch.Tensor,            # [B, T, Hkv, D]
    seg_ids: torch.Tensor,      # [B, T] segment id per token (-1 = pad)
    positions: torch.Tensor,    # [B, T] position WITHIN the segment
    *,
    scale: float,
    sliding_window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Causal self-attention over a segment-packed row: a token attends
    only to earlier tokens of its own segment; pads attend to nothing
    and their output rows are garbage the caller never gathers."""
    groups = q.shape[2] // k.shape[2]
    sq, sk = seg_ids[:, :, None], seg_ids[:, None, :]
    pq, pk = positions[:, :, None], positions[:, None, :]
    mask = (sq == sk) & (sq >= 0) & (pk <= pq)
    if sliding_window is not None:
        mask = mask & (pk > pq - sliding_window)
    return _attend(q, _gqa_expand(k, groups), _gqa_expand(v, groups), mask,
                   scale, logit_softcap)


def paged_context_attention(
    q: torch.Tensor,            # [B, T, H, D] chunk queries
    cache_k: torch.Tensor,      # [P, ps, Hkv, D] (chunk KV already written)
    cache_v: torch.Tensor,
    page_tables: torch.Tensor,  # [B, pmax]
    start_pos: torch.Tensor,    # [B] absolute position of q[:, 0]
    true_lens: torch.Tensor,    # [B] valid NEW tokens in the chunk
    *,
    scale: float,
    sliding_window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    layer: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,   # int8 pools: [P, Hkv] / [Lg, P, Hkv]
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chunked prefill WITH prior context: queries attend over the whole
    paged history (earlier chunks + this one) with absolute-position
    causal masking.  Pages past the longest history are fully masked
    and are not gathered.  With scales, the int8 pages are dequantized
    to q's dtype after the gather."""
    B, T, H, D = q.shape
    ck, cv = _layer_view(cache_k, layer), _layer_view(cache_v, layer)
    ps, Hkv = ck.shape[1], ck.shape[2]
    end = start_pos.long() + true_lens.long()                     # [B]
    n_pg = max(1, min(page_tables.shape[1], -(-int(end.max()) // ps)))
    pt = page_tables[:, :n_pg].long()
    S = n_pg * ps
    k, v = ck[pt], cv[pt]                                         # [B, n_pg, ps, Hkv, D]
    if k_scale is not None:
        k = _dequant_gathered(k, k_scale, pt, layer, q.dtype)
        v = _dequant_gathered(v, v_scale, pt, layer, q.dtype)
    k = k.reshape(B, S, Hkv, D)
    v = v.reshape(B, S, Hkv, D)
    groups = H // Hkv
    q_pos = start_pos.long()[:, None] + torch.arange(T, device=q.device)[None, :]
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = k_pos[:, None, :] <= q_pos[:, :, None]                  # [B, T, S]
    mask = mask & (k_pos < end[:, None])[:, None, :]
    if sliding_window is not None:
        mask = mask & (k_pos[:, None, :] > q_pos[:, :, None] - sliding_window)
    return _attend(q, _gqa_expand(k, groups), _gqa_expand(v, groups), mask,
                   scale, logit_softcap)


def paged_decode_attention(
    q: torch.Tensor,            # [B, H, D] (one new token per sequence)
    cache_k: torch.Tensor,      # [num_pages, page_size, Hkv, D]
    cache_v: torch.Tensor,
    page_tables: torch.Tensor,  # [B, pages_per_seq]
    lengths: torch.Tensor,      # [B] tokens in cache INCLUDING the new one
    *,
    scale: float,
    sliding_window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    layer: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,   # int8 pools: [P, Hkv] / [Lg, P, Hkv]
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attend one query token per sequence over its paged KV history
    (int8 pages, with scales, dequantized to q's dtype after the
    gather)."""
    B, H, D = q.shape
    ck, cv = _layer_view(cache_k, layer), _layer_view(cache_v, layer)
    ps, Hkv = ck.shape[1], ck.shape[2]
    pmax = page_tables.shape[1]
    S = pmax * ps
    groups = H // Hkv
    pt = page_tables.long()
    k, v = ck[pt], cv[pt]
    if k_scale is not None:
        k = _dequant_gathered(k, k_scale, pt, layer, q.dtype)
        v = _dequant_gathered(v, v_scale, pt, layer, q.dtype)
    k = k.reshape(B, S, Hkv, D)
    v = v.reshape(B, S, Hkv, D)
    qg = q.reshape(B, Hkv, groups, D)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    s_pos = torch.arange(S, device=q.device)[None, :]
    ln = lengths.long()[:, None]
    mask = s_pos < ln
    if sliding_window is not None:
        mask = mask & (s_pos >= ln - sliding_window)
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(v.dtype), v)
    return out.reshape(B, H, D)
