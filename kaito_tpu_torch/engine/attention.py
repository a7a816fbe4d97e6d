"""Attention: reference implementations in plain PyTorch.

Counterparts of ``kaito_tpu.engine.attention``, with the same
arguments and the same arithmetic: fp32 scores and softmax, normalised
probabilities cast to the value dtype before the PV product.  The
tests hold them against the JAX package, and the kernels of
``engine.ops`` against them.  Of the GQA functions only
:func:`paged_context_attention` is on the model's path: it has no
kernel in the JAX package either, and serves prompt chunks that follow
earlier chunks (prompts longer than ``max_prefill_tokens``) on the card
as well.

The three MLA functions (DeepSeek-style latent attention) are the
model's whole MLA path, on the card too: the JAX package computes them
as plain einsums, outside any Pallas kernel.  The paged two gather the
latent pages over the full page-table width, as the JAX functions do,
so a captured decode window holds them, and use the absorbed form:
``q_nope`` is projected into latent space, scores and the output are
latent products in fp32, and ``W_uv`` expands the output.
"""

from __future__ import annotations

from typing import Optional

import torch

from kaito_tpu_torch.engine.devprof import named_scope
from kaito_tpu_torch.engine.kv_cache import dequantize_pages

NEG_INF = -1e30

# every attention entry point runs inside the profiler's "attention"
# range, as the JAX package's run under named_scope("attention"): a
# kernel launched there is bucketed as attention whatever its name
_scoped = named_scope("attention")


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


@_scoped
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


@_scoped
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


def history_pages(page_tables: torch.Tensor, start_pos: torch.Tensor,
                  true_lens: torch.Tensor, page_size: int) -> torch.Tensor:
    """The columns of ``page_tables`` that hold a chunked prefill's
    history and chunk (earlier chunks + this one): read once on the
    host, so that every layer's context attention gathers only these
    pages without reading the lengths back itself."""
    end = int((start_pos.long() + true_lens.long()).max())
    return page_tables[:, :max(1, min(page_tables.shape[1], -(-end // page_size)))]


@_scoped
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
    causal masking.  Every page of ``page_tables`` is gathered, pages
    past a row's history masked (the model passes only the history's
    columns, :func:`history_pages`).  With scales, the int8 pages are
    dequantized to q's dtype after the gather."""
    B, T, H, D = q.shape
    ck, cv = _layer_view(cache_k, layer), _layer_view(cache_v, layer)
    ps, Hkv = ck.shape[1], ck.shape[2]
    end = start_pos.long() + true_lens.long()                     # [B]
    n_pg = page_tables.shape[1]
    pt = page_tables.long()
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


@_scoped
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-style latent attention)
# ---------------------------------------------------------------------------

@_scoped
def mla_prefill_attention(
    q_nope: torch.Tensor,       # [B, T, H, dn]
    q_rope: torch.Tensor,       # [B, T, H, dr] (roped)
    c_kv: torch.Tensor,         # [B, T, dl] normalized latent
    k_rope: torch.Tensor,       # [B, T, dr] (roped, shared across heads)
    kv_b_k: torch.Tensor,       # [dl, H*dn]
    kv_b_v: torch.Tensor,       # [dl, H*dv]
    *,
    scale: float,
    true_len: Optional[torch.Tensor] = None,   # [B]
) -> torch.Tensor:
    """Latent attention over a fresh chunk (positions 0..T-1): per-head
    K/V expanded from the latent, scores ``q_nope . k_nope + q_rope .
    k_rope`` in fp32, the causal (and ``true_len``) mask, probabilities
    cast to V's dtype.  Returns [B, T, H, dv]."""
    B, T, H, dn = q_nope.shape
    dv = kv_b_v.shape[1] // H
    k_nope = (c_kv @ kv_b_k).reshape(B, T, H, dn)
    v = (c_kv @ kv_b_v).reshape(B, T, H, dv)
    s = torch.einsum("bthd,bshd->bhts", q_nope.float(), k_nope.float())
    s = s + torch.einsum("bthd,bsd->bhts", q_rope.float(), k_rope.float())
    s = s * scale
    pos = torch.arange(T, device=q_nope.device)
    mask = (pos[None, :] <= pos[:, None])[None].expand(B, T, T)
    if true_len is not None:
        mask = mask & (pos[None, None, :] < true_len.long()[:, None, None])
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p.to(v.dtype), v)


def _latent_pages(cache_latent: torch.Tensor, page_tables: torch.Tensor,
                  layer: Optional[int], latent_scale: Optional[torch.Tensor],
                  kv_lora_rank: int):
    """(c_kv, k_rope) of every page of ``page_tables`` [B, pmax]:
    [B, pmax * ps, dl] and [B, pmax * ps, dr], scaled to fp32 when the
    pool is int8 (``latent_scale`` [P, 1] / [Lg, P, 1]), else in the
    pool's dtype."""
    pt = page_tables.long()
    lat = _layer_view(cache_latent, layer)[pt][:, :, :, 0]   # [B, pmax, ps, dl+dr]
    if latent_scale is not None:
        sl = _layer_view(latent_scale, layer)[pt]             # [B, pmax, 1]
        lat = lat.float() * sl[..., None]
    B, pmax, ps, dtot = lat.shape
    lat = lat.reshape(B, pmax * ps, dtot)
    return lat[..., :kv_lora_rank], lat[..., kv_lora_rank:]


@_scoped
def mla_paged_context_attention(
    q_nope: torch.Tensor,        # [B, T, H, dn] chunk queries
    q_rope: torch.Tensor,        # [B, T, H, dr] (roped)
    cache_latent: torch.Tensor,  # [P, ps, 1, dl+dr] (chunk latent already written)
    page_tables: torch.Tensor,   # [B, pmax]
    start_pos: torch.Tensor,     # [B] absolute position of q[:, 0]
    true_lens: torch.Tensor,     # [B] valid NEW tokens in the chunk
    kv_b_k: torch.Tensor,        # [dl, H*dn]
    kv_b_v: torch.Tensor,        # [dl, H*dv]
    *,
    scale: float,
    kv_lora_rank: int,
    layer: Optional[int] = None,
    latent_scale: Optional[torch.Tensor] = None,   # int8 pool: [P, 1] / [Lg, P, 1]
) -> torch.Tensor:
    """Chunked MLA prefill WITH prior context: the chunk's queries attend
    over the whole paged latent history (earlier chunks + this one) with
    absolute-position causal masking, in the absorbed form.  Returns
    [B, T, H, dv] in q's dtype."""
    B, T, H, dn = q_nope.shape
    dl = kv_lora_rank
    dv = kv_b_v.shape[1] // H
    c_kv, k_rope = _latent_pages(cache_latent, page_tables, layer, latent_scale, dl)
    S = c_kv.shape[1]
    c_kv = c_kv.float()
    q_lat = torch.einsum("bthd,lhd->bthl", q_nope.float(),
                         kv_b_k.reshape(dl, H, dn).float())
    s = torch.einsum("bthl,bsl->bhts", q_lat, c_kv)
    s = s + torch.einsum("bthd,bsd->bhts", q_rope.float(), k_rope.float())
    s = s * scale
    dev = q_nope.device
    q_pos = start_pos.long()[:, None] + torch.arange(T, device=dev)[None, :]
    k_pos = torch.arange(S, device=dev)[None, :]
    mask = k_pos[:, None, :] <= q_pos[:, :, None]                 # [B, T, S]
    end = start_pos.long() + true_lens.long()
    mask = mask & (k_pos < end[:, None])[:, None, :]
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out_lat = torch.einsum("bhts,bsl->bthl", p, c_kv)
    out = torch.einsum("bthl,lhd->bthd", out_lat,
                       kv_b_v.reshape(dl, H, dv).float())
    return out.to(q_nope.dtype)


@_scoped
def mla_paged_decode_attention(
    q_nope: torch.Tensor,        # [B, H, dn]
    q_rope: torch.Tensor,        # [B, H, dr]
    cache_latent: torch.Tensor,  # [P, ps, 1, dl+dr]
    page_tables: torch.Tensor,   # [B, pmax]
    lengths: torch.Tensor,       # [B] tokens in cache INCLUDING the new one
    kv_b_k: torch.Tensor,        # [dl, H*dn]
    kv_b_v: torch.Tensor,        # [dl, H*dv]
    *,
    scale: float,
    kv_lora_rank: int,
    layer: Optional[int] = None,
    latent_scale: Optional[torch.Tensor] = None,   # int8 pool: [P, 1] / [Lg, P, 1]
) -> torch.Tensor:
    """One query token per sequence over its paged latent history, in
    the absorbed form: ``q_lat = q_nope . W_uk`` per head, scores
    ``q_lat . c_kv + q_rope . k_rope`` and the latent output in fp32,
    expanded by ``W_uv``; no per-token K/V is formed.  Returns
    [B, H, dv] in q's dtype."""
    B, H, dn = q_nope.shape
    dl = kv_lora_rank
    dv = kv_b_v.shape[1] // H
    c_kv, k_rope = _latent_pages(cache_latent, page_tables, layer, latent_scale, dl)
    S = c_kv.shape[1]
    c_kv = c_kv.float()
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope.float(),
                         kv_b_k.reshape(dl, H, dn).float())
    s = torch.einsum("bhl,bsl->bhs", q_lat, c_kv)
    s = s + torch.einsum("bhd,bsd->bhs", q_rope.float(), k_rope.float())
    s = s * scale
    s_pos = torch.arange(S, device=q_nope.device)[None, :]
    s = torch.where((s_pos < lengths.long()[:, None])[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out_lat = torch.einsum("bhs,bsl->bhl", p, c_kv)
    out = torch.einsum("bhl,lhd->bhd", out_lat, kv_b_v.reshape(dl, H, dv).float())
    return out.to(q_nope.dtype)
