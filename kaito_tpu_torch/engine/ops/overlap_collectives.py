"""Tensor-parallel collectives for decode: the pipelined ring and the
plain all-reduce it replaces.

Counterpart of ``kaito_tpu.engine.ops.overlap_collectives``.  The JAX
package runs these as ``shard_map`` bodies, one per device of the mesh's
tensor axis, with ``ppermute`` hops between them.  Here one process
drives every shard, so each function takes and returns a LIST with one
tensor per shard, in mesh order, each on its shard's device; a ring hop
moves every shard's tensor to the next device (``perm = i -> i + 1``).
On two cards the hop is a peer copy; when two mesh slots map onto one
device it moves nothing.

``overlap_linear``
    The row-parallel linear (attention-out, MLP-down) with its output
    all-reduce decomposed into ``ring_matmul_reduce_scatter`` and
    ``ring_all_gather``: n - 1 hops each, every hop beside the next
    chunk's partial matmul.  QTensor weights ride the ring as column
    chunks (``_slice_out``) through ``quant_linear``, with the next
    layer's slab as ``prefetch`` (K6).
``psum_linear``
    The same projection with the plain all-reduce: every shard's partial
    product, summed in rank order on each device.  Prefill and the
    gate-off decode use it.
``all_gather_matmul``
    The column-parallel dual (q, gate, up): x chunks rotate around the
    ring while each shard multiplies the chunk it holds by the matching
    rows of its weight.  Plain 2-D weights only (``ag_matmul_eligible``).

The JAX module's ``KAITO_COMM_OVERLAP=jax`` body override is left out:
on the card it would be a switch that hides the ring.  The engine's
gate itself (``cfg.comm_overlap``, with that variable as its fallback)
decides whether decode takes the ring.

Numerics: the ring accumulates the chunk contributions in a fixed device
order, which differs from the psum's rank order at n > 2; greedy decode
is token-identical, logits agree to float tolerance.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from kaito_tpu_torch.engine.ops.quant_matmul import quant_linear
from kaito_tpu_torch.parallel.mesh import Mesh

__all__ = [
    "overlap_linear", "psum_linear", "all_gather_matmul", "ag_matmul_eligible",
    "ring_matmul_reduce_scatter", "ring_all_gather", "ring_all_gather_matmul",
]


def _out_dim(w) -> int:
    if isinstance(w, dict):
        return int(w["scale"].shape[-1])
    return int(w.shape[-1])


def _slice_out(w, start: int, size: int):
    """Column chunk [start, start + size) of a plain weight or QTensor, as
    a view.  Every QTensor plane ends in the out dim (q8/q4 [K(/2), N],
    int8 scale [N], int4 scale [G, N]), so one last-axis slice per plane
    keeps the chunk a well-formed QTensor."""
    if isinstance(w, dict):
        return {k: v[..., start:start + size] for k, v in w.items()}
    return w[..., start:start + size]


def _local_matmul(x, w, prefetch=None):
    """One shard's partial product: the fused dequant path for QTensors
    (with the layer-ahead slab), a plain matmul otherwise."""
    if isinstance(w, dict):
        return quant_linear(x, w, prefetch=prefetch)
    return x @ w


def _hop(ts: Sequence[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """One ring hop: shard i's tensor lands on shard i + 1's device."""
    n = len(ts)
    return [ts[(d - 1) % n].to(mesh.devices[d]) for d in range(n)]


def ring_matmul_reduce_scatter(xs, ws, mesh: Mesh, prefetch=None, add=None):
    """Pipelined matmul + reduce-scatter.  xs[d]: [.., K_local]; ws[d]:
    [K_local, N] (full out dim); prefetch[d]: the next layer's slab for
    ws[d], or None; add[d]: a [.., N] term shard d adds to its partial
    product (a LoRA delta's partial sum), or None.  Returns the fully
    reduced chunk each shard owns,
    [.., N / n].  At step s shard d computes chunk ``(d - s - 1) mod n``
    into the accumulator that just arrived and forwards it, so the
    accumulator that lands on d after the last hop has visited every
    shard once: chunk d, complete."""
    n = len(xs)
    N = _out_dim(ws[0])
    if N % n:
        raise ValueError(f"out dim {N} not divisible by ring size {n}")
    nc = N // n
    acc: list = [None] * n
    for s in range(n):
        for d in range(n):
            c = (d - s - 1) % n
            wc = _slice_out(ws[d], c * nc, nc)
            pfc = (_slice_out(prefetch[d], c * nc, nc)
                   if prefetch is not None else None)
            part = _local_matmul(xs[d], wc, prefetch=pfc)
            if add is not None and add[d] is not None:
                part = part + add[d][..., c * nc:(c + 1) * nc]
            acc[d] = part if acc[d] is None else acc[d] + part
        if s != n - 1:
            acc = _hop(acc, mesh)
    return acc


def ring_all_gather(ys, mesh: Mesh):
    """Ring all-gather of owned chunks: ys[d] [.., N/n] (chunk d) ->
    [.., N] on every shard, through n - 1 hops."""
    n = len(ys)
    got = [{d: ys[d]} for d in range(n)]
    cur, src = list(ys), list(range(n))
    for _ in range(n - 1):
        cur = _hop(cur, mesh)
        src = [src[(d - 1) % n] for d in range(n)]
        for d in range(n):
            got[d][src[d]] = cur[d]
    return [torch.cat([got[d][j] for j in range(n)], dim=-1) for d in range(n)]


def ring_all_gather_matmul(xs, ws, mesh: Mesh):
    """Pipelined all-gather + matmul.  xs[d]: the x chunk shard d owns,
    [.., K/n]; ws[d]: [K, N_local], out-sharded with every contraction
    row present.  x chunks rotate around the ring and each arrival
    multiplies its matching row block.  Returns each shard's out shard
    [.., N_local].  Plain weights only."""
    n = len(xs)
    kc = xs[0].shape[-1]
    acc: list = [None] * n
    cur, src = list(xs), list(range(n))
    for s in range(n):
        for d in range(n):
            part = cur[d] @ ws[d][src[d] * kc:(src[d] + 1) * kc]
            acc[d] = part if acc[d] is None else acc[d] + part
        if s != n - 1:
            cur = _hop(cur, mesh)
            src = [src[(d - 1) % n] for d in range(n)]
    return acc


def overlap_linear(xs, ws, mesh: Mesh, prefetch: Optional[list] = None,
                   add: Optional[list] = None):
    """Row-parallel TP linear with the output collective decomposed into
    pipelined ring hops: xs[d] [.., K/n] @ ws[d] [K/n, N] -> [.., N] on
    every shard, numerically a sum of the partials in ring order.
    ``prefetch`` lists each shard's next-layer slab for ``ws`` (same
    QTensor layout); its column chunks ride the same ring steps into
    ``quant_linear`` (K6).  ``add[d]`` (or None) is a [.., N] term added
    to shard d's partial product before the reduction."""
    yc = ring_matmul_reduce_scatter(xs, ws, mesh, prefetch=prefetch, add=add)
    return ring_all_gather(yc, mesh)


def psum_linear(xs, ws, mesh: Mesh, add: Optional[list] = None):
    """Row-parallel TP linear with the plain all-reduce: each shard's
    partial product (plus ``add[d]`` when given and not None), and on
    every device their sum in rank order."""
    parts = [_local_matmul(x, w) for x, w in zip(xs, ws)]
    if add is not None:
        parts = [p if a is None else p + a for p, a in zip(parts, add)]
    out = []
    for dev in mesh.devices:
        total = parts[0].to(dev)
        for p in parts[1:]:
            total = total + p.to(dev)
        out.append(total)
    return out


def ag_matmul_eligible(x: torch.Tensor, w, n: int) -> bool:
    """Can this column-parallel projection take :func:`all_gather_matmul`?
    ``w`` is one shard's weight [K, N/n]: plain 2-D only (int4 packing
    ties row slicing to nibble pairs, and QTensors carry scales), with
    the contraction dim K, which the ring gathers, divisible by the ring
    size."""
    if n <= 1 or isinstance(w, dict) or w.dim() != 2:
        return False
    K = int(w.shape[0])
    return int(x.shape[-1]) == K and K % n == 0


def all_gather_matmul(xs, ws, mesh: Mesh):
    """Column-parallel entry: xs[d] [.., K] (the replicated activation)
    @ ws[d] [K, N/n] -> [.., N/n] per shard, with the activation's
    all-gather hidden behind the partial dots.  Shard d starts from the
    K-chunk it owns, ``xs[d][..., d*K/n:(d+1)*K/n]``."""
    n = len(xs)
    kc = xs[0].shape[-1] // n
    own = [x[..., d * kc:(d + 1) * kc] for d, x in enumerate(xs)]
    return ring_all_gather_matmul(own, ws, mesh)
