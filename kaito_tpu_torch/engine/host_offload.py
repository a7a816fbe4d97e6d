"""Host-RAM KV offload tier.

The port's own copy of ``kaito_tpu/engine/host_offload.py``: when the
page pool runs dry and a sequence is preempted to be resumed, its
written KV pages are copied to a host-side LRU pool, and its
re-admission copies them back into freshly acquired pages instead of
recomputing the whole prefix.

The host copies live in pinned memory.  A spill's device-to-host copy
is issued non-blocking on the stream that writes the pool, behind every
decode step that wrote the pages, and the entry holds an event of it;
a restore orders its host-to-device copy after that event.  A restore
writes the pages in place (``index_copy_``) into the pool tensors the
engine already holds, which are never replaced: every captured decode
window and verify graph keeps the pool's addresses.

Dropping an entry is always safe: resume falls back to the recompute
path the scheduler already has.  A tensor-parallel engine spills and
restores each shard's pages from its own pool (an entry holds one
tensor per shard).  The JAX package's multi-process spill of per-host
shards waits for multi-host serving.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class HostKVEntry:
    k: list               # host tensors, one per shard: [L, n_pages, ...]
    v: list
    written: int          # tokens whose KV the pages hold
    nbytes: int
    n_pages: int          # padded page-bucket size
    k_scale: Optional[list] = None   # fp32 [L, n_pages, Hkv] per shard
    v_scale: Optional[list] = None   # when the pool is int8 (the codes are
                                     # meaningless without them)
    events: Optional[list] = None    # per shard: the copy's CUDA event, or None


def _shards(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` in host memory: a card's tensor copied into pinned memory
    without waiting; a host tensor (a gather's fresh copy) as it is."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class HostKVPool:
    """LRU byte-budgeted store of spilled sequences, keyed by req_id."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self.used_bytes = 0
        self._entries: "collections.OrderedDict[str, HostKVEntry]" = \
            collections.OrderedDict()
        self.spilled_pages = 0
        self.restored_pages = 0
        self.evicted_entries = 0
        self.hits = 0       # pop() found the spilled entry
        self.misses = 0     # pop() came up empty (evicted/never spilled)

    def __len__(self) -> int:
        return len(self._entries)

    def put(self, req_id: str, k, v, written: int,
            k_scale=None, v_scale=None) -> bool:
        """Store a spilled sequence (``k`` / ``v`` and the scales a
        tensor, or a list of one per shard, on any device); returns
        False if it can never fit."""
        self.discard(req_id)   # same-key overwrite must not double-count
        k, v = _shards(k), _shards(v)
        parts = k + v
        if k_scale is not None:
            k_scale, v_scale = _shards(k_scale), _shards(v_scale)
            parts += k_scale + v_scale
        nbytes = sum(t.nbytes for t in parts)
        if nbytes > self.max_bytes:
            return False
        while self.used_bytes + nbytes > self.max_bytes and self._entries:
            _, old = self._entries.popitem(last=False)
            self.used_bytes -= old.nbytes
            self.evicted_entries += 1
        n_pages = k[0].shape[1]
        events = []
        for j, t in enumerate(k):
            ev = None
            if t.device.type == "cuda":
                k[j], v[j] = _to_host(t), _to_host(v[j])
                if k_scale is not None:
                    k_scale[j], v_scale[j] = _to_host(k_scale[j]), _to_host(v_scale[j])
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(t.device))
            events.append(ev)
        self._entries[req_id] = HostKVEntry(
            k=k, v=v, written=written, nbytes=nbytes, n_pages=n_pages,
            k_scale=k_scale, v_scale=v_scale, events=events)
        self.used_bytes += nbytes
        self.spilled_pages += n_pages
        return True

    def has(self, req_id: str) -> bool:
        return req_id in self._entries

    def pop(self, req_id: str) -> Optional[HostKVEntry]:
        entry = self._entries.pop(req_id, None)
        if entry is not None:
            self.used_bytes -= entry.nbytes
            self.restored_pages += entry.n_pages
            self.hits += 1
        else:
            self.misses += 1
        return entry

    def discard(self, req_id: str) -> None:
        entry = self._entries.pop(req_id, None)
        if entry is not None:
            self.used_bytes -= entry.nbytes


def gather_pages(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Copy pages out of the pools: [L, P, ps, H, D] -> [L, n, ...]
    (also the scale pools, [L, P, H] -> [L, n, H])."""
    return cache_k.index_select(1, ids), cache_v.index_select(1, ids)


def scatter_pages(cache_k: torch.Tensor, cache_v: torch.Tensor, ids: torch.Tensor,
                  k_pages: torch.Tensor, v_pages: torch.Tensor,
                  after: Optional["torch.cuda.Event"] = None) -> None:
    """Write spilled pages back into page slots ``ids`` of the pools, in
    place: the pool tensors keep their storage.  ``after`` (the spill's
    copy event) orders the upload behind the download it reads."""
    if after is not None:
        torch.cuda.current_stream(cache_k.device).wait_event(after)
    dev = cache_k.device
    cache_k.index_copy_(1, ids, k_pages.to(dev, cache_k.dtype, non_blocking=True))
    cache_v.index_copy_(1, ids, v_pages.to(dev, cache_v.dtype, non_blocking=True))
