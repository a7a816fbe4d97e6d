"""Cluster-wide KV pool, the replica-local side.

The port's own copy of ``kaito_tpu/engine/kv_pool.py``.  Every replica
keeps a byte-budgeted LRU of finished prompt prefixes (whole-page KV
slabs staged by the P/D export machinery, ``engine/pd.py``), keyed by
the SAME chained FNV-1a block hashes the router computes over request
bodies (``runtime/routing.prefix_blocks``).  The store is served over
the chunked P/D wire (``/kv_pool/<key>/meta`` + ``/chunk/<i>``) and its
key set is advertised at ``/debug/kv_pool``.  Below the host store a
bounded directory of slab files (:class:`DiskPageStore`) holds what the
host LRU demotes; its layout is the JAX package's, byte for byte, so a
directory written by either package is read by the other.

The block hashes are an INDEX, never an authority: the meta response
carries the entry's exact ``prompt_tokens`` and the fetching engine
imports only the longest common whole-page token prefix
(``common_prefix_pages``).  Any miss, eviction or transfer failure
degrades to the local prefill the scheduler already has.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from kaito_tpu_torch.engine.pd import _slab_meta, serialize_chunk, slab_plans, wire_dtype
from kaito_tpu_torch.runtime.routing import adapter_seed, prefix_blocks

# one KV page of page_size tokens covers page_size * CHARS_PER_TOKEN
# prompt chars — the same heuristic the EPP uses to align its block
# size to the engine's page size (routing.CHARS_PER_TOKEN)
CHARS_PER_TOKEN = 4
_MASK64 = (1 << 64) - 1


def pool_block_chars(page_size: int) -> int:
    """Char-block size whose blocks line up 1:1 with KV pages."""
    return page_size * CHARS_PER_TOKEN


def prompt_pool_blocks(text: str, page_size: int,
                       adapter: str = "") -> list[int]:
    """The engine-side publisher's block hashes for a prompt.  MUST
    stay the exact chain the EPP computes (``prefix_blocks`` at
    ``kv_page_size * 4`` chars) — a silent divergence makes the global
    index useless (pinned by tests/test_kv_pool.py).  ``adapter`` seeds
    the chain so KV computed under a LoRA adapter never hash-matches
    base KV (or another adapter's) for the same text; "" keeps every
    pre-adapter chain byte-identical."""
    return prefix_blocks(text, pool_block_chars(page_size),
                         seed=adapter_seed(adapter))


def pool_key(blocks: list[int]) -> str:
    """Store key of a prefix: the chained hash of its LAST block (it
    folds every earlier block, so it names the whole prefix)."""
    return f"{blocks[-1] & _MASK64:016x}"


def meta_nbytes(meta: dict) -> int:
    """Host bytes a staged entry's chunks occupy once drained (K + V +
    fp32 scale slabs for int8 pools), from the wire meta alone."""
    size = wire_dtype(meta["dtype"]).itemsize
    n = math.prod(meta["shape"]) * size
    n += math.prod(meta.get("v_shape", meta["shape"])) * size
    if "ks_shape" in meta:
        n += (math.prod(meta["ks_shape"]) + math.prod(meta["vs_shape"])) * 4
    return n


class HostExport:
    """A StagedExport-shaped serving surface over HOST tensors.

    After a fetch the target replica replicates the imported prefix into
    its own store (so the pool heals toward N holders); the assembled
    host slab is what it has, and this wraps it with the ``meta`` /
    ``plans`` / ``get_chunk`` surface the pool endpoints serve,
    serializing chunks on demand."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 ks: Optional[torch.Tensor] = None,
                 vs: Optional[torch.Tensor] = None, *,
                 n_tokens: int, model: str, prompt_tokens: list[int]):
        self._k, self._v, self._ks, self._vs = k, v, ks, vs
        self.plans = slab_plans(k, v, ks, vs)
        self.meta = _slab_meta(k, v, ks, vs, n_tokens=n_tokens, model=model,
                               chunks=[p.to_json() for p in self.plans])
        self.prompt_tokens = list(prompt_tokens)
        self.first_token = -1

    @property
    def n_chunks(self) -> int:
        return len(self.plans)

    def ensure_draining(self) -> None:
        """Parity with StagedExport: the bytes are already on the host."""

    def get_chunk(self, i: int, timeout: float = 60.0, consume: bool = False) -> bytes:
        if not 0 <= i < len(self.plans):
            raise IndexError(f"chunk {i} out of range ({len(self.plans)})")
        p = self.plans[i]
        sl = (slice(p.layer_lo, p.layer_hi), slice(p.page_lo, p.page_hi))
        ks = vs = None
        if self._ks is not None:
            ks, vs = self._ks[sl], self._vs[sl]
        return serialize_chunk(self._k[sl], self._v[sl], ks, vs)


@dataclass
class PoolEntry:
    """One published prefix: whole pages only, tokens are authoritative."""

    key: str
    blocks: list[int]          # chained block hashes, one per KV page
    n_tokens: int              # == n_pages * page_size
    n_pages: int
    export: object             # StagedExport or HostExport
    nbytes: int
    created: float = field(default_factory=time.monotonic)


class PrefixPageStore:
    """Byte-budgeted thread-safe LRU of published prefixes, keyed by
    ``pool_key``.  Dropping an entry is always safe — the fetch path
    treats a 410 exactly like a miss and recomputes locally."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self.used_bytes = 0
        self._entries: "collections.OrderedDict[str, PoolEntry]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.published_total = 0
        self.evictions_total = 0
        self.hits_total = 0          # get() served a fetch
        self.misses_total = 0        # get() came up empty (evicted/never had)
        # tier-3 spill hook (docs/kv-pool.md): when a disk tier exists
        # the engine points this at its async spill queue so LRU
        # victims demote to SSD instead of vanishing.  Called OUTSIDE
        # the store lock with the evicted PoolEntry; must never block.
        self.on_evict: Optional[Callable[[PoolEntry], None]] = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def put(self, entry: PoolEntry) -> bool:
        """Publish; returns False if the entry can never fit."""
        if entry.nbytes > self.max_bytes:
            return False
        victims: list[PoolEntry] = []
        with self._lock:
            old = self._entries.pop(entry.key, None)
            if old is not None:
                self.used_bytes -= old.nbytes
            while (self.used_bytes + entry.nbytes > self.max_bytes
                   and self._entries):
                _, victim = self._entries.popitem(last=False)
                self.used_bytes -= victim.nbytes
                self.evictions_total += 1
                victims.append(victim)
            self._entries[entry.key] = entry
            self.used_bytes += entry.nbytes
            self.published_total += 1
        if self.on_evict is not None:
            for victim in victims:
                self.on_evict(victim)
        return True

    def get(self, key: str) -> Optional[PoolEntry]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses_total += 1
                return None
            self._entries.move_to_end(key)
            self.hits_total += 1
            return entry

    def peek(self, key: str) -> Optional[PoolEntry]:
        """Lookup WITHOUT hit/miss accounting or LRU touch — chunk
        pulls of an already-claimed fetch must not inflate the hit
        rate (one fetch = one hit, counted at the meta handshake)."""
        with self._lock:
            return self._entries.get(key)

    def has(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def advert(self, max_entries: int = 0) -> list[dict]:
        """The holder's index advert, freshest last-used first: key +
        per-page block-hash chain (hex — JSON numbers lose 64-bit
        precision) + token count, enough for the EPP to match request
        prefixes without ever seeing KV bytes.  ``max_entries`` > 0
        caps the advert to the freshest N rows so large pools stop
        inflating every EPP scrape; a capped advert is authoritative
        only for the rows it lists (the scraper merges instead of
        wholesale-replacing)."""
        with self._lock:
            entries = list(self._entries.values())
        if max_entries > 0:
            entries = entries[-max_entries:]
        return [{"key": e.key,
                 "blocks": [f"{b & _MASK64:016x}" for b in e.blocks],
                 "n_tokens": e.n_tokens}
                for e in reversed(entries)]


class DiskPageStore:
    """Tier-3 of the KV pool: a bounded directory of SSD slab files
    holding prefixes demoted out of the host-RAM ``PrefixPageStore``
    LRU (docs/kv-pool.md "Tier 3: SSD").

    Layout — per entry, two files named by the same ``pool_key``:

    - ``<key>.slab``: the entry's ``serialize_chunk`` outputs
      concatenated in plan order, byte-identical to what the pool's
      ``/chunk/<i>`` endpoints would have served (int8 scale slabs and
      all).  Chunk boundaries live in the meta, so a read is one
      ``seek`` + one bounded ``read`` — mmap-friendly, no parsing.
    - ``<key>.json``: wire meta (model/dtype/shapes/chunk plans),
      chunk byte sizes, block-hash chain (hex), token count, and the
      authoritative ``prompt_tokens``.

    The slab is written first, the meta second, both via the
    flight-recorder tmp+rename idiom — a meta file therefore PROVES a
    complete slab, and a crash mid-spill leaves only an orphan slab
    that the next startup scan deletes.  Pruning is mtime-LRU against
    ``max_bytes``; a read hit touches the meta so conversations that
    keep coming back stay resident.  Like every pool tier, dropping an
    entry is always safe — the fetch path falls through to remote
    peers and then local recompute."""

    SLAB = ".slab"
    META = ".json"

    def __init__(self, root: str, max_bytes: int):
        self.root = root
        self.max_bytes = max_bytes
        self.used_bytes = 0
        self._lock = threading.Lock()
        self._sizes: dict[str, int] = {}     # key -> slab+meta bytes
        self.hits_total = 0          # lookup_longest found an entry
        self.misses_total = 0        # lookup_longest came up empty
        self.spills_total = 0        # entries written by the spill worker
        self.evictions_total = 0     # entries pruned by the byte budget
        self.errors_total = 0        # corrupt meta/slab, failed writes
        os.makedirs(root, exist_ok=True)
        self._scan()

    def __len__(self) -> int:
        with self._lock:
            return len(self._sizes)

    def _paths(self, key: str) -> tuple[str, str]:
        # keys are our own 16-hex-char pool_key strings; refuse
        # anything else so a hostile key can't traverse out of root
        if not (len(key) == 16 and all(c in "0123456789abcdef"
                                       for c in key)):
            raise ValueError(f"bad pool key {key!r}")
        return (os.path.join(self.root, key + self.SLAB),
                os.path.join(self.root, key + self.META))

    def _scan(self) -> None:
        """Rebuild the in-memory index from disk (restart survival):
        a meta file with a matching slab is an entry; anything else —
        orphan slabs from interrupted spills, stray tmp files — is
        deleted."""
        with self._lock:
            for name in sorted(os.listdir(self.root)):
                path = os.path.join(self.root, name)
                if not os.path.isfile(path):
                    continue
                if name.endswith(self.META) and len(name) == 16 + len(self.META):
                    key = name[:16]
                    slab, meta = path[:-len(self.META)] + self.SLAB, path
                    if os.path.exists(slab):
                        size = os.path.getsize(slab) + os.path.getsize(meta)
                        self._sizes[key] = size
                        self.used_bytes += size
                    else:
                        os.unlink(meta)
                elif name.endswith(self.SLAB):
                    key = name[:16] if len(name) == 16 + len(self.SLAB) else ""
                    if key not in self._sizes and not os.path.exists(
                            path[:-len(self.SLAB)] + self.META):
                        os.unlink(path)
                elif name.endswith(".tmp"):
                    os.unlink(path)
            self._prune_locked()

    def has(self, key: str) -> bool:
        with self._lock:
            return key in self._sizes

    def spill(self, entry: PoolEntry) -> bool:
        """Persist a demoted entry (spill-worker thread only — chunk
        serialization may block on the export's D2H drain).  Returns
        True if the entry is on disk afterwards."""
        key = entry.key
        with self._lock:
            if key in self._sizes:
                return True          # already demoted once before
        if entry.nbytes > self.max_bytes:
            return False
        exp = entry.export
        try:
            exp.ensure_draining()
            # consume=False: pool entries serve arbitrarily many
            # readers (same contract as the /chunk endpoints) — the
            # spill must not destroy chunks a concurrent fetch needs
            chunks = [exp.get_chunk(i, consume=False)
                      for i in range(len(exp.plans))]
            blob = b"".join(chunks)
            meta = {"meta": exp.meta,
                    "chunk_sizes": [len(c) for c in chunks],
                    "blocks": [f"{b & _MASK64:016x}" for b in entry.blocks],
                    "n_tokens": entry.n_tokens,
                    "n_pages": entry.n_pages,
                    "prompt_tokens": [int(t) for t in exp.prompt_tokens]}
            meta_bytes = json.dumps(meta).encode()
            slab_path, meta_path = self._paths(key)
            tmp = slab_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, slab_path)
            tmp = meta_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(meta_bytes)
            os.replace(tmp, meta_path)
        except Exception:
            self.errors_total += 1
            return False
        with self._lock:
            if key not in self._sizes:
                size = len(blob) + len(meta_bytes)
                self._sizes[key] = size
                self.used_bytes += size
                self.spills_total += 1
            self._prune_locked()
        return True

    def load_meta(self, key: str) -> Optional[dict]:
        """Parsed meta for a resident entry, or None.  Corrupt meta
        (unparseable JSON, missing fields) drops the entry — the
        caller falls through to the next tier."""
        with self._lock:
            if key not in self._sizes:
                return None
        _, meta_path = self._paths(key)
        try:
            with open(meta_path, "rb") as f:
                meta = json.loads(f.read())
            if not isinstance(meta.get("chunk_sizes"), list) \
                    or "meta" not in meta:
                raise ValueError("malformed disk meta")
            return meta
        except (OSError, ValueError):
            self.errors_total += 1
            self.drop(key)
            return None

    def lookup_longest(self, blocks: list[int]) -> Optional[tuple[str, dict]]:
        """Longest stored prefix of the request's block chain:
        ``(key, meta)`` for the deepest ``blocks[:n]`` whose key is
        resident, or None.  One lookup counts one hit or one miss."""
        for n in range(len(blocks), 0, -1):
            key = pool_key(blocks[:n])
            meta = self.load_meta(key)
            if meta is not None:
                self.hits_total += 1
                self.touch(key)
                return key, meta
        self.misses_total += 1
        return None

    def read_chunk(self, key: str, i: int, meta: dict) -> bytes:
        """Chunk ``i``'s exact serialized bytes from the slab.  A
        truncated or vanished slab raises — the import machinery
        already turns any feed error into a clean local-recompute
        fallback (``kv_pool_fetch_failures_total``)."""
        sizes = meta["chunk_sizes"]
        if not 0 <= i < len(sizes):
            raise IndexError(f"chunk {i} out of range ({len(sizes)})")
        off = sum(sizes[:i])
        slab_path, _ = self._paths(key)
        try:
            with open(slab_path, "rb") as f:
                f.seek(off)
                data = f.read(int(sizes[i]))
        except OSError as e:
            self.errors_total += 1
            raise ValueError(f"disk slab read failed: {e}") from e
        if len(data) != int(sizes[i]):
            self.errors_total += 1
            self.drop(key)
            raise ValueError(
                f"truncated disk slab {key} chunk {i}: "
                f"{len(data)} != {sizes[i]}")
        return data

    def touch(self, key: str) -> None:
        """Refresh LRU position (prune order is meta mtime)."""
        try:
            _, meta_path = self._paths(key)
            os.utime(meta_path)
        except OSError:
            pass

    def drop(self, key: str) -> None:
        with self._lock:
            size = self._sizes.pop(key, None)
            if size is not None:
                self.used_bytes -= size
        try:
            slab_path, meta_path = self._paths(key)
            for p in (meta_path, slab_path):
                if os.path.exists(p):
                    os.unlink(p)
        except (OSError, ValueError):
            pass

    def _prune_locked(self) -> None:
        """Evict oldest-touched entries until under budget (meta
        mtime ascending — ``touch`` on read keeps live conversations
        resident).  Caller holds the lock."""
        if self.used_bytes <= self.max_bytes:
            return
        ages = []
        for key in self._sizes:
            _, meta_path = self._paths(key)
            try:
                ages.append((os.path.getmtime(meta_path), key))
            except OSError:
                ages.append((0.0, key))
        ages.sort()
        for _, key in ages:
            if self.used_bytes <= self.max_bytes:
                break
            size = self._sizes.pop(key, 0)
            self.used_bytes -= size
            self.evictions_total += 1
            try:
                slab_path, meta_path = self._paths(key)
                for p in (meta_path, slab_path):
                    if os.path.exists(p):
                        os.unlink(p)
            except (OSError, ValueError):
                pass


def common_prefix_pages(req_tokens: list[int], entry_tokens: list[int],
                        page_size: int) -> int:
    """Whole pages of ``entry_tokens`` that are a verified token-level
    prefix of ``req_tokens`` — capped below the full request so at
    least one token remains for the prefill to produce logits from.
    This, not the hash match, is the import authority."""
    limit = min(len(req_tokens) - 1, len(entry_tokens))
    n = 0
    while n < limit and req_tokens[n] == entry_tokens[n]:
        n += 1
    return n // page_size
