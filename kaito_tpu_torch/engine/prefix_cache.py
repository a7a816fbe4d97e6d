"""Prefix-caching KV page allocator: a radix tree over page-sized token
chunks, so sequences that share a prompt prefix share its pages.

The port's own copy of the JAX package's native prefix cache
(``kaito_tpu/native/src/prefix_cache.cc`` behind ``NativePrefixCache``),
in Python so that serving needs no host compiler.  Same API and the
same page-level semantics:

- page 0 is the null page and is never handed out; the free stack
  starts at pages ``num_pages - 1 ... 1`` and pops from the back;
- ``acquire`` shares only whole prompt pages that match from the start
  (one hit per shared page, one miss at the first mismatch) and rolls
  everything back on OOM;
- ``release`` commits the whole pages of ``tokens``; a page whose
  content is already committed under another page is freed, and tail
  pages that were never committed go back to the free stack;
- ``release_uncommitted`` returns the shared references from the start
  and commits nothing;
- eviction takes the least recently released committed node whose
  refcount is 0, ties broken by insertion order (the native code takes
  whichever its hash map visits first);
- ``available`` counts free pages plus evictable nodes.

Each node is keyed by its parent's key and its own chunk, so equal
chunks under different prefixes are different nodes, and a node whose
parent was evicted is found again once the same parent is committed.
Unlike the native code, which scans every node to evict or to count,
``available`` is O(1) and taking a page O(log n): the evictable nodes
sit in a heap ordered by (release tick, insertion order), with stale
entries skipped when popped and compacted when they pile up.
"""

from __future__ import annotations

import heapq
import threading
from typing import Optional


class _Node:
    __slots__ = ("page", "refcount", "lru", "seq", "key")

    def __init__(self, page: int, key: tuple, lru: int, seq: int):
        self.page = page
        self.refcount = 0      # sequences holding this page right now
        self.lru = lru         # tick of the last release that touched it
        self.seq = seq         # insertion order (the eviction tie-break)
        self.key = key


class PrefixCache:
    """Prefix-caching page allocator over ``num_pages`` pages of
    ``page_size`` tokens (page 0 reserved)."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2 or page_size < 1:
            raise ValueError("bad prefix cache parameters")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(num_pages - 1, 0, -1))
        self._nodes: dict[tuple, _Node] = {}
        self._owner: dict[int, tuple] = {}     # committed page -> node key
        self._heap: list[tuple] = []           # (lru, seq, key) candidates
        self._evictable = 0
        self._tick = 0
        self._seq = 0
        self._lock = threading.Lock()
        self.hits = self.misses = self.evictions = 0

    # -- the tree ------------------------------------------------------

    def _chunk_key(self, tokens, i: int, parent: int) -> tuple:
        ps = self.page_size
        return (parent, tuple(tokens[i * ps:(i + 1) * ps]))

    def _add_ref(self, node: _Node, delta: int) -> None:
        was = node.refcount == 0
        node.refcount += delta
        if node.refcount == 0 and not was:
            self._push(node)
        elif was and node.refcount != 0:
            self._evictable -= 1

    def _push(self, node: _Node) -> None:
        """``node`` became evictable."""
        self._evictable += 1
        heapq.heappush(self._heap, (node.lru, node.seq, node.key))
        if len(self._heap) > 2 * len(self._nodes) + 64:
            self._compact()

    def _compact(self) -> None:
        self._heap = [(n.lru, n.seq, k) for k, n in self._nodes.items()
                      if n.refcount == 0]
        heapq.heapify(self._heap)

    def _evict_one(self) -> bool:
        while self._heap:
            lru, seq, key = heapq.heappop(self._heap)
            node = self._nodes.get(key)
            if node is None or node.refcount != 0 or node.lru != lru \
                    or node.seq != seq:
                continue           # stale: re-referenced, retouched or gone
            del self._nodes[key]
            del self._owner[node.page]
            self._evictable -= 1
            self._free.append(node.page)
            self.evictions += 1
            return True
        return False

    def _take_page(self) -> int:
        if not self._free and not self._evict_one():
            return -1
        return self._free.pop()

    # -- the API -------------------------------------------------------

    def acquire(self, tokens: list[int], max_total_tokens: int
                ) -> Optional[tuple[list[int], int]]:
        """Pages covering ``max_total_tokens`` for a sequence starting
        with ``tokens``, and how many leading tokens they already hold:
        ``(pages, cached_tokens)``, or None on OOM (nothing held)."""
        ps = self.page_size
        total_pages = -(-max_total_tokens // ps)
        full = len(tokens) // ps
        pages: list[int] = []
        shared: list[_Node] = []
        cached, parent, matching = 0, 0, True
        with self._lock:
            for i in range(total_pages):
                if matching and i < full:
                    key = self._chunk_key(tokens, i, parent)
                    node = self._nodes.get(key)
                    if node is not None:
                        self._add_ref(node, 1)
                        pages.append(node.page)
                        shared.append(node)
                        cached += ps
                        parent = hash(key)
                        self.hits += 1
                        continue
                    matching = False
                    self.misses += 1
                p = self._take_page()
                if p < 0:
                    for node in shared:
                        self._add_ref(node, -1)
                    self._free.extend(pages[len(shared):])
                    return None
                pages.append(p)
        return pages, cached

    def release(self, tokens: list[int], pages: list[int]) -> None:
        """Release a sequence: commit the whole pages of ``tokens`` (the
        tokens whose KV landed) for reuse and drop its references."""
        ps = self.page_size
        full = min(len(tokens) // ps, len(pages))
        with self._lock:
            self._tick += 1
            parent = 0
            for i, page in enumerate(pages):
                if i >= full:
                    # a tail page (partial, or past the tokens): uncached
                    if page not in self._owner:
                        self._free.append(page)
                    continue
                key = self._chunk_key(tokens, i, parent)
                node = self._nodes.get(key)
                if node is not None and node.page == page:
                    node.lru = self._tick      # before a push re-queues it
                    self._add_ref(node, -1)
                elif node is not None:
                    # the same content is committed under another page
                    self._free.append(page)
                elif page not in self._owner:
                    self._seq += 1
                    node = _Node(page, key, self._tick, self._seq)
                    self._nodes[key] = node
                    self._owner[page] = key
                    self._push(node)
                parent = hash(key)

    def release_uncommitted(self, tokens: list[int], pages: list[int]) -> None:
        """Return the shared references from the start and free the
        rest, committing nothing (for pages whose KV is not trusted)."""
        ps = self.page_size
        full = min(len(tokens) // ps, len(pages))
        with self._lock:
            self._tick += 1
            parent, matching = 0, True
            for i, page in enumerate(pages):
                if matching and i < full:
                    key = self._chunk_key(tokens, i, parent)
                    node = self._nodes.get(key)
                    if node is not None and node.page == page:
                        node.lru = self._tick
                        self._add_ref(node, -1)
                        parent = hash(key)
                        continue
                    matching = False
                if page not in self._owner:
                    self._free.append(page)

    def alloc_raw(self, n: int) -> Optional[list[int]]:
        """``n`` plain pages for a running sequence's growth (evicting
        as needed); they return through release() with the rest.  None
        when the pool cannot supply them (nothing taken)."""
        taken: list[int] = []
        with self._lock:
            for _ in range(n):
                p = self._take_page()
                if p < 0:
                    self._free.extend(taken)
                    return None
                taken.append(p)
        return taken

    @property
    def available(self) -> int:
        """Free pages plus evictable committed pages."""
        return len(self._free) + self._evictable

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "cached_pages": len(self._nodes)}
