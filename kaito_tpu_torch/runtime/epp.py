"""First-party endpoint picker (EPP) behind the InferencePool.

Both controllers render an InferencePool whose ``extensionRef`` names
``<name>-epp`` (``controllers/inferenceset.py``,
``controllers/multiroleinference.py``); this module is that picker.
It rides the shared routing data path (``runtime/routing.py`` — same
breaker/retry/SSE relay/drain as the round-robin dp_router front) and
replaces only the candidate ORDER with a scored one (docs/routing.md):

1. **Prefix-hash affinity** — a bounded LRU of recent prompt-prefix
   block hashes per backend, block size aligned to the engine's
   prefix-cache page size, so repeated-prefix traffic lands on the
   replica whose radix tree already holds the KV (SGLang-style
   cache-aware routing).
2. **Live load** — ``kaito:batch_occupancy``, queue depth, and KV
   utilization scraped from each replica's ``/metrics``; hysteresis
   (enter-high/exit-low watermarks) keeps affinity from steering onto
   a saturated or breaker-open backend.
3. **PD plugin chain** — decode requests carrying a staged-KV
   ``kv_transfer`` handle steer to the prefill-owning replica (or its
   group), honoring the MultiRoleInference ``eppPluginsConfig`` chain
   (pd-filter / kv-locality-scorer / queue-depth-scorer).

The picker exports its own ``kaito:epp_*`` series next to the shared
``kaito:router_*`` transport families on ``/metrics``.

The port's own copy of ``kaito_tpu/runtime/epp.py`` over the port's
``runtime/routing.py``, metric types (``engine/metrics.py``) and QoS
ranks (``engine/qos.py``).  The affinity block follows the scraped
``kaito:kv_page_size``: at the port's default page of 64 tokens a block
is 256 chars, so a prompt shorter than that earns no affinity.
"""

from __future__ import annotations

import argparse
import collections
import http.client
import json
import logging
import signal
import threading
from typing import Iterable, Optional

from kaito_tpu_torch.engine.metrics import Counter, Gauge, Registry
from kaito_tpu_torch.engine.qos import priority_rank
from kaito_tpu_torch.runtime.routing import (Backend, PrefixAffinityIndex,
                                             RoutingCore, _BackendPoller, _MASK64,
                                             _fnv1a, adapter_seed,
                                             extract_prompt_text,
                                             make_routing_server, prefix_blocks)

logger = logging.getLogger(__name__)

# With no tokenizer in the picker, block size is expressed in CHARS and
# aligned to the engine's KV page size (tokens) via a chars-per-token
# estimate: ~4 chars/token is the usual English/BPE rule of thumb, and
# over-estimating only makes affinity blocks COARSER than engine pages
# (a char-block hit still maps onto whole cached pages).
CHARS_PER_TOKEN = 4
DEFAULT_BLOCK_CHARS = 64       # engine default page_size=16 tokens * 4

# score weight that dominates load terms when most prefix blocks match
AFFINITY_WEIGHT = 3.0

# cluster KV-pool locality weight: below AFFINITY_WEIGHT (a radix-tree
# hit on the picked replica beats a cross-replica fetch) but above the
# load terms, so a healthy holder wins ties against equally-loaded peers
POOL_WEIGHT = 2.5

# adapter-residency weight (docs/multi-lora.md): below POOL_WEIGHT —
# faulting an adapter in from a replica's host tier (or hot-loading it)
# is cheaper than re-prefilling a long prefix — but above the load
# terms, so adapter-tagged traffic concentrates on replicas already
# serving that adapter instead of spreading slot-table churn fleet-wide
ADAPTER_WEIGHT = 2.0

# cap on adapter names folded in per advert — a hand-rolled replica
# can't balloon the index (real slot tables hold a few dozen at most)
_MAX_ADAPTERS_PER_ADVERT = 1024


class KVPoolIndex:
    """Cluster-wide prefix→holder lookup (docs/kv-pool.md).

    Built from the ``/debug/kv_pool`` adverts each replica serves:
    every advertised entry contributes one index row PER BLOCK HASH in
    its chain, so a request matching only the first half of a long
    published prefix still finds the holder.  Because the hashes are
    chained (block *i* folds every earlier block), equality at position
    *i* implies — up to hash collision, which the ENGINE's token-level
    trim makes harmless — that the whole *i+1*-block prefix matches.
    Rows are keyed by (block_chars, hash) so adverts from replicas
    configured with a different page size can never cross-match."""

    # retained rows per URL when a replica sends CAPPED adverts (the
    # merge path below never wholesale-replaces, so bound what a
    # long-lived replica can accumulate in the index)
    MAX_ENTRIES_PER_URL = 4096

    def __init__(self):
        self._lock = threading.Lock()
        # url -> {"block_chars": int, "entries": OrderedDict key->entry
        # (freshest LAST)}
        self._adverts: dict[str, dict] = {}
        # (block_chars, hash hex) -> url -> (entry key, n_pages, n_tokens)
        self._index: dict = {}
        self.updates = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def update(self, url: str, advert: Optional[dict]) -> None:
        """Fold one replica's advert (None/empty/disabled = forget
        it — a scrape failure or a rollout restart must not leave
        stale holders steering fetches at a replica without the KV;
        the fetch path degrades to recompute anyway, this just keeps
        the hint hit rate honest).

        A FULL advert wholesale-replaces the replica's rows.  A CAPPED
        advert (``"capped": true`` — the store listed only its
        freshest N entries) is authoritative only for the rows it
        lists: listed keys are refreshed/added, unlisted rows are
        retained (bounded by ``MAX_ENTRIES_PER_URL``) — an evicted
        retained row just degrades a later fetch to an ordinary
        miss."""
        with self._lock:
            if (isinstance(advert, dict) and advert.get("enabled")
                    and advert.get("entries")):
                bc = int(advert.get("block_chars") or 0)
                # the wire lists freshest FIRST; key the rows freshest
                # LAST so popitem(last=False) ages out the stalest
                fresh: "collections.OrderedDict[str, dict]" = \
                    collections.OrderedDict(
                        (str(e.get("key") or ""), e)
                        for e in reversed(advert["entries"])
                        if e.get("key"))
                prev = self._adverts.get(url)
                if (advert.get("capped") and prev is not None
                        and prev["block_chars"] == bc):
                    merged = prev["entries"]
                    for k, e in fresh.items():
                        merged.pop(k, None)
                        merged[k] = e
                    while len(merged) > self.MAX_ENTRIES_PER_URL:
                        merged.popitem(last=False)
                    entries = merged
                else:
                    entries = fresh
                self._adverts[url] = {"block_chars": bc,
                                      "entries": entries}
            else:
                self._adverts.pop(url, None)
            self._rebuild_locked()
            self.updates += 1

    def drop(self, url: str) -> None:
        self.update(url, None)

    def _rebuild_locked(self) -> None:
        idx: dict = {}
        for url, adv in self._adverts.items():
            bc = adv["block_chars"]
            for e in adv["entries"].values():
                blocks = e.get("blocks") or []
                key = str(e.get("key") or "")
                n_tokens = int(e.get("n_tokens") or 0)
                if not blocks or not key:
                    continue
                for i, h in enumerate(blocks):
                    holders = idx.setdefault((bc, str(h)), {})
                    cur = holders.get(url)
                    # same hash can appear in several entries (shared
                    # prefixes): keep the one serving the most pages
                    if cur is None or i + 1 > cur[1]:
                        holders[url] = (key, i + 1, n_tokens)
        self._index = idx

    def match(self, blocks: list[int],
              block_chars: int) -> dict[str, tuple]:
        """url -> (entry key, matched pages, entry tokens) for the
        LONGEST advertised prefix of ``blocks`` — scan from the tail so
        the first hit is the best one."""
        hexes = [f"{b & _MASK64:016x}" for b in blocks]
        with self._lock:
            for i in range(len(hexes) - 1, -1, -1):
                holders = self._index.get((block_chars, hexes[i]))
                if holders:
                    return dict(holders)
        return {}


class KVPoolScraper(_BackendPoller):
    """Background ``/debug/kv_pool`` advert scrape per backend: keeps
    the cluster prefix→holder index fresh without spending a request
    round trip.  A 403 (pool disabled), connect failure, or garbage
    body clears that replica's rows."""

    def __init__(self, picker: "EndpointPicker", interval_s: float = 2.0,
                 timeout_s: float = 2.0):
        super().__init__("epp-kv-pool-scraper", interval_s)
        self.picker = picker
        self.timeout_s = timeout_s

    def targets(self) -> Iterable[Backend]:
        return [b for b in self.picker.backends if b.alive]

    def poll_one(self, b: Backend) -> None:
        advert = None
        try:
            conn = http.client.HTTPConnection(b.host, b.port,
                                              timeout=self.timeout_s)
            try:
                conn.request("GET", "/debug/kv_pool")
                resp = conn.getresponse()
                if resp.status == 200:
                    advert = json.loads(resp.read().decode("utf-8",
                                                           "replace"))
            finally:
                conn.close()
        except (ConnectionError, OSError, ValueError):
            advert = None
        if self.picker.pool_index is not None:
            self.picker.pool_index.update(b.url, advert)


class AdapterIndex:
    """Fleet-wide adapter→holder lookup (docs/multi-lora.md).

    Built from the ``/v1/adapters`` snapshots each replica serves:
    per replica, which adapters sit in its HBM slot table (score 1.0 —
    requests dispatch against them immediately) and which are parked in
    its host tier (score 0.5 — a fault-back-in away).  The union of all
    advertised names doubles as the picker's answer to "is this
    request's ``model`` field an adapter?" — the EPP has no catalog of
    its own, so only names the fleet actually serves get the
    adapter-seeded hash chain (a not-yet-scraped adapter degrades to
    unseeded blocks: no affinity signal, no pool match, never a wrong
    route)."""

    def __init__(self):
        self._lock = threading.Lock()
        # url -> {adapter name -> residency score (1.0 HBM, 0.5 host)}
        self._by_url: dict[str, dict[str, float]] = {}
        self._names: set[str] = set()           # fleet-wide union
        self.updates = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._names)

    def update(self, url: str, snap: Optional[dict]) -> None:
        """Replace one replica's advert (None/disabled = forget it —
        a restart or scrape failure must not leave stale residency
        steering adapter traffic at a replica that dropped it)."""
        with self._lock:
            if isinstance(snap, dict) and snap.get("enabled"):
                scores: dict[str, float] = {}
                for e in (snap.get("resident") or
                          [])[:_MAX_ADAPTERS_PER_ADVERT]:
                    name = str((e or {}).get("name") or "")
                    if name:
                        scores[name] = 1.0
                for name in (snap.get("host_tier") or
                             [])[:_MAX_ADAPTERS_PER_ADVERT]:
                    scores.setdefault(str(name), 0.5)
                if scores:
                    self._by_url[url] = scores
                else:
                    self._by_url.pop(url, None)
            else:
                self._by_url.pop(url, None)
            self._names = set().union(*self._by_url.values()) \
                if self._by_url else set()
            self.updates += 1

    def drop(self, url: str) -> None:
        self.update(url, None)

    def known(self, name: str) -> bool:
        with self._lock:
            return name in self._names

    def residency(self, name: str) -> dict[str, float]:
        """url -> residency score for every replica serving ``name``."""
        with self._lock:
            return {url: scores[name]
                    for url, scores in self._by_url.items()
                    if name in scores}


class AdapterScraper(_BackendPoller):
    """Background ``/v1/adapters`` snapshot scrape per backend (the
    same poller family as the KV-pool advert scrape).  A 403 (cache
    disabled), connect failure, or garbage body clears that replica's
    residency rows."""

    def __init__(self, picker: "EndpointPicker", interval_s: float = 2.0,
                 timeout_s: float = 2.0):
        super().__init__("epp-adapter-scraper", interval_s)
        self.picker = picker
        self.timeout_s = timeout_s

    def targets(self) -> Iterable[Backend]:
        return [b for b in self.picker.backends if b.alive]

    def poll_one(self, b: Backend) -> None:
        snap = None
        try:
            conn = http.client.HTTPConnection(b.host, b.port,
                                              timeout=self.timeout_s)
            try:
                conn.request("GET", "/v1/adapters")
                resp = conn.getresponse()
                if resp.status == 200:
                    snap = json.loads(resp.read().decode("utf-8",
                                                         "replace"))
            finally:
                conn.close()
        except (ConnectionError, OSError, ValueError):
            snap = None
        if self.picker.adapter_index is not None:
            self.picker.adapter_index.update(b.url, snap)


def default_epp_plugins_config() -> dict:
    """Standalone (InferenceSet) chain: no roles to filter, so the
    pd-filter is a no-op and affinity + load do the work."""
    return {
        "plugins": [
            {"type": "pd-filter"},
            {"type": "prefix-affinity-scorer", "weight": AFFINITY_WEIGHT},
            {"type": "kv-locality-scorer", "weight": 2},
            {"type": "queue-depth-scorer", "weight": 1},
            {"type": "kv-load-scorer", "weight": 1},
            # QoS (docs/qos.md): both are inert (score 0) for requests
            # without an X-Kaito-Tenant / X-Kaito-Priority header
            {"type": "tenant-stickiness-scorer", "weight": 1},
            {"type": "priority-scorer", "weight": 1},
        ],
    }


class RequestCtx:
    """Everything scoring needs, parsed once per request."""

    __slots__ = ("blocks", "matched", "kv_source", "want_role", "steered",
                 "tenant", "priority", "pool_match", "adapter",
                 "adapter_residency", "session")

    def __init__(self):
        self.blocks: list[int] = []            # prompt prefix block hashes
        self.matched: dict[str, int] = {}      # url -> consecutive hits
        self.kv_source: str = ""               # kv_transfer.source_url
        self.want_role: str = ""               # "", "prefill", "decode"
        self.steered = False                   # PD locality won the pick
        self.tenant: str = ""                  # X-Kaito-Tenant (QoS)
        self.priority: str = ""                # X-Kaito-Priority class name
        self.session: str = ""                 # X-Kaito-Session conv id
        # cluster KV pool: url -> (entry key, matched pages, entry tokens)
        self.pool_match: dict[str, tuple] = {}
        self.adapter: str = ""                 # resolved LoRA adapter name
        # url -> residency score (1.0 HBM slot, 0.5 host tier)
        self.adapter_residency: dict[str, float] = {}


def _extract_prompt(body: Optional[bytes]) -> str:
    """Best-effort prompt text from an inference request body; any
    parse failure just means no affinity signal for this request."""
    if not body:
        return ""
    try:
        obj = json.loads(body)
    except (ValueError, UnicodeDecodeError):
        return ""
    # extraction shared with the engine-side KV-pool publisher so both
    # hash the SAME bytes (routing.extract_prompt_text)
    return extract_prompt_text(obj)


def _extract_kv_source(body: Optional[bytes]) -> str:
    if not body:
        return ""
    try:
        obj = json.loads(body)
    except (ValueError, UnicodeDecodeError):
        return ""
    if not isinstance(obj, dict):
        return ""
    kt = obj.get("kv_transfer")
    if isinstance(kt, dict):
        src = kt.get("source_url")
        if isinstance(src, str):
            return src.rstrip("/")
    return ""


class EndpointPicker(RoutingCore):
    """Scored candidate ordering over the shared routing transport."""

    def __init__(self, backends: list, *, block_chars: int = 0,
                 index_capacity: int = 65536,
                 plugins_config: Optional[dict] = None,
                 registry: Optional[Registry] = None,
                 draining: Optional[Iterable[str]] = None,
                 kv_pool: bool = False,
                 adapter_affinity: bool = False):
        # empty pools are legal here: a scaled-to-zero InferenceSet
        # keeps its EPP front alive so arrivals surface as
        # kaito:router_requests_received_total (the wake signal) while
        # clients get a retryable 503 instead of a dead DNS name
        super().__init__(backends, registry, allow_empty=True)
        for url in draining or ():
            self.set_draining(url)
        self._block_chars = block_chars        # 0 = auto from kv_page_size
        self.index = PrefixAffinityIndex(index_capacity)
        cfg = plugins_config or default_epp_plugins_config()
        self.plugins = [(p.get("type", ""), float(p.get("weight", 1)))
                        for p in cfg.get("plugins", [])
                        if isinstance(p, dict)]
        # cluster KV pool (docs/kv-pool.md): the index + scorer exist
        # only when enabled, so with the pool off the scoring math and
        # the /metrics exposition are byte-identical to before
        self.pool_index = KVPoolIndex() if kv_pool else None
        if kv_pool and not any(t == "kv-pool-scorer"
                               for t, _ in self.plugins):
            self.plugins.append(("kv-pool-scorer", POOL_WEIGHT))
        # multi-LoRA adapter affinity (docs/multi-lora.md): same
        # flag-gated discipline — with it off, no index, no scorer, no
        # metric families, byte-identical scoring and exposition
        self.adapter_index = AdapterIndex() if adapter_affinity else None
        if adapter_affinity and not any(t == "adapter-affinity-scorer"
                                        for t, _ in self.plugins):
            self.plugins.append(("adapter-affinity-scorer",
                                 ADAPTER_WEIGHT))
        r = self.registry
        self.m_picks = Counter(
            "kaito:epp_picks_total",
            "Requests the picker routed, per chosen backend", r,
            labels=("backend",))
        self.m_affinity_hits = Counter(
            "kaito:epp_affinity_hits_total",
            "Requests landed on a backend already holding prefix blocks",
            r)
        self.m_affinity_misses = Counter(
            "kaito:epp_affinity_misses_total",
            "Requests with prefix signal but no (usable) block owner", r)
        self.m_pd_steered = Counter(
            "kaito:epp_pd_steered_total",
            "Decode requests steered to the staged-KV owner or its group",
            r)
        Gauge("kaito:epp_backend_saturated",
              "Hysteresis saturation per backend (1 = affinity excluded)",
              r, labels=("backend",),
              fn=lambda: {(b.url,): float(b.saturated)
                          for b in self.backends})
        Gauge("kaito:epp_affinity_index_size",
              "Distinct prefix block hashes currently indexed", r,
              fn=lambda: float(len(self.index)))
        Gauge("kaito:epp_affinity_index_evictions",
              "Prefix block hashes evicted from the LRU index", r,
              fn=lambda: float(self.index.evictions))
        if kv_pool:
            self.m_pool_route = Counter(
                "kaito:epp_kv_pool_holder_routed_total",
                "Requests routed to a replica already holding the "
                "matched pool prefix", r)
            self.m_pool_fetch = Counter(
                "kaito:epp_kv_pool_fetch_hints_total",
                "Requests sent to a non-holder with an X-Kaito-KV-Fetch "
                "hint (cross-replica prefix fetch)", r)
            Gauge("kaito:epp_kv_pool_index_size",
                  "Distinct (block_chars, block hash) rows in the "
                  "cluster prefix->holder index", r,
                  fn=lambda: float(len(self.pool_index)))
            # session affinity (docs/routing.md "Session affinity"):
            # conversation-keyed pin so turn N lands on the replica
            # whose host/SSD KV tiers hold turn N-1's pages — gated
            # with the pool (no pool, no tiered KV worth pinning to)
            self.m_session_pin_routed = Counter(
                "kaito:epp_session_pin_routed_total",
                "Requests routed to their conversation's pinned holder "
                "(X-Kaito-Session)", r)
            self.m_session_pin_misses = Counter(
                "kaito:epp_session_pin_misses_total",
                "Session-tagged requests whose pinned holder was gone "
                "or unusable (fell back to prefix scoring)", r)
            Gauge("kaito:epp_session_pins",
                  "Conversations currently pinned to a holder", r,
                  fn=lambda: float(self.index.session_count()))
        if adapter_affinity:
            self.m_adapter_hits = Counter(
                "kaito:epp_adapter_affinity_hits_total",
                "Adapter requests routed to a replica already holding "
                "the adapter (HBM slot or host tier)", r)
            self.m_adapter_misses = Counter(
                "kaito:epp_adapter_affinity_misses_total",
                "Adapter requests with no resident replica (target must "
                "hot-load before serving)", r)
            Gauge("kaito:epp_adapter_index_size",
                  "Distinct adapter names advertised by the fleet", r,
                  fn=lambda: float(len(self.adapter_index)))

    # -- affinity block size ----------------------------------------------
    @property
    def block_chars(self) -> int:
        """Char-block size for prefix hashing: explicit override, else
        the engine's scraped ``kaito:kv_page_size`` (tokens) times the
        chars-per-token estimate, else the engine-default fallback —
        keeping affinity blocks aligned with what the radix tree can
        actually reuse."""
        if self._block_chars > 0:
            return self._block_chars
        pages = [b.load.page_size for b in self.backends
                 if b.load.page_size > 0]
        if pages:
            return int(max(pages)) * CHARS_PER_TOKEN
        return DEFAULT_BLOCK_CHARS

    # -- scoring -----------------------------------------------------------
    def make_ctx(self, method: str, path: str,
                 body: Optional[bytes], headers=None) -> RequestCtx:
        ctx = RequestCtx()
        if headers is not None:
            # the picker runs in its own pod with only the wire to go
            # on: headers are the QoS intake (body fields as fallback,
            # matching the engine server's contract)
            ctx.tenant = (headers.get("X-Kaito-Tenant") or "").strip()
            ctx.priority = (headers.get("X-Kaito-Priority") or "").strip()
            ctx.session = (headers.get("X-Kaito-Session") or "").strip()
        if method != "POST":
            return ctx
        if path.startswith("/pd/prefill"):
            ctx.want_role = "prefill"
        kv_source = _extract_kv_source(body)
        if kv_source:
            ctx.kv_source = kv_source
            ctx.want_role = ctx.want_role or "decode"
        if headers is not None:
            ctx.adapter = (headers.get("X-Kaito-Adapter") or "").strip()
        if not ctx.tenant or not ctx.priority or (
                not ctx.adapter and self.adapter_index is not None):
            try:
                obj = json.loads(body) if body else {}
            except (ValueError, UnicodeDecodeError):
                obj = {}
            if isinstance(obj, dict):
                ctx.tenant = ctx.tenant or str(obj.get("tenant") or "")
                ctx.priority = ctx.priority or str(obj.get("priority") or "")
                # the picker only trusts a "model" field as an adapter
                # selector when a scraped advert has named it: a scrape
                # race degrades to unseeded blocks (no affinity, no
                # pool match) — never a wrong route or a poisoned seed
                if not ctx.adapter and self.adapter_index is not None:
                    model = str(obj.get("model") or "")
                    if model and self.adapter_index.known(model):
                        ctx.adapter = model
        if ctx.adapter and self.adapter_index is not None:
            ctx.adapter_residency = self.adapter_index.residency(ctx.adapter)
        prompt = _extract_prompt(body)
        if prompt:
            # the adapter name seeds the hash chain exactly like the
            # engine's pool/prefix publishing does, so adapter traffic
            # never affinity-matches (or pool-fetches) base KV
            ctx.blocks = prefix_blocks(prompt, self.block_chars,
                                       seed=adapter_seed(ctx.adapter))
            if ctx.blocks:
                ctx.matched = self.index.match(ctx.blocks)
                if self.pool_index is not None:
                    ctx.pool_match = self.pool_index.match(
                        ctx.blocks, self.block_chars)
        return ctx

    def _filter_role(self, ctx: RequestCtx,
                     pool: list[Backend]) -> list[Backend]:
        """pd-filter: keep replicas whose role can serve this request.
        Unlabelled ("") and "both" backends always qualify; when no
        backend matches (homogeneous pool), the filter is a no-op."""
        if not ctx.want_role:
            return pool
        kept = [b for b in pool
                if b.role in ("", "both", ctx.want_role)]
        return kept or pool

    def _score(self, b: Backend, ctx: RequestCtx) -> float:
        """Weighted plugin-chain sum; each scorer yields [0, 1]."""
        total = 0.0
        for ptype, weight in self.plugins:
            if ptype == "prefix-affinity-scorer":
                # a saturated or breaker-tripped backend never earns
                # affinity — steering onto it would trade a cache hit
                # for queueing (or a connect failure)
                if ctx.blocks and not b.saturated and b.state == "closed":
                    total += weight * (ctx.matched.get(b.url, 0)
                                       / len(ctx.blocks))
            elif ptype == "kv-locality-scorer":
                if ctx.kv_source:
                    if b.url == ctx.kv_source:
                        # colocated decode: device-to-device handoff
                        total += weight
                    elif b.group and b.group == self._source_group(ctx):
                        total += weight * 0.5
            elif ptype == "kv-pool-scorer":
                # cluster-pool locality: a replica holding the matched
                # published prefix earns score proportional to how much
                # of the prompt it covers.  Saturated or breaker-open
                # holders earn nothing — they'd be routed to only for
                # the KV, trading a transfer for queueing; the non-
                # holder pick then gets a fetch hint instead
                # (request_headers), which is the route-vs-fetch split.
                if ctx.pool_match and not b.saturated \
                        and b.state == "closed":
                    info = ctx.pool_match.get(b.url)
                    if info is not None and ctx.blocks:
                        total += weight * min(1.0,
                                              info[1] / len(ctx.blocks))
            elif ptype == "adapter-affinity-scorer":
                # LoRA residency locality: a replica with the adapter in
                # an HBM slot scores 1.0 (instant dispatch), host tier
                # 0.5 (one fault-in away), elsewhere 0 (full hot-load).
                # Saturated/tripped replicas earn nothing, mirroring the
                # other affinity scorers.
                if ctx.adapter and ctx.adapter_residency \
                        and not b.saturated and b.state == "closed":
                    total += weight * ctx.adapter_residency.get(b.url, 0.0)
            elif ptype == "queue-depth-scorer":
                total += weight / (1.0 + b.load.waiting)
            elif ptype == "kv-load-scorer":
                total += weight * (1.0 - min(1.0, max(
                    b.load.kv_usage, b.load.occupancy)))
            elif ptype == "tenant-stickiness-scorer":
                # rendezvous hash of (tenant, backend): a tenant's
                # traffic concentrates on one healthy replica so its
                # prefix cache stays warm there — without a shared
                # index, and stable as the pool changes.  Saturated
                # replicas earn nothing (stickiness must not pile onto
                # a full backend).
                if ctx.tenant and not b.saturated and b.state == "closed":
                    h = _fnv1a(f"{ctx.tenant}|{b.url}".encode(), 0)
                    total += weight * (h / float(_MASK64))
            elif ptype == "priority-scorer":
                # high-priority traffic avoids loaded backends harder:
                # the rank scales the headroom term, so best-effort
                # ("" / rank 0) is indifferent while guaranteed traffic
                # strongly prefers the emptiest replica
                rank = priority_rank(ctx.priority)
                if rank > 0:
                    total += weight * rank * (1.0 - min(1.0, max(
                        b.load.occupancy, b.load.kv_usage)))
            # pd-filter participates as a filter, not a scorer;
            # unknown plugin types are ignored (forward compat)
        return total

    def request_headers(self, ctx, backend: Backend) -> dict:
        """Per-candidate steering (docs/kv-pool.md): when the picked
        replica is NOT a holder of the matched pool prefix, name the
        best live holder in ``X-Kaito-KV-Fetch`` so the replica can
        pull the prefix over the chunked PD wire instead of
        recomputing it.  The engine applies the final measured
        transfer-vs-recompute veto; the EPP only nominates — so a
        fresh scale-out replica (no measured rates yet) trusts the
        hint, which is exactly the cold-boot case the pool serves.
        Resolved per failover attempt: if the holder itself ends up
        picked, no hint is sent."""
        if not isinstance(ctx, RequestCtx) or not ctx.pool_match:
            return {}
        if backend.url in ctx.pool_match:
            return {}                  # routed to a holder: no fetch
        best_url, best = "", None
        for b in self.backends:
            info = ctx.pool_match.get(b.url)
            if info is None or not b.alive or b.state != "closed":
                continue               # dead holder: advert is stale
            if best is None or info[1] > best[1]:
                best_url, best = b.url, info
        if best is None:
            return {}
        return {"X-Kaito-KV-Fetch": best_url,
                "X-Kaito-KV-Fetch-Key": best[0]}

    def _source_group(self, ctx: RequestCtx) -> str:
        for b in self.backends:
            if b.url == ctx.kv_source:
                return b.group
        return ""

    def candidates(self, method: str, path: str,
                   ctx) -> Iterable[Backend]:
        """Alive candidates in descending score order, then draining
        backends (healthy but leaving the pool — 503-free last resort),
        then cooling-down backends (same never-0-candidates guarantee
        as the round-robin front)."""
        if not isinstance(ctx, RequestCtx):
            ctx = RequestCtx()
        pool = self._filter_role(ctx, list(self.backends))
        alive = [b for b in pool if b.alive and not b.draining]
        draining = [b for b in pool if b.alive and b.draining]
        dead = [b for b in pool if not b.alive]
        # stable sort: score ties fall back to least-loaded-first order;
        # replicas inside a 429 Retry-After window sort after every
        # non-demoted peer regardless of score (healthy but shedding)
        alive.sort(key=lambda b: (b.demoted, -self._score(b, ctx),
                                  b.load.waiting))
        # session pin (docs/routing.md "Session affinity"): a
        # conversation's turn N goes to the replica that served turn
        # N-1 — its HBM radix tree / host store / SSD tier hold the
        # history — ahead of prefix scoring.  A gone, saturated,
        # breaker-open, or shedding holder forfeits the pin and the
        # scored order stands (the holder's tiers are useless if the
        # request would just queue behind them).
        if ctx.session and self.pool_index is not None and alive:
            pinned = self.index.session_holder(ctx.session)
            if pinned:
                for i, b in enumerate(alive):
                    if (b.url == pinned and b.state == "closed"
                            and not b.saturated and not b.demoted):
                        alive.insert(0, alive.pop(i))
                        break
        for b in alive + draining + dead:
            with self._lock:
                b.served += 1
            yield b

    def note_response(self, backend: Backend, ctx,
                      status: int) -> None:
        """A response head arrived: account the pick and feed the
        affinity index (the chosen replica now holds this prefix)."""
        self.m_picks.inc(backend=backend.url)
        if not isinstance(ctx, RequestCtx):
            return
        if ctx.kv_source and not ctx.steered and (
                backend.url == ctx.kv_source
                or (backend.group
                    and backend.group == self._source_group(ctx))):
            ctx.steered = True         # count once per request
            self.m_pd_steered.inc()
        if ctx.pool_match and self.pool_index is not None:
            if backend.url in ctx.pool_match:
                self.m_pool_route.inc()
            elif self.request_headers(ctx, backend):
                self.m_pool_fetch.inc()
        if ctx.session and self.pool_index is not None:
            holder = self.index.session_holder(ctx.session)
            if holder == backend.url:
                self.m_session_pin_routed.inc()
            elif holder is not None:
                self.m_session_pin_misses.inc()
            # re-pin to whoever actually served the turn (first turn
            # creates the pin; a failover moves it) — never onto a
            # draining replica whose tiers are about to vanish
            if status < 500 and not backend.draining:
                self.index.record_session(ctx.session, backend.url)
        if ctx.adapter and self.adapter_index is not None:
            if ctx.adapter_residency.get(backend.url, 0.0) > 0:
                self.m_adapter_hits.inc()
            else:
                self.m_adapter_misses.inc()
        if ctx.blocks:
            if ctx.matched.get(backend.url, 0) > 0:
                self.m_affinity_hits.inc()
            else:
                self.m_affinity_misses.inc()
            # a draining replica's KV is about to be torn down: never
            # record fresh affinity that would steer prompts at a
            # backend scheduled for deletion
            if status < 500 and not backend.draining:
                self.index.record(ctx.blocks, backend.url)


def _parse_backend_arg(spec: str) -> Backend:
    """``url[=role[/group]]`` — e.g. ``http://p0:5000=prefill/g0``."""
    url, _, rolegroup = spec.partition("=")
    role, _, group = rolegroup.partition("/")
    return Backend(url, role=role, group=group)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kaito-tpu-epp")
    ap.add_argument("--backend", action="append", default=[],
                    help="backend spec url[=role[/group]] (repeat per "
                         "replica); role in {prefill,decode,both}; zero "
                         "backends = scaled-to-zero front (503 + wake "
                         "signal)")
    ap.add_argument("--drain-backend", action="append", default=[],
                    help="backend url currently draining for scale-down "
                         "(kept serving in-flight work, never scored for "
                         "new picks)")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--block-chars", type=int, default=0,
                    help="affinity block size in chars (0 = derive from "
                         "the scraped engine kv_page_size)")
    ap.add_argument("--index-capacity", type=int, default=65536,
                    help="max distinct prefix block hashes kept (LRU)")
    ap.add_argument("--plugins-config", default="",
                    help="plugin-chain JSON (inline, or @path to a file "
                         "— the InferencePool's eppPluginsConfig)")
    ap.add_argument("--health-probe-interval-s", type=float, default=2.0,
                    help="per-backend /health probe cadence (0 = off)")
    ap.add_argument("--scrape-interval-s", type=float, default=1.0,
                    help="per-backend /metrics load scrape cadence "
                         "(0 = off)")
    ap.add_argument("--drain-timeout-s", type=float, default=30.0,
                    help="SIGTERM grace: max seconds to finish in-flight "
                         "requests before exit")
    ap.add_argument("--kv-pool", action="store_true",
                    help="enable the cluster KV-pool index: scrape "
                         "/debug/kv_pool adverts, score holders, emit "
                         "X-Kaito-KV-Fetch hints (docs/kv-pool.md)")
    ap.add_argument("--kv-pool-scrape-interval-s", type=float, default=2.0,
                    help="per-backend /debug/kv_pool advert scrape "
                         "cadence (0 = off)")
    ap.add_argument("--adapter-affinity", action="store_true",
                    help="enable the multi-LoRA adapter-affinity index: "
                         "scrape /v1/adapters adverts, seed prefix "
                         "hashes per adapter, score resident replicas "
                         "(docs/multi-lora.md)")
    ap.add_argument("--adapter-scrape-interval-s", type=float, default=2.0,
                    help="per-backend /v1/adapters advert scrape "
                         "cadence (0 = off)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    plugins_config = None
    if args.plugins_config:
        raw = args.plugins_config
        if raw.startswith("@"):
            with open(raw[1:], encoding="utf-8") as f:
                raw = f.read()
        plugins_config = json.loads(raw)

    picker = EndpointPicker(
        [_parse_backend_arg(s) for s in args.backend],
        block_chars=args.block_chars,
        index_capacity=args.index_capacity,
        plugins_config=plugins_config,
        draining=args.drain_backend,
        kv_pool=args.kv_pool,
        adapter_affinity=args.adapter_affinity)
    srv = make_routing_server(picker, args.host, args.port,
                              probe_interval_s=args.health_probe_interval_s,
                              scrape_interval_s=args.scrape_interval_s)
    if args.kv_pool and args.kv_pool_scrape_interval_s > 0:
        pool_scraper = KVPoolScraper(picker, args.kv_pool_scrape_interval_s)
        pool_scraper.start()
        srv.pool_scraper = pool_scraper      # type: ignore[attr-defined]
    if args.adapter_affinity and args.adapter_scrape_interval_s > 0:
        a_scraper = AdapterScraper(picker, args.adapter_scrape_interval_s)
        a_scraper.start()
        srv.adapter_scraper = a_scraper      # type: ignore[attr-defined]

    def _term(signum, frame):
        logger.info("SIGTERM: draining %d in-flight request(s)",
                    picker.inflight)
        threading.Thread(target=lambda: (picker.drain(args.drain_timeout_s),
                                         srv.shutdown()),
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    logger.info("epp on :%d -> %s", srv.server_address[1],
                [b.url for b in picker.backends])
    srv.serve_forever()
    logger.info("epp exited cleanly")


if __name__ == "__main__":
    main()
