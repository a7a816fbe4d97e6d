"""Shared routing data path: transport + endpoint scoring.

ONE relay implementation serves both fronts of the replica tier
(docs/routing.md):

- ``kaito_tpu_torch.runtime.dp_router`` — the round-robin compatibility
  front (single-node DP deployments, tests, dryruns);
- ``kaito_tpu_torch.runtime.epp`` — the first-party endpoint picker the
  InferencePool's ``extensionRef`` resolves to, scoring replicas by
  prefix-hash affinity, live load, and the PD plugin chain.

The transport guts here are what used to live inside dp_router: the
per-backend circuit breaker (open/half-open/closed with exponential
cooldown), the ``/health`` prober, jittered idempotent retry across
replicas and cycles, byte-for-byte SSE relay, chunked-body handling,
SIGTERM drain, and X-Request-Id propagation.  A front chooses ONLY the
candidate order (``RoutingCore.candidates``); everything about how a
request reaches a replica is shared.

Scoring building blocks (used by the EPP, unit-testable alone):

- ``prefix_blocks``       — chained FNV-1a hashes over fixed-size
  prompt blocks, the wire-level analogue of the engine's radix-tree
  page hashing (``native/src/prefix_cache.cc``); the block size is
  aligned to the engine's KV page size so an affinity hit lands where
  cached KV actually lives.
- ``PrefixAffinityIndex`` — bounded LRU of recent block hashes per
  backend (the hash ring the picker consults).
- ``BackendLoad`` scraping — ``kaito:batch_occupancy``, queue depth
  and KV utilization from each replica's ``/metrics``.
- ``update_saturation``   — hysteresis: a replica enters saturation at
  the high watermarks and only leaves below the low ones, so affinity
  never flaps onto a barely-recovered backend.

The port's own copy of ``kaito_tpu/runtime/routing.py`` (imports
changed).  The prefix helpers (``prefix_blocks``, ``adapter_seed``,
``extract_prompt_text``) are also what the engine's KV-pool publisher
and the server hash with (``engine/kv_pool.py``, ``engine/server.py``):
both sides must hash the same bytes the same way, bit for bit, or the
cluster index never matches.  ``parse_load_metrics`` reads the port
server's own families (``engine/metrics.py``).
"""

from __future__ import annotations

import http.client
import json
import logging
import random
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterable, Optional

from kaito_tpu_torch.engine.metrics import Counter, Gauge, Histogram, Registry
from kaito_tpu_torch.utils.failpoints import FAILPOINTS, FailpointError
from kaito_tpu_torch.utils.tracing import (make_request_id, parse_traceparent,
                                           sanitize_request_id)

logger = logging.getLogger(__name__)

DOWN_COOLDOWN_S = 5.0
DOWN_COOLDOWN_MAX_S = 60.0
BREAKER_THRESHOLD = 3          # consecutive failures that OPEN the breaker
RETRY_CYCLES = 2               # full passes over the backend list
RETRY_BACKOFF_S = 0.1          # jittered sleep between cycles
HOP_HEADERS = {"connection", "keep-alive", "transfer-encoding",
               "te", "trailer", "upgrade", "proxy-authorization"}
# POST routes that are safe to replay against another replica before any
# response byte: stateless inference (any replica computes the same
# answer).  PD side-channel routes mutate per-replica staging state and
# must NOT fail over blindly.
IDEMPOTENT_POST_PREFIXES = ("/v1/completions", "/v1/chat/completions",
                            "/v1/embeddings", "/score", "/tokenize",
                            "/detokenize")

_BREAKER_STATES = {"closed": 0, "half-open": 1, "open": 2}

# hysteresis watermarks: enter saturation at *_HI, leave below *_LO
SAT_OCCUPANCY_HI = 0.90
SAT_OCCUPANCY_LO = 0.70
SAT_KV_HI = 0.90
SAT_KV_LO = 0.75
SAT_QUEUE_HI = 8
SAT_QUEUE_LO = 2


class BackendLoad:
    """Last-scraped load snapshot for one replica (all floats so a
    missing series degrades to 0 rather than None-poisoning scores)."""

    __slots__ = ("occupancy", "waiting", "kv_usage", "page_size", "ts")

    def __init__(self):
        self.occupancy = 0.0       # kaito:batch_occupancy
        self.waiting = 0.0         # kaito:num_requests_waiting
        self.kv_usage = 0.0        # kaito:kv_cache_usage_perc
        self.page_size = 0.0       # kaito:kv_page_size (tokens)
        self.ts = 0.0              # monotonic scrape time (0 = never)


class Backend:
    """One replica plus its circuit-breaker state.

    ``down_until`` stays THE open-until timestamp (tests poke it to
    heal a backend); ``failures`` counts CONSECUTIVE connect failures.
    State is derived, never stored:

    - ``open``      — cooling down (``down_until`` in the future)
    - ``half-open`` — cooldown lapsed but the breaker tripped and no
      success has closed it yet (the next request is the probe)
    - ``closed``    — healthy
    """

    def __init__(self, url: str, role: str = "", group: str = ""):
        url = url.rstrip("/")
        assert url.startswith("http://"), f"http backends only: {url}"
        self.url = url
        hostport = url[len("http://"):]
        self.host, _, port = hostport.partition(":")
        self.port = int(port or 80)
        self.role = role           # "" | "prefill" | "decode" | "both"
        self.group = group         # replica group for PD KV locality
        self.down_until = 0.0
        # 429 advisory window (Retry-After): the replica is healthy but
        # FULL — no breaker trip, just deprioritized for new picks
        self.avoid_until = 0.0
        self.served = 0
        self.failures = 0
        self.load = BackendLoad()
        self.saturated = False     # hysteresis state (update_saturation)
        # scale-down drain (autoscaler): a draining backend keeps
        # serving its in-flight work but stops attracting new picks —
        # fronts order it after every healthy peer, never 503 it
        self.draining = False

    @property
    def alive(self) -> bool:
        return time.monotonic() >= self.down_until

    @property
    def demoted(self) -> bool:
        """Inside a 429 Retry-After advisory window: last-resort only."""
        return time.monotonic() < self.avoid_until

    def demote(self, seconds: float) -> None:
        """A 429 with Retry-After: honor the advisory window without
        touching the breaker (the replica is alive, just shedding)."""
        self.avoid_until = max(self.avoid_until,
                               time.monotonic() + max(0.0, seconds))

    @property
    def state(self) -> str:
        if not self.alive:
            return "open"
        if self.failures >= BREAKER_THRESHOLD:
            return "half-open"
        return "closed"

    def mark_down(self) -> None:
        """One more consecutive failure: cool down with exponential
        backoff (capped) so a dead replica is probed ever less often
        while it stays dead."""
        self.failures += 1
        backoff = min(DOWN_COOLDOWN_S * (2 ** max(0, self.failures
                                                  - BREAKER_THRESHOLD)),
                      DOWN_COOLDOWN_MAX_S)
        self.down_until = time.monotonic() + backoff

    def mark_up(self) -> None:
        """A success (request or health probe) closes the breaker."""
        self.failures = 0
        self.down_until = 0.0


def update_saturation(b: Backend,
                      occ_hi: float = SAT_OCCUPANCY_HI,
                      occ_lo: float = SAT_OCCUPANCY_LO,
                      kv_hi: float = SAT_KV_HI,
                      kv_lo: float = SAT_KV_LO,
                      q_hi: float = SAT_QUEUE_HI,
                      q_lo: float = SAT_QUEUE_LO) -> bool:
    """Hysteresis band around the saturation decision: a backend that
    crossed a high watermark keeps rejecting affinity steering until it
    falls below EVERY low watermark — without the band, a replica
    hovering at the threshold would flap in and out of eligibility on
    every scrape."""
    ld = b.load
    if b.saturated:
        if (ld.occupancy <= occ_lo and ld.kv_usage <= kv_lo
                and ld.waiting <= q_lo):
            b.saturated = False
    else:
        if (ld.occupancy >= occ_hi or ld.kv_usage >= kv_hi
                or ld.waiting >= q_hi):
            b.saturated = True
    return b.saturated


# ---------------------------------------------------------------------------
# prefix-hash affinity
# ---------------------------------------------------------------------------

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def _fnv1a(data: bytes, seed: int) -> int:
    h = (_FNV_OFFSET ^ seed) & _MASK64
    for byte in data:
        h = ((h ^ byte) * _FNV_PRIME) & _MASK64
    return h


def adapter_seed(adapter: str) -> int:
    """Chain seed folding a LoRA adapter name into the block hashes: KV
    computed under adapter deltas must never hash-match base KV (or
    another adapter's) for the same text.  "" (the base) is seed 0."""
    return _fnv1a(adapter.encode("utf-8", "replace"), 0) if adapter else 0


def prefix_blocks(text: str, block_chars: int, seed: int = 0) -> list[int]:
    """Chained block hashes of a prompt prefix: block i's hash folds in
    block i-1's, so equal blocks at different depths hash differently.
    A trailing partial block is dropped (only whole KV pages are ever
    reused).  ``seed`` namespaces the whole chain (``adapter_seed``)."""
    if block_chars <= 0:
        return []
    data = text.encode("utf-8", "replace")
    out: list[int] = []
    parent = seed & _MASK64
    for i in range(len(data) // block_chars):
        parent = _fnv1a(data[i * block_chars:(i + 1) * block_chars], parent)
        out.append(parent)
    return out


def extract_prompt_text(obj) -> str:
    """The prompt string the hashes are taken over, from a parsed request
    body: ``prompt``, else the ``messages`` with their role markers (so
    the same content under another role maps to other blocks)."""
    if not isinstance(obj, dict):
        return ""
    prompt = obj.get("prompt")
    if isinstance(prompt, str):
        return prompt
    msgs = obj.get("messages")
    if isinstance(msgs, list):
        return "".join(f"<{m.get('role', '')}>{m.get('content', '')}"
                       for m in msgs if isinstance(m, dict))
    return ""


class PrefixAffinityIndex:
    """Bounded LRU of recent prompt-prefix block hashes per backend.

    ``record`` notes that a backend just served (and therefore now
    holds KV for) a chain of blocks; ``match`` returns, per backend,
    how many LEADING blocks of a new prompt that backend has seen.
    Capacity bounds total distinct block hashes; eviction is LRU so a
    hot shared prefix never ages out while it keeps hitting."""

    def __init__(self, capacity: int = 65536,
                 session_capacity: int = 16384):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.session_capacity = session_capacity
        self.evictions = 0
        self._lock = threading.Lock()
        # block hash -> {backend_url: last_touch} (insertion order = LRU)
        self._map: OrderedDict[int, dict[str, float]] = OrderedDict()
        # session id -> backend url (insertion order = LRU): the
        # conversation-keyed pin (docs/routing.md "Session affinity").
        # Turn N of a conversation routes to the replica that served
        # turn N-1 — whose host/SSD KV tiers hold the history — before
        # prefix scoring gets a say; a dead/removed holder falls back
        # to normal scoring via drop_backend.
        self._sessions: OrderedDict[str, str] = OrderedDict()

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def record(self, blocks: Iterable[int], backend_url: str) -> None:
        now = time.monotonic()
        with self._lock:
            for h in blocks:
                owners = self._map.get(h)
                if owners is None:
                    owners = self._map[h] = {}
                else:
                    self._map.move_to_end(h)
                owners[backend_url] = now
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)
                self.evictions += 1

    def match(self, blocks: list[int]) -> dict[str, int]:
        """backend url -> number of consecutive leading blocks it
        holds.  Only unbroken runs count: a backend missing block k
        cannot serve block k+1 from cache (the engine's radix tree
        stops at the first divergence)."""
        out: dict[str, int] = {}
        alive: Optional[set] = None
        with self._lock:
            for h in blocks:
                owners = self._map.get(h)
                if not owners:
                    break
                self._map.move_to_end(h)
                here = set(owners)
                alive = here if alive is None else (alive & here)
                if not alive:
                    break
                for url in alive:
                    out[url] = out.get(url, 0) + 1
        return out

    def record_session(self, session: str, backend_url: str) -> None:
        """Pin a conversation to the replica that just served it."""
        if not session:
            return
        with self._lock:
            self._sessions[session] = backend_url
            self._sessions.move_to_end(session)
            while len(self._sessions) > self.session_capacity:
                self._sessions.popitem(last=False)

    def session_holder(self, session: str) -> Optional[str]:
        """The pinned holder url for a conversation, or None."""
        if not session:
            return None
        with self._lock:
            url = self._sessions.get(session)
            if url is not None:
                self._sessions.move_to_end(session)
            return url

    def session_count(self) -> int:
        with self._lock:
            return len(self._sessions)

    def drop_backend(self, backend_url: str) -> None:
        """Forget a replica (removed from the pool / restarted — its
        KV cache is gone, affinity to it is stale)."""
        with self._lock:
            empty = []
            for h, owners in self._map.items():
                owners.pop(backend_url, None)
                if not owners:
                    empty.append(h)
            for h in empty:
                del self._map[h]
            stale = [s for s, url in self._sessions.items()
                     if url == backend_url]
            for s in stale:
                del self._sessions[s]


# ---------------------------------------------------------------------------
# /metrics scraping
# ---------------------------------------------------------------------------

_LOAD_SERIES = {
    "kaito:batch_occupancy": "occupancy",
    "kaito:num_requests_waiting": "waiting",
    "kaito:kv_cache_usage_perc": "kv_usage",
    "kaito:kv_page_size": "page_size",
}


def parse_load_metrics(text: str) -> dict[str, float]:
    """Pull the routing-relevant gauges out of an exposition payload.
    Labelled series of the same family (DP groups) are summed for
    counters-like values and averaged for the utilization gauges —
    close enough for scoring, and robust to either shape."""
    sums: dict[str, list[float]] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name = line.split("{", 1)[0].split(" ", 1)[0]
        key = _LOAD_SERIES.get(name)
        if key is None:
            continue
        try:
            value = float(line.rsplit(" ", 1)[1])
        except (ValueError, IndexError):
            continue
        sums.setdefault(key, []).append(value)
    out: dict[str, float] = {}
    for key, vals in sums.items():
        if key == "waiting":
            out[key] = sum(vals)
        else:
            out[key] = sum(vals) / len(vals)
    return out


# fields the load parser may populate; anything else the parser ever
# returns is dropped instead of setattr-poked into the snapshot
_LOAD_FIELDS = frozenset(s for s in BackendLoad.__slots__ if s != "ts")
# a scrape missing any of these is PARTIAL (truncated payload, wrong
# process behind the port): keep the old snapshot and its stale ts
_LOAD_REQUIRED = ("occupancy", "waiting", "kv_usage")


def scrape_backend_load(b: Backend, timeout: float = 5.0) -> bool:
    """GET one replica's /metrics and fold the load gauges into
    ``b.load`` + its hysteresis state.  Returns False (and leaves the
    old snapshot in place, stale ts included) when the replica is
    unreachable or the payload is missing the core load series.

    The new snapshot is built aside and swapped in whole, so a
    concurrent scorer never reads a half-updated mix of old and new
    gauges stamped with a fresh ``ts``."""
    try:
        conn = http.client.HTTPConnection(b.host, b.port, timeout=timeout)
        try:
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            if resp.status != 200:
                return False
            vals = parse_load_metrics(resp.read().decode("utf-8", "replace"))
        finally:
            conn.close()
    except (ConnectionError, OSError):
        return False
    if any(k not in vals for k in _LOAD_REQUIRED):
        return False
    fresh = BackendLoad()
    fresh.page_size = b.load.page_size      # optional series: carry over
    for key, v in vals.items():
        if key in _LOAD_FIELDS:
            setattr(fresh, key, v)
    fresh.ts = time.monotonic()
    b.load = fresh
    update_saturation(b)
    return True


class _BackendPoller(threading.Thread):
    """Shared loop shape for the background scraper/prober: the first
    pass runs IMMEDIATELY (not after the first interval sleep), every
    pass polls the backends CONCURRENTLY, and a per-backend in-flight
    guard skips a backend whose previous poll has not returned yet — so
    one hung-but-alive replica degrades only its own freshness, never
    the cadence of the others (the old serial loop let a single 5 s
    timeout starve every backend behind it)."""

    def __init__(self, name: str, interval_s: float):
        super().__init__(daemon=True, name=name)
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._inflight: set[int] = set()
        self._guard = threading.Lock()

    def stop(self) -> None:
        self._stop.set()

    def targets(self) -> Iterable[Backend]:
        raise NotImplementedError

    def poll_one(self, b: Backend) -> None:
        raise NotImplementedError

    def poll_pass(self) -> None:
        for b in self.targets():
            with self._guard:
                if id(b) in self._inflight:
                    continue            # previous poll still hanging
                self._inflight.add(id(b))
            threading.Thread(target=self._poll_guarded, args=(b,),
                             daemon=True, name=f"{self.name}-worker").start()

    def _poll_guarded(self, b: Backend) -> None:
        try:
            self.poll_one(b)
        except Exception:
            logger.debug("%s: poll of %s failed", self.name, b.url,
                         exc_info=True)
        finally:
            with self._guard:
                self._inflight.discard(id(b))

    def run(self) -> None:
        self.poll_pass()                # first pass now, not at t+interval
        while not self._stop.wait(self.interval_s):
            self.poll_pass()


class MetricsScraper(_BackendPoller):
    """Background load scraper: keeps every backend's ``load`` snapshot
    fresh so scoring never blocks a request on a network round trip."""

    def __init__(self, core: "RoutingCore", interval_s: float = 1.0,
                 timeout_s: float = 2.0):
        super().__init__("routing-metrics-scraper", interval_s)
        self.core = core
        self.timeout_s = timeout_s

    def targets(self) -> Iterable[Backend]:
        return [b for b in self.core.backends if b.alive]

    def poll_one(self, b: Backend) -> None:
        scrape_backend_load(b, timeout=self.timeout_s)


class HealthProber(_BackendPoller):
    """Background ``/health`` probe per backend: closes breakers as
    replicas recover, opens them when a live-looking backend refuses
    the probe — without spending client requests on discovery."""

    def __init__(self, router: "RoutingCore", interval_s: float = 2.0,
                 timeout_s: float = 5.0):
        super().__init__("dp-health-prober", interval_s)
        self.router = router
        self.timeout_s = timeout_s

    def targets(self) -> Iterable[Backend]:
        return list(self.router.backends)

    def poll_one(self, b: Backend) -> None:
        try:
            conn = http.client.HTTPConnection(b.host, b.port,
                                              timeout=self.timeout_s)
            try:
                conn.request("GET", "/health")
                resp = conn.getresponse()
                # read the body before closing: an unread reply makes the
                # close a reset, which the replica's server logs
                resp.read()
                ok = resp.status == 200
            finally:
                conn.close()
        except (ConnectionError, OSError):
            ok = False
        if ok:
            if b.failures:
                logger.info("health probe: %s recovered", b.url)
            b.mark_up()
        elif b.alive:
            b.mark_down()


def _retryable(method: str, path: str) -> bool:
    """May this request be replayed against another replica (before any
    response byte)?  GET/DELETE always; POST only on the stateless
    inference routes."""
    if method in ("GET", "DELETE", "HEAD"):
        return True
    if method == "POST":
        return any(path.startswith(p) for p in IDEMPOTENT_POST_PREFIXES)
    return False


# ---------------------------------------------------------------------------
# routing core: backends + breaker + drain + transport metrics
# ---------------------------------------------------------------------------

class RoutingCore:
    """Everything a routing front shares: the backend list, breaker
    bookkeeping, drain state, and the relay-tier metric families.
    Fronts override ``candidates`` (the ordering policy) and optionally
    ``make_ctx`` / ``note_response`` / ``handle_local``."""

    def __init__(self, backends: list, registry: Optional[Registry] = None,
                 allow_empty: bool = False):
        if not backends and not allow_empty:
            raise ValueError("router needs at least one backend")
        self.backends = [b if isinstance(b, Backend) else Backend(b)
                         for b in backends]
        self._rr = 0
        self._lock = threading.Lock()
        self.draining = False
        self._inflight = 0
        # the relay tier's OWN /metrics (docs/observability.md): the
        # engine replicas each expose theirs; these cover the transport
        r = registry if registry is not None else Registry()
        self.registry = r
        self.m_received = Counter(
            "kaito:router_requests_received_total",
            "Relayable requests accepted by this front (scale-to-zero "
            "wake signal: arrivals exist even with zero backends)", r)
        self.m_forwarded = Counter(
            "kaito:router_requests_forwarded_total",
            "Requests relayed to a backend (response head received)",
            r, labels=("backend",))
        self.m_retries = Counter(
            "kaito:router_retries_total",
            "Relay attempts beyond each request's first", r,
            labels=("backend",))
        self.m_failures = Counter(
            "kaito:router_backend_failures_total",
            "Connect/forward failures that skipped a backend", r,
            labels=("backend",))
        self.m_rate_limited = Counter(
            "kaito:router_backend_rate_limited_total",
            "429 responses that demoted a backend for its Retry-After "
            "window (request failed over, breaker untouched)", r,
            labels=("backend",))
        self.upstream_latency = Histogram(
            "kaito:router_upstream_latency_seconds",
            "Forward-to-response-head latency per backend", r,
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0),
            labels=("backend",))
        # breaker state is time-derived (down_until vs now), so the
        # family is computed at scrape time via the labelled-fn Gauge
        Gauge("kaito:router_backend_breaker_state",
              "Circuit breaker per backend (0=closed, 1=half-open, 2=open)",
              r, labels=("backend",),
              fn=lambda: {(b.url,): _BREAKER_STATES[b.state]
                          for b in self.backends})
        Gauge("kaito:router_backend_draining",
              "Scale-down drain state per backend (1 = not scored)",
              r, labels=("backend",),
              fn=lambda: {(b.url,): float(b.draining)
                          for b in self.backends})

    # -- selection policy --------------------------------------------------
    def next_backend(self) -> Optional[Backend]:
        """Next live non-draining non-demoted backend (round robin);
        replicas inside a 429 Retry-After window come next (they are
        healthy, just shedding), draining backends are last-resort only
        (they still serve correctly — better that than a 503 — but new
        work prefers survivors), and if every backend is cooling down,
        the next one regardless (better a refused retry than a
        guaranteed 503 when all marks are stale)."""
        with self._lock:
            n = len(self.backends)
            if n == 0:
                return None
            for offset in range(n):
                b = self.backends[(self._rr + offset) % n]
                if b.alive and not b.draining and not b.demoted:
                    self._rr = (self._rr + offset + 1) % n
                    b.served += 1
                    return b
            for offset in range(n):
                b = self.backends[(self._rr + offset) % n]
                if b.alive and not b.draining:
                    self._rr = (self._rr + offset + 1) % n
                    b.served += 1
                    return b
            for offset in range(n):
                b = self.backends[(self._rr + offset) % n]
                if b.alive:
                    self._rr = (self._rr + offset + 1) % n
                    b.served += 1
                    return b
            b = self.backends[self._rr % n]
            self._rr = (self._rr + 1) % n
            b.served += 1
            return b

    def set_draining(self, url: str, draining: bool = True) -> bool:
        """Flip one backend's drain state (autoscaler scale-down:
        mark, let in-flight finish, then remove).  Returns False when
        no backend matches the url."""
        url = url.rstrip("/")
        found = False
        for b in self.backends:
            if b.url == url:
                b.draining = draining
                found = True
        return found

    def make_ctx(self, method: str, path: str,
                 body: Optional[bytes], headers=None):
        """Parse whatever the front's scoring needs out of the request
        (``headers`` carries the QoS tenant/priority intake).  The base
        (round-robin) front needs nothing."""
        return None

    def request_headers(self, ctx, backend: "Backend") -> dict:
        """Extra headers to inject into the forwarded request, resolved
        per CANDIDATE backend (the EPP's KV-pool front steers a picked
        replica to fetch a prefix from its holder via
        ``X-Kaito-KV-Fetch``).  The base front injects nothing."""
        return {}

    def candidates(self, method: str, path: str, ctx) -> Iterable[Backend]:
        """One preference-ordered pass over the replicas for one retry
        cycle.  The default is the classic round robin."""
        for _ in range(len(self.backends)):
            b = self.next_backend()
            if b is not None:
                yield b

    def note_response(self, backend: Backend, ctx, status: int) -> None:
        """A response head arrived from ``backend`` (any status)."""

    def handle_local(self, path: str, method: str = "GET"):
        """Locally-answered routes (never forwarded).  Returns
        ``(status, content_type, body_bytes)`` or None to relay."""
        if path == "/router/stats":
            body = json.dumps(self.stats()).encode()
            return 200, "application/json", body
        if path == "/metrics" and method == "GET":
            # the front's OWN series, never forwarded: per-backend
            # forwards/retries/failures, breaker state, latency
            return (200, "text/plain; version=0.0.4",
                    self.registry.expose().encode())
        return None

    def stats(self) -> dict:
        with self._lock:
            return {b.url: {"served": b.served, "alive": b.alive,
                            "state": b.state, "failures": b.failures,
                            "draining": b.draining}
                    for b in self.backends}

    # -- drain bookkeeping -------------------------------------------------
    def begin_request(self) -> bool:
        """Admission gate: False while draining (caller answers 503)."""
        with self._lock:
            if self.draining:
                return False
            self._inflight += 1
            return True

    def end_request(self) -> None:
        with self._lock:
            self._inflight -= 1

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop accepting, wait for in-flight relays to finish.  Returns
        True when the router went quiet inside the timeout."""
        with self._lock:
            self.draining = True
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.inflight == 0:
                return True
            time.sleep(0.05)
        return self.inflight == 0


# ---------------------------------------------------------------------------
# the relay server (shared verbatim by every front)
# ---------------------------------------------------------------------------

def make_routing_server(core: RoutingCore, host: str = "0.0.0.0",
                        port: int = 0, probe_interval_s: float = 0.0,
                        scrape_interval_s: float = 0.0
                        ) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _send_json(self, code: int, obj: dict,
                       headers: Optional[dict] = None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            rid = getattr(self, "_rid", None)
            if rid:
                self.send_header("X-Request-Id", rid)
            for k, v in (headers or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(body)

        def _read_request_body(self) -> Optional[bytes]:
            """Read the client body whichever way it was framed.  A
            ``Transfer-Encoding: chunked`` body is DE-CHUNKED here and
            forwarded with Content-Length (http.client sets it), so a
            chunked client upload is no longer silently dropped."""
            te = (self.headers.get("Transfer-Encoding") or "").lower()
            if "chunked" in te:
                chunks = []
                while True:
                    size_line = self.rfile.readline(65536).strip()
                    size = int(size_line.split(b";")[0] or b"0", 16)
                    if size == 0:
                        # consume trailers until the blank line
                        while self.rfile.readline(65536).strip():
                            pass
                        break
                    chunks.append(self.rfile.read(size))
                    self.rfile.read(2)          # CRLF after each chunk
                return b"".join(chunks)
            length = int(self.headers.get("Content-Length") or 0)
            return self.rfile.read(length) if length else None

        def _relay(self, method: str):
            # end-to-end tracing: accept the caller's X-Request-Id (or
            # a W3C traceparent), mint one otherwise, and forward it so
            # router + engine logs/spans correlate on one id.
            self._rid = (sanitize_request_id(self.headers.get("X-Request-Id"))
                         or parse_traceparent(self.headers.get("traceparent"))
                         or make_request_id())
            local = core.handle_local(self.path, method)
            if local is not None:
                status, ctype, body = local
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if not core.begin_request():
                self._send_json(503, {"error": "router draining"},
                                headers={"Retry-After": 1})
                return
            core.m_received.inc()
            try:
                self._relay_inner(method)
            finally:
                core.end_request()

        def _relay_inner(self, method: str):
            try:
                body = self._read_request_body()
            except (ValueError, ConnectionError, OSError):
                self._send_json(400, {"error": "malformed request body"})
                return
            # failover is only safe BEFORE the first response byte: a
            # backend that dies mid-stream cannot be retried without
            # corrupting the client's half-written reply (and without
            # re-running the inference) — abort the connection instead.
            # Retryable requests get RETRY_CYCLES full passes over the
            # candidate order with a jittered backoff between passes;
            # one-shot (non-idempotent) requests get a single pass.
            ctx = core.make_ctx(method, self.path, body,
                                headers=self.headers)
            retryable = _retryable(method, self.path)
            cycles = RETRY_CYCLES if retryable else 1
            last_status: Optional[int] = None
            attempts = 0
            for cycle in range(cycles):
                if cycle:
                    time.sleep(RETRY_BACKOFF_S * (1 + random.random()))
                remaining = len(core.backends)
                for b in core.candidates(method, self.path, ctx):
                    remaining -= 1
                    attempts += 1
                    if attempts > 1:
                        core.m_retries.inc(backend=b.url)
                    t_fwd = time.monotonic()
                    try:
                        resp, conn = self._connect(b, method, body, ctx)
                    except (ConnectionError, OSError, FailpointError) as e:
                        logger.warning("backend %s unreachable (%s); "
                                       "skipping", b.url, e)
                        core.m_failures.inc(backend=b.url)
                        b.mark_down()
                        continue
                    core.upstream_latency.observe(
                        time.monotonic() - t_fwd, backend=b.url)
                    if retryable and resp.status in (502, 503) \
                            and (cycle + 1 < cycles or remaining > 0):
                        # the replica answered but cannot serve (loading
                        # stub, drain, overload): try elsewhere.  The
                        # breaker does NOT trip — the process is alive.
                        last_status = resp.status
                        conn.close()
                        continue
                    if retryable and resp.status == 429 \
                            and (cycle + 1 < cycles or remaining > 0):
                        # shedding replica: honor its Retry-After as a
                        # demotion window (healthy-but-full, no breaker
                        # trip) and fail over to the next candidate NOW
                        # — a shed request should move, not die
                        try:
                            ra = min(60.0, max(
                                1.0, float(resp.getheader("Retry-After")
                                           or 1)))
                        except (TypeError, ValueError):
                            ra = 1.0
                        b.demote(ra)
                        core.m_rate_limited.inc(backend=b.url)
                        last_status = resp.status
                        conn.close()
                        continue
                    b.mark_up()
                    core.m_forwarded.inc(backend=b.url)
                    core.note_response(b, ctx, resp.status)
                    self._stream_response(b, method, resp, conn)
                    return
            self._send_json(503 if last_status is None else last_status,
                            {"error": "no live backend"},
                            headers={"Retry-After": 1})

        def _connect(self, b: Backend, method: str,
                     body: Optional[bytes], ctx=None):
            """Send the request and read the response HEAD; raises are
            retryable (nothing has reached the client yet)."""
            FAILPOINTS.fire("router.forward", backend=b.url)
            conn = http.client.HTTPConnection(b.host, b.port, timeout=600)
            headers = {k: v for k, v in self.headers.items()
                       if k.lower() not in HOP_HEADERS
                       and k.lower() not in ("content-length",
                                             "x-request-id")}
            headers["X-Request-Id"] = self._rid
            # per-candidate steering headers from the front (e.g. the
            # EPP's KV-pool fetch hint) — resolved HERE because the
            # chosen backend differs per failover attempt
            headers.update(core.request_headers(ctx, b) or {})
            conn.request(method, self.path, body=body, headers=headers)
            return conn.getresponse(), conn

        def _stream_response(self, b: Backend, method: str, resp,
                             conn) -> None:
            """Relay an already-open backend response.  A BACKEND read
            failure marks it down and aborts the client connection (no
            retry — bytes are already out); a CLIENT write failure just
            ends the relay (the backend is healthy)."""
            try:
                self.send_response(resp.status)
                for k, v in resp.getheaders():
                    if k.lower() not in HOP_HEADERS:
                        self.send_header(k, v)
                # 1xx/204/304 (and HEAD replies) carry NO body by spec:
                # chunked framing (or a terminator) after their headers
                # would corrupt the connection for the next request
                bodyless = (resp.status < 200 or resp.status in (204, 304)
                            or method == "HEAD")
                has_len = resp.getheader("Content-Length") is not None
                if not has_len and not bodyless:
                    # stream of unknown length (SSE): relay chunked
                    self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                if bodyless:
                    return
                # relay bytes AS THEY ARRIVE so SSE tokens stream through
                while True:
                    try:
                        chunk = resp.read1(65536) if hasattr(resp, "read1") \
                            else resp.read(65536)
                    except (ConnectionError, OSError) as e:
                        logger.warning("backend %s died mid-stream (%s); "
                                       "aborting relay", b.url, e)
                        b.mark_down()
                        self.close_connection = True
                        return
                    if not chunk:
                        break
                    try:
                        if has_len:
                            self.wfile.write(chunk)
                        else:
                            self.wfile.write(
                                b"%x\r\n%s\r\n" % (len(chunk), chunk))
                        self.wfile.flush()
                    except (ConnectionError, OSError):
                        # client went away: backend stays healthy
                        self.close_connection = True
                        return
                if not has_len:
                    try:
                        self.wfile.write(b"0\r\n\r\n")
                    except (ConnectionError, OSError):
                        self.close_connection = True
            finally:
                conn.close()

        def do_GET(self):
            self._relay("GET")

        def do_POST(self):
            self._relay("POST")

        def do_DELETE(self):
            self._relay("DELETE")

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.router = core                        # type: ignore[attr-defined]
    if probe_interval_s > 0:
        prober = HealthProber(core, probe_interval_s)
        prober.start()
        srv.prober = prober                  # type: ignore[attr-defined]
    if scrape_interval_s > 0:
        scraper = MetricsScraper(core, scrape_interval_s)
        scraper.start()
        srv.scraper = scraper                # type: ignore[attr-defined]
    return srv
