"""Fleet telemetry plane: cross-replica aggregation + scaling signals.

The control-plane half of the observability story (docs/observability
.md "Fleet"): every engine replica already exposes ``/metrics`` and
``/debug/slo``, every routing front exposes ``kaito:router_*`` /
``kaito:epp_*`` — but each of those is a per-process, point-in-time
view.  ``FleetTelemetry`` lifts them to per-CR rolling signals:

1. **Discovery** — scrape targets come from the KubeStore: each
   InferenceSet's child Workspaces (one replica Service each) plus the
   set's EPP Service, and standalone Workspaces as single-replica CRs
   of their own.  A ``kaito-tpu.io/scrape-url`` annotation (Workspace
   or Service) overrides the DNS-form URL — dev loops and tests point
   it at loopback ports.

2. **Scrape** — each target is polled on a staggered schedule (phase
   derived from the URL hash so N replicas never thundering-herd one
   instant) with a per-target deadline, CONCURRENTLY, with an
   in-flight guard per target: a hung-but-alive replica degrades only
   its own freshness, never the cadence of its siblings.  Parsing
   reuses the strict exposition parser (``utils/promtext``)
   and the ``parse_load_metrics`` pattern from ``runtime/routing``.

3. **Fold** — per scrape round, fresh replica samples collapse into
   per-CR aggregates (sum/mean/p95 + ``replicas_reporting``) appended
   to bounded ring time-series (``runtime/slo.WindowSeries`` — the SLO
   watchdog's multi-window design, lifted from one process to the
   fleet).  Counter families become rates via per-replica deltas,
   reset-safe across replica restarts (uptime gauge).

4. **Export** — ``kaito:fleet_*{kind,name}`` gauges on the manager
   registry, a ``GET /debug/fleet`` JSON endpoint next to
   ``/debug/trace``, and a ``ScalingSignal`` condition per CR fed by a
   pure-function evaluator with enter-high/exit-low hysteresis and
   sustained-window logic (``idle | nominal | pressure | saturated``),
   plus deduped ``FleetPressureDetected`` / ``FleetPressureResolved``
   Events.

No actuation here: ``recommended_replicas`` is a hint in the output
contract (the autoscaling loop's read side) — the autoscaler is a
pure consumer of this plane.

A copy of ``kaito_tpu.runtime.fleet``.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import logging
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from kaito_tpu_torch.runtime.slo import WindowSeries
from kaito_tpu_torch.utils.promtext import parse_exposition, parse_labels

logger = logging.getLogger(__name__)

ANNOTATION_SCRAPE_URL = "kaito-tpu.io/scrape-url"

SIGNAL_IDLE = "idle"
SIGNAL_NOMINAL = "nominal"
SIGNAL_PRESSURE = "pressure"
SIGNAL_SATURATED = "saturated"
SIGNAL_CODE = {SIGNAL_IDLE: 0, SIGNAL_NOMINAL: 1,
               SIGNAL_PRESSURE: 2, SIGNAL_SATURATED: 3}

COND_SCALING_SIGNAL = "ScalingSignal"
EVENT_PRESSURE_DETECTED = "FleetPressureDetected"
EVENT_PRESSURE_RESOLVED = "FleetPressureResolved"
EVENT_FLIGHT_RECORDED = "FlightRecorded"

# engine series folded per replica: family -> (sample key, fold across
# labelled series of ONE payload).  Gauges; counters are listed below.
_ENGINE_GAUGES = {
    "kaito:batch_occupancy": ("occupancy", "mean"),
    "kaito:num_requests_waiting": ("waiting", "sum"),
    "kaito:kv_cache_usage_perc": ("kv_usage", "mean"),
    "kaito:active_slots": ("active_slots", "sum"),
    "kaito:slots_total": ("slots_total", "sum"),
    "kaito:process_uptime_seconds": ("uptime_s", "mean"),
    "kaito:process_resident_memory_bytes": ("rss_bytes", "sum"),
    "kaito:host_kv_entries": ("host_kv_entries", "sum"),
    "kaito:host_kv_bytes_used": ("host_kv_bytes", "sum"),
    "kaito:adapter_resident": ("adapter_resident", "sum"),
    "kaito:adapter_slots_total": ("adapter_slots_total", "sum"),
    # sampled device-time attribution (engine/devprof.py): last-window
    # gauges, present only on replicas running with devprof on — the
    # fold means over whoever reports, like the adapter families
    "kaito:device_comm_pct": ("device_comm_pct", "mean"),
    "kaito:device_comm_compute_overlap_pct": ("device_overlap_pct",
                                              "mean"),
    "kaito:device_idle_pct": ("device_idle_pct", "mean"),
    # incident flight recorder (utils/flightrec.py): bundles written
    # since process start, present only with --flight-dir — the summed
    # fold feeds the controller's FlightRecorded Event
    "kaito:flight_bundles_total": ("flight_bundles", "sum"),
    # tier-3 SSD KV (docs/kv-pool.md "Tier 3: SSD"): present only on
    # replicas running with --kv-pool-disk-bytes > 0
    "kaito:kv_tier_entries": ("kv_tier_entries", "sum"),
    "kaito:kv_tier_bytes_used": ("kv_tier_bytes", "sum"),
}
# cumulative counters -> per-replica delta rates at fold time
_ENGINE_COUNTERS = {
    "kaito:request_success_total": "requests_total",
    "kaito:request_shed_total": "shed_total",
    "kaito:generation_tokens_total": "gen_tokens_total",
    "kaito:prefix_cache_hits_total": "prefix_hits_total",
    "kaito:prefix_cache_misses_total": "prefix_misses_total",
    "kaito:spec_proposed_tokens_total": "spec_proposed_total",
    "kaito:spec_accepted_tokens_total": "spec_accepted_total",
    "kaito:host_kv_hits_total": "host_kv_hits_total",
    "kaito:host_kv_misses_total": "host_kv_misses_total",
    "kaito:host_kv_evictions_total": "host_kv_evictions_total",
    "kaito:adapter_loads_total": "adapter_loads_total",
    "kaito:adapter_evictions_total": "adapter_evictions_total",
    "kaito:adapter_hits_total": "adapter_hits_total",
    "kaito:grammar_cache_hits_total": "grammar_hits_total",
    "kaito:grammar_cache_misses_total": "grammar_misses_total",
    # tier-3 SSD KV (docs/kv-pool.md "Tier 3: SSD"): the labelled
    # hits family (tier="host"|"disk") sums across labels into one
    # local-tier hit counter; spills/evictions judge churn
    "kaito:kv_tier_hits_total": "kv_tier_hits_total",
    "kaito:kv_tier_spills_total": "kv_tier_spills_total",
    "kaito:kv_tier_evictions_total": "kv_tier_evictions_total",
    # packed prefill (docs/prefill.md): histogram _sum/_count fold into
    # plain counters (a fleet-level histogram merge would need every
    # bucket edge; mean pack size + dispatch rate answer the capacity
    # question), plus the prompt-token counter for tokens/s
    "kaito:prompt_tokens_total": "prompt_tokens_total",
    "kaito:engine_prefill_pack_size_sum": "prefill_packed_seqs_total",
    "kaito:engine_prefill_pack_size_count": "prefill_dispatches_total",
    "kaito:prefill_queue_wait_seconds_sum": "prefill_wait_seconds_total",
    "kaito:prefill_queue_wait_seconds_count": "prefill_waits_total",
}
# EPP / router front series (arrival side of the same CR).  The
# received counter keeps ticking even with ZERO backends — it is the
# scale-to-zero wake signal the autoscaler watches.
_EPP_COUNTERS = {
    "kaito:router_requests_forwarded_total": "forwarded_total",
    "kaito:epp_requests_forwarded_total": "forwarded_total",
    "kaito:router_requests_received_total": "received_total",
}
# tenant-labelled counters (present only when the engine runs with a
# QoS config) -> dynamic per-tenant keys "tenant_<what>_total:<tenant>"
_TENANT_COUNTERS = {
    "kaito:requests_shed_total": "tenant_shed_total",
    "kaito:requests_served_total": "tenant_served_total",
}


@dataclass
class FleetPolicy:
    """Signal thresholds (enter-high / exit-low pairs) + sustain
    windows.  Everything injectable so the unit tier and small e2e
    clusters can tighten the bands."""

    # pressure enters when ANY high watermark is sustained; exits to
    # nominal only when EVERY low watermark is sustained (hysteresis)
    occupancy_hi: float = 0.85
    occupancy_lo: float = 0.60
    queue_hi: float = 4.0          # waiting requests PER replica
    queue_lo: float = 1.0
    kv_hi: float = 0.90
    kv_lo: float = 0.70
    burn_hi: float = 1.0           # worst fast-window SLO burn
    burn_lo: float = 0.25
    shed_hi: float = 0.5           # sheds/s across the fleet
    shed_lo: float = 0.0
    # saturation: pressure so deep that +1 replica won't cut it
    sat_kv: float = 0.97
    sat_shed: float = 2.0
    sat_queue: float = 16.0        # per replica, with occupancy pinned
    sat_occupancy: float = 0.95
    # sustained-window lengths: a transition needs EVERY sample inside
    # the window on the far side of the watermark AND enough coverage
    sustain_s: float = 30.0
    idle_sustain_s: float = 300.0
    min_window_coverage: float = 0.8
    min_samples: int = 2
    # freshness horizon for replica samples (0 = derive from interval)
    freshness_s: float = 0.0
    # recommended_replicas hints (no actuation in this plane)
    scale_to_zero_hint: bool = False
    max_replicas_hint: int = 0     # 0 = unbounded

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in (
            "occupancy_hi", "occupancy_lo", "queue_hi", "queue_lo",
            "kv_hi", "kv_lo", "burn_hi", "burn_lo", "shed_hi", "shed_lo",
            "sat_kv", "sat_shed", "sat_queue", "sat_occupancy",
            "sustain_s", "idle_sustain_s")}


@dataclass
class SignalDecision:
    """Output contract of the pure evaluator — the read-side half of
    the autoscaler loop."""

    state: str
    reason: str                    # CamelCase, condition/Event-ready
    message: str                   # stable wording (Event dedupe)
    drivers: list                  # which watermarks drove the state
    observed: dict                 # last aggregate sample
    recommended_replicas: int      # hint the autoscaler consumes


# ---------------------------------------------------------------------------
# pure signal evaluation
# ---------------------------------------------------------------------------

def _per_replica_queue(s: dict) -> float:
    return s.get("queue_sum", 0.0) / max(1.0, s.get("replicas_reporting", 1))


def _pressure_drivers(s: dict, p: FleetPolicy) -> list[str]:
    """Which high watermarks does this aggregate sample cross?"""
    out = []
    if s.get("occupancy_mean", 0.0) >= p.occupancy_hi:
        out.append("occupancy")
    if _per_replica_queue(s) >= p.queue_hi:
        out.append("queue")
    if s.get("kv_mean", 0.0) >= p.kv_hi:
        out.append("kv")
    if s.get("burn_max", 0.0) >= p.burn_hi:
        out.append("slo-burn")
    if s.get("shed_rate", 0.0) > p.shed_hi:
        out.append("shed")
    return out


def _below_low_watermarks(s: dict, p: FleetPolicy) -> bool:
    return (s.get("occupancy_mean", 0.0) <= p.occupancy_lo
            and _per_replica_queue(s) <= p.queue_lo
            and s.get("kv_mean", 0.0) <= p.kv_lo
            and s.get("burn_max", 0.0) <= p.burn_lo
            and s.get("shed_rate", 0.0) <= p.shed_lo)


def _saturated(s: dict, p: FleetPolicy) -> bool:
    return (s.get("kv_mean", 0.0) >= p.sat_kv
            or s.get("shed_rate", 0.0) >= p.sat_shed
            or (s.get("occupancy_mean", 0.0) >= p.sat_occupancy
                and _per_replica_queue(s) >= p.sat_queue))


def _idle(s: dict) -> bool:
    return (s.get("requests_rate", 0.0) <= 0.0
            and s.get("queue_sum", 0.0) <= 0.0
            and s.get("active_slots", 0.0) <= 0.0)


def _sustained(samples: list[tuple[float, dict]], now: float,
               window_s: float, pred: Callable[[dict], bool],
               policy: FleetPolicy) -> bool:
    """True when EVERY sample inside ``[now - window_s, now]``
    satisfies ``pred`` AND the window has real coverage — enough
    samples, and the oldest one near the window's far edge.  Without
    the coverage check a single fresh sample would count as
    'sustained' right after startup."""
    inside = [(t, s) for t, s in samples if t >= now - window_s]
    if len(inside) < policy.min_samples:
        return False
    oldest = min(t for t, _ in inside)
    if now - oldest < window_s * policy.min_window_coverage:
        return False
    return all(pred(s) for _, s in inside)


def recommend_replicas(state: str, replicas: int, p: FleetPolicy) -> int:
    """The hint the autoscaler consumes.  Deliberately coarse —
    +1 on pressure, +50% on saturation, shrink toward idle — the
    actuation policy (warm pools, drain, cooldowns) lives with the
    actuator, not the telemetry plane."""
    replicas = max(1, int(replicas))
    if state == SIGNAL_SATURATED:
        want = replicas + max(1, math.ceil(replicas * 0.5))
    elif state == SIGNAL_PRESSURE:
        want = replicas + 1
    elif state == SIGNAL_IDLE:
        want = 0 if p.scale_to_zero_hint else 1
    else:
        want = replicas
    if p.max_replicas_hint > 0:
        want = min(want, p.max_replicas_hint)
    return want


def evaluate_signal(prev_state: str, samples: list[tuple[float, dict]],
                    policy: FleetPolicy, now: float,
                    replicas: int = 1) -> SignalDecision:
    """Pure function: (previous state, aggregate ring samples, policy,
    clock) -> next state + contract.  Enter-high/exit-low hysteresis:
    entering ``pressure`` needs a HIGH watermark sustained for
    ``sustain_s``; leaving it needs EVERY low watermark sustained for
    the same window — a fleet hovering at one threshold cannot flap."""
    p = policy
    prev = prev_state if prev_state in SIGNAL_CODE else SIGNAL_NOMINAL
    last = samples[-1][1] if samples else {}
    state = prev

    def sustained(pred, window=p.sustain_s):
        return _sustained(samples, now, window, pred, p)

    if sustained(lambda s: _saturated(s, p)):
        state = SIGNAL_SATURATED
    elif prev == SIGNAL_SATURATED:
        # exit saturation only once below the saturation band...
        if sustained(lambda s: not _saturated(s, p)):
            # ...and fall all the way to nominal only through the
            # pressure exit-low gate
            state = SIGNAL_NOMINAL if sustained(
                lambda s: _below_low_watermarks(s, p)) else SIGNAL_PRESSURE
    elif prev == SIGNAL_PRESSURE:
        if sustained(lambda s: _below_low_watermarks(s, p)):
            state = SIGNAL_NOMINAL
    else:                                  # idle | nominal
        if sustained(lambda s: bool(_pressure_drivers(s, p))):
            state = SIGNAL_PRESSURE
        elif prev == SIGNAL_IDLE:
            if last and not _idle(last):
                state = SIGNAL_NOMINAL     # traffic arrived: wake now
        elif sustained(_idle, p.idle_sustain_s):
            state = SIGNAL_IDLE

    drivers = _pressure_drivers(last, p) if last else []
    if state == SIGNAL_NOMINAL:
        reason, msg = "FleetNominal", "fleet load inside the nominal band"
    elif state == SIGNAL_IDLE:
        reason, msg = "FleetIdle", \
            f"no fleet traffic for {int(p.idle_sustain_s)}s"
    else:
        reason = "FleetSaturated" if state == SIGNAL_SATURATED \
            else "FleetPressure"
        # stable wording (no live numbers): repeats dedupe into one
        # Event with a bumped count instead of flooding the ring
        msg = (f"sustained {state}: "
               f"{', '.join(drivers) or 'load above watermarks'}")
    return SignalDecision(
        state=state, reason=reason, message=msg, drivers=drivers,
        observed=dict(last),
        recommended_replicas=recommend_replicas(state, replicas, p))


# ---------------------------------------------------------------------------
# scrape targets + samples
# ---------------------------------------------------------------------------

@dataclass
class ScrapeTarget:
    url: str
    replica: str                   # workspace name / "<name>-epp"
    role: str = "replica"          # "replica" | "epp"
    phase: float = 0.0             # stagger offset inside the interval


@dataclass
class ReplicaSample:
    """Last successful scrape of one target, plus derived rates."""

    ts: float = 0.0                # time_fn() at scrape success
    values: dict = field(default_factory=dict)
    rates: dict = field(default_factory=dict)
    scrape_seconds: float = 0.0
    consecutive_failures: int = 0
    last_error: str = ""


class _CRSeries:
    """Per-CR ring time-series of fold aggregates + signal state."""

    def __init__(self, kind: str, namespace: str, name: str,
                 max_window_s: float, time_fn: Callable[[], float]):
        self.kind = kind
        self.namespace = namespace
        self.name = name
        self.time_fn = time_fn
        self.ring: WindowSeries = WindowSeries(max_window_s, time_fn)
        # WindowSeries stores scalars; aggregates ride next to it as
        # (ts, dict) tuples pruned on the same horizon
        self.samples: list[tuple[float, dict]] = []
        self.max_window_s = max_window_s
        self.state = SIGNAL_NOMINAL
        self.state_since = time_fn()
        self.transitions = 0
        self.last_decision: Optional[SignalDecision] = None
        self.replicas_desired = 0
        # flight-recorder Event dedupe: folded bundle count at the last
        # FlightRecorded Event (None = no baseline yet — the first
        # observation must not read pre-existing bundles as an incident)
        self.flight_bundles_seen: Optional[float] = None
        # per-CR hint overrides from spec.autoscale (scale_to_zero,
        # max_replicas); None = global policy (one config source for
        # recommended_replicas hints AND actuation)
        self.hint_overrides: Optional[tuple[bool, int]] = None

    def add(self, agg: dict) -> None:
        now = self.time_fn()
        self.ring.add(agg.get("queue_sum", 0.0))   # bounded scalar ring
        self.samples.append((now, agg))
        cutoff = now - self.max_window_s
        while self.samples and self.samples[0][0] < cutoff:
            self.samples.pop(0)
        # hard bound mirrors WindowSeries: a stuck clock cannot grow it
        del self.samples[:-4096]

    def window_stats(self, window_s: float) -> dict:
        now = self.time_fn()
        inside = [s for t, s in self.samples if t >= now - window_s]
        if not inside:
            return {}
        out: dict[str, dict] = {}
        for key in sorted({k for s in inside for k in s}):
            vals = [s[key] for s in inside if key in s]
            out[key] = {"last": round(vals[-1], 6),
                        "mean": round(sum(vals) / len(vals), 6),
                        "max": round(max(vals), 6)}
        return out


def _stable_phase(url: str, interval_s: float) -> float:
    h = int.from_bytes(hashlib.sha256(url.encode()).digest()[:8], "big")
    return (h / 2.0 ** 64) * interval_s


def _percentile(values: list[float], q: float) -> float:
    if not values:
        return 0.0
    xs = sorted(values)
    idx = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
    return xs[idx]


def parse_replica_metrics(text: str) -> dict[str, float]:
    """Fold one ``/metrics`` payload into the fleet's sample keys.
    Labelled series of one family are summed (counters, absolute
    gauges) or averaged (utilization ratios) exactly like
    ``routing.parse_load_metrics`` — robust to DP-grouped engines."""
    sums: dict[str, list[float]] = {}
    means: dict[str, list[float]] = {}
    for name, labels, value in parse_exposition(text):
        gauge = _ENGINE_GAUGES.get(name)
        if gauge is not None:
            key, fold = gauge
            (means if fold == "mean" else sums).setdefault(
                key, []).append(value)
            continue
        ctr = _ENGINE_COUNTERS.get(name) or _EPP_COUNTERS.get(name)
        if ctr is not None:
            sums.setdefault(ctr, []).append(value)
            continue
        ten = _TENANT_COUNTERS.get(name)
        if ten is not None:
            tenant = parse_labels(labels).get("tenant", "")
            if tenant:
                sums.setdefault(f"{ten}:{tenant}", []).append(value)
    out = {k: sum(v) for k, v in sums.items()}
    out.update({k: sum(v) / len(v) for k, v in means.items()})
    return out


# ---------------------------------------------------------------------------
# the telemetry plane
# ---------------------------------------------------------------------------

class FleetTelemetry:
    """Discover → scrape → fold → evaluate → export.

    Cheap to construct (no threads, no sockets): the manager builds one
    per process and either runs the background loop (``start()``) or
    drives rounds explicitly (``scrape_once`` — what the test tiers
    do).  ``time_fn`` is injectable for deterministic units."""

    def __init__(self, store, policy: Optional[FleetPolicy] = None,
                 interval_s: float = 10.0, timeout_s: float = 2.0,
                 max_window_s: float = 900.0,
                 time_fn: Callable[[], float] = time.monotonic):
        self.store = store
        self.policy = policy or FleetPolicy()
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.max_window_s = float(max_window_s)
        self.time_fn = time_fn
        self._lock = threading.Lock()
        # CR key -> {url -> ScrapeTarget}; epp targets ride in the same
        # map with role="epp"
        self._targets: dict[tuple, dict[str, ScrapeTarget]] = {}
        self._samples: dict[tuple, dict[str, ReplicaSample]] = {}
        self._crs: dict[tuple, _CRSeries] = {}
        self._next_due: dict[str, float] = {}
        self._inflight: set[str] = set()
        self._last_agg: dict[tuple, dict] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- freshness -----------------------------------------------------

    @property
    def freshness_s(self) -> float:
        return self.policy.freshness_s or (3.0 * self.interval_s
                                           + self.timeout_s)

    # -- discovery -----------------------------------------------------

    def _resolve_url(self, obj, service) -> Optional[str]:
        """Workspace/Service -> scrape URL.  Annotation beats DNS; no
        Service and no annotation means the replica is not scrapable
        yet (it simply doesn't report)."""
        for o in (obj, service):
            if o is None:
                continue
            url = (getattr(o.metadata, "annotations", None)
                   or {}).get(ANNOTATION_SCRAPE_URL)
            if url:
                return url.rstrip("/")
        if service is None:
            return None
        ports = (service.spec or {}).get("ports") or []
        port = ports[0].get("port", 5000) if ports else 5000
        return f"http://{service.metadata.name}:{port}"

    def refresh_targets(self) -> None:
        """Rebuild the target map from the store: InferenceSet children
        + their EPP, and standalone Workspaces as their own CR."""
        from kaito_tpu_torch.api.workspace import LABEL_CREATED_BY_INFERENCESET

        targets: dict[tuple, dict[str, ScrapeTarget]] = {}
        desired: dict[tuple, int] = {}
        hints: dict[tuple, tuple[bool, int]] = {}

        def add(key, url, replica, role):
            if url is None:
                return
            targets.setdefault(key, {})[url] = ScrapeTarget(
                url=url, replica=replica, role=role,
                phase=_stable_phase(url, self.interval_s))

        try:
            isets = self.store.list("InferenceSet")
        except Exception:
            isets = []
        for iset in isets:
            ns, name = iset.metadata.namespace, iset.metadata.name
            key = ("InferenceSet", ns, name)
            desired[key] = max(getattr(iset.status, "replicas", 0),
                               getattr(iset.spec, "replicas", 0))
            autoscale = getattr(iset.spec, "autoscale", None)
            if autoscale is not None and autoscale.enabled:
                hints[key] = (bool(autoscale.scale_to_zero),
                              int(autoscale.max_replicas))
            children = self.store.list(
                "Workspace", ns,
                labels={LABEL_CREATED_BY_INFERENCESET: name})
            for ws in children:
                svc = self.store.try_get("Service", ns, ws.metadata.name)
                add(key, self._resolve_url(ws, svc), ws.metadata.name,
                    "replica")
            epp_svc = self.store.try_get("Service", ns, f"{name}-epp")
            if epp_svc is not None:
                add(key, self._resolve_url(None, epp_svc), f"{name}-epp",
                    "epp")
        try:
            workspaces = self.store.list("Workspace")
        except Exception:
            workspaces = []
        for ws in workspaces:
            if ws.metadata.labels.get(LABEL_CREATED_BY_INFERENCESET):
                continue                  # counted under its set
            ns, name = ws.metadata.namespace, ws.metadata.name
            key = ("Workspace", ns, name)
            desired[key] = 1
            svc = self.store.try_get("Service", ns, name)
            url = self._resolve_url(ws, svc)
            if url is not None:
                add(key, url, name, "replica")

        with self._lock:
            self._targets = targets
            for key in list(self._samples):
                if key not in targets:
                    del self._samples[key]
            for key, tmap in targets.items():
                cr = self._crs.get(key)
                if cr is None:
                    cr = self._crs[key] = _CRSeries(
                        key[0], key[1], key[2], self.max_window_s,
                        self.time_fn)
                cr.replicas_desired = desired.get(key, len(tmap))
                cr.hint_overrides = hints.get(key)
                smap = self._samples.setdefault(key, {})
                for url in list(smap):
                    if url not in tmap:
                        del smap[url]     # replica left the set
            for key in list(self._crs):
                if key not in targets:
                    del self._crs[key]
                    self._last_agg.pop(key, None)

    # -- scraping ------------------------------------------------------

    def _fetch(self, url: str, path: str) -> Optional[bytes]:
        if not url.startswith("http://"):
            raise ValueError(f"unsupported scrape url: {url}")
        hostport = url[len("http://"):]
        host, _, port = hostport.partition(":")
        conn = http.client.HTTPConnection(host, int(port or 80),
                                          timeout=self.timeout_s)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            if resp.status != 200:
                return None
            return resp.read()
        finally:
            conn.close()

    def _scrape_target(self, key: tuple, t: ScrapeTarget) -> None:
        t0 = self.time_fn()
        values: dict[str, float] = {}
        err = ""
        try:
            body = self._fetch(t.url, "/metrics")
            if body is None:
                raise ConnectionError("non-200 /metrics")
            values = parse_replica_metrics(body.decode("utf-8", "replace"))
            if t.role == "replica":
                # one extra cheap field ride-along: the replica's worst
                # fast-window SLO burn (see slo.snapshot burn_max)
                try:
                    slo_body = self._fetch(t.url, "/debug/slo")
                    if slo_body is not None:
                        snap = json.loads(slo_body)
                        values["burn_max"] = float(
                            snap.get("burn_max", 0.0))
                        # per-role attribution: the
                        # replica's role keys a dynamic burn field so
                        # the P/D split can act on the right SLO per
                        # pool; the ITL SLI rides along when enabled
                        role = str(snap.get("role", "") or "unified")
                        values[f"role_burn:{role}"] = values["burn_max"]
                        itl = (snap.get("burn_rates") or {}).get(
                            "itl_p99")
                        if itl is not None:
                            values["itl_burn_max"] = float(
                                itl.get("fast", 0.0))
                except (ValueError, ConnectionError, OSError):
                    pass                  # burn is optional per scrape
        except (ConnectionError, OSError, ValueError) as e:
            err = f"{type(e).__name__}: {e}"
        now = self.time_fn()
        with self._lock:
            smap = self._samples.setdefault(key, {})
            prev = smap.get(t.url) or ReplicaSample()
            if err:
                prev.consecutive_failures += 1
                prev.last_error = err
                smap[t.url] = prev        # ts stays stale
                return
            rates = self._rates(prev, values, now)
            smap[t.url] = ReplicaSample(
                ts=now, values=values, rates=rates,
                scrape_seconds=now - t0, consecutive_failures=0)

    def _rates(self, prev: ReplicaSample, values: dict,
               now: float) -> dict:
        """Counter deltas -> per-second rates.  A counter that moved
        backwards (replica restart — the uptime gauge confirms) rates
        as 0 for one round instead of going hugely negative."""
        if not prev.ts or now <= prev.ts:
            return {}
        dt = now - prev.ts
        restarted = values.get("uptime_s", float("inf")) < dt
        out = {}
        keys = ["requests_total", "shed_total", "gen_tokens_total",
                "prefix_hits_total", "prefix_misses_total",
                "spec_proposed_total", "spec_accepted_total",
                "host_kv_hits_total", "host_kv_misses_total",
                "host_kv_evictions_total",
                "kv_tier_hits_total", "kv_tier_spills_total",
                "kv_tier_evictions_total",
                "adapter_loads_total", "adapter_evictions_total",
                "adapter_hits_total",
                "grammar_hits_total", "grammar_misses_total",
                "prompt_tokens_total", "prefill_packed_seqs_total",
                "prefill_dispatches_total", "prefill_wait_seconds_total",
                "prefill_waits_total",
                "forwarded_total", "received_total"]
        # per-tenant counters carry the tenant in the key itself
        # ("tenant_shed_total:acme"), so rate whatever both samples have
        keys += [k for k in values if k.startswith("tenant_")
                 and "_total:" in k]
        for key in keys:
            if key not in values or key not in prev.values:
                continue
            delta = values[key] - prev.values[key]
            if delta < 0 or restarted:
                delta = 0.0
            stem, _, tenant = key.partition(":")
            rkey = stem[:-len("_total")] + "_rate"
            out[f"{rkey}:{tenant}" if tenant else rkey] = delta / dt
        return out

    def scrape_once(self, force: bool = False, wait: bool = True) -> int:
        """One staggered round: spawn a worker per due target (guarded
        so a hung target never piles up), optionally join with the
        per-target deadline, then fold.  Returns the number of targets
        polled this round."""
        now = self.time_fn()
        with self._lock:
            due: list[tuple[tuple, ScrapeTarget]] = []
            for key, tmap in self._targets.items():
                for t in tmap.values():
                    nd = self._next_due.get(t.url)
                    if nd is None:
                        nd = now + (0.0 if force else t.phase)
                        self._next_due[t.url] = nd
                    if not force and now < nd:
                        continue
                    if t.url in self._inflight:
                        continue          # hung: only ITS freshness lags
                    self._inflight.add(t.url)
                    self._next_due[t.url] = max(nd, now) + self.interval_s
                    due.append((key, t))
        workers = []
        for key, t in due:
            th = threading.Thread(target=self._scrape_guarded,
                                  args=(key, t), daemon=True,
                                  name="fleet-scrape")
            th.start()
            workers.append(th)
        if wait:
            deadline = time.monotonic() + self.timeout_s + 1.0
            for th in workers:
                th.join(max(0.0, deadline - time.monotonic()))
        self.fold()
        return len(due)

    def _scrape_guarded(self, key: tuple, t: ScrapeTarget) -> None:
        try:
            self._scrape_target(key, t)
        finally:
            with self._lock:
                self._inflight.discard(t.url)

    # -- folding -------------------------------------------------------

    def ingest(self, key: tuple, url: str, values: dict,
               rates: Optional[dict] = None, role: str = "replica",
               replica: str = "") -> None:
        """Test/embedding hook: feed a replica sample without a socket
        (the unit tier drives the evaluator through this)."""
        with self._lock:
            self._targets.setdefault(key, {})[url] = ScrapeTarget(
                url=url, replica=replica or url, role=role)
            if key not in self._crs:
                self._crs[key] = _CRSeries(key[0], key[1], key[2],
                                           self.max_window_s, self.time_fn)
                self._crs[key].replicas_desired = 1
            self._samples.setdefault(key, {})[url] = ReplicaSample(
                ts=self.time_fn(), values=dict(values),
                rates=dict(rates or {}))

    def _fresh(self, key: tuple) -> tuple[list, list]:
        now = self.time_fn()
        horizon = now - self.freshness_s
        replicas, epps = [], []
        tmap = self._targets.get(key, {})
        for url, s in self._samples.get(key, {}).items():
            if s.ts <= 0 or s.ts < horizon:
                continue
            t = tmap.get(url)
            (epps if t is not None and t.role == "epp"
             else replicas).append(s)
        return replicas, epps

    def fold(self) -> None:
        """Collapse fresh replica samples into one aggregate sample per
        CR and append it to the CR's ring."""
        with self._lock:
            keys = list(self._targets)
        for key in keys:
            with self._lock:
                replicas, epps = self._fresh(key)
                cr = self._crs.get(key)
            if cr is None:
                continue
            agg = self._aggregate(replicas, epps)
            with self._lock:
                cr.add(agg)
                self._last_agg[key] = agg

    @staticmethod
    def _aggregate(replicas: list, epps: list) -> dict:
        def vals(k):
            return [s.values[k] for s in replicas if k in s.values]

        def rate(k):
            return sum(s.rates.get(k, 0.0) for s in replicas)

        def fold(k, how):
            v = vals(k)
            if not v:
                return 0.0
            if how == "sum":
                return sum(v)
            if how == "mean":
                return sum(v) / len(v)
            return _percentile(v, 0.95)

        hit = rate("prefix_hits_rate")
        miss = rate("prefix_misses_rate")
        prop = rate("spec_proposed_rate")
        acc = rate("spec_accepted_rate")
        hkv_hit = rate("host_kv_hits_rate")
        hkv_miss = rate("host_kv_misses_rate")
        gr_hit = rate("grammar_hits_rate")
        gr_miss = rate("grammar_misses_rate")
        agg = {
            "replicas_reporting": float(len(replicas)),
            "queue_sum": fold("waiting", "sum"),
            "queue_p95": fold("waiting", "p95"),
            "occupancy_mean": fold("occupancy", "mean"),
            "occupancy_p95": fold("occupancy", "p95"),
            "kv_mean": fold("kv_usage", "mean"),
            "kv_p95": fold("kv_usage", "p95"),
            "active_slots": fold("active_slots", "sum"),
            "slots_total": fold("slots_total", "sum"),
            "rss_bytes": fold("rss_bytes", "sum"),
            "uptime_min": min(vals("uptime_s"), default=0.0),
            "requests_total": fold("requests_total", "sum"),
            "gen_tokens_total": fold("gen_tokens_total", "sum"),
            "requests_rate": rate("requests_rate"),
            "shed_rate": rate("shed_rate"),
            "tokens_rate": rate("gen_tokens_rate"),
            "burn_max": max(vals("burn_max"), default=0.0),
            # per-token ITL SLI (replicas running with --itl): worst
            # fast-window itl_p99 burn across the fleet
            "itl_burn_max": max(vals("itl_burn_max"), default=0.0),
            # incident flight recorder: bundles written across replicas
            # (apply_signals turns an increase into a FlightRecorded
            # Event on the owning CR)
            "flight_bundles": fold("flight_bundles", "sum"),
            "prefix_hit_rate": hit / (hit + miss) if hit + miss > 0 else 0.0,
            "spec_accept_rate": acc / prop if prop > 0 else 0.0,
            # host KV offload tier, cluster-wide: capacity (entries /
            # bytes sums), churn (evictions/s), and effectiveness (hit
            # fraction of pops) — the rollout dashboards judge whether
            # the tier is sized right from these three
            "host_kv_entries": fold("host_kv_entries", "sum"),
            "host_kv_bytes": fold("host_kv_bytes", "sum"),
            "host_kv_evictions_rate": rate("host_kv_evictions_rate"),
            "host_kv_hit_rate": (hkv_hit / (hkv_hit + hkv_miss)
                                 if hkv_hit + hkv_miss > 0 else 0.0),
            # tier-3 SSD KV (docs/kv-pool.md "Tier 3: SSD"): capacity
            # (entries/bytes across replicas running the tier), local
            # tiered-probe hit rate, and demotion/prune churn
            "kv_tier_entries": fold("kv_tier_entries", "sum"),
            "kv_tier_bytes": fold("kv_tier_bytes", "sum"),
            "kv_tier_hits_rate": rate("kv_tier_hits_rate"),
            "kv_tier_spills_rate": rate("kv_tier_spills_rate"),
            "kv_tier_evictions_rate": rate("kv_tier_evictions_rate"),
            # multi-LoRA adapter plane (docs/multi-lora.md): residency
            # vs capacity (is the slot table sized right?), hot-load +
            # eviction churn, and per-request adapter traffic
            "adapter_resident": fold("adapter_resident", "sum"),
            "adapter_slots_total": fold("adapter_slots_total", "sum"),
            "adapter_loads_rate": rate("adapter_loads_rate"),
            "adapter_evictions_rate": rate("adapter_evictions_rate"),
            "adapter_hits_rate": rate("adapter_hits_rate"),
            # structured output (docs/structured-output.md): fraction
            # of constrained requests served a precompiled grammar —
            # a low rate cluster-wide means the schema working set
            # exceeds --grammar-cache-entries
            "grammar_cache_hit_rate": (
                gr_hit / (gr_hit + gr_miss)
                if gr_hit + gr_miss > 0 else 0.0),
            # packed prefill (docs/prefill.md): prompt tokens/s,
            # prefill dispatches/s, mean sequences per dispatch (the
            # packing win — 1.0 means serial), and mean staged->first-
            # dispatch queue wait (the TTFT component packing attacks)
            "prefill_tokens_rate": rate("prompt_tokens_rate"),
            "prefill_dispatch_rate": rate("prefill_dispatches_rate"),
            "prefill_pack_mean": (
                rate("prefill_packed_seqs_rate")
                / rate("prefill_dispatches_rate")
                if rate("prefill_dispatches_rate") > 0 else 0.0),
            "prefill_queue_wait_mean": (
                rate("prefill_wait_seconds_rate")
                / rate("prefill_waits_rate")
                if rate("prefill_waits_rate") > 0 else 0.0),
            # sampled device-time attribution (engine/devprof.py):
            # means over the replicas that report (devprof-off
            # replicas emit no device_* series and don't dilute)
            "device_comm_pct": fold("device_comm_pct", "mean"),
            "device_overlap_pct": fold("device_overlap_pct", "mean"),
            "device_idle_pct": fold("device_idle_pct", "mean"),
        }
        if epps:
            agg["arrival_rate"] = sum(
                s.rates.get("forwarded_rate", 0.0) for s in epps)
            agg["received_rate"] = sum(
                s.rates.get("received_rate", 0.0) for s in epps)
            agg["epp_reporting"] = float(len(epps))
        # per-tenant slices (QoS engines only): sum each tenant's
        # shed/served rate across replicas, keyed "tenant_shed_rate:<t>"
        for s in replicas:
            for rk, rv in s.rates.items():
                if rk.startswith("tenant_") and ":" in rk:
                    agg[rk] = agg.get(rk, 0.0) + rv
        # per-role SLO burn: worst burn per serving
        # role across replicas, keyed "role_burn:<role>" — the P/D
        # autoscaler scales prefill pools on TTFT burn and decode pools
        # on ITL burn without mixing the two
        for s in replicas:
            for rk, rv in s.values.items():
                if rk.startswith("role_burn:"):
                    agg[rk] = max(agg.get(rk, 0.0), rv)
        return agg

    # -- evaluation + condition/event surfacing ------------------------

    def evaluate(self, key: tuple) -> Optional[SignalDecision]:
        """Run the pure evaluator over one CR's ring; updates the CR's
        sticky state.  None until the first fold lands (no telemetry ->
        no opinion, so embedding a Manager never writes conditions for
        CRs nobody scrapes)."""
        with self._lock:
            cr = self._crs.get(key)
            if cr is None or not cr.samples:
                return None
            samples = list(cr.samples)
            prev = cr.state
            replicas = cr.replicas_desired or 1
            overrides = cr.hint_overrides
        policy = self.policy
        if overrides is not None:
            # spec.autoscale is the single config source: its
            # scale-to-zero / max-replicas bounds shape the hint the
            # actuator consumes
            import dataclasses

            policy = dataclasses.replace(
                policy, scale_to_zero_hint=overrides[0],
                max_replicas_hint=overrides[1])
        decision = evaluate_signal(prev, samples, policy,
                                   self.time_fn(), replicas)
        with self._lock:
            if decision.state != cr.state:
                cr.state = decision.state
                cr.state_since = self.time_fn()
                cr.transitions += 1
            cr.last_decision = decision
        return decision

    def signal(self, key: tuple) -> Optional[tuple[str, float, SignalDecision]]:
        """Actuator-facing read: (state, state_since, last decision)
        for one CR, or None before the first evaluation.  The
        autoscaler consumes this instead of re-parsing conditions."""
        with self._lock:
            cr = self._crs.get(key)
            if cr is None or cr.last_decision is None:
                return None
            return cr.state, cr.state_since, cr.last_decision

    def last_aggregate(self, key: tuple) -> dict:
        """Last folded aggregate for one CR ({} when never folded) —
        the autoscaler's scale-to-zero wake check reads
        ``received_rate`` from here."""
        with self._lock:
            return dict(self._last_agg.get(key, {}))

    def apply_signals(self) -> None:
        """Evaluate every CR and surface the verdict: ``ScalingSignal``
        condition (+ status hint fields on InferenceSet) and deduped
        pressure Events.  Store writes only happen on CHANGE — a
        steady fleet adds zero resourceVersion churn per resync."""
        from kaito_tpu_torch.api.meta import Condition, get_condition, set_condition
        from kaito_tpu_torch.controllers.runtime import update_with_retry
        from kaito_tpu_torch.k8s.events import record_event

        with self._lock:
            keys = list(self._crs)
        for key in keys:
            with self._lock:
                cr = self._crs.get(key)
                prev = cr.state if cr else SIGNAL_NOMINAL
            decision = self.evaluate(key)
            if decision is None:
                continue
            kind, ns, name = key
            obj = self.store.try_get(kind, ns, name)
            if obj is None:
                continue
            # abnormal-true convention (PodPressure-style): True means
            # a scaling action is signalled; False means nominal
            status = "True" if decision.state != SIGNAL_NOMINAL else "False"
            reason, message = decision.reason, decision.message
            if decision.observed.get("replicas_reporting", 0) <= 0:
                status, reason = "Unknown", "NoTelemetry"
                message = "no replica reported a fresh scrape"
            cur = get_condition(obj.status.conditions, COND_SCALING_SIGNAL)
            hint = decision.recommended_replicas
            needs_write = (cur is None or cur.status != status
                           or cur.reason != reason
                           or (kind == "InferenceSet"
                               and (getattr(obj.status, "scaling_signal", "")
                                    != decision.state
                                    or getattr(obj.status,
                                               "recommended_replicas", -1)
                                    != hint)))
            if needs_write:
                def mutate(o):
                    set_condition(o.status.conditions, Condition(
                        type=COND_SCALING_SIGNAL, status=status,
                        reason=reason, message=message))
                    if hasattr(o.status, "scaling_signal"):
                        o.status.scaling_signal = decision.state
                    if hasattr(o.status, "recommended_replicas"):
                        o.status.recommended_replicas = hint
                try:
                    update_with_retry(self.store, kind, ns, name, mutate)
                except Exception:
                    logger.debug("ScalingSignal write failed for %s",
                                 key, exc_info=True)
            entered_pressure = (decision.state in (SIGNAL_PRESSURE,
                                                   SIGNAL_SATURATED)
                                and prev not in (SIGNAL_PRESSURE,
                                                 SIGNAL_SATURATED))
            left_pressure = (prev in (SIGNAL_PRESSURE, SIGNAL_SATURATED)
                             and decision.state not in (SIGNAL_PRESSURE,
                                                        SIGNAL_SATURATED))
            if entered_pressure:
                record_event(self.store, obj, "Warning",
                             EVENT_PRESSURE_DETECTED, decision.message)
            elif left_pressure:
                record_event(self.store, obj, "Normal",
                             EVENT_PRESSURE_RESOLVED,
                             f"fleet back to {decision.state}")
            # incident flight recorder: surface a FlightRecorded Event
            # the moment any replica's bundle count advances past the
            # remembered baseline (first observation only arms it, so
            # pre-existing bundles don't read as a fresh incident;
            # restarts lower the sum and just re-baseline)
            fb = decision.observed.get("flight_bundles", 0.0)
            with self._lock:
                cr = self._crs.get(key)
                seen = cr.flight_bundles_seen if cr is not None else None
                if cr is not None:
                    cr.flight_bundles_seen = fb
            if seen is not None and fb > seen:
                record_event(
                    self.store, obj, "Warning", EVENT_FLIGHT_RECORDED,
                    f"flight-recorder bundle(s) written "
                    f"({int(seen)} -> {int(fb)}): fetch via "
                    f"GET /debug/flight on the replicas")

    # -- export: gauges + /debug/fleet ---------------------------------

    def register_metrics(self, registry) -> None:
        """Attach ``kaito:fleet_*{kind,name}`` to the manager registry.
        Everything reads the last fold, so the labelled-fn Gauge form
        fits exactly (same pattern as the SLO watchdog)."""
        from kaito_tpu_torch.engine.metrics import Gauge

        def family(field_, scale=1.0):
            def _fn():
                with self._lock:
                    return {(k[0], k[2]): agg.get(field_, 0.0) * scale
                            for k, agg in self._last_agg.items()}
            return _fn

        def agg_family(fields):
            def _fn():
                out = {}
                with self._lock:
                    for k, agg in self._last_agg.items():
                        for agg_name, f in fields.items():
                            out[(k[0], k[2], agg_name)] = agg.get(f, 0.0)
                return out
            return _fn

        r = registry
        Gauge("kaito:fleet_replicas_reporting",
              "Replicas with a fresh scrape, per CR", r,
              labels=("kind", "name"), fn=family("replicas_reporting"))
        Gauge("kaito:fleet_queue_depth",
              "Waiting requests across the fleet (sum/mean/p95)", r,
              labels=("kind", "name", "agg"),
              fn=agg_family({"sum": "queue_sum", "p95": "queue_p95"}))
        Gauge("kaito:fleet_batch_occupancy",
              "Decode-slot occupancy across the fleet", r,
              labels=("kind", "name", "agg"),
              fn=agg_family({"mean": "occupancy_mean",
                             "p95": "occupancy_p95"}))
        Gauge("kaito:fleet_kv_usage",
              "KV page-pool utilization across the fleet", r,
              labels=("kind", "name", "agg"),
              fn=agg_family({"mean": "kv_mean", "p95": "kv_p95"}))
        Gauge("kaito:fleet_requests_total",
              "Finished requests summed over reporting replicas", r,
              labels=("kind", "name"), fn=family("requests_total"))
        Gauge("kaito:fleet_requests_per_s",
              "Fleet request completion rate", r,
              labels=("kind", "name"), fn=family("requests_rate"))
        Gauge("kaito:fleet_tokens_per_s",
              "Fleet generated-token rate", r,
              labels=("kind", "name"), fn=family("tokens_rate"))
        Gauge("kaito:fleet_shed_per_s",
              "Fleet admission-shed rate (429s)", r,
              labels=("kind", "name"), fn=family("shed_rate"))
        Gauge("kaito:fleet_prefix_hit_rate",
              "Fleet prefix-cache hit ratio (rate-weighted)", r,
              labels=("kind", "name"), fn=family("prefix_hit_rate"))
        Gauge("kaito:fleet_spec_accept_rate",
              "Fleet speculative-decoding accept ratio", r,
              labels=("kind", "name"), fn=family("spec_accept_rate"))
        Gauge("kaito:fleet_slo_burn_max",
              "Worst replica fast-window SLO burn per CR", r,
              labels=("kind", "name"), fn=family("burn_max"))
        Gauge("kaito:fleet_slo_itl_burn_max",
              "Worst replica fast-window ITL p99 burn per CR "
              "(replicas running with --itl)", r,
              labels=("kind", "name"), fn=family("itl_burn_max"))

        def _role_burns():
            out = {}
            with self._lock:
                for k, agg in self._last_agg.items():
                    for field_, v in agg.items():
                        if field_.startswith("role_burn:"):
                            role = field_.split(":", 1)[1]
                            out[(k[0], k[2], role)] = v
            return out

        Gauge("kaito:fleet_slo_role_burn_max",
              "Worst replica fast-window SLO burn per CR and serving "
              "role (prefill/decode/unified)", r,
              labels=("kind", "name", "role"), fn=_role_burns)
        Gauge("kaito:fleet_flight_bundles",
              "Flight-recorder bundles written across reporting "
              "replicas", r,
              labels=("kind", "name"), fn=family("flight_bundles"))
        Gauge("kaito:fleet_host_kv_entries",
              "Host KV offload entries summed over the fleet", r,
              labels=("kind", "name"), fn=family("host_kv_entries"))
        Gauge("kaito:fleet_host_kv_bytes",
              "Host KV offload bytes summed over the fleet", r,
              labels=("kind", "name"), fn=family("host_kv_bytes"))
        Gauge("kaito:fleet_host_kv_evictions_per_s",
              "Fleet host KV offload eviction rate (churn)", r,
              labels=("kind", "name"),
              fn=family("host_kv_evictions_rate"))
        Gauge("kaito:fleet_host_kv_hit_rate",
              "Fleet host KV offload hit ratio (rate-weighted)", r,
              labels=("kind", "name"), fn=family("host_kv_hit_rate"))
        Gauge("kaito:fleet_kv_tier_entries",
              "SSD KV tier entries summed over the fleet", r,
              labels=("kind", "name"), fn=family("kv_tier_entries"))
        Gauge("kaito:fleet_kv_tier_bytes",
              "SSD KV tier bytes summed over the fleet", r,
              labels=("kind", "name"), fn=family("kv_tier_bytes"))
        Gauge("kaito:fleet_kv_tier_hits_per_s",
              "Fleet rate of prefix imports served from the local "
              "host/SSD tiers", r,
              labels=("kind", "name"), fn=family("kv_tier_hits_rate"))
        Gauge("kaito:fleet_kv_tier_spills_per_s",
              "Fleet rate of host-LRU victims demoted to SSD", r,
              labels=("kind", "name"), fn=family("kv_tier_spills_rate"))
        Gauge("kaito:fleet_kv_tier_evictions_per_s",
              "Fleet rate of SSD-tier budget prunes (churn)", r,
              labels=("kind", "name"),
              fn=family("kv_tier_evictions_rate"))
        Gauge("kaito:fleet_adapter_resident",
              "LoRA adapters resident in HBM slots, fleet-wide", r,
              labels=("kind", "name"), fn=family("adapter_resident"))
        Gauge("kaito:fleet_adapter_slots_total",
              "LoRA HBM slot capacity summed over the fleet", r,
              labels=("kind", "name"), fn=family("adapter_slots_total"))
        Gauge("kaito:fleet_adapter_loads_per_s",
              "Fleet adapter hot-load rate (install + host fault-in)", r,
              labels=("kind", "name"), fn=family("adapter_loads_rate"))
        Gauge("kaito:fleet_adapter_evictions_per_s",
              "Fleet adapter slot-eviction rate (churn: slots too "
              "few for the working set)", r,
              labels=("kind", "name"), fn=family("adapter_evictions_rate"))
        Gauge("kaito:fleet_adapter_hits_per_s",
              "Fleet rate of requests served by an already-resident "
              "adapter", r,
              labels=("kind", "name"), fn=family("adapter_hits_rate"))
        Gauge("kaito:fleet_grammar_cache_hit_rate",
              "Fleet grammar compile-cache hit ratio for constrained "
              "requests (rate-weighted)", r,
              labels=("kind", "name"), fn=family("grammar_cache_hit_rate"))
        Gauge("kaito:fleet_prefill_tokens_per_s",
              "Fleet prompt-token prefill rate", r,
              labels=("kind", "name"), fn=family("prefill_tokens_rate"))
        Gauge("kaito:fleet_prefill_dispatches_per_s",
              "Fleet prefill dispatch rate (packed rounds count once)", r,
              labels=("kind", "name"), fn=family("prefill_dispatch_rate"))
        Gauge("kaito:fleet_prefill_pack_mean",
              "Mean sequences per prefill dispatch across the fleet "
              "(1.0 = serial; higher = packing engaged)", r,
              labels=("kind", "name"), fn=family("prefill_pack_mean"))
        Gauge("kaito:fleet_prefill_queue_wait_mean",
              "Mean staged-to-first-prefill-dispatch wait across the "
              "fleet (seconds)", r,
              labels=("kind", "name"), fn=family("prefill_queue_wait_mean"))
        Gauge("kaito:fleet_device_comm_pct",
              "Mean collective share of device wall across replicas "
              "sampling device profiles (engine/devprof.py)", r,
              labels=("kind", "name"), fn=family("device_comm_pct"))
        Gauge("kaito:fleet_device_overlap_pct",
              "Mean share of collective time hidden behind compute "
              "across sampling replicas", r,
              labels=("kind", "name"), fn=family("device_overlap_pct"))
        Gauge("kaito:fleet_device_idle_pct",
              "Mean idle share of device wall across sampling "
              "replicas", r,
              labels=("kind", "name"), fn=family("device_idle_pct"))

        def tenant_family(prefix):
            def _fn():
                out = {}
                with self._lock:
                    for k, agg in self._last_agg.items():
                        for ak, v in agg.items():
                            if ak.startswith(prefix):
                                tenant = ak[len(prefix):]
                                out[(k[0], k[2], tenant)] = v
                return out
            return _fn

        Gauge("kaito:fleet_tenant_served_per_s",
              "Fleet per-tenant completion rate (QoS engines only)", r,
              labels=("kind", "name", "tenant"),
              fn=tenant_family("tenant_served_rate:"))
        Gauge("kaito:fleet_tenant_shed_per_s",
              "Fleet per-tenant admission-shed rate (QoS engines only)",
              r, labels=("kind", "name", "tenant"),
              fn=tenant_family("tenant_shed_rate:"))

        def _states():
            with self._lock:
                return {(k[0], k[2]): SIGNAL_CODE[cr.state]
                        for k, cr in self._crs.items()}

        Gauge("kaito:fleet_signal_state",
              "Scaling signal per CR (0=idle 1=nominal 2=pressure "
              "3=saturated)", r, labels=("kind", "name"), fn=_states)

    def snapshot(self) -> dict:
        """The ``GET /debug/fleet`` payload."""
        now = self.time_fn()
        out: dict = {
            "interval_s": self.interval_s,
            "timeout_s": self.timeout_s,
            "freshness_s": round(self.freshness_s, 3),
            "policy": self.policy.to_dict(),
            "fleet": {},
        }
        with self._lock:
            keys = sorted(self._crs)
        for key in keys:
            with self._lock:
                cr = self._crs.get(key)
                if cr is None:
                    continue
                tmap = dict(self._targets.get(key, {}))
                smap = dict(self._samples.get(key, {}))
                agg = dict(self._last_agg.get(key, {}))
                decision = cr.last_decision
                state, since = cr.state, cr.state_since
                transitions = cr.transitions
                desired = cr.replicas_desired
            replicas = {}
            for url, t in sorted(tmap.items()):
                s = smap.get(url) or ReplicaSample()
                fresh = s.ts > 0 and now - s.ts <= self.freshness_s
                replicas[t.replica] = {
                    "url": url,
                    "role": t.role,
                    "fresh": fresh,
                    "age_s": round(now - s.ts, 3) if s.ts else None,
                    "scrape_seconds": round(s.scrape_seconds, 4),
                    "consecutive_failures": s.consecutive_failures,
                    "last_error": s.last_error,
                    "values": {k: round(v, 6)
                               for k, v in sorted(s.values.items())},
                    "rates": {k: round(v, 6)
                              for k, v in sorted(s.rates.items())},
                }
            kind, ns, name = key
            out["fleet"][f"{kind}/{ns}/{name}"] = {
                "kind": kind, "namespace": ns, "name": name,
                "replicas_desired": desired,
                "replicas_reporting": int(agg.get("replicas_reporting", 0)),
                "replicas": replicas,
                "last": {k: round(v, 6) for k, v in sorted(agg.items())},
                "windows": {
                    "60s": cr.window_stats(60.0),
                    "300s": cr.window_stats(300.0),
                },
                "signal": {
                    "state": state,
                    "since_s": round(now - since, 3),
                    "transitions": transitions,
                    "reason": decision.reason if decision else "",
                    "message": decision.message if decision else "",
                    "drivers": list(decision.drivers) if decision else [],
                    "recommended_replicas":
                        decision.recommended_replicas if decision else 0,
                },
            }
        return out

    # -- background loop -----------------------------------------------

    def start(self) -> None:
        """Run the scrape loop on a daemon thread (ticks every
        ``interval_s / 4`` so staggered phases land close to their due
        time; each tick only polls targets that are actually due)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(max(0.05, self.interval_s / 4.0)):
                try:
                    self.scrape_once(wait=False)
                except Exception:
                    logger.exception("fleet scrape round failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-telemetry")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
