"""Incident flight recorder: bounded JSON bundles of every debug surface.

The port's own copy of ``kaito_tpu/utils/flightrec.py``, behind the
server's ``--flight-dir``.

When an SLO page, an engine-fatal error, or a SIGTERM-with-in-flight-
requests fires, the evidence an operator needs — the span ring, the
step timeline, the SLO burn snapshot, queue/
slot state — is normally gone by the time anyone attaches.  The flight
recorder snapshots all of it into one timestamped JSON bundle under
``--flight-dir`` at the moment of the trigger, so the black box
survives the pod.

Three automatic triggers (watched by :class:`FlightWatcher`):

- ``slo_page``     — any SLI's alert state transitions into ``page``
                     (deduped: one bundle per excursion, re-armed when
                     every SLI leaves ``page``),
- ``engine_fatal`` — the engine-fatal counter advances,
- ``sigterm``      — the server's SIGTERM handler calls
                     :meth:`FlightRecorder.record` directly when
                     requests are still in flight,

plus a manual one: ``POST /debug/flight``.

Bundles are bounded: beyond ``max_bundles`` the oldest (by mtime) are
pruned, LRU-style.  ``GET /debug/flight`` lists them; ``GET
/debug/flight/<name>`` fetches one; ``kaito:flight_bundles_total``
counts them.

Everything here is dependency-free and engine-agnostic: the recorder
takes a ``collect`` callable returning the bundle body, and
:func:`engine_flight_snapshot` is the canonical collector over an
InferenceEngine + SLOWatchdog pair.  All writes are atomic
(tmp + rename) so a scrape never sees a torn bundle.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)

SCHEMA = "kaito.flight/1"

# triggers (bundle["trigger"] and the filename tag)
TRIGGER_SLO_PAGE = "slo_page"
TRIGGER_ENGINE_FATAL = "engine_fatal"
TRIGGER_SIGTERM = "sigterm"
TRIGGER_MANUAL = "manual"

_SPAN_CAP = 2048      # newest spans kept per bundle
_STEP_CAP = 1024      # newest timeline records kept per bundle


def _safe(fn: Callable[[], object], fallback=None):
    """Debug surfaces must never take the incident path down."""
    try:
        return fn()
    except Exception as exc:      # pragma: no cover - defensive
        logger.warning("flight recorder surface failed: %s", exc)
        return fallback


class FlightRecorder:
    """Write bounded, timestamped JSON bundles under ``flight_dir``.

    ``collect`` returns the bundle body (the debug surfaces); the
    recorder adds the envelope (schema, trigger, reason, timestamps,
    sequence) and enforces the LRU bound.  Thread-safe: triggers can
    fire from the watcher thread, a handler thread, and the signal
    handler concurrently.
    """

    def __init__(self, flight_dir: str,
                 collect: Callable[[], dict],
                 max_bundles: int = 16,
                 time_fn: Callable[[], float] = time.time):
        if not flight_dir:
            raise ValueError("flight_dir must be a non-empty path")
        self.dir = flight_dir
        self.collect = collect
        self.max_bundles = max(1, int(max_bundles))
        self.time_fn = time_fn
        self._seq = 0
        self._lock = threading.Lock()
        self.bundles_total = 0
        os.makedirs(self.dir, exist_ok=True)

    # -- write ---------------------------------------------------------

    def record(self, trigger: str, reason: str = "") -> Optional[str]:
        """Snapshot every surface into one bundle; returns its name
        (or None if the write failed — incidents must not cascade)."""
        now = self.time_fn()
        with self._lock:
            self._seq += 1
            seq = self._seq
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(now))
        name = f"flight-{stamp}-{seq:04d}-{trigger}.json"
        bundle = {
            "schema": SCHEMA,
            "trigger": trigger,
            "reason": reason,
            "written_at": now,
            "written_at_iso": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                            time.gmtime(now)),
            "seq": seq,
        }
        body = _safe(self.collect, fallback={"collect_error": True})
        if isinstance(body, dict):
            bundle.update(body)
        try:
            path = os.path.join(self.dir, name)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(bundle, f, default=str)
            os.replace(tmp, path)
        except OSError as exc:
            logger.warning("flight bundle write failed: %s", exc)
            return None
        with self._lock:
            self.bundles_total += 1
        self._prune()
        logger.warning("flight bundle recorded: %s (trigger=%s%s)", name,
                       trigger, f", {reason}" if reason else "")
        return name

    def _prune(self) -> None:
        """LRU by mtime: keep the newest ``max_bundles`` bundles."""
        try:
            entries = []
            for n in os.listdir(self.dir):
                if n.startswith("flight-") and n.endswith(".json"):
                    p = os.path.join(self.dir, n)
                    entries.append((os.path.getmtime(p), p))
            entries.sort()
            for _, p in entries[:-self.max_bundles]:
                os.unlink(p)
        except OSError:      # pragma: no cover - fs race
            pass

    # -- read (the /debug/flight surface) ------------------------------

    def list(self) -> list[dict]:
        """Newest-first bundle index (name, bytes, mtime, trigger)."""
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for n in names:
            if not (n.startswith("flight-") and n.endswith(".json")):
                continue
            p = os.path.join(self.dir, n)
            try:
                st = os.stat(p)
            except OSError:
                continue
            # flight-<stamp>-<seq>-<trigger>.json
            trigger = n[:-5].split("-", 3)[-1] if n.count("-") >= 3 else ""
            out.append({"name": n, "bytes": st.st_size,
                        "mtime": st.st_mtime, "trigger": trigger})
        out.sort(key=lambda e: e["mtime"], reverse=True)
        return out

    def read(self, name: str) -> Optional[bytes]:
        """Fetch one bundle by name; traversal-safe (a name is a bare
        filename, never a path)."""
        if os.path.basename(name) != name or not (
                name.startswith("flight-") and name.endswith(".json")):
            return None
        try:
            with open(os.path.join(self.dir, name), "rb") as f:
                return f.read()
        except OSError:
            return None


class FlightWatcher:
    """Poll the SLO alert states and the engine-fatal counter; fire the
    recorder on transitions.  ``check()`` is the whole decision step and
    is directly drivable from tests; the thread just calls it on an
    interval.  The engine itself needs zero trigger wiring — the watcher
    observes the same surfaces an operator would.
    """

    def __init__(self, recorder: FlightRecorder,
                 slo_snapshot: Optional[Callable[[], dict]] = None,
                 fatal_count: Optional[Callable[[], int]] = None,
                 interval_s: float = 1.0):
        self.recorder = recorder
        self.slo_snapshot = slo_snapshot
        self.fatal_count = fatal_count
        self.interval_s = max(0.05, float(interval_s))
        self._paging = False           # dedupe: armed only outside page
        self._fatal_seen: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check(self) -> list[str]:
        """One poll; returns the names of any bundles written."""
        wrote = []
        if self.slo_snapshot is not None:
            snap = _safe(self.slo_snapshot, fallback={}) or {}
            alerts = snap.get("alerts") or {}
            paging = sorted(s for s, st in alerts.items() if st == "page")
            if paging and not self._paging:
                # one bundle per excursion into page, however many SLIs
                # join it while it lasts; re-armed when all leave
                name = self.recorder.record(
                    TRIGGER_SLO_PAGE, reason="paging: " + ", ".join(paging))
                if name:
                    wrote.append(name)
            self._paging = bool(paging)
        if self.fatal_count is not None:
            n = _safe(self.fatal_count, fallback=None)
            if n is not None:
                if self._fatal_seen is None:
                    self._fatal_seen = n   # baseline, not an incident
                elif n > self._fatal_seen:
                    name = self.recorder.record(
                        TRIGGER_ENGINE_FATAL,
                        reason=f"engine_fatal_total {self._fatal_seen} "
                               f"-> {n}")
                    if name:
                        wrote.append(name)
                    self._fatal_seen = n
        return wrote

    def start(self) -> None:
        if self._thread is not None:
            return

        def _run():
            while not self._stop.wait(self.interval_s):
                _safe(self.check)

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="kaito-flight-watch")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)


def config_fingerprint(cfg) -> dict:
    """Stable digest + full dump of the engine config, so two bundles
    from differently-configured replicas are distinguishable at a
    glance."""
    try:
        import dataclasses
        values = dataclasses.asdict(cfg)
    except Exception:
        values = {k: v for k, v in vars(cfg).items()
                  if not k.startswith("_")}
    blob = json.dumps(values, sort_keys=True, default=str)
    return {"sha256": hashlib.sha256(blob.encode()).hexdigest()[:16],
            "values": json.loads(blob)}


def engine_flight_snapshot(engine, slo=None, cfg=None) -> dict:
    """The canonical ``collect`` over an engine + watchdog: every debug
    surface the server exposes, flattened into one JSON-safe dict.
    Each surface is collected defensively — a wedged engine must still
    produce a (partial) bundle."""
    body: dict = {}
    if slo is not None:
        body["slo"] = _safe(slo.snapshot)

    spans = [{"name": s.name, "trace_id": s.trace_id, "t0": s.t0,
              "dur": s.dur, "attrs": s.attrs}
             for s in _safe(engine.tracer.spans, fallback=[]) or []]
    body["spans"] = spans[-_SPAN_CAP:]
    body["spans_dropped"] = (int(engine.tracer.dropped)
                             + max(0, len(spans) - _SPAN_CAP))
    body["timeline"] = (_safe(engine.timeline.records, fallback=[])
                        or [])[-_STEP_CAP:]
    dp = getattr(engine, "devprof", None)
    body["devprof"] = _safe(dp.snapshot) if dp is not None else None
    body["queue"] = {
        "running": int(_safe(lambda: engine.num_running, fallback=0) or 0),
        "waiting": int(_safe(lambda: engine.num_waiting, fallback=0) or 0),
    }
    slots = []
    for i, slot in enumerate(engine.slots):
        req = slot.request
        if req is None:
            continue
        slots.append(_safe(lambda r=req, s=slot, j=i: {
            "slot": j, "req_id": r.req_id, "trace_id": r.trace_id,
            "tenant": r.tenant, "position": int(s.position),
            "remaining": int(s.remaining),
            "output_tokens": len(r.output_tokens),
        }))
    body["slots"] = [s for s in slots if s]
    body["counters"] = _safe(lambda: dict(engine.counters), fallback={})
    if engine.qos is not None:
        body["qos_classes"] = _safe(lambda: sorted(engine.qos.classes))
    if cfg is not None:
        body["config"] = _safe(lambda: config_fingerprint(cfg))
    return body
