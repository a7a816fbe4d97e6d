"""Control-plane observability: manager metrics + debug HTTP server.

The controller-runtime freebies the reference gets from kubebuilder
(``controller_runtime_reconcile_total`` et al.), rebuilt on our
dependency-free metrics layer: reconcile counters/durations per
controller, resync and watch-restart counters, per-CR condition-state
gauges, emitted-Event counters, and a ``RingTracer`` of reconcile
spans so a slow reconcile is diagnosable at ``/debug/trace`` exactly
the way a slow request is on the engine server.

``make_manager_server`` serves ``/metrics``, ``/debug/trace``,
``/debug/fleet`` (when a ``FleetTelemetry`` plane is attached) and
``/healthz`` on ``--metrics-port`` (the port the Helm chart already
exposes as the manager's ``metrics`` containerPort).

A copy of ``kaito_tpu.controllers.metrics``.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from kaito_tpu_torch.engine.metrics import Counter, Gauge, Histogram, Registry
from kaito_tpu_torch.utils.tracing import RingTracer, chrome_trace

logger = logging.getLogger(__name__)

# bucket spread for reconciles: sub-ms store round-trips up to
# multi-second full-plan passes
RECONCILE_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_COND_STATE = {"True": 1.0, "False": 0.0}

# kinds whose per-CR condition state is worth a gauge series
_CONDITION_KINDS = ("Workspace", "InferenceSet")


class ManagerMetrics:
    """One Registry + tracer per manager process."""

    def __init__(self, trace_capacity: int = 8192):
        self.registry = Registry()
        r = self.registry
        self.reconcile_total = Counter(
            "kaito:controller_reconcile_total",
            "Reconcile outcomes per controller", r,
            labels=("controller", "result"))
        self.reconcile_duration = Histogram(
            "kaito:controller_reconcile_duration_seconds",
            "Reconcile wall time per controller", r,
            buckets=RECONCILE_BUCKETS, labels=("controller",))
        self.resync_total = Counter(
            "kaito:controller_resync_total",
            "Full periodic resync passes", r)
        self.watch_restarts = Counter(
            "kaito:controller_watch_restarts_total",
            "Watch stream reconnects per kind", r, labels=("kind",))
        self.workspace_condition = Gauge(
            "kaito:workspace_condition",
            "Workspace condition state (1=True, 0=False, -1=Unknown)", r,
            labels=("name", "type"))
        self.inferenceset_condition = Gauge(
            "kaito:inferenceset_condition",
            "InferenceSet condition state (1=True, 0=False, -1=Unknown)", r,
            labels=("name", "type"))
        self._cond_gauges = {"Workspace": self.workspace_condition,
                             "InferenceSet": self.inferenceset_condition}
        self.tracer = RingTracer(trace_capacity)

    def observe_reconcile(self, controller: str, result: str,
                          seconds: float) -> None:
        self.reconcile_total.inc(controller=controller, result=result)
        self.reconcile_duration.observe(seconds, controller=controller)

    def attach_event_counter(self, recorder) -> None:
        """Scrape-time counter over the store's EventRecorder — emitted
        Events become a queryable series without double bookkeeping."""

        def _counts() -> dict:
            out: dict[tuple, float] = {}
            for ev in recorder.events():
                key = (ev.type, ev.reason)
                out[key] = out.get(key, 0.0) + ev.count
            return out

        Gauge("kaito:controller_events_total",
              "Events recorded per type and reason", self.registry,
              labels=("type", "reason"), fn=_counts)

    def refresh_conditions(self, store) -> None:
        """Rebuild the per-CR condition gauges from a full listing
        (called once per resync; deleted CRs drop out)."""
        for kind in _CONDITION_KINDS:
            gauge = self._cond_gauges[kind]
            gauge.clear()
            try:
                objs = store.list(kind)
            except Exception:
                continue
            for obj in objs:
                for c in getattr(obj.status, "conditions", []) or []:
                    gauge.set(_COND_STATE.get(c.status, -1.0),
                              name=obj.metadata.name, type=c.type)


class ManagerHandler(BaseHTTPRequestHandler):
    metrics: ManagerMetrics   # injected by make_manager_server
    fleet = None              # FleetTelemetry, when the manager runs one
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        mm = self.metrics
        if self.path == "/metrics":
            self._send(200, mm.registry.expose().encode(),
                       "text/plain; version=0.0.4")
        elif self.path.startswith("/debug/trace"):
            from urllib.parse import parse_qs, urlparse

            q = parse_qs(urlparse(self.path).query)
            tid = q.get("trace_id", [None])[0]
            payload = chrome_trace(mm.tracer.spans(tid))
            self._send(200, json.dumps(payload).encode(), "application/json")
        elif self.path == "/debug/fleet":
            if self.fleet is None:
                self._send(404, b'{"error": "fleet telemetry disabled"}',
                           "application/json")
            else:
                self._send(200, json.dumps(self.fleet.snapshot()).encode(),
                           "application/json")
        elif self.path == "/healthz":
            self._send(200, b'{"status": "ok"}', "application/json")
        else:
            self._send(404, b'{"error": "no route"}', "application/json")


def make_manager_server(metrics: ManagerMetrics, host: str = "0.0.0.0",
                        port: int = 8080, fleet=None) -> ThreadingHTTPServer:
    handler = type("Handler", (ManagerHandler,),
                   {"metrics": metrics, "fleet": fleet})
    return ThreadingHTTPServer((host, port), handler)


def start_manager_server(metrics: ManagerMetrics, host: str = "0.0.0.0",
                         port: int = 8080,
                         fleet=None) -> Optional[ThreadingHTTPServer]:
    """Spawn the metrics server on a daemon thread (None on bind
    failure — observability must not take the control plane down)."""
    try:
        server = make_manager_server(metrics, host, port, fleet=fleet)
    except OSError:
        logger.exception("manager metrics server bind failed on :%s", port)
        return None
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="manager-metrics").start()
    logger.info("manager metrics on :%s (/metrics, /debug/trace%s)",
                server.server_address[1],
                ", /debug/fleet" if fleet is not None else "")
    return server
