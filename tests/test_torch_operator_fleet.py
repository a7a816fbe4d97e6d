"""The port's fleet telemetry plane (``runtime/fleet.py``) and autoscaler
(``controllers/autoscaler.py``) against the JAX package's, on the CPU.

Every scenario of ``tests/test_fleet.py`` and ``tests/test_autoscaler.py``
(their fast tier) runs through both packages on an injected clock, fed
the recorded expositions those tests use: payload folds, counter rates
with restart detection, the pure evaluator's ``SignalDecision``s and
replica hints, discovery, ingest -> fold -> gauges, the ring, the
``ScalingSignal`` condition and its events, the concurrent scraper
against a hung target, the ``/debug/fleet`` route; the autoscaler's
stabilization, cooldown, caps, minimum, drain, flap, scale-to-zero and
wake, warm pools, the EPP drain args and the node-count guard.  After
every step the stored objects and events (normalised as in
``tests/test_torch_operator_workspace.py``), the
decision and the exported gauges of both packages are equal.

A GPU set's warm NodePool is the A3 one its next replica takes.

The port's server exposes every family the JAX fleet folds that the JAX
engine's server exposes: both servers serve ``tiny-llama-real`` on the
CPU, take the same requests, and each one's ``/metrics`` bytes fold
through both fleets to the same samples.
"""

import dataclasses
import importlib
import json
import os
import socket
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_fleet import ENGINE_PAYLOAD, PREFILL_PAYLOAD, TENANT_PAYLOAD
from tests.test_torch_operator_workspace import (  # noqa: F401 (autouse fixture)
    _offline_fetchers,
    _snapshot,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(root: str) -> types.SimpleNamespace:
    mods = {name: importlib.import_module(f"{root}.{path}") for name, path in (
        ("api", "api"), ("ws", "api.workspace"), ("iset", "api.inferenceset"),
        ("meta", "api.meta"), ("objects", "controllers.objects"),
        ("runtime", "controllers.runtime"), ("fleet", "runtime.fleet"),
        ("asc", "controllers.autoscaler"), ("isetc", "controllers.inferenceset"),
        ("manager", "controllers.manager"), ("metrics", "controllers.metrics"),
        ("engine_metrics", "engine.metrics"), ("karpenter", "provision.karpenter"),
        ("epp", "manifests.epp"))}
    return types.SimpleNamespace(**mods)


JAX, PORT = _pkg("kaito_tpu"), _pkg("kaito_tpu_torch")
KEY = ("InferenceSet", "default", "fleet")


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


def _decision(d):
    return None if d is None else dataclasses.asdict(d)


def _expose(p, ft, asc=None) -> str:
    reg = p.engine_metrics.Registry()
    ft.register_metrics(reg)
    if asc is not None:
        asc.register_metrics(reg)
    return reg.expose()


def _state(p, store, ft, asc=None, key=KEY) -> dict:
    """What both packages must agree on after a step."""
    sig = ft.signal(key)
    return dict(store=_snapshot(store), gauges=_expose(p, ft, asc),
                signal=None if sig is None else (sig[0], sig[1], _decision(sig[2])),
                agg=ft.last_aggregate(key))


# ---------------------------------------------------------------------------
# tests/test_fleet.py
# ---------------------------------------------------------------------------

def _fl_policy(p, **kw):
    base = dict(sustain_s=10.0, idle_sustain_s=30.0, min_samples=2,
                min_window_coverage=0.8)
    base.update(kw)
    return p.fleet.FleetPolicy(**base)


HIGH = {"occupancy_mean": 0.95, "replicas_reporting": 2.0}
MID = {"occupancy_mean": 0.70, "replicas_reporting": 2.0}
LOW = {"occupancy_mean": 0.10, "queue_sum": 0.5, "replicas_reporting": 2.0,
       "requests_rate": 1.0}
DEEP = {"kv_mean": 0.99, "replicas_reporting": 2.0}
QUIET_AGG = {"requests_rate": 0.0, "queue_sum": 0.0, "active_slots": 0.0,
             "replicas_reporting": 1.0}


def _series(now, spec):
    return [(now - age, s) for age, s in spec]


def fl_parse_and_rates(p):
    out = {n: p.fleet.parse_replica_metrics(t) for n, t in (
        ("engine", ENGINE_PAYLOAD), ("tenant", TENANT_PAYLOAD), ("prefill", PREFILL_PAYLOAD))}
    clock = Clock()
    ft = p.fleet.FleetTelemetry(p.runtime.Store(), time_fn=clock)
    prev = p.fleet.ReplicaSample(ts=clock() - 10.0, values={
        "requests_total": 100.0, "uptime_s": 50.0, "tenant_shed_total:free": 3.0,
        "prefill_packed_seqs_total": 0.0, "prefill_dispatches_total": 0.0,
        "prompt_tokens_total": 0.0})
    out["rates"] = [ft._rates(prev, v, clock()) for v in (
        {"requests_total": 130.0, "uptime_s": 60.0},
        {"requests_total": 4.0, "uptime_s": 2.0},
        dict(out["prefill"], uptime_s=60.0),
        {"tenant_shed_total:free": 8.0, "uptime_s": 60.0})]
    out["no_prev"] = ft._rates(p.fleet.ReplicaSample(), {"requests_total": 4.0}, clock())
    return out


def fl_evaluator(p):
    pol, now = _fl_policy(p), 100.0
    f = p.fleet
    cases = [
        (f.SIGNAL_NOMINAL, [(1.0, HIGH)], pol),
        (f.SIGNAL_NOMINAL, [(9.0, HIGH), (5.0, HIGH), (1.0, HIGH)], pol),
        (f.SIGNAL_NOMINAL, [(9.0, MID), (5.0, MID), (1.0, MID)], pol),
        (f.SIGNAL_PRESSURE, [(9.0, MID), (5.0, MID), (1.0, MID)], pol),
        (f.SIGNAL_PRESSURE, [(9.0, LOW), (5.0, LOW), (1.0, LOW)], pol),
        (f.SIGNAL_NOMINAL, [(9.0, DEEP), (5.0, DEEP), (1.0, DEEP)], pol),
        (f.SIGNAL_SATURATED, [(9.0, MID), (5.0, MID), (1.0, MID)], pol),
        (f.SIGNAL_SATURATED, [(9.0, LOW), (5.0, LOW), (1.0, LOW)], pol),
        (f.SIGNAL_NOMINAL, [(29.0, QUIET_AGG), (15.0, QUIET_AGG), (1.0, QUIET_AGG)], pol),
        (f.SIGNAL_IDLE, [(29.0, QUIET_AGG), (15.0, QUIET_AGG),
                         (0.5, dict(QUIET_AGG, requests_rate=2.0))], pol),
        ("bogus", [(9.0, HIGH), (1.0, HIGH)], pol),
    ]
    decisions = [_decision(f.evaluate_signal(prev, _series(now, spec), pol_, now, 3))
                 for prev, spec, pol_ in cases]
    hints = [f.recommend_replicas(st, n, pol_) for st, n, pol_ in (
        (f.SIGNAL_NOMINAL, 3, pol), (f.SIGNAL_PRESSURE, 3, pol), (f.SIGNAL_SATURATED, 4, pol),
        (f.SIGNAL_IDLE, 3, pol), (f.SIGNAL_IDLE, 3, _fl_policy(p, scale_to_zero_hint=True)),
        (f.SIGNAL_SATURATED, 4, _fl_policy(p, max_replicas_hint=5)),
        (f.SIGNAL_PRESSURE, 0, pol))]
    return dict(decisions=decisions, hints=hints)


def _service(p, name, port=5000, annotations=None):
    return p.objects.Unstructured(
        "Service", p.api.ObjectMeta(name=name, annotations=annotations or {}),
        spec={"ports": [{"port": port}]})


def fl_discovery(p):
    store = p.runtime.Store()
    store.create(p.api.InferenceSet(p.api.ObjectMeta(name="fleet"),
                                    p.api.InferenceSetSpec(replicas=2)))
    for i in range(2):
        store.create(p.api.Workspace(p.api.ObjectMeta(
            name=f"fleet-{i}", labels={p.ws.LABEL_CREATED_BY_INFERENCESET: "fleet"})))
        store.create(_service(p, f"fleet-{i}", port=5000 + i))
    store.create(_service(p, "fleet-epp"))
    store.create(p.api.Workspace(p.api.ObjectMeta(
        name="solo", annotations={p.fleet.ANNOTATION_SCRAPE_URL: "http://127.0.0.1:7777/"})))
    store.create(p.api.Workspace(p.api.ObjectMeta(name="bare")))
    ft = p.fleet.FleetTelemetry(store)

    def targets():
        return {"/".join(k): {u: dataclasses.asdict(t) for u, t in sorted(m.items())}
                for k, m in sorted(ft._targets.items())}

    ft.refresh_targets()
    before = targets()
    store.delete("Workspace", "default", "solo")
    ft.refresh_targets()
    return dict(before=before, after=targets())


def fl_fold_and_gauges(p):
    clock = Clock()
    ft = p.fleet.FleetTelemetry(p.runtime.Store(), time_fn=clock)
    ft.ingest(KEY, "http://r0:5000", {"occupancy": 1.0, "waiting": 4.0, "kv_usage": 0.5,
                                      "requests_total": 100.0},
              rates={"requests_rate": 2.0, "prefix_hits_rate": 3.0,
                     "prefix_misses_rate": 1.0}, replica="r0")
    ft.ingest(KEY, "http://r1:5000", {"occupancy": 0.5, "waiting": 1.0, "kv_usage": 0.3,
                                      "requests_total": 40.0},
              rates={"requests_rate": 1.0, "tenant_shed_rate:free": 0.5}, replica="r1")
    qos = ("InferenceSet", "default", "qos")
    ft.ingest(qos, "http://q0:5000", {"waiting": 0.0}, rates={
        "tenant_shed_rate:free": 0.5, "tenant_served_rate:acme": 1.0}, replica="q0")
    pack = ("InferenceSet", "default", "pack")
    vals = p.fleet.parse_replica_metrics(PREFILL_PAYLOAD)
    ft.ingest(pack, "http://p0:5000", vals, rates={
        "prompt_tokens_rate": 409.6, "prefill_packed_seqs_rate": 3.0,
        "prefill_dispatches_rate": 1.0, "prefill_wait_seconds_rate": 0.04,
        "prefill_waits_rate": 0.8}, replica="p0")
    ft.ingest(("InferenceSet", "default", "front"), "http://e:5000", {},
              rates={"received_rate": 2.0, "forwarded_rate": 1.5}, role="epp", replica="e")
    ft.fold()
    first = dict(aggs={"/".join(k): a for k, a in sorted(ft._last_agg.items())},
                 gauges=_expose(p, ft))
    clock.tick(ft.freshness_s + 1.0)
    ft.ingest(KEY, "http://r1:5000", {"occupancy": 0.5, "waiting": 1.0}, replica="r1")
    ft.fold()
    return dict(first=first, stale=ft._last_agg[KEY], gauges=_expose(p, ft))


def fl_ring(p):
    clock = Clock()
    ft = p.fleet.FleetTelemetry(p.runtime.Store(), max_window_s=30.0, time_fn=clock)
    key = ("Workspace", "default", "solo")
    for _ in range(10):
        ft.ingest(key, "http://r0:5000", {"waiting": 1.0}, replica="r0")
        ft.fold()
        clock.tick(10.0)
    cr = ft._crs[key]
    return dict(samples=cr.samples, w30=cr.window_stats(30.0), w5=cr.window_stats(5.0))


def _drive_fold(ft, clock, key, values, rounds, dt=4.0, rps=1.0, epp_rps=None):
    for _ in range(rounds):
        clock.tick(dt)
        ft.ingest(key, "http://r0:5000", values, rates={"requests_rate": rps},
                  replica="r0")
        if epp_rps is not None:
            ft.ingest(key, "http://epp:5000", {}, rates={"received_rate": epp_rps},
                      role="epp", replica="epp")
        ft.fold()
        ft.apply_signals()


def fl_condition_and_events(p):
    clock = Clock()
    store = p.runtime.Store()
    store.create(p.api.InferenceSet(p.api.ObjectMeta(name="fleet"),
                                    p.api.InferenceSetSpec(replicas=1)))
    ft = p.fleet.FleetTelemetry(store, policy=_fl_policy(p), time_fn=clock)
    steps = []
    for values, rounds in (({"occupancy": 0.95, "waiting": 9.0, "kv_usage": 0.2}, 5),
                           ({"occupancy": 0.95, "waiting": 9.0, "kv_usage": 0.2}, 3),
                           ({"occupancy": 0.05, "waiting": 0.0, "kv_usage": 0.1}, 6)):
        _drive_fold(ft, clock, KEY, values, rounds)
        steps.append(_state(p, store, ft))
    steps.append(ft._crs[KEY].transitions)
    return steps


def fl_no_telemetry(p):
    clock = Clock()
    store = p.runtime.Store()
    store.create(p.api.InferenceSet(p.api.ObjectMeta(name="fleet"),
                                    p.api.InferenceSetSpec(replicas=1)))
    ft = p.fleet.FleetTelemetry(store, time_fn=clock)
    ft.ingest(KEY, "http://r0:5000", {"occupancy": 0.2}, replica="r0")
    clock.tick(ft.freshness_s + 1.0)
    ft.fold()
    ft.apply_signals()
    return _state(p, store, ft)


def fl_flight_bundles(p):
    """A replica's flight-recorder count advancing past the baseline
    becomes one FlightRecorded Event."""
    clock = Clock()
    store = p.runtime.Store()
    store.create(p.api.InferenceSet(p.api.ObjectMeta(name="fleet"),
                                    p.api.InferenceSetSpec(replicas=1)))
    ft = p.fleet.FleetTelemetry(store, policy=_fl_policy(p), time_fn=clock)
    for n in (2.0, 2.0, 3.0, 3.0):
        _drive_fold(ft, clock, KEY, {"occupancy": 0.3, "flight_bundles": n}, 1)
    return _state(p, store, ft)


FLEET_SCENARIOS = {"parse-and-rates": fl_parse_and_rates, "evaluator": fl_evaluator,
                   "discovery": fl_discovery, "fold-and-gauges": fl_fold_and_gauges,
                   "ring": fl_ring, "condition-and-events": fl_condition_and_events,
                   "no-telemetry": fl_no_telemetry, "flight-bundles": fl_flight_bundles}


@pytest.mark.parametrize("name", list(FLEET_SCENARIOS))
def test_fleet_scenario_matches_the_jax_fleet(name):
    want = FLEET_SCENARIOS[name](JAX)
    got = FLEET_SCENARIOS[name](PORT)
    assert got == want
    # the scenario did what its JAX test says
    if name == "parse-and-rates":
        assert got["engine"]["requests_total"] == 10.0 and got["rates"][1] == {
            "requests_rate": 0.0}
    if name == "evaluator":
        states = [d["state"] for d in got["decisions"]]
        assert states[:8] == ["nominal", "pressure", "nominal", "pressure", "nominal",
                              "saturated", "pressure", "nominal"]
        assert got["hints"] == [3, 4, 6, 1, 0, 5, 2]
    if name == "condition-and-events":
        store = got[-2]["store"]
        assert [e["reason"] for e in store["events"]] == [
            "FleetPressureDetected", "FleetPressureResolved"]
        assert got[-1] == 2
    if name == "no-telemetry":
        cond = got["store"]["objects"]["InferenceSet"]["default/fleet"]["status"][
            "conditions"][0]
        assert (cond["status"], cond["reason"]) == ("Unknown", "NoTelemetry")
    if name == "flight-bundles":
        assert [e["reason"] for e in got["store"]["events"]] == ["FlightRecorded"]


class _FakeEngine(BaseHTTPRequestHandler):
    """A replica answering the recorded exposition and an SLO snapshot."""

    def log_message(self, *a):
        pass

    def do_GET(self):
        if self.path == "/metrics":
            body = ENGINE_PAYLOAD.encode()
        elif self.path == "/debug/slo":
            body = json.dumps({"burn_max": 0.5, "role": "decode",
                               "burn_rates": {"itl_p99": {"fast": 0.25}}}).encode()
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture(scope="module")
def replicas():
    """A live fake replica and a hung one (accepts, never answers)."""
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _FakeEngine)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    hung = socket.socket()
    hung.bind(("127.0.0.1", 0))
    hung.listen(4)
    yield srv.server_address[1], hung.getsockname()[1]
    srv.shutdown()
    srv.server_close()
    hung.close()


def _scrape_run(p, ports):
    store = p.runtime.Store()
    store.create(p.api.InferenceSet(p.api.ObjectMeta(name="fleet"),
                                    p.api.InferenceSetSpec(replicas=2)))
    for i, port in enumerate(ports):
        store.create(p.api.Workspace(p.api.ObjectMeta(
            name=f"fleet-{i}", labels={p.ws.LABEL_CREATED_BY_INFERENCESET: "fleet"},
            annotations={p.fleet.ANNOTATION_SCRAPE_URL: f"http://127.0.0.1:{port}"})))
    ft = p.fleet.FleetTelemetry(store, interval_s=0.2, timeout_s=0.5)
    ft.refresh_targets()
    t0 = time.monotonic()
    polled = [ft.scrape_once(force=True, wait=True), ft.scrape_once(force=True, wait=True)]
    took = time.monotonic() - t0
    snap = ft.snapshot()["fleet"]["InferenceSet/default/fleet"]
    for rep in snap["replicas"].values():
        for k in ("age_s", "scrape_seconds"):
            rep.pop(k)
        rep["values"].pop("uptime_s", None)
    snap["signal"].pop("since_s")
    snap.pop("windows")
    return dict(polled=polled, snap=snap, agg=ft.last_aggregate(KEY)), took


def test_scraper_hung_target_degrades_only_itself_as_in_jax(replicas):
    want, _ = _scrape_run(JAX, replicas)
    got, took = _scrape_run(PORT, replicas)
    assert took < 5.0
    # the hung target's error text names its own timeout in both
    assert got["snap"]["replicas"]["fleet-1"]["last_error"] \
        == want["snap"]["replicas"]["fleet-1"]["last_error"]
    assert got == want
    healthy = got["snap"]["replicas"]["fleet-0"]
    assert healthy["fresh"] and healthy["values"]["burn_max"] == 0.5
    assert healthy["values"]["role_burn:decode"] == 0.5
    assert healthy["values"]["itl_burn_max"] == 0.25
    assert not got["snap"]["replicas"]["fleet-1"]["fresh"]
    assert got["agg"]["replicas_reporting"] == 1.0


@pytest.mark.parametrize("p", [JAX, PORT], ids=["jax", "port"])
def test_manager_debug_fleet_route(p):
    mgr = p.manager.Manager()
    mgr.store.create(p.api.InferenceSet(p.api.ObjectMeta(name="fleet"),
                                        p.api.InferenceSetSpec(replicas=1)))
    mgr.resync()
    srv = p.metrics.make_manager_server(mgr.metrics, host="127.0.0.1", port=0,
                                        fleet=mgr.fleet)
    bare = p.metrics.make_manager_server(mgr.metrics, host="127.0.0.1", port=0)
    for s in (srv, bare):
        threading.Thread(target=s.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(base + "/debug/fleet", timeout=5) as r:
            snap = json.loads(r.read())
        assert "policy" in snap and "fleet" in snap
        with urllib.request.urlopen(base + "/metrics", timeout=5) as r:
            assert "kaito:fleet_signal_state" in r.read().decode()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(
                f"http://127.0.0.1:{bare.server_address[1]}/debug/fleet", timeout=5)
        assert e.value.code == 404
    finally:
        for s in (srv, bare):
            s.shutdown()
            s.server_close()


# ---------------------------------------------------------------------------
# tests/test_autoscaler.py
# ---------------------------------------------------------------------------

A_HIGH = {"occupancy": 0.95, "waiting": 8.0, "kv_usage": 0.5, "active_slots": 2.0}
A_LOW = {"occupancy": 0.10, "waiting": 0.0, "kv_usage": 0.10, "active_slots": 1.0}
A_QUIET = {"occupancy": 0.0, "waiting": 0.0, "kv_usage": 0.0, "active_slots": 0.0}


def _as_policy(p, **kw):
    base = dict(sustain_s=10.0, idle_sustain_s=10.0, min_samples=2,
                min_window_coverage=0.8)
    base.update(kw)
    return p.fleet.FleetPolicy(**base)


def _a_template(p, instance="ct5lp-hightpu-1t", preset="phi-4-mini-instruct"):
    return p.iset.WorkspaceTemplate(resource=p.api.ResourceSpec(instance_type=instance),
                                    inference=p.api.InferenceSpec(preset=preset))


def _a_iset(p, replicas=1, autoscale=None, template=None, **spec_kw):
    return p.api.InferenceSet(p.api.ObjectMeta(name="fleet"), p.api.InferenceSetSpec(
        replicas=replicas, template=template or _a_template(p),
        autoscale=autoscale or p.iset.AutoscalePolicy(), **spec_kw))


def _rig(p, iset, provision=False):
    clock = Clock()
    store = p.runtime.Store()
    store.create(iset)
    ft = p.fleet.FleetTelemetry(store, policy=_as_policy(p), time_fn=clock)
    prov = p.karpenter.KarpenterTPUProvisioner(store) if provision else None
    asc = p.asc.AutoscalerController(store, ft, provisioner=prov, time_fn=clock)
    return store, ft, asc, clock


def _with_children(p, store, n, ready=()):
    for i in range(n):
        ws = p.api.Workspace(p.api.ObjectMeta(
            name=f"fleet-{i}", labels={p.ws.LABEL_CREATED_BY_INFERENCESET: "fleet"}))
        if i in ready:
            p.meta.set_condition(ws.status.conditions, p.meta.Condition(
                type=p.ws.COND_INFERENCE_READY, status="True", reason="Ready",
                message=""))
        store.create(ws)


def _steps(p, store, ft, asc, clock, plan, rec=None):
    """Run ``plan``: (values, rounds, kwargs) drives then one tick, each
    step's state recorded."""
    out = []
    for values, rounds, kw in plan:
        if values is not None:
            _drive_fold(ft, clock, KEY, values, rounds, **kw)
        asc.tick()
        if rec is not None:
            rec.reconcile(store.get("InferenceSet", "default", "fleet"))
        out.append(_state(p, store, ft, asc))
    return out


def as_stabilization_and_cooldown(p):
    pol = p.iset.AutoscalePolicy(enabled=True, max_replicas=4, scale_up_stabilization_s=20.0,
                                 scale_up_cooldown_s=120.0, warm_pool=0)
    store, ft, asc, clock = _rig(p, _a_iset(p, autoscale=pol))
    return _steps(p, store, ft, asc, clock, [(A_HIGH, 4, {}), (A_HIGH, 5, {}),
                                             (A_HIGH, 3, {}), (A_HIGH, 30, {})])


def as_capped_by_max(p):
    pol = p.iset.AutoscalePolicy(enabled=True, max_replicas=1, scale_up_stabilization_s=0.0,
                                 scale_up_cooldown_s=0.0, warm_pool=0)
    store, ft, asc, clock = _rig(p, _a_iset(p, autoscale=pol))
    return _steps(p, store, ft, asc, clock, [(A_HIGH, 6, {})])


def as_minimum_and_disabled(p):
    store, ft, asc, clock = _rig(p, _a_iset(p, replicas=0, autoscale=p.iset.AutoscalePolicy(
        enabled=True, min_replicas=2)))
    out = _steps(p, store, ft, asc, clock, [(None, 0, {})])

    def off(o):
        o.spec.autoscale.enabled = False
    p.runtime.update_with_retry(store, "InferenceSet", "default", "fleet", off)
    return out + _steps(p, store, ft, asc, clock, [(None, 0, {}), (None, 0, {})])


def _idle_policy(p, **kw):
    base = dict(enabled=True, min_replicas=1, idle_grace_s=12.0,
                scale_down_stabilization_s=0.0, scale_down_cooldown_s=0.0,
                drain_grace_s=15.0, warm_pool=0)
    base.update(kw)
    return p.iset.AutoscalePolicy(**base)


def as_drain_then_commit(p):
    store, ft, asc, clock = _rig(p, _a_iset(p, replicas=2, autoscale=_idle_policy(p)))
    _with_children(p, store, 2, ready=(0, 1))
    q = {"rps": 0.0}
    return _steps(p, store, ft, asc, clock, [(A_QUIET, 4, q), (A_QUIET, 3, q),
                                             (A_QUIET, 1, q), (A_QUIET, 4, q)])


def as_flap_cancels_drain(p):
    store, ft, asc, clock = _rig(p, _a_iset(p, replicas=2, autoscale=_idle_policy(p)))
    _with_children(p, store, 2, ready=(0, 1))
    return _steps(p, store, ft, asc, clock, [(A_QUIET, 7, {"rps": 0.0}), (A_HIGH, 1, {})])


def as_scale_to_zero_and_wake(p):
    pol = _idle_policy(p, min_replicas=0, scale_to_zero=True, idle_grace_s=10.0,
                       drain_grace_s=5.0)
    store, ft, asc, clock = _rig(p, _a_iset(p, replicas=1, autoscale=pol))
    _with_children(p, store, 1, ready=(0,))
    q = {"rps": 0.0, "epp_rps": 0.0}
    out = _steps(p, store, ft, asc, clock, [(A_QUIET, 7, q), (A_QUIET, 2, q),
                                            (A_QUIET, 2, q)])
    clock.tick(4.0)
    ft.ingest(KEY, "http://epp:5000", {}, rates={"received_rate": 2.0}, role="epp",
              replica="epp")
    ft.fold()
    ft.apply_signals()
    return out + _steps(p, store, ft, asc, clock, [(None, 0, {})])


def as_warm_pool_then_gc(p, instance="ct5lp-hightpu-1t", preset="phi-4-mini-instruct"):
    pol = p.iset.AutoscalePolicy(enabled=True, max_replicas=3, warm_pool=1,
                                 warm_pool_gc_s=30.0, scale_up_stabilization_s=3600.0)
    store, ft, asc, clock = _rig(p, _a_iset(p, autoscale=pol, template=_a_template(
        p, instance, preset)), provision=True)
    _with_children(p, store, 1, ready=(0,))
    return _steps(p, store, ft, asc, clock, [(A_HIGH, 4, {}), (A_HIGH, 1, {}),
                                             (A_LOW, 4, {}), (A_LOW, 8, {})])


def as_warm_pool_adopted(p):
    pol = p.iset.AutoscalePolicy(enabled=True, max_replicas=3, warm_pool=1,
                                 warm_pool_gc_s=0.0, scale_up_stabilization_s=3600.0)
    store, ft, asc, clock = _rig(p, _a_iset(p, autoscale=pol), provision=True)
    _with_children(p, store, 1, ready=(0,))
    out = _steps(p, store, ft, asc, clock, [(A_HIGH, 4, {})])
    store.create(p.api.Workspace(p.api.ObjectMeta(
        name="fleet-1", labels={p.ws.LABEL_CREATED_BY_INFERENCESET: "fleet"})))
    return out + _steps(p, store, ft, asc, clock, [(A_LOW, 4, {})])


def as_drain_through_epp(p):
    store, ft, asc, clock = _rig(p, _a_iset(p, replicas=2, autoscale=_idle_policy(p)))
    rec = p.isetc.InferenceSetReconciler(store, gateway_api_enabled=True)
    rec.reconcile(store.get("InferenceSet", "default", "fleet"))
    q = {"rps": 0.0}
    return _steps(p, store, ft, asc, clock, [(A_QUIET, 7, q), (A_QUIET, 5, q)], rec=rec)


def as_epp_command_and_guards(p):
    out = dict(cmd=p.epp.build_epp_command(
        ["http://a:5000", "http://b:5000"], draining=["http://b:5000"],
        plugins_config={"plugins": [{"type": "pd-filter"}]}, block_chars=64,
        kv_pool=True, adapter_affinity=True))
    store = p.runtime.Store()
    store.create(_a_iset(p, replicas=4))
    for i in (0, 3):
        store.create(p.api.Workspace(p.api.ObjectMeta(
            name=f"fleet-{i}", labels={p.ws.LABEL_CREATED_BY_INFERENCESET: "fleet"})))
    p.isetc.InferenceSetReconciler(store).reconcile(store.get("InferenceSet", "default",
                                                              "fleet"))
    out["sparse"] = _snapshot(store)
    falcon = _a_template(p, "ct5lp-hightpu-4t", "falcon-40b")
    store = p.runtime.Store()
    store.create(_a_iset(p, replicas=5, node_count_limit=5, template=falcon))
    p.isetc.InferenceSetReconciler(store).reconcile(store.get("InferenceSet", "default",
                                                              "fleet"))
    out["guard"] = _snapshot(store)
    pol = p.iset.AutoscalePolicy(enabled=True, max_replicas=8, warm_pool=0)
    iset = _a_iset(p, node_count_limit=5, autoscale=pol, template=falcon)
    store = p.runtime.Store()
    store.create(iset)
    asc = p.asc.AutoscalerController(store, p.fleet.FleetTelemetry(store, time_fn=Clock()))
    out["cap"] = asc._replica_cap(iset, pol, [])
    return out


def as_hint_from_spec(p):
    pol = p.iset.AutoscalePolicy(enabled=True, min_replicas=0, scale_to_zero=True,
                                 max_replicas=5)
    clock = Clock()
    store = p.runtime.Store()
    store.create(_a_iset(p, replicas=2, autoscale=pol))
    store.create(p.api.Workspace(p.api.ObjectMeta(
        name="fleet-0", labels={p.ws.LABEL_CREATED_BY_INFERENCESET: "fleet"},
        annotations={p.fleet.ANNOTATION_SCRAPE_URL: "http://r0:5000"})))
    ft = p.fleet.FleetTelemetry(store, policy=_as_policy(p), time_fn=clock)
    ft.refresh_targets()
    _drive_fold(ft, clock, KEY, A_QUIET, 7, rps=0.0)
    return _state(p, store, ft)


def as_manager_gate(p):
    off = p.manager.Manager().autoscaler
    mgr = p.manager.Manager(feature_gates="autoscaler=true,enableInferenceSetController=true")
    mgr.resync()
    fams = sorted({ln.split()[2] for ln in mgr.metrics.registry.expose().splitlines()
                   if ln.startswith("# TYPE")})
    return dict(off=off, on=type(mgr.autoscaler).__name__, families=fams)


AUTOSCALER_SCENARIOS = {
    "stabilization-and-cooldown": as_stabilization_and_cooldown,
    "capped-by-max": as_capped_by_max, "minimum-and-disabled": as_minimum_and_disabled,
    "drain-then-commit": as_drain_then_commit, "flap-cancels-drain": as_flap_cancels_drain,
    "scale-to-zero-and-wake": as_scale_to_zero_and_wake,
    "warm-pool-then-gc": as_warm_pool_then_gc, "warm-pool-adopted": as_warm_pool_adopted,
    "drain-through-epp": as_drain_through_epp,
    "epp-command-and-guards": as_epp_command_and_guards,
    "hint-from-spec": as_hint_from_spec, "manager-gate": as_manager_gate}


def _replicas(step) -> int:
    return step["store"]["objects"]["InferenceSet"]["default/fleet"]["spec"]["replicas"]


@pytest.mark.parametrize("name", list(AUTOSCALER_SCENARIOS))
def test_autoscaler_scenario_matches_the_jax_autoscaler(name):
    want = AUTOSCALER_SCENARIOS[name](JAX)
    got = AUTOSCALER_SCENARIOS[name](PORT)
    assert got == want
    # the scenario did what its JAX test says
    if name == "stabilization-and-cooldown":
        assert [_replicas(s) for s in got] == [1, 2, 2, 3]
    if name == "drain-then-commit":
        assert [_replicas(s) for s in got] == [2, 2, 2, 1]
    if name == "scale-to-zero-and-wake":
        assert [_replicas(s) for s in got] == [1, 0, 0, 1]
    if name == "warm-pool-then-gc":
        assert "default/fleet-1" not in got[0]["store"]["objects"]["Workspace"]
        assert "/fleet-1-slice-0" in got[0]["store"]["objects"]["NodePool"]
        assert "/fleet-1-slice-0" not in got[-1]["store"]["objects"].get("NodePool", {})
    if name == "epp-command-and-guards":
        assert got["cap"] == 2 and len(got["guard"]["objects"]["Workspace"]) == 2
    if name == "manager-gate":
        assert got["off"] is None and "kaito:autoscaler_desired_replicas" in got["families"]


def test_gpu_sets_warm_pool_is_the_a3_one():
    """Pressure on a GPU set renders its next replica's NodePool through
    the port's plan and provisioner: the A3 machine type and its card."""
    steps = as_warm_pool_then_gc(PORT, "a3-highgpu-1g", "llama-3.1-8b-instruct")
    pools = steps[0]["store"]["objects"]["NodePool"]
    spec = pools["/fleet-1-slice-0"]["spec"]["template"]["spec"]
    assert {r["key"]: r["values"] for r in spec["requirements"]} == {
        "cloud.google.com/gke-accelerator": ["nvidia-h100-80gb"],
        "node.kubernetes.io/instance-type": ["a3-highgpu-1g"]}
    assert spec["taints"][0]["key"] == "nvidia.com/gpu"
    labels = pools["/fleet-1-slice-0"]["metadata"]["labels"]
    assert labels["kaito-tpu.io/warm-pool-for"] == "fleet"
    assert "/fleet-1-slice-0" not in steps[-1]["store"]["objects"].get("NodePool", {})


# ---------------------------------------------------------------------------
# the families the fleet folds, on two live servers
# ---------------------------------------------------------------------------

SERVE = dict(model="tiny-llama-real", max_model_len=256, dtype="float32", kv_dtype="float32",
             weights_dir=os.path.join(REPO, "checkpoints", "tiny-llama-real"))


def _serve_and_scrape(make, engine) -> bytes:
    engine.start()
    srv = make(engine)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        for i, body in enumerate(({"prompt": "the fleet folds", "max_tokens": 4},
                                  {"prompt": "the fleet folds", "max_tokens": 4},
                                  {"prompt": "another prompt here", "max_tokens": 3})):
            req = urllib.request.Request(
                base + "/v1/completions",
                data=json.dumps(dict(body, temperature=0.0, ignore_eos=True)).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.status == 200
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            return r.read()
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()
        t.join(timeout=10)


@pytest.fixture(scope="module")
def payloads():
    from kaito_tpu.engine.config import EngineConfig as JaxConfig
    from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
    from kaito_tpu.engine.server import make_server as jax_make_server
    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.engine import InferenceEngine
    from kaito_tpu_torch.engine.server import make_server

    jax = _serve_and_scrape(
        lambda e: jax_make_server(e, JaxConfig(**SERVE), host="127.0.0.1", port=0),
        JaxEngine(JaxConfig(**SERVE)))
    port = _serve_and_scrape(
        lambda e: make_server(e, EngineConfig(**SERVE), host="127.0.0.1", port=0,
                              device="cpu"),
        InferenceEngine(EngineConfig(**SERVE), device="cpu"))
    return jax.decode(), port.decode()


def _folded_families(p) -> set:
    f = p.fleet
    return set(f._ENGINE_GAUGES) | set(f._ENGINE_COUNTERS) | set(f._EPP_COUNTERS) \
        | set(f._TENANT_COUNTERS)


def test_port_server_exposes_every_family_the_fleet_folds(payloads):
    from kaito_tpu.utils.promtext import parse_exposition

    jax_text, port_text = payloads
    folded = _folded_families(JAX)
    assert _folded_families(PORT) == folded
    exposed = {name for name, _, _ in parse_exposition(jax_text)} & folded
    port_exposed = {name for name, _, _ in parse_exposition(port_text)}
    assert exposed - port_exposed == set()
    # the samples the fleet keeps: each server's bytes fold the same
    # through both fleets, to the same keys from either server
    for text in (jax_text, port_text):
        assert PORT.fleet.parse_replica_metrics(text) \
            == JAX.fleet.parse_replica_metrics(text)
    jax_keys = set(JAX.fleet.parse_replica_metrics(jax_text))
    port_keys = set(JAX.fleet.parse_replica_metrics(port_text))
    assert jax_keys == port_keys
    assert {"occupancy", "waiting", "kv_usage", "active_slots", "slots_total",
            "requests_total", "gen_tokens_total", "prompt_tokens_total",
            "prefill_dispatches_total"} <= port_keys
    vals = PORT.fleet.parse_replica_metrics(port_text)
    assert (vals["requests_total"], vals["gen_tokens_total"]) == (3.0, 11.0)
