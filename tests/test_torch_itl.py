"""The port's ITL recorder and the watchdog's per-tenant and ITL SLIs.

- With ``itl_enabled`` the engine stamps every token it retires:
  ``kaito:inter_token_latency_seconds`` counts tokens - 1 a request on
  the single-step, windowed and async paths, and the observer the
  server wires (``SLOWatchdog.observe_itl``) sees each gap with its
  tenant.
- ``kaito:itl_stalls_total`` counts the gaps above ``slo_itl_p99_ms``
  (the stamps' clock injected as ``_itl_time``).
- With ITL off, ``/metrics`` and ``/debug/slo`` hold no ITL or tenant
  series, and the server's families are the JAX server's with the same
  config; with ITL and QoS on they are too.
- The port's ``SLOWatchdog`` and the JAX package's, fed one series on
  one fake clock with tenants and ITL on, give equal snapshots and
  equal ``kaito:slo_*`` expositions.
"""

import json
import random
import re
import threading
import urllib.request

import pytest

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.metrics import Registry as JaxRegistry
from kaito_tpu.engine.server import make_server as jax_make_server
from kaito_tpu.runtime.slo import SLOTargets as JaxTargets
from kaito_tpu.runtime.slo import SLOWatchdog as JaxWatchdog
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.metrics import Registry
from kaito_tpu_torch.engine.server import make_server
from kaito_tpu_torch.runtime.slo import SLOTargets, SLOWatchdog
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

BASE = dict(model="tiny-llama-test", max_model_len=256, page_size=16,
            max_num_seqs=4, dtype="float32", kv_dtype="float32",
            prefill_buckets=(32, 64, 128), seed=0,
            enable_prefix_caching=False)
PROMPTS = [[(k * i) % 1900 + 2 for i in range(9 + 7 * k)] for k in (3, 5, 7)]
QOS = json.dumps({"classes": {"guaranteed": {"priority": 100, "weight": 8},
                              "best-effort": {"priority": 0}},
                  "tenants": {"acme": "guaranteed"},
                  "default_class": "best-effort"})


class FakeClock:
    def __init__(self, t=1000.0, step=0.0):
        self.t, self.step = t, step

    def __call__(self):
        self.t += self.step
        return self.t


def _greedy(n):
    return SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True)


def _drive(eng, reqs, max_steps=3000):
    for _ in range(max_steps):
        eng.step()
        if all(r.finish_reason for r in reqs):
            break
    eng._drain_pipeline()
    assert all(r.finish_reason for r in reqs)


@pytest.mark.parametrize("loop", ["single", "window", "async"])
def test_stamps_count_tokens_minus_one_a_request(loop):
    kw = {"single": dict(decode_run_ahead=1), "window": dict(decode_run_ahead=4),
          "async": dict(decode_run_ahead=4, async_dispatch=True)}[loop]
    eng = InferenceEngine(EngineConfig(**{**BASE, **kw, "itl_enabled": True}),
                          device="cpu")
    seen = []
    eng.itl_observer = lambda gap, tenant: seen.append((gap, tenant))
    reqs = [eng.submit(p, _greedy(n), tenant=t)
            for p, n, t in zip(PROMPTS, (5, 17, 30), ("a", "b", ""))]
    _drive(eng, reqs)
    assert [len(r.output_tokens) for r in reqs] == [5, 17, 30]
    assert eng.itl_hist.count == sum(n - 1 for n in (5, 17, 30)) == len(seen)
    assert sorted({t for _, t in seen}) == ["", "a", "b"]
    assert all(g >= 0 for g, _ in seen)
    assert all(r.last_emit_time is not None for r in reqs)


@pytest.mark.parametrize("target_ms,stalls", [(250.0, 0), (50.0, 12)])
def test_stall_counter_follows_the_itl_target(target_ms, stalls):
    eng = InferenceEngine(EngineConfig(**{**BASE, "itl_enabled": True,
                                          "slo_itl_p99_ms": target_ms}), device="cpu")
    eng._itl_time = FakeClock(step=0.1)     # every stamp 100 ms after the last
    req = eng.submit(PROMPTS[0], _greedy(13))
    _drive(eng, [req])
    assert eng.itl_hist.count == 12
    assert eng.counters["itl_stalls_total"] == stalls


def test_itl_off_and_env_gate(monkeypatch):
    eng = InferenceEngine(EngineConfig(**BASE), device="cpu")
    assert eng.itl_hist is None and "itl_stalls_total" not in eng.counters
    monkeypatch.setenv("KAITO_ITL", "1")
    on = InferenceEngine(EngineConfig(**BASE), device="cpu")
    assert on.itl_enabled and on.itl_hist is not None


# ---------------------------------------------------------------------------
# the served surface with ITL off and on
# ---------------------------------------------------------------------------

def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.read().decode()


def _complete(base, tenant=""):
    req = urllib.request.Request(base + "/v1/completions", data=json.dumps(
        {"prompt": "itl gaps", "max_tokens": 6, "temperature": 0.0,
         "ignore_eos": True}).encode(), headers={"Content-Type": "application/json",
                                                 "X-Kaito-Tenant": tenant})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _types(text):
    return dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))


def _serve(make, engine, cfg, **kw):
    srv = make(engine, cfg, host="127.0.0.1", port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.mark.parametrize("extra", [{}, {"itl_enabled": True, "qos_config": QOS}],
                         ids=["off", "itl-and-qos"])
def test_served_families_match_the_jax_server(extra):
    cfg = dict(model="tiny-llama-test", max_model_len=256, **extra)
    jeng, teng = JaxEngine(JaxConfig(**cfg)), InferenceEngine(EngineConfig(**cfg),
                                                              device="cpu")
    jeng.start()
    teng.start()
    jsrv, jbase = _serve(jax_make_server, jeng, JaxConfig(**cfg))
    tsrv, tbase = _serve(make_server, teng, EngineConfig(**cfg), device="cpu")
    try:
        for base in (jbase, tbase):
            _complete(base, tenant="acme")
        jtext, ttext = _get(jbase, "/metrics"), _get(tbase, "/metrics")
        jslo, tslo = json.loads(_get(jbase, "/debug/slo")), json.loads(
            _get(tbase, "/debug/slo"))
    finally:
        for srv, eng in ((jsrv, jeng), (tsrv, teng)):
            srv.shutdown()
            srv.server_close()
            eng.stop()
    assert _types(ttext) == _types(jtext)
    assert set(tslo) == set(jslo) and set(tslo["sli"]["fast"]) == set(jslo["sli"]["fast"])
    assert set(tslo["burn_rates"]) == set(jslo["burn_rates"])
    if not extra:
        assert not [f for f in _types(ttext) if "itl" in f or "inter_token" in f]
        assert "tenant=" not in ttext and "tenants" not in tslo
        assert "itl_p99" not in tslo["burn_rates"]
        assert not [k for k in tslo["sli"]["fast"] if k.startswith("itl")]
    else:
        assert "kaito:inter_token_latency_seconds_count 5" in ttext
        assert 'kaito:requests_served_total{tenant="acme"} 1' in ttext
        assert tslo["tenants"]["acme"]["itl_samples"] == 5
        assert tslo["sli"]["fast"]["itl_samples"] == 5


# ---------------------------------------------------------------------------
# the watchdog against the JAX package's
# ---------------------------------------------------------------------------

def _feed(wd, clock, seed):
    rnd = random.Random(seed)
    for _ in range(300):
        clock.t += rnd.choice((0.5, 3.0, 40.0, 400.0))
        kind = rnd.randrange(5)
        tenant = rnd.choice(("", "acme", "free", "meter"))
        if kind == 0:
            wd.observe_ttft(rnd.uniform(0.01, 2.0), tenant=tenant)
        elif kind == 1:
            wd.observe_itl(rnd.uniform(0.001, 0.6), tenant=tenant)
        elif kind == 2:
            wd.note_shed(rnd.randint(1, 3), tenant=tenant)
        elif kind == 3:
            wd.note_tokens(rnd.randint(0, 500))
        else:
            class R:
                pass
            r = R()
            r.submit_time = clock.t - 1.0
            r.first_token_time = clock.t - rnd.uniform(0.0, 0.9)
            r.finish_time = clock.t
            r.output_tokens = [1] * rnd.randint(0, 9)
            r.finish_reason = rnd.choice(("stop", "length", "error", "deadline"))
            r.tenant = tenant
            wd.observe_request(r)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("per_tenant,itl", [(True, True), (True, False),
                                            (False, True), (False, False)])
def test_watchdog_snapshots_equal_the_jax_package(seed, per_tenant, itl):
    jclock, tclock = FakeClock(), FakeClock()
    kw = dict(chips=2, per_tenant=per_tenant, itl_enabled=itl, role="decode")
    jwd = JaxWatchdog(targets=JaxTargets(itl_p99_s=0.2), time_fn=jclock, **kw)
    twd = SLOWatchdog(targets=SLOTargets(itl_p99_s=0.2), time_fn=tclock, **kw)
    _feed(jwd, jclock, seed)
    _feed(twd, tclock, seed)
    assert twd.snapshot() == jwd.snapshot()
    if per_tenant:
        assert twd.tenant_snapshot() == jwd.tenant_snapshot()
    jreg, treg = JaxRegistry(), Registry()
    jwd.register_metrics(jreg)
    twd.register_metrics(treg)
    assert treg.expose() == jreg.expose()
