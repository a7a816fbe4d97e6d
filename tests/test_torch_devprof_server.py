"""The device profiler's serving surface on the port's CPU server, against
the JAX server's contract.

- devprof off: ``/debug/device`` answers 403 and ``/metrics`` carries no
  ``kaito:device_*`` line;
- devprof on, the CPU engine decoding: the engine thread opens and
  closes the window, its buckets sum to 100, decode carries the phase
  time, ``/debug/device`` agrees with ``/metrics``;
- the port's ``kaito:device_*`` and ``kaito:host_kv_*`` exposition read by
  ``kaito_tpu.runtime.fleet.parse_replica_metrics`` folds to the JAX
  engine's values for the same window;
- ``/start_profile`` / ``/stop_profile``: the trace file, the 409s, the
  auto-stop, a sampler window skipped meanwhile, the timer cancelled at
  shutdown;
- the flight recorder's bundle carries the profiler's snapshot.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.metrics import EngineMetrics as JaxMetrics
from kaito_tpu.runtime.fleet import parse_replica_metrics
from kaito_tpu.utils.promtext import parse_exposition, parse_labels
from kaito_tpu_torch.engine import devprof as tdp
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.metrics import EngineMetrics
from kaito_tpu_torch.engine.server import make_server, parse_args
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(model="tiny-llama-test", max_model_len=256, page_size=16, max_num_seqs=2,
           dtype="float32", kv_dtype="float32", prefill_buckets=(32, 64, 128),
           enable_prefix_caching=False, seed=0)


class _Served:
    def __init__(self, **kw):
        self.cfg = EngineConfig(**{**CFG, **kw})
        self.eng = InferenceEngine(self.cfg, device="cpu")
        self.eng.start()
        self.server = make_server(self.eng, self.cfg, host="127.0.0.1", port=0,
                                  device="cpu")
        self.th = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.th.start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.eng.stop()
        self.th.join(timeout=10)


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _metrics(base):
    return _call(base + "/metrics")[1].decode()


@pytest.fixture
def off():
    srv = _Served()
    yield srv
    srv.close()


@pytest.fixture
def on(monkeypatch, tmp_path):
    monkeypatch.setenv("KAITO_PROFILE_DIR", str(tmp_path / "profiles"))
    # sampled by the tests (an hour between windows of the sampler's own)
    srv = _Served(devprof_interval_s=3600.0, devprof_window_s=0.3)
    yield srv
    srv.close()


def _decode_in_background(eng, n=400):
    req = eng.submit([4, 5, 6], SamplingParams(max_tokens=n, temperature=0.0,
                                               ignore_eos=True))
    t = threading.Thread(target=lambda: list(req.stream()), daemon=True)
    t.start()
    # the window should see decode steps only: wait for the first token
    for _ in range(600):
        if req.output_tokens:
            break
        time.sleep(0.01)
    return req, t


def test_devprof_off_is_403_and_has_no_device_families(off):
    assert off.eng.devprof is None
    status, raw = _call(off.base + "/debug/device")
    assert status == 403 and "--devprof-interval-s" in json.loads(raw)["error"]["message"]
    text = _metrics(off.base)
    assert "kaito:device_" not in text and "devprof" not in text


def test_window_on_a_decoding_cpu_engine(on):
    eng = on.eng
    assert eng.devprof.attached
    req, t = _decode_in_background(eng)
    try:
        summary = eng.devprof.sample_window()
    finally:
        eng.abort(req)
        t.join(timeout=60)
    assert summary is not None and summary["n_slices"] > 0
    assert sum(summary["bucket_pct"].values()) == pytest.approx(100.0, abs=0.01)
    # the window holds decode steps only, every operator under kaito/decode
    assert summary["phase_pct"]["decode"] > 0.0
    assert summary["phase_attributed_pct"] > 90.0
    assert summary["bucket_pct"]["matmul"] > 0.0
    assert summary["bucket_pct"]["attention"] > 0.0
    assert summary["window_tokens"] > 0
    assert not tdp.PROFILE_LOCK.locked()

    status, raw = _call(on.base + "/debug/device")
    assert status == 200
    dbg = json.loads(raw)
    assert dbg["windows_total"] == 1 and dbg["last"]["bucket_pct"] == summary["bucket_pct"]
    assert dbg["ring"] == [dbg["last"]]
    samples = parse_exposition(_metrics(on.base))
    vals = {n: v for n, labels, v in samples if not labels}
    assert vals["kaito:device_comm_pct"] == pytest.approx(dbg["last"]["comm_pct"])
    assert vals["kaito:device_idle_pct"] == pytest.approx(dbg["last"]["bucket_pct"]["idle"])
    assert vals["kaito:device_windows_total"] == 1.0
    assert vals["kaito:device_phase_attributed_pct"] == pytest.approx(
        dbg["last"]["phase_attributed_pct"])
    buckets = {parse_labels(labels)["bucket"]: v for n, labels, v in samples
               if n == "kaito:device_bucket_pct"}
    assert buckets == pytest.approx(dbg["last"]["bucket_pct"])
    phases = {parse_labels(labels)["phase"]: v for n, labels, v in samples
              if n == "kaito:device_phase_pct"}
    assert phases == pytest.approx(dbg["last"]["phase_pct"])
    assert vals["kaito:device_capture_seconds_count"] == 1.0


def test_fleet_fold_matches_the_jax_families():
    """One window summary in the port's profiler and in the JAX engine's:
    the fleet parser reads the same values from both expositions."""
    summary = tdp.summarize_window([
        tdp.Slice("all-reduce.1", "kaito/decode", 0.0, 4.0, "A"),
        tdp.Slice("dot.1", "kaito/decode", 0.0, 6.0, "B"),
        tdp.Slice("copy.1", "kaito/prefill", 6.0, 2.0, "B"),
    ], window_tokens=10.0, capture_s=0.25)
    jeng = JaxEngine(JaxConfig(**{**CFG, "devprof_interval_s": 3600.0}))
    teng = InferenceEngine(EngineConfig(**{**CFG, "devprof_interval_s": 3600.0,
                                            "host_kv_offload_bytes": 1 << 20}),
                           device="cpu")
    jeng.devprof.windows.append(summary)
    teng.devprof.windows.append(summary)
    jvals = parse_replica_metrics(JaxMetrics(jeng).registry.expose())
    tvals = parse_replica_metrics(EngineMetrics(teng).registry.expose())
    keys = {k for k in jvals if k.startswith(("device_", "host_kv"))}
    assert {"device_comm_pct", "device_overlap_pct", "device_idle_pct"} <= keys
    assert {k: tvals[k] for k in keys} == pytest.approx({k: jvals[k] for k in keys})
    assert tvals["device_comm_pct"] == pytest.approx(summary["comm_pct"])


def test_start_and_stop_profile(on):
    base, eng = on.base, on.eng
    assert _call(base + "/stop_profile", {})[0] == 409
    assert _call(base + "/start_profile", {"seconds": -1})[0] == 400
    status, raw = _call(base + "/start_profile", {})
    assert status == 200 and json.loads(raw)["status"] == "started"
    try:
        assert _call(base + "/start_profile", {})[0] == 409
        # a sampler window meanwhile is skipped, never stolen
        skipped = eng.devprof.windows_skipped
        assert eng.devprof.sample_window() is None
        assert eng.devprof.windows_skipped == skipped + 1
        assert _call(base + "/v1/completions", {"prompt": "x", "max_tokens": 4})[0] == 200
    finally:
        status, raw = _call(base + "/stop_profile", {})
    assert status == 200
    body = json.loads(raw)
    assert body["status"] == "stopped" and os.path.dirname(body["file"]) == body["dir"]
    with open(body["file"]) as f:
        doc = json.load(f)
    # the engine thread's ranges are in it: the trace was taken there
    names = {e.get("name") for e in doc["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"kaito/decode", "kaito/prefill"} <= names
    assert _call(base + "/stop_profile", {})[0] == 409
    assert not tdp.PROFILE_LOCK.locked()


def test_profile_auto_stop(on):
    base = on.base
    status, raw = _call(base + "/start_profile", {"seconds": 0.3})
    body = json.loads(raw)
    assert status == 200 and body["auto_stop_seconds"] == 0.3
    assert body["auto_stop_deadline"] > time.time() - 1
    for _ in range(200):
        if not on.server.state.trace.active:
            break
        time.sleep(0.05)
    assert not on.server.state.trace.active
    assert _call(base + "/stop_profile", {})[0] == 409
    assert [p for p in os.listdir(body["dir"]) if p.endswith(".trace.json")]
    # a timer pending at shutdown is cancelled
    assert _call(base + "/start_profile", {"seconds": 600})[0] == 200
    timer = on.server.state.profile_timer
    on.server.state.close()
    timer.join(timeout=10)
    assert on.server.state.profile_timer is None and not timer.is_alive()
    on.server.state.stop_profile()
    assert not tdp.PROFILE_LOCK.locked()


def test_flight_bundle_carries_the_snapshot(tmp_path):
    srv = _Served(devprof_interval_s=3600.0, devprof_window_s=0.0,
                  flight_dir=str(tmp_path))
    try:
        assert srv.eng.devprof.sample_window() is not None
        status, raw = _call(srv.base + "/debug/flight", {})
        assert status == 200
        name = json.loads(raw)["bundle"]
        bundle = json.loads(_call(f"{srv.base}/debug/flight/{name}")[1])
        assert bundle["devprof"]["windows_total"] == 1
        assert bundle["devprof"]["last"] == srv.eng.devprof.last()
    finally:
        srv.close()


def test_flags_and_environment(monkeypatch):
    cfg, _ = parse_args(["--devprof-interval-s", "2", "--devprof-window-s", "0.5"])
    assert (cfg.devprof_interval_s, cfg.devprof_window_s) == (2.0, 0.5)
    monkeypatch.setenv("KAITO_DEVPROF_INTERVAL_S", "7")
    monkeypatch.setenv("KAITO_DEVPROF_WINDOW_S", "0.125")
    cfg, _ = parse_args([])
    assert (cfg.devprof_interval_s, cfg.devprof_window_s) == (7.0, 0.125)
