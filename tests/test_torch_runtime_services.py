"""The port's runtime services around the engine against the JAX
package's, on the CPU: the data-parallel front, the health checks, the
self-benchmark probe and the hub fetch.

- ``tests/test_dp_router.py``'s cases over two in-process port servers
  on ``tiny-llama-real`` behind the port's ``DPRouter``: round robin
  spreads requests, greedy output is the same whichever replica
  answers, SSE relays through the front, a replica marked down costs a
  skipped turn and no failed request.
- ``runtime/health.py`` under the same environments as the JAX module
  (ordinal from ``TPU_WORKER_ID`` and the hostname, leader ``/health``,
  coordinator reachability, ``main``'s line and exit code).
- ``tests/test_runtime_probes.py``'s probe against a port server and a
  JAX server: both emit the ``KAITO_BENCHMARK_CONFIG`` and
  ``KAITO_BENCHMARK_RESULT`` lines with the same keys.
- ``fetch_from_hub`` from a fake snapshot in a temporary, offline hub
  cache copies the same tree as the JAX fetch, and a ``hub://``
  adapter source installs through the port's server.
"""

import io
import json
import os
import socket
import threading
import urllib.request
from contextlib import redirect_stdout

import pytest

from kaito_tpu.runtime import benchmark_probe as jax_probe
from kaito_tpu.runtime import health as jax_health
from kaito_tpu.runtime import weight_fetch as jax_fetch
from kaito_tpu_torch.runtime import benchmark_probe as probe
from kaito_tpu_torch.runtime import health
from kaito_tpu_torch.runtime import weight_fetch as fetch
from tests.helpers.hub_cache import fake_snapshot, offline_hub
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(model="tiny-llama-real",
            weights_dir=os.path.join(REPO, "checkpoints", "tiny-llama-real"),
            max_model_len=256, page_size=16, max_num_seqs=4, dtype="float32",
            kv_dtype="float32", prefill_buckets=(64, 128, 256), seed=0)


def _post(url, body, timeout=240.0):
    req = urllib.request.Request(url, json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _serve_port(**over):
    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.engine import InferenceEngine
    from kaito_tpu_torch.engine.server import make_server

    cfg = EngineConfig(**{**TINY, **over})
    eng = InferenceEngine(cfg, device="cpu")
    eng.start()
    srv = make_server(eng, cfg, host="127.0.0.1", port=0, device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return eng, srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _close(eng, srv):
    srv.shutdown()
    srv.server_close()
    eng.stop()


# ---------------------------------------------------------------------------
# the data-parallel front (tests/test_dp_router.py:32-79)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dp():
    from kaito_tpu_torch.runtime.dp_router import DPRouter, make_router_server

    served = [_serve_port() for _ in range(2)]
    urls = [u for _, _, u in served]
    router = DPRouter(urls)
    front = make_router_server(router, "127.0.0.1", 0)
    threading.Thread(target=front.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{front.server_address[1]}", urls, router
    front.shutdown()
    front.server_close()
    for eng, srv, _ in served:
        _close(eng, srv)


def test_dp_round_robin_spreads_requests(dp):
    router_url, backend_urls, _ = dp
    outs = [_post(router_url + "/v1/completions",
                  {"prompt": f"dp req {i}", "max_tokens": 4, "temperature": 0,
                   "ignore_eos": True})[1] for i in range(4)]
    assert all(o["usage"]["completion_tokens"] == 4 for o in outs)
    stats = json.loads(urllib.request.urlopen(router_url + "/router/stats",
                                              timeout=10).read())
    assert all(stats[u]["served"] >= 2 for u in backend_urls), stats


def test_dp_greedy_determinism_across_replicas(dp):
    router_url, backend_urls, _ = dp
    body = {"prompt": "deterministic across replicas", "max_tokens": 6,
            "temperature": 0}
    texts = [_post(router_url + "/v1/completions", body)[1]["choices"][0]["text"]
             for _ in range(2)]
    direct = [_post(u + "/v1/completions", body)[1]["choices"][0]["text"]
              for u in backend_urls]
    assert texts[0] == texts[1] == direct[0] == direct[1]


def test_dp_streaming_relays_through_router(dp):
    router_url, _, _ = dp
    req = urllib.request.Request(
        router_url + "/v1/completions",
        json.dumps({"prompt": "stream me", "max_tokens": 4, "temperature": 0,
                    "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    events, saw_done = [], False
    with urllib.request.urlopen(req, timeout=240) as r:
        assert r.headers.get("X-Request-Id")
        for line in r:
            line = line.decode().strip()
            if line == "data: [DONE]":
                saw_done = True
            elif line.startswith("data: "):
                events.append(json.loads(line[len("data: "):]))
    assert len(events) >= 2 and saw_done
    assert any(e["choices"][0].get("finish_reason") for e in events)


def test_dp_survives_replica_death(dp):
    router_url, _, router = dp
    router.backends[0].mark_down()
    try:
        outs = [_post(router_url + "/v1/completions",
                      {"prompt": f"failover {i}", "max_tokens": 3, "temperature": 0,
                       "ignore_eos": True})[1] for i in range(2)]
        assert all(o["usage"]["completion_tokens"] == 3 for o in outs)
    finally:
        router.backends[0].down_until = 0.0


# ---------------------------------------------------------------------------
# health (runtime/health.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env", [{"TPU_WORKER_ID": "3"}, {"HOSTNAME": "ws-abc-2"},
                                 {"HOSTNAME": "leader"}, {"HOSTNAME": "ws-0"}],
                         ids=["worker-id", "ordinal", "no-ordinal", "zero"])
def test_pod_ordinal_matches_jax(monkeypatch, env):
    monkeypatch.delenv("TPU_WORKER_ID", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert health.pod_ordinal() == jax_health.pod_ordinal()


def test_health_checks_match_jax():
    eng, srv, url = _serve_port()
    closed = socket.socket()
    closed.bind(("127.0.0.1", 0))
    dead = f"127.0.0.1:{closed.getsockname()[1]}"      # bound, never listening
    try:
        hostport = url[len("http://"):]
        cases = []
        for m in (health, jax_health):
            out = [m.leader_http_healthy(url), m.leader_http_healthy(f"http://{dead}"),
                   m.coordinator_reachable(hostport), m.coordinator_reachable(dead)]
            for argv in (["--role", "leader", "--base-url", url],
                         ["--role", "leader", "--base-url", f"http://{dead}"],
                         ["--role", "worker", "--coordinator", hostport],
                         ["--role", "worker", "--coordinator", dead],
                         ["--role", "worker"]):
                buf = io.StringIO()
                with redirect_stdout(buf):
                    rc = m.main(argv)
                out.append((rc, json.loads(buf.getvalue())))
            cases.append(out)
        assert cases[0] == cases[1]
        assert cases[0][:4] == [True, False, True, False]
        assert [rc for rc, _ in cases[0][4:]] == [0, 1, 0, 1, 0]
    finally:
        closed.close()
        _close(eng, srv)


# ---------------------------------------------------------------------------
# the self-benchmark probe (tests/test_runtime_probes.py:28-49)
# ---------------------------------------------------------------------------

def _jax_served():
    from kaito_tpu.engine.config import EngineConfig
    from kaito_tpu.engine.engine import InferenceEngine
    from kaito_tpu.engine.server import make_server

    cfg = EngineConfig(**TINY)
    eng = InferenceEngine(cfg)
    eng.start()
    srv = make_server(eng, cfg, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return eng, srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _probe_lines(module, url, sink):
    assert module.wait_healthy(url, 30)
    result = module.run_benchmark(url, duration_s=2, input_len=64, output_len=16,
                                  concurrency=2, sink=str(sink))
    assert result["generation_tokens"] > 0 and result["total_tpm"] > 0
    assert result["errors"] == 0
    line = sink.read_text()
    assert line.startswith("KAITO_BENCHMARK_RESULT")
    return result, json.loads(line[len("KAITO_BENCHMARK_RESULT"):])


def test_benchmark_probe_lines_match_jax(tmp_path):
    eng, srv, url = _serve_port()
    try:
        concurrency = probe.derive_concurrency(url, 64, 16)
        result, line = _probe_lines(probe, url, tmp_path / "port.log")
        # the CONFIG line's tag and framing (the run's own is overwritten
        # in its sink by the RESULT line, as the JAX probe's is)
        probe._emit("KAITO_BENCHMARK_CONFIG", {"k": 1}, str(tmp_path / "cfg.log"))
    finally:
        _close(eng, srv)
    jeng, jsrv, jurl = _jax_served()
    try:
        jconcurrency = jax_probe.derive_concurrency(jurl, 64, 16)
        jresult, jline = _probe_lines(jax_probe, jurl, tmp_path / "jax.log")
    finally:
        jsrv.shutdown()
        jeng.stop()
    assert concurrency == jconcurrency
    assert set(result) == set(jresult) and set(line) == set(jline)
    assert line == result
    assert (tmp_path / "cfg.log").read_text() == 'KAITO_BENCHMARK_CONFIG{"k": 1}\n'


def test_benchmark_probe_main_exits_by_its_result(tmp_path):
    eng, srv, url = _serve_port()
    try:
        rc = probe.main(["--base-url", url, "--duration", "1", "--input-len", "32",
                         "--output-len", "4", "--concurrency", "1",
                         "--sink", str(tmp_path / "sink")])
        assert rc == 0
        assert (tmp_path / "sink").read_text().startswith("KAITO_BENCHMARK_RESULT")
    finally:
        _close(eng, srv)
    assert probe.main(["--base-url", "http://127.0.0.1:1", "--health-deadline", "0",
                       "--sink", str(tmp_path / "none")]) == 1


# ---------------------------------------------------------------------------
# the hub fetch (runtime/weight_fetch.py) and the hub:// adapter source
# ---------------------------------------------------------------------------

def _tree(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


def test_fetch_from_hub_copies_the_jax_tree(monkeypatch, tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    for name, data in (("config.json", b'{"a": 1}'), ("model.safetensors", b"\x00" * 64),
                       ("tokenizer.json", b"{}"), ("sub" + os.sep + "nested.json", b"[]")):
        (src / name).write_bytes(data)
    offline_hub(monkeypatch, tmp_path / "hub")
    fake_snapshot(tmp_path / "hub", "acme/model", src)
    assert fetch.fetch_from_hub("acme/model", str(tmp_path / "port")) == 0
    assert jax_fetch.fetch_from_hub("acme/model", str(tmp_path / "jax")) == 0
    got = _tree(tmp_path / "port")
    assert got == _tree(tmp_path / "jax")
    assert sorted(got) == ["config.json", "model.safetensors", "tokenizer.json"]
    outs = []
    for m, dest in ((fetch, "port-main"), (jax_fetch, "jax-main")):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = m.main(["--model-id", "acme/model", "--dest", str(tmp_path / dest)])
        outs.append((rc, json.loads(buf.getvalue())["status"]))
        buf = io.StringIO()
        with redirect_stdout(buf):
            outs.append(m.main(["--model-id", "acme/missing",
                                "--dest", str(tmp_path / "none")]))
    assert outs[:2] == outs[2:] == [(0, "ok"), 1]


def test_hub_adapter_installs_through_the_port_server(monkeypatch, tmp_path):
    """``POST /v1/adapters`` with a ``hub://`` source inside the
    allowlist pulls the snapshot and hot-loads it (200 with the slot);
    the adapter then serves, with the greedy text a local install of the
    same artifact gives."""
    from kaito_tpu.models import get_model_by_name as jax_model
    from tests.helpers.lora_adapters import make_adapter

    art = tmp_path / "art"
    make_adapter(art, jax_model("tiny-llama-real").arch, seed=31, r=4, alpha=6,
                 base="tiny-llama-real", scale=4.0)
    offline_hub(monkeypatch, tmp_path / "hub")
    fake_snapshot(tmp_path / "hub", "acme/lora", art)
    eng, srv, url = _serve_port(adapter_slots=2, adapter_rmax=8,
                                adapter_source_allowlist="hub://acme/")
    try:
        status, out = _post(url + "/v1/adapters", {"name": "h", "source": "hub://acme/lora"})
        assert status == 200 and out["loaded"] == "h"
        status, _ = _post(url + "/v1/adapters", {"name": "local", "source": str(art)})
        assert status == 200
        body = {"prompt": "the cat sat on the", "max_tokens": 8, "temperature": 0.0}
        texts = {m: _post(url + "/v1/completions", {**body, "model": m})[1]
                 ["choices"][0]["text"] for m in ("h", "local", "tiny-llama-real")}
        assert texts["h"] == texts["local"] != texts["tiny-llama-real"]
    finally:
        _close(eng, srv)
