"""The port's observability surface against the JAX server's.

A JAX server and a port server, both on ``tiny-llama-test`` with the
default ``EngineConfig`` on the CPU, take the same requests (a repeated
prompt, so the prefix cache hits, and a streamed chat).  Both
``/metrics`` pages parse with the reference's ``parse_exposition`` and
show the same families, types and label names; the deterministic
counters are equal; the port's histograms are cumulative
(``check_histograms``).  ``/debug/trace?trace_id=`` returns the JAX
server's span names for an ``X-Request-Id``, which both echo;
``/debug/timeline`` holds one record per non-idle engine step;
``/debug/slo`` has the JAX server's keys; ``/debug/flight`` answers 403
without a directory and writes a bundle with one.
"""

import json
import re
import threading
import urllib.error
import urllib.request

import pytest

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.server import make_server as jax_make_server
from kaito_tpu.utils.promtext import (check_histograms, parse_exposition,
                                      parse_labels)
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine
from kaito_tpu_torch.engine.server import make_server, parse_args
from kaito_tpu_torch.utils import promtext as port_promtext
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(model="tiny-llama-test", max_model_len=256)
PROMPT = "the prefix cache shares whole pages of a prompt " * 3
# (X-Request-Id, body) sent to both servers in this order
REQUESTS = (
    ("rid-cold", {"prompt": PROMPT, "max_tokens": 5}),
    ("rid-warm", {"prompt": PROMPT, "max_tokens": 5}),
    ("rid-other", {"prompt": "a different prompt", "max_tokens": 3}),
)


def _call(url, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


class _Served:
    def __init__(self, server, engine):
        self.server, self.engine = server, engine
        self.base = f"http://127.0.0.1:{server.server_address[1]}"
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.engine.stop()
        self.thread.join(timeout=10)


def _drive_requests(srv):
    out = {}
    for rid, body in REQUESTS:
        out[rid] = _call(srv.base + "/v1/completions",
                         dict(body, temperature=0.0, ignore_eos=True),
                         {"X-Request-Id": rid})
    status, headers, raw = _call(srv.base + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
        "temperature": 0.0, "ignore_eos": True, "stream": True},
        {"X-Request-Id": "rid-stream"})
    assert status == 200 and raw.rstrip().endswith(b"data: [DONE]")
    out["rid-stream"] = (status, headers, raw)
    return out


def _steps(engine):
    """Count the engine loop's non-idle steps (the scheduler's own
    return value)."""
    engine.nonidle_steps = 0
    inner = engine._step_sync

    def counted():
        did = inner()
        engine.nonidle_steps += bool(did)
        return did
    engine._step_sync = counted


@pytest.fixture(scope="module")
def servers():
    jeng = JaxEngine(JaxConfig(**CFG))
    jeng.start()
    jsrv = _Served(jax_make_server(jeng, JaxConfig(**CFG), host="127.0.0.1",
                                   port=0), jeng)
    teng = InferenceEngine(EngineConfig(**CFG), device="cpu")
    _steps(teng)
    teng.start()
    tsrv = _Served(make_server(teng, EngineConfig(**CFG), host="127.0.0.1",
                               port=0, device="cpu"), teng)
    responses = {"jax": _drive_requests(jsrv), "torch": _drive_requests(tsrv)}
    yield jsrv, tsrv, responses
    jsrv.close()
    tsrv.close()


def _metrics(srv):
    status, headers, raw = _call(srv.base + "/metrics")
    assert status == 200 and headers["Content-Type"] == "text/plain; version=0.0.4"
    return raw.decode()


def _families(text):
    types = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))
    labels = {}
    for name, lbl, _ in parse_exposition(text):
        fam = next((f for f in (name, re.sub(r"_(bucket|sum|count)$", "", name))
                    if f in types), name)
        labels.setdefault(fam, set()).update(set(parse_labels(lbl)) - {"le"})
    return types, labels


def test_metrics_families_match_the_jax_server(servers):
    jsrv, tsrv, _ = servers
    jtext, ttext = _metrics(jsrv), _metrics(tsrv)
    jtypes, jlabels = _families(jtext)
    ttypes, tlabels = _families(ttext)
    assert ttypes == jtypes
    assert tlabels == jlabels
    assert len(ttypes) >= 50


def test_deterministic_counters_match(servers):
    jsrv, tsrv, _ = servers

    def values(text):
        return {(n, l): v for n, l, v in parse_exposition(text)}

    jv, tv = values(_metrics(jsrv)), values(_metrics(tsrv))
    keys = [k for k in jv if k[0] in (
        "kaito:prompt_tokens_total", "kaito:generation_tokens_total",
        "kaito:request_success_total", "kaito:prefix_cached_tokens_total",
        "kaito:prefix_cache_hits_total", "kaito:prefix_cache_misses_total",
        "kaito:kv_pages_total", "kaito:kv_page_size", "kaito:slots_total")]
    assert len(keys) == 9
    assert {k: tv.get(k) for k in keys} == {k: jv[k] for k in keys}
    assert tv[("kaito:prefix_cached_tokens_total", "")] > 0
    assert tv[("kaito:prompt_tokens_total", "")] == \
        tsrv.engine.counters["prompt_tokens_total"]


def test_port_histograms_are_cumulative(servers):
    _, tsrv, _ = servers
    text = _metrics(tsrv)
    series = check_histograms(parse_exposition(text))
    assert ("kaito:time_to_first_token_seconds", "") in series
    assert port_promtext.check_histograms(port_promtext.parse_exposition(text))


def test_request_id_is_echoed_and_traced(servers):
    jsrv, tsrv, responses = servers
    for name in ("jax", "torch"):
        for rid, (status, headers, _) in responses[name].items():
            assert status == 200 and headers["X-Request-Id"] == rid, (name, rid)

    def span_names(srv, rid):
        status, _, raw = _call(f"{srv.base}/debug/trace?trace_id={rid}")
        doc = json.loads(raw)
        assert status == 200 and doc["metadata"] == {"dropped": 0}
        assert all(e["args"]["name"] == rid for e in doc["traceEvents"]
                   if e["ph"] == "M")
        return sorted(e["name"] for e in doc["traceEvents"] if e["ph"] == "X")

    for rid in ("rid-cold", "rid-warm", "rid-stream"):
        assert span_names(tsrv, rid) == span_names(jsrv, rid), rid
    admit = [e for e in json.loads(_call(f"{tsrv.base}/debug/trace?trace_id=rid-warm")[2])
             ["traceEvents"] if e["name"] == "admit"]
    assert admit[0]["args"]["cached_tokens"] > 0
    # a traceparent's trace id names a request without X-Request-Id
    tp = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    status, headers, _ = _call(tsrv.base + "/v1/completions", {
        "prompt": "x", "max_tokens": 1}, {"traceparent": tp})
    assert status == 200 and headers["X-Request-Id"] == "ab" * 16
    status, headers, raw = _call(tsrv.base + "/v1/completions", {"prompt": ""},
                                 {"X-Request-Id": "rid-bad"})
    assert status == 400 and headers["X-Request-Id"] == "rid-bad"
    assert json.loads(raw)["error"]["request_id"] == "rid-bad"


def test_timeline_holds_one_record_per_nonidle_step(servers):
    _, tsrv, _ = servers
    status, _, raw = _call(tsrv.base + "/debug/timeline")
    doc = json.loads(raw)
    steps = [e for e in doc["traceEvents"] if e["name"] == "engine.step"]
    assert status == 200 and steps
    assert len(steps) == tsrv.engine.nonidle_steps == len(tsrv.engine.timeline)
    assert sum(e["args"]["decode_tokens"] for e in steps) == \
        tsrv.engine.counters["generation_tokens_total"]


def test_slo_snapshot_has_the_jax_keys(servers):
    jsrv, tsrv, _ = servers

    def keys(doc, depth=0):
        if not isinstance(doc, dict) or depth > 3:
            return set()
        return {k for k in doc} | {f"{k}.{sub}" for k, v in doc.items()
                                   for sub in keys(v, depth + 1)}

    j = json.loads(_call(jsrv.base + "/debug/slo")[2])
    t = json.loads(_call(tsrv.base + "/debug/slo")[2])
    assert keys(t) == keys(j)
    assert t["sli"]["fast"]["ttft_samples"] >= len(REQUESTS) + 1


def test_flight_recorder(servers, tmp_path):
    _, tsrv, _ = servers
    assert _call(tsrv.base + "/debug/flight")[0] == 403
    assert _call(tsrv.base + "/debug/flight", {})[0] == 403
    cfg, _ = parse_args(["--model", "tiny-llama-test", "--max-model-len", "256",
                         "--flight-dir", str(tmp_path)])
    assert cfg.flight_dir == str(tmp_path)
    eng = InferenceEngine(cfg, device="cpu")
    eng.start()
    srv = _Served(make_server(eng, cfg, host="127.0.0.1", port=0, device="cpu"), eng)
    try:
        assert _call(srv.base + "/v1/completions", {"prompt": "x", "max_tokens": 2},
                     {"X-Request-Id": "rid-f"})[0] == 200
        status, _, raw = _call(srv.base + "/debug/flight", {})
        assert status == 200
        name = json.loads(raw)["bundle"]
        listing = json.loads(_call(srv.base + "/debug/flight")[2])
        assert [b["name"] for b in listing["bundles"]] == [name]
        bundle = json.loads(_call(f"{srv.base}/debug/flight/{name}")[2])
        assert bundle["schema"] == "kaito.flight/1" and bundle["trigger"] == "manual"
        assert {"rid-f"} <= {s["trace_id"] for s in bundle["spans"]}
        assert bundle["timeline"] and bundle["counters"]["requests_total"] == 1
        assert "kaito:flight_bundles_total 1" in _metrics(srv)
    finally:
        srv.close()
    assert (tmp_path / name).exists()
