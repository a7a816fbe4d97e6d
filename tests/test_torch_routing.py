"""The port's routing data path (``kaito_tpu_torch/runtime/routing.py``)
against the JAX package's, on the CPU.

- The routing units of ``tests/test_epp.py`` (chained prefix blocks,
  the affinity index's leading runs, LRU bound and dropped backends,
  saturation hysteresis, the ``/metrics`` load parser, ``--backend``
  specs) run through both packages, each with the JAX test's
  expectations and equal outputs; the load parser also reads a live
  port server's own ``/metrics`` (``tiny-llama-real``, in process) and
  the prefix helpers keep the hashes the KV pool publishes.
- The router-server scenarios of ``tests/test_failpoints.py`` (breaker
  open, half-open and closed under a failpoint-killed backend, the
  health prober closing a breaker, a 204 relayed without chunked
  framing, a chunked client body de-chunked, the SIGTERM drain's 503,
  the idempotent-retry classification) run against stdlib stub
  backends through each package's round-robin front, with equal status
  codes, bodies and breaker states.
"""

import http.client
import importlib
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(root):
    mods = {"routing": "runtime.routing", "epp": "runtime.epp",
            "dp": "runtime.dp_router", "fp": "utils.failpoints"}
    return types.SimpleNamespace(root=root, **{
        k: importlib.import_module(f"{root}.{m}") for k, m in mods.items()})


JAX, PORT = _pkg("kaito_tpu"), _pkg("kaito_tpu_torch")


# ---------------------------------------------------------------------------
# routing units (tests/test_epp.py:35-118)
# ---------------------------------------------------------------------------

def u_prefix_blocks(p):
    pb = p.routing.prefix_blocks
    b = pb("abcdabcd", 4)
    assert len(b) == 2 and b[0] != b[1]
    assert pb("abcdabcdzzzz", 4)[:2] == b
    assert pb("abcdab", 4) == b[:1]
    assert pb("abc", 4) == [] and pb("anything", 0) == []
    seed = p.routing.adapter_seed("style-a")
    assert p.routing.adapter_seed("") == 0 and seed != 0
    msgs = {"messages": [{"role": "system", "content": "x" * 40},
                         {"role": "user", "content": "hi"}]}
    return dict(b=b, seeded=pb("abcdabcd" * 9, 16, seed=seed), seed=seed,
                chat=p.routing.extract_prompt_text(msgs),
                prompt=p.routing.extract_prompt_text({"prompt": "p"}),
                none=p.routing.extract_prompt_text([1]))


def u_affinity_index(p):
    idx = p.routing.PrefixAffinityIndex(capacity=16)
    idx.record([1, 2, 3], "http://a")
    idx.record([1, 2], "http://b")
    out = [idx.match([1, 2, 3])]
    assert out[0] == {"http://a": 3, "http://b": 2}
    out.append(idx.match([9, 1, 2]))
    assert out[-1] == {}
    idx.record([3], "http://c")
    assert "http://c" not in idx.match([1, 2, 3])
    return out


def u_lru(p):
    idx = p.routing.PrefixAffinityIndex(capacity=3)
    idx.record([1, 2, 3], "http://a")
    idx.record([4], "http://a")
    assert len(idx) == 3 and idx.evictions == 1
    assert idx.match([1]) == {}
    assert idx.match([2]) == {"http://a": 1}
    idx.match([2, 3])
    idx.record([5], "http://a")
    assert idx.match([2]) == {"http://a": 1}
    return len(idx), idx.evictions


def u_drop_backend(p):
    idx = p.routing.PrefixAffinityIndex(capacity=16)
    idx.record([1, 2], "http://a")
    idx.record([1], "http://b")
    idx.record_session("conv", "http://a")
    idx.drop_backend("http://a")
    assert idx.match([1, 2]) == {"http://b": 1}
    assert len(idx) == 1 and idx.session_holder("conv") is None
    return len(idx)


def u_hysteresis(p):
    b = p.routing.Backend("http://x:1")
    seen = []
    for field, v, want in (("occupancy", 0.95, True), ("occupancy", 0.80, True),
                           ("occupancy", 0.60, False), ("waiting", 9, True),
                           ("waiting", 3, True), ("waiting", 0, False),
                           ("kv_usage", 0.91, True), ("kv_usage", 0.76, True),
                           ("kv_usage", 0.70, False)):
        setattr(b.load, field, v)
        seen.append(p.routing.update_saturation(b))
        assert seen[-1] is want, (field, v)
    return seen


def u_parse_load(p):
    text = "\n".join([
        "# HELP kaito:num_requests_waiting q",
        'kaito:num_requests_waiting{group="0"} 3',
        'kaito:num_requests_waiting{group="1"} 2',
        'kaito:batch_occupancy{group="0"} 0.5',
        'kaito:batch_occupancy{group="1"} 0.7',
        "kaito:kv_page_size 16",
        "kaito:something_else 42",
        "kaito:kv_cache_usage_perc not-a-number",
    ])
    vals = p.routing.parse_load_metrics(text)
    assert vals["waiting"] == 5.0 and vals["page_size"] == 16.0
    assert vals["occupancy"] == pytest.approx(0.6)
    assert "something_else" not in vals and "kv_usage" not in vals
    return vals


def u_backend_arg(p):
    parse = p.epp._parse_backend_arg
    out = [(b.url, b.role, b.group, b.host, b.port) for b in (
        parse("http://p0:5000=prefill/g0"), parse("http://d0:5000=decode"),
        parse("http://plain:5000/"), parse("http://noport"))]
    assert out[0][:3] == ("http://p0:5000", "prefill", "g0")
    assert out[1][1:3] == ("decode", "") and out[2][1:3] == ("", "")
    assert out[3][4] == 80
    return out


def u_breaker_backoff(p):
    b = p.routing.Backend("http://x:1")
    cool = []
    for _ in range(6):
        t0 = time.monotonic()
        b.mark_down()
        cool.append(round(b.down_until - t0))
    assert b.state == "open"
    b.down_until = 0.0
    assert b.state == "half-open"
    b.mark_up()
    assert b.state == "closed" and b.failures == 0
    b.demote(2.5)
    assert b.demoted and b.alive
    return cool


UNITS = {"prefix_blocks": u_prefix_blocks, "affinity_index": u_affinity_index,
         "lru": u_lru, "drop_backend": u_drop_backend, "hysteresis": u_hysteresis,
         "parse_load": u_parse_load, "backend_arg": u_backend_arg,
         "breaker_backoff": u_breaker_backoff}


@pytest.mark.parametrize("unit", list(UNITS))
def test_routing_units_match_jax(unit):
    assert UNITS[unit](PORT) == UNITS[unit](JAX)


def test_prefix_helpers_keep_the_pool_hashes():
    """The three helpers the KV pool and the server import are the ones
    the router hashes with (the same objects), and their chains equal the
    JAX package's on multi-byte text at every block size and seed (the
    pool's published keys depend on them)."""
    from kaito_tpu_torch.engine import kv_pool, server

    r = PORT.routing
    assert kv_pool.prefix_blocks is r.prefix_blocks
    assert kv_pool.adapter_seed is r.adapter_seed
    assert server.extract_prompt_text is r.extract_prompt_text
    text = "".join(chr(33 + (i * 7) % 90) for i in range(700)) + "é✓"
    for bc in (4, 64, 256):
        for seed in (0, r.adapter_seed("style-a")):
            assert r.prefix_blocks(text, bc, seed) == JAX.routing.prefix_blocks(
                text, bc, seed)


def test_load_parser_reads_a_port_servers_metrics():
    """``parse_load_metrics`` on a live port server's own ``/metrics``
    (not a copied string): the load gauges and the page size are read,
    both parsers agree, and ``scrape_backend_load`` folds them into a
    backend with a fresh stamp."""
    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.engine import InferenceEngine
    from kaito_tpu_torch.engine.server import make_server

    cfg = EngineConfig(model="tiny-llama-real",
                       weights_dir=os.path.join(REPO, "checkpoints", "tiny-llama-real"),
                       max_model_len=128, page_size=16, max_num_seqs=2, dtype="float32",
                       kv_dtype="float32", prefill_buckets=(32, 64), seed=0)
    eng = InferenceEngine(cfg, device="cpu")
    eng.start()
    srv = make_server(eng, cfg, host="127.0.0.1", port=0, device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        text = urllib.request.urlopen(url + "/metrics", timeout=30).read().decode()
        vals = PORT.routing.parse_load_metrics(text)
        assert vals == JAX.routing.parse_load_metrics(text)
        assert vals == {"occupancy": 0.0, "waiting": 0.0, "kv_usage": 0.0,
                        "page_size": 16.0}
        b = PORT.routing.Backend(url)
        assert PORT.routing.scrape_backend_load(b, timeout=10)
        assert b.load.page_size == 16.0 and b.load.ts > 0 and not b.saturated
        assert not PORT.routing.scrape_backend_load(PORT.routing.Backend(
            "http://127.0.0.1:1"), timeout=2)
    finally:
        srv.shutdown()
        srv.server_close()
        eng.stop()


# ---------------------------------------------------------------------------
# router-server scenarios (tests/test_failpoints.py:289-403)
# ---------------------------------------------------------------------------

def _fake_backend(tag: str) -> ThreadingHTTPServer:
    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"ok": True})
            elif self.path == "/nobody":
                self.send_response(204)
                self.end_headers()
            elif self.path == "/sse":
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.end_headers()
                for i in range(3):
                    self.wfile.write(f"data: {i}\n\n".encode())
                    self.wfile.flush()
                self.close_connection = True
            else:
                self._json(404, {"error": "nope"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b""
            if self.path == "/echo":
                self._json(200, {"len": len(body),
                                 "body": body.decode("utf-8", "replace"),
                                 "rid": self.headers.get("X-Request-Id")})
            else:
                self._json(200, {"backend": tag, "len": len(body)})

    return ThreadingHTTPServer(("127.0.0.1", 0), H)


class _Pair:
    """Two stub backends behind ``p``'s round-robin front."""

    def __init__(self, p):
        self.p = p
        self.stubs = [_fake_backend("b0"), _fake_backend("b1")]
        for b in self.stubs:
            threading.Thread(target=b.serve_forever, daemon=True).start()
        self.urls = [f"http://127.0.0.1:{b.server_address[1]}" for b in self.stubs]
        self.router = p.dp.DPRouter(self.urls)
        self.srv = p.dp.make_router_server(self.router, "127.0.0.1", 0)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def close(self):
        for s in (self.srv, *self.stubs):
            s.shutdown()
            s.server_close()


def _post(url, obj, headers=None):
    req = urllib.request.Request(url, json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("Retry-After")


def s_breaker_failover(p, pair):
    router, urls = pair.router, pair.urls
    out = []
    with p.fp.failpoint("router.forward", backend=urls[0]):
        for i in range(6):
            router.backends[0].down_until = 0.0
            out.append(_post(pair.url + "/v1/completions", {"i": i}))
        assert all(s == 200 and o["backend"] == "b1" for s, o in out)
        assert router.backends[0].failures >= 3
        out.append((router.backends[0].failures, router.backends[0].state))
        assert out[-1][1] == "open"
    router.backends[0].down_until = 0.0
    out.append(router.backends[0].state)
    assert out[-1] == "half-open"
    out += [_post(pair.url + "/v1/completions", {"i": i})[0] for i in range(4)]
    assert router.backends[0].state == "closed" and router.backends[0].failures == 0
    stats = json.loads(urllib.request.urlopen(pair.url + "/router/stats",
                                              timeout=5).read())
    out.append(sorted((s["state"], s["alive"], s["failures"]) for s in stats.values()))
    failed = router.m_failures.value(backend=urls[0])
    assert failed >= 3
    return out + [failed]


def s_health_probe(p, pair):
    router = p.dp.DPRouter([pair.urls[0]])
    for _ in range(3):
        router.backends[0].mark_down()
    assert router.backends[0].state == "open"
    prober = p.dp.HealthProber(router, interval_s=0.05)
    prober.start()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and router.backends[0].state != "closed":
        time.sleep(0.02)
    prober.stop()
    assert router.backends[0].state == "closed"
    return router.backends[0].state


def s_no_chunked_204(p, pair):
    host, port = pair.url[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request("GET", "/nobody")
        resp = conn.getresponse()
        first = (resp.status, resp.getheader("Transfer-Encoding"), resp.read())
        assert first == (204, None, b"")
        conn.request("GET", "/health")
        resp2 = conn.getresponse()
        second = (resp2.status, json.loads(resp2.read()))
        assert second == (200, {"ok": True})
        conn.request("GET", "/sse")
        resp3 = conn.getresponse()
        sse = (resp3.status, resp3.getheader("Transfer-Encoding"), resp3.read())
        assert sse == (200, "chunked", b"data: 0\n\ndata: 1\n\ndata: 2\n\n")
        return first, second, sse
    finally:
        conn.close()


def s_dechunk(p, pair):
    host, port = pair.url[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request("POST", "/echo", body=iter([b"hello ", b"world"]),
                     headers={"Transfer-Encoding": "chunked",
                              "X-Request-Id": "req-abc"},
                     encode_chunked=True)
        resp = conn.getresponse()
        out = (resp.status, json.loads(resp.read()))
        assert out == (200, {"len": 11, "body": "hello world", "rid": "req-abc"})
        return out
    finally:
        conn.close()


def s_drain(p, pair):
    router = pair.router
    assert router.drain(timeout_s=1.0)
    refused = _post(pair.url + "/v1/completions", {})
    assert refused[0] == 503 and refused[1] == {"error": "router draining"}
    assert refused[2] is not None
    router.draining = False
    after = _post(pair.url + "/v1/completions", {})
    assert after[0] == 200
    received = router.m_received.value()
    return refused, after[0], received


def s_retryable(p, pair):
    r = p.dp._retryable
    out = [r("GET", "/anything"), r("DELETE", "/pd/kv/x"), r("POST", "/v1/completions"),
           r("POST", "/v1/chat/completions"), r("POST", "/pd/prefill"),
           r("PUT", "/v1/completions"), r("HEAD", "/health")]
    assert out == [True, True, True, True, False, False, True]
    return out


SCENARIOS = {"breaker_failover": s_breaker_failover, "health_probe": s_health_probe,
             "no_chunked_204": s_no_chunked_204, "dechunk": s_dechunk, "drain": s_drain,
             "retryable": s_retryable}


def _run_scenario(p, name):
    p.fp.FAILPOINTS.clear()
    pair = _Pair(p)
    try:
        return SCENARIOS[name](p, pair)
    finally:
        pair.close()
        p.fp.FAILPOINTS.clear()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_router_scenarios_match_jax(name):
    assert _run_scenario(PORT, name) == _run_scenario(JAX, name)


def test_router_metrics_are_the_jax_families():
    """The front's own ``/metrics`` (never forwarded) carries the same
    ``kaito:router_*`` families and samples after the same traffic."""
    from kaito_tpu_torch.utils.promtext import check_histograms, parse_exposition

    def run(p):
        pair = _Pair(p)
        try:
            for i in range(4):
                _post(pair.url + "/v1/completions", {"i": i})
            text = urllib.request.urlopen(pair.url + "/metrics", timeout=5).read().decode()
        finally:
            pair.close()
        port_of = {u: f"b{i}" for i, u in enumerate(pair.urls)}
        samples = parse_exposition(text)
        check_histograms(samples)
        out = set()
        for name, lbl, v in samples:
            for u, tag in port_of.items():
                lbl = lbl.replace(u, tag)
            if "latency_seconds" in name and not name.endswith("_count"):
                v = None                  # host timings differ run to run
            out.add((name, lbl, v))
        return out

    assert run(PORT) == run(JAX)
