"""The port server's ``main`` path on the CPU, started as a pod starts it.

``start_server`` (everything ``main`` does before it serves) runs with
``--weights-dir http://...`` (``tiny-llama-real`` served by a local
server that answers ``Range``), ``--kaito-config-file`` (a ``vllm:``
section naming the served model and the golden section's quantization)
and ``--dtype float32``.  The weight server holds its first answer until
the test has seen the loading stub: ``/health`` 503 ``loading``,
``/metrics`` ``kaito:engine_loading 1``, a POST 503.  Then ``/health``
answers 200, ``/v1/models`` names the file's model, ``/ui`` the page,
and each golden prompt of ``tests/testdata/goldens_tiny-llama-real.json``
gives its section's greedy tokens (exact) and logprobs (atol 2e-3)
over HTTP.
"""

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from kaito_tpu_torch.engine.server import start_server, token_surface_forms
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "tiny-llama-real")
GOLDENS = os.path.join(REPO, "tests", "testdata", "goldens_tiny-llama-real.json")

# golden section -> the config file's lines beside the served model name
SECTIONS = {
    "fp32": "",
    "int8": "  quantization: int8\n",
    "weight_int4": "  quantization: int4\n",
    "kv_int8": "  kv-cache-dtype: int8\n",
}


class _GatedRanges(BaseHTTPRequestHandler):
    """Ranged reads of ``root``; every answer waits for ``gate``."""

    protocol_version = "HTTP/1.1"
    root = ""
    gate: threading.Event = threading.Event()
    ranged: list = []

    def log_message(self, *a):
        pass

    def do_GET(self):
        type(self).gate.wait(60)
        path = os.path.join(self.root, self.path.lstrip("/"))
        if not os.path.isfile(path):
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        with open(path, "rb") as f:
            data = f.read()
        a, _, b = self.headers["Range"].split("=")[1].partition("-")
        type(self).ranged.append(self.path)
        body = data[int(a):int(b) + 1]
        self.send_response(206)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture
def weights():
    handler = type("W", (_GatedRanges,), {"root": CKPT, "gate": threading.Event(),
                                          "ranged": []})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}/", handler
    handler.gate.set()
    srv.shutdown()
    srv.server_close()
    th.join(timeout=10)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _call(url, body=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait_for(url, status, limit=60.0):
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline:
        try:
            code, body = _call(url, timeout=5)
            if code == status:
                return body
        except (urllib.error.URLError, ConnectionError):
            pass
        time.sleep(0.02)
    raise AssertionError(f"{url} never answered {status}")


@pytest.mark.parametrize("section", list(SECTIONS))
def test_main_streams_loads_and_replays_the_goldens(weights, tmp_path, section):
    url, handler = weights
    conf = tmp_path / "inference_config.yaml"
    conf.write_text("vllm:\n  served-model-name: tiny-chat\n  max-num-seqs: 4\n"
                    + SECTIONS[section])
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    argv = ["--model", "tiny-llama-real", "--port", str(port), "--max-model-len", "512",
            "--weights-dir", url, "--kaito-config-file", str(conf),
            "--dtype", "float32", "--device", "cpu", "--host", "127.0.0.1"]
    out: dict = {}

    def build():
        try:
            out["server"], out["args"] = start_server(argv)
        except Exception as e:           # reported below
            out["error"] = e

    loader = threading.Thread(target=build)
    loader.start()
    try:
        body = json.loads(_wait_for(base + "/health", 503))
        assert body["status"] == "loading" and body["seconds"] >= 0
        code, metrics = _call(base + "/metrics")
        assert code == 200 and b"kaito:engine_loading 1\n" in metrics
        code, err = _call(base + "/v1/completions", {"prompt": "x", "max_tokens": 1})
        assert code == 503 and json.loads(err)["error"]["type"] == "unavailable"
        assert "server" not in out
    finally:
        handler.gate.set()
        loader.join(timeout=120)
    assert "error" not in out, out.get("error")
    server = out["server"]
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    try:
        eng = server.state.engine
        assert handler.ranged and all(p.endswith(".safetensors") for p in handler.ranged)
        assert (eng.cfg.max_num_seqs, eng.cfg.served_model_name) == (4, "tiny-chat")
        json.loads(_wait_for(base + "/health", 200))
        code, models = _call(base + "/v1/models")
        assert json.loads(models)["data"][0]["id"] == "tiny-chat"
        code, metrics = _call(base + "/metrics")
        assert b"kaito:engine_loading" not in metrics
        code, page = _call(base + "/ui")
        assert code == 200 and b"chat demo" in page
        for p in json.load(open(GOLDENS))["prompts"]:
            want = p[section]
            code, raw = _call(base + "/v1/completions", {
                "prompt": p["text"], "max_tokens": len(want["greedy_tokens"]),
                "temperature": 0.0, "ignore_eos": True, "logprobs": 1})
            assert code == 200, raw
            resp = json.loads(raw)
            assert resp["usage"]["prompt_tokens"] == len(p["prompt_tokens"])
            lp = resp["choices"][0]["logprobs"]
            assert lp["tokens"] == token_surface_forms(eng.tokenizer,
                                                       want["greedy_tokens"]), p["text"]
            diff = max(abs(a - b) for a, b in zip(lp["token_logprobs"], want["logprobs"]))
            assert diff <= 2e-3, (p["text"], diff)
    finally:
        server.shutdown()
        server.server_close()
        server.state.engine.stop()
        serving.join(timeout=10)


def test_stub_is_gone_when_the_engine_fails(tmp_path):
    """A load that fails raises out of start_server and leaves the port
    free: the stub does not outlive it."""
    port = _free_port()
    with pytest.raises(FileNotFoundError):
        start_server(["--model", "tiny-llama-real", "--port", str(port),
                      "--weights-dir", str(tmp_path / "missing"), "--device", "cpu",
                      "--host", "127.0.0.1", "--dtype", "float32"])
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))
