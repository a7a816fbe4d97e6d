"""The port's demo chat UI (``kaito_tpu_torch.ui``) mirroring
``tests/test_demo_ui.py``: the page's bytes are the JAX package's, the
port's server serves it at ``/ui``, and the standalone proxy serves it
and relays completions (plain and streamed) to a port server on
``tiny-llama-real`` on the CPU."""

import json
import os
import socket
import threading
import urllib.error
import urllib.request

import pytest

import kaito_tpu.ui as jax_ui
import kaito_tpu_torch.ui as ui
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine
from kaito_tpu_torch.engine.server import make_server as make_engine_server
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "checkpoints", "tiny-llama-real")


def _serve(srv):
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return th


@pytest.fixture(scope="module")
def stack():
    cfg = EngineConfig(model="tiny-llama-real", weights_dir=CKPT, dtype="float32",
                       kv_dtype="float32", max_model_len=256, max_num_seqs=2,
                       prefill_buckets=(32, 64), enable_prefix_caching=False)
    eng = InferenceEngine(cfg, device="cpu")
    eng.start()
    backend = make_engine_server(eng, cfg, host="127.0.0.1", port=0, device="cpu")
    proxy = ui.make_server(f"http://127.0.0.1:{backend.server_address[1]}",
                           host="127.0.0.1", port=0)
    threads = [_serve(backend), _serve(proxy)]
    yield (f"http://127.0.0.1:{proxy.server_address[1]}",
           f"http://127.0.0.1:{backend.server_address[1]}")
    for srv in (proxy, backend):
        srv.shutdown()
        srv.server_close()
    eng.stop()
    for th in threads:
        th.join(timeout=10)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _post(url, body, raw=None):
    req = urllib.request.Request(url, data=raw if raw is not None else
                                 json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_the_page_is_the_jax_packages():
    assert ui.PAGE.encode() == jax_ui.PAGE.encode()


@pytest.mark.parametrize("path", ["/", "/ui", "/ui/"])
def test_proxy_serves_the_page(stack, path):
    ui_url, _ = stack
    status, ctype, body = _get(ui_url + path)
    assert status == 200 and ctype == "text/html; charset=utf-8"
    assert body == jax_ui.PAGE.encode()


@pytest.mark.parametrize("path", ["/ui", "/ui/"])
def test_engine_server_serves_the_page(stack, path):
    _, backend = stack
    status, ctype, body = _get(backend + path)
    assert status == 200 and ctype == "text/html; charset=utf-8"
    assert body == jax_ui.PAGE.encode()


def test_proxy_relays_a_completion(stack):
    ui_url, backend = stack
    body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
            "temperature": 0.0}
    status, raw = _post(ui_url + "/v1/chat/completions", body)
    assert status == 200
    out = json.loads(raw)
    assert out["usage"]["completion_tokens"] == 4
    # the same request straight to the server gives the same reply
    _, direct = _post(backend + "/v1/chat/completions", body)
    assert (out["choices"][0]["message"]["content"]
            == json.loads(direct)["choices"][0]["message"]["content"])


def test_proxy_relays_a_stream(stack):
    ui_url, _ = stack
    status, raw = _post(ui_url + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
        "stream": True})
    body = raw.decode()
    assert status == 200 and "data: " in body and body.rstrip().endswith("[DONE]")


def test_proxy_relays_errors_and_refuses_other_paths(stack):
    ui_url, _ = stack
    status, raw = _post(ui_url + "/v1/completions", None, raw=b"not json")
    assert status == 400 and "error" in json.loads(raw)
    assert _post(ui_url + "/admin", {})[0] == 404
    assert _get(ui_url + "/nope")[0] == 404
    status, _, raw = _get(ui_url + "/health")
    assert status == 200 and json.loads(raw) == {"status": "ok"}


def test_proxy_answers_502_when_the_backend_is_down():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    proxy = ui.make_server(f"http://127.0.0.1:{dead}", host="127.0.0.1", port=0)
    th = _serve(proxy)
    try:
        status, raw = _post(f"http://127.0.0.1:{proxy.server_address[1]}"
                            "/v1/chat/completions", {"messages": []})
        assert status == 502 and json.loads(raw)["error"]["type"] == "bad_gateway"
    finally:
        proxy.shutdown()
        proxy.server_close()
        th.join(timeout=10)


def test_main_parses_its_command_line(monkeypatch):
    seen = {}

    class _Srv:
        def serve_forever(self):
            raise KeyboardInterrupt

    monkeypatch.setattr(ui, "make_server",
                        lambda backend, host, port: seen.update(
                            backend=backend, host=host, port=port) or _Srv())
    ui.main(["--backend", "http://ws:5000", "--port", "8123"])
    assert seen == {"backend": "http://ws:5000", "host": "0.0.0.0", "port": 8123}
    with pytest.raises(SystemExit):
        ui.main([])
