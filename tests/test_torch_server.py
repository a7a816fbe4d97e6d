"""The port's OpenAI server on the CPU (port 0): a completion and a
streamed chat carry exactly the tokens the engine itself produces for
the same prompt, in the JAX server's response shapes."""

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from kaito_tpu_torch.engine.chat import render_chat
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.server import make_server
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def served():
    cfg = EngineConfig(model="tiny-llama-real",
                       weights_dir=os.path.join(REPO, "checkpoints",
                                                "tiny-llama-real"),
                       dtype="float32", kv_dtype="float32", max_model_len=512,
                       max_num_seqs=4, prefill_buckets=(64, 128, 256),
                       enable_prefix_caching=False, seed=0)
    eng = InferenceEngine(cfg, device="cpu")
    eng.start()
    server = make_server(eng, cfg, host="127.0.0.1", port=0, device="cpu")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    yield eng, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    eng.stop()
    th.join(timeout=10)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _engine_tokens(eng, text, n):
    req = eng.submit(eng.tokenizer.encode(text), SamplingParams(
        max_tokens=n, temperature=0.0, ignore_eos=True))
    return list(req.stream())


def test_completion_matches_the_engine(served):
    eng, base = served
    prompt = "The library is distributed in the hope that "
    want = _engine_tokens(eng, prompt, 12)
    status, raw = _post(f"{base}/v1/completions", {
        "prompt": prompt, "max_tokens": 12, "temperature": 0.0,
        "ignore_eos": True, "logprobs": 1})
    assert status == 200
    resp = json.loads(raw)
    assert resp["object"] == "text_completion"
    ch = resp["choices"][0]
    assert ch["text"] == eng.tokenizer.decode(want)
    assert ch["finish_reason"] == "length"
    assert resp["usage"] == {"prompt_tokens": len(prompt) + 1,
                             "completion_tokens": 12,
                             "total_tokens": len(prompt) + 13}
    lps = ch["logprobs"]["token_logprobs"]
    assert len(lps) == 12 and all(x <= 0 for x in lps)


def test_streamed_chat_matches_the_engine(served):
    eng, base = served
    messages = [{"role": "user", "content": "Say something about licenses."}]
    want = _engine_tokens(eng, render_chat(eng.tokenizer, messages,
                                           model_id=eng.md.name), 16)
    req = urllib.request.Request(
        f"{base}/v1/chat/completions",
        data=json.dumps({"messages": messages, "max_tokens": 16,
                         "temperature": 0.0, "ignore_eos": True,
                         "stream": True,
                         "stream_options": {"include_usage": True}}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        events = [ln.decode().strip()[6:] for ln in r
                  if ln.decode().startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks if c["choices"])
    assert text == eng.tokenizer.decode(want)
    finishes = [c["choices"][0]["finish_reason"] for c in chunks if c["choices"]]
    assert finishes[-1] == "length"
    assert chunks[-1]["usage"]["completion_tokens"] == 16


def test_stop_string_truncates(served):
    eng, base = served
    prompt = "This package provides a"
    text = eng.tokenizer.decode(_engine_tokens(eng, prompt, 12))
    stop = text[4:6]
    status, raw = _post(f"{base}/v1/completions", {
        "prompt": prompt, "max_tokens": 12, "temperature": 0.0,
        "ignore_eos": True, "stop": [stop]})
    ch = json.loads(raw)["choices"][0]
    assert status == 200
    assert ch["text"] == text[:text.find(stop)] and ch["finish_reason"] == "stop"


def test_health_and_models(served):
    eng, base = served
    status, body = _get(f"{base}/health")
    assert status == 200 and body["status"] == "ok" and body["device"] == "cpu"
    status, body = _get(f"{base}/v1/models")
    assert status == 200 and body["data"][0]["id"] == "tiny-llama-real"


@pytest.mark.parametrize("path", ["/ui", "/ui/"])
def test_unported_routes_answer_501(served, path):
    """The routes this test once found unported: ``/ui`` and ``/ui/`` now
    serve the demo chat page, as the JAX server does."""
    from kaito_tpu_torch.ui import PAGE

    _, base = served
    with urllib.request.urlopen(base + path, timeout=60) as r:
        assert r.status == 200
        assert r.headers["Content-Type"] == "text/html; charset=utf-8"
        assert r.read() == PAGE.encode()


def test_debug_device_is_403_with_devprof_off(served):
    """The JAX server's answer with sampling off (--devprof-interval-s 0)."""
    eng, base = served
    assert eng.devprof is None
    status, body = _get(base + "/debug/device")
    assert status == 403 and "--devprof-interval-s" in body["error"]["message"]


@pytest.mark.parametrize("body,code", [
    ({"prompt": ""}, 400),
    ({"prompt": "x", "model": "other-model"}, 404),
    # the JAX server's answers: constrained output is served on both
    # endpoints, tools only on chat; KV transfer without --pd-enabled 403
    ({"prompt": "x", "max_tokens": 8, "response_format": {"type": "json_object"}},
     200),
    ({"prompt": "x", "tool_choice": "auto"}, 400),
    ({"prompt": "x", "kv_transfer": {"source_url": "http://localhost:1"}}, 403),
    ({"prompt": "x", "max_tokens": -3}, 400),
    ({"prompt": "x", "temperature": "hot"}, 400),
])
def test_bad_requests(served, body, code):
    _, base = served
    status, raw = _post(f"{base}/v1/completions", body)
    assert status == code, raw
    assert ("error" in json.loads(raw)) == (code != 200)


def test_unknown_route_is_404(served):
    _, base = served
    status, _ = _post(f"{base}/v1/embeddings", {"input": "x"})
    assert status == 404


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "This package provides a"}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "Hi."}]}),
])
def test_a_client_that_leaves_mid_stream_frees_its_slot(served, monkeypatch, capsys,
                                                        path, body):
    """A streaming client that closes its connection after the first
    event: the server aborts the request at the first failed write (no
    traceback), so it stops well short of max_tokens, and serves on."""
    eng, base = served
    submitted = []
    real = eng.submit

    def recording(*a, **kw):
        submitted.append(real(*a, **kw))
        return submitted[-1]

    monkeypatch.setattr(eng, "submit", recording)
    max_tokens = 400
    data = json.dumps(dict(body, max_tokens=max_tokens, temperature=0.0,
                           ignore_eos=True, stream=True)).encode()
    host, port = base[len("http://"):].split(":")
    with socket.create_connection((host, int(port)), timeout=60) as s:
        s.sendall(b"POST %s HTTP/1.1\r\nHost: %s\r\nContent-Type: application/json"
                  b"\r\nContent-Length: %d\r\n\r\n%s"
                  % (path.encode(), host.encode(), len(data), data))
        got = b""
        while b"data: " not in got:
            chunk = s.recv(4096)
            assert chunk, got
            got += chunk
    assert got.startswith(b"HTTP/1.0 200") or got.startswith(b"HTTP/1.1 200"), got
    (req,) = submitted
    deadline = time.monotonic() + 60
    while req.finish_time is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert req.aborted and req.finish_time is not None
    assert len(req.output_tokens) < max_tokens
    assert "Traceback" not in capsys.readouterr().err
    status, _ = _post(f"{base}/v1/completions", {"prompt": "x", "max_tokens": 2})
    assert status == 200
