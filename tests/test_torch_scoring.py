"""Prompt scoring (``echo``) and ``n`` > 1 choices of the port.

- ``InferenceEngine.score_prompt`` equals the JAX engine's on one set
  of weights at rtol 2e-3 / atol 2e-4 (``tests/test_engine_core.py``'s
  tolerance) on ``tiny-llama-test``, ``tiny-llama-real``,
  ``tiny-moe-real``, a gpt-oss-shaped MoE with a sliding window, a tiny
  MLA model and int8 weights, at prompts that pad to one and to two
  128-position chunks; on two tensor-parallel CPU slots it equals one
  device.
- Scoring the committed ``tiny-llama-real`` checkpoint's golden prompt
  plus its golden tokens reproduces the golden logprobs within 2e-3.
- A score asked for from another thread while the loop decodes runs on
  the engine thread, and the decode beside it is undisturbed.
- Over HTTP the ``echo`` and ``n`` bodies have the JAX server's shape
  (``tests/test_server.py``), ``n: 3`` at temperature 0 gives the JAX
  server's tokens, and a scoring failure answers 500.
"""

import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.server import make_server as jax_make_server
from kaito_tpu.models.autogen import metadata_from_hf_config as j_metadata
from kaito_tpu.models.registry import get_model_by_name as jax_model
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.model import params_from_jax
from kaito_tpu_torch.engine.server import make_server
from kaito_tpu_torch.models import get_model_by_name
from kaito_tpu_torch.models.autogen import metadata_from_hf_config
from kaito_tpu_torch.parallel.mesh import build_mesh
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_mla import CONFIGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "testdata", "goldens_tiny-llama-real.json")
BASE = dict(model="tiny-llama-test", max_model_len=256, page_size=16,
            max_num_seqs=4, dtype="float32", kv_dtype="float32",
            prefill_buckets=(32, 64, 128), seed=0,
            enable_prefix_caching=False)


def _gpt_oss_tiny(pkg_model):
    """gpt-oss-20b's layout at a tiny width (a window of 8 tokens on
    every other layer), in either package's metadata."""
    md = pkg_model("gpt-oss-20b")
    return dataclasses.replace(md, name="gpt-oss-tiny", arch=dataclasses.replace(
        md.arch, vocab_size=300, hidden_size=64, num_layers=4, num_heads=4,
        num_kv_heads=2, head_dim=32, intermediate_size=64, num_experts=8,
        moe_intermediate_size=64, sliding_window=8, max_position_embeddings=512))


# name -> (config changes, JAX metadata, port metadata, vocabulary)
MODELS = {
    "tiny-llama-test": ({}, None, None, 1900),
    "tiny-llama-real": ({"model": "tiny-llama-real"}, None, None, 256),
    "tiny-moe-real": ({"model": "tiny-moe-real"}, None, None, 250),
    "gpt-oss-tiny": ({"model": "gpt-oss-tiny"}, lambda: _gpt_oss_tiny(jax_model),
                     lambda: _gpt_oss_tiny(get_model_by_name), 290),
    "tiny-mla": ({"model": "tiny-mla-test", "max_model_len": 128},
                 lambda: j_metadata("test/q_lora", CONFIGS["q_lora"],
                                    name="tiny-mla-test"),
                 lambda: metadata_from_hf_config("test/q_lora", CONFIGS["q_lora"],
                                                 name="tiny-mla-test"), 480),
    "int8-weights": ({"quantization": "int8"}, None, None, 1900),
}


def _pair(name, **extra):
    """A JAX engine and a port engine on the JAX engine's weights."""
    cfg, jmd, tmd, _ = MODELS[name]
    cfg = {**BASE, **cfg, **extra}
    jmd, tmd = (jmd() if jmd else None), (tmd() if tmd else None)
    jeng = JaxEngine(JaxConfig(**cfg), metadata=jmd)
    arch = (tmd or get_model_by_name(cfg["model"])).arch
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), arch)
    return jeng, InferenceEngine(EngineConfig(**cfg), metadata=tmd, params=params,
                                 device="cpu")


def _prompt(n, vocab, k=7):
    return [(k * i) % vocab + 2 for i in range(n)]


@pytest.mark.parametrize("name", list(MODELS))
def test_score_prompt_matches_the_jax_engine(name):
    jeng, eng = _pair(name)
    vocab = MODELS[name][3]
    for n in (1, 9, 100 if name == "tiny-mla" else 150):
        toks = _prompt(n, vocab)
        want, got = jeng.score_prompt(toks), eng.score_prompt(toks)
        assert got[0] is None and len(got) == n == len(want)
        assert all(x <= 0.0 for x in got[1:])
        np.testing.assert_allclose(got[1:], want[1:], rtol=2e-3, atol=2e-4)
    with pytest.raises(ValueError, match="max_model_len"):
        eng.score_prompt(_prompt(eng.cfg.max_model_len, vocab))
    assert eng.score_prompt([]) == []


def test_scores_reproduce_the_golden_logprobs():
    eng = InferenceEngine(EngineConfig(
        model="tiny-llama-real", weights_dir=os.path.join(REPO, "checkpoints",
                                                          "tiny-llama-real"),
        dtype="float32", max_model_len=512, enable_prefix_caching=False),
        device="cpu")
    for p in json.load(open(GOLDENS))["prompts"]:
        prompt, gold = p["prompt_tokens"], p["fp32"]
        lps = eng.score_prompt(prompt + gold["greedy_tokens"])
        n = len(prompt)
        np.testing.assert_allclose(lps[n:n + len(gold["greedy_tokens"])],
                                   gold["logprobs"], rtol=0, atol=2e-3,
                                   err_msg=p["text"])


def test_tensor_parallel_score_equals_one_device():
    jeng, one = _pair("tiny-llama-test")
    arch = get_model_by_name("tiny-llama-test").arch
    tp = InferenceEngine(EngineConfig(**{**BASE, "tensor_parallel": 2}), device="cpu",
                         mesh=build_mesh(tensor=2, devices=["cpu", "cpu"]),
                         params=params_from_jax(jax.tree.map(np.asarray, jeng.params),
                                                arch))
    toks = _prompt(140, 1900)
    np.testing.assert_allclose(tp.score_prompt(toks)[1:], one.score_prompt(toks)[1:],
                               rtol=1e-4, atol=1e-5)


def test_score_during_decode_runs_on_the_engine_thread():
    """Scoring asked for from this thread while a request decodes: the
    forward runs on the loop's thread, between steps, and the decode
    beside it gives the tokens it gives alone."""
    ref = InferenceEngine(EngineConfig(**BASE), device="cpu")
    toks = _prompt(60, 1900, k=5)
    want_score = ref.score_prompt(toks)
    prompt = _prompt(20, 1900, k=3)
    greedy = SamplingParams(max_tokens=120, temperature=0.0, ignore_eos=True)
    alone = ref.submit(prompt, greedy)
    for _ in range(2000):
        ref.step()
        if alone.finish_reason:
            break

    eng = InferenceEngine(EngineConfig(**BASE), device="cpu")
    threads = []
    inner = eng.model.score

    def score(*a):
        threads.append(threading.current_thread().name)
        return inner(*a)

    eng.model.score = score
    eng.start()
    try:
        req = eng.submit(prompt, greedy)
        first = req.out.get()
        got = eng.score_prompt(toks)
        steps = eng.counters["decode_steps_total"]
        out = [first] + list(req.stream())
    finally:
        eng.stop()
    assert threads == ["engine-loop"]
    assert got == want_score
    assert 0 < len(req.output_tokens) and out == alone.output_tokens
    assert req.output_tokens == alone.output_tokens
    c = eng.counters
    assert c["decode_steps_total"] >= steps
    assert c["generation_tokens_total"] == 120 and c["requests_finished_total"] == 1
    assert c["prompt_tokens_total"] == len(prompt)


# ---------------------------------------------------------------------------
# over HTTP
# ---------------------------------------------------------------------------

def _post(base, body, path="/v1/completions"):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def servers():
    cfg = dict(model="tiny-llama-test", max_model_len=256, dtype="float32",
               kv_dtype="float32")
    jeng = JaxEngine(JaxConfig(**cfg))
    arch = get_model_by_name("tiny-llama-test").arch
    teng = InferenceEngine(EngineConfig(**cfg), device="cpu", params=params_from_jax(
        jax.tree.map(np.asarray, jeng.params), arch))
    out = []
    for eng, make, ecfg, kw in ((jeng, jax_make_server, JaxConfig(**cfg), {}),
                                (teng, make_server, EngineConfig(**cfg),
                                 {"device": "cpu"})):
        eng.start()
        srv = make(eng, ecfg, host="127.0.0.1", port=0, **kw)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        out.append((srv, eng, f"http://127.0.0.1:{srv.server_address[1]}"))
    yield out[0][2], out[1][2], teng
    for srv, eng, _ in out:
        srv.shutdown()
        srv.server_close()
        eng.stop()


def test_echo_body_has_the_jax_shape(servers):
    jbase, base, _ = servers
    body = {"prompt": "score this prompt", "max_tokens": 0, "echo": True, "logprobs": 1}
    (jstatus, want), (status, out) = _post(jbase, body), _post(base, body)
    assert status == jstatus == 200
    ch = out["choices"][0]
    assert ch["text"] == "score this prompt" and ch["finish_reason"] == "stop"
    lp = ch["logprobs"]
    assert lp["token_logprobs"][0] is None
    assert len(lp["token_logprobs"]) == out["usage"]["prompt_tokens"]
    assert "".join(lp["tokens"]) == ch["text"]
    assert out["usage"] == want["usage"] and out["usage"]["completion_tokens"] == 0
    jlp = want["choices"][0]["logprobs"]
    assert lp["tokens"] == jlp["tokens"] and lp["text_offset"] == jlp["text_offset"]
    np.testing.assert_allclose(lp["token_logprobs"][1:], jlp["token_logprobs"][1:],
                               rtol=2e-3, atol=2e-4)
    assert set(out) == set(want) and set(ch) == set(want["choices"][0])


@pytest.mark.parametrize("body", [
    {"prompt": "x", "max_tokens": 4, "echo": True, "logprobs": 1},
    {"prompt": "x", "max_tokens": 0, "echo": True},
    {"prompt": "x", "max_tokens": 2, "n": 2, "stream": True},
    {"prompt": "x", "max_tokens": 2, "n": 17},
    {"prompt": "x", "max_tokens": 2, "n": -1},
], ids=["echo-generates", "echo-no-logprobs", "n-stream", "n-17", "n-negative"])
def test_echo_and_n_refusals_match_the_jax_server(servers, body):
    jbase, base, _ = servers
    (jstatus, _), (status, out) = _post(jbase, body), _post(base, body)
    assert status == jstatus == 400 and "error" in out


def test_n_choices_shape(servers):
    _, base, _ = servers
    status, out = _post(base, {"prompt": "count with me", "max_tokens": 5, "n": 3,
                               "temperature": 0.8, "seed": 7})
    assert status == 200
    assert [c["index"] for c in out["choices"]] == [0, 1, 2]
    assert out["usage"]["completion_tokens"] == 15


@pytest.mark.parametrize("chat", [False, True])
def test_n_greedy_choices_are_the_jax_servers(servers, chat):
    jbase, base, _ = servers
    path = "/v1/chat/completions" if chat else "/v1/completions"
    body = {"max_tokens": 6, "n": 3, "temperature": 0.0, "ignore_eos": True}
    body.update({"messages": [{"role": "user", "content": "n choices"}]} if chat
                else {"prompt": "n choices", "logprobs": 1})
    (jstatus, want), (status, out) = _post(jbase, body, path), _post(base, body, path)
    assert status == jstatus == 200
    key = (lambda c: c["message"]["content"]) if chat else (lambda c: c["text"])
    texts = [key(c) for c in out["choices"]]
    assert texts == [key(c) for c in want["choices"]] and len(set(texts)) == 1
    assert out["usage"] == want["usage"]
    if not chat:
        for c, w in zip(out["choices"], want["choices"]):
            assert c["logprobs"]["tokens"] == w["logprobs"]["tokens"]
            np.testing.assert_allclose(c["logprobs"]["token_logprobs"],
                                       w["logprobs"]["token_logprobs"], atol=2e-4)


def test_scoring_failure_answers_500(servers, monkeypatch):
    _, base, teng = servers

    def broken(*a):
        raise RuntimeError("scoring kernel failed")

    monkeypatch.setattr(teng.model, "score", broken)
    status, out = _post(base, {"prompt": "x y", "max_tokens": 0, "echo": True,
                               "logprobs": 1})
    assert status == 500 and "scoring kernel failed" in out["error"]["message"]
