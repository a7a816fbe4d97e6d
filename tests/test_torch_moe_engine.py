"""The port's engine serving MoE models on the CPU.

- ``tiny-moe-real`` (the committed trained MoE checkpoint) in fp32
  reproduces the ``fp32``, ``int8``, ``weight_int4`` and ``kv_int8``
  goldens of ``tests/testdata/goldens_tiny-moe-real.json``: greedy tokens
  exact, logprobs within atol 2e-3, as ``tests/test_real_checkpoint.py``
  holds the JAX engine; ``fp32`` again through the async loop, the eager
  reference loop and the two forms the card runs (``grouped``, bf16's,
  and ``dense``, fp32's), and with every prompt in flight at once.
- The JAX engine and the port, one set of synthetic weights, the same
  concurrent traffic: the same greedy tokens, for tiny-moe-real and a
  gpt-oss-shaped tiny arch.
- Tensor parallelism with a MoE model raises; the server serves
  ``tiny-moe-real`` and takes ``--model gpt-oss-20b``.
"""

import dataclasses
import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.engine import SamplingParams as JaxParams
from kaito_tpu.models import get_model_by_name as jax_model
from kaito_tpu_torch.engine import server as tserver
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.model import params_from_jax
from kaito_tpu_torch.models import get_model_by_name
from kaito_tpu_torch.parallel.mesh import build_mesh
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "tiny-moe-real")
GOLDENS = os.path.join(REPO, "tests", "testdata", "goldens_tiny-moe-real.json")
REAL = dict(model="tiny-moe-real", weights_dir=CKPT, dtype="float32",
            max_model_len=512, max_num_seqs=2, prefill_buckets=(64, 128),
            enable_prefix_caching=False, seed=0)
MODES = {"fp32": ("", "float32"), "int8": ("int8", "float32"),
         "weight_int4": ("int4", "float32"), "kv_int8": ("", "int8")}
PROMPTS = [[(3 * i) % 250 + 2 for i in range(9)],
           [(5 * i) % 250 + 2 for i in range(21)],
           [(7 * i) % 250 + 2 for i in range(34)],
           [(13 * i) % 240 + 2 for i in range(70)]]


def _greedy(n, **kw):
    return SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True, **kw)


def _drive(eng, reqs, max_steps=3000):
    for _ in range(max_steps):
        eng.step()
        if all(r.finish_reason for r in reqs):
            break
    assert all(r.finish_reason for r in reqs)
    return [list(r.output_tokens) for r in reqs]


def _goldens():
    return json.load(open(GOLDENS))


def _replay(eng, section):
    for p in _goldens()["prompts"]:
        want = p[section]
        req = eng.submit(list(p["prompt_tokens"]),
                         _greedy(len(want["greedy_tokens"]), logprobs=True))
        assert _drive(eng, [req])[0] == want["greedy_tokens"], p["text"]
        np.testing.assert_allclose(req.output_logprobs, want["logprobs"],
                                   rtol=0, atol=2e-3, err_msg=p["text"])


@pytest.mark.parametrize("section", list(MODES))
def test_goldens(section):
    quant, kv = MODES[section]
    eng = InferenceEngine(EngineConfig(**REAL, quantization=quant, kv_dtype=kv),
                          device="cpu")
    assert eng.model.moe_impl == "ragged"
    _replay(eng, section)


@pytest.mark.parametrize("how", ["async", "eager_loop", "grouped", "dense"])
def test_fp32_goldens_through(how):
    """``fp32`` through the async loop, the eager reference loop, and the
    card's bf16 (grouped) and fp32 (dense) expert forms."""
    cfg = EngineConfig(**REAL, kv_dtype="float32", async_dispatch=how == "async")
    eng = InferenceEngine(cfg, device="cpu", _eager_decode=how == "eager_loop")
    if how in ("grouped", "dense"):
        eng.model.moe_impl = how
    assert (eng.window is None) == (how == "eager_loop")
    _replay(eng, "fp32")


def test_goldens_batched_together():
    """Every golden prompt in flight at once: packed prefill and batched
    decode through the MoE layers give each its fp32 continuation."""
    eng = InferenceEngine(EngineConfig(**{**REAL, "max_num_seqs": 8},
                                       kv_dtype="float32"), device="cpu")
    golden = _goldens()
    reqs = [eng.submit(list(p["prompt_tokens"]),
                       _greedy(len(p["fp32"]["greedy_tokens"])))
            for p in golden["prompts"]]
    outs = _drive(eng, reqs)
    assert eng.counters["prefill_packed_steps_total"] > 0
    for p, out in zip(golden["prompts"], outs):
        assert out == p["fp32"]["greedy_tokens"], p["text"]


def _gpt_oss_tiny(pkg_model):
    """gpt-oss-20b's preset at a tiny width (8 experts, top-4, a window of
    8 tokens on every other layer), in either package's metadata."""
    md = pkg_model("gpt-oss-20b")
    return dataclasses.replace(md, name="gpt-oss-tiny", arch=dataclasses.replace(
        md.arch, vocab_size=300, hidden_size=64, num_layers=4, num_heads=4,
        num_kv_heads=2, head_dim=32, intermediate_size=64, num_experts=8,
        moe_intermediate_size=64, sliding_window=8, max_position_embeddings=512))


@pytest.mark.parametrize("name", ["tiny-moe-real", "gpt-oss-tiny"])
def test_matches_the_jax_engine_on_the_same_weights(name):
    """The slice end to end: JAX engine and port, one set of weights, the
    same concurrent traffic, the same greedy tokens."""
    base = dict(model=name, max_model_len=256, page_size=16, max_num_seqs=4,
                dtype="float32", kv_dtype="float32", prefill_buckets=(32, 64, 128),
                seed=0, enable_prefix_caching=False)
    jmd = _gpt_oss_tiny(jax_model) if name == "gpt-oss-tiny" else None
    tmd = _gpt_oss_tiny(get_model_by_name) if name == "gpt-oss-tiny" else None
    jeng = JaxEngine(JaxConfig(**base), metadata=jmd)
    assert jeng.model.moe_impl == "ragged"
    jreqs = [jeng.submit(list(p), JaxParams(max_tokens=6, temperature=0.0,
                                            ignore_eos=True))
             for p in PROMPTS[:3]]
    want = _drive(jeng, jreqs)
    arch = (tmd or get_model_by_name(name)).arch
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), arch)
    eng = InferenceEngine(EngineConfig(**base), metadata=tmd, params=params,
                          device="cpu")
    got = _drive(eng, [eng.submit(list(p), _greedy(6)) for p in PROMPTS[:3]])
    assert got == want


def test_tensor_parallel_moe_raises():
    cfg = EngineConfig(**REAL, kv_dtype="float32", tensor_parallel=2)
    with pytest.raises(NotImplementedError, match="M17"):
        InferenceEngine(cfg, device="cpu",
                        mesh=build_mesh(tensor=2, devices=["cpu", "cpu"]))


def test_server_serves_tiny_moe_real():
    """A completion over HTTP carries the tokens the engine produces for
    the same prompt; a streamed chat ends with its usage."""
    cfg = EngineConfig(**{**REAL, "max_num_seqs": 4}, kv_dtype="float32")
    eng = InferenceEngine(cfg, device="cpu")
    eng.start()
    server = tserver.make_server(eng, cfg, host="127.0.0.1", port=0, device="cpu")
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        want = list(eng.submit(eng.tokenizer.encode("The river "), _greedy(8)).stream())
        body = dict(model="tiny-moe-real", prompt="The river ", max_tokens=8,
                    temperature=0.0)
        req = urllib.request.Request(f"{base}/v1/completions",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            resp = json.loads(r.read())
        assert resp["choices"][0]["text"] == eng.tokenizer.decode(want)
        assert resp["usage"]["completion_tokens"] == 8
        chat = dict(model="tiny-moe-real", max_tokens=6, stream=True,
                    messages=[{"role": "user", "content": "Hello"}],
                    stream_options={"include_usage": True})
        req = urllib.request.Request(f"{base}/v1/chat/completions",
                                     data=json.dumps(chat).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            lines = [ln for ln in r.read().decode().splitlines()
                     if ln.startswith("data: ")]
        assert lines[-1] == "data: [DONE]"
        assert json.loads(lines[-2][6:])["usage"]["completion_tokens"] == 6
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()
        th.join(timeout=10)


def test_server_takes_gpt_oss_20b(monkeypatch):
    """``--model gpt-oss-20b`` reaches the engine config with no new flag
    (the engine itself is built on the card by ``chip_smoke.py``; ``main``
    builds it before ``make_server``, so the engine is what stops here)."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_engine(cfg, device="cuda"):
        seen["cfg"] = cfg
        raise Stop

    monkeypatch.setattr(tserver, "InferenceEngine", fake_engine)
    with pytest.raises(Stop):
        tserver.main(["--model", "gpt-oss-20b", "--device", "cpu"])
    assert seen["cfg"].model == "gpt-oss-20b"
