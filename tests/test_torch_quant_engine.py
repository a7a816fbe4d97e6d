"""The port's engine serving quantized modes on the CPU.

- ``tiny-llama-real`` (the committed trained checkpoint) in fp32
  reproduces the ``int8``, ``weight_int4`` and ``kv_int8`` goldens of
  ``tests/testdata/goldens_tiny-llama-real.json``: greedy tokens exact,
  logprobs within atol 2e-3, as ``tests/test_real_checkpoint.py`` holds
  the JAX engine.
- A JAX tree from ``quantize_params`` crosses over through
  ``params_from_jax``; with int4 weights and an int8 KV cache together
  the port's greedy tokens equal the JAX engine's, with packed and with
  serial prefill, and with prompts that straddle prefill chunks.
- Unknown schemes raise ``ValueError``; the server's ``--quantization``
  and ``--kv-cache-dtype int8`` reach the engine config.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.engine import SamplingParams as JaxParams
from kaito_tpu_torch.engine import server as tserver
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.model import params_from_jax
from kaito_tpu_torch.engine.quant import is_qtensor
from kaito_tpu_torch.models import get_model_by_name
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "testdata", "goldens_tiny-llama-real.json")

BASE = dict(model="tiny-llama-test", max_model_len=512, page_size=16,
            max_num_seqs=4, dtype="float32", prefill_buckets=(32, 64, 128, 256),
            seed=0, enable_prefix_caching=False)
PROMPTS = [
    [(3 * i) % 1900 + 2 for i in range(9)],
    [(5 * i) % 1900 + 2 for i in range(21)],
    [(7 * i) % 1900 + 2 for i in range(34)],
    [(13 * i) % 1800 + 2 for i in range(70)],
]


def _greedy(n, **kw):
    return SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True, **kw)


def _drive(eng, reqs, max_steps=3000):
    for _ in range(max_steps):
        eng.step()
        if all(r.finish_reason for r in reqs):
            break
    assert all(r.finish_reason for r in reqs)
    return [list(r.output_tokens) for r in reqs]


def _real_engine(quant, kv_dtype):
    cfg = EngineConfig(model="tiny-llama-real",
                       weights_dir=os.path.join(REPO, "checkpoints",
                                                "tiny-llama-real"),
                       dtype="float32", kv_dtype=kv_dtype, max_model_len=512,
                       max_num_seqs=2, prefill_buckets=(64, 128),
                       enable_prefix_caching=False, quantization=quant, seed=0)
    return InferenceEngine(cfg, device="cpu")


MODES = [("int8", "float32", "int8"), ("int4", "float32", "weight_int4"),
         ("", "int8", "kv_int8")]


@pytest.mark.parametrize("quant,kv_dtype,section", MODES)
def test_quantized_goldens(quant, kv_dtype, section):
    eng = _real_engine(quant, kv_dtype)
    golden = json.load(open(GOLDENS))
    for p in golden["prompts"]:
        want = p[section]
        req = eng.submit(list(p["prompt_tokens"]),
                         _greedy(len(want["greedy_tokens"]), logprobs=True))
        assert _drive(eng, [req])[0] == want["greedy_tokens"], p["text"]
        np.testing.assert_allclose(req.output_logprobs, want["logprobs"],
                                   rtol=0, atol=2e-3, err_msg=p["text"])


def test_kv_int8_goldens_batched_together():
    """All golden prompts in flight at once: packed prefill into int8
    pages and batched int8 decode give each its kv_int8 continuation."""
    eng = _real_engine("", "int8")
    golden = json.load(open(GOLDENS))
    reqs = [eng.submit(list(p["prompt_tokens"]),
                       _greedy(len(p["kv_int8"]["greedy_tokens"])))
            for p in golden["prompts"]]
    outs = _drive(eng, reqs)
    assert eng.counters["prefill_packed_steps_total"] > 0
    for p, out in zip(golden["prompts"], outs):
        assert out == p["kv_int8"]["greedy_tokens"], p["text"]


def test_weights_are_held_quantized():
    eng = _real_engine("int4", "int8")
    tree = eng.model.param_tree()
    assert is_qtensor(tree["dense"]["q"]) and tree["dense"]["q"]["q4"].dtype == torch.int8
    assert not is_qtensor(tree["dense"]["attn_norm"])
    assert tree["lm_head"].dtype == torch.float32
    plain = _real_engine("", "float32")
    assert eng.model.param_bytes() < plain.model.param_bytes()
    assert eng.cache.k.dtype == torch.int8 and eng.cache.quantized


@pytest.mark.parametrize("pack,budget", [(0, 512), (1, 512), (0, 48)],
                         ids=["packed", "serial", "chunked"])
def test_int4_weights_and_int8_kv_match_the_jax_engine(pack, budget):
    """The JAX engine quantizes its own synthetic weights; the port takes
    that quantized tree (int8 codes, fp32 scales) and serves the same
    concurrent traffic to the same greedy tokens."""
    cfg = dict(BASE, kv_dtype="int8", quantization="int4", prefill_pack=pack,
               max_prefill_tokens=budget)
    jeng = JaxEngine(JaxConfig(**cfg))
    jreqs = [jeng.submit(list(p), JaxParams(max_tokens=6, temperature=0.0,
                                            ignore_eos=True))
             for p in PROMPTS]
    want = _drive(jeng, jreqs)
    arch = get_model_by_name(BASE["model"]).arch
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), arch)
    assert params["dense"]["down"]["q4"].dtype == torch.int8
    assert params["dense"]["down"]["scale"].dtype == torch.float32
    eng = InferenceEngine(EngineConfig(**cfg), params=params, device="cpu")
    got = _drive(eng, [eng.submit(list(p), _greedy(6)) for p in PROMPTS])
    assert got == want
    if pack == 0 and budget == 512:
        assert eng.counters["prefill_packed_steps_total"] > 0
    if budget == 48:
        assert eng.counters["prefill_steps_total"] >= 4


def test_plain_tree_is_quantized_like_the_jax_engine():
    """A plain JAX tree handed over with ``quantization`` set is quantized
    by the port after the cast, as the JAX engine quantizes it."""
    cfg = dict(BASE, kv_dtype="float32", quantization="int8")
    jeng = JaxEngine(JaxConfig(**{**cfg, "quantization": ""}))
    arch = get_model_by_name(BASE["model"]).arch
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), arch)
    eng = InferenceEngine(EngineConfig(**cfg), params=params, device="cpu")
    jq = JaxEngine(JaxConfig(**cfg), params=jeng.params)
    for k, v in jax.tree.map(np.asarray, jq.params["dense"]["q"]).items():
        np.testing.assert_array_equal(eng.model.param_tree()["dense"]["q"][k].numpy(), v)


@pytest.mark.parametrize("quant", ["int3", "fp8", "INT8"])
def test_unknown_scheme_raises_before_loading(quant):
    with pytest.raises(ValueError, match="unknown quantization"):
        InferenceEngine(EngineConfig(**BASE, quantization=quant), device="cpu")


def test_unknown_kv_dtype_raises():
    with pytest.raises(ValueError, match="kv_dtype"):
        InferenceEngine(EngineConfig(**{**BASE, "kv_dtype": "fp8"}), device="cpu")


def test_server_flags_reach_the_engine_config(monkeypatch):
    seen = {}

    class Stop(Exception):
        pass

    def fake_make_server(engine, cfg, host="0.0.0.0", port=None, device="cuda"):
        seen["cfg"], seen["device"] = cfg, device
        raise Stop

    monkeypatch.setattr(tserver, "make_server", fake_make_server)
    with pytest.raises(Stop):
        tserver.main(["--model", "tiny-llama-test", "--device", "cpu",
                      "--quantization", "int4", "--kv-cache-dtype", "int8"])
    assert seen["cfg"].quantization == "int4" and seen["cfg"].kv_dtype == "int8"
    with pytest.raises(SystemExit):
        tserver.main(["--model", "tiny-llama-test", "--quantization", "int3"])
