"""The decode window (``kaito_tpu_torch.engine.decode_graph``) on the CPU.

On the card a window is captured once per key and replayed as a CUDA
graph; on the CPU the same object runs its body eagerly on the same
static buffers, which is how these tests hold the buffer plumbing:

- The engine's static-buffer window emits exactly what the eager
  reference loop (``InferenceEngine(..., _eager_decode=True)``, which
  uploads fresh tensors every window) emits, token for token and
  logprob for logprob, for windows of K = 1, 2 and 4, greedy and
  sampled from the same seed, with and without penalties: on the CPU
  both run the same operations in the same order.
- No static input, window output or sampler mirror is replaced across
  windows, ``set_slot`` calls and batch epochs: a captured graph keeps
  the pointers it was captured with.
- ``TransformerLM`` keeps its embedding multiplier on the device once
  built (a host copy per call cannot be captured); its decode logits
  still match the JAX model's with a multiplier (fp32 atol 1e-4, as
  ``tests/test_torch_model.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaito_tpu.engine.kv_cache import create_kv_cache as j_cache
from kaito_tpu.engine.model import TransformerLM as JaxLM
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.decode_graph import DecodeWindow
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.kv_cache import create_kv_cache as t_cache
from kaito_tpu_torch.engine.model import TransformerLM, params_from_jax
from kaito_tpu_torch.models import get_model_by_name
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

BASE = dict(model="tiny-llama-test", max_model_len=256, page_size=16,
            max_num_seqs=4, dtype="float32", kv_dtype="float32",
            prefill_buckets=(32, 64, 128), seed=3, enable_prefix_caching=False)
PROMPTS = [[(3 * i) % 1900 + 2 for i in range(9)],
           [(5 * i) % 1900 + 2 for i in range(21)],
           [(7 * i) % 1900 + 2 for i in range(40)]]


def _mk(**kw):
    eager = kw.pop("_eager_decode", False)
    return InferenceEngine(EngineConfig(**{**BASE, **kw}), device="cpu",
                           _eager_decode=eager)


def _params(i, sampled, penalties):
    kw = dict(max_tokens=14 + 3 * i, ignore_eos=True, logprobs=True)
    if sampled:
        kw.update(temperature=0.8, top_k=20 if i == 0 else 0,
                  top_p=0.9 if i == 1 else 1.0)
    else:
        kw.update(temperature=0.0)
    if penalties and i != 2:
        kw.update(repetition_penalty=1.3, presence_penalty=0.4,
                  frequency_penalty=0.2)
    return SamplingParams(**kw)


def _serve(eng, sampled, penalties, max_steps=500):
    reqs = [eng.submit(list(p), _params(i, sampled, penalties))
            for i, p in enumerate(PROMPTS)]
    for _ in range(max_steps):
        eng.step()
        if all(r.finish_reason for r in reqs):
            break
    assert all(r.finish_reason == "length" for r in reqs)
    return [(r.output_tokens, r.output_logprobs) for r in reqs]


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("penalties", [False, True])
def test_window_matches_the_eager_reference(K, sampled, penalties):
    ref = _mk(decode_run_ahead=K, _eager_decode=True)
    assert ref.window is None
    eng = _mk(decode_run_ahead=K)
    assert eng.window is not None and not eng.window.capture
    want = _serve(ref, sampled, penalties)
    got = _serve(eng, sampled, penalties)
    assert got == want
    for key in ("decode_steps_total", "decode_windows_total", "generation_tokens_total"):
        assert eng.counters[key] == ref.counters[key], key
    if K > 1:
        assert eng.counters["decode_windows_total"] < eng.counters["decode_steps_total"]
    # nothing is captured on the CPU
    assert eng.counters["decode_graph_captures_total"] == 0
    assert eng.counters["decode_graph_replays_total"] == 0


def _ptrs(eng):
    w = eng.window
    ptrs = {f"in.{k}": t.data_ptr() for k, t in w.inputs.items()}
    ptrs.update({f"out.{K}.{i}": t.data_ptr() for K, out in w._eager.items()
                 for i, t in enumerate(out)})
    ptrs.update({f"knob.{k}": t.data_ptr() for k, t in eng.sampling._dev.items()})
    return ptrs


def test_static_buffers_keep_their_storage():
    eng = _mk(decode_run_ahead=2)
    first = eng.submit(PROMPTS[0], SamplingParams(max_tokens=30, temperature=0.7,
                                                  ignore_eos=True))
    for _ in range(4):
        eng.step()
    before = _ptrs(eng)
    assert set(before) >= {"in.stop", "in.page_tables", "out.2.0", "knob.top_p"}
    epoch = eng._batch_epoch
    # admissions (set_slot, new batch epochs), a penalized request,
    # evictions: every window reads the same buffers
    later = [eng.submit(p, SamplingParams(max_tokens=6 + i, temperature=0.5 * i,
                                          repetition_penalty=1.1, ignore_eos=True))
             for i, p in enumerate(PROMPTS[1:])]
    for _ in range(200):
        eng.step()
        after = _ptrs(eng)
        assert {k: after[k] for k in before} == before
        if first.finish_reason and all(r.finish_reason for r in later):
            break
    assert eng._batch_epoch > epoch + 4
    assert all(r.finish_reason == "length" for r in [first] + later)


def test_capture_needs_a_card():
    with pytest.raises(ValueError, match="card"):
        DecodeWindow(lambda *a: None, 2, 4, 8, torch.device("cpu"),
                     capture=True, counters={})


def test_embedding_multiplier_matches_jax():
    arch = dataclasses.replace(get_model_by_name("tiny-llama-test").arch,
                               embedding_multiplier=2.5)
    jm = JaxLM(arch, dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(1))
    tm = TransformerLM(arch, dtype=torch.float32, device="cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, jp), arch))
    assert tm._embed_scale is not None
    rng = np.random.RandomState(2)
    B, T, PS, P = 2, 8, 16, 8
    toks = rng.randint(0, arch.vocab_size, size=(B, T)).astype(np.int32)
    tl = np.array([8, 5], np.int32)
    pt = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    jc = j_cache(arch, P, PS, jnp.float32)
    tc = t_cache(arch, P, PS, torch.float32, "cpu")
    jc, jl, _ = jm.prefill(jp, jc, jnp.asarray(toks), jnp.asarray(tl), jnp.asarray(pt))
    tc, tl_, _ = tm.prefill(tc, torch.from_numpy(toks), torch.from_numpy(tl),
                            torch.from_numpy(pt))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
    jc, jl = jm.decode(jp, jc, jnp.asarray(nxt), jnp.asarray(tl), jnp.asarray(pt))
    tc, tl_ = tm.decode(tc, torch.from_numpy(nxt), torch.from_numpy(tl),
                        torch.from_numpy(pt))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
