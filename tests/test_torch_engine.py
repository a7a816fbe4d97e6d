"""The port's engine on the CPU: task-level goldens, scheduler
equivalences and the gates this slice does not port.

- ``tiny-llama-real`` (the committed trained checkpoint) reproduces the
  fp32 goldens of ``tests/testdata/goldens_tiny-llama-real.json``:
  greedy tokens exact, logprobs within atol 2e-3, as
  ``tests/test_real_checkpoint.py`` holds the JAX engine.
- Greedy output is the same whether fresh prompts are segment-packed or
  prefilled one by one, chunked, preempted, or decoded in fused windows
  (``tests/test_prefill_pack.py`` holds the JAX engine to the first).
- The JAX engine and the port, given the same weights, emit the same
  greedy tokens for the same concurrent traffic.
"""

import json
import os

import jax
import numpy as np
import pytest

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.engine import SamplingParams as JaxParams
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.model import params_from_jax
from kaito_tpu_torch.models import get_model_by_name
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "testdata", "goldens_tiny-llama-real.json")

BASE = dict(model="tiny-llama-test", max_model_len=512, page_size=16,
            max_num_seqs=4, dtype="float32", kv_dtype="float32",
            prefill_buckets=(32, 64, 128, 256), seed=0,
            enable_prefix_caching=False)
PROMPTS = [
    [(3 * i) % 1900 + 2 for i in range(9)],
    [(5 * i) % 1900 + 2 for i in range(21)],
    [(7 * i) % 1900 + 2 for i in range(34)],
    [(11 * i) % 1900 + 2 for i in range(65)],
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


def _mk(**kw):
    return InferenceEngine(EngineConfig(**{**BASE, **kw}), device="cpu")


def _run(eng, prompts, n=8):
    return _drive(eng, [eng.submit(list(p), _greedy(n)) for p in prompts])


@pytest.fixture(scope="module")
def serial_ref():
    """Serial round-robin output of PROMPTS (the reference schedule)."""
    eng = _mk(prefill_pack=1)
    return _run(eng, PROMPTS), eng.counters


# ---------------------------------------------------------------------------
# goldens
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def real_engine():
    cfg = EngineConfig(model="tiny-llama-real",
                       weights_dir=os.path.join(REPO, "checkpoints",
                                                "tiny-llama-real"),
                       dtype="float32", kv_dtype="float32", max_model_len=512,
                       max_num_seqs=2, prefill_buckets=(64, 128),
                       enable_prefix_caching=False, seed=0)
    eng = InferenceEngine(cfg, device="cpu")
    eng.start()
    yield eng, json.load(open(GOLDENS))
    eng.stop()


def test_golden_greedy_tokens_and_logprobs(real_engine):
    eng, golden = real_engine
    for p in golden["prompts"]:
        want = p["fp32"]["greedy_tokens"]
        req = eng.submit(list(p["prompt_tokens"]),
                         _greedy(len(want), logprobs=True))
        assert list(req.stream()) == want, p["text"]
        np.testing.assert_allclose(req.output_logprobs, p["fp32"]["logprobs"],
                                   rtol=0, atol=2e-3, err_msg=p["text"])


def test_golden_prompts_batched_together(real_engine):
    """All golden prompts in flight at once (packed prefill, batched
    decode) still reproduce each one's greedy continuation."""
    eng, golden = real_engine
    reqs = [eng.submit(list(p["prompt_tokens"]),
                       _greedy(len(p["fp32"]["greedy_tokens"])))
            for p in golden["prompts"]]
    for p, r in zip(golden["prompts"], reqs):
        assert list(r.stream()) == p["fp32"]["greedy_tokens"], p["text"]


# ---------------------------------------------------------------------------
# scheduler equivalences
# ---------------------------------------------------------------------------

def test_pack_matches_serial(serial_ref):
    ref, serial_counters = serial_ref
    packed = _mk(prefill_pack=0)
    assert _run(packed, PROMPTS) == ref
    c = packed.counters
    assert c["prefill_steps_total"] < serial_counters["prefill_steps_total"]
    assert c["prefill_tokens_total"] == serial_counters["prefill_tokens_total"]
    assert c["prefill_packed_steps_total"] > 0


def test_pack_one_is_the_serial_scheduler(serial_ref):
    ref, serial_counters = serial_ref
    eng = _mk(prefill_pack=1)
    assert _run(eng, PROMPTS) == ref
    assert eng.counters["prefill_steps_total"] == serial_counters["prefill_steps_total"]
    assert eng.counters["prefill_packed_steps_total"] == 0


def test_long_prompt_straddles_chunks():
    """A prompt longer than the token budget is prefilled in chunks
    (continuation chunks attend over the paged history) and still
    matches the serial schedule."""
    prompts = [[(13 * i) % 1800 + 2 for i in range(200)]] + PROMPTS[:2]
    ref = _run(_mk(prefill_pack=1, max_prefill_tokens=48), prompts)
    packed = _mk(prefill_pack=0, max_prefill_tokens=48)
    assert _run(packed, prompts) == ref
    assert packed.counters["prefill_steps_total"] >= 5


def test_fused_decode_windows_match_single_steps(serial_ref):
    ref, _ = serial_ref
    eng = _mk(prefill_pack=1, decode_run_ahead=4)
    assert _run(eng, PROMPTS) == ref
    assert eng.counters["decode_windows_total"] < eng.counters["decode_steps_total"]


def test_preemption_resumes_seamlessly():
    """A pool too small for every sequence forces preemption; resumed
    sequences re-prefill prompt + output and finish identically."""
    prompts = PROMPTS[:3]
    ref = _run(_mk(prefill_pack=1), prompts, n=40)
    # 9 usable pages of 16 tokens; the three sequences need 13
    small = _mk(prefill_pack=1, max_model_len=128, max_pages=10)
    assert _run(small, prompts, n=40) == ref
    assert small.counters["preemptions_total"] > 0


def test_matches_the_jax_engine_on_the_same_weights():
    """The slice end to end: JAX engine and port, one set of weights,
    the same concurrent traffic, the same greedy tokens."""
    jcfg = JaxConfig(**BASE)
    jeng = JaxEngine(jcfg)
    jreqs = [jeng.submit(list(p), JaxParams(max_tokens=6, temperature=0.0,
                                            ignore_eos=True))
             for p in PROMPTS[:3]]
    want = _drive(jeng, jreqs)
    arch = get_model_by_name(BASE["model"]).arch
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), arch)
    eng = InferenceEngine(EngineConfig(**BASE), params=params, device="cpu")
    assert _run(eng, PROMPTS[:3], n=6) == want


# ---------------------------------------------------------------------------
# request semantics
# ---------------------------------------------------------------------------

def test_stop_token_ends_the_request():
    ref = _run(_mk(), PROMPTS[:1], n=8)[0]
    eng = _mk()
    req = eng.submit(PROMPTS[0], _greedy(8, stop_token_ids=(ref[3],)))
    out = _drive(eng, [req])[0]
    assert req.finish_reason == "stop"
    assert out == ref[:ref.index(ref[3]) + 1]


def test_abort_retires_the_slot():
    eng = _mk()
    req = eng.submit(PROMPTS[1], _greedy(100))
    for _ in range(5):
        eng.step()
    eng.abort(req)
    _drive(eng, [req])
    assert len(req.output_tokens) < 100
    assert eng.allocator.available == eng.allocator.num_pages - 1


def test_sampled_requests_are_seeded_and_valid():
    def run():
        eng = _mk()
        reqs = [eng.submit(p, SamplingParams(max_tokens=10, temperature=0.9,
                                             top_k=50, top_p=0.9,
                                             repetition_penalty=1.2,
                                             ignore_eos=True))
                for p in PROMPTS[:2]]
        return _drive(eng, reqs)

    a, b = run(), run()
    assert a == b                       # one engine seed, one draw stream
    V = get_model_by_name(BASE["model"]).arch.vocab_size
    assert all(len(o) == 10 and all(0 <= t < V for t in o) for o in a)


def test_submit_validates_input():
    eng = _mk()
    with pytest.raises(ValueError):
        eng.submit([], _greedy(4))
    with pytest.raises(ValueError):
        eng.submit(list(range(600)), _greedy(4))
    with pytest.raises(ValueError):
        eng.submit([1, 2], _greedy(0))


# ---------------------------------------------------------------------------
# gates this slice does not port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field,value,item", [
    ("tensor_parallel", 2, "M19"),
    ("pipeline_parallel", 2, "M19"),
    ("data_parallel", 2, "M19"),
    ("sequence_parallel", 2, "M19"),
    ("expert_parallel", 2, "M19"),
    ("kv_pool_enabled", True, "M18"),
    ("kv_pool_disk_bytes", 1 << 20, "M18"),
    ("pd_enabled", True, "M18"),
])
def test_unported_gates_raise(field, value, item):
    with pytest.raises(NotImplementedError, match=item):
        _mk(**{field: value})


@pytest.mark.parametrize("field,value", [
    ("speculative_ngram", 3),
    ("speculative_draft", "tiny-llama-test"),
])
def test_speculation_gates_build(field, value):
    """The two M14 gates build an engine that serves: greedy output equal
    to the plain engine's, through at least one verify round."""
    eng = _mk(**{field: value})
    assert eng.spec_verify is not None
    assert (eng.spec_draft is not None) == (field == "speculative_draft")
    prompt = [7, 11, 13, 7, 11, 13, 7, 11, 13, 7, 11]
    assert _run(eng, [prompt], n=12) == _run(_mk(), [prompt], n=12)
    assert eng.counters["spec_steps_total"] > 0


@pytest.mark.parametrize("field,value", [
    ("adapters_dir", "/nonexistent"),
    ("adapter_slots", 2),
])
def test_adapter_gates_build(field, value):
    """The two M16 gates build an engine that serves: with no adapter
    found (an empty slot table), base output equal to the plain
    engine's, and an unknown adapter refused at submission."""
    eng = _mk(**{field: value})
    assert (eng.adapter_cache is not None) == (field == "adapter_slots")
    assert eng.adapter_index == {}
    assert _run(eng, PROMPTS[:2], n=6) == _run(_mk(), PROMPTS[:2], n=6)
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit([1, 2, 3], _greedy(2), adapter="nope")


def test_prefix_caching_default_runs_on_the_plain_allocator(caplog):
    """Prefix caching is on by default and builds the radix tree (the
    plain allocator serves only with it off, and for MLA, as in the JAX
    engine); output is the same as with it off."""
    from kaito_tpu_torch.engine.engine import PageAllocator
    from kaito_tpu_torch.engine.prefix_cache import PrefixCache
    from kaito_tpu_torch.models.autogen import metadata_from_hf_config
    from tests.test_torch_mla import CONFIGS

    assert EngineConfig().enable_prefix_caching
    with caplog.at_level("INFO"):
        eng = InferenceEngine(EngineConfig(**{**BASE, "enable_prefix_caching": True}),
                              device="cpu")
    assert "radix tree" in caplog.text
    assert isinstance(eng.prefix_cache, PrefixCache) and eng.allocator is eng.prefix_cache
    assert _run(eng, PROMPTS[:1], n=4)[0] == _run(_mk(), PROMPTS[:1], n=4)[0]
    assert isinstance(_mk().allocator, PageAllocator) and _mk().prefix_cache is None
    mla = InferenceEngine(
        EngineConfig(model="tiny-mla-test", max_model_len=128, page_size=16,
                     max_num_seqs=2, dtype="float32", prefill_buckets=(16, 32, 64)),
        metadata=metadata_from_hf_config("test/q_lora", CONFIGS["q_lora"],
                                         name="tiny-mla-test"),
        device="cpu")
    assert mla.cfg.enable_prefix_caching and mla.prefix_cache is None
    assert isinstance(mla.allocator, PageAllocator)
