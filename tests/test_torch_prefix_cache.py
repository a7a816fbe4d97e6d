"""The port's prefix cache (``engine/prefix_cache.py``) against the JAX
package's native one, and through the engine against the JAX engine.

- ``PrefixCache`` against ``kaito_tpu.native.NativePrefixCache`` on op
  sequences drawn with hypothesis over a small pool (16-64 pages of 4
  tokens), used as the engine uses it (a release covers at least the
  shared prefix): page IDs equal up to the first eviction; ``None``
  results, ``cached_tokens``, ``available`` and ``stats()`` equal at
  every step until an eviction has to choose among nodes released in
  the same tick (the native code takes whichever its hash map visits
  first, the port the oldest insertion); page 0 never handed out, no
  page held twice, and every page available once all is released.
- Port twins of ``tests/test_prefix_caching.py``.
- The engine against the JAX engine (native tree, ``tiny-llama-test``,
  fp32) on one schedule of repeated and diverging prompts: greedy
  tokens, ``prefix_cached_tokens_total`` and the hit and miss counters,
  in the sync loop, the async loop, at TP=2 on a CPU mesh, and with an
  int8 KV pool (fresh engines: a reused int8 page keeps the scale its
  last owner grew).  A tiny MLA engine builds no tree.
- ``tiny-llama-real``'s goldens in all four modes with the tree on, each
  prompt served twice: the second run is a prefix hit.
"""

import json
import os

import jax
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.engine import SamplingParams as JaxParams
from kaito_tpu.native import NativePrefixCache, load_native
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.model import params_from_jax
from kaito_tpu_torch.engine.prefix_cache import PrefixCache
from kaito_tpu_torch.models import get_model_by_name
from kaito_tpu_torch.parallel.mesh import build_mesh
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "testdata", "goldens_tiny-llama-real.json")

native = pytest.mark.skipif(load_native() is None,
                            reason="native toolchain unavailable")


# ---------------------------------------------------------------------------
# PrefixCache against NativePrefixCache
# ---------------------------------------------------------------------------

# prompt stems that share and diverge at page (4-token) edges
_STEMS = ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12], [1, 2, 3, 4, 9, 9, 9, 9],
          [5, 5, 5, 5, 6, 6, 6, 6, 7], [1, 2, 3, 4, 5, 6, 7, 8, 0, 0, 0, 0, 1])


def _tie_broken(cache, before, evictions_before) -> bool:
    """Did the op just run evict among nodes of one release tick?
    ``before`` maps every evictable node key to its tick at the start."""
    k = cache.evictions - evictions_before
    if not k:
        return False
    ticks = sorted(t for key, t in before.items()
                   if key not in cache._nodes or cache._nodes[key].refcount == 0)
    return k < len(ticks) and ticks[k - 1] == ticks[k]


@native
@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.data())
def test_prefix_cache_matches_the_native_tree(data):
    n = data.draw(st.integers(16, 64), label="num_pages")
    port, ref = PrefixCache(n, 4), NativePrefixCache(n, 4)
    held = []      # (tokens, port pages, native pages, shared tokens)
    exact = True   # no eviction has had to break a tie yet
    for _ in range(data.draw(st.integers(10, 60), label="ops")):
        before = {k: nd.lru for k, nd in port._nodes.items() if nd.refcount == 0}
        ev0 = port.evictions
        op = data.draw(st.sampled_from(["acquire", "acquire", "release",
                                        "uncommitted", "grow"]))
        if op == "acquire":
            stem = data.draw(st.sampled_from(_STEMS))
            toks = stem[:data.draw(st.integers(1, len(stem)))] + data.draw(
                st.lists(st.integers(0, 3), max_size=6))
            total = len(toks) + data.draw(st.integers(1, 6))
            a, b = port.acquire(toks, total), ref.acquire(toks, total)
            if exact:
                assert (a is None) == (b is None)
            if a is not None and b is not None:
                if exact:
                    assert a[1] == b[1]
                if port.evictions == 0:
                    assert a[0] == [int(p) for p in b[0]]
                held.append((toks, a[0], [int(p) for p in b[0]], max(a[1], b[1])))
            elif a is not None:
                port.release_uncommitted(toks, a[0])
            elif b is not None:
                ref.release_uncommitted(toks, b[0])
        elif op in ("release", "uncommitted") and held:
            toks, pa, pb, shared = held.pop(data.draw(st.integers(0, len(held) - 1)))
            # what landed: at least the shared prefix, maybe generated tokens
            written = (toks + data.draw(st.lists(st.integers(0, 3), max_size=5)))[
                :data.draw(st.integers(shared, len(toks) + 5))]
            if op == "release":
                port.release(written, pa)
                ref.release(written, pb)
            else:
                port.release_uncommitted(written, pa)
                ref.release_uncommitted(written, pb)
        elif op == "grow":
            k = data.draw(st.integers(0, 3))
            a, b = port.alloc_raw(k), ref.alloc_raw(k)
            if exact:
                assert (a is None) == (b is None)
            if a is not None and b is not None:
                b = [int(p) for p in b]
                if port.evictions == 0:
                    assert a == b
                if held:
                    t, pa, pb, s = held[-1]
                    held[-1] = (t, pa + a, pb + b, s)
                else:
                    port.release([], a)
                    ref.release([], b)
            elif a is not None:
                port.release([], a)
            elif b is not None:
                ref.release([], b)
        exact = exact and not _tie_broken(port, before, ev0)
        if exact:
            assert port.available == ref.available
            assert port.stats() == ref.stats()
        taken = [p for _, pa, _, _ in held for p in pa]
        assert 0 not in taken
        # a page is held twice only when both holders share its node
        shared_pages = {nd.page for nd in port._nodes.values()}
        assert all(taken.count(p) == 1 for p in taken if p not in shared_pages)
        assert port.available <= n - 1
    for toks, pa, pb, _ in held:
        port.release(toks, pa)
        ref.release(toks, pb)
    assert port.available == n - 1 == ref.available


def test_ties_evict_in_insertion_order_and_lru_first():
    pc = PrefixCache(4, 2)       # pages 1-3
    a, _ = pc.acquire([1, 1, 2, 2], 4)
    pc.release([1, 1, 2, 2], a)          # one tick: [1,1] then [2,2]
    b, _ = pc.acquire([3, 3], 2)
    pc.release([3, 3], b)                # a later tick
    assert pc.available == 3 and pc.stats()["cached_pages"] == 3
    (p,) = pc.alloc_raw(1)
    assert p == a[0]                     # the oldest tick, inserted first
    assert pc.acquire([1, 1, 2, 2], 4)[1] == 0   # its child is unreachable
    assert pc.stats()["evictions"] == 3
    with pytest.raises(ValueError):
        PrefixCache(1, 4)


def test_available_is_constant_time_bookkeeping():
    """``available`` reads counters: no scan of the tree."""
    pc = PrefixCache(2048, 4)
    held = [pc.acquire([i, i, i, i, 7], 6) for i in range(600)]
    for i, (pages, _) in enumerate(held):
        pc.release([i, i, i, i, 7], pages)
    assert pc.available == 2047
    assert len(pc._heap) <= 2 * len(pc._nodes) + 64


def test_release_uncommitted_returns_pages_without_caching():
    pc = PrefixCache(16, 4)
    pc.release(list(range(4)), pc.acquire(list(range(4)), 4)[0])
    assert pc.stats()["cached_pages"] == 1
    avail = pc.available
    toks = list(range(4)) + [9, 9, 9, 9]      # shared page + fresh page
    pages, cached = pc.acquire(toks, 8)
    assert cached == 4
    pc.release_uncommitted(toks, pages)
    assert pc.stats()["cached_pages"] == 1    # nothing new committed
    assert pc.available == avail              # all refs/pages returned


# ---------------------------------------------------------------------------
# the engine's use of the tree (twins of tests/test_prefix_caching.py)
# ---------------------------------------------------------------------------

TWIN = dict(model="tiny-llama-test", max_model_len=256, page_size=16,
            max_num_seqs=2, dtype="float32", kv_dtype="float32",
            prefill_buckets=(32, 64, 128), seed=0)


def _greedy(n, **kw):
    return SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True, **kw)


def _drive(eng, reqs, max_steps=3000):
    for _ in range(max_steps):
        eng.step()
        if all(r.finish_reason for r in reqs):
            break
    assert all(r.finish_reason for r in reqs)
    return [list(r.output_tokens) for r in reqs]


def _one(eng, prompt, n=6):
    return _drive(eng, [eng.submit(list(prompt), _greedy(n))])[0]


def test_prefix_reuse_identical_output():
    plain = InferenceEngine(EngineConfig(**TWIN, enable_prefix_caching=False),
                            device="cpu")
    cached = InferenceEngine(EngineConfig(**TWIN), device="cpu")
    assert cached.prefix_cache is not None
    prompt = list(range(40, 40 + 37))  # 2 full pages + remainder
    ref = _one(plain, prompt)
    assert _one(cached, prompt) == ref
    # the second submission shares the committed prompt pages
    assert _one(cached, prompt) == ref
    assert cached.prefix_cache.stats()["hits"] >= 2
    assert cached.counters["prefix_cached_tokens_total"] >= 32
    # a divergent continuation of the same prefix is also correct
    other = prompt[:32] + [7, 8, 9]
    assert _one(cached, other) == _one(plain, other)
    assert cached.counters["prefix_cache_hits_total"] == 2
    assert cached.counters["prefix_cache_misses_total"] == 1


def test_final_sampled_token_never_committed():
    """A sequence whose prompt + output ends on a page edge commits only
    the pages its written KV fills: the last sampled token's KV never
    lands."""
    eng = InferenceEngine(EngineConfig(**TWIN), device="cpu")
    plain = InferenceEngine(EngineConfig(**TWIN, enable_prefix_caching=False),
                            device="cpu")
    prompt = list(range(100, 127))        # 27 + 5 outputs = 32 = 2 pages
    out = _one(eng, prompt, 5)
    assert len(out) == 5
    # written KV covers 31 tokens -> only ONE full page is cacheable
    assert eng.prefix_cache.stats()["cached_pages"] == 1
    cont = prompt + out
    assert _one(eng, cont, 5) == _one(plain, cont, 5)


def test_pages_reclaimable_after_burst():
    eng = InferenceEngine(EngineConfig(**TWIN), device="cpu")
    reqs = [eng.submit([i * 3 + 1, i * 3 + 2, i * 3 + 3] * 8, _greedy(4))
            for i in range(5)]
    _drive(eng, reqs)
    # every page is free or evictable (refcounts back at zero)
    assert eng.allocator.available == eng.allocator.num_pages - 1


def test_preempted_prefill_returns_its_shared_pages():
    """A prompt whose every page is cached prefills its last token
    again; preempted before that lands, its shared pages still return
    (the written prefix is one token short of the last shared page)."""
    eng = InferenceEngine(EngineConfig(**TWIN), device="cpu")
    prompt = list(range(200, 232))            # exactly 2 pages
    _one(eng, prompt, 3)
    req = eng.submit(list(prompt), _greedy(3))
    eng._admit_new()
    slot = next(i for i, s in enumerate(eng.slots) if s.request is req)
    assert eng.slots[slot].shared_tokens == 32 and eng.slots[slot].written == 31
    eng._preempt_slot(slot)
    assert eng.allocator.available == eng.allocator.num_pages - 1
    assert _drive(eng, [req])[0] == _one(eng, prompt, 3)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

PARITY = dict(model="tiny-llama-test", max_model_len=256, page_size=16,
              max_num_seqs=3, dtype="float32", prefill_buckets=(32, 64, 128),
              max_pages=48, seed=0)
_A = [(3 * i) % 1900 + 2 for i in range(40)]
_B = [(5 * i) % 1900 + 2 for i in range(21)]
_C = [(7 * i) % 1900 + 2 for i in range(48)]      # exactly 3 pages
# rounds run to completion one after another, so every hit is the same
# whatever the loop's timing: repeats, a divergence after two pages, a
# continuation, a whole-prompt hit (its last token prefilled again)
ROUNDS = ([_A, _B],
          [_A, _A[:32] + [7, 8, 9], _B, _C],
          [_A + [11] * 20, _C, _B[:16] + [1]])


def _jax_rounds(jcfg):
    eng = JaxEngine(jcfg)
    assert eng.prefix_cache is not None
    outs = []
    for prompts in ROUNDS:
        reqs = [eng.submit(list(p), JaxParams(max_tokens=6, temperature=0.0,
                                              ignore_eos=True)) for p in prompts]
        outs.append(_drive(eng, reqs))
    return eng, outs


def _port_rounds(eng):
    outs = []
    for prompts in ROUNDS:
        outs.append(_drive(eng, [eng.submit(list(p), _greedy(6)) for p in prompts]))
    return outs


_KEYS = ("prefix_cached_tokens_total", "prefix_cache_hits_total",
         "prefix_cache_misses_total", "prompt_tokens_total",
         "generation_tokens_total")


@pytest.fixture(scope="module")
def jax_reference():
    ref = {}
    for kv in ("float32", "int8"):
        jeng, outs = _jax_rounds(JaxConfig(**PARITY, kv_dtype=kv))
        ref[kv] = (outs, {k: jeng.counters[k] for k in _KEYS},
                   params_from_jax(jax.tree.map(np.asarray, jeng.params),
                                   get_model_by_name("tiny-llama-test").arch))
    return ref


@native
@pytest.mark.parametrize("mode", ["sync", "async", "tp2", "kv_int8"])
def test_engine_matches_the_jax_engine_with_the_tree(jax_reference, mode):
    kv = "int8" if mode == "kv_int8" else "float32"
    want, counters, params = jax_reference[kv]
    cfg = EngineConfig(**PARITY, kv_dtype=kv, async_dispatch=mode == "async",
                       decode_run_ahead=4 if mode == "async" else None)
    mesh = build_mesh(tensor=2, devices=["cpu", "cpu"]) if mode == "tp2" else None
    eng = InferenceEngine(cfg, params=params, device="cpu", mesh=mesh)
    assert eng.prefix_cache is not None
    assert _port_rounds(eng) == want
    assert {k: eng.counters[k] for k in _KEYS} == counters
    assert counters["prefix_cache_hits_total"] >= 5
    assert eng.allocator.available == eng.allocator.num_pages - 1


def test_mla_engine_builds_no_tree():
    from kaito_tpu_torch.models.autogen import metadata_from_hf_config
    from tests.test_torch_mla import CONFIGS

    md = metadata_from_hf_config("test/q_lora", CONFIGS["q_lora"],
                                 name="tiny-mla-test")
    eng = InferenceEngine(EngineConfig(model="tiny-mla-test", max_model_len=128,
                                       page_size=16, max_num_seqs=2,
                                       dtype="float32", kv_dtype="float32",
                                       prefill_buckets=(16, 32, 64)),
                          metadata=md, device="cpu")
    assert eng.prefix_cache is None
    prompt = [(3 * i) % 500 + 2 for i in range(40)]
    assert _one(eng, prompt, 4) == _one(eng, prompt, 4)
    assert eng.counters["prefix_cached_tokens_total"] == 0
    assert eng.counters["prefix_cache_hits_total"] == 0
    assert eng.counters["prefix_cache_misses_total"] == 0


# ---------------------------------------------------------------------------
# goldens with the tree on
# ---------------------------------------------------------------------------

def _warm_config(cls, quant, kv_dtype):
    return cls(model="tiny-llama-real",
               weights_dir=os.path.join(REPO, "checkpoints", "tiny-llama-real"),
               dtype="float32", kv_dtype=kv_dtype, max_model_len=512,
               page_size=16, max_num_seqs=2, prefill_buckets=(64, 128),
               quantization=quant, seed=0)


def _jax_warm_logprobs(quant, kv_dtype, golden):
    """The JAX engine's logprobs for each golden prompt served twice."""
    eng = JaxEngine(_warm_config(JaxConfig, quant, kv_dtype))
    out = []
    for p in golden["prompts"]:
        for _ in range(2):
            req = eng.submit(list(p["prompt_tokens"]), JaxParams(
                max_tokens=len(p["kv_int8"]["greedy_tokens"]), temperature=0.0,
                ignore_eos=True, logprobs=True))
            _drive(eng, [req])
            out.append(list(req.output_logprobs))
    return out


@pytest.mark.parametrize("quant,kv_dtype,section", [
    ("", "float32", "fp32"), ("int8", "float32", "int8"),
    ("int4", "float32", "weight_int4"), ("", "int8", "kv_int8")])
def test_goldens_replay_warm_with_the_tree(quant, kv_dtype, section):
    """Each golden prompt twice in one engine at page 16: the second run
    prefills only the suffix past its cached pages and still reproduces
    the golden tokens and logprobs.  Over int8 pages the logprobs of
    both runs are held against the JAX engine's same runs instead: a
    page's scale covers its 16 tokens (not the goldens' 64), and a
    reused page keeps the scale it grew."""
    eng = InferenceEngine(_warm_config(EngineConfig, quant, kv_dtype), device="cpu")
    golden = json.load(open(GOLDENS))
    jax_lps = (_jax_warm_logprobs(quant, kv_dtype, golden)
               if section == "kv_int8" else None)
    for j, p in enumerate(golden["prompts"]):
        want = p[section]
        for run in range(2):
            cached0 = eng.counters["prefix_cached_tokens_total"]
            req = eng.submit(list(p["prompt_tokens"]),
                             _greedy(len(want["greedy_tokens"]), logprobs=True))
            assert _drive(eng, [req])[0] == want["greedy_tokens"], (p["text"], run)
            lps = want["logprobs"] if jax_lps is None else jax_lps[2 * j + run]
            np.testing.assert_allclose(req.output_logprobs, lps, rtol=0,
                                       atol=2e-3, err_msg=f"{p['text']} run {run}")
            cached = eng.counters["prefix_cached_tokens_total"] - cached0
            assert cached == (len(p["prompt_tokens"]) // 16 * 16 if run else 0)
