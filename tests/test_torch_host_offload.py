"""The port's host-RAM KV tier (``kaito_tpu_torch/engine/host_offload.py``
and the engine's spill / restore) against the JAX package's on the CPU.

- ``HostKVPool`` against the JAX pool under one put / pop / discard
  sequence: ``used_bytes``, entries, evictions, hits, misses and pages
  equal after every call, the bytes round-tripped, int8 scales carried.
- The JAX test's pair (``tests/test_host_offload.py``: two sequences
  whose growth overruns a 9-page pool, so the newer one is preempted)
  through the JAX engine and the port on ``tiny-llama-real`` fp32, in
  the sync and async loops, at TP=2 on a CPU mesh and with int8 KV:
  tokens and the counters ``preemptions_total``,
  ``host_kv_spilled_pages_total``, ``host_kv_restored_pages_total`` and
  ``prefill_steps_total`` equal; fewer prefill steps than the tier-off
  engine, whose tokens the restore reproduces; every page returns and
  the pool tensors keep their addresses.
- A pool too small for any entry falls back to recompute; a tiny MLA
  model (zero-size ``v``) restores its latent pool; a seeded sampled and
  a constrained request are preempted and restored as the JAX engine
  does; n-gram and self-draft speculation run across a restore as in
  the JAX engine; a sequence under an adapter restores in its lane
  (boot-time stacks and the slot cache); an aborted or expired spilled
  request leaves no entry.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.engine import SamplingParams as JaxParams
from kaito_tpu.engine.grammar import GrammarSpec as JaxSpec
from kaito_tpu.engine.host_offload import HostKVPool as JaxPool
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.grammar import GrammarSpec
from kaito_tpu_torch.engine.host_offload import HostKVPool
from kaito_tpu_torch.parallel.mesh import build_mesh
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_host_offload.py's config, on the committed checkpoint
BASE = dict(model="tiny-llama-real",
            weights_dir=os.path.join(REPO, "checkpoints", "tiny-llama-real"),
            max_model_len=256, page_size=16, max_num_seqs=2, max_pages=10,
            dtype="float32", kv_dtype="float32", prefill_buckets=(32, 64, 128),
            seed=0, enable_prefix_caching=False)
TIER = 256 * 2**20
A, B = [40, 41, 42] * 11, [50, 51, 52] * 11
COUNTERS = ("preemptions_total", "host_kv_spilled_pages_total",
            "host_kv_restored_pages_total", "prefill_steps_total")
# a grammar that needs at least 61 tokens before it may end
REGEX = "[a-z ]{30,40}[a-z ]{30,40}\\."


def _greedy(n, cls=SamplingParams, **kw):
    return cls(max_tokens=n, temperature=0.0, ignore_eos=True, **kw)


def _drive(eng, reqs, max_steps=4000):
    for _ in range(max_steps):
        if all(r.finish_reason for r in reqs):
            break
        eng.step()
    assert all(r.finish_reason for r in reqs)
    return [list(r.output_tokens) for r in reqs]


def _pair(eng, cls, b_params=None, b_prompt=B, b_adapter=""):
    """The pair, submitted together and stepped to the end."""
    ra = eng.submit(list(A), _greedy(100, cls))
    rb = eng.submit(list(b_prompt), b_params or _greedy(40, cls), adapter=b_adapter)
    return _drive(eng, [ra, rb]), [ra, rb]


def _counters(eng):
    return {k: eng.counters[k] for k in COUNTERS}


def _port(mesh=None, **kw):
    return InferenceEngine(EngineConfig(**{**BASE, **kw}), device="cpu", mesh=mesh)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's pair with the tier on, sync and async, and with
    int8 KV; tokens and counters."""
    out = {}
    for name, kw in (("sync", {}), ("async", dict(async_dispatch=True)),
                     ("int8", dict(kv_dtype="int8"))):
        jeng = JaxEngine(JaxConfig(**{**BASE, **kw}, host_kv_offload_bytes=TIER))
        toks, _ = _pair(jeng, JaxParams)
        out[name] = toks, _counters(jeng)
    return out


@pytest.fixture(scope="module")
def tier_off():
    eng = _port()
    toks, _ = _pair(eng, SamplingParams)
    return toks, _counters(eng)


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

def _arrays(rng, pages, dtype=np.float32):
    k = rng.standard_normal((2, pages, 4, 1, 8)).astype(dtype)
    return k, (k * 2).astype(dtype)


def _state(pool, ids):
    return (pool.used_bytes, len(pool), pool.evicted_entries, pool.hits, pool.misses,
            pool.spilled_pages, pool.restored_pages, [pool.has(i) for i in ids])


def test_pool_accounting_matches_the_jax_pool():
    rng = np.random.default_rng(0)
    k1, v1 = _arrays(rng, 4)
    k2, v2 = _arrays(rng, 2)
    k3, v3 = _arrays(rng, 8)
    budget = 2 * (k1.nbytes + v1.nbytes)
    ours, theirs = HostKVPool(budget), JaxPool(budget)
    ids = ("a", "b", "c", "d")
    ops = [("put", "a", k1, v1), ("put", "b", k2, v2), ("put", "a", k2, v2),
           ("pop", "b"), ("pop", "b"), ("put", "c", k1, v1), ("put", "d", k1, v1),
           ("discard", "a"), ("put", "b", k3, v3), ("put", "a", k2, v2),
           ("pop", "d"), ("discard", "zz"), ("pop", "a"), ("pop", "c")]
    for op in ops:
        if op[0] == "put":
            _, i, k, v = op
            got = ours.put(i, torch.from_numpy(k), torch.from_numpy(v), written=5)
            want = theirs.put(i, jnp.asarray(k), jnp.asarray(v), written=5)
            assert got == want, op[:2]
        elif op[0] == "pop":
            got, want = ours.pop(op[1]), theirs.pop(op[1])
            assert (got is None) == (want is None), op
            if got is not None:
                np.testing.assert_array_equal(got.k[0].numpy(), np.asarray(want.k))
                np.testing.assert_array_equal(got.v[0].numpy(), np.asarray(want.v))
                assert (got.written, got.n_pages, got.nbytes) == \
                    (want.written, want.n_pages, want.nbytes)
        else:
            ours.discard(op[1])
            theirs.discard(op[1])
        assert _state(ours, ids) == _state(theirs, ids), op[:2]
    assert ours.evicted_entries > 0 and ours.misses > 0
    # an entry that can never fit is refused outright
    assert not HostKVPool(8).put("big", torch.from_numpy(k1), torch.from_numpy(v1), 1)


def test_pool_carries_int8_scales_and_shards():
    k = torch.ones((2, 3, 4, 1, 2), dtype=torch.int8)
    ks = torch.full((2, 3, 1), 0.5)
    pool, jpool = HostKVPool(1 << 20), JaxPool(1 << 20)
    assert pool.put("q", [k, k * 3], [k * 2, k * 4], written=5, k_scale=[ks, ks * 2],
                    v_scale=[ks / 2, ks])
    jpool.put("q", jnp.asarray(k.numpy()), jnp.asarray(k.numpy() * 2), written=5,
              k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(ks.numpy() / 2))
    # two shards hold twice the one-device bytes
    assert pool.used_bytes == 2 * jpool.used_bytes
    e = pool.pop("q")
    assert e.n_pages == 3 and len(e.k) == 2 and e.events == [None, None]
    assert torch.equal(e.k[1], k * 3) and torch.equal(e.v_scale[0], ks / 2)
    assert torch.equal(e.k_scale[1], ks * 2)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sync", "async", "tp2"])
def test_pair_matches_the_jax_engine(jax_runs, tier_off, mode):
    want, counters = jax_runs["async" if mode == "async" else "sync"]
    mesh = build_mesh(tensor=2, devices=["cpu", "cpu"]) if mode == "tp2" else None
    eng = _port(mesh=mesh, host_kv_offload_bytes=TIER, async_dispatch=mode == "async")
    toks, _ = _pair(eng, SamplingParams)
    assert toks == want
    assert _counters(eng) == counters
    assert counters["preemptions_total"] >= 1
    assert counters["host_kv_spilled_pages_total"] >= 1
    assert counters["host_kv_restored_pages_total"] >= 1
    # the restore skipped the recompute, and gave the recompute's tokens
    assert toks == tier_off[0]
    assert tier_off[1]["preemptions_total"] >= 1
    assert eng.counters["prefill_steps_total"] < tier_off[1]["prefill_steps_total"]
    assert eng.allocator.available == eng.allocator.num_pages - 1
    assert len(eng.host_kv) == 0 and eng.host_kv.used_bytes == 0
    assert eng.host_kv.hits == 1 and eng.host_kv.misses == 0


def test_int8_kv_scales_are_carried(jax_runs):
    want, counters = jax_runs["int8"]
    eng = _port(host_kv_offload_bytes=TIER, kv_dtype="int8")
    toks, _ = _pair(eng, SamplingParams)
    assert toks == want and _counters(eng) == counters
    assert counters["host_kv_restored_pages_total"] >= 1


def test_pool_tensors_keep_their_addresses():
    eng = _port(host_kv_offload_bytes=TIER, kv_dtype="int8")
    c = eng.cache
    ptrs = [t.data_ptr() for t in (c.k, c.v, c.k_scale, c.v_scale)]
    _pair(eng, SamplingParams)
    assert eng.counters["host_kv_restored_pages_total"] >= 1
    assert eng.cache is c
    assert [t.data_ptr() for t in (c.k, c.v, c.k_scale, c.v_scale)] == ptrs


def test_lru_eviction_falls_back_to_recompute(tier_off):
    eng = _port(host_kv_offload_bytes=1024)     # no entry fits
    toks, _ = _pair(eng, SamplingParams)
    assert toks == tier_off[0]
    assert eng.counters["preemptions_total"] >= 1
    assert eng.counters["host_kv_spilled_pages_total"] == 0
    assert eng.counters["host_kv_restored_pages_total"] == 0
    assert eng.counters["prefill_steps_total"] == tier_off[1]["prefill_steps_total"]


def test_mla_latent_pool_restores():
    from kaito_tpu.models.autogen import metadata_from_hf_config as j_metadata
    from kaito_tpu_torch.models.autogen import metadata_from_hf_config
    from tests.test_torch_mla import CONFIGS

    name = next(iter(CONFIGS))
    cfg = dict(model="tiny-mla-test", max_model_len=256, page_size=16, max_num_seqs=2,
               max_pages=10, dtype="float32", kv_dtype="float32",
               prefill_buckets=(32, 64, 128), seed=0, enable_prefix_caching=False,
               host_kv_offload_bytes=TIER)
    jmd = j_metadata(f"test/{name}", CONFIGS[name], name="tiny-mla-test")
    tmd = metadata_from_hf_config(f"test/{name}", CONFIGS[name], name="tiny-mla-test")
    jeng = JaxEngine(JaxConfig(**cfg), metadata=jmd)
    want, _ = _pair(jeng, JaxParams)
    import jax

    from kaito_tpu_torch.engine.model import params_from_jax
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), tmd.arch)
    eng = InferenceEngine(EngineConfig(**cfg), metadata=tmd, params=params, device="cpu")
    assert eng.cache.v.numel() == 0
    got, _ = _pair(eng, SamplingParams)
    assert got == want and _counters(eng) == _counters(jeng)
    assert eng.counters["host_kv_restored_pages_total"] >= 1


def _b_params(kind, eng, cls, spec_cls):
    if kind == "seeded":
        return cls(max_tokens=60, temperature=0.8, seed=7, ignore_eos=True,
                   logprobs=True)
    g = eng.grammar_cache.get(spec_cls("regex", REGEX), eng.tokenizer)
    return cls(max_tokens=100, temperature=0.0, grammar=g, logprobs=True)


@pytest.mark.parametrize("kind", ["seeded", "grammar"])
def test_sampled_and_constrained_requests_restore_as_jax(kind):
    jeng = JaxEngine(JaxConfig(**BASE, host_kv_offload_bytes=TIER))
    want, jreqs = _pair(jeng, JaxParams, _b_params(kind, jeng, JaxParams, JaxSpec))
    eng = _port(host_kv_offload_bytes=TIER)
    got, reqs = _pair(eng, SamplingParams, _b_params(kind, eng, SamplingParams,
                                                     GrammarSpec))
    assert got == want
    np.testing.assert_allclose(reqs[1].output_logprobs, jreqs[1].output_logprobs,
                               rtol=1e-3, atol=1e-4)
    assert _counters(eng) == _counters(jeng)
    assert reqs[1].preemptions >= 1
    assert eng.counters["host_kv_restored_pages_total"] >= 1
    if kind == "grammar":
        text = eng.tokenizer.decode(got[1])
        assert len(text) > 60


@pytest.mark.parametrize("slots", [0, 2])
def test_adapter_request_restores_in_its_lane(tmp_path, slots):
    """The preempted sequence runs under an adapter (boot-time stacks,
    and the slot cache): its restore resumes in its lane, as the JAX
    engine's does."""
    from kaito_tpu.models import get_model_by_name as jax_model
    from tests.helpers.lora_adapters import make_adapter

    make_adapter(tmp_path / "ad", jax_model("tiny-llama-real").arch, seed=31, r=4,
                 alpha=16, base="tiny-llama-real", scale=2.0)
    cfg = dict(BASE, host_kv_offload_bytes=TIER, adapters_dir=str(tmp_path),
               adapter_slots=slots)
    jeng = JaxEngine(JaxConfig(**cfg))
    want, _ = _pair(jeng, JaxParams, b_adapter="ad")
    eng = InferenceEngine(EngineConfig(**cfg), device="cpu")
    got, reqs = _pair(eng, SamplingParams, b_adapter="ad")
    assert got == want and _counters(eng) == _counters(jeng)
    assert reqs[1].preemptions >= 1
    assert eng.counters["host_kv_restored_pages_total"] >= 1
    # the lane made a difference: the base model's stream is another
    base, _ = _pair(_port(host_kv_offload_bytes=TIER), SamplingParams)
    assert got[1] != base[1]


@pytest.mark.parametrize("spec", [dict(speculative_ngram=4),
                                  dict(speculative_draft="tiny-llama-real",
                                       speculative_draft_weights_dir=BASE["weights_dir"])])
def test_speculation_across_a_restore(spec):
    rep = [7, 11, 13] * 11
    jeng = JaxEngine(JaxConfig(**BASE, host_kv_offload_bytes=TIER, **spec))
    want, _ = _pair(jeng, JaxParams, b_prompt=rep)
    eng = _port(host_kv_offload_bytes=TIER, **spec)
    got, _ = _pair(eng, SamplingParams, b_prompt=rep)
    assert got == want
    keys = COUNTERS + ("spec_steps_total", "spec_proposed_tokens_total",
                       "spec_accepted_tokens_total", "spec_draft_proposed_tokens_total",
                       "spec_draft_accepted_tokens_total")
    assert {k: eng.counters[k] for k in keys} == {k: jeng.counters[k] for k in keys}
    assert eng.counters["host_kv_restored_pages_total"] >= 1
    assert eng.counters["spec_steps_total"] > 0


@pytest.mark.parametrize("how", ["abort", "deadline"])
def test_a_spilled_request_that_ends_in_the_queue_leaves_no_entry(how):
    eng = _port(host_kv_offload_bytes=TIER)
    ra = eng.submit(list(A), _greedy(100))
    rb = eng.submit(list(B), _greedy(40))
    for _ in range(2000):
        eng.step()
        if eng.host_kv.has(rb.req_id) and rb not in [s.request for s in eng.slots]:
            break
    assert eng.host_kv.has(rb.req_id) and eng.host_kv.used_bytes > 0
    if how == "abort":
        eng.abort(rb)
    else:
        rb.deadline = eng._now() - 1.0
        eng._last_deadline_sweep = -1e9
    _drive(eng, [ra, rb])
    assert rb.finish_reason == ("abort" if how == "abort" else "deadline")
    assert len(eng.host_kv) == 0 and eng.host_kv.used_bytes == 0
    assert eng.allocator.available == eng.allocator.num_pages - 1
