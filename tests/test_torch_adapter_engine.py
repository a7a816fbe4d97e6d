"""The port's engine serving per-request LoRA adapters, against the JAX
engine's same runs (fp32 on the CPU, greedy; the JAX engine's base
weights carried over, both engines loading the same artifacts).

- A heterogeneous batch (base and three adapters, one at alpha/r =
  1.5, one on q/v only) gives the JAX engine's tokens, which equal each
  prompt's solo stream; so do the async loop, the eager reference loop,
  an int8 base with an int8 KV cache, and TP=2 on a CPU mesh.
- One slot: load -> evict to the host tier -> fault back in gives the
  same tokens, the cache's counters equal the JAX engine's, and every
  lane tensor keeps its ``data_ptr`` across the churn.
- Adapter requests never hit or fill the prefix tree (exclusive pages),
  a base request of the same prompt does: tokens and prefix counters
  equal to the JAX engine's.
- Four fresh prompts under two adapters pack into two dispatches.
- The n-gram verify window passes each row's adapter: on
  ``tiny-llama-real`` (its checkpoint, nonzero acceptance), greedy tokens
  and the ``spec_*`` counters equal the JAX engine's.
- MLA has no adapter sites: the JAX engine's merge into the base
  weights, and the port's, give the same tokens.
- Gating: with no adapter config the engine has no cache, no adapter
  counters, no ``kaito:adapter_*`` family, and uploads no adapter ids.
"""

import os

import jax
import numpy as np
import pytest

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.engine import SamplingParams as JaxParams
from kaito_tpu.models import get_model_by_name as jax_model
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.metrics import EngineMetrics
from kaito_tpu_torch.engine.model import params_from_jax
from kaito_tpu_torch.models import get_model_by_name
from kaito_tpu_torch.parallel.mesh import build_mesh
from tests.helpers.lora_adapters import make_adapter
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL = os.path.join(REPO, "checkpoints", "tiny-llama-real")
CFG = dict(model="tiny-llama-test", max_model_len=128, page_size=16, max_num_seqs=4,
           dtype="float32", kv_dtype="float32", prefill_buckets=(32, 64),
           enable_prefix_caching=False, seed=0)
ARCH = get_model_by_name("tiny-llama-test").arch
# (prompt, adapter) submitted together
BATCH = [([5, 9, 13, 17, 21, 25], "style-a"), ([3, 1, 4, 1, 5, 9, 2, 6], ""),
         ([7, 7, 8, 8, 9, 9, 10], "style-b"), ([11, 12, 13], "style-c")]
N = 8
SPEC = ("decode_steps_total", "spec_steps_total", "spec_proposed_tokens_total",
        "spec_accepted_tokens_total", "generation_tokens_total")


def _greedy(cls, n=N):
    return cls(max_tokens=n, temperature=0.0, ignore_eos=True)


def _drive(eng, reqs, max_steps=3000):
    for _ in range(max_steps):
        eng.step()
        if all(r.finish_reason for r in reqs):
            break
    assert all(r.finish_reason == "length" for r in reqs), [r.error for r in reqs]
    return [list(r.output_tokens) for r in reqs]


def _serve(eng, batch, cls, n=N):
    return _drive(eng, [eng.submit(list(p), _greedy(cls, n), adapter=a)
                        for p, a in batch])


@pytest.fixture(scope="module")
def adapters_dir(tmp_path_factory):
    arch = jax_model("tiny-llama-test").arch
    root = tmp_path_factory.mktemp("lora")
    make_adapter(root / "style-a", arch, seed=1, r=4, alpha=6)
    make_adapter(root / "style-b", arch, seed=7, r=8, alpha=16, scale=0.8)
    make_adapter(root / "style-c", arch, seed=3, r=2, alpha=8, targets=("q", "v"))
    return root


def _jax_params(jeng):
    return params_from_jax({k: v for k, v in jax.tree.map(np.asarray, jeng.params).items()
                            if k != "serve_lora"}, ARCH)


@pytest.fixture(scope="module")
def jax_run(adapters_dir):
    """The JAX engine's heterogeneous batch, each prompt solo, and a
    one-slot churn (a, b, a again), with its weights."""
    out = {}
    jeng = JaxEngine(JaxConfig(**CFG, adapters_dir=str(adapters_dir), adapter_slots=3))
    out["batch"] = _serve(jeng, BATCH, JaxParams)
    out["solo"] = [_serve(jeng, [b], JaxParams)[0] for b in BATCH]
    out["params"] = _jax_params(jeng)
    one = JaxEngine(JaxConfig(**CFG, adapters_dir=str(adapters_dir), adapter_slots=1))
    out["churn"] = [_serve(one, [BATCH[i]], JaxParams)[0] for i in (0, 2, 0, 3)]
    out["churn_snapshot"] = one.adapter_snapshot()
    return out


def _port(params, adapters_dir, **kw):
    mesh = kw.pop("mesh", None)
    eager = kw.pop("_eager_decode", False)
    cfg = {**CFG, "adapters_dir": str(adapters_dir), "adapter_slots": 3, **kw}
    return InferenceEngine(EngineConfig(**cfg), params=params, device="cpu", mesh=mesh,
                           _eager_decode=eager)


def test_heterogeneous_batch_equals_solo_and_jax(jax_run, adapters_dir):
    assert jax_run["batch"] == jax_run["solo"]
    eng = _port(jax_run["params"], adapters_dir)
    assert sorted(eng.adapter_index) == ["style-a", "style-b", "style-c"]
    assert _serve(eng, BATCH, SamplingParams) == jax_run["batch"]
    assert [_serve(eng, [b], SamplingParams)[0] for b in BATCH] == jax_run["solo"]
    # each adapter changes its prompt's stream
    base = InferenceEngine(EngineConfig(**CFG), params=jax_run["params"], device="cpu")
    plain = _serve(base, [(p, "") for p, _ in BATCH], SamplingParams)
    assert [a != b for a, b in zip(plain, jax_run["batch"])] == [True, False, True, True]


@pytest.mark.parametrize("mode", ["async", "eager"])
def test_async_and_eager_loops(jax_run, adapters_dir, mode):
    kw = {"async_dispatch": True} if mode == "async" else {"_eager_decode": True}
    eng = _port(jax_run["params"], adapters_dir, **kw)
    assert _serve(eng, BATCH, SamplingParams) == jax_run["batch"]
    if mode == "async":
        assert eng.counters["h2d_uploads_total"] > 0


def test_evict_and_fault_are_exact(jax_run, adapters_dir):
    """One slot and a host tier: a, b (evicts a), a (faults back in,
    evicting b), c: the JAX engine's tokens and snapshot, and the lanes
    never move."""
    eng = _port(jax_run["params"], adapters_dir, adapter_slots=1)
    ptrs = {k: t.data_ptr() for k, t in eng.model.lora["dense"].items()}
    got = [_serve(eng, [BATCH[i]], SamplingParams)[0] for i in (0, 2, 0, 3)]
    assert got == jax_run["churn"]
    assert got[0] == got[2] == jax_run["solo"][0]
    assert {k: t.data_ptr() for k, t in eng.model.lora["dense"].items()} == ptrs
    snap = eng.adapter_snapshot()
    assert snap == jax_run["churn_snapshot"]
    assert snap["faults_total"] >= 1 and snap["evictions_total"] >= 3


def test_adapter_requests_bypass_the_prefix_tree(jax_run, adapters_dir):
    prompt = [(3 * i) % 200 + 5 for i in range(40)]
    seq = [(prompt, ""), (prompt, "style-a"), (prompt, "style-a"), (prompt, "")]
    keys = ("prefix_cache_hits_total", "prefix_cache_misses_total",
            "prefix_cached_tokens_total")
    jeng = JaxEngine(JaxConfig(**{**CFG, "enable_prefix_caching": True},
                               adapters_dir=str(adapters_dir), adapter_slots=3))
    want = [_serve(jeng, [s], JaxParams)[0] for s in seq]
    eng = _port(jax_run["params"], adapters_dir, enable_prefix_caching=True)
    got = [_serve(eng, [s], SamplingParams)[0] for s in seq]
    assert got == want
    assert got[1] == got[2] != got[0] == got[3]
    assert {k: eng.counters[k] for k in keys} == {k: jeng.counters[k] for k in keys}
    # only the base requests counted: one miss, then one hit
    assert (eng.counters["prefix_cache_misses_total"],
            eng.counters["prefix_cache_hits_total"]) == (1, 1)


def test_fresh_prompts_pack_per_adapter(jax_run, adapters_dir):
    batch = [([4, 8, 15, 16], "style-a"), ([23, 42, 4], "style-b"),
             ([8, 15, 16, 23, 42], "style-a"), ([1, 2, 3, 4, 5, 6], "style-b")]
    eng = _port(jax_run["params"], adapters_dir)
    got = _serve(eng, batch, SamplingParams)
    assert eng.counters["prefill_packed_steps_total"] == 2
    assert eng.counters["prefill_steps_total"] == 2
    solo = _port(jax_run["params"], adapters_dir, prefill_pack=1)
    assert got == [_serve(solo, [b], SamplingParams)[0] for b in batch]


def test_int8_base_and_int8_kv(adapters_dir):
    kw = dict(quantization="int8", kv_dtype="int8")
    jeng = JaxEngine(JaxConfig(**{**CFG, **kw}, adapters_dir=str(adapters_dir),
                               adapter_slots=3))
    want = _serve(jeng, BATCH, JaxParams)
    params = params_from_jax({k: v for k, v in jax.tree.map(np.asarray, jeng.params).items()
                              if k != "serve_lora"}, ARCH)
    eng = _port(params, adapters_dir, **kw)
    assert _serve(eng, BATCH, SamplingParams) == want


def test_tensor_parallel_two_slots(jax_run, adapters_dir):
    eng = _port(jax_run["params"], adapters_dir,
                mesh=build_mesh(tensor=2, devices=["cpu", "cpu"]))
    assert len(eng.model.lora) == 2
    assert _serve(eng, BATCH, SamplingParams) == jax_run["batch"]
    ov = _port(jax_run["params"], adapters_dir, comm_overlap=True,
               mesh=build_mesh(tensor=2, devices=["cpu", "cpu"]))
    assert ov.comm_overlap
    assert _serve(ov, BATCH, SamplingParams) == jax_run["batch"]


def test_ngram_verify_window_passes_adapter_ids(tmp_path):
    arch = jax_model("tiny-llama-real").arch
    for name, seed in (("r-a", 21), ("r-b", 22)):
        make_adapter(tmp_path / name, arch, seed=seed, r=4, alpha=6,
                     base="tiny-llama-real", scale=0.3)
    cfg = dict(model="tiny-llama-real", weights_dir=REAL, max_model_len=256,
               page_size=16, max_num_seqs=4, dtype="float32", kv_dtype="float32",
               prefill_buckets=(32, 64, 128), seed=0, enable_prefix_caching=False,
               speculative_ngram=4, adapters_dir=str(tmp_path), adapter_slots=2)
    rep = [ord(c) for c in "the cat sat on the mat. the cat sat on the"]
    batch = [(rep, "r-a"), (rep, ""), ([ord(c) for c in "abcabcabcabc"], "r-b")]
    jeng = JaxEngine(JaxConfig(**cfg))
    want = _serve(jeng, batch, JaxParams, n=24)
    eng = InferenceEngine(EngineConfig(**cfg), device="cpu")
    got = _serve(eng, batch, SamplingParams, n=24)
    assert got == want
    assert {k: eng.counters[k] for k in SPEC} == {k: jeng.counters[k] for k in SPEC}
    assert eng.counters["spec_accepted_tokens_total"] > 0
    assert eng.counters["spec_verify_eager_total"] == eng.counters["spec_steps_total"]


def test_mla_merges_adapters_into_the_base(tmp_path):
    from kaito_tpu.models.autogen import metadata_from_hf_config as j_metadata
    from kaito_tpu_torch.models.autogen import metadata_from_hf_config
    from tests.test_torch_mla import CONFIGS

    name = next(iter(CONFIGS))
    jmd = j_metadata(f"test/{name}", CONFIGS[name], name="tiny-mla-test")
    tmd = metadata_from_hf_config(f"test/{name}", CONFIGS[name], name="tiny-mla-test")
    make_adapter(tmp_path / "m", jmd.arch, seed=4, r=4, alpha=8, base="tiny-mla-test",
                 targets=("o", "gate", "up", "down"))
    cfg = dict(model="tiny-mla-test", max_model_len=128, page_size=16, max_num_seqs=2,
               dtype="float32", kv_dtype="float32", prefill_buckets=(16, 32),
               enable_prefix_caching=False, seed=0, adapters_dir=str(tmp_path),
               adapter_slots=2)
    prompts = [[(3 * i) % 400 + 2 for i in range(11)], [9, 8, 7, 6]]
    jeng = JaxEngine(JaxConfig(**cfg), metadata=jmd)
    assert jeng.adapters_merged and jeng.adapter_cache is None
    want = _drive(jeng, [jeng.submit(p, _greedy(JaxParams, 6)) for p in prompts])
    # the base weights before the JAX engine's merge
    plain = JaxEngine(JaxConfig(**{**cfg, "adapters_dir": "", "adapter_slots": 0}),
                      metadata=jmd)
    base = params_from_jax(jax.tree.map(np.asarray, plain.params), tmd.arch)
    eng = InferenceEngine(EngineConfig(**cfg), metadata=tmd, params=base, device="cpu")
    assert eng.adapters_merged and eng.adapter_cache is None
    assert eng.adapter_index == {}
    got = _drive(eng, [eng.submit(p, _greedy(SamplingParams, 6)) for p in prompts])
    assert got == want
    unmerged = _drive(plain, [plain.submit(p, _greedy(JaxParams, 6)) for p in prompts])
    assert unmerged != want


def test_no_adapter_config_is_invisible(jax_run, adapters_dir):
    eng = InferenceEngine(EngineConfig(**CFG, async_dispatch=True),
                          params=jax_run["params"], device="cpu")
    assert eng.adapter_cache is None and eng.adapter_index == {}
    assert eng.model.lora == {}
    assert not any("adapter" in k for k in eng.counters)
    text = EngineMetrics(eng).registry.expose()
    assert "kaito:adapter" not in text
    _serve(eng, [(p, "") for p, _ in BATCH], SamplingParams)
    # base traffic on an engine with adapters uploads what an engine
    # without them does (the adapter ids only while a row holds one)
    on = _port(jax_run["params"], adapters_dir, async_dispatch=True)
    _serve(on, [(p, "") for p, _ in BATCH], SamplingParams)
    assert on.counters["h2d_uploads_total"] == eng.counters["h2d_uploads_total"]
    _serve(on, BATCH, SamplingParams)
    assert on.counters["h2d_uploads_total"] > 2 * eng.counters["h2d_uploads_total"] > 0
    assert "kaito:adapter_resident 3" in EngineMetrics(on).registry.expose()
    with pytest.raises(RuntimeError, match="not enabled"):
        eng.load_adapter_dynamic("x", str(adapters_dir / "style-a"))
    assert eng.adapter_snapshot() is None
