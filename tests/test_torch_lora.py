"""The port's multi-LoRA compute and lanes against the JAX package's.

- ``nn.lora_delta``, ``nn.multi_lora_delta`` and ``nn.mlp``'s adapter
  sites against the JAX functions on the same numpy inputs (fp32 rtol
  1e-5 / atol 1e-5; bf16 within 2e-2 of the output's largest
  magnitude, one bf16 rounding of the rank-r intermediate apart).
- ``adapters.load_adapter_stacks`` and ``adapter_cache.AdapterCache``
  lanes equal, bit for bit, to the JAX package's from the same
  artifacts (bf16 and fp32, one adapter at alpha/r = 1.5), with the
  same refusals, counters and snapshots through loads, an eviction to
  the host tier and a fault back in.
- The demote -> fault round trip at scaling 1.5 in bf16: the lanes
  after the fault are the lanes before the eviction, in the port and in
  the JAX cache (which reads the lane back and divides by the scaling).
- ``tiny-llama-test``'s prefill (batched and segment-packed) and decode
  logits through per-row adapter lanes against ``TransformerLM`` in JAX
  (fp32, rtol 1e-4 / atol 1e-4, ``test_torch_model``'s tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaito_tpu.engine import nn as jnn
from kaito_tpu.engine.adapter_cache import AdapterCache as JaxCache
from kaito_tpu.engine.adapters import load_adapter_stacks as jax_stacks
from kaito_tpu.engine.kv_cache import create_kv_cache as j_cache
from kaito_tpu.engine.model import TransformerLM as JaxLM
from kaito_tpu.models import get_model_by_name as jax_model
from kaito_tpu_torch.engine import nn
from kaito_tpu_torch.engine.adapter_cache import (AdapterBusyError, AdapterCache,
                                                  AdapterLoadError)
from kaito_tpu_torch.engine.adapters import discover_adapters, load_adapter_stacks
from kaito_tpu_torch.engine.kv_cache import create_kv_cache as t_cache
from kaito_tpu_torch.engine.model import TransformerLM, params_from_jax
from kaito_tpu_torch.models import get_model_by_name
from kaito_tpu_torch.tuning.lora import load_adapter
from tests.helpers.lora_adapters import adapter_leaves, make_adapter
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

PRESET = "tiny-llama-test"
ARCH = get_model_by_name(PRESET).arch
JARCH = jax_model(PRESET).arch
TOL = dict(rtol=1e-4, atol=1e-4)
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def adapters_dir(tmp_path_factory):
    """Three servable adapters (r 4 / 8 / 2, one at alpha/r = 1.5, one on
    q and v only), one for another base model, one unreadable."""
    root = tmp_path_factory.mktemp("lora")
    make_adapter(root / "style-a", JARCH, seed=1, r=4, alpha=6)
    make_adapter(root / "style-b", JARCH, seed=7, r=8, alpha=16, scale=0.8)
    make_adapter(root / "style-c", JARCH, seed=3, r=2, alpha=8, targets=("q", "v"))
    make_adapter(root / "wrong-base", JARCH, seed=5, base="other-model")
    (root / "broken").mkdir()
    (root / "broken" / "adapter_config.json").write_text("{")
    return root


# ---------------------------------------------------------------------------
# the delta functions
# ---------------------------------------------------------------------------

def test_lora_delta_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    p = {"q_lora_a": rng.standard_normal((16, 4)).astype(np.float32),
         "q_lora_b": rng.standard_normal((4, 8)).astype(np.float32)}
    want = jnn.lora_delta(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                          "q", 1.5)
    got = nn.lora_delta(_t(x), {k: _t(v) for k, v in p.items()}, "q", 1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert nn.lora_delta(_t(x), {}, "q", 1.5) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_lora_delta_matches_jax(dtype):
    rng = np.random.default_rng(1)
    B, T, E, r, O, n = 4, 3, 32, 8, 24, 3
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    lanes = {"v_a": rng.standard_normal((n, E, r)).astype(np.float32),
             "v_b": rng.standard_normal((n, r, O)).astype(np.float32)}
    lanes["v_a"][0] = 0
    lanes["v_b"][0] = 0
    ids = np.array([2, 0, 1, 2], np.int32)
    jd = _JDT[dtype]
    want = np.asarray(jnn.multi_lora_delta(
        jnp.asarray(x, jd), {k: jnp.asarray(v, jd) for k, v in lanes.items()}, "v",
        jnp.asarray(ids)), np.float32)
    td = _TDT[dtype]
    got = nn.multi_lora_delta(_t(x).to(td), {k: _t(v).to(td) for k, v in lanes.items()},
                              "v", _t(ids).long()).float().numpy()
    assert not got[1].any() and not want[1].any()          # lane 0: the base
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert nn.multi_lora_delta(_t(x), lanes, "q", _t(ids)) is None
    assert nn.multi_lora_delta(_t(x), None, "v", _t(ids)) is None


def test_mlp_sites_match_jax():
    rng = np.random.default_rng(2)
    E, I, r, n = 32, 64, 4, 3
    x = rng.standard_normal((3, 2, E)).astype(np.float32)
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("gate", (E, I)), ("up", (E, I)), ("down", (I, E)))}
    lanes = {}
    for t, (i, o) in (("gate", (E, I)), ("up", (E, I)), ("down", (I, E))):
        lanes[f"{t}_a"] = rng.standard_normal((n, i, r)).astype(np.float32) / 4
        lanes[f"{t}_b"] = rng.standard_normal((n, r, o)).astype(np.float32) / 4
        lanes[f"{t}_a"][0] = 0                      # lane 0: the base
    ids = np.array([1, 0, 2], np.int32)
    want = jnn.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, JARCH,
                   serve_lora={k: jnp.asarray(v) for k, v in lanes.items()},
                   lora_ids=jnp.asarray(ids))
    got = nn.mlp(_t(x), {k: _t(v) for k, v in p.items()}, ARCH,
                 lora={k: _t(v) for k, v in lanes.items()}, lora_ids=_t(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    plain = nn.mlp(_t(x), {k: _t(v) for k, v in p.items()}, ARCH)
    assert not torch.equal(plain[0], got[0]) and torch.equal(plain[1], got[1])


# ---------------------------------------------------------------------------
# boot-time stacks and the cache's lanes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_boot_stacks_bit_equal_to_jax(adapters_dir, dtype):
    jrefusals, trefusals = {}, {}
    jl, jidx = jax_stacks(JaxLM(JARCH, dtype=_JDT[dtype]), str(adapters_dir), PRESET,
                          refusals=jrefusals)
    tl, tidx = load_adapter_stacks(TransformerLM(ARCH, _TDT[dtype], "cpu"),
                                   str(adapters_dir), PRESET, refusals=trefusals)
    assert tidx == jidx == {"style-a": 1, "style-b": 2, "style-c": 3}
    assert trefusals == jrefusals == {"unreadable": 1, "base_mismatch": 1}
    assert sorted(tl) == sorted(jl) == ["dense"]
    assert sorted(tl["dense"]) == sorted(jl["dense"])
    for k, v in jl["dense"].items():
        assert tl["dense"][k].dtype == _TDT[dtype]
        np.testing.assert_array_equal(_bits(tl["dense"][k]), _bits(v))
    # the escape hatch serves the mismatched base too
    _, idx = load_adapter_stacks(TransformerLM(ARCH, _TDT[dtype], "cpu"),
                                 str(adapters_dir), PRESET, allow_base_mismatch=True)
    assert "wrong-base" in idx


def _lanes_equal(tc, jc):
    for k, v in jc.serve_lora["dense"].items():
        np.testing.assert_array_equal(_bits(tc.serve_lora["dense"][k]), _bits(v))


def _jax_factors(path):
    from kaito_tpu.tuning.lora import load_adapter as jload

    ad, cfg, base = jload(str(path))
    return ad, cfg.r, cfg.scaling, base


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cache_lanes_bit_equal_to_jax(adapters_dir, dtype):
    """The same loads, eviction and fault through both caches: lanes,
    residency, host tier, counters and snapshots equal after each."""
    kw = dict(slots=2, rmax=8, base_model=PRESET, host_bytes=64 << 20)
    jc = JaxCache(JaxLM(JARCH, dtype=_JDT[dtype]), **kw)
    tc = AdapterCache(TransformerLM(ARCH, _TDT[dtype], "cpu"), **kw)
    assert tc.serve_lora["dense"]["q_a"].shape == (4, 3, 256, 8)
    _lanes_equal(tc, jc)                                      # all zeros
    for name in ("style-a", "style-b"):
        assert tc.load_from_path(name, str(adapters_dir / name)) == \
            jc.load_from_path(name, str(adapters_dir / name))
        _lanes_equal(tc, jc)
    assert tc.ensure("style-a") == jc.ensure("style-a")       # LRU touch
    # a third adapter evicts style-b (least recent) to the host tier
    assert tc.load_from_path("style-c", str(adapters_dir / "style-c")) == \
        jc.load_from_path("style-c", str(adapters_dir / "style-c"))
    _lanes_equal(tc, jc)
    assert tc.host.has("style-b") and jc.host.has("style-b")
    assert tc.host.used_bytes == jc.host.used_bytes
    # the fault back in evicts style-a and rewrites its lane
    assert tc.ensure("style-b") == jc.ensure("style-b")
    _lanes_equal(tc, jc)
    assert tc.snapshot() == jc.snapshot()
    # a delete zeroes the lane
    assert tc.remove("style-c") and jc.remove("style-c")
    _lanes_equal(tc, jc)
    assert tc.snapshot() == jc.snapshot()
    assert not tc.remove("nope") and not jc.remove("nope")


def test_cache_refusals_and_pinning(adapters_dir):
    """Typed, counted refusals and busy pinning, as the JAX cache's."""
    kw = dict(slots=1, rmax=4, base_model=PRESET, host_bytes=64 << 20)
    for cache in (JaxCache(JaxLM(JARCH, dtype=jnp.float32), **kw),
                  AdapterCache(TransformerLM(ARCH, torch.float32, "cpu"), **kw)):
        err = AdapterLoadError if isinstance(cache, AdapterCache) else Exception
        for name, reason in (("wrong-base", "base_mismatch"),
                             ("style-b", "rank_overflow"), ("broken", "unreadable")):
            with pytest.raises(err) as ei:
                cache.load_from_path(name, str(adapters_dir / name))
            assert ei.value.reason == reason
        with pytest.raises(err) as ei:
            cache.install("empty", {"dense/nope": np.zeros(3)}, r=2, scaling=1.0)
        assert ei.value.reason == "no_targets"
        assert cache.load_failures == {"base_mismatch": 1, "rank_overflow": 1,
                                       "unreadable": 1, "no_targets": 1}
        cache.load_from_path("style-a", str(adapters_dir / "style-a"))
        cache.busy_fn = lambda name: True
        with pytest.raises(err) as ei:
            cache.load_from_path("style-c", str(adapters_dir / "style-c"))
        assert ei.value.reason == "capacity"
        with pytest.raises(AdapterBusyError if isinstance(cache, AdapterCache)
                           else RuntimeError):
            cache.remove("style-a")
        cache.busy_fn = lambda name: False
        assert cache.remove("style-a") and not cache.has("style-a")
        with pytest.raises(KeyError):
            cache.ensure("style-a")


def test_demote_fault_round_trip_at_scaling_1_5(tmp_path):
    """bf16 lanes at alpha/r = 1.5: after an eviction to the host tier and
    a fault back in, every lane is bit-equal to what the install wrote,
    in the port (which demotes the factors as installed) and in the JAX
    cache (which reads the lane back and divides by the scaling)."""
    make_adapter(tmp_path / "x", JARCH, seed=11, r=8, alpha=12, scale=2.0)
    make_adapter(tmp_path / "y", JARCH, seed=12, r=4, alpha=4)
    kw = dict(slots=1, rmax=8, base_model=PRESET, host_bytes=64 << 20)
    jc = JaxCache(JaxLM(JARCH, dtype=jnp.bfloat16), **kw)
    tc = AdapterCache(TransformerLM(ARCH, torch.bfloat16, "cpu"), **kw)
    for c in (jc, tc):
        c.load_from_path("x", str(tmp_path / "x"))
    assert load_adapter(str(tmp_path / "x"))[1].scaling == 1.5
    before_t = {k: _bits(v[:, 1]).copy() for k, v in tc.serve_lora["dense"].items()}
    before_j = {k: _bits(v[:, 1]).copy() for k, v in jc.serve_lora["dense"].items()}
    for c in (jc, tc):
        c.load_from_path("y", str(tmp_path / "y"))       # evicts x
        assert c.host.has("x")
        assert c.ensure("x") == 1 and c.faults_total == 1
    for k in before_t:
        np.testing.assert_array_equal(_bits(tc.serve_lora["dense"][k][:, 1]), before_t[k])
        np.testing.assert_array_equal(_bits(jc.serve_lora["dense"][k][:, 1]), before_j[k])
        np.testing.assert_array_equal(before_t[k], before_j[k])


def test_mla_and_moe_sites():
    """MLA has no sites (the cache refuses it, the stacks answer empty);
    a MoE group keeps q/k/v/o only."""
    moe = TransformerLM(get_model_by_name("tiny-moe-real").arch, torch.float32, "cpu")
    assert set(moe.lora_specs()["moe"]) == {"q", "k", "v", "o"}
    from kaito_tpu_torch.models.autogen import metadata_from_hf_config
    from tests.test_torch_mla import CONFIGS

    name = next(iter(CONFIGS))
    md = metadata_from_hf_config(f"test/{name}", CONFIGS[name], name="tiny-mla-test")
    mla = TransformerLM(md.arch, torch.float32, "cpu")
    assert mla.lora_specs() == {}
    with pytest.raises(ValueError, match="MLA"):
        AdapterCache(mla, slots=1, rmax=4)
    assert discover_adapters("/nonexistent") == {}


# ---------------------------------------------------------------------------
# the model's logits through adapter lanes
# ---------------------------------------------------------------------------

PS, P, PMAX = 16, 40, 6


def _tables(B):
    return np.stack([np.arange(1 + b * PMAX, 1 + (b + 1) * PMAX) for b in range(B)]
                    ).astype(np.int32)


@pytest.fixture(scope="module")
def both_models(adapters_dir):
    jm = JaxLM(JARCH, dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    serve_lora, idx = jax_stacks(jm, str(adapters_dir), PRESET)
    jp = {**jp, "serve_lora": serve_lora}
    tm = TransformerLM(ARCH, torch.float32, "cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, jp), ARCH))
    assert sorted(tm.lora["dense"]) == sorted(serve_lora["dense"])
    return jm, jp, tm


def test_prefill_and_decode_logits_with_adapters(both_models):
    jm, jp, tm = both_models
    rng = np.random.RandomState(0)
    B, T = 4, 16
    toks = rng.randint(0, ARCH.vocab_size, size=(B, T)).astype(np.int32)
    tl = np.array([16, 11, 7, 13], np.int32)
    ids = np.array([1, 0, 2, 3], np.int32)
    pt = _tables(B)
    jc = j_cache(JARCH, P, PS, jnp.float32)
    tc = t_cache(ARCH, P, PS, torch.float32, "cpu")
    jc, jl, _ = jm.prefill(jp, jc, jnp.asarray(toks), jnp.asarray(tl), jnp.asarray(pt),
                           adapter_ids=jnp.asarray(ids))
    tc, tlg, _ = tm.prefill(tc, _t(toks), _t(tl), _t(pt), adapter_ids=_t(ids))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jl), **TOL)
    # each adapter row differs from the base's logits of the same prompt
    _, base, _ = tm.prefill(t_cache(ARCH, P, PS, torch.float32, "cpu"), _t(toks),
                            _t(tl), _t(pt))
    assert torch.equal(base[1], tlg[1])
    assert all(not torch.allclose(base[b], tlg[b], atol=1e-3) for b in (0, 2, 3))
    pos = tl.copy()
    nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    for _ in range(3):
        jc, jl = jm.decode(jp, jc, jnp.asarray(nxt), jnp.asarray(pos), jnp.asarray(pt),
                           adapter_ids=jnp.asarray(ids))
        tc, tlg = tm.decode(tc, _t(nxt), _t(pos), _t(pt), adapter_ids=_t(ids))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jl), **TOL)
        nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        pos = pos + 1
    # the verify forward (a window at every position) through the lanes
    win = np.stack([nxt, nxt, nxt], axis=1).astype(np.int32)
    jc, jvl = jm.verify_window_logits(jp, jc, jnp.asarray(win), jnp.asarray([3] * B),
                                      jnp.asarray(pt), jnp.asarray(pos),
                                      adapter_ids=jnp.asarray(ids))
    tc, tvl = tm.verify_window_logits(tc, _t(win), _t(np.array([3] * B, np.int32)),
                                      _t(pt), _t(pos), adapter_ids=_t(ids))
    np.testing.assert_allclose(tvl.numpy(), np.asarray(jvl), **TOL)


def test_packed_prefill_logits_with_one_adapter(both_models):
    """Segment-packed prompts under one adapter (the JAX model's [1] ids)."""
    jm, jp, tm = both_models
    T = 32
    lens = [9, 14]
    toks = np.zeros((1, T), np.int32)
    segs = np.full((1, T), -1, np.int32)
    poss = np.zeros((1, T), np.int32)
    tok_pages = np.zeros((T,), np.int32)
    last = np.zeros((2,), np.int32)
    off = 0
    for si, n in enumerate(lens):
        toks[0, off:off + n] = (np.arange(n) * (si + 3)) % 500 + 1
        segs[0, off:off + n] = si
        poss[0, off:off + n] = np.arange(n)
        tok_pages[off:off + n] = 1 + si * PMAX + np.arange(n) // PS
        last[si] = off + n - 1
        off += n
    aid = np.array([2], np.int32)
    jc = j_cache(JARCH, P, PS, jnp.float32)
    tc = t_cache(ARCH, P, PS, torch.float32, "cpu")
    _, jl, _ = jm.prefill_packed(jp, jc, jnp.asarray(toks), jnp.asarray(segs),
                                 jnp.asarray(poss), jnp.asarray(tok_pages),
                                 jnp.asarray(last), adapter_ids=jnp.asarray(aid))
    _, tlg, _ = tm.prefill_packed(tc, _t(toks), _t(segs), _t(poss), _t(tok_pages),
                                  _t(last), adapter_ids=_t(aid))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jl), **TOL)


def test_tensor_parallel_lanes_split(both_models):
    """At TP=2 each shard holds its split of every lane (column targets'
    B by out columns, row targets' A by in rows); the sharded model's
    decode logits through adapter lanes equal the single model's."""
    from kaito_tpu_torch.engine.kv_cache import create_sharded_kv_cache
    from kaito_tpu_torch.engine.model import TensorParallelLM
    from kaito_tpu_torch.parallel.mesh import build_mesh

    _, jp, tm = both_models
    tp = TensorParallelLM(ARCH, build_mesh(tensor=2, devices=["cpu", "cpu"]),
                          dtype=torch.float32)
    tp.load_params(params_from_jax(jax.tree.map(np.asarray, jp), ARCH))
    tp.set_lora(tm.lora)
    s0 = tp.lora[0]["dense"]
    assert s0["q_b"].shape[-1] == tm.lora["dense"]["q_b"].shape[-1] // 2
    assert s0["o_a"].shape[-2] == tm.lora["dense"]["o_a"].shape[-2] // 2
    assert s0["q_a"].shape == tm.lora["dense"]["q_a"].shape
    rng = np.random.RandomState(3)
    toks = rng.randint(0, ARCH.vocab_size, size=(3, 16)).astype(np.int32)
    tl = np.array([12, 16, 5], np.int32)
    ids = np.array([3, 1, 0], np.int32)
    pt = _tables(3)
    single = t_cache(ARCH, P, PS, torch.float32, "cpu")
    shards = create_sharded_kv_cache(ARCH, ["cpu", "cpu"], P, PS, torch.float32)
    _, want, _ = tm.prefill(single, _t(toks), _t(tl), _t(pt), adapter_ids=_t(ids))
    _, got, _ = tp.prefill(shards, _t(toks), _t(tl), _t(pt), adapter_ids=_t(ids))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    nxt = want.argmax(-1).to(torch.int32)
    _, want = tm.decode(single, nxt, _t(tl), _t(pt), adapter_ids=_t(ids))
    _, got = tp.decode(shards, nxt, _t(tl), _t(pt), adapter_ids=_t(ids))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    tp.overlap = True                      # the decode ring adds the o/down deltas too
    _, got = tp.decode(shards, nxt, _t(tl + 1), _t(pt), adapter_ids=_t(ids))
    _, want = tm.decode(single, nxt, _t(tl + 1), _t(pt), adapter_ids=_t(ids))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_adapter_leaves_helper_shapes():
    leaves = adapter_leaves(JARCH, seed=0, r=4)
    assert leaves["dense"]["down_lora_a"].shape == (4, 1024, 4)
    assert leaves["dense"]["down_lora_b"].shape == (4, 4, 256)
