"""kaito_tpu_torch TransformerLM against kaito_tpu TransformerLM.

``tiny-llama-test`` weights come from the JAX ``init_params`` and are
carried across with ``params_from_jax``; both models run the same
tokens in fp32 on the CPU, where the port's attention wrappers run the
kernels' plain versions.  Tolerance: fp32 atol 1e-4 on logits, because
four layers of 256-wide matmuls, norms and rope accumulate rounding in
each framework's own order (observed differences are a few 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaito_tpu.engine.kv_cache import create_kv_cache as j_cache
from kaito_tpu.engine.model import TransformerLM as JaxLM
from kaito_tpu.models import get_model_by_name as jax_model
from kaito_tpu_torch.engine.kv_cache import create_kv_cache as t_cache
from kaito_tpu_torch.engine.model import (TransformerLM, check_tensor_parallel,
                                          params_from_jax)
from kaito_tpu_torch.models import get_model_by_name
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

PRESET = "tiny-llama-test"
PS, P, PMAX = 16, 40, 6
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_side():
    model = JaxLM(jax_model(PRESET).arch, dtype=jnp.float32)
    params = model.init_params(jax.random.PRNGKey(0))
    return model, params


def _port(jax_side):
    _, params = jax_side
    arch = get_model_by_name(PRESET).arch
    model = TransformerLM(arch, dtype=torch.float32, device="cpu")
    model.load_params(params_from_jax(jax.tree.map(np.asarray, params), arch))
    return model


def _tables(B):
    pt = np.zeros((B, PMAX), np.int32)
    for b in range(B):
        pt[b] = np.arange(1 + b * PMAX, 1 + (b + 1) * PMAX)
    return pt


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_inactive", [False, True])
def test_prefill_and_decode_match(jax_side, with_inactive):
    """Decode logits match; with an inactive row, the active row's logits
    match and both pools agree (the inactive row writes the null page)."""
    jm, jp = jax_side
    tm = _port(jax_side)
    arch = tm.arch
    rng = np.random.RandomState(0)
    B, T = 2, 16
    toks = rng.randint(0, arch.vocab_size, size=(B, T)).astype(np.int32)
    tl = np.array([16, 11], np.int32)
    pt = _tables(B)
    jc = j_cache(jm.arch, P, PS, jnp.float32)
    tc = t_cache(arch, P, PS, torch.float32, "cpu")
    jc, jl, jh = jm.prefill(jp, jc, jnp.asarray(toks), jnp.asarray(tl),
                            jnp.asarray(pt))
    tc, tlg, th = tm.prefill(tc, _t(toks), _t(tl), _t(pt))
    _close(tlg, jl)
    _close(th, jh)
    np.testing.assert_allclose(tc.k[:, 1:].numpy(), np.asarray(jc.k[:, 1:]),
                               **TOL)
    pos = tl.copy()
    nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    act = np.array([True, not with_inactive])
    live = act.nonzero()[0]
    for _ in range(3):
        jc, jl = jm.decode(jp, jc, jnp.asarray(nxt), jnp.asarray(pos),
                           jnp.asarray(pt), active=jnp.asarray(act))
        tc, tlg = tm.decode(tc, _t(nxt), _t(pos), _t(pt), active=_t(act))
        _close(tlg[live], np.asarray(jl)[live])
        nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        pos = pos + act
    np.testing.assert_allclose(tc.k[:, 1:].numpy(), np.asarray(jc.k[:, 1:]),
                               **TOL)


@pytest.mark.parametrize("first", [12, 16])   # 16: the split on a page edge
def test_chunked_prefill_with_start_pos_matches(jax_side, first):
    jm, jp = jax_side
    tm = _port(jax_side)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, tm.arch.vocab_size, size=(1, 20)).astype(np.int32)
    pt = _tables(1)
    jc = j_cache(jm.arch, P, PS, jnp.float32)
    tc = t_cache(tm.arch, P, PS, torch.float32, "cpu")
    chunk1 = np.zeros((1, 16), np.int32)
    chunk1[0, :first] = toks[0, :first]
    n1 = np.array([first], np.int32)
    jc, _, _ = jm.prefill(jp, jc, jnp.asarray(chunk1), jnp.asarray(n1),
                          jnp.asarray(pt))
    tc, _, _ = tm.prefill(tc, _t(chunk1), _t(n1), _t(pt))
    chunk2 = np.zeros((1, 16), np.int32)
    chunk2[0, :20 - first] = toks[0, first:]
    start = np.array([first], np.int32)
    n = np.array([20 - first], np.int32)
    jc, jl, _ = jm.prefill(jp, jc, jnp.asarray(chunk2), jnp.asarray(n),
                           jnp.asarray(pt), start_pos=jnp.asarray(start))
    tc, tlg, _ = tm.prefill(tc, _t(chunk2), _t(n), _t(pt), start_pos=_t(start))
    _close(tlg, jl)


@pytest.mark.parametrize("seg_lens", [(9, 21, 13), (16, 1, 30)])
def test_packed_prefill_matches(jax_side, seg_lens):
    jm, jp = jax_side
    tm = _port(jax_side)
    rng = np.random.RandomState(2)
    T = 48
    toks = np.zeros((1, T), np.int32)
    segs = np.full((1, T), -1, np.int32)
    poss = np.zeros((1, T), np.int32)
    tok_pages = np.zeros((T,), np.int32)
    last = np.zeros((len(seg_lens),), np.int32)
    pt = _tables(len(seg_lens))
    off = 0
    for si, n in enumerate(seg_lens):
        toks[0, off:off + n] = rng.randint(0, tm.arch.vocab_size, size=n)
        segs[0, off:off + n] = si
        rel = np.arange(n)
        poss[0, off:off + n] = rel
        tok_pages[off:off + n] = pt[si][rel // PS]
        last[si] = off + n - 1
        off += n
    jc = j_cache(jm.arch, P, PS, jnp.float32)
    tc = t_cache(tm.arch, P, PS, torch.float32, "cpu")
    jc, jl, _ = jm.prefill_packed(jp, jc, jnp.asarray(toks), jnp.asarray(segs),
                                  jnp.asarray(poss), jnp.asarray(tok_pages),
                                  jnp.asarray(last))
    tc, tlg, _ = tm.prefill_packed(tc, _t(toks), _t(segs), _t(poss),
                                   _t(tok_pages), _t(last))
    _close(tlg, jl)
    np.testing.assert_allclose(tc.v[:, 1:].numpy(), np.asarray(jc.v[:, 1:]), **TOL)


def test_params_from_jax_keeps_names_and_shapes(jax_side):
    _, jp = jax_side
    tm = _port(jax_side)
    tree = tm.param_tree()
    assert set(tree) == set(jp)
    assert set(tree["dense"]) == set(jp["dense"])
    for name, t in tree["dense"].items():
        assert tuple(t.shape) == jp["dense"][name].shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(jp["dense"][name]))


def test_synthetic_init_is_seeded_and_scaled():
    arch = get_model_by_name(PRESET).arch
    a = TransformerLM(arch, dtype=torch.float32, device="cpu")
    a.init_params(seed=3)
    b = TransformerLM(arch, dtype=torch.float32, device="cpu")
    b.init_params(seed=3)
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    tree = a.param_tree()
    assert torch.all(tree["final_norm"] == 1.0)
    assert torch.all(tree["dense"]["attn_norm"] == 1.0)
    # 0.02 at the top level, 1/sqrt(fan_in) per layer
    assert abs(tree["embed"].std().item() - 0.02) < 0.002
    q = tree["dense"]["q"]
    assert abs(q.std().item() - arch.hidden_size ** -0.5) < 0.1 * arch.hidden_size ** -0.5
    assert not torch.equal(tree["dense"]["q"], tree["dense"]["k"][..., :1].expand_as(q))
    c = TransformerLM(arch, dtype=torch.float32, device="cpu")
    c.init_params(seed=4)
    assert not torch.equal(c.param_tree()["embed"], tree["embed"])


@pytest.mark.parametrize("preset,item", [("deepseek-v3-0324", "M17")])
def test_unported_families_raise(preset, item):
    """What the port does not serve of a family raises with its ROADMAP
    item: DeepSeek-V3 (MLA + MoE) builds, and refuses tensor
    parallelism."""
    arch = get_model_by_name(preset).arch
    assert TransformerLM(arch, dtype=torch.float32, device="cpu").is_mla
    with pytest.raises(NotImplementedError, match=item):
        check_tensor_parallel(arch, 2)
