"""The port's MoE layer against the JAX package's, on the CPU.

- ``nn.moe_mlp`` (dense form) and ``nn.moe_mlp_ragged`` (grouped form)
  against ``kaito_tpu.engine.nn``'s, in fp32 at atol 1e-5: 8 experts,
  top-2 and top-4, with and without a shared expert, plain, int8 and
  int4 expert stacks.  The forms run in other orders of sums than XLA's
  (observed differences are a few 1e-7).
- The window's capturable form (``grouped=True``: one
  ``torch._grouped_mm`` over device-side group bounds) and the card's
  fp32 form (``moe_mlp``) against the host-sized ragged form; rows left
  out by ``valid`` take no expert and leave the others unchanged.
- ``TransformerLM`` against ``kaito_tpu``'s with ``moe_impl="ragged"``,
  weights through ``params_from_jax``: prefill and decode logits at
  atol 1e-4 (as ``tests/test_torch_model.py``), for tiny-moe-real's
  arch, a gpt-oss-shaped tiny arch (sliding window on every other
  layer) and an arch with a dense group before its MoE group, under each
  of the port's three ``moe_impl`` forms.
- Parameter specs, logical axes, quantized expert stacks, synthetic
  init and the safetensors loader against the JAX package's.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaito_tpu.engine import nn as jnn
from kaito_tpu.engine.kv_cache import create_kv_cache as j_cache
from kaito_tpu.engine.model import TransformerLM as JaxLM
from kaito_tpu.engine.quant import quantize_params as j_quantize_params
from kaito_tpu.engine.weights import load_safetensors_params as j_load
from kaito_tpu.models import get_model_by_name as jax_model
from kaito_tpu_torch.engine import nn as tnn
from kaito_tpu_torch.engine.kv_cache import create_kv_cache as t_cache
from kaito_tpu_torch.engine.model import (TransformerLM, _to_torch,
                                          check_tensor_parallel, moe_impl_for,
                                          params_from_jax)
from kaito_tpu_torch.engine.quant import quantize_params
from kaito_tpu_torch.engine.weights import load_safetensors_params
from kaito_tpu_torch.models import get_model_by_name
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

MOE_TOL = dict(rtol=0, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
PS, P, PMAX = 16, 40, 6
CKPT = "checkpoints/tiny-moe-real"


def _archs(name: str, **kw):
    """The same arch in both packages' ModelArch."""
    return (replace(jax_model(name).arch, **kw),
            replace(get_model_by_name(name).arch, **kw))


# name -> (preset, overrides)
ARCHS = {
    "tiny-moe-real": ("tiny-moe-real", {}),
    # gpt-oss-20b's shape at a tiny width: 8 experts, top-4, a window of
    # 8 tokens on every other layer, head_dim 32, untied head
    "gpt-oss-tiny": ("gpt-oss-20b", dict(
        vocab_size=300, hidden_size=64, num_layers=4, num_heads=4,
        num_kv_heads=2, head_dim=32, intermediate_size=64, num_experts=8,
        moe_intermediate_size=64, sliding_window=8)),
    # a dense group (layer 0), then a MoE group with a shared expert
    "dense-then-moe": ("tiny-moe-real", dict(
        num_layers=3, moe_layer_start=1, num_experts=8, num_shared_experts=1,
        moe_intermediate_size=64)),
}


# ---------------------------------------------------------------------------
# The MoE MLP
# ---------------------------------------------------------------------------

def _moe_case(k, shared, quant, T=12, E=64, X=8, I=32, seed=0):
    jarch, tarch = _archs("tiny-moe-real", hidden_size=E, num_experts=X,
                          num_experts_per_tok=k, moe_intermediate_size=I,
                          num_shared_experts=shared)
    rng = np.random.RandomState(seed)
    p = {"router": rng.randn(E, X) / E ** 0.5,
         "experts_gate": rng.randn(X, E, I) / E ** 0.5,
         "experts_up": rng.randn(X, E, I) / E ** 0.5,
         "experts_down": rng.randn(X, I, E) / I ** 0.5}
    if shared:
        p.update(shared_gate=rng.randn(E, I * shared) / E ** 0.5,
                 shared_up=rng.randn(E, I * shared) / E ** 0.5,
                 shared_down=rng.randn(I * shared, E) / I ** 0.5)
    jp = {n: jnp.asarray(v, jnp.float32) for n, v in p.items()}
    if quant:
        jp = j_quantize_params({"moe": jp}, quant)["moe"]
    tp = {n: ({a: _to_torch(np.asarray(b)) for a, b in v.items()}
              if isinstance(v, dict) else _to_torch(np.asarray(v)))
          for n, v in jp.items()}
    x = rng.randn(T, E).astype(np.float32)
    return jarch, tarch, jp, tp, x


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("fn", ["moe_mlp", "moe_mlp_ragged"])
def test_moe_mlp_matches_jax(fn, k, shared, quant):
    jarch, tarch, jp, tp, x = _moe_case(k, shared, quant)
    want = np.asarray(getattr(jnn, fn)(jnp.asarray(x), jp, jarch))
    got = getattr(tnn, fn)(torch.from_numpy(x), tp, tarch)
    np.testing.assert_allclose(got.numpy(), want, **MOE_TOL)


@pytest.mark.parametrize("quant", ["", "int8", "int4"])
@pytest.mark.parametrize("k", [2, 4])
def test_capturable_forms_match_the_ragged_form(k, quant):
    """The window's grouped form and the card's fp32 dense form against
    the host-sized ragged form, fp32."""
    _, arch, _, tp, x = _moe_case(k, 1, quant, seed=1)
    xt = torch.from_numpy(x)
    ref = tnn.moe_mlp_ragged(xt, tp, arch)
    for got in (tnn.moe_mlp_ragged(xt, tp, arch, grouped=True),
                tnn.moe_mlp(xt, tp, arch)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **MOE_TOL)


@pytest.mark.parametrize("grouped", [False, True])
def test_rows_left_out_take_no_expert(grouped):
    """Tokens outside ``valid`` (a decode batch's idle rows) go into no
    expert group: their routed output is zero and the other tokens'
    rows are those of the full batch."""
    _, arch, _, tp, x = _moe_case(4, 0, "", seed=2)
    xt = torch.from_numpy(x)
    valid = torch.tensor([True, False] * 6)
    full = tnn.moe_mlp_ragged(xt, tp, arch, grouped=grouped)
    part = tnn.moe_mlp_ragged(xt, tp, arch, grouped=grouped, valid=valid)
    np.testing.assert_allclose(part[valid].numpy(), full[valid].numpy(), **MOE_TOL)
    assert torch.all(part[~valid] == 0)


def test_grouped_form_in_bf16_is_close_to_the_ragged_form():
    """bf16: the grouped products round to bf16 before the activation,
    the ragged loop keeps them in fp32, so the two agree to bf16's
    precision (2e-2 of the output's scale, a few of bf16's 2^-8 steps)."""
    _, arch, _, tp, x = _moe_case(4, 1, "", seed=3)
    tb = {n: v.to(torch.bfloat16) for n, v in tp.items()}
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = tnn.moe_mlp_ragged(xb, tb, arch).float()
    got = tnn.moe_mlp_ragged(xb, tb, arch, grouped=True).float()
    assert got.dtype == ref.dtype
    assert (got - ref).abs().max() <= 2e-2 * ref.abs().max()


def test_moe_impl_follows_device_and_dtype():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert moe_impl_for(cpu, torch.bfloat16) == "ragged"
    assert moe_impl_for(cpu, torch.float32) == "ragged"
    assert moe_impl_for(cuda, torch.bfloat16) == "grouped"
    assert moe_impl_for(cuda, torch.float32) == "dense"


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

_JAX_SIDE: dict = {}


def _jax_side(name):
    if name not in _JAX_SIDE:
        preset, kw = ARCHS[name]
        jarch, tarch = _archs(preset, **kw)
        jm = JaxLM(jarch, dtype=jnp.float32)
        jm.moe_impl = "ragged"
        _JAX_SIDE[name] = (jm, jm.init_params(jax.random.PRNGKey(0)), tarch)
    return _JAX_SIDE[name]


def _port(name, impl="ragged", quant=""):
    jm, jp, tarch = _jax_side(name)
    if quant:
        jp = j_quantize_params(jp, quant)
    tm = TransformerLM(tarch, dtype=torch.float32, device="cpu")
    tm.moe_impl = impl
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, jp), tarch))
    return jm, jp, tm


def _tables(B):
    return np.stack([np.arange(1 + b * PMAX, 1 + (b + 1) * PMAX)
                     for b in range(B)]).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _prefill_then_decode(jm, jp, tm, steps=3):
    """Prefill two prompts (16 and 11 tokens), then decode with the
    second row inactive; every logit of the live rows compared."""
    rng = np.random.RandomState(0)
    B, T = 2, 16
    toks = rng.randint(0, tm.arch.vocab_size, size=(B, T)).astype(np.int32)
    tl = np.array([16, 11], np.int32)
    pt = _tables(B)
    jc = j_cache(jm.arch, P, PS, jnp.float32)
    tc = t_cache(tm.arch, P, PS, torch.float32, "cpu")
    jc, jl, jh = jm.prefill(jp, jc, jnp.asarray(toks), jnp.asarray(tl),
                            jnp.asarray(pt))
    tc, tlg, th = tm.prefill(tc, _t(toks), _t(tl), _t(pt))
    _close(tlg, jl)
    _close(th, jh)
    pos = tl.copy()
    nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    act = np.array([True, False])
    for _ in range(steps):
        jc, jl = jm.decode(jp, jc, jnp.asarray(nxt), jnp.asarray(pos),
                           jnp.asarray(pt), active=jnp.asarray(act))
        tc, tlg = tm.decode(tc, _t(nxt), _t(pos), _t(pt), active=_t(act))
        _close(tlg[:1], np.asarray(jl)[:1])
        nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        pos = pos + act
    np.testing.assert_allclose(tc.k[:, 1:].numpy(), np.asarray(jc.k[:, 1:]), **TOL)


@pytest.mark.parametrize("impl", ["ragged", "grouped", "dense"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_model_matches_jax(name, impl):
    jm, jp, tm = _port(name, impl)
    assert [(g.name, g.start, g.count, g.moe) for g in tm.groups] == \
        [(g.name, g.start, g.count, g.moe) for g in jm.groups]
    _prefill_then_decode(jm, jp, tm)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_model_matches_jax(quant):
    """A JAX tree from ``quantize_params`` (expert stacks [L, X, in, out]
    as QTensors) serves the same logits in the port."""
    jm, jp, tm = _port("tiny-moe-real", quant=quant)
    stack = tm.param_tree()["moe"]["experts_down"]
    assert stack[{"int8": "q8", "int4": "q4"}[quant]].dtype == torch.int8
    _prefill_then_decode(jm, jp, tm, steps=2)


def test_packed_prefill_matches_jax():
    """Segment-packed prompts through the windowed gpt-oss-shaped arch."""
    jm, jp, tm = _port("gpt-oss-tiny")
    rng = np.random.RandomState(2)
    seg_lens, T = (9, 21, 13), 48
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
        poss[0, off:off + n] = np.arange(n)
        tok_pages[off:off + n] = pt[si][np.arange(n) // PS]
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


@pytest.mark.parametrize("name", ["tiny-moe-real", "gpt-oss-20b", "dense-then-moe"])
def test_specs_and_axes_match_jax(name):
    """Layer groups, every parameter's shape and its logical axes, at
    full width for gpt-oss-20b (built, never initialised)."""
    preset, kw = ARCHS.get(name, (name, {}))
    jarch, tarch = _archs(preset, **kw)
    jm = JaxLM(jarch, dtype=jnp.bfloat16)
    tm = TransformerLM(tarch, dtype=torch.bfloat16, device="cpu")
    assert [g.name for g in tm.groups] == [g.name for g in jm.groups]
    for g in tm.groups:
        want = {n: s for n, (s, _) in jm._layer_specs(g.moe).items()}
        assert tm._layer_specs(g.moe) == want
    assert tm.param_logical_axes() == jm.param_logical_axes()


def test_moe_presets_build_and_refuse_tensor_parallel():
    for name in ("tiny-moe-real", "gpt-oss-20b"):
        arch = get_model_by_name(name).arch
        m = TransformerLM(arch, dtype=torch.float32, device="cpu")
        assert [g.moe for g in m.groups] == [True]
        check_tensor_parallel(arch, 1)
        with pytest.raises(NotImplementedError, match="M17"):
            check_tensor_parallel(arch, 2)


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_expert_stacks_quantize_like_jax(scheme):
    """Codes and scales of [L, X, in, out] stacks equal the JAX
    package's: per-(layer, expert, out) int8 scales, per-group int4
    scales; a layer view keeps the expert axis."""
    jm, jp, _ = _jax_side("dense-then-moe")
    # the JAX engine quantizes under jit (see engine/quant.py's docstring)
    want = jax.tree.map(np.asarray,
                        jax.jit(j_quantize_params, static_argnums=1)(jp, scheme))
    tarch = _jax_side("dense-then-moe")[2]
    got = quantize_params(params_from_jax(jax.tree.map(np.asarray, jp), tarch),
                          scheme)
    for name in ("experts_gate", "experts_up", "experts_down", "shared_down"):
        for k, v in want["moe"][name].items():
            np.testing.assert_array_equal(got["moe"][name][k].numpy(), v)
    tm = TransformerLM(tarch, dtype=torch.float32, device="cpu")
    tm.load_params(got)
    g = tm.groups[1]
    layer = tm._layer_params(g, 0)
    codes = layer["experts_gate"]["q8" if scheme == "int8" else "q4"]
    X, E, I = tarch.num_experts, tarch.hidden_size, tarch.moe_intermediate_size
    assert tuple(codes.shape) == ((X, E, I) if scheme == "int8" else (X, E // 2, I))
    assert layer["experts_gate"]["scale"].shape[0] == X


@pytest.mark.parametrize("quant", ["", "int8"])
def test_synthetic_moe_init(quant):
    tarch = _jax_side("gpt-oss-tiny")[2]
    m = TransformerLM(tarch, dtype=torch.float32, device="cpu")
    m.init_params(seed=1, quantization=quant)
    tree = m.param_tree()["moe"]
    E = tarch.hidden_size
    assert tuple(tree["router"].shape) == (tarch.num_layers, E, tarch.num_experts)
    assert abs(tree["router"].std().item() - E ** -0.5) < 0.1 * E ** -0.5
    if quant:
        assert tree["experts_up"]["q8"].dtype == torch.int8
    else:
        assert abs(tree["experts_up"].std().item() - E ** -0.5) < 0.1 * E ** -0.5
    b = TransformerLM(tarch, dtype=torch.float32, device="cpu")
    b.init_params(seed=1, quantization=quant)
    for (n, x), (_, y) in zip(m.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n


def test_safetensors_tree_equals_the_jax_loaders():
    arch = get_model_by_name("tiny-moe-real").arch
    tm = TransformerLM(arch, dtype=torch.float32, device="cpu")
    got = load_safetensors_params(tm, CKPT)
    want = jax.tree.map(np.asarray, j_load(JaxLM(jax_model("tiny-moe-real").arch,
                                                 dtype=jnp.float32), CKPT))
    assert set(got) == set(want) and set(got["moe"]) == set(want["moe"])
    for name, t in got.items():
        if name != "moe":
            np.testing.assert_array_equal(t.float().numpy(), want[name])
    for name, t in got["moe"].items():
        assert tuple(t.shape) == want["moe"][name].shape, name
        np.testing.assert_array_equal(t.float().numpy(), want["moe"][name])
