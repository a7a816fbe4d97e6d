"""kaito_tpu_torch MLA (DeepSeek-style latent attention) against kaito_tpu.

- The three attention functions (``mla_prefill_attention``,
  ``mla_paged_context_attention``, ``mla_paged_decode_attention``) on the
  same seeded inputs as their JAX twins: fp32 at rtol/atol 2e-5 (as
  ``tests/test_torch_attention.py``), bf16 at atol 2e-2 of outputs of
  order one (probabilities and values round to bf16 in each framework's
  own order of sums); with and without latent scales, ragged lengths and
  ``start_pos > 0``.
- The latent pool: its shape, its bytes against
  ``md.kv_bytes_per_token``, and the written rows at DeepSeek-V3's
  latent width (576): bf16 rows equal, int8 codes and scales equal to
  the JAX writes' under ``jit``.
- ``TransformerLM``: prefill, chunked prefill and decode logits against
  the JAX model at fp32 atol 1e-4 (as ``tests/test_torch_model.py``), for
  ``tests/test_mla.py``'s config (q_lora, 1 dense + 2 MoE layers, a
  shared expert), a q-direct variant (``q_lora_rank`` unset, as
  DeepSeek-V2-Lite publishes it), int8 and int4 weights and an int8
  latent pool; specs and logical axes at DeepSeek-V3's full width.
- DeepSeek's yarn rope: the model's prefill and decode logits.
- Refusals: packed prefill, tensor parallelism, and a CUDA device
  without a card.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaito_tpu.engine import attention as jattn
from kaito_tpu.engine import kv_cache as jkv
from kaito_tpu.engine.model import TransformerLM as JaxLM
from kaito_tpu.engine.quant import quantize_params as j_quantize_params
from kaito_tpu.models import get_model_by_name as jax_model
from kaito_tpu.models.autogen import arch_from_hf_config as j_arch_from_hf
from kaito_tpu_torch.engine import attention as tattn
from kaito_tpu_torch.engine import kv_cache as tkv
from kaito_tpu_torch.engine.model import (TransformerLM, check_tensor_parallel,
                                          params_from_jax)
from kaito_tpu_torch.models import get_model_by_name
from kaito_tpu_torch.models.autogen import (arch_from_hf_config,
                                            metadata_from_hf_config)
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# tests/test_mla.py's config
MLA_CFG = {
    "architectures": ["DeepseekV3ForCausalLM"],
    "model_type": "deepseek_v3",
    "vocab_size": 512,
    "hidden_size": 64,
    "num_hidden_layers": 3,
    "num_attention_heads": 4,
    "num_key_value_heads": 4,
    "intermediate_size": 128,
    "moe_intermediate_size": 32,
    "n_routed_experts": 4,
    "num_experts_per_tok": 2,
    "n_shared_experts": 1,
    "first_k_dense_replace": 1,
    "kv_lora_rank": 32,
    "q_lora_rank": 48,
    "qk_rope_head_dim": 16,
    "qk_nope_head_dim": 24,
    "v_head_dim": 24,
    "max_position_embeddings": 256,
}
# the q-direct form: no q_lora_rank, q projected straight from the input
Q_DIRECT_CFG = {k: v for k, v in MLA_CFG.items() if k != "q_lora_rank"}
CONFIGS = {"q_lora": MLA_CFG, "q_direct": Q_DIRECT_CFG}

PS, P, PMAX = 16, 40, 6
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=0, atol=2e-2)
TOL = dict(rtol=1e-4, atol=1e-4)
KV8_TOL = dict(rtol=0, atol=1e-3)      # see _prefill_then_decode


def _t(a):
    return torch.from_numpy(np.array(a))


def _both(a, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype``
    ("float32" or "bfloat16"; both round to nearest even)."""
    if dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), _t(a).to(torch.bfloat16)
    return jnp.asarray(a), _t(a)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# The attention functions
# ---------------------------------------------------------------------------

H, DN, DR, DL, DV = 4, 24, 16, 32, 24


def _weights(rng):
    return (rng.randn(DL, H * DN).astype(np.float32) / np.sqrt(DL),
            rng.randn(DL, H * DV).astype(np.float32) / np.sqrt(DL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_attention_matches(dtype, ragged):
    rng = np.random.RandomState(0)
    B, T = 2, 20
    arrays = (rng.randn(B, T, H, DN), rng.randn(B, T, H, DR), rng.randn(B, T, DL),
              rng.randn(B, T, DR), *_weights(rng))
    pairs = [_both(a.astype(np.float32), dtype) for a in arrays]
    tl = np.array([20, 7], np.int32) if ragged else None
    want = jattn.mla_prefill_attention(
        *(j for j, _ in pairs), scale=0.1,
        true_len=None if tl is None else jnp.asarray(tl))
    got = tattn.mla_prefill_attention(
        *(t for _, t in pairs), scale=0.1, true_len=None if tl is None else _t(tl))
    assert got.dtype == pairs[0][1].dtype and tuple(got.shape) == (B, T, H, DV)
    rows = [0] if ragged else [0, 1]
    np.testing.assert_allclose(got.float().numpy()[rows], _np(want)[rows],
                               **(F32_TOL if dtype == "float32" else BF16_TOL))
    if ragged:   # valid queries of the short row only
        np.testing.assert_allclose(got.float().numpy()[1, :7], _np(want)[1, :7],
                                   **(F32_TOL if dtype == "float32" else BF16_TOL))


def _latent_pool(rng, quantized, layers, dtype):
    """A latent pool [L, P, PS, 1, DL+DR] (or [P, ...] with ``layers`` 0)
    as (JAX, torch); int8 codes with scales [L, P, 1] when
    ``quantized``."""
    lead = (layers,) if layers else ()
    if quantized:
        codes = rng.randint(-127, 128, lead + (P, PS, 1, DL + DR)).astype(np.int8)
        scale = (rng.rand(*lead, P, 1) * 0.02 + 0.001).astype(np.float32)
        return (jnp.asarray(codes), _t(codes)), (jnp.asarray(scale), _t(scale))
    pool = rng.randn(*lead, P, PS, 1, DL + DR).astype(np.float32)
    return _both(pool, dtype), (None, None)


def _tables(rng, B, pmax=PMAX):
    return np.stack([rng.permutation(np.arange(1, P))[:pmax]
                     for _ in range(B)]).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("layers", [0, 2])
def test_context_attention_matches(dtype, quantized, layers):
    """Chunks that follow earlier chunks: ragged start positions (0, 13,
    40) and lengths, over the full page-table width."""
    rng = np.random.RandomState(1)
    B, T = 3, 16
    (jpool, tpool), (jsc, tsc) = _latent_pool(rng, quantized, layers, dtype)
    pt = _tables(rng, B)
    start = np.array([0, 13, 40], np.int32)
    lens = np.array([16, 9, 1], np.int32)
    qn, qr = (_both(rng.randn(B, T, H, d).astype(np.float32), dtype) for d in (DN, DR))
    wk, wv = (_both(w, dtype) for w in _weights(rng))
    layer = 1 if layers else None
    want = jattn.mla_paged_context_attention(
        qn[0], qr[0], jpool, jnp.asarray(pt), jnp.asarray(start), jnp.asarray(lens),
        wk[0], wv[0], scale=0.1, kv_lora_rank=DL,
        layer=None if layer is None else jnp.asarray(layer), latent_scale=jsc)
    got = tattn.mla_paged_context_attention(
        qn[1], qr[1], tpool, _t(pt), _t(start), _t(lens), wk[1], wv[1], scale=0.1,
        kv_lora_rank=DL, layer=layer, latent_scale=tsc)
    assert got.dtype == qn[1].dtype and tuple(got.shape) == (B, T, H, DV)
    for b in range(B):   # each row's valid queries
        np.testing.assert_allclose(got.float().numpy()[b, :lens[b]],
                                   _np(want)[b, :lens[b]],
                                   **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("layers", [0, 2])
def test_decode_attention_matches(dtype, quantized, layers):
    """One query a sequence over ragged lengths (1 to the full width),
    and a length-0 row (an idle decode slot) whose output is only
    finite."""
    rng = np.random.RandomState(2)
    B = 4
    (jpool, tpool), (jsc, tsc) = _latent_pool(rng, quantized, layers, dtype)
    pt = _tables(rng, B)
    lengths = np.array([1, 37, PMAX * PS, 0], np.int32)
    qn, qr = (_both(rng.randn(B, H, d).astype(np.float32), dtype) for d in (DN, DR))
    wk, wv = (_both(w, dtype) for w in _weights(rng))
    layer = 1 if layers else None
    want = jattn.mla_paged_decode_attention(
        qn[0], qr[0], jpool, jnp.asarray(pt), jnp.asarray(lengths), wk[0], wv[0],
        scale=0.1, kv_lora_rank=DL,
        layer=None if layer is None else jnp.asarray(layer), latent_scale=jsc)
    got = tattn.mla_paged_decode_attention(
        qn[1], qr[1], tpool, _t(pt), _t(lengths), wk[1], wv[1], scale=0.1,
        kv_lora_rank=DL, layer=layer, latent_scale=tsc)
    assert got.dtype == qn[1].dtype and tuple(got.shape) == (B, H, DV)
    np.testing.assert_allclose(got.float().numpy()[:3], _np(want)[:3],
                               **(F32_TOL if dtype == "float32" else BF16_TOL))
    assert torch.isfinite(got.float()).all()


def test_decode_is_the_context_form_at_one_token():
    """The absorbed decode equals the context form with one query at
    start_pos = length - 1: the same arithmetic the JAX package uses for
    both."""
    rng = np.random.RandomState(3)
    (_, pool), _ = _latent_pool(rng, False, 0, "float32")
    pt = _t(_tables(rng, 2))
    lengths = torch.tensor([5, 70], dtype=torch.int32)
    qn, qr = _t(rng.randn(2, H, DN).astype(np.float32)), _t(
        rng.randn(2, H, DR).astype(np.float32))
    wk, wv = (_t(w) for w in _weights(rng))
    dec = tattn.mla_paged_decode_attention(qn, qr, pool, pt, lengths, wk, wv,
                                           scale=0.1, kv_lora_rank=DL)
    ctx = tattn.mla_paged_context_attention(
        qn[:, None], qr[:, None], pool, pt, lengths - 1, torch.ones(2, dtype=torch.int32),
        wk, wv, scale=0.1, kv_lora_rank=DL)[:, 0]
    np.testing.assert_allclose(dec.numpy(), ctx.numpy(), **F32_TOL)


# ---------------------------------------------------------------------------
# The latent pool
# ---------------------------------------------------------------------------

def _archs(cfg=MLA_CFG, **kw):
    return (dataclasses.replace(j_arch_from_hf(cfg), **kw),
            dataclasses.replace(arch_from_hf_config(cfg), **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_latent_pool_shape_and_bytes(dtype):
    """One latent stream: k [L, P, ps, 1, kv_lora_rank + rope], v empty,
    as the JAX package allocates them (both scale pools for int8);
    ``kv_bytes`` counts the stream once, which is what
    ``md.kv_bytes_per_token`` sizes the pool by."""
    jarch, tarch = _archs()
    md = metadata_from_hf_config("test/tiny-mla", MLA_CFG, name="tiny-mla-test")
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    c = tkv.create_kv_cache(tarch, 64, PS, tdt, "cpu")
    j = jkv.create_kv_cache(jarch, 64, PS, jdt)
    assert tuple(c.k.shape) == j.k.shape == (3, 64, PS, 1, 32 + 16)
    assert tuple(c.v.shape) == j.v.shape and c.v.numel() == 0
    el = c.k.element_size()
    scales = 0
    if dtype == "int8":
        assert tuple(c.k_scale.shape) == tuple(c.v_scale.shape) == j.k_scale.shape \
            == (3, 64, 1)
        scales = 64 * tkv.scale_bytes_per_page(tarch)
        assert tkv.scale_bytes_per_page(tarch) == jkv.scale_bytes_per_page(jarch)
    assert tkv.kv_bytes(c) == c.k.numel() * el + scales
    assert tkv.kv_bytes(c) == md.arch.kv_bytes_per_token(el) * PS * 64 + scales


def test_latent_pool_of_deepseek_v3_is_576_wide():
    arch = get_model_by_name("deepseek-v3-0324").arch
    c = tkv.create_kv_cache(dataclasses.replace(arch, num_layers=2), 3, PS,
                            torch.bfloat16, "cpu")
    assert tuple(c.k.shape) == (2, 3, PS, 1, 576) and c.v.numel() == 0
    assert arch.kv_bytes_per_token(2) == 61 * 576 * 2


DEEPSEEK_LATENT = 512 + 64


@pytest.mark.parametrize("quantized", [False, True])
def test_latent_writes_match_jax(quantized):
    """Prefill chunks (one mid-page, with padding), then two decode steps
    with an idle row, at DeepSeek-V3's latent width: bf16 rows equal
    the JAX writes'; int8 codes and scales equal (one absmax scale a
    page over the whole [c_kv ; k_rope] row), except on the null page
    the idle row and the padding write."""
    D = DEEPSEEK_LATENT
    rng = np.random.RandomState(4)
    L, Pp = 2, 10
    dt = torch.int8 if quantized else torch.bfloat16
    tc = torch.zeros((L, Pp, PS, 1, D), dtype=dt)
    jc = jnp.zeros((L, Pp, PS, 1, D), jnp.int8 if quantized else jnp.bfloat16)
    ts = torch.zeros((L, Pp, 1)) if quantized else None
    js = jnp.zeros((L, Pp, 1), jnp.float32) if quantized else None
    if quantized:
        jpre = jax.jit(functools.partial(jkv.write_prefill_tokens_q, page_size=PS))
        jdec = jax.jit(functools.partial(jkv.write_decode_tokens_q, page_size=PS))
    else:
        jpre = jax.jit(functools.partial(jkv.write_prefill_tokens, page_size=PS))
        jdec = jax.jit(functools.partial(jkv.write_decode_tokens, page_size=PS))
    pt = np.array([[3, 5, 8], [7, 2, 0]], np.int32)
    T = 24
    for start, lens, mag in ((np.array([0, 0]), np.array([21, 10]), 0.5),
                             (np.array([21, 10]), np.array([20, 13]), 3.0)):
        new32 = (rng.randn(2, T, 1, D) * mag).astype(np.float32)
        jn, tn = _both(new32, "float32" if quantized else "bfloat16")
        if quantized:
            tkv.write_prefill_tokens_q(tc, ts, tn, _t(pt), _t(start), _t(lens), PS,
                                       layer=1)
            jc, js = jpre(jc, js, jn, jnp.asarray(pt), jnp.asarray(start, jnp.int32),
                          jnp.asarray(lens, jnp.int32), layer=jnp.asarray(1))
        else:
            tkv.write_prefill_tokens(tc, tn, _t(pt), _t(start), _t(lens), PS, layer=1)
            jc = jpre(jc, jn, jnp.asarray(pt), jnp.asarray(start, jnp.int32),
                      jnp.asarray(lens, jnp.int32), layer=jnp.asarray(1))
    pos = np.array([41, 23], np.int32)
    act = np.array([True, False])
    for step in range(2):
        new32 = (rng.randn(2, 1, D) * (1.0 + 4 * step)).astype(np.float32)
        jn, tn = _both(new32, "float32" if quantized else "bfloat16")
        if quantized:
            tkv.write_decode_tokens_q(tc, ts, tn, _t(pt), _t(pos + step), PS,
                                      active=_t(act), layer=1)
            jc, js = jdec(jc, js, jn, jnp.asarray(pt), jnp.asarray(pos + step),
                          active=jnp.asarray(act), layer=jnp.asarray(1))
        else:
            tkv.write_decode_tokens(tc, tn, _t(pt), _t(pos + step), PS,
                                    active=_t(act), layer=1)
            jc = jdec(jc, jn, jnp.asarray(pt), jnp.asarray(pos + step),
                      active=jnp.asarray(act), layer=jnp.asarray(1))
    if quantized:
        np.testing.assert_array_equal(tc.numpy()[:, 1:], np.asarray(jc)[:, 1:])
        np.testing.assert_array_equal(ts.numpy()[:, 1:], np.asarray(js)[:, 1:])
        assert ts[1, 8].item() > 0 and not tc[0].any()
    else:
        np.testing.assert_array_equal(tc.float().numpy()[:, 1:], _np(jc)[:, 1:])
        assert tc[1, 8].abs().sum() > 0 and not tc[0].any()


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

_JAX_SIDE: dict = {}


def _jax_side(name):
    if name not in _JAX_SIDE:
        jarch, tarch = _archs(CONFIGS[name])
        jm = JaxLM(jarch, dtype=jnp.float32)
        jm.moe_impl = "ragged"
        _JAX_SIDE[name] = (jm, jm.init_params(jax.random.PRNGKey(0)), tarch)
    return _JAX_SIDE[name]


def _port(name="q_lora", quant=""):
    jm, jp, tarch = _jax_side(name)
    if quant:
        jp = jax.jit(j_quantize_params, static_argnums=1)(jp, quant)
    tm = TransformerLM(tarch, dtype=torch.float32, device="cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, jp), tarch))
    return jm, jp, tm


def _ptables(B):
    return np.stack([np.arange(1 + b * PMAX, 1 + (b + 1) * PMAX)
                     for b in range(B)]).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _caches(jm, tm, kv):
    jdt, tdt = (jnp.int8, torch.int8) if kv == "int8" else (jnp.float32, torch.float32)
    return (jkv.create_kv_cache(jm.arch, P, PS, jdt),
            tkv.create_kv_cache(tm.arch, P, PS, tdt, "cpu"))


def _prefill_then_decode(jm, jp, tm, kv="float32", steps=3):
    """Prefill two prompts (16 and 11 tokens), then decode with the
    second row inactive; the live rows' logits and the written latent
    pages compared.

    An int8 pool is compared per write: the two frameworks' fp32 latents
    differ in their last bits, so a value that sits on a rounding edge
    of its page scale takes codes one apart (about one value in a
    hundred here).  One code step moves a latent element by its page's
    scale and these logits by up to ~2e-4, and a step would carry every
    earlier step's flips, so each decode step starts from the JAX pool
    (codes and scales copied in), its logits are held at atol 1e-3, and
    its writes must give the JAX codes but for at most two values a
    step, each one apart, and the JAX scales to 1e-6."""
    rng = np.random.RandomState(0)
    B, T = 2, 16
    toks = rng.randint(0, tm.arch.vocab_size, size=(B, T)).astype(np.int32)
    tl = np.array([16, 11], np.int32)
    pt = _ptables(B)
    jc, tc = _caches(jm, tm, kv)
    jc, jl, jh = jm.prefill(jp, jc, jnp.asarray(toks), jnp.asarray(tl),
                            jnp.asarray(pt))
    tc, tlg, th = tm.prefill(tc, _t(toks), _t(tl), _t(pt))
    _close(tlg, jl)
    _close(th, jh)
    pos = tl.copy()
    nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    act = np.array([True, False])
    for _ in range(steps):
        if kv == "int8":
            _same_codes(tc, jc)
            tc.k.copy_(_t(np.asarray(jc.k)))
            tc.k_scale.copy_(_t(np.asarray(jc.k_scale)))
        jc, jl = jm.decode(jp, jc, jnp.asarray(nxt), jnp.asarray(pos),
                           jnp.asarray(pt), active=jnp.asarray(act))
        tc, tlg = tm.decode(tc, _t(nxt), _t(pos), _t(pt), active=_t(act))
        np.testing.assert_allclose(tlg[:1].numpy(), np.asarray(jl)[:1],
                                   **(KV8_TOL if kv == "int8" else TOL))
        nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        pos = pos + act
    if kv == "int8":
        _same_codes(tc, jc)
    else:
        np.testing.assert_allclose(tc.k.numpy()[:, 1:], np.asarray(jc.k)[:, 1:], **TOL)


def _same_codes(tc, jc):
    """The latent codes and scales of every page but the null page: codes
    equal but for at most two values one apart, scales to 1e-6."""
    diff = np.abs(tc.k.numpy()[:, 1:].astype(np.int32)
                  - np.asarray(jc.k)[:, 1:].astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).sum() <= 2
    np.testing.assert_allclose(tc.k_scale.numpy()[:, 1:],
                               np.asarray(jc.k_scale)[:, 1:], rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_model_matches_jax(name):
    jm, jp, tm = _port(name)
    assert tm.is_mla and [(g.name, g.count, g.moe) for g in tm.groups] == \
        [(g.name, g.count, g.moe) for g in jm.groups] == [("dense", 1, False),
                                                           ("moe", 2, True)]
    assert ("q_a" in tm.param_tree()["dense"]) == (name == "q_lora")
    _prefill_then_decode(jm, jp, tm)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("layer,group,index", [(0, "dense", 0), (2, "moe", 1)])
def test_model_decode_attention_matches_jax(layer, group, index, quantized):
    """``TransformerLM.mla_decode_attention`` (one layer's decode attention
    over a given latent pool, as a decode step runs it) against the JAX
    function with that layer's kv_b weights and the JAX model's scale."""
    jm, jp, tm = _port()
    rng = np.random.RandomState(4)
    B, L = 3, tm.arch.num_layers
    (jpool, tpool), (jsc, tsc) = _latent_pool(rng, quantized, L, "float32")
    cache = tkv.create_kv_cache(tm.arch, P, PS, torch.int8 if quantized
                                else torch.float32, "cpu")
    cache.k.copy_(tpool)
    if quantized:
        cache.k_scale.copy_(tsc)
    pt = _tables(rng, B)
    lengths = np.array([1, 37, PMAX * PS], np.int32)
    qn, qr = (rng.randn(B, H, d).astype(np.float32) for d in (DN, DR))
    want = jattn.mla_paged_decode_attention(
        jnp.asarray(qn), jnp.asarray(qr), jpool, jnp.asarray(pt), jnp.asarray(lengths),
        jp[group]["kv_b_k"][index], jp[group]["kv_b_v"][index], scale=jm._scale,
        kv_lora_rank=DL, layer=jnp.asarray(layer), latent_scale=jsc)
    got = tm.mla_decode_attention(cache, _t(qn), _t(qr), _t(pt), _t(lengths),
                                  layer=layer)
    assert tuple(got.shape) == (B, H, DV)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32_TOL)


@pytest.mark.parametrize("quant,kv", [("int8", "float32"), ("int4", "float32"),
                                      ("", "int8")])
def test_quantized_model_matches_jax(quant, kv):
    """int8 / int4 weights (the JAX tree from ``quantize_params``: q_a,
    q_b, kv_a, o, the MLPs and experts as QTensors, kv_b_k / kv_b_v
    plain) and an int8 latent pool."""
    jm, jp, tm = _port(quant=quant)
    if quant:
        dense = tm.param_tree()["dense"]
        for name in ("q_a", "q_b", "kv_a", "o", "gate", "up", "down"):
            assert isinstance(dense[name], dict), name
        for name in ("kv_b_k", "kv_b_v", "q_a_norm", "kv_a_norm"):
            assert isinstance(dense[name], torch.Tensor), name
    _prefill_then_decode(jm, jp, tm, kv=kv, steps=2)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("first", [12, 16])   # 16: the split on a page edge
def test_chunked_prefill_with_start_pos_matches(name, first):
    """A second chunk attends over the first through the paged latent
    (the absorbed context form), against the JAX model and against one
    whole prefill of the same 24 tokens."""
    jm, jp, tm = _port(name)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, tm.arch.vocab_size, size=(1, 24)).astype(np.int32)
    pt = _ptables(1)
    jc, tc = _caches(jm, tm, "float32")
    chunk1 = np.zeros((1, 16), np.int32)
    chunk1[0, :first] = toks[0, :first]
    n1 = np.array([first], np.int32)
    jc, _, _ = jm.prefill(jp, jc, jnp.asarray(chunk1), jnp.asarray(n1), jnp.asarray(pt))
    tc, _, _ = tm.prefill(tc, _t(chunk1), _t(n1), _t(pt))
    chunk2 = np.zeros((1, 16), np.int32)
    chunk2[0, :24 - first] = toks[0, first:]
    start = np.array([first], np.int32)
    n = np.array([24 - first], np.int32)
    jc, jl, _ = jm.prefill(jp, jc, jnp.asarray(chunk2), jnp.asarray(n),
                           jnp.asarray(pt), start_pos=jnp.asarray(start))
    tc, tlg, _ = tm.prefill(tc, _t(chunk2), _t(n), _t(pt), start_pos=_t(start))
    _close(tlg, jl)
    _, wl, _ = tm.prefill(tkv.create_kv_cache(tm.arch, P, PS, torch.float32, "cpu"),
                          _t(toks), torch.tensor([24], dtype=torch.int32), _t(pt))
    np.testing.assert_allclose(tlg.numpy(), wl.numpy(), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("name", ["tiny-mla", "tiny-mla-q-direct", "deepseek-v3-0324"])
def test_specs_and_axes_match_jax(name):
    """Layer groups, every parameter's shape and its logical axes; at
    DeepSeek-V3's full width (built, never initialised) too."""
    if name == "deepseek-v3-0324":
        jarch, tarch = jax_model(name).arch, get_model_by_name(name).arch
    else:
        jarch, tarch = _archs(MLA_CFG if name == "tiny-mla" else Q_DIRECT_CFG)
    jm = JaxLM(jarch, dtype=jnp.bfloat16)
    tm = TransformerLM(tarch, dtype=torch.bfloat16, device="cpu")
    assert [g.name for g in tm.groups] == [g.name for g in jm.groups]
    for g in tm.groups:
        assert tm._layer_specs(g.moe) == {n: s for n, (s, _)
                                          in jm._layer_specs(g.moe).items()}
    assert tm.param_logical_axes() == jm.param_logical_axes()
    assert tm._scale == jm._scale
    np.testing.assert_allclose(tm._inv_freq_global.numpy(),
                               np.asarray(jm._inv_freq_global), rtol=1e-6)
    if name == "deepseek-v3-0324":
        assert tm._layer_specs(True)["kv_b_k"] == (512, 128 * 128)
        assert tm._layer_specs(True)["router"] == (7168, 256)


@pytest.mark.parametrize("quant", ["", "int8"])
def test_synthetic_mla_init(quant):
    """Synthetic weights: the latent projections quantize under int8,
    kv_b_k / kv_b_v and the norms stay plain, and a seed reproduces."""
    _, tarch = _archs()
    a = TransformerLM(tarch, dtype=torch.float32, device="cpu")
    a.init_params(seed=3, quantization=quant)
    b = TransformerLM(tarch, dtype=torch.float32, device="cpu")
    b.init_params(seed=3, quantization=quant)
    ta, tb = a.param_tree(), b.param_tree()
    for g in ("dense", "moe"):
        assert torch.all(ta[g]["kv_a_norm"] == 1.0) and torch.all(ta[g]["q_a_norm"] == 1.0)
        assert isinstance(ta[g]["kv_b_k"], torch.Tensor)
        assert isinstance(ta[g]["kv_a"], dict) == bool(quant)
        want = tb[g]["kv_a"]["q8"] if quant else tb[g]["kv_a"]
        assert torch.equal(ta[g]["kv_a"]["q8"] if quant else ta[g]["kv_a"], want)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_packed_prefill_raises():
    _, _, tm = _port()
    c = tkv.create_kv_cache(tm.arch, P, PS, torch.float32, "cpu")
    z = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="MLA"):
        tm.prefill_packed(c, z, z, z, torch.zeros(16, dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32))


def test_tensor_parallel_raises_with_the_roadmap_item():
    _, tarch = _archs()
    check_tensor_parallel(tarch, 1)
    with pytest.raises(NotImplementedError, match="item 40"):
        check_tensor_parallel(tarch, 2)
    with pytest.raises(NotImplementedError, match="item 40"):
        check_tensor_parallel(get_model_by_name("deepseek-v3-0324").arch, 8)


@pytest.mark.parametrize("mscale", [1.0, 0.707])
def test_yarn_rope_model_matches_jax(mscale):
    """DeepSeek's yarn rope (the mscale ratio on the rope table, the
    all-dim mscale squared in the softmax scale): prefill and decode
    logits against the JAX model."""
    scaling = {"type": "yarn", "factor": 40.0, "mscale": mscale,
               "mscale_all_dim": 1.0, "original_max_position_embeddings": 64}
    jarch, tarch = _archs(rope_scaling=scaling)
    jm = JaxLM(jarch, dtype=jnp.float32)
    jm.moe_impl = "ragged"
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = TransformerLM(tarch, dtype=torch.float32, device="cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, jp), tarch))
    assert tm._scale == jm._scale and tm._rope_mscale == jm._rope_mscale
    _prefill_then_decode(jm, jp, tm)


def test_cuda_without_a_card_raises():
    """The default device is the card; without one nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path runs instead")
    _, tarch = _archs()
    with pytest.raises((RuntimeError, AssertionError)):
        TransformerLM(tarch, dtype=torch.float32)
    with pytest.raises((RuntimeError, AssertionError)):
        tkv.create_kv_cache(tarch, 4, PS, torch.float32)
