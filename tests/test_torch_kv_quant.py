"""kaito_tpu_torch int8 KV cache against kaito_tpu's.

- The quantizing page writes (decode, prefill, segment-packed) land the
  same int8 codes and fp32 scales as the JAX package's writes under
  ``jit`` (as the JAX engine runs them), exactly, in every page but the
  null page 0, which takes the writes of inactive rows and padding.
  Exact: the fold, the requantization and the rounding are the same
  fp32 operations in the same order.
- The plain version of the quantized decode kernel (K1q) agrees with the
  Pallas kernel in interpret mode and with the JAX plain decode, in fp32
  at atol 2e-5 as ``tests/test_kv_quant.py`` holds them; the paged
  context and decode references read int8 pages through their scales.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaito_tpu.engine import attention as jattn
from kaito_tpu.engine import kv_cache as jkv
from kaito_tpu.engine.ops.decode_attention import paged_decode_attention_pallas
from kaito_tpu.models import get_model_by_name as jax_model
from kaito_tpu_torch.engine import attention as tattn
from kaito_tpu_torch.engine import kv_cache as tkv
from kaito_tpu_torch.engine.ops import decode_attention as tdec
from kaito_tpu_torch.models import get_model_by_name
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

PRESET = "tiny-llama-test"
PS = 16
BIG = 1 << 30
TOL = dict(rtol=0, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pools(L=3, P=12, Hkv=2, D=16):
    """Zeroed int8 pools and scales, one numpy copy per package."""
    return (np.zeros((L, P, PS, Hkv, D), np.int8),
            np.zeros((L, P, Hkv), np.float32))


def _same_except_null(t_cache, t_scale, j_cache, j_scale):
    np.testing.assert_array_equal(t_cache.numpy()[:, 1:], np.asarray(j_cache)[:, 1:])
    np.testing.assert_array_equal(t_scale.numpy()[:, 1:], np.asarray(j_scale)[:, 1:])


def test_create_int8_pool():
    arch = get_model_by_name(PRESET).arch
    c = tkv.create_kv_cache(arch, 6, PS, torch.int8, "cpu")
    j = jkv.create_kv_cache(jax_model(PRESET).arch, 6, PS, jnp.int8)
    assert c.quantized and c.k.dtype == torch.int8
    for t, jj in ((c.k, j.k), (c.k_scale, j.k_scale), (c.v_scale, j.v_scale)):
        assert tuple(t.shape) == jj.shape and not t.any()
    assert c.k_scale.dtype == torch.float32
    assert not tkv.create_kv_cache(arch, 6, PS, torch.bfloat16, "cpu").quantized
    assert tkv.scale_bytes_per_page(arch) == jkv.scale_bytes_per_page(
        jax_model(PRESET).arch)
    assert tkv.kv_cache_is_quantized(torch.int8)
    assert not tkv.kv_cache_is_quantized(torch.bfloat16)


def test_dequantize_pages_matches():
    rng = np.random.RandomState(0)
    pages = rng.randint(-127, 128, (5, PS, 2, 8)).astype(np.int8)
    scale = rng.rand(5, 2).astype(np.float32)
    np.testing.assert_array_equal(
        tkv.dequantize_pages(_t(pages), _t(scale)).numpy(),
        np.asarray(jkv.dequantize_pages(jnp.asarray(pages), jnp.asarray(scale))))


def test_decode_writes_match_with_growth_and_an_inactive_row():
    """Three steps into shared and fresh pages: later, larger tokens grow
    the page scales and requantize the earlier codes; row 2 is
    inactive and writes only the null page."""
    ck, cs = _pools()
    tc, ts = _t(ck), _t(cs)
    jc, js = jnp.asarray(ck), jnp.asarray(cs)
    jfn = jax.jit(functools.partial(jkv.write_decode_tokens_q, page_size=PS))
    rng = np.random.RandomState(1)
    pt = np.array([[3, 5, 0], [7, 0, 0], [9, 0, 0], [2, 4, 0]], np.int32)
    active = np.array([True, True, False, True])
    for step, (pos, mag) in enumerate(((np.array([0, 3, 0, 15]), 0.1),
                                       (np.array([1, 4, 0, 16]), 5.0),
                                       (np.array([16, 5, 0, 17]), 1.0))):
        new = (rng.randn(4, 2, 16) * mag).astype(np.float32)
        out = tkv.write_decode_tokens_q(tc, ts, _t(new), _t(pt), _t(pos), PS,
                                        active=_t(active), layer=1)
        assert out[0] is tc and out[1] is ts          # in place
        jc, js = jfn(jc, js, jnp.asarray(new), jnp.asarray(pt),
                     jnp.asarray(pos, jnp.int32), active=jnp.asarray(active),
                     layer=jnp.asarray(1))
        _same_except_null(tc, ts, jc, js)
    assert not tc[:, 9].any() and not ts[:, 9].any()   # the inactive row's page
    assert ts[1, 3].min() > 0                         # grown, finite


def test_decode_writes_without_layer_or_mask_match():
    ck, cs = _pools()
    rng = np.random.RandomState(2)
    new = rng.randn(2, 2, 16).astype(np.float32)
    pt = np.array([[6, 0], [8, 0]], np.int32)
    pos = np.array([2, 9], np.int32)
    tc, ts = _t(ck[0]), _t(cs[0])
    tkv.write_decode_tokens_q(tc, ts, _t(new), _t(pt), _t(pos), PS)
    jc, js = jax.jit(functools.partial(jkv.write_decode_tokens_q, page_size=PS))(
        jnp.asarray(ck[0]), jnp.asarray(cs[0]), jnp.asarray(new), jnp.asarray(pt),
        jnp.asarray(pos))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_prefill_writes_match_mid_page_padding_and_growth():
    """A first chunk, then a continuation chunk that starts mid-page with
    larger values (its pages' scales grow and the first chunk's codes
    are requantized); the rows carry padding past their true length and
    one row is empty."""
    ck, cs = _pools()
    tc, ts = _t(ck), _t(cs)
    jc, js = jnp.asarray(ck), jnp.asarray(cs)
    jfn = jax.jit(functools.partial(jkv.write_prefill_tokens_q, page_size=PS))
    rng = np.random.RandomState(3)
    pt = np.array([[3, 5, 8, 0], [7, 2, 0, 0], [9, 0, 0, 0]], np.int32)
    T = 24
    for start, lens, mag in ((np.array([0, 0, 0]), np.array([21, 10, 0]), 0.5),
                             (np.array([21, 10, 0]), np.array([20, 13, 0]), 3.0)):
        new = (rng.randn(3, T, 2, 16) * mag).astype(np.float32)
        tkv.write_prefill_tokens_q(tc, ts, _t(new), _t(pt), _t(start), _t(lens), PS,
                                   layer=2)
        jc, js = jfn(jc, js, jnp.asarray(new), jnp.asarray(pt),
                     jnp.asarray(start, jnp.int32), jnp.asarray(lens, jnp.int32),
                     layer=jnp.asarray(2))
        _same_except_null(tc, ts, jc, js)
    assert not tc[2, 9].any()                 # the empty row wrote nothing
    deq = tkv.dequantize_pages(tc[2], ts[2]).numpy()
    assert np.isfinite(deq).all()


def test_packed_writes_match_the_serial_writes_and_jax():
    """Two fresh segments and pad tokens in one row: the same codes and
    scales as the JAX packed write, and as the serial prefill write of
    each segment."""
    ck, cs = _pools()
    rng = np.random.RandomState(4)
    lens = (21, 9)
    T = 32
    new = rng.randn(1, T, 2, 16).astype(np.float32)
    tables = [np.array([3, 5], np.int32), np.array([7], np.int32)]
    pack_pages = np.concatenate(tables)                     # [3, 5, 7]
    slot = np.full((T,), len(pack_pages), np.int32)         # pads: one past the end
    offsets = np.zeros((T,), np.int32)
    slot[:21] = np.arange(21) // PS
    offsets[:21] = np.arange(21) % PS
    slot[21:30] = 2
    offsets[21:30] = np.arange(9)
    tc, ts = _t(ck), _t(cs)
    tkv.write_packed_prefill_tokens_q(tc, ts, _t(new), _t(pack_pages), _t(slot),
                                      _t(offsets), layer=0)
    jfn = jax.jit(jkv.write_packed_prefill_tokens_q)
    jc, js = jfn(jnp.asarray(ck), jnp.asarray(cs), jnp.asarray(new),
                 jnp.asarray(pack_pages), jnp.asarray(slot), jnp.asarray(offsets),
                 layer=jnp.asarray(0))
    _same_except_null(tc, ts, jc, js)
    # the serial writes of the two segments land the same bytes
    sc, ss = _t(ck), _t(cs)
    for si, (off, n) in enumerate(((0, 21), (21, 9))):
        pt = np.zeros((1, 2), np.int32)
        pt[0, :len(tables[si])] = tables[si]
        tkv.write_prefill_tokens_q(sc, ss, _t(new[:, off:off + n]), _t(pt),
                                   _t(np.array([0], np.int32)),
                                   _t(np.array([n], np.int32)), PS, layer=0)
    np.testing.assert_array_equal(sc[:, 1:].numpy(), tc[:, 1:].numpy())
    np.testing.assert_array_equal(ss[:, 1:].numpy(), ts[:, 1:].numpy())


def _quantized_pool(rng, L, P, Hkv, D):
    """Random pages quantized per (page, head) as the writes would."""
    pages = rng.randn(L, P, PS, Hkv, D).astype(np.float32)
    scale = np.abs(pages).max(axis=(2, 4)) / 127.0               # [L, P, Hkv]
    codes = np.clip(np.round(pages / scale[:, :, None, :, None]), -127, 127)
    return codes.astype(np.int8), scale.astype(np.float32)


@pytest.mark.parametrize("softcap,window", [(None, BIG), (20.0, BIG), (None, 23)])
def test_k1q_plain_matches_pallas_and_the_jax_decode(softcap, window):
    rng = np.random.RandomState(5)
    B, Hkv, G, D, P, pmax, L = 3, 2, 2, 32, 10, 4, 2
    q = rng.randn(B, Hkv * G, D).astype(np.float32)
    k8, ks = _quantized_pool(rng, L, P, Hkv, D)
    v8, vs = _quantized_pool(rng, L, P, Hkv, D)
    pt = np.stack([rng.permutation(np.arange(1, P))[:pmax] for _ in range(B)]
                  ).astype(np.int32)
    lens = np.array([5, PS * pmax, 37], np.int32)
    scale = D ** -0.5
    got = tdec.paged_decode_attention_cuda(
        _t(q), _t(k8), _t(v8), _t(pt), _t(lens), window, scale=scale,
        softcap=softcap, layer=1, k_scale=_t(ks), v_scale=_t(vs)).numpy()
    pallas = paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(pt),
        jnp.asarray(lens), jnp.asarray(window, jnp.int32), scale=scale,
        softcap=softcap, layer=jnp.asarray(1), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), interpret=True)
    plain = jattn.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(pt),
        jnp.asarray(lens), scale=scale, logit_softcap=softcap,
        sliding_window=None if window == BIG else window, layer=jnp.asarray(1),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(plain), **TOL)


def test_decode_reference_with_scales_matches():
    rng = np.random.RandomState(6)
    B, Hkv, G, D, P, pmax = 2, 2, 2, 32, 8, 3
    q = rng.randn(B, Hkv * G, D).astype(np.float32)
    k8, ks = _quantized_pool(rng, 1, P, Hkv, D)
    v8, vs = _quantized_pool(rng, 1, P, Hkv, D)
    pt = np.array([[2, 4, 6], [1, 3, 0]], np.int32)
    lens = np.array([40, 20], np.int32)
    got = tattn.paged_decode_attention(
        _t(q), _t(k8[0]), _t(v8[0]), _t(pt), _t(lens), scale=0.2,
        k_scale=_t(ks[0]), v_scale=_t(vs[0])).numpy()
    want = jattn.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k8[0]), jnp.asarray(v8[0]), jnp.asarray(pt),
        jnp.asarray(lens), scale=0.2, k_scale=jnp.asarray(ks[0]),
        v_scale=jnp.asarray(vs[0]))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("layer", [None, 1])
def test_paged_context_attention_with_scales_matches(layer):
    rng = np.random.RandomState(7)
    B, T, Hkv, G, D, P, pmax = 2, 8, 2, 2, 32, 10, 4
    q = rng.randn(B, T, Hkv * G, D).astype(np.float32)
    k8, ks = _quantized_pool(rng, 2, P, Hkv, D)
    v8, vs = _quantized_pool(rng, 2, P, Hkv, D)
    if layer is None:
        k8, ks, v8, vs = k8[0], ks[0], v8[0], vs[0]
    pt = np.array([[3, 5, 7, 0], [2, 4, 6, 8]], np.int32)
    start = np.array([20, 40], np.int32)
    lens = np.array([T, 5], np.int32)
    got = tattn.paged_context_attention(
        _t(q), _t(k8), _t(v8), _t(pt), _t(start), _t(lens), scale=0.2,
        sliding_window=24, layer=layer, k_scale=_t(ks), v_scale=_t(vs)).numpy()
    want = jattn.paged_context_attention(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(pt),
        jnp.asarray(start), jnp.asarray(lens), scale=0.2, sliding_window=24,
        layer=None if layer is None else jnp.asarray(layer),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    for b in range(B):
        n = int(lens[b])
        np.testing.assert_allclose(got[b, :n], np.asarray(want)[b, :n], **TOL)
