"""kaito_tpu_torch attention against kaito_tpu attention on the CPU.

The four reference functions of ``engine.attention`` are held against
their JAX twins with the fixtures of ``tests/test_pallas_ops.py`` and
``tests/test_flash_prefill.py``; the plain versions of the three CUDA
kernels (the code a wrapper runs for CPU tensors) are held against the
Pallas kernels themselves in interpret mode, one small case each.
Tolerance: fp32 rtol/atol 2e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaito_tpu.engine import attention as jattn
from kaito_tpu.engine.ops.decode_attention import paged_decode_attention_pallas
from kaito_tpu.engine.ops.flash_prefill import (flash_prefill_attention,
                                                flash_prefill_packed)
from kaito_tpu_torch.engine import attention as tattn
from kaito_tpu_torch.engine.ops import decode_attention as tdec
from kaito_tpu_torch.engine.ops import flash_prefill as tflash
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

BIG = 1 << 30
TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _decode_setup(B=3, Hkv=2, G=2, D=64, ps=16, pmax=6, P=32, seed=0):
    rng = np.random.RandomState(seed)
    H = Hkv * G
    q = rng.randn(B, H, D).astype(np.float32)
    ck = rng.randn(P, ps, Hkv, D).astype(np.float32)
    cv = rng.randn(P, ps, Hkv, D).astype(np.float32)
    pt = np.zeros((B, pmax), np.int32)
    for b in range(B):
        pt[b] = rng.permutation(np.arange(1, P))[:pmax]
    lengths = rng.randint(1, pmax * ps, size=(B,)).astype(np.int32)
    return q, ck, cv, pt, lengths


def _prefill_setup(B=2, T=64, Hkv=2, G=2, D=32, seed=0):
    rng = np.random.RandomState(seed)
    H = Hkv * G
    return (rng.randn(B, T, H, D).astype(np.float32),
            rng.randn(B, T, Hkv, D).astype(np.float32),
            rng.randn(B, T, Hkv, D).astype(np.float32))


def _packed_layout(T, seg_lens):
    segs = np.full((1, T), -1, np.int32)
    poss = np.zeros((1, T), np.int32)
    off = 0
    for si, ln in enumerate(seg_lens):
        segs[0, off:off + ln] = si
        poss[0, off:off + ln] = np.arange(ln)
        off += ln
    return segs, poss


# ---------------------------------------------------------------------------
# engine.attention vs kaito_tpu.engine.attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,softcap,G,Hkv,seed", [
    (None, None, 2, 2, 0),
    (7, None, 2, 2, 0),
    (None, 30.0, 2, 2, 0),
    (None, None, 4, 1, 5),          # MQA
])
def test_paged_decode_attention_matches(window, softcap, G, Hkv, seed):
    q, ck, cv, pt, lengths = _decode_setup(G=G, Hkv=Hkv, seed=seed)
    want = jattn.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pt),
        jnp.asarray(lengths), scale=0.125, sliding_window=window,
        logit_softcap=softcap)
    got = tattn.paged_decode_attention(
        _t(q), _t(ck), _t(cv), _t(pt), _t(lengths), scale=0.125,
        sliding_window=window, logit_softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_decode_attention_stacked_layer_matches():
    q, ck, cv, pt, lengths = _decode_setup(seed=3)
    ck2, cv2 = np.stack([cv, ck]), np.stack([ck, cv])
    want = jattn.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(ck2), jnp.asarray(cv2), jnp.asarray(pt),
        jnp.asarray(lengths), scale=0.2, layer=jnp.asarray(1))
    got = tattn.paged_decode_attention(
        _t(q), _t(ck2), _t(cv2), _t(pt), _t(lengths), scale=0.2, layer=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window,softcap,true_lens", [
    (None, None, (64, 64)),
    (None, None, (50, 23)),        # ragged
    (9, None, (64, 64)),           # sliding window
    (None, 25.0, (64, 40)),        # softcap
])
def test_prefill_attention_matches(window, softcap, true_lens):
    q, k, v = _prefill_setup()
    tl = np.asarray(true_lens, np.int32)
    want = jattn.prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.17,
        sliding_window=window, logit_softcap=softcap, true_len=jnp.asarray(tl))
    got = tattn.prefill_attention(_t(q), _t(k), _t(v), scale=0.17,
                                  sliding_window=window, logit_softcap=softcap,
                                  true_len=_t(tl))
    for b, n in enumerate(true_lens):
        np.testing.assert_allclose(got[b, :n].numpy(), np.asarray(want[b, :n]),
                                   **TOL)


@pytest.mark.parametrize("window,softcap,seg_lens", [
    (None, None, (20, 30, 14)),
    (None, None, (25, 17)),        # trailing pad
    (7, None, (20, 30, 14)),
    (None, 25.0, (40, 10)),
    (None, None, (64,)),
])
def test_packed_prefill_attention_matches(window, softcap, seg_lens):
    q, k, v = _prefill_setup(B=1)
    segs, poss = _packed_layout(64, seg_lens)
    want = jattn.packed_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(segs),
        jnp.asarray(poss), scale=0.17, sliding_window=window,
        logit_softcap=softcap)
    got = tattn.packed_prefill_attention(
        _t(q), _t(k), _t(v), _t(segs), _t(poss), scale=0.17,
        sliding_window=window, logit_softcap=softcap)
    n = sum(seg_lens)
    np.testing.assert_allclose(got[0, :n].numpy(), np.asarray(want[0, :n]), **TOL)


@pytest.mark.parametrize("window,softcap", [(None, None), (5, None), (None, 20.0)])
def test_paged_context_attention_matches(window, softcap):
    rng = np.random.RandomState(7)
    B, T, Hkv, G, D, ps, P, pmax = 2, 8, 2, 2, 32, 4, 20, 6
    q = rng.randn(B, T, Hkv * G, D).astype(np.float32)
    ck = rng.randn(2, P, ps, Hkv, D).astype(np.float32)
    cv = rng.randn(2, P, ps, Hkv, D).astype(np.float32)
    pt = np.stack([rng.permutation(np.arange(1, P))[:pmax] for _ in range(B)]
                  ).astype(np.int32)
    start = np.array([5, 12], np.int32)
    tl = np.array([8, 3], np.int32)
    want = jattn.paged_context_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pt),
        jnp.asarray(start), jnp.asarray(tl), scale=0.2, sliding_window=window,
        logit_softcap=softcap, layer=jnp.asarray(1))
    got = tattn.paged_context_attention(
        _t(q), _t(ck), _t(cv), _t(pt), _t(start), _t(tl), scale=0.2,
        sliding_window=window, logit_softcap=softcap, layer=1)
    for b in range(B):
        np.testing.assert_allclose(got[b, :tl[b]].numpy(),
                                   np.asarray(want[b, :tl[b]]), **TOL)


# ---------------------------------------------------------------------------
# the kernels' plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def test_decode_kernel_plain_matches_pallas():
    q, ck, cv, pt, lengths = _decode_setup(seed=1)
    want = paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pt),
        jnp.asarray(lengths), jnp.asarray(9, jnp.int32), scale=0.125,
        softcap=30.0, interpret=True)
    got = tdec.paged_decode_attention_plain(
        _t(q), _t(ck), _t(cv), _t(pt), _t(lengths), 9, scale=0.125,
        softcap=30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_kernel_plain_matches_pallas():
    q, k, v = _prefill_setup()
    tl = np.array([50, 23], np.int32)
    want = flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tl),
        jnp.asarray(9, jnp.int32), scale=0.17, softcap=25.0, block_q=16,
        block_k=16, interpret=True)
    got = tflash.flash_prefill_attention_plain(
        _t(q), _t(k), _t(v), _t(tl), 9, scale=0.17, softcap=25.0)
    for b, n in enumerate(tl):
        np.testing.assert_allclose(got[b, :n].numpy(), np.asarray(want[b, :n]),
                                   **TOL)


def test_flash_packed_kernel_plain_matches_pallas():
    q, k, v = _prefill_setup(B=1)
    segs, poss = _packed_layout(64, (20, 30, 9))
    want = flash_prefill_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(segs),
        jnp.asarray(poss), jnp.asarray(7, jnp.int32), scale=0.17, block_q=16,
        block_k=16, interpret=True)
    got = tflash.flash_prefill_packed_plain(
        _t(q), _t(k), _t(v), _t(segs), _t(poss), 7, scale=0.17)
    np.testing.assert_allclose(got[0, :59].numpy(), np.asarray(want[0, :59]), **TOL)


def test_cpu_tensors_take_the_plain_versions():
    """A wrapper given CPU tensors runs its plain version and launches
    nothing."""
    q, ck, cv, pt, lengths = _decode_setup(seed=2)
    before = tdec.paged_decode_attention_cuda.launches
    got = tdec.paged_decode_attention_cuda(_t(q), _t(ck), _t(cv), _t(pt),
                                           _t(lengths), BIG, scale=0.3)
    want = tdec.paged_decode_attention_plain(_t(q), _t(ck), _t(cv), _t(pt),
                                             _t(lengths), BIG, scale=0.3)
    assert torch.equal(got, want)
    qp, kp, vp = _prefill_setup(B=1)
    segs, poss = _packed_layout(64, (30, 34))
    out = tflash.flash_prefill_packed_cuda(_t(qp), _t(kp), _t(vp), _t(segs),
                                           _t(poss), BIG, scale=0.2)
    assert torch.equal(out, tflash.flash_prefill_packed_plain(
        _t(qp), _t(kp), _t(vp), _t(segs), _t(poss), BIG, scale=0.2))
    out = tflash.flash_prefill_attention_cuda(_t(qp), _t(kp), _t(vp),
                                              torch.tensor([64], dtype=torch.int32),
                                              BIG, scale=0.2)
    assert out.shape == qp.shape
    assert tdec.paged_decode_attention_cuda.launches == before


def test_plain_versions_agree_with_reference_attention():
    """The kernel contract (q pre-scaled in q's dtype, unnormalised P)
    and the reference functions are one function in fp32."""
    q, k, v = _prefill_setup(seed=4)
    tl = np.array([64, 41], np.int32)
    a = tflash.flash_prefill_attention_plain(_t(q), _t(k), _t(v), _t(tl), BIG,
                                             scale=0.17)
    b = tattn.prefill_attention(_t(q), _t(k), _t(v), scale=0.17, true_len=_t(tl))
    for i, n in enumerate(tl):
        np.testing.assert_allclose(a[i, :n].numpy(), b[i, :n].numpy(), **TOL)


def test_decode_plain_zero_length_row_is_zero():
    """A row of length 0 (an inactive engine row) attends over nothing
    and comes out zero, as the kernel's does; other rows are unchanged."""
    q, ck, cv, pt, lengths = _decode_setup(seed=3)
    zeroed = lengths.copy()
    zeroed[0] = 0
    got = tdec.paged_decode_attention_plain(_t(q), _t(ck), _t(cv), _t(pt),
                                            _t(zeroed), BIG, scale=0.3)
    want = tdec.paged_decode_attention_plain(_t(q), _t(ck), _t(cv), _t(pt),
                                             _t(lengths), BIG, scale=0.3)
    assert torch.count_nonzero(got[0]) == 0
    np.testing.assert_allclose(got[1:].numpy(), want[1:].numpy(), **TOL)
