"""The tile schedule of the bf16 flash prefill kernels, on the CPU.

``key_tile_range`` and ``tile_fully_visible``
(``kaito_tpu_torch.engine.ops.flash_prefill``) are the rule the CUDA
kernels mirror: which key tiles a query tile visits, and on which it
skips the per-element mask.  A property test holds both against the
dense masks of the plain versions; a parametrised test runs an online
softmax in plain PyTorch that visits only those tiles, masking only
the tiles the rule says cut the mask, against the Pallas kernels in
interpret mode (fp32 atol 1e-5: the same arithmetic in another
summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from kaito_tpu.engine.ops.flash_prefill import (flash_prefill_attention,
                                                flash_prefill_packed)
from kaito_tpu_torch.engine.ops import flash_prefill as tflash
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

BIG = 1 << 30
NEG_INF = -1e30


@st.composite
def _segments(draw, T):
    """Contiguous ordered segments of 1..T tokens (many of one token,
    some crossing tiles), pads (-1) after them; within-segment
    positions."""
    segs = np.full(T, -1, np.int32)
    poss = np.zeros(T, np.int32)
    off, sid = 0, 0
    while off < T and draw(st.integers(0, 9)) > 0:
        n = draw(st.one_of(st.integers(1, 3), st.integers(1, T)))
        n = min(n, T - off)
        segs[off:off + n] = sid
        poss[off:off + n] = np.arange(n)
        off, sid = off + n, sid + 1
    return segs, poss


_windows = st.one_of(st.just(1), st.integers(2, 15), st.integers(16, 80),
                     st.just(BIG))


def _check_schedule(mode, mask, T, bq, bk, **kw):
    """Every visible (query, key) pair lies inside its query tile's key
    range, and every tile the rule calls fully visible is."""
    range_kw = {n: x for n, x in kw.items() if n != "positions"}
    for q_start in range(0, T, bq):
        first, last = tflash.key_tile_range(mode, q_start, bq, bk, T, **range_kw)
        rows = mask[q_start:q_start + bq]
        for qi, ki in zip(*np.nonzero(rows)):
            assert first <= ki // bk <= last, (q_start + qi, ki, first, last)
        for k_start in range(0, T, bk):
            if tflash.tile_fully_visible(mode, q_start, k_start, bq, bk, T, **kw):
                assert rows[:, k_start:k_start + bk].all(), (q_start, k_start)
                assert first <= k_start // bk <= last


@settings(max_examples=150, deadline=None)
@given(data=st.data(), T=st.integers(1, 150), blocks=st.sampled_from(
    [(tflash.BLOCK_Q, tflash.BLOCK_K), (16, 16), (16, 32), (32, 16)]), window=_windows)
def test_fresh_tile_range_covers_every_visible_pair(data, T, blocks, window):
    true_len = data.draw(st.integers(0, T))
    mask = tflash.fresh_mask(T, torch.tensor([true_len]), window)[0].numpy()
    _check_schedule("fresh", mask, T, *blocks, true_len=true_len, window=window)


@settings(max_examples=150, deadline=None)
@given(data=st.data(), T=st.integers(1, 150), blocks=st.sampled_from(
    [(tflash.BLOCK_Q, tflash.BLOCK_K), (16, 16), (16, 32), (32, 16)]), window=_windows)
def test_packed_tile_range_covers_every_visible_pair(data, T, blocks, window):
    segs, poss = data.draw(_segments(T))
    mask = tflash.packed_mask(torch.from_numpy(segs)[None],
                              torch.from_numpy(poss)[None], window)[0].numpy()
    _check_schedule("packed", mask, T, *blocks, window=window, seg_ids=segs,
                    positions=poss)


def test_pad_only_tile_visits_nothing():
    segs = np.array([0] * 20 + [-1] * 44, np.int32)
    assert tflash.key_tile_range("packed", 32, 16, 16, 64, seg_ids=segs) == (0, -1)
    assert tflash.key_tile_range("packed", 16, 16, 16, 64, seg_ids=segs) == (0, 1)
    # a window of one token: the last tile of a fresh chunk visits only its own
    assert tflash.key_tile_range("fresh", 48, 16, 16, 64, true_len=64,
                                 window=1) == (3, 3)


def _scheduled_flash(q, k, v, mode, bq, bk, scale, softcap=None, true_len=None,
                     window=BIG, seg_ids=None, positions=None):
    """Online softmax over the scheduled key tiles only, in fp32, with the
    kernels' arithmetic (q pre-scaled, NEG_INF masking, P rounded to the
    input dtype, output over max(l, 1e-30))."""
    B, T, H, D = q.shape
    G = H // k.shape[2]
    qs = (q * scale).to(q.dtype).float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    out = torch.zeros(B, T, H, D)
    for b in range(B):
        if mode == "fresh":
            mask = tflash.fresh_mask(T, true_len[b:b + 1], window)[0]
            kw = dict(true_len=int(true_len[b]), window=window)
        else:
            mask = tflash.packed_mask(seg_ids[b:b + 1], positions[b:b + 1],
                                      window)[0]
            kw = dict(window=window, seg_ids=seg_ids[b].numpy(),
                      positions=positions[b].numpy())
        range_kw = {n: x for n, x in kw.items() if n != "positions"}
        for q0 in range(0, T, bq):
            first, last = tflash.key_tile_range(mode, q0, bq, bk, T, **range_kw)
            qt = qs[b, q0:q0 + bq].transpose(0, 1)                 # [H, bq, D]
            m = torch.full((H, qt.shape[1], 1), NEG_INF)
            l = torch.zeros(H, qt.shape[1], 1)
            acc = torch.zeros(H, qt.shape[1], D)
            for kt in range(first, last + 1):
                k0 = kt * bk
                s = qt @ kf[b, k0:k0 + bk].permute(1, 2, 0)        # [H, bq, bk]
                if softcap:
                    s = torch.tanh(s / softcap) * softcap
                if not tflash.tile_fully_visible(mode, q0, k0, bq, bk, T, **kw):
                    s = torch.where(mask[q0:q0 + bq, k0:k0 + bk], s, NEG_INF)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                pv = p.to(v.dtype).float() @ vf[b, k0:k0 + bk].transpose(0, 1)
                acc = acc * alpha + pv
                m = m_new
            out[b, q0:q0 + bq] = (acc / l.clamp_min(1e-30)).transpose(0, 1)
    return out.to(q.dtype)


def _inputs(B, T, Hkv, G, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, Hkv * G, D).astype(np.float32),
            rng.randn(B, T, Hkv, D).astype(np.float32),
            rng.randn(B, T, Hkv, D).astype(np.float32))


@pytest.mark.parametrize("true_lens,window,softcap", [
    ((64, 37), BIG, None), ((64, 64), 1, None), ((50, 64), 9, None),
    ((64, 20), 40, 25.0), ((0, 64), BIG, None)])
def test_scheduled_fresh_loop_matches_pallas(true_lens, window, softcap):
    q, k, v = _inputs(2, 64, 2, 2, 32, seed=len(true_lens) + window % 97)
    tl = np.asarray(true_lens, np.int32)
    want = flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tl),
        jnp.asarray(min(window, 2**31 - 1), jnp.int32), scale=0.17,
        softcap=softcap, block_q=16, block_k=16, interpret=True)
    got = _scheduled_flash(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), "fresh", 16, 16, 0.17, softcap,
                           true_len=torch.from_numpy(tl), window=window)
    for b, n in enumerate(tl):
        np.testing.assert_allclose(got[b, :n].numpy(), np.asarray(want[b, :n]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("seg_lens,window,softcap", [
    ((20, 30, 9), BIG, None),                      # pads at the end
    ((1, 2, 3, 1, 1, 2, 40, 3, 1), BIG, None),     # short segments, one over 3 tiles
    ((1,) * 64, BIG, None),                        # every token its own segment
    ((17, 33, 14), 5, 30.0),
    ((64,), 16, None)])
def test_scheduled_packed_loop_matches_pallas(seg_lens, window, softcap):
    T = 64
    q, k, v = _inputs(1, T, 2, 2, 32, seed=len(seg_lens))
    segs = np.full((1, T), -1, np.int32)
    poss = np.zeros((1, T), np.int32)
    off = 0
    for si, n in enumerate(seg_lens):
        segs[0, off:off + n] = si
        poss[0, off:off + n] = np.arange(n)
        off += n
    want = flash_prefill_packed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(segs),
        jnp.asarray(poss), jnp.asarray(min(window, 2**31 - 1), jnp.int32),
        scale=0.17, softcap=softcap, block_q=16, block_k=16, interpret=True)
    got = _scheduled_flash(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), "packed", 16, 16, 0.17, softcap,
                           window=window, seg_ids=torch.from_numpy(segs),
                           positions=torch.from_numpy(poss))
    np.testing.assert_allclose(got[0, :off].numpy(), np.asarray(want[0, :off]),
                               rtol=0, atol=1e-5)
