"""The launch plan of the paged decode kernel (K1/K1q), on the CPU.

``decode_plan`` and ``decode_split`` (``kaito_tpu_torch.engine.ops.
decode_attention``) mirror ``dec_n_split`` and ``dec_split`` of
``csrc/decode_attention.cu``: the grid's splits per (sequence, head
block), and the token range each CTA finds on the device from the
sequence's length and the window.  Hypothesis holds them, over batches,
KV heads, groups, page sizes 16/32/64, lengths with zeros, windows and SM
counts, to the properties the kernel relies on: every live token of the
window falls in exactly one split, every split starts on a page edge and
a 16-token edge, none runs past the length, neither the grid nor the
scratch depends on the page table's width, and the per-card workspace
(``workspace_bounds``) holds every plan's scratch and counters.

A plain loop that walks the plan with the kernel's arithmetic (per split,
four warps each taking every fourth 16-token slice with its own fp32
online softmax, the warps merged, then the splits merged in split order)
is held against the Pallas kernel in interpret mode on fp32 inputs:
rtol/atol 2e-5, as ``tests/test_torch_attention.py`` holds the
plain version (the same sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from kaito_tpu.engine.ops.decode_attention import paged_decode_attention_pallas
from kaito_tpu_torch.engine.ops import decode_attention as tdec
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

BIG = 1 << 30
NEG_INF = tdec.NEG_INF
WARPS = 4


def _live_splits(length, window, ps, n_split):
    ranges = [tdec.decode_split(length, window, ps, n_split, s) for s in range(n_split)]
    n_live = ranges[0][3]
    assert all(r[3] == n_live for r in ranges)
    return ranges[0][0], [(t0, t1) for _, t0, t1, _ in ranges[:n_live]], ranges[n_live:]


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 64), Hkv=st.sampled_from([1, 2, 4, 8]),
       G=st.sampled_from([1, 2, 4, 7, 8, 16]), D=st.sampled_from([32, 64, 128]),
       sms=st.sampled_from([1, 8, 78, 114, 132]))
def test_plan_depends_on_batch_heads_and_card_only(B, Hkv, G, D, sms):
    H = Hkv * G
    plan = tdec.decode_plan(B, H, Hkv, D, sms)
    assert 1 <= plan.n_split <= tdec.MAX_SPLIT
    assert plan.head_blocks * tdec.HEADS_PER_CTA >= G > (plan.head_blocks - 1) * 8
    pairs = B * Hkv * plan.head_blocks
    assert plan.ctas == pairs * plan.n_split and plan.counters == pairs
    # about CTAS_PER_SM CTAs an SM: the fewest splits that reach it, unless
    # capped
    target = tdec.CTAS_PER_SM * sms
    assert plan.ctas >= target or plan.n_split == tdec.MAX_SPLIT
    assert plan.n_split == 1 or pairs * (plan.n_split - 1) < target
    # every (sequence, head, split) partial has its row of the scratch
    if plan.n_split > 1:
        assert plan.scratch_floats == B * H * plan.n_split * (D + 2)
    else:
        assert plan.scratch_floats == 0


@settings(max_examples=300, deadline=None)
@given(B=st.one_of(st.integers(1, 64), st.integers(65, 4096)),
       Hkv=st.sampled_from([1, 2, 4, 8]), G=st.sampled_from([1, 2, 4, 7, 8, 16]),
       D=st.sampled_from([32, 64, 128]), sms=st.sampled_from([1, 8, 78, 114, 132]))
def test_workspace_bounds_cover_every_plan(B, Hkv, G, D, sms):
    """The per-card workspace is sized once by ``workspace_bounds`` and
    never replaced (a captured graph keeps its pointers): every plan with
    a merge fits in it, at any batch."""
    plan = tdec.decode_plan(B, Hkv * G, Hkv, D, sms)
    floats, counters = tdec.workspace_bounds(sms)
    if plan.n_split > 1:
        assert plan.scratch_floats <= floats and plan.counters <= counters


@settings(max_examples=400, deadline=None)
@given(lengths=st.lists(st.one_of(st.just(0), st.integers(1, 4096)), min_size=1,
                        max_size=8),
       window=st.one_of(st.just(BIG), st.integers(1, 3000)),
       ps=st.sampled_from([16, 32, 64]), sms=st.sampled_from([1, 8, 132]),
       Hkv=st.sampled_from([1, 8]))
def test_splits_cover_the_window_once_on_page_edges(lengths, window, ps, sms, Hkv):
    B, G, D = len(lengths), 4, 128
    # the page table's width enters neither the plan nor the ranges (they
    # take none), and no split reads a column past the longest sequence's
    # last page: any table at least that wide gives the same reads
    need = max(-(-n // ps) for n in lengths)
    n_split = tdec.decode_plan(B, Hkv * G, Hkv, D, sms).n_split
    for length in lengths:
        lo, live, idle = _live_splits(length, window, ps, n_split)
        assert lo == max(0, length - window)
        covered = np.zeros(max(length, 1), np.int32)
        for t0, t1 in live:
            assert t0 % ps == 0 and t0 % tdec.SLICE == 0, (t0, ps)
            assert t0 < t1 <= length
            assert (t1 - 1) // ps < need
            covered[t0:t1] += 1
        # every token of the window exactly once, nothing a page or more
        # before it
        assert (covered[lo:length] == 1).all()
        if live:
            assert live[0][0] <= lo < live[0][0] + max(ps, tdec.SLICE)
            assert all(a[1] == b[0] for a, b in zip(live, live[1:]))
            assert live[-1][1] == length
            # no split shorter than one page, but the last
            assert all(t1 - t0 >= ps for t0, t1 in live[:-1])
        else:
            assert length == 0
        # the splits past n_live start at or past the end: they exit
        assert all(t0 >= length for _, t0, _, _ in idle)


# ---------------------------------------------------------------------------
# the plan walked in plain PyTorch against the Pallas kernel
# ---------------------------------------------------------------------------

def _warp_state(qs, k, v, pos, lo, sk=None, sv=None, softcap=None):
    """One warp's online softmax over its slices: (m, l, acc) per head."""
    G, D = qs.shape
    m = torch.full((G,), NEG_INF)
    l = torch.zeros(G)
    acc = torch.zeros(G, D)
    for i in range(0, len(pos), tdec.SLICE):
        sl = slice(i, i + tdec.SLICE)
        s = qs @ k[sl].T
        if sk is not None:
            s = s * sk[sl]
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        valid = pos[sl] >= lo
        s = torch.where(valid, s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None]) * valid
        l = l * alpha + p.sum(dim=1)
        if sv is not None:
            p = p * sv[sl]
        acc = acc * alpha[:, None] + p @ v[sl]
        m = m_new
    return m, l, acc


def _merge(states):
    M = torch.stack([m for m, _, _ in states]).amax(dim=0)
    L = sum(l * torch.exp(m - M) for m, l, _ in states)
    A = sum(a * torch.exp(m - M)[:, None] for m, _, a in states)
    return M, L, A


def _planned_loop(q, ck, cv, pt, lengths, window, scale, softcap, sms,
                  k_scale=None, v_scale=None):
    B, H, D = q.shape
    _, ps, Hkv, _ = ck.shape
    G = H // Hkv
    n_split = tdec.decode_plan(B, H, Hkv, D, sms).n_split
    out = torch.zeros(B, H, D)
    for b in range(B):
        lo, live, _ = _live_splits(int(lengths[b]), window, ps, n_split)
        for h in range(Hkv):
            qs = q[b, h * G:(h + 1) * G] * scale
            splits = []
            for t0, t1 in live:
                warps = []
                for w in range(WARPS):
                    pos = torch.tensor([p for c in range(t0 + tdec.SLICE * w, t1,
                                                         WARPS * tdec.SLICE)
                                        for p in range(c, min(c + tdec.SLICE, t1))],
                                       dtype=torch.long)
                    pages = pt[b, pos // ps].long()
                    k, v = ck[pages, pos % ps, h], cv[pages, pos % ps, h]
                    sk = sv = None
                    if k_scale is not None:
                        sk, sv = k_scale[pages, h], v_scale[pages, h]
                    warps.append(_warp_state(qs, k.float(), v.float(), pos, lo, sk, sv,
                                             softcap))
                splits.append(_merge(warps))
            if splits:
                _, L, A = _merge(splits)
                out[b, h * G:(h + 1) * G] = A / L.clamp_min(1e-30)[:, None]
    return out


def _case(seed, B, Hkv, G, D, ps, pmax, P, lengths, quant):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Hkv * G, D).astype(np.float32)
    if quant:
        ck = rng.randint(-127, 128, size=(P, ps, Hkv, D)).astype(np.int8)
        cv = rng.randint(-127, 128, size=(P, ps, Hkv, D)).astype(np.int8)
        ks = (rng.rand(P, Hkv) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.rand(P, Hkv) * 0.02 + 0.001).astype(np.float32)
    else:
        ck = rng.randn(P, ps, Hkv, D).astype(np.float32)
        cv = rng.randn(P, ps, Hkv, D).astype(np.float32)
        ks = vs = None
    pt = np.stack([rng.permutation(np.arange(1, P))[:pmax] for _ in range(B)]
                  ).astype(np.int32)
    return q, ck, cv, ks, vs, pt, np.array(lengths, np.int32)


# (Hkv, G, D, ps, lengths, window, softcap, quant, sms): sms small, so that
# the plan cuts each sequence into several splits, as a full card does at
# full batch
CASES = [
    (2, 2, 32, 16, [130, 1, 77], BIG, None, False, 4),
    (2, 4, 64, 16, [200, 33, 16], 40, None, False, 8),
    (1, 8, 32, 32, [191, 64, 5], BIG, 30.0, False, 3),
    (2, 2, 64, 16, [150, 17, 96], 23, None, True, 6),
    (2, 4, 32, 16, [256, 2, 100], BIG, 30.0, True, 12),
]


@pytest.mark.parametrize("Hkv,G,D,ps,lengths,window,softcap,quant,sms", CASES)
def test_planned_loop_matches_pallas(Hkv, G, D, ps, lengths, window, softcap, quant,
                                     sms):
    B, pmax, P = len(lengths), 16, 60
    q, ck, cv, ks, vs, pt, ln = _case(len(lengths) + D + ps, B, Hkv, G, D, ps, pmax, P,
                                      lengths, quant)
    assert tdec.decode_plan(B, Hkv * G, Hkv, D, sms).n_split > 1
    scale = D ** -0.5
    kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)) if quant else {}
    want = np.asarray(paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pt),
        jnp.asarray(ln), jnp.asarray(min(window, 2**31 - 1), jnp.int32), scale=scale,
        softcap=softcap, interpret=True, **kw))
    t = torch.from_numpy
    got = _planned_loop(t(q), t(ck), t(cv), t(pt), t(ln), window, scale, softcap, sms,
                        *((t(ks), t(vs)) if quant else ()))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_planned_loop_leaves_idle_rows_zero():
    """A row of length 0 has no live split and comes out zero, as the
    plain version has it."""
    q, ck, cv, _, _, pt, ln = _case(3, 3, 2, 2, 32, 16, 8, 30, [0, 70, 0], False)
    t = torch.from_numpy
    got = _planned_loop(t(q), t(ck), t(cv), t(pt), t(ln), BIG, 0.2, None, 2)
    want = tdec.paged_decode_attention_plain(t(q), t(ck), t(cv), t(pt), t(ln), BIG,
                                             scale=0.2)
    assert not got[0].any() and not got[2].any()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
