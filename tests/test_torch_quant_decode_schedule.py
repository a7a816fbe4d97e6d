"""The launch plan of the quantized matmul's decode-row path, on the CPU.

``decode_plan`` (``kaito_tpu_torch.engine.ops.quant_matmul``) is the rule
``csrc/quant_matmul.cu`` mirrors for bf16 calls of 1-16 rows: the n8 tiles
of rows, one CTA per 128-column tile and K slice, and how K is split for
a card of a given SM count.  Hypothesis holds it, over rows 1-16, the
Llama-3.1-8B projections, their TP=2 shards and ring chunks (the
``SHAPES`` of ``tests/test_torch_quant_schedule.py``), int8 and int4
(groups of 128 and of the whole K) and several SM counts, to the
properties the kernel relies on: every output owned exactly once per
slice, slices of whole stages (int4: whole groups) that are contiguous
and cover K, one wave of CTAs, and a per-card workspace
(``decode_workspace_bounds``) that holds every split call's partials and
merge counters.  A plain loop that walks the plan with the kernel's
arithmetic (the products of each stage summed in fp32, int4 scales
folded per group, int8 scales once per slice, the slices' partials summed
in slice order, one cast) is held against the Pallas kernel in interpret
mode (fp32 x; rtol 2e-5, atol 1e-4, as ``test_planned_loop_matches_pallas``
of the wide path: the same sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from kaito_tpu.engine import quant as jq
from kaito_tpu.engine.ops import quant_matmul as jqm
from kaito_tpu_torch.engine.ops import quant_matmul as tqm
from kaito_tpu_torch.engine.quant import unpack_int4
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_quant_schedule import SHAPES

SMS = [132, 114, 78, 8, 1]


def _groups(K, int4, whole_k):
    return 1 if not int4 or whole_k else K // jq.INT4_GROUP


def _slices(plan, K):
    return [(s * plan.kc, min(K, (s + 1) * plan.kc)) for s in range(plan.n_split)]


@settings(max_examples=400, deadline=None)
@given(rows=st.integers(1, 16), shape=st.sampled_from(SHAPES),
       scheme=st.sampled_from(["int8", "int4", "int4 whole-K"]),
       sms=st.sampled_from(SMS))
def test_decode_plan_covers_every_output_once(rows, shape, scheme, sms):
    K, N = shape
    int4 = scheme != "int8"
    groups = _groups(K, int4, scheme == "int4 whole-K")
    gk = K // groups
    plan = tqm.decode_plan(rows, K, N, groups, int4, sms)
    assert tqm.decode_fits(K, N, gk, int4)
    # rows: one n8 tile up to 8, two up to 16
    assert plan.nt == (1 if rows <= 8 else 2) and 8 * plan.nt >= rows
    # the grid, (N // DECODE_TN column tiles) x (n_split K slices), CTA
    # (tile, s) reading in-rows [s kc, min(K, (s + 1) kc)) of its tile's
    # columns: every column in one tile, every in-row in one slice, so
    # every output is owned by exactly one CTA of each slice
    tiles = N // tqm.DECODE_TN
    assert tiles * tqm.DECODE_TN == N
    reads = np.zeros(K, np.int32)
    for s in range(plan.n_split):
        reads[s * plan.kc:min(K, (s + 1) * plan.kc)] += 1
    assert (reads == 1).all()
    # K slices: whole stages (int4: whole groups), contiguous, none empty,
    # covering K; all but the last hold at least 2 stages when K is split,
    # DECODE_MIN_STAGES where more than one CTA an SM runs
    ks = tqm.decode_stage(int4)
    assert plan.kc % ks == 0 and (not int4 or plan.kc % gk == 0)
    bounds = _slices(plan, K)
    assert bounds[0][0] == 0 and bounds[-1][1] == K
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all((hi - lo) % (gk if int4 else ks) == 0 for lo, hi in bounds)
    if plan.n_split > 1:
        assert plan.kc >= 2 * ks
        if tiles * plan.n_split > sms:
            assert plan.kc >= tqm.DECODE_MIN_STAGES * ks
    # one wave: at most one CTA an SM, or DECODE_CTAS_PER_SM (one fewer
    # for two n8 tiles), and no split where the tiles fill that wave
    slots = (tqm.DECODE_CTAS_PER_SM - (plan.nt - 1)) * sms
    if tiles >= slots:
        assert plan.n_split == 1
    assert plan.n_split == 1 or tiles * plan.n_split <= max(slots, sms)
    # the card's workspace holds a split call's partials and counters
    floats, counters = tqm.decode_workspace_bounds(sms)
    if plan.n_split > 1:
        assert plan.n_split * rows * N <= floats
        assert N // 32 <= counters


@settings(max_examples=300, deadline=None)
@given(rows=st.integers(1, 16), K=st.integers(1, 256).map(lambda u: 128 * u),
       N=st.integers(1, 1024).map(lambda u: 128 * u), int4=st.booleans(),
       sms=st.sampled_from(SMS))
def test_decode_workspace_bounds_cover_every_plan(rows, K, N, int4, sms):
    """The per-card workspace is sized once by ``decode_workspace_bounds``
    and never replaced (a captured graph keeps its pointers): every split
    plan fits in it, at any K and N on the tensor-core shapes."""
    groups = K // 128 if int4 and K % 128 == 0 else 1
    plan = tqm.decode_plan(rows, K, N, groups, int4, sms)
    floats, counters = tqm.decode_workspace_bounds(sms)
    if plan.n_split > 1:
        assert plan.n_split * rows * N <= floats and N // 32 <= counters


def test_decode_rows_take_the_decode_path():
    """bf16 calls of 1-16 rows on the decode-row shapes take the
    decode-row path, and only they: not 17 rows, fp32 x, shapes off the
    tiles, nor int4 whose K or groups are not whole 128-row stages; and
    the wide path's per-call workspace does not count them."""
    w = {"q8": torch.zeros(512, 256, dtype=torch.int8), "scale": torch.ones(256)}
    for rows in (1, 8, 16):
        x = torch.zeros(rows, 512, dtype=torch.bfloat16)
        assert tqm.takes_decode(x, w["q8"], w["scale"], 1, False)
        assert not tqm.takes_wide(x, w["q8"], w["scale"], 1)
    assert not tqm.takes_decode(torch.zeros(17, 512, dtype=torch.bfloat16), w["q8"],
                                w["scale"], 1, False)
    assert not tqm.takes_decode(torch.zeros(8, 512), w["q8"], w["scale"], 1, False)
    assert not tqm.takes_decode(torch.zeros(8, 500, dtype=torch.bfloat16),
                                w["q8"][:500], w["scale"], 1, False)
    q4 = torch.zeros(96, 256, dtype=torch.int8)   # K = 192: int8 fits, int4 does not
    x = torch.zeros(8, 192, dtype=torch.bfloat16)
    assert tqm.takes_decode(x, torch.zeros(192, 256, dtype=torch.int8), w["scale"], 1,
                            False)
    assert not tqm.takes_decode(x, q4, torch.ones(1, 256), 1, True)
    assert not tqm.takes_decode(torch.zeros(8, 512, dtype=torch.bfloat16),
                                torch.zeros(256, 256, dtype=torch.int8), torch.ones(8, 256),
                                8, True)
    # the CUDA-core fallback's split is all a decode-row call's own
    # workspace has to hold
    assert tqm.workspace_floats(8, 4096, 1024, 1, False, True) == \
        tqm.workspace_floats(8, 4096, 1024, 1, False, False)


def _planned_loop(x: torch.Tensor, w: dict, sms: int) -> torch.Tensor:
    """x [rows, K] @ w walked CTA by CTA and stage by stage as the
    decode-row path's plan runs it, in fp32."""
    rows, K = x.shape
    int4 = "q4" in w
    q = (unpack_int4(w["q4"]) if int4 else w["q8"]).float()
    N = q.shape[1]
    scale = w["scale"].reshape(-1, N)
    groups = scale.shape[0]
    gk = K // groups
    plan = tqm.decode_plan(rows, K, N, groups, int4, sms)
    parts = torch.zeros(plan.n_split, rows, N)
    for tile in range(N // tqm.DECODE_TN):
        cols = slice(tile * tqm.DECODE_TN, (tile + 1) * tqm.DECODE_TN)
        for s, (k_lo, k_hi) in enumerate(_slices(plan, K)):
            acc = torch.zeros(rows, tqm.DECODE_TN)
            part = torch.zeros_like(acc)
            ks = tqm.decode_stage(int4)
            for k0 in range(k_lo, k_hi, ks):
                part += x[:, k0:k0 + ks] @ q[k0:k0 + ks, cols]
                if int4 and ((k0 + ks) % gk == 0 or k0 + ks == k_hi):
                    acc += part * scale[k0 // gk, cols]
                    part.zero_()
            parts[s, :, cols] = acc if int4 else part * scale[0, cols]
    out = torch.zeros(rows, N)
    for s in range(plan.n_split):   # the merge, in slice order
        out += parts[s]
    return out


@pytest.mark.parametrize("scheme", ["int8", "int4", "int4 whole-K"])
@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("K,N,sms", [(1024, 256, 132), (2048, 128, 132), (384, 384, 1)])
def test_planned_loop_matches_pallas(scheme, rows, K, N, sms):
    """Split and unsplit plans (K 1024 and 2048 cut into 2 and 4 slices
    for int8 and int4 groups of 128, one whole-K group unsplit; one card
    slot per column tile, unsplit), against the Pallas kernel in
    interpret mode."""
    rng = np.random.RandomState(rows + K + N)
    x = rng.randn(rows, K).astype(np.float32)
    if scheme == "int4 whole-K":   # the quantizer makes one only where K % 128 != 0
        qt = {"q4": rng.randint(-128, 128, (K // 2, N)).astype(np.int8),
              "scale": (rng.rand(1, N) / 64).astype(np.float32)}
    else:
        fn = jax.jit(lambda a: jq.quantize_weight(a, scheme))
        qt = jax.tree.map(np.array, fn(jnp.asarray(rng.randn(K, N).astype(np.float32))))
    w = {k: torch.from_numpy(v) for k, v in qt.items()}
    groups = w["scale"].reshape(-1, N).shape[0]
    int4 = scheme != "int8"
    assert tqm.decode_fits(K, N, K // groups, int4)
    plan = tqm.decode_plan(rows, K, N, groups, int4, sms)
    assert (plan.n_split > 1) == (scheme != "int4 whole-K" and sms > 1)
    got = _planned_loop(torch.from_numpy(x), w, sms)
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), jax.tree.map(jnp.asarray, qt),
                                       interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-4)
