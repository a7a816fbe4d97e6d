"""The launch plan of the quantized matmul's wide path, on the CPU.

``wide_plan`` (``kaito_tpu_torch.engine.ops.quant_matmul``) is the rule
``csrc/quant_matmul.cu`` mirrors for bf16 calls of 17-256 rows: the rows a
CTA holds, the CTAs of a 128-column tile, and how K is split.  Hypothesis
holds it, over rows 17-256, the Llama-3.1-8B projections, their TP=2
shards and ring chunks, int8 and int4 (groups of 128 and of the whole K),
to the properties the kernel relies on.  A plain loop that walks the plan
with the kernel's arithmetic (the products of each stage summed in fp32,
int4 scales folded per group, int8 scales once per K slice, the slices'
partials summed in order, one cast) is held against the Pallas kernel in
interpret mode (fp32 x; rtol 2e-5, atol 1e-4: the same sums of up to 1024
products in another order, on outputs of magnitude ~20-30).
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

# [K, N]: the projections of Llama-3.1-8B (q/o, k/v, gate/up, down), their
# TP=2 column shards (q, k/v, gate/up) and row shards (o, down), and the
# ring's column chunks of those row shards
SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
          (4096, 2048), (4096, 512), (4096, 7168), (2048, 4096), (7168, 4096),
          (2048, 2048), (7168, 2048)]


def _groups(K, int4, whole_k):
    return 1 if not int4 or whole_k else K // jq.INT4_GROUP


def _ctas(plan, N):
    """(column tile, row block, K slice) of every CTA of the grid."""
    return [(bx // plan.row_blocks, bx % plan.row_blocks, s)
            for bx in range(N // tqm.WIDE_TN * plan.row_blocks)
            for s in range(plan.n_split)]


@settings(max_examples=300, deadline=None)
@given(rows=st.integers(17, 256), shape=st.sampled_from(SHAPES),
       scheme=st.sampled_from(["int8", "int4", "int4 whole-K"]))
def test_wide_plan_covers_every_output_once(rows, shape, scheme):
    K, N = shape
    int4 = scheme != "int8"
    groups = _groups(K, int4, scheme == "int4 whole-K")
    gk = K // groups
    plan = tqm.wide_plan(rows, K, N, groups, int4)
    assert tqm.tc_fits(K, N, gk)
    # rows: 64, 128 or 256 a CTA (int4 at most 128); every row of every
    # column tile owned by exactly one CTA of each K slice, none empty
    assert plan.nt in (64, 128, 256) and not (int4 and plan.nt > 128)
    owners = np.zeros((plan.n_split, N // tqm.WIDE_TN, rows), np.int32)
    for tile, rb, s in _ctas(plan, N):
        lo, hi = rb * plan.nt, min(rows, (rb + 1) * plan.nt)
        assert lo < hi, (tile, rb)
        owners[s, tile, lo:hi] += 1
    assert (owners == 1).all()
    # K slices: whole stages (int4: whole groups, few enough to stage
    # their scale rows), contiguous, none empty, covering K
    assert plan.kc % tqm.STAGE == 0 and (not int4 or plan.kc % gk == 0)
    bounds = [(s * plan.kc, min(K, (s + 1) * plan.kc)) for s in range(plan.n_split)]
    assert bounds[0][0] == 0 and bounds[-1][1] == K
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    if int4:
        assert plan.kc // gk <= tqm.WIDE_SCALE_GROUPS
    # no split where the tiles alone fill the SMs; else one wave at most
    tiles = N // tqm.WIDE_TN * plan.row_blocks
    if tiles >= tqm.SMS:
        assert plan.n_split == 1
    else:
        slots = tqm.SMS * (2 if plan.nt <= (64 if int4 else 128) else 1)
        assert plan.n_split == 1 or tiles * plan.n_split <= slots
    # the workspace the wrapper allocates holds the split's partials
    need = plan.n_split * rows * N if plan.n_split > 1 else 0
    assert need <= tqm.workspace_floats(rows, K, N, groups, int4, True)


def test_decode_and_long_calls_take_no_wide_plan():
    """Up to 16 rows (decode) and over 256 (the dequant route) stay off
    the wide path; so do fp32 x and shapes off the tensor-core tiles."""
    x = torch.zeros(16, 512, dtype=torch.bfloat16)
    w = {"q8": torch.zeros(512, 256, dtype=torch.int8), "scale": torch.ones(256)}
    assert not tqm.takes_wide(x, w["q8"], w["scale"], 1)
    assert tqm.takes_wide(torch.zeros(17, 512, dtype=torch.bfloat16), w["q8"],
                          w["scale"], 1)
    assert not tqm.takes_wide(torch.zeros(17, 512), w["q8"], w["scale"], 1)
    assert not tqm.takes_wide(torch.zeros(257, 512, dtype=torch.bfloat16), w["q8"],
                              w["scale"], 1)
    assert not tqm.takes_wide(torch.zeros(17, 500, dtype=torch.bfloat16),
                              w["q8"][:500], w["scale"], 1)


def _planned_loop(x: torch.Tensor, w: dict) -> torch.Tensor:
    """x [rows, K] @ w walked CTA by CTA and stage by stage as the wide
    path's plan runs it, in fp32."""
    rows, K = x.shape
    int4 = "q4" in w
    q = (unpack_int4(w["q4"]) if int4 else w["q8"]).float()
    N = q.shape[1]
    scale = w["scale"].reshape(-1, N)
    groups = scale.shape[0]
    gk = K // groups
    plan = tqm.wide_plan(rows, K, N, groups, int4)
    parts = torch.zeros(plan.n_split, rows, N)
    for tile, rb, s in _ctas(plan, N):
        cols = slice(tile * tqm.WIDE_TN, (tile + 1) * tqm.WIDE_TN)
        r = slice(rb * plan.nt, min(rows, (rb + 1) * plan.nt))
        k_lo, k_hi = s * plan.kc, min(K, (s + 1) * plan.kc)
        acc = torch.zeros(r.stop - r.start, tqm.WIDE_TN)
        part = torch.zeros_like(acc)
        for k0 in range(k_lo, k_hi, tqm.STAGE):
            part += x[r, k0:k0 + tqm.STAGE] @ q[k0:k0 + tqm.STAGE, cols]
            if int4 and (k0 + tqm.STAGE) % gk == 0 or k0 + tqm.STAGE == k_hi:
                acc += part * scale[k0 // gk, cols]
                part.zero_()
        parts[s, r, cols] = acc
    return parts.sum(dim=0)


@pytest.mark.parametrize("scheme", ["int8", "int4"])
@pytest.mark.parametrize("rows,K,N", [(64, 512, 256), (200, 512, 256), (256, 1024, 128),
                                      (17, 384, 384)])
def test_planned_loop_matches_pallas(scheme, rows, K, N):
    rng = np.random.RandomState(rows + K + N)
    x = rng.randn(rows, K).astype(np.float32)
    fn = jax.jit(lambda a: jq.quantize_weight(a, scheme))
    qt = jax.tree.map(np.array, fn(jnp.asarray(rng.randn(K, N).astype(np.float32))))
    got = _planned_loop(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in qt.items()})
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), jax.tree.map(jnp.asarray, qt),
                                       interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-4)
