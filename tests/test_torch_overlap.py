"""The port's tensor-parallel collectives and K6's plain path against the
JAX package.

- ``parallel.sharding``: ``ring_axis`` and ``spec`` give what
  ``kaito_tpu.parallel.sharding`` gives (a ``PartitionSpec`` there, a
  tuple here).
- ``overlap_linear``, ``psum_linear`` and ``all_gather_matmul`` on a
  CPU mesh of 2 and 4 slots against the JAX ring on the virtual CPU
  mesh (``cpu_devices``), for plain fp32 weights and for int8/int4
  QTensors with and without the next layer's slab as ``prefetch``, on
  the cases of ``tests/test_comm_overlap.py``.  Tolerance: fp32
  rtol/atol 2e-4, the JAX tests' own (the two sum in other orders).
- K6's plain path: ``quant_linear(..., prefetch=w_next)`` against the
  JAX ``quant_linear`` with the Pallas kernel in interpret mode, and
  bitwise equal to the port's own output without the prefetch;
  ``prefetch_ok`` drops what the JAX gate drops.

Inputs are numpy arrays from a seeded generator, handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from kaito_tpu.engine.ops import overlap_collectives as jov
from kaito_tpu.engine.ops.quant_matmul import quant_linear as j_quant_linear
from kaito_tpu.engine.quant import quantize_weight_int4 as j_int4
from kaito_tpu.engine.quant import quantize_weight_int8 as j_int8
from kaito_tpu.parallel import sharding as jsh
from kaito_tpu_torch.engine.ops import overlap_collectives as tov
from kaito_tpu_torch.engine.ops import quant_matmul as tqm
from kaito_tpu_torch.parallel import sharding as tsh
from kaito_tpu_torch.parallel.mesh import build_mesh
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=2e-4, atol=2e-4)


def _jmesh(n):
    return JaxMesh(np.array(jax.devices()[:n]), ("tensor",))


def _tmesh(n):
    return build_mesh(tensor=n, devices=["cpu"] * n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tq(w):
    """A JAX QTensor as the port's (same codes and scales)."""
    return {k: _t(v) for k, v in w.items()}


def _rows(w, n):
    """Row-parallel shards (contraction dim) of a plain weight or a
    QTensor: int8 scales replicated, int4 scale rows with their groups."""
    if isinstance(w, dict):
        out = [{} for _ in range(n)]
        for k, v in w.items():
            parts = v.chunk(n, dim=0) if (v.dim() == 2) else [v] * n
            for d in range(n):
                out[d][k] = parts[d]
        return out
    return list(w.chunk(n, dim=0))


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------


def test_ring_axis_matches_jax():
    assert tsh.ring_axis(tsh.SERVE_RULES) == jsh.ring_axis(jsh.SERVE_RULES) \
        == "tensor"
    for rules in ({}, {"heads": "tensor", "intermediate": "expert"},
                  {"heads": "tensor"}, {"heads": ("tensor", "data"),
                                        "intermediate": "tensor"}):
        assert tsh.ring_axis(tsh.PartitionRules(rules)) \
            == jsh.ring_axis(jsh.PartitionRules(rules)), rules


@pytest.mark.parametrize("axes", [
    ("layers", "embed", "heads"), ("layers", "heads", "embed"),
    ("vocab", "embed"), ("embed",), ("heads", "heads"), (None, "kv_heads"),
    ("batch", "seq", "embed"), ("expert", "embed", "intermediate"), ()])
def test_spec_matches_jax(axes):
    assert tsh.SERVE_RULES.spec(axes) == tuple(jsh.SERVE_RULES.spec(axes))
    rules = {"batch": ("data", "fsdp"), "embed": "fsdp", "heads": "tensor"}
    assert tsh.PartitionRules(rules).spec(axes) \
        == tuple(jsh.PartitionRules(rules).spec(axes))


# ---------------------------------------------------------------------------
# ring collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_overlap_and_psum_linear_match_jax(cpu_devices, n):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8 * n)).astype(np.float32)
    w = rng.standard_normal((8 * n, 12 * n)).astype(np.float32)
    want = np.asarray(jov.overlap_linear(jnp.asarray(x), jnp.asarray(w), _jmesh(n)))
    xs, ws = list(_t(x).chunk(n, dim=-1)), _rows(_t(w), n)
    for fn in (tov.overlap_linear, tov.psum_linear):
        outs = fn(xs, ws, _tmesh(n))
        assert len(outs) == n
        for out in outs:
            np.testing.assert_allclose(out.numpy(), want, **TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_all_gather_matmul_matches_jax(cpu_devices, n):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 32)).astype(np.float32)
    w = rng.standard_normal((32, 48)).astype(np.float32)
    want = np.asarray(jov.all_gather_matmul(jnp.asarray(x), jnp.asarray(w),
                                            _jmesh(n)))
    ws = list(_t(w).chunk(n, dim=-1))
    outs = tov.all_gather_matmul([_t(x)] * n, ws, _tmesh(n))
    np.testing.assert_allclose(torch.cat(outs, dim=-1).numpy(), want, **TOL)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("scheme", ["int8", "int4"])
@pytest.mark.parametrize("prefetch", [False, True])
def test_quantized_ring_matches_jax(cpu_devices, n, scheme, prefetch):
    """QTensors ride the ring (int4 groups of 128 along K, so each shard
    owns whole groups); with ``prefetch`` the next layer's slab rides the
    same chunks and changes nothing."""
    quantize = j_int8 if scheme == "int8" else j_int4
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 512)).astype(np.float32)
    w = quantize(jnp.asarray(rng.standard_normal((512, 64)), jnp.float32))
    w_next = quantize(jnp.asarray(rng.standard_normal((512, 64)), jnp.float32))
    mesh = _jmesh(n)
    want = np.asarray(jov.overlap_linear(jnp.asarray(x), w, mesh,
                                         prefetch=w_next if prefetch else None))
    xs = list(_t(x).chunk(n, dim=-1))
    pf = _rows(_tq(w_next), n) if prefetch else None
    outs = tov.overlap_linear(xs, _rows(_tq(w), n), _tmesh(n), prefetch=pf)
    for out in outs:
        np.testing.assert_allclose(out.numpy(), want, **TOL)
    plain = tov.psum_linear(xs, _rows(_tq(w), n), _tmesh(n))
    np.testing.assert_allclose(plain[0].numpy(), want, **TOL)


def test_ring_out_dim_not_divisible_raises():
    xs = [torch.ones(2, 4)] * 4
    ws = [torch.ones(4, 13)] * 4          # 13 % 4 != 0
    with pytest.raises(ValueError, match="divisible"):
        tov.overlap_linear(xs, ws, _tmesh(4))


def test_ag_matmul_eligible_gating():
    """On one shard's weight [K, N/n]: plain 2-D weights whose K matches
    x and divides by the ring; QTensors stay on the plain path."""
    x = torch.ones(2, 32)
    w = torch.ones(32, 12)
    assert tov.ag_matmul_eligible(x, w, 4)
    assert not tov.ag_matmul_eligible(x, w, 1)
    assert not tov.ag_matmul_eligible(x, {"q8": w}, 4)
    assert not tov.ag_matmul_eligible(x, torch.ones(30, 12), 4)
    assert not tov.ag_matmul_eligible(torch.ones(2, 30), torch.ones(30, 12), 4)
    assert not tov.ag_matmul_eligible(x, torch.ones(32), 4)


def test_ring_hops_visit_every_shard():
    """The chunk order c = (d - s - 1) mod n: each output column chunk
    sums every shard's partial exactly once."""
    n = 4
    xs = [torch.full((1, 1), float(10 ** d)) for d in range(n)]
    ws = [torch.ones(1, 8) for _ in range(n)]
    outs = tov.overlap_linear(xs, ws, _tmesh(n))
    for out in outs:
        assert torch.equal(out, torch.full((1, 8), 1111.0))


# ---------------------------------------------------------------------------
# K6: the layer-ahead prefetch changes nothing of the arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_k6_plain_path_matches_jax_interpret(monkeypatch, scheme):
    monkeypatch.setenv("KAITO_QUANT_MATMUL", "interpret")
    quantize = j_int8 if scheme == "int8" else j_int4
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    w = quantize(jnp.asarray(rng.standard_normal((256, 256)), jnp.float32))
    w_next = quantize(jnp.asarray(rng.standard_normal((256, 256)), jnp.float32))
    want = np.asarray(j_quant_linear(jnp.asarray(x), w, prefetch=w_next))
    got = tqm.quant_linear(_t(x), _tq(w), prefetch=_tq(w_next))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, tqm.quant_linear(_t(x), _tq(w)))
    # a column chunk of the planes (the ring's strided view) as well
    chunk = tov._slice_out(_tq(w), 128, 128)
    got = tqm.quant_linear(_t(x), chunk,
                           prefetch=tov._slice_out(_tq(w_next), 128, 128))
    np.testing.assert_allclose(got.numpy(), want[:, 128:], **TOL)


def test_prefetch_ok_gating():
    """Kind and shape mismatches, slabs over the L2 budget and planes the
    kernel cannot prefetch are dropped, not errors."""
    from kaito_tpu_torch.engine.quant import quantize_weight

    w8 = quantize_weight(torch.ones(256, 256), "int8")
    w4 = quantize_weight(torch.ones(256, 256), "int4")
    assert tqm.prefetch_ok(w8, w8)
    assert tqm.prefetch_ok(w4, w4)
    assert not tqm.prefetch_ok(w8, None)
    assert not tqm.prefetch_ok(w8, w4)                         # kind mismatch
    other = quantize_weight(torch.ones(256, 128), "int8")
    assert not tqm.prefetch_ok(w8, other)                      # shape mismatch
    big = quantize_weight(torch.ones(4224, 4096), "int8")      # 17.3 MB
    assert not tqm.prefetch_ok(big, big)
    off = tov._slice_out(w8, 1, 128)                           # 1-byte offset
    assert not tqm.prefetch_ok(tov._slice_out(w8, 0, 128), off)
    with pytest.raises(ValueError, match="prefetch_ok"):
        tqm.quant_matmul_cuda(torch.ones(2, 256), w8, w4)
