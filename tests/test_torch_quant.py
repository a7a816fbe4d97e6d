"""kaito_tpu_torch weight quantization against kaito_tpu's.

- The quantizer's codes and scales equal the JAX engine's (its
  ``quantize_weight`` under ``jit``, as the engine runs it) bit for bit.
- The int4 container is a bijection over every nibble pair.
- The plain version of the fused dequant matmul (K4/K5, what the kernel
  wrapper runs for CPU tensors) agrees with the Pallas kernel in
  interpret mode and with ``dequant_matmul_jax`` at the shapes of
  ``tests/test_weight_quant.py``, in fp32 (rtol/atol 2e-5: the sums run
  in another order).
- Routing: rows above ``MAX_ROWS`` take the dequantize-then-matmul
  route; unknown schemes raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaito_tpu.engine import quant as jq
from kaito_tpu.engine.ops import quant_matmul as jqm
from kaito_tpu.models import get_model_by_name as jax_model
from kaito_tpu_torch.engine import quant as tq
from kaito_tpu_torch.engine.ops import quant_matmul as tqm
from kaito_tpu_torch.models import get_model_by_name
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)


def _jit_quantize(w: np.ndarray, scheme: str) -> dict:
    fn = jax.jit(lambda a: jq.quantize_weight(a, scheme))
    return jax.tree.map(np.array, fn(jnp.asarray(w)))


@pytest.mark.parametrize("scheme", ["int8", "int4"])
@pytest.mark.parametrize("shape", [
    (256, 48),              # dense 2-D: two int4 groups
    (3, 256, 48),           # stacked layers
    (2, 4, 384, 32),        # MoE [layer, expert, in, out]
    (100, 16),              # in % 128 != 0: one whole-column int4 group
    (4, 1024, 256),         # tiny-llama down projection
])
def test_codes_and_scales_equal_the_jax_engines(scheme, shape):
    rng = np.random.RandomState(sum(shape))
    w = (rng.randn(*shape) * rng.uniform(0.01, 3.0, shape[-1])).astype(np.float32)
    want = _jit_quantize(w, scheme)
    got = tq.quantize_weight(torch.from_numpy(w), scheme)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == {"q8": torch.int8, "q4": torch.int8,
                                "scale": torch.float32}[k]
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_bf16_weights_quantize_like_the_jax_engine():
    rng = np.random.RandomState(3)
    w = rng.randn(2, 256, 64).astype(np.float32)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    for scheme in ("int8", "int4"):
        want = _jit_quantize(np.asarray(jnp.asarray(w, jnp.bfloat16)), scheme)
        got = tq.quantize_weight(wb, scheme)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_pack_unpack_is_a_bijection_over_all_nibbles():
    vals = np.arange(-8, 8, dtype=np.int32)
    lo, hi = np.meshgrid(vals, vals, indexing="ij")
    q = np.stack([lo.ravel(), hi.ravel()], axis=1).reshape(-1, 2, 1)   # [256, 2, 1]
    packed = tq._pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.int8 and tuple(packed.shape) == (256, 1, 1)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq._pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), q)
    # every byte value is one distinct nibble pair
    assert len(set(packed.numpy().ravel().tolist())) == 256


@pytest.mark.parametrize("scheme", ["int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequant_weight_matches(scheme, dtype):
    rng = np.random.RandomState(4)
    w = rng.randn(3, 256, 40).astype(np.float32)
    qt = _jit_quantize(w, scheme)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jq.dequant_weight(jax.tree.map(jnp.asarray, qt), jdt),
                      np.float32)
    got = tq.dequant_weight({k: torch.from_numpy(v) for k, v in qt.items()}, dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


# the kernel-parity shapes of tests/test_weight_quant.py (odd K only int8)
SHAPES = [("int8", 1, 256, 128), ("int8", 4, 128, 48), ("int8", 8, 512, 256),
          ("int8", 3, 100, 16), ("int4", 1, 256, 128), ("int4", 4, 128, 48),
          ("int4", 8, 512, 256), ("int4", 3, 96, 16)]


@pytest.mark.parametrize("scheme,rows,K,N", SHAPES)
def test_plain_quant_matmul_matches_the_pallas_kernel_and_fallback(scheme, rows,
                                                                  K, N):
    rng = np.random.RandomState(rows * K + N)
    x = rng.randn(rows, K).astype(np.float32)
    qt = _jit_quantize(rng.randn(K, N).astype(np.float32), scheme)
    jw = jax.tree.map(jnp.asarray, qt)
    tw = {k: torch.from_numpy(v) for k, v in qt.items()}
    got = tqm.quant_linear(torch.from_numpy(x), tw).numpy()
    pallas = np.asarray(jqm.quant_matmul(jnp.asarray(x), jw, interpret=True))
    fallback = np.asarray(jqm.dequant_matmul_jax(jnp.asarray(x), jw))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, fallback, **TOL)
    np.testing.assert_allclose(tqm.dequant_matmul(torch.from_numpy(x), tw).numpy(),
                               fallback, **TOL)


# prefill-sized rows, which the kernel's wide path takes on the card.
# Their tolerance: 64-256 rows give thousands more outputs of magnitude
# ~20 than SHAPES, and the fp32 sums of 512 products, run in other orders
# here, in the Pallas kernel and in the fallback, differ by up to ~6e-5
# absolute on a few of them (TOL's atol is 2e-5).
PREFILL_SHAPES = [(scheme, rows, 512, 256) for scheme in ("int8", "int4")
                  for rows in (64, 200, 256)]
PREFILL_TOL = dict(rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("scheme,rows,K,N", PREFILL_SHAPES)
def test_plain_quant_matmul_at_prefill_rows(scheme, rows, K, N):
    rng = np.random.RandomState(rows * K + N)
    x = rng.randn(rows, K).astype(np.float32)
    qt = _jit_quantize(rng.randn(K, N).astype(np.float32), scheme)
    jw = jax.tree.map(jnp.asarray, qt)
    tw = {k: torch.from_numpy(v) for k, v in qt.items()}
    got = tqm.quant_linear(torch.from_numpy(x), tw).numpy()
    pallas = np.asarray(jqm.quant_matmul(jnp.asarray(x), jw, interpret=True))
    fallback = np.asarray(jqm.dequant_matmul_jax(jnp.asarray(x), jw))
    np.testing.assert_allclose(got, pallas, **PREFILL_TOL)
    np.testing.assert_allclose(got, fallback, **PREFILL_TOL)


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_leading_dims_flatten_into_rows(scheme):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 3, 256).astype(np.float32)
    qt = _jit_quantize(rng.randn(256, 128).astype(np.float32), scheme)
    tw = {k: torch.from_numpy(v) for k, v in qt.items()}
    got = tqm.quant_linear(torch.from_numpy(x), tw)
    want = jqm.quant_linear(jnp.asarray(x), jax.tree.map(jnp.asarray, qt))
    assert tuple(got.shape) == (2, 3, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_plain_version_folds_scales_in_fp32():
    """In bf16 the plain version (the kernel's arithmetic: fp32 dot, fp32
    scale, one cast) is the fp32 result rounded once; the JAX fallback
    scales in bf16 after a bf16 dot and lands within bf16 rounding."""
    rng = np.random.RandomState(8)
    x = rng.randn(4, 256).astype(np.float32)
    qt = {k: torch.from_numpy(v) for k, v in
          _jit_quantize(rng.randn(256, 64).astype(np.float32), "int8").items()}
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tqm.quant_matmul_plain(xb, qt)
    exact = tqm.quant_matmul_plain(xb.float(), qt)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, exact.to(torch.bfloat16))
    fallback = tqm.dequant_matmul(xb, qt).float()
    assert (fallback - exact).abs().max().item() <= 2e-2 * exact.abs().max().item()


def test_rows_over_max_take_the_dequant_route(monkeypatch):
    calls = []

    def spy(x, w):
        calls.append(x.shape[0])
        return tqm.quant_matmul_plain(x, w)

    monkeypatch.setattr(tqm, "quant_matmul_cuda", spy)
    rng = np.random.RandomState(9)
    w = tq.quantize_weight(torch.from_numpy(rng.randn(128, 32).astype(np.float32)),
                           "int4")
    x = torch.from_numpy(rng.randn(tqm.MAX_ROWS + 1, 128).astype(np.float32))
    assert torch.equal(tqm.quant_linear(x, w), tqm.dequant_matmul(x, w))
    assert calls == []
    tqm.quant_linear(x[:tqm.MAX_ROWS].reshape(2, tqm.MAX_ROWS // 2, 128), w)
    assert calls == [tqm.MAX_ROWS]


def test_unknown_scheme_raises():
    w = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="int3"):
        tq.quantize_weight(w, "int3")
    with pytest.raises(ValueError, match="int3"):
        tq.quantize_params({"dense": {"q": w}}, "int3")
    with pytest.raises(ValueError, match="odd"):
        tq.quantize_weight(torch.zeros(5, 4), "int4")


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_quantize_params_matches_the_jax_tree(scheme):
    rng = np.random.RandomState(10)
    tree = {"embed": rng.randn(16, 8).astype(np.float32),
            "dense": {"q": rng.randn(2, 8, 8).astype(np.float32),
                      "attn_norm": rng.randn(2, 8).astype(np.float32),
                      "down": rng.randn(2, 16, 8).astype(np.float32)}}
    fn = jax.jit(lambda t: jq.quantize_params(t, scheme))
    want = jax.tree.map(np.array, fn(jax.tree.map(jnp.asarray, tree)))
    got = tq.quantize_params(
        {"embed": torch.from_numpy(tree["embed"]),
         "dense": {k: torch.from_numpy(v) for k, v in tree["dense"].items()}},
        scheme)
    np.testing.assert_array_equal(got["embed"].numpy(), want["embed"])
    np.testing.assert_array_equal(got["dense"]["attn_norm"].numpy(),
                                  want["dense"]["attn_norm"])
    for key in ("q", "down"):
        assert tq.qtensor_kind(got["dense"][key]) == scheme
        for k, v in want["dense"][key].items():
            np.testing.assert_array_equal(got["dense"][key][k].numpy(), v)
    # already-quantized leaves pass through untouched
    again = tq.quantize_params(got, scheme)
    assert again["dense"]["q"] is got["dense"]["q"]


def test_helpers_match():
    for preset in ("tiny-llama-test", "llama-3.1-8b-instruct", "phi-2"):
        arch, jarch = get_model_by_name(preset).arch, jax_model(preset).arch
        for scheme in ("int8", "int4", "fp8", ""):
            assert tq.supports_quantization(arch, scheme) \
                == jq.supports_quantization(jarch, scheme)
    assert tq.QUANT_KEYS == jq.QUANT_KEYS and tq.QUANT_SCHEMES == jq.QUANT_SCHEMES
    assert tq.INT4_GROUP == jq.INT4_GROUP
    for group, name in (("dense", "q"), ("dense", "attn_norm"), ("serve_lora", "q")):
        assert tq.is_quantized_leaf(group, name) == jq.is_quantized_leaf(group, name)
    q4 = tq.quantize_weight(torch.zeros(3, 384, 8), "int4")
    q8 = tq.quantize_weight(torch.zeros(3, 384, 8), "int8")
    assert tq.int4_group_size(q4) == 128
    assert tq.qtensor_kind(q4) == "int4" and tq.qtensor_kind(q8) == "int8"
    assert tq.is_qtensor(q8) and not tq.is_qtensor({"scale": 1})
    assert tq.qtensor_kind(torch.zeros(2)) == ""
