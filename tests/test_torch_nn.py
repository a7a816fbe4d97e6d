"""kaito_tpu_torch.engine.nn against kaito_tpu.engine.nn on the CPU.

Inputs are made with numpy from a seed and fed to both.  Tolerance:
fp32 rtol/atol 2e-5 (the two frameworks round transcendentals and sums
in their own order)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaito_tpu.engine import nn as jnn
from kaito_tpu.models import get_model_by_name as jax_model
from kaito_tpu_torch.engine import nn as tnn
from kaito_tpu_torch.models import get_model_by_name
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), **(kw or TOL))


@pytest.mark.parametrize("preset", ["tiny-llama-test", "llama-3.1-8b-instruct",
                                    "phi-2", "gemma-3-4b-instruct"])
def test_rope_frequencies_match(preset):
    """default (theta 10k), llama3 scaling, partial rotary, gemma theta."""
    arch = get_model_by_name(preset).arch
    want = jnn.rope_frequencies(jax_model(preset).arch)
    _close(tnn.rope_frequencies(arch, "cpu"), want)


def test_rope_linear_scaling_matches():
    arch = dataclasses.replace(get_model_by_name("tiny-llama-test").arch,
                               rope_scaling={"rope_type": "linear",
                                             "factor": 4.0})
    jarch = dataclasses.replace(jax_model("tiny-llama-test").arch,
                                rope_scaling={"rope_type": "linear",
                                              "factor": 4.0})
    _close(tnn.rope_frequencies(arch, "cpu"), jnn.rope_frequencies(jarch))


@pytest.mark.parametrize("preset,mscale", [("llama-3.1-8b-instruct", 1.0),
                                           ("phi-2", 1.0),
                                           ("tiny-llama-test", 0.9)])
def test_apply_rope_matches(preset, mscale):
    arch = get_model_by_name(preset).arch
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 4, arch.head_dim).astype(np.float32)
    pos = rng.randint(0, 4000, size=(2, 5)).astype(np.int32)
    inv = tnn.rope_frequencies(arch, "cpu")
    got = tnn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), inv,
                         arch.head_dim, mscale=mscale)
    want = jnn.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                          jnp.asarray(inv.numpy()), arch.head_dim,
                          mscale=mscale)
    # angles reach 4000 rad: one fp32 ulp of the angle is 2.4e-4, so the
    # two sin/cos implementations may differ by that much
    _close(got, want, rtol=0, atol=5e-4)


@pytest.mark.parametrize("offset", [False, True])
def test_rms_norm_matches(offset):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 7, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    _close(tnn.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6, offset),
           jnn.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, offset))


@pytest.mark.parametrize("with_bias", [False, True])
def test_layer_norm_matches(with_bias):
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 7, 64) * 3 + 1).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    b = rng.randn(64).astype(np.float32) if with_bias else None
    got = tnn.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                         None if b is None else torch.from_numpy(b), 1e-5)
    want = jnn.layer_norm(jnp.asarray(x), jnp.asarray(w),
                          None if b is None else jnp.asarray(b), 1e-5)
    _close(got, want)


def test_apply_norm_dispatches_on_arch():
    arch = get_model_by_name("phi-2").arch            # layernorm family
    jarch = jax_model("phi-2").arch
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 32).astype(np.float32)
    p = {"scale": rng.randn(32).astype(np.float32),
         "bias": rng.randn(32).astype(np.float32)}
    got = tnn.apply_norm(torch.from_numpy(x),
                         {k: torch.from_numpy(v) for k, v in p.items()}, arch)
    want = jnn.apply_norm(jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in p.items()}, jarch)
    _close(got, want)


@pytest.mark.parametrize("name", ["silu", "gelu", "gelu_tanh"])
def test_activation_matches(name):
    x = np.linspace(-6, 6, 301, dtype=np.float32)
    _close(tnn.activation(torch.from_numpy(x), name),
           jnn.activation(jnp.asarray(x), name))


def test_unknown_activation_raises():
    with pytest.raises(ValueError):
        tnn.activation(torch.zeros(3), "relu6")


@pytest.mark.parametrize("preset", ["tiny-llama-test", "phi-2"])
def test_mlp_matches(preset):
    """gated SwiGLU (llama) and classic 2-matrix GELU with biases (phi-2)."""
    arch = dataclasses.replace(get_model_by_name(preset).arch,
                               hidden_size=32, intermediate_size=48)
    jarch = dataclasses.replace(jax_model(preset).arch, hidden_size=32,
                                intermediate_size=48)
    rng = np.random.RandomState(4)
    p = {"up": rng.randn(32, 48), "down": rng.randn(48, 32) / 7}
    if arch.gated_mlp:
        p["gate"] = rng.randn(32, 48)
    else:
        p["up_bias"], p["down_bias"] = rng.randn(48), rng.randn(32)
    p = {k: (v / 5).astype(np.float32) for k, v in p.items()}
    x = rng.randn(2, 3, 32).astype(np.float32)
    got = tnn.mlp(torch.from_numpy(x),
                  {k: torch.from_numpy(v) for k, v in p.items()}, arch)
    want = jnn.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                   jarch)
    _close(got, want)


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_linear_routes_quantized_weights(scheme):
    """A QTensor weight goes through the quantized matmul, as in the JAX
    package's nn.linear (fp32: the two differ by summation order)."""
    from kaito_tpu.engine.quant import quantize_weight as jquant
    from kaito_tpu_torch.engine.quant import quantize_weight as tquant

    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 256).astype(np.float32)
    w = rng.randn(256, 64).astype(np.float32)
    got = tnn.linear(torch.from_numpy(x), tquant(torch.from_numpy(w), scheme))
    want = jnn.linear(jnp.asarray(x), jquant(jnp.asarray(w), scheme))
    _close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("cap", [None, 30.0])
def test_softcap_matches(cap):
    x = np.linspace(-200, 200, 101, dtype=np.float32)
    _close(tnn.softcap(torch.from_numpy(x), cap), jnn.softcap(jnp.asarray(x), cap))


def test_rope_attention_factor():
    arch = get_model_by_name("llama-3.1-8b-instruct").arch
    assert tnn.rope_attention_factor(arch) == 1.0
    arch = dataclasses.replace(arch, rope_scaling={
        **arch.rope_scaling, "attention_factor": 1.25})
    assert tnn.rope_attention_factor(arch) == 1.25
