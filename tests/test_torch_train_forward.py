"""The port's training forward against the JAX package's, on the CPU.

``TransformerLM.forward_train`` (mode "train") and the masked
cross-entropy of ``tuning.train_step`` against ``jax.value_and_grad``
of the JAX ``forward_train``, from the same weights (the JAX
``init_params``, with the JAX ``add_lora_params`` factors and B drawn
non-zero so that every factor has a gradient): tiny llama, gemma-3 cut
to four layers with its sliding windows and softcaps added, phi-2
(parallel residual, classic MLP, biases), tiny-moe-real (MoE, the dense
expert form) and a tiny MLA model (DeepSeek-V3 layout; its attention
projections take no LoRA update, in either package).  Also: a few
leaves under full fine-tuning, QLoRA (the int8 base of the port's
``tuning.quant.quantize_base``, codes and scales equal to the JAX
package's; 32-row calls take the K4 wrapper under autograd), remat on
equal to remat off, the attention mask honoured, and the K4/K5 autograd
Function's ``dx`` equal to the dequant product's.

Tolerances, fp32: logits atol 1e-4 (each framework sums in its own
order, as ``tests/test_torch_model.py``); loss rtol 1e-5; each gradient
within 1e-4 of its largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaito_tpu.engine.model import TransformerLM as JaxLM
from kaito_tpu.models import get_model_by_name as jax_model
from kaito_tpu.models.autogen import arch_from_hf_config as j_arch_from_hf
from kaito_tpu.tuning.quant import quantize_base as j_quantize_base
from kaito_tpu_torch.engine.model import TransformerLM, params_from_jax
from kaito_tpu_torch.engine.ops.quant_matmul import (QuantMatmulFn, dequant_matmul,
                                                     quant_linear, quant_matmul_plain)
from kaito_tpu_torch.engine.quant import quantize_weight as serve_quantize
from kaito_tpu_torch.models import get_model_by_name
from kaito_tpu_torch.models.autogen import arch_from_hf_config
from kaito_tpu_torch.tuning.lora import ALL_TARGETS
from kaito_tpu_torch.tuning.quant import dequantize_weight, quantize_base, quantize_weight
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.helpers.train_pairs import (batch, jax_loss_grads, lora_keys, np_tree, pair,
                                       torch_loss_grads)

LOGIT_ATOL, LOSS_RTOL, GRAD_REL = 1e-4, 1e-5, 1e-4
NARROW = dict(hidden_size=64, intermediate_size=128, vocab_size=512)
MLA_CFG = {
    "architectures": ["DeepseekV3ForCausalLM"], "model_type": "deepseek_v3",
    "vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 3,
    "num_attention_heads": 4, "num_key_value_heads": 4, "intermediate_size": 128,
    "moe_intermediate_size": 32, "n_routed_experts": 4, "num_experts_per_tok": 2,
    "n_shared_experts": 1, "first_k_dense_replace": 1, "kv_lora_rank": 32,
    "qk_rope_head_dim": 16, "qk_nope_head_dim": 24, "v_head_dim": 24,
    "max_position_embeddings": 256,
}


def _preset(name, **kw):
    return (dataclasses.replace(jax_model(name).arch, **kw),
            dataclasses.replace(get_model_by_name(name).arch, **kw))


# family -> ((JAX arch, port arch), lora targets)
FAMILIES = {
    "tiny-llama": (lambda: _preset("tiny-llama-test"), ("q", "k", "v", "o")),
    "gemma-3-windowed-softcapped": (lambda: _preset(
        "gemma-3-4b-instruct", **NARROW, num_heads=2, num_kv_heads=1, num_layers=4,
        sliding_window=8, sliding_window_pattern=2, attn_logit_softcap=50.0,
        final_logit_softcap=30.0), ALL_TARGETS),
    "phi-2-parallel-residual": (lambda: _preset(
        "phi-2", **NARROW, num_heads=2, num_kv_heads=2, num_layers=2), ALL_TARGETS),
    "tiny-moe-real": (lambda: _preset("tiny-moe-real"), ("q", "k", "v", "o")),
    "tiny-mla": (lambda: (j_arch_from_hf(MLA_CFG), arch_from_hf_config(MLA_CFG)),
                 ALL_TARGETS),
}


def _close_grads(got: dict, want: dict):
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-6)
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= GRAD_REL * scale, f"{k}: {err} > {GRAD_REL} x {scale}"


def _compare(jm, params, tm, keys, tokens, mask, attn_mask=None):
    jl, jloss, jg = jax_loss_grads(jm, params, keys, tokens, mask, attn_mask)
    tl, tloss, tg = torch_loss_grads(tm, keys, tokens, mask, attn_mask)
    assert tl.dtype == np.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGIT_ATOL)
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    _close_grads(tg, jg)
    return tg


@pytest.mark.parametrize("family", list(FAMILIES))
def test_lora_forward_and_grads_match_jax(family):
    archs, targets = FAMILIES[family]
    jarch, tarch = archs()
    jm, params, tm = pair(jarch, tarch, targets=targets)
    keys = lora_keys(params)
    assert keys
    tokens, mask = batch(jarch.vocab_size, 2, 24, seed=1, pad=(0, 6))
    grads = _compare(jm, params, tm, keys, tokens, mask)
    # every factor a projection applies has a gradient; MLA's attention
    # factors are added but, as in the JAX package, applied nowhere
    for k, g in grads.items():
        site = k.split("/")[1].split("_lora_")[0]
        applied = not (tm.is_mla and site in ("q", "k", "v", "o"))
        assert (np.abs(g).max() > 0) == applied, k


def test_attention_mask_sets_the_true_lengths():
    jarch, tarch = _preset("tiny-llama-test")
    jm, params, tm = pair(jarch, tarch)
    keys = lora_keys(params)
    tokens, mask = batch(jarch.vocab_size, 2, 16, seed=2, pad=(0, 5))
    _compare(jm, params, tm, keys, tokens, mask, attn_mask=mask)
    # a row's tokens past its length change nothing before it
    t2 = tokens.copy()
    t2[1, 12:] = (t2[1, 12:] + 7) % jarch.vocab_size
    a, _, _ = torch_loss_grads(tm, keys, tokens, mask, attn_mask=mask)
    b, _, _ = torch_loss_grads(tm, keys, t2, mask, attn_mask=mask)
    np.testing.assert_array_equal(a[1, :11], b[1, :11])


def test_full_fine_tuning_grads_match_jax():
    jarch, tarch = _preset("tiny-llama-test")
    jm, params, tm = pair(jarch, tarch, method="full")
    keys = ["dense/down", "dense/mlp_norm", "dense/q", "embed", "final_norm", "lm_head"]
    tokens, mask = batch(jarch.vocab_size, 2, 16, seed=3)
    _compare(jm, params, tm, keys, tokens, mask)


def test_qlora_grads_match_jax_through_the_kernel_wrapper(monkeypatch):
    """B=2, T=16: every projection is a 32-row call, which takes the K4
    wrapper (its plain version here) under autograd."""
    jarch, tarch = _preset("tiny-llama-test")
    jm, params, tm = pair(jarch, tarch, method="qlora")
    calls = []
    real = QuantMatmulFn.forward

    def counted(ctx, x, w, w_next):
        calls.append(tuple(x.shape))
        return real(ctx, x, w, w_next)

    monkeypatch.setattr(QuantMatmulFn, "forward", staticmethod(counted))
    tokens, mask = batch(jarch.vocab_size, 2, 16, seed=4)
    _compare(jm, params, tm, lora_keys(params), tokens, mask)
    # 7 quantized projections a layer, all but the first layer's q/k/v
    # (whose input, the frozen embedding, needs no gradient) under
    # autograd; the rematerialized forward of the backward adds more
    assert len(calls) >= 7 * jarch.num_layers - 3 and set(calls) <= {
        (32, tarch.hidden_size), (32, tarch.num_heads * tarch.head_dim),
        (32, tarch.intermediate_size)}


def test_remat_on_equals_remat_off():
    jarch, tarch = _preset("tiny-moe-real")
    _, params, tm = pair(jarch, tarch)
    keys = lora_keys(params)
    tokens, mask = batch(jarch.vocab_size, 2, 16, seed=5)
    on = torch_loss_grads(tm, keys, tokens, mask, remat=True)
    off = torch_loss_grads(tm, keys, tokens, mask, remat=False)
    np.testing.assert_array_equal(on[0], off[0])
    assert on[1] == off[1]
    for k in keys:
        np.testing.assert_array_equal(on[2][k], off[2][k])


def test_quantize_base_equals_jax():
    jarch, tarch = _preset("tiny-moe-real")
    jm = JaxLM(jarch, dtype=jnp.float32)
    params = jm.init_params(jax.random.PRNGKey(7))
    want = np_tree(j_quantize_base(jm, params))
    tm = TransformerLM(tarch, dtype=torch.float32, device="cpu")
    tm.load_params(params_from_jax(np_tree(params), tarch))
    quantize_base(tm)
    got = tm.param_tree()
    n = 0
    for g in want:
        if not isinstance(want[g], dict):
            continue
        for t, w in want[g].items():
            if isinstance(w, dict):
                np.testing.assert_array_equal(got[g][t]["q8"].numpy(), w["q8"])
                np.testing.assert_array_equal(got[g][t]["scale"].numpy(), w["scale"])
                np.testing.assert_array_equal(
                    dequantize_weight(got[g][t], torch.float32).numpy(),
                    np.asarray(w["q8"], np.float32) * w["scale"][..., None, :])
                n += 1
            else:
                assert not isinstance(got[g][t], dict), (g, t)
    assert n == 4          # q/k/v/o of the MoE stack; experts stay plain


def test_quantize_weight_rounds_half_to_even_and_clips():
    w = torch.tensor([[127.0, 0.5], [-1.5, 1.0], [2.5, -2.0]])
    qt = quantize_weight(w)
    assert qt["q8"].dtype == torch.int8
    np.testing.assert_array_equal(qt["q8"].numpy(), [[127, 32], [-2, 64], [2, -127]])


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_quant_matmul_fn_dx_equals_the_dequant_product(scheme):
    rng = np.random.RandomState(8)
    K, N = 256, 96
    w = serve_quantize(torch.from_numpy(rng.randn(K, N).astype(np.float32)) / 16, scheme)
    x = torch.from_numpy(rng.randn(2, 20, K).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.randn(2, 20, N).astype(np.float32))
    y = quant_linear(x, w)
    assert "QuantMatmulFn" in type(y.grad_fn).__name__ or any(
        "QuantMatmulFn" in type(f[0]).__name__ for f in y.grad_fn.next_functions if f[0])
    np.testing.assert_array_equal(y.detach().numpy(),
                                  quant_matmul_plain(x.detach(), w).numpy())
    (dx,) = torch.autograd.grad(y, x, g)
    x2 = x.detach().clone().requires_grad_(True)
    (want,) = torch.autograd.grad(dequant_matmul(x2, w), x2, g)
    np.testing.assert_allclose(dx.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    # no gradient wanted: the kernel wrapper itself, no autograd node
    with torch.no_grad():
        assert quant_linear(x, w).grad_fn is None
