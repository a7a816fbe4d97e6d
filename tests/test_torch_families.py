"""The dense families in kaito_tpu_torch against kaito_tpu on the CPU.

Each family's preset is cut to a few layers at narrow widths, keeping
its head dim and its traits: gemma-3 (head dim 256, sliding windows
with a global layer, four norms a layer with offset, q/k norms, the
embedding multiplier, ``query_pre_attn_scalar``), falcon (parallel
residual, layer norms, one KV head), phi-2 (head dim 80, partial rotary
0.4, parallel residual, biases), phi-3 (head dim 96, longrope with
factor lists whose original length the prompts and decode cross),
phi-4-mini (partial rotary 0.75, tied embeddings), qwen2 (q/k/v biases)
and qwen3 (q/k norms).  Weights come from the JAX ``init_params`` and are
carried across with ``params_from_jax``; both models run one prefill of
two prompts (24 and 14 tokens) and four decode steps in fp32.
Tolerance: fp32 atol 1e-4 on logits, as ``tests/test_torch_model.py``
(each framework sums in its own order).

The fused-weight split: a phi-3 checkpoint written under the fused
``qkv_proj`` / ``gate_up_proj`` names loads in the port to the JAX
loader's tensors, through ``safetensors`` and through the port's own
``write_safetensors``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaito_tpu.engine.kv_cache import create_kv_cache as j_cache
from kaito_tpu.engine.model import TransformerLM as JaxLM
from kaito_tpu.engine.weights import export_hf_state_dict
from kaito_tpu.engine.weights import load_safetensors_params as j_load
from kaito_tpu.models import get_model_by_name as jax_model
from kaito_tpu_torch.engine.kv_cache import create_kv_cache as t_cache
from kaito_tpu_torch.engine.model import TransformerLM, params_from_jax
from kaito_tpu_torch.engine.weights import load_safetensors_params as t_load
from kaito_tpu_torch.engine.weights import write_safetensors
from kaito_tpu_torch.models import get_model_by_name
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

PS, P, PMAX = 16, 12, 4
TOL = dict(rtol=1e-4, atol=1e-4)
NARROW = dict(hidden_size=64, intermediate_size=128, vocab_size=512, num_layers=2)
PHI3_ROPE = {"rope_type": "longrope", "original_max_position_embeddings": 16,
             "long_factor": [1.0 + 0.25 * i for i in range(48)],
             "short_factor": [1.0 + 0.02 * i for i in range(48)]}
# family -> (preset, overrides of its arch); head dims stay the preset's
FAMILIES = {
    "gemma-3": ("gemma-3-4b-instruct",
                dict(NARROW, num_heads=2, num_kv_heads=1, num_layers=4,
                     sliding_window=8, sliding_window_pattern=2)),
    "falcon": ("falcon-7b", dict(NARROW, num_heads=4, num_kv_heads=1)),
    "phi-2": ("phi-2", dict(NARROW, num_heads=2, num_kv_heads=2)),
    "phi-3": ("phi-3-mini-128k-instruct",
              dict(NARROW, num_heads=2, num_kv_heads=2, rope_scaling=PHI3_ROPE)),
    "phi-4-mini": ("phi-4-mini-instruct", dict(NARROW, num_heads=4, num_kv_heads=2)),
    "qwen2": ("qwen2.5-coder-7b-instruct", dict(NARROW, num_heads=4, num_kv_heads=2)),
    "qwen3": ("qwen3-8b", dict(NARROW, num_heads=4, num_kv_heads=2)),
}
HEAD_DIMS = {"gemma-3": 256, "falcon": 64, "phi-2": 80, "phi-3": 96,
             "phi-4-mini": 128, "qwen2": 128, "qwen3": 128}


def _archs(family):
    preset, kw = FAMILIES[family]
    return (dataclasses.replace(jax_model(preset).arch, **kw),
            dataclasses.replace(get_model_by_name(preset).arch, **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_prefill_and_decode_match(family):
    jarch, tarch = _archs(family)
    assert tarch.head_dim == HEAD_DIMS[family]
    jm = JaxLM(jarch, dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = TransformerLM(tarch, dtype=torch.float32, device="cpu")
    tm.load_params(params_from_jax(jax.tree.map(np.asarray, jp), tarch))
    assert (tm._longrope is None) == (family != "phi-3")
    rng = np.random.RandomState(0)
    B, T = 2, 24
    toks = rng.randint(0, tarch.vocab_size, size=(B, T)).astype(np.int32)
    tl = np.array([24, 14], np.int32)
    pt = np.stack([np.arange(1 + b * PMAX, 1 + (b + 1) * PMAX)
                   for b in range(B)]).astype(np.int32)
    jc = j_cache(jarch, P, PS, jnp.float32)
    tc = t_cache(tarch, P, PS, torch.float32, "cpu")
    jc, jl, _ = jm.prefill(jp, jc, jnp.asarray(toks), jnp.asarray(tl), jnp.asarray(pt))
    tc, tlg, _ = tm.prefill(tc, _t(toks), _t(tl), _t(pt))
    _close(tlg, jl)
    pos = tl.copy()
    nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    act = np.array([True, True])
    for _ in range(4):        # phi-3's short row crosses position 16 here
        jc, jl = jm.decode(jp, jc, jnp.asarray(nxt), jnp.asarray(pos),
                           jnp.asarray(pt), active=jnp.asarray(act))
        tc, tlg = tm.decode(tc, _t(nxt), _t(pos), _t(pt), active=_t(act))
        _close(tlg, jl)
        nxt = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        pos = pos + 1
    np.testing.assert_allclose(tc.k[:, 1:].numpy(), np.asarray(jc.k[:, 1:]), **TOL)


def _fused_state_dict(jm, jp, layers):
    """The JAX model's HF state dict with q/k/v fused into ``qkv_proj``
    and gate/up into ``gate_up_proj``, as phi-3 checkpoints store them."""
    sd = export_hf_state_dict(jm, jp)
    for i in range(layers):
        pre = f"model.layers.{i}."
        sd[pre + "self_attn.qkv_proj.weight"] = np.concatenate(
            [sd.pop(pre + f"self_attn.{n}_proj.weight") for n in "qkv"])
        sd[pre + "mlp.gate_up_proj.weight"] = np.concatenate(
            [sd.pop(pre + f"mlp.{n}_proj.weight") for n in ("gate", "up")])
    return sd


@pytest.mark.parametrize("writer", ["safetensors", "port"])
def test_fused_phi3_checkpoint_splits_as_jax(tmp_path, writer):
    jarch, tarch = _archs("phi-3")
    jarch = dataclasses.replace(jarch, num_kv_heads=1)   # q and k/v cut apart
    tarch = dataclasses.replace(tarch, num_kv_heads=1)
    jm = JaxLM(jarch, dtype=jnp.float32)
    jp = jm.init_params(jax.random.PRNGKey(3))
    sd = _fused_state_dict(jm, jp, jarch.num_layers)
    assert not any(k.endswith(("q_proj.weight", "gate_proj.weight")) for k in sd)
    path = str(tmp_path / "model.safetensors")
    if writer == "safetensors":
        from safetensors.numpy import save_file

        save_file(sd, path)
    else:
        write_safetensors(path, {k: torch.from_numpy(np.array(v))
                                 for k, v in sd.items()})
    want = j_load(jm, str(tmp_path))
    tm = TransformerLM(tarch, dtype=torch.float32, device="cpu")
    got = t_load(tm, str(tmp_path))
    assert set(got) == set(want)
    for key, val in want.items():
        if isinstance(val, dict):
            assert set(got[key]) == set(val)
            for name, x in val.items():
                np.testing.assert_array_equal(got[key][name].numpy(), np.asarray(x),
                                              err_msg=f"{key}/{name}")
        else:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(val))
    # and the split is the one the JAX model was drawn with
    np.testing.assert_array_equal(got["dense"]["k"].numpy(), np.asarray(jp["dense"]["k"]))
    np.testing.assert_array_equal(got["dense"]["up"].numpy(), np.asarray(jp["dense"]["up"]))
