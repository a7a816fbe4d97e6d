"""yarn and longrope rope in kaito_tpu_torch against kaito_tpu on the CPU.

The cases of ``tests/test_rope_scaling.py``, each config built through
both packages' ``autogen``:

- ``rope_frequencies``, ``longrope_tables`` and ``rope_attention_factor``
  for yarn (NTK-by-parts, the deepseek mscale ratio), longrope with
  factor lists past and within the original length, longrope with a
  plain factor, and the ``su`` alias.  fp32 tables at rtol 1e-6 (the
  same float32 arithmetic on both sides), factors exactly.
- ``TransformerLM._rope_select`` at positions 0, 4095, 4096 and 10000:
  the short table, then the long one from the original length on.
- MLA's softmax scale with yarn's ``mscale_all_dim`` term squared.
- An engine over a phi-3 longrope config with factor lists (the JAX
  test's) decodes across the original length to the JAX engine's greedy
  tokens on the same weights.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaito_tpu.engine import nn as jnn
from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.engine import SamplingParams as JaxParams
from kaito_tpu.engine.model import TransformerLM as JaxLM
from kaito_tpu.models.autogen import arch_from_hf_config as j_arch
from kaito_tpu.models.autogen import metadata_from_hf_config as j_metadata
from kaito_tpu_torch.engine import nn as tnn
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.model import TransformerLM, params_from_jax
from kaito_tpu_torch.models.autogen import arch_from_hf_config as t_arch
from kaito_tpu_torch.models.autogen import metadata_from_hf_config as t_metadata
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

BASE_CFG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 512, "hidden_size": 256, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2,
    "intermediate_size": 512, "max_position_embeddings": 131072,
    "rope_theta": 10000.0,
}
HALF = 32
LONG = [2.0 + i * 0.1 for i in range(HALF)]
SCALINGS = {
    "yarn": ({"rope_type": "yarn", "factor": 40.0,
              "original_max_position_embeddings": 4096,
              "beta_fast": 32, "beta_slow": 1}, 131072),
    "yarn-defaults": ({"rope_type": "yarn", "factor": 40.0}, 131072),
    "yarn-deepseek": ({"rope_type": "yarn", "factor": 40.0, "mscale": 1.0,
                       "mscale_all_dim": 1.0,
                       "original_max_position_embeddings": 4096}, 131072),
    "yarn-mscale": ({"type": "yarn", "factor": 16.0, "mscale": 0.707,
                     "mscale_all_dim": 1.0,
                     "original_max_position_embeddings": 2048}, 65536),
    "longrope-long": ({"rope_type": "longrope", "long_factor": LONG,
                       "short_factor": [1.0] * HALF,
                       "original_max_position_embeddings": 4096}, 131072),
    "longrope-short": ({"rope_type": "longrope", "long_factor": LONG,
                        "short_factor": [1.0 + i * 0.01 for i in range(HALF)],
                        "original_max_position_embeddings": 4096}, 4096),
    "longrope-mscales": ({"rope_type": "longrope", "long_factor": LONG,
                          "short_factor": [1.0] * HALF, "long_mscale": 1.3,
                          "short_mscale": 1.1,
                          "original_max_position_embeddings": 4096}, 131072),
    "longrope-factor": ({"rope_type": "longrope", "factor": 32.0}, 131072),
    "su": ({"type": "su", "long_factor": LONG, "short_factor": [1.0] * HALF,
            "original_max_position_embeddings": 2048}, 131072),
}


def _archs(scaling, max_pos=131072, cfg=BASE_CFG):
    c = {**cfg, "rope_scaling": scaling, "max_position_embeddings": max_pos}
    return j_arch(c), t_arch(c)


def _close(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol, atol=0)


@pytest.mark.parametrize("case", list(SCALINGS))
def test_tables_and_factors_match(case):
    ja, ta = _archs(*SCALINGS[case])
    _close(tnn.rope_frequencies(ta, "cpu"), jnn.rope_frequencies(ja))
    assert tnn.rope_attention_factor(ta) == jnn.rope_attention_factor(ja)
    want, got = jnn.longrope_tables(ja), tnn.longrope_tables(ta, "cpu")
    assert (got is None) == (want is None)
    if want is not None:
        _close(got[0], want[0])
        _close(got[1], want[1])
        assert got[2:] == want[2:]


def test_yarn_matches_the_reference_recipe_ends():
    """High-frequency pairs keep the base table, the lowest-frequency one
    is fully interpolated (``test_yarn_matches_reference_recipe``)."""
    _, ta = _archs(SCALINGS["yarn"][0])
    got = tnn.rope_frequencies(ta, "cpu").double().numpy()
    base = 1.0 / (10000.0 ** (np.arange(0, 64, 2) / 64))
    np.testing.assert_allclose(got[0], base[0], rtol=1e-6)
    np.testing.assert_allclose(got[-1], base[-1] / 40.0, rtol=1e-4)


def test_yarn_mscale():
    assert tnn.yarn_get_mscale(40.0) == jnn.yarn_get_mscale(40.0)
    assert tnn.yarn_get_mscale(16.0, 0.707) == jnn.yarn_get_mscale(16.0, 0.707)
    assert tnn.yarn_get_mscale(1.0) == 1.0
    _, ta = _archs(SCALINGS["yarn-defaults"][0])
    assert tnn.rope_attention_factor(ta) == 0.1 * math.log(40.0) + 1.0


@pytest.mark.parametrize("case", ["longrope-long", "longrope-mscales", "su"])
def test_rope_select_switches_per_position(case):
    """Positions 0 and 4095 take the short table and mscale, 4096 and
    10000 the long ones, as the JAX model's ``_rope_select``."""
    scaling, max_pos = SCALINGS[case]
    ja, ta = _archs(scaling, max_pos)
    jm = JaxLM(ja, dtype=jnp.float32)
    tm = TransformerLM(ta, dtype=torch.float32, device="cpu")
    positions = np.asarray([[0, 4095, 4096, 10000]], np.int32)
    jinv, jms = jm._rope_select(jnp.asarray(positions))
    tinv, tms = tm._rope_select(torch.from_numpy(positions))
    assert tuple(tinv.shape) == jinv.shape == (1, 4, HALF)
    assert tuple(tms.shape) == np.asarray(jms).shape == (1, 4, 1, 1)
    _close(tinv, jinv)
    _close(tms, jms)
    short, long, orig = tm._longrope[:3]
    cut = positions[0] >= orig
    for i, is_long in enumerate(cut):
        assert torch.equal(tinv[0, i], long if is_long else short)


def test_rope_select_without_factor_lists_is_the_one_table():
    ja, ta = _archs(SCALINGS["longrope-factor"][0])
    tm = TransformerLM(ta, dtype=torch.float32, device="cpu")
    inv, ms = tm._rope_select(torch.tensor([[0, 10000]], dtype=torch.int32))
    assert tm._longrope is None and inv is tm._inv_freq_global
    assert ms == jnn.rope_attention_factor(ja)


MLA_YARN_CFG = {
    "architectures": ["DeepseekV3ForCausalLM"], "model_type": "deepseek_v3",
    "vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 4,
    "intermediate_size": 128, "max_position_embeddings": 131072,
    "kv_lora_rank": 32, "qk_rope_head_dim": 16,
    "qk_nope_head_dim": 32, "v_head_dim": 32,
    "n_routed_experts": 0, "num_experts_per_tok": 0,
}


@pytest.mark.parametrize("scaling", [
    {"type": "yarn", "factor": 40.0, "mscale": 1.0, "mscale_all_dim": 1.0,
     "original_max_position_embeddings": 4096},
    {"type": "yarn", "factor": 40.0, "mscale": 0.707, "mscale_all_dim": 1.0,
     "original_max_position_embeddings": 4096},
    {"type": "yarn", "factor": 40.0, "original_max_position_embeddings": 4096},
])
def test_mla_softmax_scale_carries_mscale_squared(scaling):
    ja, ta = _archs(scaling, cfg=MLA_YARN_CFG)
    jm = JaxLM(ja, dtype=jnp.float32)
    tm = TransformerLM(ta, dtype=torch.float32, device="cpu")
    assert tm.is_mla
    assert abs(tm._scale - jm._scale) < 1e-12
    assert tm._rope_mscale == jm._rope_mscale
    _close(tm._inv_freq_global, jm._inv_freq_global)
    if "mscale_all_dim" in scaling:
        m = tnn.yarn_get_mscale(40.0, 1.0)
        assert abs(tm._scale - m * m / math.sqrt(32 + 16)) < 1e-12


PHI3_CFG = {
    "architectures": ["Phi3ForCausalLM"], "model_type": "phi3",
    "vocab_size": 512, "hidden_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 4,
    "intermediate_size": 256, "max_position_embeddings": 8192,
    "rope_scaling": {"type": "longrope",
                     "long_factor": [1.5 + 0.05 * i for i in range(16)],
                     "short_factor": [1.0 + 0.01 * i for i in range(16)],
                     "original_max_position_embeddings": 40},
}
PHI3_ENGINE = dict(model="x", max_model_len=256, page_size=16, max_num_seqs=2,
                   dtype="float32", kv_dtype="float32", prefill_buckets=(32, 64),
                   enable_prefix_caching=False, seed=0)


def test_longrope_engine_decodes_across_the_switch_as_jax():
    """``test_phi3_128k_preset_decode_consistency`` on both engines: two
    prompts (30 and 45 tokens) decode 20 greedy tokens each across the
    original length of 40, the one prefilling across it; the port, on the
    JAX engine's weights, emits the JAX engine's tokens."""
    jmd = j_metadata("test/phi3-longrope", PHI3_CFG)
    jeng = JaxEngine(JaxConfig(**PHI3_ENGINE), metadata=jmd)
    assert jeng.model._longrope is not None and jeng.model._longrope[4] > 1.0
    prompts = [[(7 * i) % 500 + 3 for i in range(30)],
               [(11 * i) % 500 + 3 for i in range(45)]]

    def drive(eng, reqs):
        for _ in range(500):
            eng.step()
            if all(r.finish_reason for r in reqs):
                break
        return [list(r.output_tokens) for r in reqs]

    want = drive(jeng, [jeng.submit(p, JaxParams(max_tokens=20, temperature=0.0,
                                                 ignore_eos=True)) for p in prompts])
    md = t_metadata("test/phi3-longrope", PHI3_CFG)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), md.arch)
    eng = InferenceEngine(EngineConfig(**PHI3_ENGINE), metadata=md, params=params,
                          device="cpu")
    assert eng.model._longrope is not None
    got = drive(eng, [eng.submit(p, SamplingParams(max_tokens=20, temperature=0.0,
                                                   ignore_eos=True)) for p in prompts])
    assert got == want and all(len(t) == 20 for t in got)
