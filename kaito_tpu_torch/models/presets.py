"""Built-in model presets.

Same preset-name surface as the reference's
``presets/workspace/models/supported_models.yaml`` (31 presets) so a
KAITO user finds every model they had; each entry carries the public HF
``config.json`` essentials so the engine can instantiate the
architecture and the estimator can size HBM without network access.

Configs are the published architecture numbers for each public
checkpoint.  Entries tagged ``approx`` use best-effort numbers where
the upstream checkpoint is gated/unpublished.
"""

from __future__ import annotations

from kaito_tpu_torch.models.autogen import metadata_from_hf_config
from kaito_tpu_torch.models.metadata import ModelMetadata
from kaito_tpu_torch.models.registry import register_model

_LLAMA31_SCALING = {
    "rope_type": "llama3",
    "factor": 8.0,
    "low_freq_factor": 1.0,
    "high_freq_factor": 4.0,
    "original_max_position_embeddings": 8192,
}


def _llama(vocab, hidden, layers, heads, kv, inter, max_pos=131072, theta=500000.0, scaling=_LLAMA31_SCALING):
    return {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": vocab,
        "hidden_size": hidden,
        "num_hidden_layers": layers,
        "num_attention_heads": heads,
        "num_key_value_heads": kv,
        "intermediate_size": inter,
        "max_position_embeddings": max_pos,
        "rope_theta": theta,
        "rope_scaling": scaling,
        "rms_norm_eps": 1e-5,
    }


_PRESETS: list[ModelMetadata] = []


def _add(name, hf_id, cfg, *, auth=False, quant="", tags=(), draft=""):
    md = metadata_from_hf_config(
        hf_id, cfg, name=name, download_auth_required=auth,
        quantization=quant, tags=tuple(tags), speculative_draft=draft,
    )
    _PRESETS.append(md)
    return md


# ---- Llama --------------------------------------------------------------
_add("llama-3.1-8b-instruct", "meta-llama/Llama-3.1-8B-Instruct",
     _llama(128256, 4096, 32, 32, 8, 14336), auth=True)
# curated draft pairing: same tokenizer family (vocab 128256), ~9x
# smaller — the "auto" value of the kaito-tpu.io/speculative-draft
# annotation resolves to this (docs/speculative.md)
_add("llama-3.3-70b-instruct", "meta-llama/Llama-3.3-70B-Instruct",
     _llama(128256, 8192, 80, 64, 8, 28672), auth=True,
     draft="llama-3.1-8b-instruct")

# ---- DeepSeek V3 / R1 (MLA + MoE) --------------------------------------
_DEEPSEEK_V3 = {
    "architectures": ["DeepseekV3ForCausalLM"],
    "model_type": "deepseek_v3",
    "vocab_size": 129280,
    "hidden_size": 7168,
    "num_hidden_layers": 61,
    "num_attention_heads": 128,
    "num_key_value_heads": 128,
    "intermediate_size": 18432,
    "moe_intermediate_size": 2048,
    "n_routed_experts": 256,
    "num_experts_per_tok": 8,
    "n_shared_experts": 1,
    "first_k_dense_replace": 3,
    "kv_lora_rank": 512,
    "q_lora_rank": 1536,
    "qk_rope_head_dim": 64,
    "qk_nope_head_dim": 128,
    "v_head_dim": 128,
    "max_position_embeddings": 163840,
    "rope_theta": 10000.0,
}
_add("deepseek-r1-0528", "deepseek-ai/DeepSeek-R1-0528", _DEEPSEEK_V3, tags=("reasoning",))
_add("deepseek-v3-0324", "deepseek-ai/DeepSeek-V3-0324", _DEEPSEEK_V3)

# ---- Falcon -------------------------------------------------------------
_FALCON_7B = {
    "architectures": ["FalconForCausalLM"],
    "model_type": "falcon",
    "vocab_size": 65024,
    "hidden_size": 4544,
    "num_hidden_layers": 32,
    "num_attention_heads": 71,
    "multi_query": True,
    "intermediate_size": 18176,
    "max_position_embeddings": 2048,
    "hidden_act": "gelu",
}
_FALCON_40B = {
    "architectures": ["FalconForCausalLM"],
    "model_type": "falcon",
    "vocab_size": 65024,
    "hidden_size": 8192,
    "num_hidden_layers": 60,
    "num_attention_heads": 128,
    "num_key_value_heads": 8,
    "intermediate_size": 32768,
    "max_position_embeddings": 2048,
    "hidden_act": "gelu",
}
_add("falcon-7b", "tiiuae/falcon-7b", _FALCON_7B)
_add("falcon-7b-instruct", "tiiuae/falcon-7b-instruct", _FALCON_7B)
_add("falcon-40b", "tiiuae/falcon-40b", _FALCON_40B)
_add("falcon-40b-instruct", "tiiuae/falcon-40b-instruct", _FALCON_40B)

# ---- Mistral / Ministral ------------------------------------------------
def _mistral(vocab, hidden, layers, heads, kv, inter, max_pos=32768, theta=1000000.0, head_dim=None):
    cfg = {
        "architectures": ["MistralForCausalLM"],
        "model_type": "mistral",
        "vocab_size": vocab,
        "hidden_size": hidden,
        "num_hidden_layers": layers,
        "num_attention_heads": heads,
        "num_key_value_heads": kv,
        "intermediate_size": inter,
        "max_position_embeddings": max_pos,
        "rope_theta": theta,
        "rope_scaling": None,
    }
    if head_dim:
        cfg["head_dim"] = head_dim
    return cfg


_add("mistral-7b", "mistralai/Mistral-7B-v0.3", _mistral(32768, 4096, 32, 32, 8, 14336))
_add("mistral-7b-instruct", "mistralai/Mistral-7B-Instruct-v0.3", _mistral(32768, 4096, 32, 32, 8, 14336))
_add("ministral-3-3b-instruct", "mistralai/Ministral-3-3B-Instruct",
     _mistral(131072, 3072, 26, 32, 8, 9216, max_pos=131072, head_dim=128), tags=("approx",))
_add("ministral-3-8b-instruct", "mistralai/Ministral-3-8B-Instruct",
     _mistral(131072, 4096, 36, 32, 8, 12288, max_pos=131072, head_dim=128), tags=("approx",))
_add("ministral-3-14b-instruct", "mistralai/Ministral-3-14B-Instruct",
     _mistral(131072, 5120, 40, 40, 8, 16384, max_pos=131072, head_dim=128), tags=("approx",))
# Mistral Large 3: DeepSeek-V3-scale sparse MoE (public numbers approximate).
_add("mistral-large-3-675b-instruct", "mistralai/Mistral-Large-3-675B-Instruct",
     dict(_DEEPSEEK_V3, vocab_size=131072), tags=("approx",))

# ---- Phi ---------------------------------------------------------------
_add("phi-2", "microsoft/phi-2", {
    "architectures": ["PhiForCausalLM"],
    "model_type": "phi",
    "vocab_size": 51200,
    "hidden_size": 2560,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "intermediate_size": 10240,
    "max_position_embeddings": 2048,
    "partial_rotary_factor": 0.4,
    "hidden_act": "gelu_new",
    "layer_norm_epsilon": 1e-5,
})


def _phi3(vocab, hidden, layers, heads, kv, inter, max_pos, scaling=None, partial=1.0, tie=False):
    return {
        "architectures": ["Phi3ForCausalLM"],
        "model_type": "phi3",
        "vocab_size": vocab,
        "hidden_size": hidden,
        "num_hidden_layers": layers,
        "num_attention_heads": heads,
        "num_key_value_heads": kv,
        "intermediate_size": inter,
        "max_position_embeddings": max_pos,
        "rope_theta": 10000.0,
        "rope_scaling": scaling,
        "partial_rotary_factor": partial,
        "tie_word_embeddings": tie,
    }


_add("phi-3-mini-4k-instruct", "microsoft/Phi-3-mini-4k-instruct", _phi3(32064, 3072, 32, 32, 32, 8192, 4096))
_add("phi-3-mini-128k-instruct", "microsoft/Phi-3-mini-128k-instruct",
     _phi3(32064, 3072, 32, 32, 32, 8192, 131072, scaling={"rope_type": "longrope", "factor": 32.0}))
_add("phi-3-medium-4k-instruct", "microsoft/Phi-3-medium-4k-instruct", _phi3(32064, 5120, 40, 40, 10, 17920, 4096))
_add("phi-3-medium-128k-instruct", "microsoft/Phi-3-medium-128k-instruct",
     _phi3(32064, 5120, 40, 40, 10, 17920, 131072, scaling={"rope_type": "longrope", "factor": 32.0}))
_add("phi-3.5-mini-instruct", "microsoft/Phi-3.5-mini-instruct",
     _phi3(32064, 3072, 32, 32, 32, 8192, 131072, scaling={"rope_type": "longrope", "factor": 32.0}))
_add("phi-4-mini-instruct", "microsoft/Phi-4-mini-instruct",
     _phi3(200064, 3072, 32, 24, 8, 8192, 131072, partial=0.75, tie=True))
_add("phi-4", "microsoft/phi-4", _phi3(100352, 5120, 40, 40, 10, 17920, 16384))

# ---- Qwen 2.5 ----------------------------------------------------------
def _qwen2(vocab, hidden, layers, heads, kv, inter, max_pos=32768):
    return {
        "architectures": ["Qwen2ForCausalLM"],
        "model_type": "qwen2",
        "vocab_size": vocab,
        "hidden_size": hidden,
        "num_hidden_layers": layers,
        "num_attention_heads": heads,
        "num_key_value_heads": kv,
        "intermediate_size": inter,
        "max_position_embeddings": max_pos,
        "rope_theta": 1000000.0,
        "rms_norm_eps": 1e-6,
        "tie_word_embeddings": hidden < 2048,
    }


_add("qwen2.5-coder-7b-instruct", "Qwen/Qwen2.5-Coder-7B-Instruct", _qwen2(152064, 3584, 28, 28, 4, 18944))
_add("qwen2.5-coder-32b-instruct", "Qwen/Qwen2.5-Coder-32B-Instruct", _qwen2(152064, 5120, 64, 40, 8, 27648),
     draft="qwen2.5-coder-7b-instruct")
_add("deepseek-r1-distill-qwen-14b", "deepseek-ai/DeepSeek-R1-Distill-Qwen-14B",
     _qwen2(152064, 5120, 48, 40, 8, 13824, max_pos=131072), tags=("reasoning",))
_add("deepseek-r1-distill-llama-8b", "deepseek-ai/DeepSeek-R1-Distill-Llama-8B",
     _llama(128256, 4096, 32, 32, 8, 14336), tags=("reasoning",))

# ---- Gemma 3 -----------------------------------------------------------
def _gemma3(vocab, hidden, layers, heads, kv, head_dim, inter, qscalar, max_pos=131072):
    return {
        "architectures": ["Gemma3ForCausalLM"],
        "model_type": "gemma3_text",
        "vocab_size": vocab,
        "hidden_size": hidden,
        "num_hidden_layers": layers,
        "num_attention_heads": heads,
        "num_key_value_heads": kv,
        "head_dim": head_dim,
        "intermediate_size": inter,
        "max_position_embeddings": max_pos,
        "rope_theta": 1000000.0,
        "sliding_window": 1024,
        "sliding_window_pattern": 6,
        "query_pre_attn_scalar": qscalar,
        "hidden_activation": "gelu_pytorch_tanh",
        "rms_norm_eps": 1e-6,
        "tie_word_embeddings": True,
    }


_add("gemma-3-4b-instruct", "google/gemma-3-4b-it", _gemma3(262208, 2560, 34, 8, 4, 256, 10240, 256), auth=True)
_add("gemma-3-27b-instruct", "google/gemma-3-27b-it", _gemma3(262208, 5376, 62, 32, 16, 128, 21504, 168), auth=True)

# ---- GPT-OSS (MoE) -----------------------------------------------------
def _gpt_oss(layers, experts):
    return {
        "architectures": ["GptOssForCausalLM"],
        "model_type": "gpt_oss",
        "vocab_size": 201088,
        "hidden_size": 2880,
        "num_hidden_layers": layers,
        "num_attention_heads": 64,
        "num_key_value_heads": 8,
        "head_dim": 64,
        "intermediate_size": 2880,
        "num_local_experts": experts,
        "num_experts_per_tok": 4,
        "max_position_embeddings": 131072,
        "rope_theta": 150000.0,
        "sliding_window": 128,
        "quantization_config": {"quant_method": "mxfp4"},
    }


_add("gpt-oss-20b", "openai/gpt-oss-20b", _gpt_oss(24, 32), quant="mxfp4")
_add("gpt-oss-120b", "openai/gpt-oss-120b", _gpt_oss(36, 128), quant="mxfp4")

# ---- additional current-generation presets (beyond the reference's 31) --
_add("llama-3.2-1b-instruct", "meta-llama/Llama-3.2-1B-Instruct",
     {**_llama(128256, 2048, 16, 32, 8, 8192), "tie_word_embeddings": True,
      "head_dim": 64}, auth=True)
_add("llama-3.2-3b-instruct", "meta-llama/Llama-3.2-3B-Instruct",
     {**_llama(128256, 3072, 28, 24, 8, 8192), "tie_word_embeddings": True,
      "head_dim": 128}, auth=True)


def _qwen3(vocab, hidden, layers, heads, kv, inter, head_dim=128, max_pos=40960):
    return {
        "architectures": ["Qwen3ForCausalLM"],
        "model_type": "qwen3",
        "vocab_size": vocab,
        "hidden_size": hidden,
        "num_hidden_layers": layers,
        "num_attention_heads": heads,
        "num_key_value_heads": kv,
        "head_dim": head_dim,
        "intermediate_size": inter,
        "max_position_embeddings": max_pos,
        "rope_theta": 1000000.0,
        "rms_norm_eps": 1e-6,
    }


_add("qwen3-8b", "Qwen/Qwen3-8B", _qwen3(151936, 4096, 36, 32, 8, 12288))
_add("qwen3-32b", "Qwen/Qwen3-32B", _qwen3(151936, 5120, 64, 64, 8, 25600),
     draft="qwen3-8b")

# ---- tiny test model (not in the reference; for CI and smoke runs) -----
_add("tiny-llama-test", "kaito-tpu/tiny-llama-test",
     _llama(2048, 256, 4, 8, 4, 1024, max_pos=2048, theta=10000.0, scaling=None),
     tags=("test",))

# ---- tiny REAL model: byte-level llama trained in-repo on local prose
# (hack/train_tiny_real.py); the committed checkpoint under
# checkpoints/tiny-llama-real pins golden logprobs + held-out
# bits/byte so rope/template/quant/serving correctness has an end-task
# regression, not just unit parity -----
_add("tiny-llama-real", "kaito-tpu/tiny-llama-real",
     _llama(258, 256, 4, 8, 4, 1024, max_pos=2048, theta=10000.0,
            scaling=None),
     tags=("test", "real-checkpoint"))

# MoE sibling: same corpus/tokenizer, mixtral-style 4-expert stack —
# pins router/expert-dispatch correctness end-task alongside the dense
# goldens (checkpoints/tiny-moe-real)
_add("tiny-moe-real", "kaito-tpu/tiny-moe-real",
     {"architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
      "vocab_size": 258, "hidden_size": 128, "num_hidden_layers": 2,
      "num_attention_heads": 4, "num_key_value_heads": 2,
      "intermediate_size": 256, "num_local_experts": 4,
      "num_experts_per_tok": 2, "max_position_embeddings": 2048},
     tags=("test", "real-checkpoint"))


def register_builtin_presets() -> None:
    for md in _PRESETS:
        register_model(md, replace=True)


register_builtin_presets()
