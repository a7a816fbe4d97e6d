"""Build :class:`ModelMetadata` from a HuggingFace ``config.json`` dict.

The TPU-native analogue of the reference's preset auto-generator
(``presets/workspace/generator/generator.go:805`` GeneratePreset): the
reference queries the HF Hub at reconcile time for safetensors sizes and
``config.json`` and derives ``bytesPerToken``/``modelFileSize``; we do
the same derivation from a config dict.  Network fetch is injected by
the caller (the controller can mount a config or use a hub client), so
this module stays pure and unit-testable.
"""

from __future__ import annotations

from typing import Mapping, Optional

from kaito_tpu_torch.models.metadata import ModelArch, ModelMetadata

# Architectures we can instantiate in the engine.  The analogue of the
# reference's vLLM arch allowlist (presets/workspace/models/
# vllm_model_arch_list.txt) — ours is what the config-driven JAX
# transformer supports.
SUPPORTED_ARCHITECTURES = {
    "LlamaForCausalLM",
    "MistralForCausalLM",
    "Qwen2ForCausalLM",
    "Qwen3ForCausalLM",
    "Phi3ForCausalLM",
    "PhiForCausalLM",
    "Gemma2ForCausalLM",
    "Gemma3ForCausalLM",
    "Gemma3ForConditionalGeneration",
    "MixtralForCausalLM",
    "DeepseekV2ForCausalLM",
    "DeepseekV3ForCausalLM",
    "FalconForCausalLM",
    "GptOssForCausalLM",
}


def _first(cfg: Mapping, *keys, default=None):
    for k in keys:
        if k in cfg and cfg[k] is not None:
            return cfg[k]
    return default


def arch_from_hf_config(cfg: Mapping) -> ModelArch:
    """Map a HF ``config.json`` dict onto :class:`ModelArch`."""
    # gemma-3 multimodal nests the LM under text_config
    if "text_config" in cfg and "num_hidden_layers" not in cfg:
        inner = dict(cfg["text_config"])
        inner.setdefault("architectures", cfg.get("architectures"))
        inner.setdefault("model_type", cfg.get("model_type"))
        cfg = inner

    archs = cfg.get("architectures") or []
    arch_name = archs[0] if archs else cfg.get("model_type", "")
    model_type = cfg.get("model_type", "").lower()

    hidden = int(_first(cfg, "hidden_size", "n_embd", default=0))
    layers = int(_first(cfg, "num_hidden_layers", "n_layer", default=0))
    heads = int(_first(cfg, "num_attention_heads", "n_head", default=0))
    kv_heads = int(_first(cfg, "num_key_value_heads", "num_kv_heads", default=heads) or heads)
    head_dim = int(_first(cfg, "head_dim", default=0) or (hidden // max(heads, 1)))
    inter = int(_first(cfg, "intermediate_size", "ffn_hidden_size", default=4 * hidden))
    vocab = int(_first(cfg, "vocab_size", default=32000))
    max_pos = int(_first(cfg, "max_position_embeddings", "n_positions", default=8192))

    act = str(_first(cfg, "hidden_act", "hidden_activation", "activation_function", default="silu"))
    if act in ("gelu_new", "gelu_fast", "gelu_pytorch_tanh"):
        act = "gelu_tanh"

    kw = dict(
        vocab_size=vocab,
        hidden_size=hidden,
        num_layers=layers,
        num_heads=heads,
        num_kv_heads=kv_heads,
        head_dim=head_dim,
        intermediate_size=inter,
        max_position_embeddings=max_pos,
        hidden_act=act,
        rms_norm_eps=float(_first(cfg, "rms_norm_eps", "layer_norm_epsilon", default=1e-5)),
        rope_theta=float(_first(cfg, "rope_theta", default=10000.0)),
        partial_rotary_factor=float(_first(cfg, "partial_rotary_factor", default=1.0)),
        rope_scaling=cfg.get("rope_scaling"),
        tie_word_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        sliding_window=cfg.get("sliding_window"),
        qkv_bias=bool(_first(cfg, "attention_bias", "qkv_bias", default=False)),
    )

    if model_type in ("gemma", "gemma2", "gemma3", "gemma3_text"):
        kw.update(
            norm_offset=True,
            embedding_multiplier=hidden ** 0.5,
            query_pre_attn_scalar=float(_first(cfg, "query_pre_attn_scalar", default=head_dim)),
        )
        if model_type in ("gemma2", "gemma3", "gemma3_text"):
            kw["pre_post_norm"] = True
        if model_type == "gemma2":
            kw["attn_logit_softcap"] = _first(cfg, "attn_logit_softcapping", default=50.0)
            kw["final_logit_softcap"] = _first(cfg, "final_logit_softcapping", default=30.0)
        if model_type in ("gemma3", "gemma3_text"):
            kw["sliding_window_pattern"] = int(_first(cfg, "sliding_window_pattern", default=6))
            kw["qk_norm"] = True

    if model_type == "qwen2":
        kw["qkv_bias"] = True
    if model_type == "qwen3":
        kw["qk_norm"] = True

    if model_type in ("mixtral",):
        kw.update(
            num_experts=int(_first(cfg, "num_local_experts", default=8)),
            num_experts_per_tok=int(_first(cfg, "num_experts_per_tok", default=2)),
        )

    if model_type in ("gpt_oss",):
        kw.update(
            num_experts=int(_first(cfg, "num_local_experts", "num_experts", default=32)),
            num_experts_per_tok=int(_first(cfg, "num_experts_per_tok", "experts_per_token", default=4)),
            moe_intermediate_size=int(_first(cfg, "intermediate_size", default=2880)),
            # gpt-oss alternates sliding/full attention layer types
            sliding_window_pattern=2,
        )

    if model_type in ("deepseek_v2", "deepseek_v3"):
        kw.update(
            num_experts=int(_first(cfg, "n_routed_experts", default=0)),
            num_experts_per_tok=int(_first(cfg, "num_experts_per_tok", default=0)),
            moe_intermediate_size=_first(cfg, "moe_intermediate_size"),
            num_shared_experts=int(_first(cfg, "n_shared_experts", default=0)),
            moe_layer_start=int(_first(cfg, "first_k_dense_replace", default=0)),
            kv_lora_rank=_first(cfg, "kv_lora_rank"),
            q_lora_rank=_first(cfg, "q_lora_rank"),
            qk_rope_head_dim=_first(cfg, "qk_rope_head_dim"),
            qk_nope_head_dim=_first(cfg, "qk_nope_head_dim"),
            v_head_dim=_first(cfg, "v_head_dim"),
        )

    if model_type == "falcon":
        if bool(cfg.get("multi_query", False)) and "num_key_value_heads" not in cfg:
            kw["num_kv_heads"] = 1
        kw.update(gated_mlp=False, parallel_residual=bool(cfg.get("parallel_attn", True)),
                  norm_type="layernorm")

    if model_type == "phi":
        kw.update(gated_mlp=False, parallel_residual=True, norm_type="layernorm",
                  linear_bias=True)

    return ModelArch(**kw)


# Parser-mode derivation for generated presets (the reference's
# reasoning/tool maps, generator.go:45-160, restricted to families this
# engine serves).  The engine's chat route gates think-tag reasoning
# splitting on reasoning_parser; tool extraction is format-sniffing
# (hermes/mistral), with the parser NAME carried for contract parity.
_REASONING_BY_PREFIX = {
    "deepseek-r1": "deepseek_r1",
    "qwq-32b": "deepseek_r1",
    "deepseek-v3": "deepseek_v3",
    "qwen3": "qwen3",
}
_REASONING_BY_ARCH = {
    "DeepseekV3ForCausalLM": "deepseek_v3",
    "Qwen3ForCausalLM": "qwen3",
    "GptOssForCausalLM": "openai_gptoss",
}
_TOOLS_BY_PREFIX = {
    "deepseek-r1": "deepseek_v3",
    "deepseek-v3": "deepseek_v3",
    "mistral": "mistral",
    "ministral": "mistral",
    "qwen2.5": "hermes",
    "qwen3": "hermes",
    "phi-4-mini": "phi4_mini_json",
    "llama-3": "llama3_json",
    "meta-llama-3": "llama3_json",
}
_TOOLS_BY_ARCH = {
    "MistralForCausalLM": "mistral",
    "MixtralForCausalLM": "mistral",
    "LlamaForCausalLM": "llama3_json",
    "Qwen2ForCausalLM": "hermes",
    "Qwen3ForCausalLM": "hermes",
}


def derive_parsers(name: str, archs) -> tuple[str, str]:
    """(tool_call_parser, reasoning_parser) for a model, by name prefix
    first (most specific), architecture fallback."""
    low = name.lower()
    tool = next((v for k, v in _TOOLS_BY_PREFIX.items()
                 if low.startswith(k)), "")
    reasoning = next((v for k, v in _REASONING_BY_PREFIX.items()
                      if low.startswith(k)), "")
    for a in archs or ():
        tool = tool or _TOOLS_BY_ARCH.get(a, "")
        reasoning = reasoning or _REASONING_BY_ARCH.get(a, "")
    return tool, reasoning


def metadata_from_hf_config(
    hf_id: str,
    cfg: Mapping,
    *,
    name: Optional[str] = None,
    model_file_bytes: int = 0,
    download_auth_required: bool = False,
    quantization: str = "",
    tags: tuple[str, ...] = (),
    speculative_draft: str = "",
) -> ModelMetadata:
    """Auto-generate a preset from a HF config dict (reference:
    ``GeneratePreset``, ``presets/workspace/generator/generator.go:805``)."""
    archs = cfg.get("architectures") or []
    runtime = "engine"
    if archs and not (set(archs) & SUPPORTED_ARCHITECTURES):
        # long-tail architecture: serve via the HF transformers
        # fallback runtime (reference: the text-generation runtime for
        # models vLLM can't serve) — the generic ModelArch extraction
        # below still sizes capacity planning
        runtime = "transformers"
    arch = arch_from_hf_config(cfg)
    if runtime == "transformers" and not (
            arch.hidden_size > 0 and arch.num_layers > 0
            and arch.num_heads > 0):
        # non-transformer config (Mamba/encoder-decoder/vision): the
        # generic dims are garbage and would drive capacity planning to
        # a too-small instance — refuse loudly instead
        raise ValueError(
            f"architecture {archs!r} for {hf_id} is not "
            f"transformer-shaped (no usable hidden/layers/heads dims); "
            f"cannot size capacity for the fallback runtime")
    quant = quantization or str(
        (cfg.get("quantization_config") or {}).get("quant_method", "")
    )
    preset_name = name or hf_id.split("/")[-1].lower()
    tool_parser, reasoning_parser = derive_parsers(
        hf_id.split("/")[-1], archs)
    return ModelMetadata(
        name=preset_name,
        hf_id=hf_id,
        arch=arch,
        model_file_bytes=model_file_bytes,
        token_limit=arch.max_position_embeddings,
        download_auth_required=download_auth_required,
        quantization=quant,
        tags=tags + (("fallback-runtime",) if runtime != "engine" else ()),
        tool_call_parser=tool_parser,
        reasoning_parser=reasoning_parser,
        runtime=runtime,
        speculative_draft=speculative_draft,
    )
