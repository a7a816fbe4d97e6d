"""Model metadata: the structural facts the planner, estimator and the
serving engine need about a model.

This is the TPU-native analogue of the reference's model registry
(``pkg/model/interface.go:33-45`` ``Model``/``PresetParam`` and the
catalog entries in ``presets/workspace/models/model_catalog.yaml``):
a preset carries enough architecture detail to (a) estimate HBM
(weights + KV-cache bytes/token), (b) plan a device mesh, and (c)
actually instantiate the model in the JAX engine — the reference only
needed (a)+(b) because vLLM owned (c).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field, replace
from typing import Optional


class AttentionKind(str, enum.Enum):
    """Attention family — drives the KV bytes/token formula (reference:
    ``presets/workspace/generator/generator.go:620`` calculateKVCacheTokenSize)."""

    MHA = "MHA"
    GQA = "GQA"
    MQA = "MQA"
    MLA = "MLA"  # DeepSeek-style latent attention: cache is kv_lora_rank+rope


@dataclass(frozen=True)
class ModelArch:
    """Engine-facing architecture description.

    One config-driven transformer implementation covers the llama /
    mistral / qwen2 / phi-3 / gemma / MoE families; the flags below are
    the union of what those need.
    """

    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    max_position_embeddings: int = 8192

    # nonlinearity / norms
    hidden_act: str = "silu"          # silu (swiglu) | gelu | gelu_tanh (geglu)
    gated_mlp: bool = True            # False: classic 2-matrix MLP (falcon, phi-2)
    rms_norm_eps: float = 1e-5
    norm_type: str = "rmsnorm"        # rmsnorm | layernorm
    norm_offset: bool = False         # gemma: weight = 1 + w
    pre_post_norm: bool = False       # gemma-2/3: extra post-attn/post-mlp norms
    parallel_residual: bool = False   # falcon/phi-2: x + attn(n(x)) + mlp(n(x))
    linear_bias: bool = False         # phi-2: biases on all projections

    # rotary embedding
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 1.0
    rope_scaling: Optional[dict] = None   # {"rope_type": "llama3"|"linear"|"yarn", ...}

    # attention details
    qk_norm: bool = False             # gemma-3 / qwen-3: RMSNorm on q and k heads
    qkv_bias: bool = False            # qwen2
    attn_logit_softcap: Optional[float] = None   # gemma-2
    final_logit_softcap: Optional[float] = None  # gemma-2
    sliding_window: Optional[int] = None
    sliding_window_pattern: Optional[int] = None  # gemma-3: 1 global per N layers
    query_pre_attn_scalar: Optional[float] = None  # gemma override for 1/sqrt(d)

    # embeddings / head
    tie_word_embeddings: bool = False
    embedding_multiplier: Optional[float] = None  # gemma scales by sqrt(hidden)

    # MoE (mixtral/deepseek/gpt-oss style); dense model if num_experts == 0
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: Optional[int] = None
    num_shared_experts: int = 0
    moe_layer_start: int = 0          # deepseek: first k layers dense

    # MLA (deepseek v2/v3)
    kv_lora_rank: Optional[int] = None
    q_lora_rank: Optional[int] = None
    qk_rope_head_dim: Optional[int] = None
    qk_nope_head_dim: Optional[int] = None
    v_head_dim: Optional[int] = None

    @property
    def kv_cache_heads(self) -> int:
        """Head count of the KV cache: MLA caches ONE shared latent."""
        return 1 if self.attention_kind == AttentionKind.MLA else self.num_kv_heads

    @property
    def kv_cache_dim(self) -> int:
        """Per-head cache dim: MLA caches [kv_lora_rank + rope] latents."""
        if self.attention_kind == AttentionKind.MLA:
            return (self.kv_lora_rank or 0) + (self.qk_rope_head_dim or 0)
        return self.head_dim

    @property
    def attention_kind(self) -> AttentionKind:
        if self.kv_lora_rank:
            return AttentionKind.MLA
        if self.num_kv_heads == 1:
            return AttentionKind.MQA
        if self.num_kv_heads < self.num_heads:
            return AttentionKind.GQA
        return AttentionKind.MHA

    def param_count(self) -> int:
        """Estimate total parameter count from the architecture."""
        h = self.hidden_size
        embed = self.vocab_size * h * (1 if self.tie_word_embeddings else 2)
        if self.attention_kind == AttentionKind.MLA:
            # q: h->q_lora->heads*(nope+rope); kv: h->kv_lora(+rope); o
            qk = (self.qk_nope_head_dim or 0) + (self.qk_rope_head_dim or 0)
            q_in = self.q_lora_rank or h
            attn = (
                (h * q_in if self.q_lora_rank else 0)
                + q_in * self.num_heads * qk
                + h * ((self.kv_lora_rank or 0) + (self.qk_rope_head_dim or 0))
                + (self.kv_lora_rank or 0) * self.num_heads * ((self.qk_nope_head_dim or 0) + (self.v_head_dim or 0))
                + self.num_heads * (self.v_head_dim or 0) * h
            )
        else:
            attn = h * self.num_heads * self.head_dim + 2 * h * self.num_kv_heads * self.head_dim + self.num_heads * self.head_dim * h
        if self.num_experts > 0:
            inter = self.moe_intermediate_size or self.intermediate_size
            experts = self.num_experts + self.num_shared_experts
            mlp_moe = 3 * h * inter * experts + h * self.num_experts
            dense_layers = self.moe_layer_start
            moe_layers = self.num_layers - dense_layers
            mlp_total = moe_layers * mlp_moe + dense_layers * 3 * h * self.intermediate_size
        else:
            mlp_total = self.num_layers * 3 * h * self.intermediate_size
        norms = self.num_layers * 2 * h + h
        return embed + self.num_layers * attn + mlp_total + norms

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache bytes per token across all layers.

        GQA formula matches the reference
        (``pkg/model/interface.go:217``): ``2*layers*kv_heads*head_dim*dtype``.
        MLA caches the compressed latent + rope key instead.
        """
        if self.attention_kind == AttentionKind.MLA:
            per_layer = (self.kv_lora_rank or 0) + (self.qk_rope_head_dim or 0)
            return self.num_layers * per_layer * dtype_bytes
        return 2 * self.num_layers * self.num_kv_heads * self.head_dim * dtype_bytes


@dataclass(frozen=True)
class ModelMetadata:
    """A registered model preset (reference: one entry of
    ``model_catalog.yaml`` + ``PresetParam``)."""

    name: str                      # preset name, e.g. "llama-3.1-8b-instruct"
    hf_id: str                     # huggingface repo id
    arch: ModelArch
    weights_dtype_bytes: int = 2   # bf16 on TPU
    model_file_bytes: int = 0      # on-disk safetensors size; 0 = derive
    token_limit: int = 0           # max context; 0 = arch.max_position_embeddings
    download_auth_required: bool = False
    quantization: str = ""         # "", "int8", "mxfp4", ...
    tool_call_parser: str = ""
    reasoning_parser: str = ""
    chat_template: str = ""        # chat template preset name
    tags: tuple[str, ...] = ()
    # "engine" = the first-party JAX engine; "transformers" = the HF
    # fallback runtime for long-tail architectures (reference:
    # RuntimeName in pkg/model/interface.go + the text-generation
    # transformers runtime)
    runtime: str = "engine"
    # default draft preset for two-model speculative decoding; "" = no
    # curated pairing.  Resolved by the `kaito-tpu.io/speculative-draft:
    # auto` annotation; serving stays non-speculative unless asked
    speculative_draft: str = ""

    @property
    def file_bytes(self) -> int:
        if self.model_file_bytes:
            return self.model_file_bytes
        return self.arch.param_count() * self.weights_dtype_bytes

    @property
    def max_model_len(self) -> int:
        return self.token_limit or self.arch.max_position_embeddings

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        return self.arch.kv_bytes_per_token(dtype_bytes)

    def disk_storage_bytes(self) -> int:
        """Provisioned disk for weights: expand for download+load headroom,
        matching the reference's sizing rule (generator.go: size*2.5 + margin,
        rounded up to 10Gi steps)."""
        GiB = 2**30
        raw = int(self.file_bytes * 2.5) + 48 * GiB
        step = 10 * GiB
        return int(math.ceil(raw / step) * step)

    def with_overrides(self, **kw) -> "ModelMetadata":
        return replace(self, **kw)
