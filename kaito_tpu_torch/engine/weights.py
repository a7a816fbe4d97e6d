"""Checkpoint loading: HF safetensors -> the stacked parameter tree.

Counterpart of ``kaito_tpu.engine.weights`` for llama-style checkpoints,
dense (phi-3's fused q/k/v and gate/up included) and MoE (Mixtral's and
Qwen/DeepSeek's expert names).  HF linear weights are [out, in]; the
port keeps the JAX package's [in, out], so projections transpose on
load, and a MoE layer's per-expert tensors stack over the expert axis.
The safetensors format (an 8-byte header length, a JSON header, raw
little-endian tensor bytes) is read and written directly, so loading
needs no package beyond torch.
"""

from __future__ import annotations

import json
import logging
import os
import struct
from typing import Callable, Optional

import torch

logger = logging.getLogger(__name__)

# our layer key -> (HF suffix, transpose?)
_LAYER_MAP = {
    "attn_norm": ("input_layernorm.weight", False),
    "attn_norm_bias": ("input_layernorm.bias", False),
    "mlp_norm": ("post_attention_layernorm.weight", False),
    "mlp_norm_bias": ("post_attention_layernorm.bias", False),
    "q": ("self_attn.q_proj.weight", True),
    "k": ("self_attn.k_proj.weight", True),
    "v": ("self_attn.v_proj.weight", True),
    "o": ("self_attn.o_proj.weight", True),
    "q_bias": ("self_attn.q_proj.bias", False),
    "k_bias": ("self_attn.k_proj.bias", False),
    "v_bias": ("self_attn.v_proj.bias", False),
    "o_bias": ("self_attn.o_proj.bias", False),
    "q_norm": ("self_attn.q_norm.weight", False),
    "k_norm": ("self_attn.k_norm.weight", False),
    "gate": ("mlp.gate_proj.weight", True),
    "up": ("mlp.up_proj.weight", True),
    "down": ("mlp.down_proj.weight", True),
    "up_bias": ("mlp.up_proj.bias", False),
    "down_bias": ("mlp.down_proj.bias", False),
    "post_attn_norm": ("post_attention_layernorm.weight", False),
    "post_mlp_norm": ("post_feedforward_layernorm.weight", False),
}
# gemma-3 swaps the meaning of post_attention_layernorm: pre-MLP norm is
# pre_feedforward_layernorm
_GEMMA_OVERRIDES = {
    "mlp_norm": ("pre_feedforward_layernorm.weight", False),
    "post_attn_norm": ("post_attention_layernorm.weight", False),
}

_ST_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """All tensors of one ``.safetensors`` file, on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())     # the tensors below are views of it
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype "
                             f"{info['dtype']}")
        lo, hi = info["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        t = torch.frombuffer(data, dtype=dtype, offset=lo,
                             count=(hi - lo) // itemsize) if hi > lo \
            else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: dict[str, torch.Tensor]) -> None:
    """Write ``tensors`` (name -> CPU tensor) as one ``.safetensors``
    file, in the layout :func:`read_safetensors` reads (tensors in name
    order, the header padded to 8 bytes)."""
    names = {v: k for k, v in _ST_DTYPES.items()}
    header, blobs, off = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def _reader(directory: str) -> tuple[Callable[[str], Optional[torch.Tensor]],
                                     list[str]]:
    tensors: dict[str, torch.Tensor] = {}
    for f in sorted(os.listdir(directory)):
        if f.endswith(".safetensors"):
            tensors.update(read_safetensors(os.path.join(directory, f)))
    return tensors.get, sorted(tensors)


def load_safetensors_params(model, directory: str) -> dict:
    """Assemble the stacked param tree from HF shards on disk."""
    read, all_keys = _reader(directory)
    params = assemble_params(model, read, all_keys)
    logger.info("loaded %d tensors from %s", len(all_keys), directory)
    return params


def assemble_params(model, read: Callable[[str], Optional[torch.Tensor]],
                    all_keys: list[str]) -> dict:
    """Map HF tensors onto the stacked layout of ``model``
    (a :class:`~kaito_tpu_torch.engine.model.TransformerLM`)."""
    arch = model.arch

    def get(name: str, required: bool = True) -> Optional[torch.Tensor]:
        for prefix in ("model.", "transformer.", ""):
            t = read(prefix + name)
            if t is not None:
                return t
        if required:
            raise KeyError(f"missing tensor {name!r}; have e.g. {all_keys[:5]}")
        return None

    def pad_vocab(t: torch.Tensor) -> torch.Tensor:
        pad = model.vocab_padded - t.shape[0]
        if pad <= 0:
            return t
        return torch.cat([t, torch.zeros((pad, t.shape[1]), dtype=t.dtype)])

    params: dict = {"embed": pad_vocab(get("embed_tokens.weight")),
                    "final_norm": get("norm.weight")}
    fnb = get("norm.bias", required=False)
    if fnb is not None:
        params["final_norm_bias"] = fnb
    if not arch.tie_word_embeddings:
        head = read("lm_head.weight")
        if head is None:
            head = get("embed_tokens.weight")
        params["lm_head"] = pad_vocab(head)

    layer_map = dict(_LAYER_MAP)
    if arch.pre_post_norm:
        layer_map.update(_GEMMA_OVERRIDES)
    for g in model.groups:
        stack: dict[str, list] = {}
        for li in range(g.start, g.start + g.count):
            for key in model._layer_specs(g.moe):
                t = None
                if key in layer_map:
                    suffix, transpose = layer_map[key]
                    t = get(f"layers.{li}.{suffix}", required=False)
                    if t is not None and transpose:
                        t = t.t()
                if t is None and key in _FUSED:
                    t = _read_fused(get, arch, li, key)
                if t is None and g.moe:
                    t = _read_moe_tensor(get, arch, li, key)
                if t is None:
                    raise KeyError(f"no source tensor for layer {li} key {key!r}")
                stack.setdefault(key, []).append(t)
        params[g.name] = {k: torch.stack(v) for k, v in stack.items()}
    return params


# phi-3 checkpoints fuse q/k/v into ``self_attn.qkv_proj`` (rows q, then
# k, then v, by the head counts) and gate/up into ``mlp.gate_up_proj``
# (gate's ``intermediate_size`` rows, then up's)
_FUSED = {"q": "self_attn.qkv_proj.weight", "k": "self_attn.qkv_proj.weight",
          "v": "self_attn.qkv_proj.weight", "gate": "mlp.gate_up_proj.weight",
          "up": "mlp.gate_up_proj.weight"}


def _read_fused(get, arch, li: int, key: str) -> Optional[torch.Tensor]:
    """Layer ``li``'s ``key`` projection [in, out] cut from its fused HF
    tensor; None when the checkpoint has no fused tensor either."""
    fused = get(f"layers.{li}.{_FUSED[key]}", required=False)
    if fused is None:
        return None
    fused = fused.t()                                # HF [out, in] -> ours
    if key in ("gate", "up"):
        I = arch.intermediate_size
        return fused[:, :I] if key == "gate" else fused[:, I:]
    Hq = arch.num_heads * arch.head_dim
    Hkv = arch.num_kv_heads * arch.head_dim
    lo = {"q": 0, "k": Hq, "v": Hq + Hkv}[key]
    return fused[:, lo:lo + (Hq if key == "q" else Hkv)]


# MoE tensors do not fit the flat suffix map: HF stores one tensor per
# expert (Mixtral's ``block_sparse_moe.experts.{e}.w{1,2,3}``, Qwen's and
# DeepSeek's ``mlp.experts.{e}.{gate,up,down}_proj``); the port stacks
# them over the expert axis.  w1 = gate, w3 = up, w2 = down (Mixtral's
# numbering).
_MOE_EXPERT_SUFFIXES = {
    "experts_gate": ("w1", "gate_proj"),
    "experts_up": ("w3", "up_proj"),
    "experts_down": ("w2", "down_proj"),
}
_MOE_SHARED = {
    "shared_gate": "gate_proj",
    "shared_up": "up_proj",
    "shared_down": "down_proj",
}


def _read_moe_tensor(get, arch, li: int, key: str) -> Optional[torch.Tensor]:
    """Layer ``li``'s router [E, X], expert stack [X, in, out] or shared
    expert [in, out] under either naming; None when absent."""
    if key == "router":
        for suffix in ("block_sparse_moe.gate.weight", "mlp.gate.weight"):
            t = get(f"layers.{li}.{suffix}", required=False)
            if t is not None:
                return t.t()                         # [X, E] -> [E, X]
        return None
    if key in _MOE_EXPERT_SUFFIXES:
        mix, qwen = _MOE_EXPERT_SUFFIXES[key]
        per_expert = []
        for e in range(arch.num_experts):
            t = get(f"layers.{li}.block_sparse_moe.experts.{e}.{mix}.weight",
                    required=False)
            if t is None:
                t = get(f"layers.{li}.mlp.experts.{e}.{qwen}.weight",
                        required=False)
            if t is None:
                return None
            per_expert.append(t.t())                 # HF [out, in] -> ours
        return torch.stack(per_expert)
    if key in _MOE_SHARED:
        t = get(f"layers.{li}.mlp.shared_experts.{_MOE_SHARED[key]}.weight",
                required=False)
        return None if t is None else t.t()
    return None
