"""LoRA: the trainable factors, the ``kaito-tpu-lora-v1`` artifact and
the merge into base weights.

Counterpart of ``kaito_tpu.tuning.lora``.  An adapter is the
``{group}/{t}_lora_a`` ([L, in, r]) and ``{group}/{t}_lora_b``
([L, r, out]) leaves of a parameter tree.  For training,
:func:`add_lora_params` puts them into the model's layer stacks as
trainable parameters, which the model's ``"train"`` mode applies at
the projection sites (``engine.nn.lora_delta``); the rest of the model
stays frozen.  An artifact is ``adapter.msgpack`` (flax's msgpack
layout, through the port's own codec ``utils.msgpack``) beside
``adapter_config.json`` (base model, rank, alpha, targets).  Artifacts
cross both ways: the JAX package loads what :func:`save_adapter`
writes, and :func:`load_adapter` reads what the JAX package saves.
Leaves come back as CPU tensors.

Two of the JAX package's choices are not copied: A is drawn from a
seeded generator with a stable per-name salt (the JAX package salts it
with Python's per-process ``hash()``), and A is kept in the model's
dtype.  ``LoraConfig.dropout`` is applied nowhere, in either package.
"""

from __future__ import annotations

import json
import math
import os
import zlib
from dataclasses import dataclass

import torch
from torch import nn as tnn

from kaito_tpu_torch.utils import msgpack

DEFAULT_TARGETS = ("q", "k", "v", "o")
ALL_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")
ADAPTER_WEIGHTS = "adapter.msgpack"
ADAPTER_CONFIG = "adapter_config.json"
ADAPTER_FORMAT = "kaito-tpu-lora-v1"


@dataclass
class LoraConfig:
    r: int = 8
    alpha: int = 16
    targets: tuple[str, ...] = DEFAULT_TARGETS
    dropout: float = 0.0     # applied by the trainer on the lora path

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


def add_lora_params(model, cfg: LoraConfig, seed: int = 0) -> None:
    """Add trainable lora factors for ``cfg.targets`` to every layer stack
    of ``model`` that has the target: ``{t}_lora_a`` [L, in, r] ~ N(0,
    1/r) and ``{t}_lora_b`` [L, r, out] = 0 (the update starts at zero),
    in the model's dtype on its device, and set ``model.lora_scaling``.
    Each A draws from its own ``torch.Generator`` seeded by ``seed`` and
    a crc32 salt of ``{group}/{t}``, so it does not depend on the
    process or the draw order."""
    gen = torch.Generator(device=model.device)
    tree = {}
    for g in model.groups:
        specs = model._layer_specs(g.moe)
        stack = {}
        for t in cfg.targets:
            if t not in specs:
                continue
            in_dim, out_dim = specs[t]
            salt = zlib.crc32(f"lora/{g.name}/{t}".encode()) & 0x7FFFFFFF
            gen.manual_seed((seed * 1_000_003 + salt) & 0x7FFF_FFFF_FFFF_FFFF)
            a = torch.empty((g.count, in_dim, cfg.r), dtype=model.dtype,
                            device=model.device).normal_(generator=gen)
            stack[f"{t}_lora_a"] = a / math.sqrt(cfg.r)
            stack[f"{t}_lora_b"] = torch.zeros((g.count, cfg.r, out_dim),
                                               dtype=model.dtype, device=model.device)
        tree[g.name] = stack
    set_lora_params(model, tree, cfg)


def set_lora_params(model, tree: dict, cfg: LoraConfig) -> None:
    """Install the lora leaves of a parameter tree (``{group: {"{t}_lora_a"
    | "{t}_lora_b": tensor}}``, other leaves ignored) into ``model``'s
    layer stacks as trainable parameters in its dtype on its device, and
    set ``model.lora_scaling``."""
    for g in model.groups:
        for name, t in tree.get(g.name, {}).items():
            if "_lora_" in name:
                model.stacks[g.name][name] = tnn.Parameter(
                    t.detach().to(device=model.device, dtype=model.dtype).clone())
    model.lora_scaling = cfg.scaling


def is_lora_path(path) -> bool:
    """Whether a leaf's key path (a sequence of keys) names a lora leaf."""
    return any("lora" in str(k) for k in path)


def lora_mask(params: dict) -> dict:
    """A tree of bools over ``params``: True for the trainable (lora)
    leaves.  A QTensor dict is one frozen leaf."""
    def walk(node, path):
        if isinstance(node, dict) and not ("q8" in node or "q4" in node):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return is_lora_path(path)

    return walk(params, ())


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    import numpy as np

    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def extract_adapter(params: dict) -> dict:
    """Only the lora leaves (the artifact shipped): ``{"a/b/c": tensor}``
    for every leaf whose key path holds "lora", in sorted key order (as
    JAX flattens a tree)."""
    out: dict = {}

    def walk(node, keys):
        if isinstance(node, dict):
            for k, v in sorted(node.items()):
                walk(v, keys + [str(k)])
        elif any("lora" in k for k in keys):
            out["/".join(keys)] = _as_tensor(node)

    walk(params, [])
    return out


def apply_adapter(params: dict, adapter: dict) -> dict:
    """Insert saved lora leaves back into a parameter tree (fresh dicts,
    shared leaves)."""
    def copy(node):
        return {k: copy(v) for k, v in node.items()} if isinstance(node, dict) else node

    out = copy(params)
    for flat_key, value in adapter.items():
        keys = flat_key.split("/")
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _as_tensor(value)
    return out


def merge_lora(model, params: dict) -> dict:
    """Fold the deltas into the base weights for serving without lora
    compute: ``W' = W + model.lora_scaling * A @ B``; the lora keys go.
    An int8 QTensor base is dequantized first (the merged weight is
    plain); an int4 base raises ValueError: the JAX package's
    ``merge_lora`` reads ``base["q8"]`` there and fails with a KeyError
    (ROADMAP queue 3)."""
    scaling = model.lora_scaling
    out = dict(params)
    for g in model.groups:
        stack = dict(out[g.name])
        for t in ALL_TARGETS:
            a = stack.pop(f"{t}_lora_a", None)
            b = stack.pop(f"{t}_lora_b", None)
            if a is None or b is None or t not in stack:
                continue
            base = stack[t]
            delta = torch.einsum("lir,lro->lio", a, b) * scaling
            if isinstance(base, dict):
                if "q8" not in base:
                    raise ValueError(
                        f"merge_lora: {g.name}.{t} is an int4 QTensor; merging an "
                        f"adapter into int4 weights is not supported")
                w = base["q8"].to(delta.dtype) * base["scale"][..., None, :]
                stack[t] = w + delta.to(w.device)
            else:
                stack[t] = base + delta.to(base.device)
        out[g.name] = stack
    return out


def save_adapter(path: str, params: dict, cfg: LoraConfig, base_model: str) -> None:
    """Write the artifact: the lora leaves of ``params`` and the config."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, ADAPTER_WEIGHTS), "wb") as f:
        f.write(msgpack.to_bytes(extract_adapter(params)))
    with open(os.path.join(path, ADAPTER_CONFIG), "w") as f:
        json.dump({"base_model": base_model, "r": cfg.r, "alpha": cfg.alpha,
                   "targets": list(cfg.targets), "format": ADAPTER_FORMAT},
                  f, indent=2)


def load_adapter(path: str) -> tuple[dict, LoraConfig, str]:
    """(flat leaves as CPU tensors, config, recorded base model)."""
    with open(os.path.join(path, ADAPTER_CONFIG)) as f:
        meta = json.load(f)
    with open(os.path.join(path, ADAPTER_WEIGHTS), "rb") as f:
        adapter = msgpack.restore(f.read())
    cfg = LoraConfig(r=meta["r"], alpha=meta["alpha"], targets=tuple(meta["targets"]))
    return adapter, cfg, meta.get("base_model", "")
