"""LoRA adapter artifacts: the ``kaito-tpu-lora-v1`` format and the
merge into base weights.

Counterpart of the artifact part of ``kaito_tpu.tuning.lora``: an
adapter is the ``{group}/{t}_lora_a`` ([L, in, r]) and
``{group}/{t}_lora_b`` ([L, r, out]) leaves of a parameter tree, saved
as ``adapter.msgpack`` (flax's msgpack layout, through the port's own
codec ``utils.msgpack``) beside ``adapter_config.json`` (base model,
rank, alpha, targets).  Artifacts cross both ways: the JAX package
loads what :func:`save_adapter` writes, and :func:`load_adapter` reads
what the JAX package saves.  Leaves come back as CPU tensors.

Training (``add_lora_params``, ``lora_mask``) is not ported yet
(ROADMAP queue 1, M21).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import torch

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
