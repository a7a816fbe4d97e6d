"""Serving-side LoRA adapter loading at boot.

Counterpart of ``kaito_tpu.engine.adapters``: the engine scans the
adapter directory and loads every adapter (``tuning.lora`` format) into
stacked per-target lanes ``[L, n_adapters + 1, in, r_max]`` that the
layer loop reads (``model.TransformerLM.lora``), so each request picks
its adapter by lane at run time (lane 0 is the base's zeros).  Requests
choose an adapter with the ``model`` field.  ``apply_adapters_to_params``
(merge into the base weights) serves adapters on a model without sites
(MLA).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from kaito_tpu_torch.tuning.lora import apply_adapter, load_adapter, merge_lora

logger = logging.getLogger(__name__)


def discover_adapters(adapters_dir: str) -> dict[str, str]:
    """Find adapters: subdirectories holding an adapter config."""
    found: dict[str, str] = {}
    if not adapters_dir or not os.path.isdir(adapters_dir):
        return found
    for name in sorted(os.listdir(adapters_dir)):
        path = os.path.join(adapters_dir, name)
        if os.path.isdir(path) and (
            os.path.exists(os.path.join(path, "adapter_config.json"))
            or os.path.exists(os.path.join(path, "adapter.msgpack"))
        ):
            found[name] = path
    return found


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def load_adapter_stacks(model, adapters_dir: str, base_model: str = "",
                        allow_base_mismatch: bool = False,
                        refusals: Optional[dict] = None) -> tuple[dict, dict]:
    """The boot-time stacked lanes.

    Returns ``(serve_lora, name_to_index)``: ``{group: {f"{t}_a": [L,
    n+1, in, rmax], f"{t}_b": [L, n+1, rmax, out]}}`` CPU tensors in the
    model's dtype (lane 0 zeros; alpha/r folded into B in fp32 before
    the cast) and each adapter's lane.  Empty dicts when nothing loads.

    An unreadable adapter is skipped and counted under ``"unreadable"``
    in ``refusals``; one whose recorded base disagrees with the served
    model under ``"base_mismatch"``, unless ``allow_base_mismatch``.  An
    MLA model has no sites and answers empty."""
    def _count(reason: str) -> None:
        if refusals is not None:
            refusals[reason] = refusals.get(reason, 0) + 1

    if model.is_mla:
        if discover_adapters(adapters_dir):
            logger.warning("per-request adapters are not supported on MLA "
                           "models; adapters in %s are merged instead", adapters_dir)
        return {}, {}
    loaded = []
    for name, path in discover_adapters(adapters_dir).items():
        try:
            adapter, cfg, base = load_adapter(path)
        except Exception:
            logger.exception("skipping unreadable adapter %s", name)
            _count("unreadable")
            continue
        if base and base_model and base != base_model:
            if not allow_base_mismatch:
                logger.warning(
                    "refusing adapter %s: targets base %s, serving %s (pass "
                    "--adapter-allow-base-mismatch to serve it anyway)",
                    name, base, base_model)
                _count("base_mismatch")
                continue
            logger.warning("adapter %s targets base %s, serving %s (allowed by "
                           "--adapter-allow-base-mismatch)", name, base, base_model)
        loaded.append((name, adapter, cfg))
    if not loaded:
        return {}, {}

    rmax = max(cfg.r for _, _, cfg in loaded)
    n = len(loaded)
    serve_lora: dict = {}
    for g in model.groups:
        group_buf: dict = {}
        for t, (in_dim, out_dim) in model.lora_specs().get(g.name, {}).items():
            key_a, key_b = f"{g.name}/{t}_lora_a", f"{g.name}/{t}_lora_b"
            if not any(key_a in ad for _, ad, _ in loaded):
                continue
            A = np.zeros((g.count, n + 1, in_dim, rmax), np.float32)
            B = np.zeros((g.count, n + 1, rmax, out_dim), np.float32)
            for i, (_, ad, cfg) in enumerate(loaded):
                if key_a not in ad:
                    continue
                a, b = _f32(ad[key_a]), _f32(ad[key_b])     # [L, in, r], [L, r, out]
                A[:, i + 1, :, :a.shape[-1]] = a
                B[:, i + 1, :b.shape[1], :] = b * cfg.scaling
            group_buf[f"{t}_a"] = torch.from_numpy(A).to(model.dtype)
            group_buf[f"{t}_b"] = torch.from_numpy(B).to(model.dtype)
        if group_buf:
            serve_lora[g.name] = group_buf
    if not serve_lora:
        logger.warning("adapters in %s carry no per-request-servable targets",
                       adapters_dir)
        return {}, {}
    name_to_index = {name: i + 1 for i, (name, _, _) in enumerate(loaded)}
    logger.info("loaded %d adapters for per-request serving: %s (rmax=%d)",
                n, list(name_to_index), rmax)
    return serve_lora, name_to_index


def apply_adapters_to_params(model, params: dict, adapters_dir: str) -> dict:
    """Load every adapter of the directory and merge it into the base
    weights (``tuning.lora.merge_lora``); several merge additively."""
    for name, path in discover_adapters(adapters_dir).items():
        try:
            adapter, cfg, base = load_adapter(path)
        except Exception:
            logger.exception("skipping unreadable adapter %s", name)
            continue
        logger.info("merging adapter %s (base %s, r=%d)", name, base, cfg.r)
        params = apply_adapter(params, adapter)
        model.lora_scaling = cfg.scaling
        params = merge_lora(model, params)
    return params
