"""Seeded LoRA adapter artifacts for the port's multi-LoRA tests.

``make_adapter`` writes a ``kaito-tpu-lora-v1`` directory through the
JAX package's ``save_adapter``: A and B of every chosen target drawn
with numpy from the seed (B nonzero, so the adapter changes the
output), shaped from the JAX model's layer specs."""

import numpy as np

ALL = ("q", "k", "v", "o", "gate", "up", "down")


def adapter_leaves(arch, seed: int, r: int = 4, targets=ALL, scale: float = 0.5,
                   moe: bool = False) -> dict:
    """{"dense": {f"{t}_lora_a": [L, in, r], f"{t}_lora_b": [L, r, out]}} fp32."""
    import jax.numpy as jnp

    from kaito_tpu.engine.model import TransformerLM

    model = TransformerLM(arch, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    out = {}
    for g in model.groups:
        specs = model._layer_specs(g.moe)
        stack = {}
        for t in targets:
            if t not in specs:
                continue
            i, o = specs[t][0]
            stack[f"{t}_lora_a"] = (rng.standard_normal((g.count, i, r))
                                    / np.sqrt(i)).astype(np.float32)
            stack[f"{t}_lora_b"] = (scale * rng.standard_normal((g.count, r, o))
                                    / np.sqrt(r)).astype(np.float32)
        out[g.name] = stack
    return out


def make_adapter(path, arch, seed: int, r: int = 4, alpha: int = 8, targets=ALL,
                 base: str = "tiny-llama-test", scale: float = 0.5) -> None:
    from kaito_tpu.tuning.lora import LoraConfig, save_adapter

    save_adapter(str(path), adapter_leaves(arch, seed, r, targets, scale),
                 LoraConfig(r=r, alpha=alpha, targets=tuple(targets)), base)
