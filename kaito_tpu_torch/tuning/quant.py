"""Weight quantization for QLoRA bases.

Counterpart of ``kaito_tpu.tuning.quant``: the dense projections of
every layer stack become per-out-channel symmetric int8 QTensors
``{"q8": int8[L, in, out], "scale": f32[L, out]}``, which
``engine.nn.linear`` routes to the fused dequant matmul (K4 for calls of
up to ``MAX_ROWS`` rows, the dequant product above that).

The arithmetic is the tuning module's, not the serving quantizer's
(``engine.quant``): the scale is ``max(absmax, 1e-8) / 127`` and the
codes ``round(w / scale)`` by true divisions (the JAX trainer quantizes
eagerly, outside ``jit``), rounded half to even and clipped to ±127, so
the codes and scales equal the JAX package's on the same weights.
"""

from __future__ import annotations

import torch
from torch import nn as tnn

QUANT_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")


def quantize_weight(w: torch.Tensor) -> dict:
    """Per-out-channel symmetric int8 over the in dim (-2):
    w [..., in, out] -> {"q8": same shape, "scale": [..., out]}."""
    w32 = w.float()
    scale = w32.abs().amax(dim=-2).clamp_min(1e-8) / 127.0
    q = torch.round(w32 / scale[..., None, :]).clamp(-127, 127).to(torch.int8)
    return {"q8": q, "scale": scale}


def dequantize_weight(qt: dict, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (qt["q8"].float() * qt["scale"][..., None, :]).to(dtype)


def quantize_base(model) -> None:
    """Quantize the dense projections (``QUANT_TARGETS``) of every layer
    stack of ``model`` in place: each plain stack moves to the model's
    QTensor stacks.  Embeddings, norms and expert stacks stay in the
    model dtype."""
    for g in model.groups:
        stack, qstack = model.stacks[g.name], model.qstacks[g.name]
        for t in QUANT_TARGETS:
            if t not in stack:
                continue
            qt = quantize_weight(stack[t].detach())
            del stack[t]
            qstack[t] = tnn.ParameterDict(
                {k: tnn.Parameter(x, requires_grad=False) for k, x in qt.items()})
