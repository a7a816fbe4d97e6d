"""The training step.

Counterpart of ``kaito_tpu.tuning.train_step`` (and of the JAX
trainer's own step): the forward over ``tokens[:, :-1]``, the masked
next-token cross-entropy against ``tokens[:, 1:]``, gradients of the
trainable leaves only (the parameters with ``requires_grad``; a frozen
int8 base never meets autograd), the optimizer's update applied in
place, and ``{"loss", "grad_norm"}`` (the norm before clipping).
Nothing reads back from the card inside a step.

One device only: the JAX package's mesh helpers (``param_shardings``,
``shard_train_state``, ``data_sharding``) wait for the port's
multi-card training (ROADMAP, M19).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from kaito_tpu_torch.tuning.optim import (GradientTransformation, apply_updates,
                                          global_norm)


@dataclass
class TrainState:
    params: list          # the trainable leaves, in trainable_leaves order
    opt_state: object
    step: int


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Masked mean next-token NLL.  logits [B, T, V] fp32; targets and
    mask [B, T]; the denominator is clamped at 1."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def flat_leaves(tree: dict, path: tuple = ()):
    """(``a/b/c`` path, leaf) of a nested dict in the JAX package's
    flatten order (keys sorted at every level)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from flat_leaves(v, path + (k,))
        else:
            yield "/".join(path + (k,)), v


def trainable_leaves(model) -> list[tuple[str, torch.Tensor]]:
    """(path, parameter) of every parameter of ``model`` that needs a
    gradient, in flatten order."""
    return [(n, t) for n, t in flat_leaves(model.param_tree()) if t.requires_grad]


def _loss(model, batch) -> torch.Tensor:
    tokens = batch["tokens"]
    logits = model.forward_train(tokens[:, :-1])
    return cross_entropy_loss(logits, tokens[:, 1:], batch["mask"])


def loss_and_grads(model, batch, params: list) -> tuple[torch.Tensor, list]:
    """The step's loss and the gradients of ``params`` (zeros for a leaf
    the forward does not reach)."""
    with torch.enable_grad():
        loss = _loss(model, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), list(grads)


def make_train_step(model, optimizer: GradientTransformation):
    """The ``(state, batch) -> (state, metrics)`` step.  batch:
    ``{"tokens": [B, T+1] int, "mask": [B, T] float}`` on the model's
    device; ``state.params`` are the model's trainable leaves, updated in
    place.  A leaf the forward does not reach gets a zero gradient."""

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, grads = loss_and_grads(model, batch, state.params)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        apply_updates(state.params, updates)
        return (TrainState(params=state.params, opt_state=opt_state,
                           step=state.step + 1),
                {"loss": loss, "grad_norm": global_norm(grads)})

    return step
