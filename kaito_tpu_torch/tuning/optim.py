"""The tuner's optimizer: optax's transformations in torch ops.

The JAX trainer runs ``optax.chain(optax.clip_by_global_norm(1.0),
optax.adamw(optax.warmup_cosine_decay_schedule(...), weight_decay=wd))``.
This module writes those pieces in torch with optax's arithmetic and
order, so that a step updates the trainable leaves as optax does:

- a transformation is a pair of functions over a list of tensors (the
  trainable leaves, in one fixed order): ``init(params) -> state`` and
  ``update(updates, state, params) -> (updates, state)``;
- :func:`clip_by_global_norm` scales every update by ``max_norm / norm``
  when the global norm is not below ``max_norm`` (a ``torch.where`` on
  the device, no host read);
- :func:`scale_by_adam` keeps the moments in the parameters' dtype,
  corrects their bias at ``count + 1`` (``1 - b ** count`` in fp32, cast
  to the moment's dtype) and puts ``eps`` outside the square root;
- :func:`add_decayed_weights` adds ``weight_decay * param`` (decoupled
  decay, before the learning rate);
- :func:`scale_by_learning_rate` multiplies by ``-schedule(count)``,
  read at the count BEFORE the update: the first step of a warmup that
  starts at 0 moves nothing.

Counts are Python ints and scalars are made on the host in fp32, so a
step reads nothing back from the card.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

Schedule = Callable[[int], torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``):
    each leaf's sum in its dtype, the leaves summed in order."""
    return torch.sqrt(sum(torch.sum(t.square()) for t in tensors))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        return [torch.where(trigger, t, (t / g_norm.to(t.dtype)) * max_norm)
                for t in updates], state

    return GradientTransformation(lambda params: {}, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(updates, state, params=None):
        mu = [(1 - b1) * g + b1 * m for g, m in zip(updates, state["mu"])]
        nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(updates, state["nu"])]
        count = state["count"] + 1
        # fp32 pow with a float exponent, as XLA computes b ** count: near
        # 1 - b2 ** count's cancellation a repeated product differs
        bc1 = 1 - torch.pow(_f32(b1), _f32(count))
        bc2 = 1 - torch.pow(_f32(b2), _f32(count))
        out = [(m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype)) + eps)
               for m, v in zip(mu, nu)]
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float = 0.0) -> GradientTransformation:
    def update(updates, state, params=None):
        return [g + weight_decay * p for g, p in zip(updates, params)], state

    return GradientTransformation(lambda params: {}, update)


def scale_by_learning_rate(schedule: Schedule) -> GradientTransformation:
    """Multiply by ``-schedule(count)``, the count before this update."""
    def init(params):
        return {"count": 0}

    def update(updates, state, params=None):
        step = -1 * schedule(state["count"])
        return ([step.to(g.dtype) * g for g in updates],
                {"count": state["count"] + 1})

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def adamw(schedule: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """``optax.adamw`` over a learning-rate schedule: Adam, then decoupled
    weight decay, then the learning rate."""
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(schedule))


def apply_updates(params, updates) -> None:
    """``param += update`` in place, in the parameter's dtype."""
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u.to(p.dtype))


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """``optax.linear_schedule``: from ``init_value`` to ``end_value`` over
    ``transition_steps`` counts, then held."""
    if transition_steps <= 0:
        return lambda count: _f32(init_value)

    def schedule(count: int) -> torch.Tensor:
        c = min(max(count, 0), transition_steps)
        frac = 1 - _f32(c) / _f32(transition_steps)
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0, exponent: float = 1.0) -> Schedule:
    """``optax.cosine_decay_schedule``."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs decay_steps > 0, got "
                         f"{decay_steps}")

    def schedule(count: int) -> torch.Tensor:
        c = _f32(min(count, decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / float(decay_steps)))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine to
    ``end_value`` at ``decay_steps`` (warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha,
                                  exponent)

    def schedule(count: int) -> torch.Tensor:
        return warmup(count) if count < warmup_steps else decay(count - warmup_steps)

    return schedule


def trainer_optimizer(learning_rate: float, warmup_steps: int,
                      max_steps: Optional[int], weight_decay: float
                      ) -> GradientTransformation:
    """The JAX trainer's chain: clip at global norm 1.0, then AdamW over
    a warmup-cosine schedule from 0 to ``learning_rate`` that decays
    over ``max(max_steps or 1000, warmup_steps + 1)`` counts."""
    schedule = warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps, max(max_steps or 1000, warmup_steps + 1))
    return chain(clip_by_global_norm(1.0),
                 adamw(schedule, weight_decay=weight_decay))
