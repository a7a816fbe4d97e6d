"""Logical-axis sharding rules: how parameter and activation dimensions
map onto mesh axes.

Counterpart of ``kaito_tpu.parallel.sharding``.  The model names every
parameter dimension with a *logical* axis ("vocab", "heads",
"intermediate", ...); these rules map the names to mesh axes.  The JAX
package turns the result into a ``PartitionSpec`` and lets GSPMD insert
the collectives; here :meth:`PartitionRules.spec` returns a plain tuple
of mesh-axis names (``None`` for a replicated dim), which
``engine.model.shard_params`` uses to cut a full tree into per-device
shards, and the model calls the collectives itself.  The training rules
(the JAX package's ``TRAIN_RULES``) are left out: the port's trainer
(``tuning/``) runs on one card, and its mesh waits for them (ROADMAP
queue 1, item 4).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Union

AxisAssignment = Union[None, str, tuple[str, ...]]


class PartitionRules:
    """Ordered logical-name -> mesh-axis mapping."""

    def __init__(self, rules: Mapping[str, AxisAssignment]):
        self.rules = dict(rules)

    def assignment(self, logical: Optional[str]) -> AxisAssignment:
        if logical is None:
            return None
        return self.rules.get(logical)

    def spec(self, logical_axes: Sequence[Optional[str]]) -> tuple:
        return logical_to_spec(logical_axes, self)


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules: PartitionRules) -> tuple:
    """One entry per dim: the mesh axis (or tuple of axes) it is split
    over, or None.  A mesh axis shards at most one dim (the first that
    asks for it); trailing Nones are trimmed, as for a PartitionSpec."""
    parts: list[AxisAssignment] = []
    used: set[str] = set()
    for name in logical_axes:
        a = rules.assignment(name)
        if a is None:
            parts.append(None)
            continue
        axes = (a,) if isinstance(a, str) else tuple(a)
        fresh = tuple(x for x in axes if x not in used)
        used.update(fresh)
        if not fresh:
            parts.append(None)
        elif len(fresh) == 1:
            parts.append(fresh[0])
        else:
            parts.append(fresh)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


# Serving: Megatron-style TP.  Weights are sharded on the head,
# intermediate and vocab dimensions over the tensor axis; activations
# batch over data; expert stacks place over the expert axis.
SERVE_RULES = PartitionRules({
    "batch": "data",
    "vocab": "tensor",
    "embed": None,
    "heads": "tensor",
    "kv_heads": "tensor",
    "head_dim": None,
    "intermediate": "tensor",
    "expert": "expert",
    "layers": None,
    "kv_pages": None,
    "seq": None,
})

# The decode linears whose CONTRACTION axis is tensor-sharded
# (attention-out contracts "heads", MLP-down contracts "intermediate"):
# the row-parallel projections whose output all-reduce the pipelined
# ring (engine/ops/overlap_collectives.py) decomposes.
ROW_PARALLEL_CONTRACTIONS: tuple[str, ...] = ("heads", "intermediate")


def ring_axis(rules: PartitionRules,
              contractions: Sequence[str] = ROW_PARALLEL_CONTRACTIONS
              ) -> Optional[str]:
    """Mesh axis the pipelined decode collectives ring over, or None.

    The ring needs ONE mesh axis that shards every row-parallel
    contraction dim the same way.  Under SERVE_RULES that is "tensor";
    rules that split the contractions across different axes (or do not
    shard them) have no ring, and the caller keeps the unoverlapped
    path."""
    axes = set()
    for name in contractions:
        a = rules.assignment(name)
        if a is None:
            return None
        axes.update((a,) if isinstance(a, str) else tuple(a))
    if len(axes) != 1:
        return None
    return next(iter(axes))
