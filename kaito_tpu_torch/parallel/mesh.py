"""The device mesh of a tensor-parallel engine.

Counterpart of ``kaito_tpu.parallel.mesh.build_mesh`` and the part of
``kaito_tpu.parallel.plan.MeshSpec`` a tensor-only mesh needs.  One
process drives every device of the mesh, as one JAX process drives its
mesh: the model holds one shard per device of the ``tensor`` axis, runs
the shards in lockstep, and a ring hop is a copy to the next device (a
peer copy over NVLink between two cards; nothing when two mesh slots
map onto one device).

A mesh may repeat a device only when the caller lists its devices:
``build_mesh(tensor=2, devices=["cuda:0", "cuda:0"])`` runs both shards
on one card, and ``devices=["cpu", "cpu"]`` on the CPU, as the tests do.
Without a list, ``build_mesh(tensor=n)`` takes ``cuda:0`` ..
``cuda:n-1`` and raises when fewer cards are visible.  No environment
variable changes this.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from kaito_tpu_torch.device import resolve_device

AXIS_TENSOR = "tensor"


class Mesh:
    """Named axes over an ordered list of devices (row-major), like a
    ``jax.sharding.Mesh``; ``shape`` maps each axis name to its size."""

    def __init__(self, devices: Sequence[torch.device],
                 axes: Sequence[tuple[str, int]]):
        self.devices = [torch.device(d) for d in devices]
        self.axes = tuple((str(n), int(s)) for n, s in axes)
        size = 1
        for _, s in self.axes:
            size *= s
        if size != len(self.devices):
            raise ValueError(f"mesh axes {self.axes} want {size} devices, "
                             f"got {len(self.devices)}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    @property
    def shared(self) -> bool:
        """Whether two mesh slots map onto one device."""
        return len(set(self.devices)) < len(self.devices)

    def __repr__(self) -> str:
        names = "x".join(f"{n}:{s}" for n, s in self.axes)
        return f"Mesh({names} over {[str(d) for d in self.devices]})"


def build_mesh(tensor: int,
               devices: Optional[Sequence[str | torch.device]] = None) -> Mesh:
    """A ``tensor``-axis mesh.  ``devices`` lists one device per slot
    (repeats allowed); by default the first ``tensor`` CUDA devices,
    which raises when fewer are visible."""
    if tensor < 1:
        raise ValueError(f"tensor axis size must be >= 1, got {tensor}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < tensor:
            raise ValueError(
                f"tensor_parallel={tensor} but only {have} CUDA devices are "
                f"visible; pass the mesh's devices explicitly to place "
                f"several shards on one device")
        devices = [f"cuda:{i}" for i in range(tensor)]
    devices = [resolve_device(d) for d in devices]
    if len(devices) != tensor:
        raise ValueError(f"tensor={tensor} needs {tensor} devices, got "
                         f"{len(devices)}")
    return Mesh(devices, ((AXIS_TENSOR, tensor),))
