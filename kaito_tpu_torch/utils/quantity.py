"""Kubernetes-style resource quantities (``27.31Gi``, ``500Mi``, ``2k``).

The reference passes model/storage sizes around as k8s
``resource.Quantity`` strings (e.g. ``modelFileSize: 27.31Gi`` in
``presets/workspace/models/model_catalog.yaml``).  We keep the same
serialized surface so presets and manifests round-trip, but store bytes
as an int.

A copy of ``kaito_tpu.utils.quantity``.
"""

from __future__ import annotations

import math
import re

_BINARY = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DECIMAL = {"k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18}
_QTY_RE = re.compile(r"^\s*([0-9]*\.?[0-9]+)\s*(Ki|Mi|Gi|Ti|Pi|Ei|k|M|G|T|P|E)?\s*$")


def parse_quantity(s: "str | int | float") -> int:
    """Parse a quantity string into bytes (or a bare count)."""
    if isinstance(s, (int, float)):
        return int(s)
    m = _QTY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity: {s!r}")
    value = float(m.group(1))
    suffix = m.group(2)
    if suffix is None:
        scale = 1
    elif suffix in _BINARY:
        scale = _BINARY[suffix]
    else:
        scale = _DECIMAL[suffix]
    return int(math.ceil(value * scale))


def format_quantity(n: int, binary: bool = True) -> str:
    """Render bytes as the largest clean binary suffix (2 decimals max)."""
    if n == 0:
        return "0"
    units = _BINARY if binary else _DECIMAL
    best = ""
    best_scale = 1
    for suffix, scale in units.items():
        if n >= scale and scale > best_scale:
            best, best_scale = suffix, scale
    value = n / best_scale
    if value == int(value):
        return f"{int(value)}{best}"
    return f"{value:.2f}{best}"


class Quantity:
    """A thin value type over bytes with k8s-style parsing/printing."""

    __slots__ = ("bytes",)

    def __init__(self, value: "str | int | float | Quantity"):
        if isinstance(value, Quantity):
            self.bytes = value.bytes
        else:
            self.bytes = parse_quantity(value)

    def __int__(self) -> int:
        return self.bytes

    def __eq__(self, other) -> bool:
        return int(self) == int(Quantity(other))

    def __lt__(self, other) -> bool:
        return self.bytes < Quantity(other).bytes

    def __le__(self, other) -> bool:
        return self.bytes <= Quantity(other).bytes

    def __add__(self, other) -> "Quantity":
        return Quantity(self.bytes + Quantity(other).bytes)

    def __mul__(self, factor: float) -> "Quantity":
        return Quantity(int(self.bytes * factor))

    def __repr__(self) -> str:
        return f"Quantity({format_quantity(self.bytes)})"

    def __str__(self) -> str:
        return format_quantity(self.bytes)

    def __hash__(self) -> int:
        return hash(self.bytes)
