"""Named fault-injection points (failpoints) for chaos testing.

The port's own copy of ``kaito_tpu/utils/failpoints.py``.  Every
interesting failure site has a stable name; tests (or an operator, via
``KAITO_FAILPOINTS``) activate a named point with an action and the
instrumented code path misbehaves exactly there (raise, delay, or
corrupt bytes) while everything around it is expected to stay healthy.

Instrumented sites of the port (grep for ``FAILPOINTS.fire`` /
``FAILPOINTS.corrupt``):

==========================  ====================================================
name                        where it fires
==========================  ====================================================
``engine.kv_import``        per slot inside ``_advance_imports`` (ctx: req_id)
``pd.export_drain``         ``StagedExport`` device-to-host drain start
``pd.chunk``                ``StagedExport.get_chunk`` payload (corrupt site)
==========================  ====================================================

Activation is programmatic (``FAILPOINTS.activate(...)`` or the
``failpoint(...)`` context manager in tests) or via the environment::

    KAITO_FAILPOINTS="engine.kv_import=raise*1;pd.chunk=corrupt"

``name=ACTION[:ARG][*COUNT]`` entries separated by ``;``.  ACTION is
``raise`` | ``delay`` | ``corrupt``; ARG is the delay in seconds or the
raise message; COUNT limits how many times the point fires (-1 =
unlimited).  Inactive failpoints cost one dict lookup.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

ENV_VAR = "KAITO_FAILPOINTS"

ACTIONS = ("raise", "delay", "corrupt")


class FailpointError(RuntimeError):
    """Raised by an active ``raise`` failpoint.  Deliberately a plain
    RuntimeError subclass: instrumented code must NOT special-case it —
    the whole point is to exercise the production error paths."""

    def __init__(self, name: str, message: str = ""):
        super().__init__(message or f"failpoint {name!r} fired")
        self.failpoint = name


@dataclass
class _Point:
    name: str
    action: str = "raise"
    arg: Any = None                       # delay seconds / raise message
    count: int = -1                       # remaining fires; -1 = unlimited
    match: Dict[str, Any] = field(default_factory=dict)
    hits: int = 0

    def matches(self, ctx: Dict[str, Any]) -> bool:
        return all(ctx.get(k) == v for k, v in self.match.items())


class FailpointRegistry:
    """Thread-safe registry of named failure-injection points."""

    def __init__(self):
        self._lock = threading.Lock()
        self._points: Dict[str, _Point] = {}
        self._hits: Dict[str, int] = {}

    # -- activation -------------------------------------------------------
    def activate(self, name: str, action: str = "raise", *,
                 arg: Any = None, count: int = -1, **match) -> None:
        """Arm ``name``.  ``match`` keys restrict firing to calls whose
        context (``fire(name, req_id=...)``) carries equal values, so a
        test can fail ONE request's KV import while its neighbours on
        the same engine proceed."""
        if action not in ACTIONS:
            raise ValueError(f"unknown failpoint action {action!r}; "
                             f"expected one of {ACTIONS}")
        with self._lock:
            self._points[name] = _Point(name=name, action=action, arg=arg,
                                        count=count, match=dict(match))

    def deactivate(self, name: str) -> None:
        with self._lock:
            self._points.pop(name, None)

    def clear(self) -> None:
        with self._lock:
            self._points.clear()
            self._hits.clear()

    def is_active(self, name: str) -> bool:
        with self._lock:
            return name in self._points

    def hits(self, name: str) -> int:
        with self._lock:
            return self._hits.get(name, 0)

    # -- firing -----------------------------------------------------------
    def _arm(self, name: str, ctx: Dict[str, Any]) -> Optional[_Point]:
        """Consume one fire of ``name`` if armed and matching."""
        with self._lock:
            p = self._points.get(name)
            if p is None or not p.matches(ctx):
                return None
            if p.count == 0:
                return None
            if p.count > 0:
                p.count -= 1
                if p.count == 0:
                    self._points.pop(name, None)
            p.hits += 1
            self._hits[name] = self._hits.get(name, 0) + 1
            return p

    def fire(self, name: str, **ctx) -> None:
        """Execute ``name`` if armed: raise FailpointError, sleep, or —
        for a ``corrupt`` point hit via ``fire`` — raise as well (bytes
        corruption needs the ``corrupt()`` entry point)."""
        if not self._points:               # fast path: nothing armed
            return
        p = self._arm(name, ctx)
        if p is None:
            return
        if p.action == "delay":
            time.sleep(float(p.arg or 0.05))
            return
        raise FailpointError(name, str(p.arg) if p.arg else "")

    def corrupt(self, name: str, data: bytes, **ctx) -> bytes:
        """Pass ``data`` through ``name``: an armed ``corrupt`` point
        flips bytes (checksum-detectable), ``delay`` sleeps, ``raise``
        raises; inactive points return the data untouched."""
        if not self._points:
            return data
        p = self._arm(name, ctx)
        if p is None:
            return data
        if p.action == "delay":
            time.sleep(float(p.arg or 0.05))
            return data
        if p.action == "raise":
            raise FailpointError(name, str(p.arg) if p.arg else "")
        if not data:
            return data
        mutated = bytearray(data)
        mutated[len(mutated) // 2] ^= 0xFF
        return bytes(mutated)

    # -- env --------------------------------------------------------------
    def load_env(self, spec: Optional[str] = None) -> None:
        """Parse ``name=action[:arg][*count]`` entries from ``spec`` (or
        the KAITO_FAILPOINTS environment variable)."""
        spec = os.environ.get(ENV_VAR, "") if spec is None else spec
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            name, _, rhs = entry.partition("=")
            rhs = rhs or "raise"
            count = -1
            if "*" in rhs:
                rhs, _, n = rhs.rpartition("*")
                count = int(n)
            action, _, arg = rhs.partition(":")
            self.activate(name.strip(), action.strip() or "raise",
                          arg=arg or None, count=count)


FAILPOINTS = FailpointRegistry()
FAILPOINTS.load_env()


@contextlib.contextmanager
def failpoint(name: str, action: str = "raise", *, arg: Any = None,
              count: int = -1, **match):
    """Scoped activation for tests: arms on entry, disarms on exit."""
    FAILPOINTS.activate(name, action, arg=arg, count=count, **match)
    try:
        yield FAILPOINTS
    finally:
        FAILPOINTS.deactivate(name)
