"""Kubernetes Event recording for the controller layer.

The in-process analogue of client-go's EventRecorder + correlator
(``k8s.io/client-go/tools/record``): reconcilers call
``record_event(store, obj, type, reason, message)`` on operator-visible
transitions, the recorder dedupes identical events into one entry with
a bumped ``count`` (the aggregation ``kubectl get events`` shows as
``x12``), keeps a bounded in-memory ring (the sink tests and the fake
store read), and — when constructed with a sink (anything with an
``emit(event)`` method) — mirrors each emission to it.

Event emission is strictly best-effort: a recorder failure must never
fail a reconcile, so every sink error is swallowed into a debug log.

A copy of ``kaito_tpu.k8s.events`` without its ``KubeEventSink``, the
sink that writes ``v1.Event`` objects to the API server: it comes with
the port's ``k8s/client.py`` (ROADMAP queue 1, item 1).
"""

from __future__ import annotations

import hashlib
import logging
import threading
from dataclasses import dataclass, field
from typing import Optional

from kaito_tpu_torch.api.meta import now_iso

logger = logging.getLogger(__name__)

EVENT_NORMAL = "Normal"
EVENT_WARNING = "Warning"

DEFAULT_CAPACITY = 4096


@dataclass
class Event:
    """One deduplicated event series (count >= 1)."""

    kind: str
    namespace: str
    name: str
    type: str            # "Normal" | "Warning"
    reason: str          # CamelCase, greppable (e.g. "ProvisioningStarted")
    message: str
    uid: str = ""
    count: int = 1
    first_timestamp: str = field(default_factory=now_iso)
    last_timestamp: str = field(default_factory=now_iso)

    @property
    def dedupe_key(self) -> tuple:
        return (self.kind, self.namespace, self.name, self.type,
                self.reason, self.message)

    def to_wire(self, sink_namespace: str = "default",
                component: str = "kaito-tpu-manager") -> dict:
        """``v1.Event`` wire shape (events land in the involved
        object's namespace; cluster-scoped objects fall back to the
        sink's)."""
        ns = self.namespace or sink_namespace
        stable = hashlib.sha256(
            repr(self.dedupe_key).encode()).hexdigest()[:16]
        return {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {"name": f"{self.name}.{stable}", "namespace": ns},
            "involvedObject": {"kind": self.kind, "namespace": self.namespace,
                               "name": self.name, "uid": self.uid},
            "type": self.type,
            "reason": self.reason,
            "message": self.message,
            "count": self.count,
            "firstTimestamp": self.first_timestamp,
            "lastTimestamp": self.last_timestamp,
            "source": {"component": component},
        }


class EventRecorder:
    """Deduplicating bounded recorder; optionally mirrors to a sink."""

    def __init__(self, sink=None,
                 capacity: int = DEFAULT_CAPACITY):
        self.sink = sink
        self.capacity = max(1, int(capacity))
        self._events: dict[tuple, Event] = {}   # insertion-ordered
        self._lock = threading.Lock()

    def event(self, obj, etype: str, reason: str, message: str) -> Event:
        """Record one occurrence against a typed object (anything with
        ``.kind`` and ``.metadata``)."""
        return self.eventf(obj.kind, obj.metadata.namespace,
                           obj.metadata.name, etype, reason, message,
                           uid=getattr(obj.metadata, "uid", ""))

    def eventf(self, kind: str, namespace: str, name: str, etype: str,
               reason: str, message: str, uid: str = "") -> Event:
        ev = Event(kind=kind, namespace=namespace, name=name, type=etype,
                   reason=reason, message=message, uid=uid)
        with self._lock:
            cur = self._events.get(ev.dedupe_key)
            if cur is not None:
                cur.count += 1
                cur.last_timestamp = now_iso()
                ev = cur
            else:
                self._events[ev.dedupe_key] = ev
                while len(self._events) > self.capacity:
                    self._events.pop(next(iter(self._events)))
        if self.sink is not None:
            try:
                self.sink.emit(ev)
            except Exception:
                logger.debug("event sink emit failed", exc_info=True)
        return ev

    def events(self, kind: Optional[str] = None,
               namespace: Optional[str] = None,
               name: Optional[str] = None,
               reason: Optional[str] = None) -> list[Event]:
        """Snapshot, oldest first, optionally filtered."""
        with self._lock:
            out = list(self._events.values())
        if kind is not None:
            out = [e for e in out if e.kind == kind]
        if namespace is not None:
            out = [e for e in out if e.namespace == namespace]
        if name is not None:
            out = [e for e in out if e.name == name]
        if reason is not None:
            out = [e for e in out if e.reason == reason]
        return out

    def for_object(self, obj) -> list[Event]:
        return self.events(kind=obj.kind, namespace=obj.metadata.namespace,
                           name=obj.metadata.name)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


def record_event(store, obj, etype: str, reason: str, message: str) -> None:
    """Record an event via the store's recorder, if it has one — the
    tolerant helper every reconciler/provisioner path calls (custom
    Store implementations without a recorder stay valid)."""
    rec = getattr(store, "events", None)
    if rec is None:
        return
    try:
        rec.event(obj, etype, reason, message)
    except Exception:
        logger.debug("event recording failed", exc_info=True)
