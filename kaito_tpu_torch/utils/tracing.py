"""Dependency-free request tracing + engine flight recorder.

The port's own copy of ``kaito_tpu/utils/tracing.py``.  Two bounded
recorders back the observability surface:

- ``RingTracer`` holds request-phase **spans** (queue wait, admission,
  prefill chunks, preemption, decode, the whole request) in a
  fixed-capacity ring — recording is a deque append under a lock held
  for nanoseconds, so the engine hot loop never blocks on a scrape.
- ``StepTimeline`` is the engine **flight recorder**: one bounded
  record per scheduler step (wall time, running/waiting, prefill vs
  decode tokens, KV page usage, preemptions, shed/expired counts).

Both export as Chrome trace-event JSON (``/debug/trace`` and
``/debug/timeline``) loadable directly in Perfetto / chrome://tracing.

Trace identity rides the ``X-Request-Id`` header end to end: the
server takes it in (or the trace id of an inbound W3C
``traceparent``), the engine stamps it on ``Request.trace_id``, and
every response echoes it.  Timestamps are ``time.monotonic()``
seconds; the Chrome export converts to microseconds, which is all
Perfetto needs (only relative time matters inside one trace).
"""

from __future__ import annotations

import collections
import re
import threading
import time
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterable, Optional

__all__ = [
    "Span", "RingTracer", "StepTimeline",
    "chrome_trace", "timeline_trace", "format_span_tree",
    "parse_traceparent", "sanitize_request_id", "make_request_id",
]

# W3C trace-context: version "00" — 00-<32 hex trace id>-<16 hex span id>-<flags>
_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-[0-9a-f]{16}-[0-9a-f]{2}$")
# characters allowed in a client-supplied request id (header-safe, log-safe)
_ID_UNSAFE_RE = re.compile(r"[^A-Za-z0-9._:\-]")
_MAX_ID_LEN = 128


def parse_traceparent(header: Optional[str]) -> Optional[str]:
    """Extract the 32-hex trace id from a W3C ``traceparent`` header,
    or None when absent/malformed (malformed headers are dropped, not
    errors — tracing must never fail a request)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m:
        return None
    tid = m.group(1)
    return tid if tid != "0" * 32 else None


def sanitize_request_id(value: Optional[str]) -> Optional[str]:
    """Clamp a client-supplied ``X-Request-Id`` to header/log-safe
    characters; None when nothing usable remains."""
    if not value:
        return None
    cleaned = _ID_UNSAFE_RE.sub("", value.strip())[:_MAX_ID_LEN]
    return cleaned or None


def make_request_id(prefix: str = "req") -> str:
    return f"{prefix}-{uuid.uuid4().hex[:16]}"


@dataclass
class Span:
    """One recorded phase: ``[t0, t0+dur]`` in monotonic seconds."""

    name: str
    trace_id: str
    t0: float
    dur: float
    attrs: dict = field(default_factory=dict)

    @property
    def t1(self) -> float:
        return self.t0 + self.dur


class RingTracer:
    """Bounded span recorder shared by the engine thread and HTTP
    handler threads.  The lock guards only a deque append / snapshot
    copy, so recording costs the hot loop effectively nothing."""

    def __init__(self, capacity: int = 8192):
        self._spans: "collections.deque[Span]" = collections.deque(
            maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        # ring-overflow evictions since start/clear: surfaced as
        # /debug/trace metadata so a missing span reads as overflow,
        # not as missing instrumentation
        self._dropped = 0

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def record(self, name: str, trace_id: str, t0: float, dur: float,
               **attrs) -> None:
        span = Span(name, trace_id, float(t0), max(0.0, float(dur)),
                    attrs or {})
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(span)

    @contextmanager
    def span(self, name: str, trace_id: str, **attrs):
        """Record the wrapped block as one span; an escaping exception
        is noted in the attrs and re-raised."""
        t0 = time.monotonic()
        try:
            yield attrs
        except BaseException as e:
            attrs["error"] = type(e).__name__
            raise
        finally:
            self.record(name, trace_id, t0, time.monotonic() - t0, **attrs)

    def spans(self, trace_id: Optional[str] = None) -> list[Span]:
        """Snapshot, oldest first; optionally filtered to one trace."""
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def chrome_trace(self, trace_id: Optional[str] = None) -> dict:
        return chrome_trace(self.spans(trace_id), dropped=self.dropped)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


def chrome_trace(spans: Iterable[Span],
                 dropped: Optional[int] = None) -> dict:
    """Chrome trace-event JSON: one complete ("X") event per span, one
    virtual thread per trace id (named via "M" metadata events), so
    Perfetto lays each request out on its own track.  ``dropped``
    (ring-overflow evictions) rides the top-level ``metadata`` key —
    Perfetto ignores it, diagnosers don't."""
    tids: dict[str, int] = {}
    events: list[dict] = []
    for s in sorted(spans, key=lambda s: (s.t0, -s.dur)):
        tid = tids.get(s.trace_id)
        if tid is None:
            tid = tids[s.trace_id] = len(tids) + 1
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": tid, "args": {"name": s.trace_id}})
        events.append({
            "name": s.name, "cat": "request", "ph": "X", "pid": 1,
            "tid": tid, "ts": int(s.t0 * 1e6), "dur": int(s.dur * 1e6),
            "args": {**s.attrs, "trace_id": s.trace_id},
        })
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if dropped is not None:
        doc["metadata"] = {"dropped": int(dropped)}
    return doc


def format_span_tree(spans: Iterable[Span]) -> str:
    """Indented text rendering of a span list, nested by interval
    containment — the slow-request log format.  Spans sort by start
    time (widest first on ties) so an enclosing "request" span parents
    its phases."""
    ordered = sorted(spans, key=lambda s: (s.t0, -s.dur))
    if not ordered:
        return "(no spans)"
    base = ordered[0].t0
    lines: list[str] = []
    stack: list[Span] = []
    for s in ordered:
        while stack and s.t1 > stack[-1].t1 + 1e-9:
            stack.pop()
        attrs = " ".join(f"{k}={v}" for k, v in s.attrs.items())
        lines.append("%s%-18s +%8.3fms %9.3fms%s" % (
            "  " * len(stack), s.name, (s.t0 - base) * 1e3, s.dur * 1e3,
            f"  [{attrs}]" if attrs else ""))
        stack.append(s)
    return "\n".join(lines)


class StepTimeline:
    """Bounded per-step flight recorder for the engine step loop."""

    def __init__(self, capacity: int = 4096):
        self._records: "collections.deque[dict]" = collections.deque(
            maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._dropped = 0

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def add(self, t0: float, dur: float, **fields) -> None:
        rec = {"ts": float(t0), "dur": max(0.0, float(dur))}
        rec.update(fields)
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self._dropped += 1
            self._records.append(rec)

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._records)

    def chrome_trace(self) -> dict:
        return timeline_trace(self.records(), dropped=self.dropped)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


def timeline_trace(records: Iterable[dict],
                   dropped: Optional[int] = None) -> dict:
    """Chrome trace-event JSON for the step timeline: an "X" slice per
    step (args carry the full record) plus "C" counter tracks for batch
    occupancy and KV page usage, so Perfetto graphs them over time.
    ``dropped`` rides ``metadata`` like chrome_trace's."""
    events: list[dict] = [
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": 0,
         "args": {"name": "engine.step"}}]
    for rec in sorted(records, key=lambda r: r.get("ts", 0.0)):
        ts = int(rec.get("ts", 0.0) * 1e6)
        events.append({
            "name": "engine.step", "cat": "engine", "ph": "X", "pid": 1,
            "tid": 0, "ts": ts, "dur": int(rec.get("dur", 0.0) * 1e6),
            "args": {k: v for k, v in rec.items() if k not in ("ts", "dur")},
        })
        events.append({"name": "batch", "ph": "C", "pid": 1, "tid": 0,
                       "ts": ts, "args": {
                           "running": rec.get("running", 0),
                           "waiting": rec.get("waiting", 0)}})
        events.append({"name": "kv_pages_used", "ph": "C", "pid": 1,
                       "tid": 0, "ts": ts,
                       "args": {"used": rec.get("kv_pages_used", 0)}})
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if dropped is not None:
        doc["metadata"] = {"dropped": int(dropped)}
    return doc
