"""Sampling device profiler: continuous device-time attribution.

The port's own copy of ``kaito_tpu/engine/devprof.py`` on
``torch.profiler``.  On a configurable cadence it takes a short trace
around live engine steps, reads the chrome trace the profiler writes,
classifies every device slice into buckets, and folds the result into
the gated ``kaito:device_*`` families, ``GET /debug/device`` and the
flight recorder's bundle.

Where the JAX package reads an XPlane dump, this reads the torch
profiler's own trace (:func:`parse_torch_trace`): each kernel, memcpy
and memset becomes a device :class:`Slice` on one track per device (not
per stream, so idle means the card ran nothing), and its phase and
scope come from the ``record_function`` ranges that enclose its launch
on the host, matched by the event's ``correlation`` id.  A replayed
CUDA graph's kernels carry the ``cudaGraphLaunch``'s correlation, so
they take the range around the replay; inside the graph no Python range
reaches a kernel, and only its name classifies it.  Without a card the
host's operators stand in for device time (the CPU tests).

The engine thread opens and closes each window at a step boundary when
the sampler thread asks (:meth:`DeviceProfiler.at_step_boundary`): the
profiler records the host ranges of the thread that started it, and a
window opened there never starts or stops inside a CUDA graph capture.
A window during which the engine captured a graph is skipped: it would
show the capture, not serving.
One process-wide lock (:data:`PROFILE_LOCK`) is held by whoever traces:
the sampler's window, ``/start_profile``'s manual trace
(:class:`ManualTrace`) or a caller's own profiled reading; a window that
finds it held is counted as skipped.  The profiler's first start in a
process initializes CUDA's tracing (seconds on an H100 machine), so
:meth:`DeviceProfiler.start` takes and drops one trace on the calling
thread before the first window.  A window's trace is read and folded in
a child process (``python -m kaito_tpu_torch.engine.devprof``): a
quarter second of decode is ~70k kernel events, and parsing their JSON
in the serving process would hold the interpreter lock the engine
thread needs.

Bucket math is exact by construction: per track, slices are clipped
against the running high-water mark before bucketing, so
``sum(buckets) + idle == device wall`` without needing the trace to be
overlap-free.  Overlap percentages measure cross-track co-scheduling:
a collective slice counts as "overlapped" for the fraction of its
duration during which some *other* track runs compute.  On one card
both overlap figures are structurally 0.0.
"""
from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import queue
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from bisect import bisect_left
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from kaito_tpu_torch.engine.metrics import Histogram

logger = logging.getLogger(__name__)

BUCKETS = ("matmul", "attention", "collective", "copy", "other", "idle")

#: Engine phases marked with ``record_function("kaito/<phase>")`` around
#: each dispatch (``phase_scope`` below; engine.py / spec.py).  A device
#: slice lands in the phase of the range that encloses its launch.
#: ``kv_import`` stays at 0 until P/D is ported.
PHASES = ("decode", "prefill", "prefill_packed", "verify", "draft",
          "kv_import")

_PHASE_RE = re.compile(r"kaito/([a-z_]+)")

# The JAX package's ordered rule table, needles and order unchanged.
# First match wins; collectives outrank everything (a fused
# all-reduce+add must count as comm), copies next, then attention
# (scope- or kernel-named), then dense math, else other.
OP_RULES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("collective", ("all-reduce", "allreduce", "reduce-scatter",
                    "reducescatter", "all-gather", "allgather",
                    "all-to-all", "alltoall", "collective-permute",
                    "collectivepermute", "ppermute", "psum",
                    "send", "recv")),
    ("copy", ("copy", "memcpy", "h2d", "d2h", "dma", "infeed",
              "outfeed", "transfer")),
    ("attention", ("attention", "attn", "flash", "softmax")),
    ("matmul", ("dot", "conv", "einsum", "matmul", "gemm")),
)

# The port's own names.  Ahead of the JAX table: NCCL kernels, the
# memory engines' copies and fills, and the port's attention kernels
# (``decode_tc_kernel`` / ``decode_fp32_kernel`` of K1/K1q match no JAX
# needle).  Behind it: the library GEMMs (cuBLAS / cuBLASLt's Hopper
# ``nvjet_*`` kernels, CUTLASS, xmma) and, on the CPU, the aten matmul
# operators, so that a GEMM launched inside an ``attention`` range still
# counts as attention, as a dot under the JAX package's attention scope
# does.  No name the JAX table buckets changes bucket.
PORT_RULES_FIRST: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("collective", ("nccldevkernel", "ncclkernel")),
    ("copy", ("memcpy", "memset")),
    ("attention", ("decode_tc_kernel", "decode_fp32_kernel", "flash_kernel",
                   "flash_tc_kernel")),
)
PORT_RULES_LAST: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("matmul", ("quant_matmul_", "nvjet", "gemm", "cutlass", "xmma", "cublas",
                "aten::mm", "aten::bmm", "aten::addmm", "aten::linear")),
)

#: One profiler per process: the sampler's window, ``/start_profile``
#: and a caller's own profiled reading all hold this while they trace
PROFILE_LOCK = threading.Lock()

# device-side trace categories that count as device time, and the host
# categories a launch is recorded under
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# seconds a manual trace waits for a sampler window to close
_LOCK_WAIT_S = 10.0
# seconds the sampler waits past its window for the engine thread
_HANDOFF_SLACK_S = 30.0
# seconds a child process may take to fold one window's trace
_PARSE_TIMEOUT_S = 120.0


def _match(rules, text: str) -> Optional[str]:
    for bucket, needles in rules:
        for needle in needles:
            if needle in text:
                return bucket
    return None


def classify(op_name: str, name: str = "") -> str:
    """Map one device slice to a bucket via the ordered rule tables.

    ``op_name`` is the slice's scope (the ``record_function`` ranges
    around its launch, e.g. ``kaito/prefill/attention``); ``name`` is
    the kernel or operator name.  Matching is case-insensitive
    substring: the port's kernel, NCCL and copy names first, then the
    JAX package's table, then the library GEMM and aten matmul names."""
    text = f"{op_name} {name}".lower()
    return (_match(PORT_RULES_FIRST, text) or _match(OP_RULES, text)
            or _match(PORT_RULES_LAST, text) or "other")


def phase_of(op_name: str) -> Optional[str]:
    m = _PHASE_RE.search(op_name)
    if m and m.group(1) in PHASES:
        return m.group(1)
    return None


def profiler_range(name: str):
    """``record_function(name)`` while this thread runs a profiler, else a
    no-op context: a range adds no CUDA launch and no host sync, and
    costs nothing when nothing records it."""
    import torch

    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def named_scope(name: str):
    """Decorator running each call inside :func:`profiler_range`: every
    launch of the call is scoped by ``name`` (the port's counterpart of
    the JAX package's ``jax.named_scope``)."""
    def deco(fn):
        @functools.wraps(fn)
        def scoped(*args, **kwargs):
            with profiler_range(name):
                return fn(*args, **kwargs)
        return scoped
    return deco


def phase_scope(phase: str):
    """Decorator marking a dispatch function's launches with the
    ``kaito/<phase>`` range the profiler attributes them by."""
    return named_scope(f"kaito/{phase}")


@dataclass
class Slice:
    """One device-time interval: an op execution on one track."""
    name: str          # kernel / operator name
    op_name: str       # scope path of its launch ("" when unresolved)
    t0_us: float
    dur_us: float
    track: str         # one executor unit (a device)
    device: bool = True

    @property
    def t1_us(self) -> float:
        return self.t0_us + self.dur_us


# ----------------------------------------------------------------------
# Chrome trace-event reader (the JAX package's fixture format)
# ----------------------------------------------------------------------

_INFRA_MARKERS = ("::",)       # ThunkExecutor::, ThreadpoolListener:: …


def parse_trace_events(doc: dict) -> List[Slice]:
    """Flatten a chrome-trace document in the JAX profiler's layout into
    ``Slice`` records.

    Device tracks are processes whose ``process_name`` contains
    ``/device:``; with none present, XLA executor threads
    (``XLATfrtCpuClient``-style ``thread_name``) stand in.  Events may
    carry explicit ``args.op_name`` / ``args.phase``, or scoped names
    under ``args.long_name``."""
    events = doc.get("traceEvents", [])
    proc_names: Dict[object, str] = {}
    thread_names: Dict[Tuple[object, object], str] = {}
    for ev in events:
        if ev.get("ph") != "M":
            continue
        nm = (ev.get("args") or {}).get("name", "")
        if ev.get("name") == "process_name":
            proc_names[ev.get("pid")] = nm
        elif ev.get("name") == "thread_name":
            thread_names[(ev.get("pid"), ev.get("tid"))] = nm

    device_pids = {p for p, n in proc_names.items() if "/device:" in n}
    host_fallback = not device_pids

    slices: List[Slice] = []
    for ev in events:
        if ev.get("ph") != "X" or not ev.get("dur"):
            continue
        pid, tid = ev.get("pid"), ev.get("tid")
        if device_pids:
            if pid not in device_pids:
                continue
        elif "XLA" not in thread_names.get((pid, tid), ""):
            continue
        name = ev.get("name", "")
        if name.startswith("$") or any(m in name for m in _INFRA_MARKERS):
            continue
        args = ev.get("args") or {}
        op_name = args.get("op_name") or args.get("long_name") or ""
        if args.get("phase"):
            op_name = f"{op_name} kaito/{args['phase']}"
        slices.append(Slice(
            name=name, op_name=op_name,
            t0_us=float(ev["ts"]), dur_us=float(ev["dur"]),
            track=f"{proc_names.get(pid, pid)}/{tid}",
            device=not host_fallback))
    return slices


# ----------------------------------------------------------------------
# The torch profiler's trace
# ----------------------------------------------------------------------

def _scopes(ranges: List[Tuple[float, float, str]],
            queries: List[Tuple[float, object]]) -> Dict[object, str]:
    """The ``/``-joined names of the ranges (one host thread's, properly
    nested) enclosing each query time, outermost first, by key."""
    ranges.sort(key=lambda r: (r[0], -r[1]))
    out: Dict[object, str] = {}
    live: List[Tuple[float, float, str]] = []
    i = 0
    for ts, key in sorted(queries, key=lambda q: q[0]):
        while i < len(ranges) and ranges[i][0] <= ts:
            live.append(ranges[i])
            i += 1
        live = [r for r in live if r[1] >= ts]
        out[key] = "/".join(r[2] for r in live)
    return out


def parse_torch_trace(doc: dict) -> List[Slice]:
    """Flatten a ``torch.profiler`` chrome trace into ``Slice`` records.

    Device time is every ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
    event, on one track per device (``args.device``).  Its scope is the
    path of ``user_annotation`` ranges (``record_function``) enclosing
    the host call that launched it: the ``cuda_runtime`` /
    ``cuda_driver`` event with the same ``args.correlation`` (a graph
    replay's kernels all carry the ``cudaGraphLaunch``'s).  A trace with
    no device event (a CPU engine) falls back to the host's operators
    (``cpu_op``), scoped by the ranges around them on their own thread,
    one track per thread."""
    ranges: Dict[Tuple[object, object], List[Tuple[float, float, str]]] = {}
    launches: Dict[object, Tuple[object, object, float]] = {}
    device: List[dict] = []
    host_ops: List[dict] = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        if cat in _DEVICE_CATS:
            if ev.get("dur"):
                device.append(ev)
        elif cat in _LAUNCH_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (ev.get("pid"), ev.get("tid"), float(ev["ts"]))
        elif cat == "user_annotation":
            t0 = float(ev["ts"])
            ranges.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                (t0, t0 + float(ev.get("dur") or 0.0), ev.get("name", "")))
        elif cat == "cpu_op" and ev.get("dur"):
            host_ops.append(ev)

    # every query at the host time of a launch (or of an operator)
    queries: Dict[Tuple[object, object], List[Tuple[float, object]]] = {}
    if device:
        for corr, (pid, tid, ts) in launches.items():
            queries.setdefault((pid, tid), []).append((ts, corr))
    else:
        for i, ev in enumerate(host_ops):
            queries.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                (float(ev["ts"]), i))
    scope: Dict[object, str] = {}
    for thread, qs in queries.items():
        scope.update(_scopes(ranges.get(thread, []), qs))

    slices: List[Slice] = []
    if device:
        for ev in device:
            args = ev.get("args") or {}
            slices.append(Slice(
                name=ev.get("name", ""), op_name=scope.get(args.get("correlation"), ""),
                t0_us=float(ev["ts"]), dur_us=float(ev["dur"]),
                track=f"cuda:{args.get('device', ev.get('pid'))}", device=True))
        return slices
    for i, ev in enumerate(host_ops):
        slices.append(Slice(
            name=ev.get("name", ""), op_name=scope.get(i, ""),
            t0_us=float(ev["ts"]), dur_us=float(ev["dur"]),
            track=f"host/{ev.get('tid')}", device=False))
    return slices


def read_trace(path: str) -> dict:
    """The chrome-trace document at ``path``."""
    with open(path, encoding="utf-8") as f:
        return json.load(f)


# ----------------------------------------------------------------------
# Window summary: buckets, overlap, phases, roofline
# ----------------------------------------------------------------------

def _merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    if not intervals:
        return []
    intervals.sort()
    out = [list(intervals[0])]
    for t0, t1 in intervals[1:]:
        if t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def _leaf_pieces(ts: List[Slice]) -> List[Tuple[float, float, Slice]]:
    """Flatten one track's (possibly nested) events into disjoint leaf
    pieces.  Time covered by a child is bucketed by the child (a host
    operator's callee, an XLA control-flow op's body), and the envelope
    keeps only its uncovered remainder.  Output is sorted by start and
    pairwise disjoint for properly nested input; the caller's
    high-water clip mops up any malformed overlap."""
    pieces: List[Tuple[float, float, Slice]] = []
    stack: List[list] = []       # [slice, emitted-up-to cursor]

    def emit(entry: list, upto: float) -> None:
        s, cur = entry
        end = min(upto, s.t1_us)
        if end > cur:
            pieces.append((cur, end, s))

    for s in sorted(ts, key=lambda s: (s.t0_us, -s.dur_us)):
        while stack and stack[-1][0].t1_us <= s.t0_us:
            done = stack.pop()
            emit(done, done[0].t1_us)
        if stack:
            top = stack[-1]
            emit(top, s.t0_us)
            top[1] = max(top[1], min(s.t1_us, top[0].t1_us))
        stack.append([s, s.t0_us])
    while stack:
        done = stack.pop()
        emit(done, done[0].t1_us)
    pieces.sort(key=lambda p: (p[0], -(p[1] - p[0])))
    return pieces


def summarize_window(slices: List[Slice],
                     roofline: Optional[dict] = None,
                     window_tokens: float = 0.0,
                     capture_s: float = 0.0) -> dict:
    """Fold one captured window's slices into the bucket breakdown.

    ``sum(bucket_pct.values()) == 100`` within float noise holds by
    construction: per track, events are first flattened to disjoint
    leaf pieces (nested children win over their envelopes), then each
    piece is clipped against the running high-water mark before it is
    bucketed, and idle is the exact remainder of the per-track wall."""
    if not slices:
        return _empty_summary(capture_s)

    by_track: Dict[str, List[Slice]] = {}
    for s in slices:
        by_track.setdefault(s.track, []).append(s)

    t_min = min(s.t0_us for s in slices)
    t_max = max(s.t1_us for s in slices)
    span_us = max(t_max - t_min, 1e-9)
    n_tracks = len(by_track)
    wall_us = span_us * n_tracks

    bucket_us = {b: 0.0 for b in BUCKETS}
    phase_us: Dict[str, float] = {p: 0.0 for p in PHASES}
    attributed_us = 0.0
    busy_us = 0.0
    # cross-track overlap inputs: merged compute / non-copy busy spans
    compute_by_track: Dict[str, List[Tuple[float, float]]] = {}
    busy_by_track: Dict[str, List[Tuple[float, float]]] = {}
    collectives: List[Slice] = []
    copies: List[Slice] = []

    for track, ts in by_track.items():
        cursor = -float("inf")
        comp: List[Tuple[float, float]] = []
        busy: List[Tuple[float, float]] = []
        for p0, p1, s in _leaf_pieces(ts):
            start = max(p0, cursor)
            if start >= p1:
                continue   # malformed overlap: already accounted
            dur = p1 - start
            cursor = p1
            bucket = classify(s.op_name, s.name)
            bucket_us[bucket] += dur
            busy_us += dur
            busy.append((start, p1))
            if bucket in ("matmul", "attention", "other"):
                comp.append((start, p1))
            elif bucket == "collective":
                collectives.append(Slice(s.name, s.op_name, start, dur,
                                         track, s.device))
            elif bucket == "copy":
                copies.append(Slice(s.name, s.op_name, start, dur,
                                    track, s.device))
            ph = phase_of(s.op_name)
            if ph is not None:
                phase_us[ph] += dur
                attributed_us += dur
        compute_by_track[track] = _merged(comp)
        busy_by_track[track] = _merged(busy)

    bucket_us["idle"] = max(wall_us - busy_us, 0.0)

    def _cross_track_overlap(subject: List[Slice],
                             spans: Dict[str, List[Tuple[float, float]]]
                             ) -> float:
        """Fraction (%) of subject time co-scheduled with work on
        another track — the 'hidden behind compute' share."""
        total = sum(s.dur_us for s in subject)
        if total <= 0.0:
            return 0.0
        starts = {tr: [a for a, _ in iv] for tr, iv in spans.items()}
        hidden = 0.0
        for s in subject:
            cover: List[Tuple[float, float]] = []
            for tr, iv in spans.items():
                if tr == s.track:
                    continue
                j = max(0, bisect_left(starts[tr], s.t0_us) - 1)
                while j < len(iv):
                    a, b = iv[j]
                    if a >= s.t1_us:
                        break
                    lo, hi = max(a, s.t0_us), min(b, s.t1_us)
                    if hi > lo:
                        cover.append((lo, hi))
                    j += 1
            hidden += sum(b - a for a, b in _merged(cover))
        return 100.0 * hidden / total

    comm_overlap_pct = _cross_track_overlap(collectives, compute_by_track)
    copy_overlap_pct = _cross_track_overlap(copies, busy_by_track)

    pct = {b: 100.0 * v / wall_us for b, v in bucket_us.items()}
    phase_pct = {p: 100.0 * v / wall_us for p, v in phase_us.items()}
    attributed_pct = (100.0 * attributed_us / busy_us) if busy_us else 0.0

    # achieved-vs-peak rates: window token throughput against the card's
    # peaks, attributed to what consumes them (matmul => FLOPs, the
    # weight stream => memory bytes)
    matmul_pct_of_peak = hbm_pct_of_peak = 0.0
    if roofline and capture_s > 0 and window_tokens > 0:
        tok_s = window_tokens / capture_s
        pf = float(roofline.get("peak_flops", 0.0))
        pb = float(roofline.get("peak_bytes_s", 0.0))
        params = float(roofline.get("params", 0.0))
        bpt = float(roofline.get("bytes_per_tok", 0.0))
        if pf > 0 and params > 0:
            matmul_pct_of_peak = 100.0 * tok_s * 2.0 * params / pf
        if pb > 0 and bpt > 0:
            hbm_pct_of_peak = 100.0 * tok_s * bpt / pb

    return {
        "ts": time.time(),
        "capture_s": round(capture_s, 6),
        "n_slices": len(slices),
        "n_tracks": n_tracks,
        "wall_us": round(wall_us, 3),
        "busy_us": round(busy_us, 3),
        "bucket_pct": {b: round(v, 3) for b, v in pct.items()},
        "comm_pct": round(pct["collective"], 3),
        "comm_compute_overlap_pct": round(comm_overlap_pct, 3),
        "copy_overlap_pct": round(copy_overlap_pct, 3),
        "phase_pct": {p: round(v, 3) for p, v in phase_pct.items()},
        "phase_attributed_pct": round(attributed_pct, 3),
        "window_tokens": window_tokens,
        "matmul_pct_of_peak_flops": round(matmul_pct_of_peak, 3),
        "hbm_pct_of_peak": round(hbm_pct_of_peak, 3),
    }


def _empty_summary(capture_s: float = 0.0) -> dict:
    return {
        "ts": time.time(),
        "capture_s": round(capture_s, 6),
        "n_slices": 0,
        "n_tracks": 0,
        "wall_us": 0.0,
        "busy_us": 0.0,
        "bucket_pct": {b: 0.0 for b in BUCKETS},
        "comm_pct": 0.0,
        "comm_compute_overlap_pct": 0.0,
        "copy_overlap_pct": 0.0,
        "phase_pct": {p: 0.0 for p in PHASES},
        "phase_attributed_pct": 0.0,
        "window_tokens": 0.0,
        "matmul_pct_of_peak_flops": 0.0,
        "hbm_pct_of_peak": 0.0,
    }


# ----------------------------------------------------------------------
# Card peaks (the roofline's denominators)
# ----------------------------------------------------------------------

#: dense peaks by ``torch.cuda.get_device_name()``: (bf16 FLOP/s, int8
#: OP/s, memory bytes/s).  NVIDIA H100 data sheet, SXM5 part, without
#: sparsity, at its 700 W limit: 989.4 TFLOP/s bf16, 1978.9 TOPS int8,
#: 3.35 TB/s HBM3.  A card missing here gets 0 peaks, so its
#: ``*_pct_of_peak`` gauges read 0
CARD_PEAKS: Dict[str, Tuple[float, float, float]] = {
    "NVIDIA H100 80GB HBM3": (989.4e12, 1978.9e12, 3.35e12),
}

# weight bytes a parameter streams per token, by weight quantization
_BYTES_PER_PARAM = {"": 2.0, "int8": 1.0, "int4": 0.53125}


def roofline(card: str, quantization: str, n_params: int) -> dict:
    """The window roofline of a model of ``n_params`` parameters under
    ``quantization`` on the card named ``card``: the int8 peak for int8
    weights, else the bf16 one."""
    bf16, int8, bytes_s = CARD_PEAKS.get(card, (0.0, 0.0, 0.0))
    quant = quantization or ""
    return {"params": float(n_params),
            "bytes_per_tok": float(n_params * _BYTES_PER_PARAM.get(quant, 2.0)),
            "peak_flops": int8 if quant == "int8" else bf16,
            "peak_bytes_s": bytes_s}


def summarize_trace(path: str, roofline: Optional[dict] = None,
                    window_tokens: float = 0.0, capture_s: float = 0.0) -> dict:
    """The window summary of the torch profiler trace at ``path``."""
    return summarize_window(parse_torch_trace(read_trace(path)), roofline=roofline,
                            window_tokens=window_tokens, capture_s=capture_s)


def _summarize_elsewhere(path: str, roofline: Optional[dict], window_tokens: float,
                         capture_s: float) -> dict:
    """:func:`summarize_trace` in a child process (see the module's
    docstring); raises when the child fails."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH", "")) if p))
    args = json.dumps({"roofline": roofline, "window_tokens": window_tokens,
                       "capture_s": capture_s})
    out = subprocess.run([sys.executable, "-m", "kaito_tpu_torch.engine.devprof", path,
                          args], env=env, capture_output=True, text=True,
                         timeout=_PARSE_TIMEOUT_S, check=True)
    return json.loads(out.stdout)


def _profile(cuda: bool):
    """A fresh ``torch.profiler.profile`` over the host (and the card)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


# ----------------------------------------------------------------------
# The sampler
# ----------------------------------------------------------------------

class DeviceProfiler:
    """Background sampler: every ``interval_s`` take a ``window_s``
    ``torch.profiler`` trace, fold it into a window summary, keep a ring.

    With ``attached`` (an engine sets it when it starts) the sampler
    thread only asks: the engine thread opens the window at its next
    step boundary and closes it at the first boundary past
    ``window_s`` (:meth:`at_step_boundary`), and the sampler reads the
    trace.  Detached, :meth:`sample_window` traces on the calling
    thread.

    Never raises out of the sampling path: a failed capture or parse
    increments a counter and the loop moves on.  A window that finds
    :data:`PROFILE_LOCK` held (a manual ``/start_profile`` trace) is
    counted as skipped, never stolen."""

    def __init__(self, interval_s: float, window_s: float = 0.25,
                 ring: int = 16,
                 roofline: Optional[dict] = None,
                 tokens_fn: Optional[Callable[[], float]] = None,
                 cuda: bool = False,
                 captures_fn: Optional[Callable[[], int]] = None):
        self.interval_s = float(interval_s)
        self.window_s = float(window_s)
        self.roofline = roofline
        self.tokens_fn = tokens_fn
        self.cuda = cuda
        # CUDA graphs the engine has captured so far: a window during
        # which one was captured is skipped (a capture is no serving step)
        self.captures_fn = captures_fn
        self.attached = False
        self.windows = deque(maxlen=max(int(ring), 1))
        self.windows_total = 0
        self.windows_skipped = 0
        self.parse_errors = 0
        # seconds spent stopping windows, on the thread that took them
        self.stop_s_total = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # the engine-thread hand-off: the sampler's ask, the window open
        # on the engine thread, and what it delivers when it closes
        self._ask = False
        self._ask_lock = threading.Lock()
        self._win: Optional[tuple] = None
        self._handoff: "queue.SimpleQueue[Optional[tuple]]" = queue.SimpleQueue()
        # registry=None: EngineMetrics adopts it when metrics are wired
        self.capture_hist = Histogram(
            "kaito:device_capture_seconds",
            "Wall time spent capturing+parsing one devprof window",
            None, buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0))

    # -- lifecycle ------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return
        with PROFILE_LOCK:
            # the process's first trace initializes CUDA's tracing: pay it
            # here, not in the first window on the engine thread
            try:
                prof = _profile(self.cuda)
                prof.start()
                prof.stop()
            except Exception as e:  # noqa: BLE001 - the windows count it
                logger.warning("devprof: the profiler did not start: %s", e)
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="devprof")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.window_s + 10)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.sample_window()

    # -- the engine thread's side ---------------------------------------

    def at_step_boundary(self, closing: bool = False) -> None:
        """Called by the engine thread between two steps (``closing``
        when its loop ends): open the window the sampler asked for, or
        close the open one once ``window_s`` has passed."""
        win = self._win
        if win is None:
            if closing or not self._ask:
                return
            with self._ask_lock:
                if not self._ask:
                    return
                self._ask = False
            self._win = self._open()
            if self._win is None:
                self._handoff.put(None)
            return
        if not closing and time.perf_counter() - win[1] < self.window_s:
            return
        self._win = None
        self._handoff.put(self._close(win))

    def _open(self) -> Optional[tuple]:
        """(profile, start, tokens, captures) of a window started on this thread,
        or None (counted as skipped) when another trace holds the lock
        or the profiler refuses."""
        if not PROFILE_LOCK.acquire(blocking=False):
            self.windows_skipped += 1
            logger.debug("devprof window skipped: a trace is running")
            return None
        try:
            prof = _profile(self.cuda)
            prof.start()
        except Exception as e:  # noqa: BLE001 - the window is optional
            PROFILE_LOCK.release()
            self.windows_skipped += 1
            logger.debug("devprof window skipped: %s", e)
            return None
        return prof, time.perf_counter(), self._tokens(), self._captures()

    def _close(self, win: tuple) -> Optional[tuple]:
        """(profile, capture seconds, tokens) of a window stopped on the
        thread that started it, or None (skipped) when stopping fails.
        The window's seconds and tokens are read before the stop: the
        profiler's stop works through every event of the window (~11 us
        each on an H100 machine) while the engine generates nothing."""
        prof, t0, tok0, cap0 = win
        t1 = time.perf_counter()
        capture_s, tokens = t1 - t0, max(self._tokens() - tok0, 0.0)
        try:
            prof.stop()
        except Exception as e:  # noqa: BLE001
            self.windows_skipped += 1
            logger.debug("devprof window lost: %s", e)
            return None
        finally:
            PROFILE_LOCK.release()
            self.stop_s_total += time.perf_counter() - t1
        if self._captures() != cap0:
            self.windows_skipped += 1
            logger.debug("devprof window skipped: a CUDA graph was captured in it")
            return None
        return prof, capture_s, tokens

    # -- one window -----------------------------------------------------

    def _from_engine(self) -> Optional[tuple]:
        """Ask the engine thread for a window and wait for it.  A window
        the engine never opened (no step boundary in time) is skipped."""
        with self._ask_lock:
            self._ask = True
        deadline = time.monotonic() + self.window_s + _HANDOFF_SLACK_S
        while True:
            try:
                return self._handoff.get(timeout=0.05)
            except queue.Empty:
                pass
            with self._ask_lock:
                # once the engine took the ask, it delivers when the
                # window closes (at the latest when its loop ends)
                if self._ask and (self._stop.is_set() or time.monotonic() > deadline):
                    self._ask = False
                    self.windows_skipped += 1
                    return None

    def _here(self) -> Optional[tuple]:
        win = self._open()
        if win is None:
            return None
        self._stop.wait(self.window_s)
        return self._close(win)

    def sample_window(self) -> Optional[dict]:
        """Capture + parse one window synchronously.  Returns the
        summary dict, or None when the window was skipped/failed."""
        t0 = time.perf_counter()
        got = self._from_engine() if self.attached else self._here()
        if got is None:
            return None
        prof, capture_s, tokens = got
        tmp = tempfile.mkdtemp(prefix="kaito-devprof-")
        try:
            try:
                path = os.path.join(tmp, "window.trace.json")
                prof.export_chrome_trace(path)
                del prof
                summary = _summarize_elsewhere(path, self.roofline, tokens, capture_s)
            except Exception:
                logger.debug("devprof parse failed", exc_info=True)
                self.parse_errors += 1
                return None
            self.capture_hist.observe(time.perf_counter() - t0)
            with self._lock:
                self.windows.append(summary)
                self.windows_total += 1
            return summary
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def _tokens(self) -> float:
        if self.tokens_fn is None:
            return 0.0
        try:
            return float(self.tokens_fn())
        except Exception:
            return 0.0

    def _captures(self) -> int:
        return 0 if self.captures_fn is None else int(self.captures_fn())

    # -- read side ------------------------------------------------------

    def last(self) -> Optional[dict]:
        with self._lock:
            return self.windows[-1] if self.windows else None

    def snapshot(self) -> dict:
        with self._lock:
            ring = list(self.windows)
        return {
            "interval_s": self.interval_s,
            "window_s": self.window_s,
            "windows_total": self.windows_total,
            "windows_skipped": self.windows_skipped,
            "parse_errors": self.parse_errors,
            "last": ring[-1] if ring else None,
            "ring": ring,
        }

    # metric accessors — gauges read the last window, 0.0 before the
    # first capture so exposition is schema-stable from step one
    def _lastval(self, key: str) -> float:
        last = self.last()
        return float(last[key]) if last else 0.0

    def comm_pct(self) -> float:
        return self._lastval("comm_pct")

    def overlap_pct(self) -> float:
        return self._lastval("comm_compute_overlap_pct")

    def copy_overlap_pct(self) -> float:
        return self._lastval("copy_overlap_pct")

    def idle_pct(self) -> float:
        last = self.last()
        return float(last["bucket_pct"]["idle"]) if last else 0.0

    def bucket_pct(self) -> Dict[Tuple[str, ...], float]:
        last = self.last()
        src = last["bucket_pct"] if last else {b: 0.0 for b in BUCKETS}
        return {(b,): float(src.get(b, 0.0)) for b in BUCKETS}

    def phase_pct(self) -> Dict[Tuple[str, ...], float]:
        last = self.last()
        src = last["phase_pct"] if last else {p: 0.0 for p in PHASES}
        return {(p,): float(src.get(p, 0.0)) for p in PHASES}


# ----------------------------------------------------------------------
# The manual trace (/start_profile, /stop_profile)
# ----------------------------------------------------------------------

class ManualTrace:
    """A ``torch.profiler`` trace a client starts and stops, taken on
    the thread ``run`` calls into (the engine thread: the profiler
    records the host ranges of the thread that starts it, and stops on
    that thread) and written as a chrome trace under a directory.  It
    holds :data:`PROFILE_LOCK` from start to stop, so sampler windows in
    between are skipped."""

    def __init__(self, run: Callable[[Callable[[], object]], object], cuda: bool):
        self.run = run
        self.cuda = cuda
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        if not PROFILE_LOCK.acquire(timeout=_LOCK_WAIT_S):
            raise RuntimeError("another profiler trace holds the card")
        try:
            prof = _profile(self.cuda)
            self.run(prof.start)
        except BaseException:
            PROFILE_LOCK.release()
            raise
        self._prof = prof

    def stop(self, out_dir: str) -> str:
        """Stop the trace and write it; returns the file's path."""
        prof, self._prof = self._prof, None
        try:
            self.run(prof.stop)
        finally:
            PROFILE_LOCK.release()
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"kaito-{os.getpid()}-{time.time_ns()}.trace.json")
        prof.export_chrome_trace(path)
        return path


if __name__ == "__main__":
    # python -m kaito_tpu_torch.engine.devprof TRACE '{"roofline": ..., ...}':
    # the window summary of a torch profiler trace as one JSON line
    print(json.dumps(summarize_trace(sys.argv[1], **json.loads(sys.argv[2]))))
