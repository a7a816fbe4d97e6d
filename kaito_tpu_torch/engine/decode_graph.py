"""The decode window: K fused decode steps over static buffers, captured
once per key and replayed as one CUDA graph.

Counterpart of the JAX engine's jitted ``decode_step`` and
``decode_multi`` (``kaito_tpu.engine.engine._build_decode_fn`` and
``_build_decode_multi_fn(K, with_state)``): there a window of K decode
steps is one XLA program, built once per shape and replayed with the
cache, sampling and penalty state donated.  Here a :class:`DecodeWindow`
keeps the window's inputs in static device buffers — last tokens,
positions, the page tables at their full width, the active rows, the
remaining budgets (``left``) and the ``[S, stop_width]`` stop matrix —
and runs K steps over them (:func:`run_steps`, the scan body), writing
the ``[K, S]`` trace (tokens, each step's active mask before it,
logprobs) into static outputs and the final carry (next tokens,
positions, active, left) back into its inputs.  The next window starts
from that carry, which is what async dispatch feeds back (copying in
only what the host changed; the synchronous loop copies every field).

On one card (``capture=True``) each key — K, the sampler's gates,
whether penalty state is live, while a slot is constrained the grammar
table's capacity, and whether a row runs an adapter — is captured once: first one eager warm-up on
a side stream with every row inactive (inactive rows write only the null
page and keep their sampling keys, and the kernels' first workspace use
then happens outside capture, as they demand), then the capture, into
one memory pool that every graph of the engine shares; from then on a
call is one graph launch. A window with an adapter row reads each row's
lane from the ``slot_adapters`` input, and the model's adapter lanes,
which the adapter cache rewrites in place: loads, evictions and faults
capture nothing again. A constrained window also reads the grammar
table and carries each row's table row (``gstate``) as it does the
tokens; a table that grows is new buffers, so the engine drops the
graphs keyed on the old one (:meth:`StaticGraphs.drop`). Random draws
come from the per-row keys of the sampler's state, a device buffer that
a replay reads and advances in place, so no generator is registered with
a graph. A capture that fails raises; nothing falls back to eager.
Without capture (the CPU, or a tensor-parallel engine, one process over
several devices) the same body runs eagerly on the same buffers.
:func:`capture_graph` is the capture itself, shared with the speculative
verify window and the draft's proposal scan (``engine.spec``).

The body is whatever the engine's step runs: an MLA model's step (the
latent page writes, int8 ones included, the gather over the full-width
page tables and the absorbed products, all plain torch) is captured the
same way, since none of it reads anything back to the host.

Launch counts.  A kernel wrapper adds one to its counter where it
launches its kernel; under capture that launch is only recorded.  The
window takes the capture's additions back, keeps them as the graph's
kernels, and adds them again at every replay, so the counters read
kernels run on the device, warm-up included.  The graph's node count,
from the CUDA driver, says how many kernels a window runs in all: the
wrappers' and PyTorch's.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import gc
import logging
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from kaito_tpu_torch.engine.ops.decode_attention import paged_decode_attention_cuda
from kaito_tpu_torch.engine.ops.flash_prefill import (flash_prefill_attention_cuda,
                                                      flash_prefill_packed_cuda)
from kaito_tpu_torch.engine.ops.quant_matmul import quant_matmul_cuda

logger = logging.getLogger(__name__)

# the carry a window writes back into its inputs, in run_steps' order
CARRY = ("last_tokens", "positions", "active", "left")

# every kernel wrapper's launch counters: (wrapper, counter attributes)
_COUNTERS = (
    (paged_decode_attention_cuda, ("launches", "launches_q")),
    (flash_prefill_attention_cuda, ("launches",)),
    (flash_prefill_packed_cuda, ("launches",)),
    (quant_matmul_cuda, ("launches_int8", "launches_int4", "launches_int8_pf",
                         "launches_int4_pf", "launches_int8_wide",
                         "launches_int4_wide")),
)

# CUgraphNodeType values (cuda.h) named in node counts
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}


def run_steps(step: Callable, K: int, tok, pos, page_tables, act, left, stop,
              grammar: Optional[tuple] = None, aids=None):
    """K fused decode steps, the body of the JAX engine's decode scan:
    ``step(tok, pos, page_tables, act, grammar_rows, aids) -> (next,
    logprob)`` runs the model (through the rows' adapter lanes ``aids``
    [S], or none) and samples; a row that emits a stop id or spends its
    budget goes inactive, so it writes no more KV.  ``grammar`` is None
    or (gmask [R, V] fp32, gtrans [R, V] int32, gstate [S] int32): each
    step gathers the rows' 0 / -inf mask rows ``gmask[gstate]`` into the
    sampler and advances ``gstate = gtrans[gstate, next]`` on the active
    rows (row 0, the unconstrained row, allows everything and loops on
    itself).  Returns the ``[K, S]`` (tokens, active before each step,
    logprobs) and the carry (tokens, positions, active, left, gstate;
    gstate None without a grammar)."""
    toks, acts, lps = [], [], []
    gst = None
    if grammar is not None:
        gmask, gtrans, gst = grammar
    for _ in range(K):
        grows = gmask[gst.long()] if gst is not None else None
        nxt, lp = step(tok, pos, page_tables, act, grows, aids)
        nxt = torch.where(act, nxt, tok)
        if gst is not None:
            gst = torch.where(act, gtrans[gst.long(), nxt.long()], gst)
        left = left - act.to(torch.int32)
        # the stop matrix is -1 padded; token ids are >= 0
        hit = (nxt[:, None] == stop).any(dim=1)
        toks.append(nxt)
        acts.append(act)
        lps.append(lp)
        pos = pos + act.to(torch.int32)
        act = act & ~hit & (left > 0)
        tok = nxt
    return (torch.stack(toks), torch.stack(acts), torch.stack(lps)), \
        (tok, pos, act, left, gst)


def launch_counts() -> dict[tuple, int]:
    """Every kernel wrapper's launch counter, by (wrapper name, attribute)."""
    return {(fn.__name__, a): getattr(fn, a) for fn, attrs in _COUNTERS
            for a in attrs}


def _add_launches(counts: dict[tuple, int], sign: int = 1) -> None:
    for fn, attrs in _COUNTERS:
        for a in attrs:
            n = counts.get((fn.__name__, a), 0)
            if n:
                setattr(fn, a, getattr(fn, a) + sign * n)


@functools.cache
def _driver() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphNodeGetType.restype = ctypes.c_int
    return lib


def graph_nodes(raw_graph: int) -> dict[str, int]:
    """Node counts by type (kernel, memcpy, memset, other) of a captured
    ``cudaGraph_t``, read through the CUDA driver."""
    lib = _driver()
    n = ctypes.c_size_t(0)
    if lib.cuGraphGetNodes(raw_graph, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if lib.cuGraphGetNodes(raw_graph, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = collections.Counter({name: 0 for name in _NODE_TYPES.values()})
    t = ctypes.c_int()
    for node in nodes[:n.value]:
        if lib.cuGraphNodeGetType(node, ctypes.byref(t)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kinds[_NODE_TYPES.get(t.value, "other")] += 1
    return dict(kinds)


def capture_graph(body: Callable[[], None], device: torch.device, pool,
                  side: torch.cuda.Stream, neutral: Callable[[], Callable[[], None]]
                  ) -> tuple[torch.cuda.CUDAGraph, dict, dict, int]:
    """Capture ``body`` (which reads and writes only static buffers) as
    one CUDA graph in ``pool``, on the stream ``side``.  ``neutral()``
    first sets the body's inputs to a harmless state (rows inactive: they
    write only the null page and draw nothing) and returns the function
    that restores them; one eager warm-up runs in that state, so every
    kernel's first workspace use happens outside capture.  Returns the
    instantiated graph, the wrapper launches one replay makes (taken back
    from the counters: a capture runs nothing), the graph's nodes by type
    and how many bytes the pool grew."""
    cur = torch.cuda.current_stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        restore = neutral()
        body()                                     # the warm-up
    # a graph the collector frees during capture (an engine dropped
    # earlier) would invalidate it: collect now, not during capture
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = launch_counts()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=side,
                              capture_error_mode="thread_local"):
            body()
    finally:
        if collecting:
            gc.enable()
    launches = {k: n - before[k] for k, n in launch_counts().items()
                if n != before[k]}
    _add_launches(launches, -1)                    # capture runs nothing
    nodes = graph_nodes(graph.raw_cuda_graph())
    graph.instantiate()
    with torch.cuda.stream(side):
        restore()
    cur.wait_stream(side)
    return graph, launches, nodes, max(0, torch.cuda.memory_reserved(device) - reserved)


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    out: Optional[tuple]             # the body's static outputs
    launches: dict                   # wrapper launches one replay makes
    nodes: dict                      # the graph's nodes by type
    replays: int = 0


class StaticGraphs:
    """Static device inputs, refreshed in place, and the graphs that read
    them, each captured once per key and replayed (on a card); without
    capture a caller runs its body eagerly over the same buffers.

    ``inputs`` maps names to the device tensors; ``name`` prefixes the
    two counters it keeps in ``counters`` (the engine's):
    ``<name>_captures_total`` and ``<name>_replays_total``.  ``pool`` is
    the graph memory pool to capture into (a new one when None); the
    engine's graphs share one."""

    def __init__(self, inputs: dict, device: torch.device, capture: bool,
                 counters: dict, name: str, pool=None):
        if capture and device.type != "cuda":
            raise ValueError(f"CUDA graphs need a card, got {device}")
        self.inputs, self.device = inputs, device
        self.capture, self.counters, self.name = capture, counters, name
        self._cuda = device.type == "cuda"
        self._stage = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=self._cuda)
                       for k, v in inputs.items()}
        self._staged: Optional[torch.cuda.Event] = None
        self.graphs: dict[tuple, _Graph] = {}
        self.pool = (pool if pool is not None else torch.cuda.graph_pool_handle()) \
            if capture else None
        self._side = torch.cuda.Stream(device) if capture else None
        self.pool_bytes = 0
        counters.setdefault(f"{name}_captures_total", 0)
        counters.setdefault(f"{name}_replays_total", 0)

    def upload(self, arrays: dict[str, np.ndarray]) -> int:
        """Copy host arrays into the named inputs, behind the stream's
        earlier work (on the card through pinned staging, without
        blocking the host); returns how many it copied."""
        if not arrays:
            return 0
        if self._staged is not None:
            self._staged.synchronize()      # the staging is free to rewrite
        for name, a in arrays.items():
            st = self._stage[name]
            st.copy_(torch.from_numpy(np.ascontiguousarray(a)))
            self.inputs[name].copy_(st, non_blocking=self._cuda)
        if self._cuda:
            self._staged = torch.cuda.Event()
            self._staged.record(torch.cuda.current_stream(self.device))
        return len(arrays)

    def replay(self, key: tuple, make: Callable) -> _Graph:
        """Replay the graph of ``key``, capturing it first: ``make()``
        gives (body, neutral, out) — the body over the static buffers,
        :func:`capture_graph`'s ``neutral`` and the body's static
        outputs, which the returned record keeps."""
        g = self.graphs.get(key)
        if g is None:
            body, neutral, out = make()
            graph, launches, nodes, grown = capture_graph(
                body, self.device, self.pool, self._side, neutral)
            self.pool_bytes += grown
            self.counters[f"{self.name}_captures_total"] += 1
            logger.info("captured %s %s: %d kernel nodes (%s), wrapper kernels "
                        "%s; graph pool %.1f MiB", self.name, key, nodes["kernel"],
                        nodes, _named(launches), self.pool_bytes / 2**20)
            g = self.graphs[key] = _Graph(graph, out, launches, nodes)
        g.graph.replay()
        _add_launches(g.launches)
        g.replays += 1
        self.counters[f"{self.name}_replays_total"] += 1
        return g

    def drop(self, stale: Callable[[tuple], bool]) -> int:
        """Forget the graphs whose key ``stale`` marks (graphs that read
        buffers the caller replaced); returns how many went."""
        keys = [k for k in self.graphs if stale(k)]
        for k in keys:
            del self.graphs[k]
        return len(keys)

    def stats(self) -> dict:
        """Captures, replays, the pool's growth and each graph's key,
        node counts and wrapper kernels."""
        return dict(
            captures=self.counters[f"{self.name}_captures_total"],
            replays=self.counters[f"{self.name}_replays_total"],
            pool_bytes=self.pool_bytes,
            graphs=[dict(key=repr(key), nodes=g.nodes, launches=_named(g.launches),
                         replays=g.replays)
                    for key, g in self.graphs.items()])


class DecodeWindow(StaticGraphs):
    """Static decode inputs and outputs, and the engine's captured
    windows.

    ``step(tok, pos, page_tables, act) -> (next, logprob)`` is one model
    step with sampling (the engine's); ``batch`` rows, page tables of
    ``pages_per_seq`` columns, a stop matrix of ``stop_width`` ids.
    ``capture`` (a card only) captures each key once and replays it;
    otherwise :meth:`run` runs the body eagerly.  ``counters`` (the
    engine's) gains ``decode_graph_captures_total`` and
    ``decode_graph_replays_total``."""

    def __init__(self, step: Callable, batch: int, pages_per_seq: int,
                 stop_width: int, device: torch.device, capture: bool,
                 counters: dict):
        S = batch

        def full(shape, dtype, fill):
            return torch.full(shape, fill, dtype=dtype, device=device)

        super().__init__({
            "last_tokens": full((S,), torch.int32, 0),
            "positions": full((S,), torch.int32, 0),
            "active": full((S,), torch.bool, False),
            "left": full((S,), torch.int32, 0),
            "page_tables": full((S, pages_per_seq), torch.int32, 0),
            "stop": full((S, stop_width), torch.int32, -1),
            "gstate": full((S,), torch.int32, 0),
            "slot_adapters": full((S,), torch.int32, 0),
        }, device, capture, counters, "decode_graph")
        self.step = step
        self._eager: dict[int, tuple] = {}

    def _outputs(self, K: int) -> tuple:
        S = self.inputs["active"].shape[0]
        return tuple(torch.empty((K, S), dtype=dt, device=self.device)
                     for dt in (torch.int32, torch.bool, torch.float32))

    def _body(self, K: int, out: tuple, grammar: Optional[tuple] = None,
              lora: bool = False) -> None:
        x = self.inputs
        if grammar is not None:
            grammar = (*grammar, x["gstate"])
        trace, carry = run_steps(self.step, K, x["last_tokens"], x["positions"],
                                 x["page_tables"], x["active"], x["left"], x["stop"],
                                 grammar, x["slot_adapters"] if lora else None)
        for o, t in zip(out, trace):
            o.copy_(t)
        for name, t in zip(CARRY, carry):
            x[name].copy_(t)
        if grammar is not None:
            x["gstate"].copy_(carry[-1])

    def run(self, K: int, key: tuple, grammar: Optional[tuple] = None,
            lora: bool = False) -> tuple:
        """K decode steps from the inputs; the static ``[K, S]`` (tokens,
        active, logprobs), valid until the next window of the same K and
        ``key`` (the sampler's gates, the penalty state's liveness,
        ``lora``, whether the rows read their adapter lanes, and last the
        grammar table's capacity when a slot is constrained).  ``grammar``
        is None or the device table (gmask, gtrans): the window then
        masks each step from the ``gstate`` input and carries it on; a
        captured graph keeps the table's pointers, so the caller keys it
        by capacity and :meth:`drop` s the graphs of a replaced table."""
        if not self.capture:
            out = self._eager.get(K)
            if out is None:
                out = self._eager[K] = self._outputs(K)
            self._body(K, out, grammar, lora)
            return out

        def make():
            out = self._outputs(K)
            act = self.inputs["active"]

            def neutral():
                saved = act.clone()
                act.zero_()
                return lambda: act.copy_(saved)

            return (lambda: self._body(K, out, grammar, lora)), neutral, out

        return self.replay((K, key), make).out

    def stats(self) -> dict:
        """Captures, replays, the pool's size and each graph's K, key,
        node counts and wrapper kernels."""
        return dict(
            captures=self.counters["decode_graph_captures_total"],
            replays=self.counters["decode_graph_replays_total"],
            pool_bytes=self.pool_bytes,
            graphs=[dict(K=K, key=repr(key), nodes=g.nodes,
                         launches=_named(g.launches))
                    for (K, key), g in self.graphs.items()])


def _named(launches: dict) -> dict:
    return {f"{fn}.{a}": n for (fn, a), n in launches.items()}


class TraceReadback:
    """Host copies of one window's ``[K, S]`` trace: enqueued right after
    the window (into pinned memory on the card), with an event that
    :meth:`wait` waits on, never the whole device."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self.host: Optional[tuple] = None
        self.event: Optional[torch.cuda.Event] = None
        self.K = 0

    def enqueue(self, out: tuple) -> None:
        K = out[0].shape[0]
        if self.host is None or self.host[0].shape[0] < K:
            self.host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=self._cuda)
                              for t in out)
        for h, t in zip(self.host, out):
            h[:K].copy_(t, non_blocking=self._cuda)
        if self._cuda:
            self.event = torch.cuda.Event()
            self.event.record()
        self.K = K

    def wait(self) -> tuple:
        """The trace as numpy views of the host copies (valid until the
        next :meth:`enqueue`)."""
        if self.event is not None:
            self.event.synchronize()
        return tuple(h[:self.K].numpy() for h in self.host)
