"""The inference engine: continuous batching over a paged KV cache.

Counterpart of the synchronous core of ``kaito_tpu.engine.engine``:

- Fixed decode *slots* (``max_num_seqs``).  One decode step advances
  every slot; inactive slots write to the null page and their samples
  are discarded.
- Prefill runs in bounded chunks that interleave with decode
  (decode-priority), writing straight into the request's pages.  The
  per-step token budget is spread over a PACK of staged slots: fresh
  prompts are segment-packed into one row, continuation chunks batch on
  the batch axis (``prefill_pack``; 1 is the serial round-robin
  scheduler).
- Pages come from a free-list allocator on demand; when the pool runs
  dry the newest sequence is preempted back to the queue (its output so
  far becomes part of its prompt on resume).
- Steady-state decode fuses up to ``decode_run_ahead`` steps into one
  window: sampling, stop detection and per-slot budgets stay on the
  device, and the host reads the window's tokens back once.  A window
  runs over static device buffers (``decode_graph.DecodeWindow``): on
  one card each window shape is captured once and replayed as one CUDA
  graph, the counterpart of the JAX engine's jitted ``decode_step`` /
  ``decode_multi``; a tensor-parallel engine runs the same window
  eagerly.
- ``async_dispatch`` (the zero-bubble loop): window N+1 is dispatched
  from window N's final carry, still on the device, while the host
  replays window N's trace; any host-side batch change drains the
  pipeline first.

Weight quantization (``quantization`` int8 / int4), the int8 KV cache
(``kv_dtype="int8"``) and tensor parallelism (``tensor_parallel``, with
the ``comm_overlap`` decode ring) serve as in the JAX engine.  A
tensor-parallel engine is one process driving every device of its mesh
(``parallel.mesh``): an explicit ``mesh=`` may place several shards on
one device; without one, ``tensor_parallel=n`` takes the first n cards.
MoE models serve on one device with the JAX engine's ragged expert
semantics (``model.moe_impl_for`` picks how the products run); a
tensor-parallel MoE engine raises.  MLA models serve on one device from
a latent page pool, their fresh prompts batched per bucket instead of
segment-packed; a tensor-parallel MLA engine raises.
Prefix caching (on by default, off for MLA) shares whole prompt pages
through the port's radix tree (``prefix_cache.PrefixCache``), as the
JAX engine does through its native one: a hit prefills only the
prompt's suffix, as a continuation chunk over the cached pages.  Every
request is traced (``tracer`` spans, one ``timeline`` record per
non-idle step, the step and queue histograms) from host clocks only.

Multi-tenant QoS (``qos_config``, ``engine.qos``): per-tenant queues
behind the one waiting-queue surface, admitted by strict priority across
classes and deficit round robin across the tenants of a class; a queued
request of a higher class claims a slot, and page room, from the newest
sequence of the lowest class below it.  Request deadlines (a per-request
``timeout_s``, else ``request_timeout_s``) are swept every 50 ms: an
expired request leaves the queue or its slot with a 408
``deadline_exceeded`` error.  The ITL recorder (``itl_enabled``, else
KAITO_ITL) stamps each token as the host retires it into
``kaito:inter_token_latency_seconds``.  Prompt scoring
(:meth:`InferenceEngine.score_prompt`, the ``echo`` contract) runs on
the engine thread between steps, never from a caller's thread.
Speculative decoding (``speculative_ngram``, ``speculative_draft``,
``engine.spec``) verifies a window of proposed tokens per slot in one
target forward, a captured graph on one card: the n-gram proposer's
greedy rows by prefix match, the draft model's (greedy and
pure-temperature rows) by Leviathan rejection sampling, with the
adaptive depth controller and its fallback ladder.  A request's ``seed``
(else its request count) keys its slot's draws: sampled requests
reproduce, and draw the JAX engine's tokens.  A request's compiled
grammar (``SamplingParams.grammar``, from ``response_format`` or a
forced tool call) is packed at admission into one table of 0 / -inf
mask rows and transition rows (host ``grammar.GrammarTable``, mirrored
on the device); every sampled token of the slot, the first after
prefill, a decode window's, a verify round's and a draft proposal's,
is drawn under its current row, and the slot's row advances on the
device and in the host mirror.
Multi-LoRA (``adapter_slots``, else ``adapters_dir``): every request may
name an adapter (``submit(adapter=...)``); each row of a batch applies
its own adapter's low-rank deltas through the model's lanes, lane 0 the
base.  With ``adapter_slots`` the lanes are the two-tier
``adapter_cache.AdapterCache``, allocated once at boot and written in
place on the engine thread (loads, evictions, faults, deletes), so no
graph is captured again; without it the adapters of ``adapters_dir``
are stacked at boot (``adapters.load_adapter_stacks``), or merged into
the base weights on a model with no sites (MLA).  Adapter requests
never share prefix-cache pages, fresh prompts pack per adapter, and the
decode and verify windows take each row's lane (``slot_adapters``) as an
input; a window with no adapter row runs the base graph.
The host-RAM KV tier (``host_kv_offload_bytes``, ``engine.host_offload``):
a sequence preempted to be resumed spills its written pages to pinned
host memory, and its re-admission copies them back into freshly
acquired, exclusive pages of the same pool tensors (the captured windows
keep their pointers) and resumes decoding with no prefill; an entry the
tier dropped resumes by recompute.  The sampling device profiler
(``devprof_interval_s``, ``engine.devprof``): the engine thread opens and
closes each ``torch.profiler`` window at a step boundary, and every
dispatch runs inside its ``kaito/<phase>`` range.
KV movement (``engine.pd``, ``engine.kv_pool``): a prefill role's request
(``submit(export_kv=True)``) stages its prompt pages where it finishes,
and a decode role continues from them with no prefill
(``submit_with_kv``, ``submit_with_kv_chunked`` over the HTTP wire,
``submit_with_kv_device`` from a colocated engine); with ``kv_pool_enabled``
a finished prompt publishes its whole pages, and a fetch
(``submit_with_kv_prefix``) imports a verified prefix and prefills the
rest, below which ``kv_pool_disk_bytes`` keeps a slab directory.  Every
import writes IN PLACE into freshly acquired, exclusive pages of the pool
tensors (``pd.import_arrays``), so the captured windows keep their
pointers; imported pages never enter the prefix tree or the host tier.
Not ported yet, and rejected at construction with the ROADMAP item that
carries them: pipeline, data, sequence and expert parallelism.
"""

from __future__ import annotations

import collections
import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from kaito_tpu_torch.device import resolve_device
from kaito_tpu_torch.engine.adapter_cache import AdapterCache, AdapterLoadError
from kaito_tpu_torch.engine.adapters import (apply_adapters_to_params,
                                             discover_adapters, load_adapter_stacks)
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.decode_graph import DecodeWindow, TraceReadback, run_steps
from kaito_tpu_torch.engine.devprof import DeviceProfiler, phase_scope, roofline
from kaito_tpu_torch.engine.grammar import GrammarCache, GrammarSlot, GrammarTable
from kaito_tpu_torch.engine.host_offload import HostKVPool, gather_pages, scatter_pages
from kaito_tpu_torch.engine.kv_cache import (NULL_PAGE, create_kv_cache,
                                             create_sharded_kv_cache,
                                             kv_bytes, kv_cache_is_quantized,
                                             scale_bytes_per_page)
from kaito_tpu_torch.engine.kv_pool import (DiskPageStore, HostExport, PoolEntry,
                                            PrefixPageStore, meta_nbytes, pool_key)
from kaito_tpu_torch.engine.metrics import Histogram
from kaito_tpu_torch.engine.model import (TensorParallelLM, TransformerLM,
                                          check_tensor_parallel)
from kaito_tpu_torch.engine.pd import (ChunkedImport, KVExportRegistry,
                                      TransferCostModel, import_arrays, import_kv,
                                      stage_export, wire_dtype)
from kaito_tpu_torch.engine.prefix_cache import PrefixCache
from kaito_tpu_torch.engine.qos import DEFAULT_TENANT, parse_qos_config
from kaito_tpu_torch.engine.quant import QUANT_SCHEMES, supports_quantization
from kaito_tpu_torch.engine.sampler import SamplingState, chosen_logprob, sample
from kaito_tpu_torch.engine.spec import (DepthController, DraftRunner, NgramIndex,
                                         VerifyWindow, width_bucket)
from kaito_tpu_torch.engine import streaming
from kaito_tpu_torch.engine.tokenizer import load_tokenizer
from kaito_tpu_torch.models.metadata import ModelMetadata
from kaito_tpu_torch.models.registry import get_model_by_name
from kaito_tpu_torch.parallel.mesh import AXIS_TENSOR, Mesh, build_mesh
from kaito_tpu_torch.parallel.sharding import SERVE_RULES, ring_axis
from kaito_tpu_torch.utils.failpoints import FAILPOINTS
from kaito_tpu_torch.utils.tracing import (RingTracer, StepTimeline,
                                           format_span_tree)

logger = logging.getLogger(__name__)

# columns in the fused-decode on-device stop matrix; requests with more
# stop ids than this take the single-step path
_STOP_WIDTH = 8
# fused decode steps per window when decode_run_ahead is None on CUDA:
# the smallest window whose single-stream decode rate beat single steps
# by more than the rates' interquartile range on an H100, with each
# window a replayed CUDA graph (chip_smoke.py --sweep-run-ahead,
# PERF.md).  A window of K delivers tokens in bursts of K, which PERF.md
# weighs.  The CPU uses 1
AUTO_RUN_AHEAD_CUDA = 4
# seconds between two deadline sweeps (each walks the queue and slots)
_DEADLINE_SWEEP_S = 0.05
# device memory the page pool leaves free for activations and scratch
_RESERVE_FRACTION = 0.08
_RESERVE_MIN_BYTES = 4 << 30
# device memory a grammar table's growth leaves free beside it, for the
# graph captures and activations that share the KV pool's reserve
_GRAMMAR_HEADROOM_BYTES = 1 << 30

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8}

# (config field, value counts as "on", ROADMAP item that ports it)
_UNPORTED = (
    ("pipeline_parallel", lambda v: v > 1, "queue 1, M19 multi-GPU"),
    ("data_parallel", lambda v: v > 1, "queue 1, M19 multi-GPU"),
    ("sequence_parallel", lambda v: v > 1, "queue 1, M19 multi-GPU"),
    ("expert_parallel", lambda v: v > 1, "queue 1, M19 multi-GPU"),
)


def check_ported(cfg: EngineConfig) -> None:
    """Raise NotImplementedError for a config gate this port lacks."""
    for name, on, item in _UNPORTED:
        if on(getattr(cfg, name)):
            raise NotImplementedError(
                f"EngineConfig.{name}={getattr(cfg, name)!r} is not ported to "
                f"kaito_tpu_torch yet (ROADMAP {item})")


def resolve_async_dispatch(cfg: EngineConfig) -> bool:
    """The async decode dispatch gate: ``cfg.async_dispatch``; None
    follows KAITO_ASYNC_DISPATCH ("1" or "true"), off when unset."""
    if cfg.async_dispatch is not None:
        return bool(cfg.async_dispatch)
    return os.environ.get("KAITO_ASYNC_DISPATCH", "") in ("1", "true")


def check_quantization(cfg: EngineConfig, md: ModelMetadata) -> None:
    """Raise ValueError for a weight-quantization scheme the engine cannot
    serve, before anything is allocated: a mistyped scheme is never
    served as bf16."""
    if not cfg.quantization:
        return
    if cfg.quantization not in QUANT_SCHEMES:
        raise ValueError(f"unknown quantization {cfg.quantization!r} "
                         f"(known: {', '.join(QUANT_SCHEMES)})")
    if not supports_quantization(md.arch, cfg.quantization):
        raise ValueError(f"quantization {cfg.quantization!r} does not support "
                         f"this architecture (hidden_size={md.arch.hidden_size})")


def resolve_mesh(cfg: EngineConfig, mesh: Optional[Mesh],
                 device: str | torch.device) -> Optional[Mesh]:
    """The engine's tensor-parallel mesh, or None for one device: the
    caller's ``mesh``, else the first ``cfg.tensor_parallel`` CUDA
    devices, which raises when fewer are visible.  A CPU mesh is always
    explicit: without one, ``device="cpu"`` at tensor_parallel > 1
    raises NotImplementedError."""
    tp = cfg.tensor_parallel
    if mesh is None:
        if tp <= 1:
            return None
        if torch.device(device).type == "cpu":
            raise NotImplementedError(
                f"tensor_parallel={tp} on the CPU without an explicit mesh: the "
                f"CPU has no devices to take, pass mesh=build_mesh(tensor={tp}, "
                f"devices=['cpu'] * {tp}) (ROADMAP queue 1, M19)")
        mesh = build_mesh(tensor=tp)
    n = mesh.size(AXIS_TENSOR)
    if len(mesh.devices) != n:
        raise ValueError(f"{mesh} has axes beyond {AXIS_TENSOR!r}; only tensor "
                         f"parallelism is ported")
    if tp not in (1, n):
        raise ValueError(f"tensor_parallel={tp} but the mesh's tensor axis "
                         f"has {n} devices")
    return mesh if n > 1 else None


@dataclass
class SamplingParams:
    max_tokens: int = 128
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    stop_token_ids: tuple[int, ...] = ()
    seed: int = 0
    ignore_eos: bool = False
    logprobs: bool = False     # per-generated-token log p (model dist)
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    min_p: float = 0.0
    # grammar-constrained decoding: the grammar.CompiledGrammar the
    # server compiled from response_format or a forced tool_choice
    # before admission (compilation never runs on the engine thread).
    # None = unconstrained
    grammar: Optional[object] = field(default=None, compare=False, repr=False)

    @property
    def has_penalties(self) -> bool:
        return (self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0
                or self.repetition_penalty != 1.0)


@dataclass
class Request:
    req_id: str
    prompt_tokens: list[int]
    params: SamplingParams
    out: "queue.SimpleQueue[Optional[int]]" = field(default_factory=queue.SimpleQueue)
    output_tokens: list[int] = field(default_factory=list)
    output_logprobs: list = field(default_factory=list)
    submit_time: float = field(default_factory=time.monotonic)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    finish_reason: str = ""
    aborted: bool = False
    preemptions: int = 0
    prompt_counted: bool = False   # prompt tokens counted once
    error: Optional[dict] = None
    # end-to-end trace identity (X-Request-Id): distinct from req_id so
    # a client-supplied id never collides with engine-internal keys;
    # defaults to req_id at submit
    trace_id: str = ""
    # absolute monotonic deadline (None: none); past it the request
    # ends with a 408 error
    deadline: Optional[float] = None
    # multi-tenant QoS: tenant id and its class's priority, "" and 0
    # with QoS off (the scheduler then reads neither)
    tenant: str = ""
    priority: int = 0
    # conversation identity (X-Kaito-Session), kept for tracing
    session: str = ""
    # the ITL recorder's stamp of the last token retired: on the
    # request, so a gap spanning a preemption counts as one stall
    last_emit_time: Optional[float] = None
    # per-request LoRA adapter name ("" = the base model)
    adapter: str = ""
    # P/D disaggregation (engine.pd): the prefill role stages the
    # prompt's KV where the request finishes; the decode role carries
    # one import kind: a one-shot (meta, payload, first_token), a
    # ChunkedImport fed by the server's puller, or a colocated engine's
    # device slabs (meta, slabs, first_token, the gather's event).
    # Imported pages are foreign bytes: exclusive, never committed to
    # the prefix tree
    export_kv: bool = False
    kv_import: Optional[tuple] = None
    kv_chunked: Optional[ChunkedImport] = None
    kv_device: Optional[tuple] = None
    # transient transfer failures left that fall back to local recompute
    kv_retries: int = 0
    # the cluster KV pool: the prompt's chained block hashes, one per
    # whole page; kv_prefix_tokens > 0 marks a pool fetch in flight
    # (kv_chunked holds only that prefix, prefill finishes the rest)
    pool_blocks: list = field(default_factory=list)
    kv_prefix_tokens: int = 0

    @property
    def imported(self) -> bool:
        """The request's prompt KV arrives from outside the engine."""
        return (self.kv_import is not None or self.kv_chunked is not None
                or self.kv_device is not None)

    def resume_tokens(self) -> list[int]:
        """Prompt plus everything generated so far — what a preempted
        request prefills from on re-admission."""
        return list(self.prompt_tokens) + list(self.output_tokens)

    def stream(self):
        """Yield token ids until completion."""
        while True:
            tok = self.out.get()
            if tok is None:
                return
            yield tok


class PageAllocator:
    """Free-list page allocator (page 0 reserved as the null page)."""

    def __init__(self, num_pages: int):
        self.free = list(range(num_pages - 1, 0, -1))
        self.num_pages = num_pages

    @property
    def available(self) -> int:
        return len(self.free)

    def alloc(self, n: int) -> list[int]:
        if n <= 0:
            return []
        if n > len(self.free):
            raise MemoryError(f"need {n} pages, have {len(self.free)}")
        taken = self.free[-n:][::-1]
        del self.free[len(self.free) - n:]
        return taken

    def release(self, pages: list[int]) -> None:
        self.free.extend(reversed(pages))


class _Job:
    """A call the engine thread runs between steps for another thread."""

    def __init__(self, fn):
        self.fn = fn
        self.done = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self.value = self.fn()
        except Exception as e:   # raised in the caller's thread
            self.error = e
        self.done.set()

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.done.set()


@dataclass
class _Slot:
    request: Optional[Request] = None
    pages: list[int] = field(default_factory=list)
    position: int = 0          # next token position (== current length)
    remaining: int = 0
    prefilling: bool = False
    prefill_pos: int = 0       # prompt tokens written so far
    prefill_tokens: list[int] = field(default_factory=list)
    seq: int = 0               # admission order (newest preempts first)
    shared_tokens: int = 0     # leading tokens on pages shared at admission
    prefill_t0: float = 0.0    # first prefill dispatch (0: none yet)
    prefill_base: int = 0      # prefill_pos at that dispatch
    staged_t0: float = 0.0     # admission time
    importing: bool = False    # P/D decode role: KV chunks still landing

    @property
    def written(self) -> int:
        """Tokens whose KV has landed in the cache."""
        return self.prefill_pos if self.prefilling else self.position


class InferenceEngine:
    """Synchronous engine core; the HTTP server drives it via a thread.

    ``params`` is an optional parameter tree (``model.params_from_jax``
    or ``TransformerLM.param_tree`` form, plain or already quantized);
    else ``cfg.weights_dir`` is loaded (streamed by ranged reads when it
    is a ``gs://``, ``http(s)://`` or ``http(s)+token://`` location:
    ``streaming.is_stream_location``), else synthetic weights are drawn
    from ``cfg.seed``.  Under ``cfg.quantization`` the plain projections
    of any of the three are quantized one tensor at a time after the
    cast to the model dtype, as the JAX engine does.

    With a tensor-parallel ``mesh`` (or ``cfg.tensor_parallel`` > 1)
    the model is a :class:`TensorParallelLM`, the cache a list of
    per-shard pools, and ``device`` is the mesh's first device, where
    logits are gathered and sampled.

    Decode windows run through a :class:`DecodeWindow`, captured as CUDA
    graphs on one card.  ``_eager_decode`` (for tests and the card's
    smoke run, as their reference) runs the synchronous loop op by op
    from fresh tensors instead.
    """

    # Loop state the async pipeline keeps on the device.  The scan-
    # advanced fields lag on the host while a window is in flight, so a
    # dirty mark on them drains the pipeline before they are uploaded
    # (uploading a stale mirror would roll the device state back);
    # page_tables is written by the host alone and safe to upload.
    _STATE_FIELDS = ("last_tokens", "positions", "active", "page_tables", "left",
                     "gstate", "slot_adapters")
    _DEVICE_ADVANCED = frozenset(("last_tokens", "positions", "active", "left",
                                  "gstate"))

    def __init__(self, cfg: EngineConfig,
                 metadata: Optional[ModelMetadata] = None,
                 params: Optional[dict] = None,
                 device: str | torch.device = "cuda",
                 mesh: Optional[Mesh] = None,
                 _eager_decode: bool = False):
        check_ported(cfg)
        # multi-tenant QoS: None keeps the single FIFO and newest-
        # preempts-first eviction; a document the port cannot serve
        # raises here
        self.qos = parse_qos_config(cfg.qos_config)
        self.async_dispatch = resolve_async_dispatch(cfg)
        if self.async_dispatch and _eager_decode:
            raise ValueError("the eager reference decode loop is synchronous; "
                             "async_dispatch needs the decode window")
        self.mesh = resolve_mesh(cfg, mesh, device)
        self.device = (self.mesh.devices[0] if self.mesh is not None
                       else resolve_device(device))
        self.cfg = cfg
        self.md = metadata or get_model_by_name(cfg.model)
        check_quantization(cfg, self.md)
        if cfg.kv_dtype not in _DTYPES:
            raise ValueError(f"unknown kv_dtype {cfg.kv_dtype!r} "
                             f"(known: {', '.join(_DTYPES)})")
        arch = self.md.arch
        if self.mesh is not None:
            check_tensor_parallel(arch, self.mesh.size(AXIS_TENSOR),
                                  cfg.quantization)
            self.model = TensorParallelLM(arch, self.mesh, dtype=_DTYPES[cfg.dtype])
        else:
            self.model = TransformerLM(arch, dtype=_DTYPES[cfg.dtype],
                                       device=self.device)
        self.comm_overlap = self._resolve_comm_overlap()
        self.tokenizer = load_tokenizer(self.md.hf_id, arch.vocab_size)
        if not cfg.max_model_len:
            cfg.max_model_len = min(self.md.max_model_len, 8192)
        self.pages_per_seq = cfg.pages_per_seq
        # buckets must cover any admissible prompt (< max_model_len)
        self.buckets = tuple(sorted(
            {b for b in cfg.prefill_buckets if b < cfg.max_model_len}
            | {cfg.max_model_len}))

        t0 = time.monotonic()
        quant = cfg.quantization
        if params is not None:
            self.model.load_params(params, quantization=quant)
        elif streaming.is_stream_location(cfg.weights_dir):
            # streaming load: per-tensor ranged reads, no local copy
            self.model.load_params(streaming.stream_safetensors_params(
                self.model, cfg.weights_dir), quantization=quant)
        elif cfg.weights_dir:
            from kaito_tpu_torch.engine.weights import load_safetensors_params

            self.model.load_params(load_safetensors_params(self.model,
                                                           cfg.weights_dir),
                                   quantization=quant)
        else:
            self.model.init_params(cfg.seed, quantization=quant)
        if self.device.type == "cuda":
            # quantizing leaves freed blocks in the caching allocator; the
            # pool is sized from what the device reports free
            torch.cuda.empty_cache()
        if self.mesh is not None:
            logger.info("tensor parallel: %s%s", self.mesh,
                        " (several shards share a device)" if self.mesh.shared
                        else "")
        logger.info("%sweights ready in %.1fs (%.2f GiB on %s)",
                    f"{quant} " if quant else "", time.monotonic() - t0,
                    self.model.param_bytes() / 2**30, self.device)
        if arch.num_experts:
            logger.info("MoE: %d experts, top-%d, expert products %s",
                        arch.num_experts, arch.num_experts_per_tok,
                        self.model.moe_impl)
        # multi-LoRA: the lanes are resident before the page pool is sized
        self._init_adapters()
        # draft-model speculation: the draft's weights and page pool are
        # resident before the target's pool is sized from what is free
        self.spec_draft: Optional[DraftRunner] = None
        self.spec_ctl: Optional[DepthController] = None
        self._ngram_idx: dict[int, NgramIndex] = {}
        if cfg.speculative_draft:
            self.spec_draft = DraftRunner(self)
            self.spec_ctl = DepthController(cfg.max_num_seqs, cfg.speculative_draft_k)

        self.sizing_report: dict = {}
        num_pages = cfg.max_pages or self._derive_max_pages()
        num_pages = max(num_pages, cfg.max_num_seqs * self.pages_per_seq // 4 + 2)
        if cfg.max_pages:
            self.sizing_report = {"source": "configured"}
        self.sizing_report["pages"] = num_pages
        if self.mesh is not None:
            self.cache = create_sharded_kv_cache(arch, self.mesh.devices, num_pages,
                                                 cfg.page_size, _DTYPES[cfg.kv_dtype])
        else:
            self.cache = create_kv_cache(arch, num_pages, cfg.page_size,
                                         _DTYPES[cfg.kv_dtype], self.device)
        self._kv_quantized = kv_cache_is_quantized(_DTYPES[cfg.kv_dtype])
        logger.info("KV cache: %d pages x %d tokens, %s (%.2f GiB)", num_pages,
                    cfg.page_size, cfg.kv_dtype, kv_bytes(self.cache) / 2**30)
        self._num_pages = num_pages
        # the tree tracks host-side page IDs only, the same ids every
        # shard of a tensor-parallel pool indexes; MLA keeps the plain
        # allocator, as the JAX engine does
        self.prefix_cache: Optional[PrefixCache] = None
        if cfg.enable_prefix_caching and not self.model.is_mla:
            self.prefix_cache = PrefixCache(num_pages, cfg.page_size)
            logger.info("prefix caching enabled (radix tree)")
        self.allocator = self.prefix_cache or PageAllocator(num_pages)
        # a single sequence can never outgrow the whole pool
        self._capacity_tokens = (num_pages - 1) * cfg.page_size
        # the host-RAM KV tier: preempted sequences spill here and resume
        # by restore instead of recompute
        self.host_kv: Optional[HostKVPool] = None
        if cfg.host_kv_offload_bytes > 0:
            self.host_kv = HostKVPool(cfg.host_kv_offload_bytes)
            logger.info("host KV offload tier: %.2f GiB",
                        cfg.host_kv_offload_bytes / 2**30)
        # the cluster KV pool's replica-local store of published prompt
        # prefixes, and below it the slab directory its LRU demotes to
        # through an async spill worker.  None when off: every pool code
        # path and the kv_pool / kv_tier metric families gate on them
        self.kv_pool: Optional[PrefixPageStore] = None
        self.kv_tier: Optional[DiskPageStore] = None
        self._spill_q: Optional[queue.Queue] = None
        self._spill_thread: Optional[threading.Thread] = None
        if cfg.kv_pool_enabled:
            self.kv_pool = PrefixPageStore(cfg.kv_pool_bytes)
            logger.info("cluster KV pool store: %.2f GiB", cfg.kv_pool_bytes / 2**30)
            if cfg.kv_pool_disk_bytes > 0:
                import tempfile

                root = cfg.kv_pool_disk_dir or os.path.join(tempfile.gettempdir(),
                                                            "kaito-kv-tier")
                self.kv_tier = DiskPageStore(root, cfg.kv_pool_disk_bytes)
                self._spill_q = queue.Queue(maxsize=256)
                self.kv_pool.on_evict = self._enqueue_spill
                self._spill_thread = threading.Thread(
                    target=self._spill_worker, daemon=True, name="kv-tier-spill")
                self._spill_thread.start()
                logger.info("KV pool disk tier: %.2f GiB at %s",
                            cfg.kv_pool_disk_bytes / 2**30, root)
        # P/D: staged exports wait here for their pull; the break-even
        # model's constants calibrate from observed transfers and prefills
        self.kv_exports = KVExportRegistry()
        self.pd_costs = TransferCostModel()
        self._last_export_tick = 0.0

        S = cfg.max_num_seqs
        self.slots = [_Slot() for _ in range(S)]
        self.page_tables = np.zeros((S, self.pages_per_seq), np.int32)
        self.positions = np.zeros((S,), np.int32)
        self.active = np.zeros((S,), bool)
        self.last_tokens = np.zeros((S,), np.int32)
        self._remaining = np.zeros((S,), np.int32)
        self.slot_adapters = np.zeros((S,), np.int32)   # 0 = the base lane
        self.sampling = SamplingState.create(S, cfg.seed, self.device)
        # penalty state allocates on the first penalized admission
        self.token_counts: Optional[torch.Tensor] = None   # [S, V] int32
        self.prompt_seen: Optional[torch.Tensor] = None    # [S, V] bool
        # grammar-constrained decoding: the compiled-schema LRU always
        # exists (the server compiles against it before admission); the
        # packed table, on the host and the device, is allocated on the
        # first constrained admission, so an unconstrained engine never
        # holds or reads it.  _gram_state is each slot's absolute table
        # row (0: unconstrained), advanced by _emit
        self.grammar_cache = GrammarCache(entries=cfg.grammar_cache_entries,
                                          max_states=cfg.grammar_max_states)
        self._gram_table: Optional[GrammarTable] = None
        self._gram_slots: list[Optional[GrammarSlot]] = [None] * S
        self._gram_state = np.zeros((S,), np.int32)
        self._gmask: Optional[torch.Tensor] = None     # [capacity, V] fp32
        self._gtrans: Optional[torch.Tensor] = None    # [capacity, V] int32
        # the larger (gmask, gtrans) an admission allocated before the
        # install that grows the host table moves to them
        self._gram_next: Optional[tuple] = None
        self._gram_host: Optional[np.ndarray] = None   # the table's uploaded arrays
        self._gram_used = 0
        self._gram_version = 0
        # table uploads: how many, their bytes, the last one's rows;
        # graphs dropped with a replaced table
        self.grammar_device_stats = {"uploads": 0, "upload_bytes": 0,
                                     "last_upload_rows": 0, "graphs_dropped": 0}

        self.waiting: "collections.deque[Request]" = collections.deque()
        # requests waiting, in self.waiting or (with QoS) the per-tenant
        # deques, which the DRR order of each priority visits
        self._waiting_count = 0
        self._tenant_queues: dict[str, "collections.deque[Request]"] = {}
        self._drr_order: dict[int, "collections.deque[str]"] = {}
        self._drr_deficit: dict[str, float] = {}
        self._last_deadline_sweep = 0.0
        # the clock of deadlines and their sweep (tests inject theirs)
        self._now = time.monotonic
        # work the engine thread runs between steps (prompt scoring)
        self._jobs: "queue.SimpleQueue[_Job]" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._decode_since_prefill = 0
        self._prefill_rr = 0
        self._admit_seq = 0
        self._batch_epoch = 0
        self._stop_cache: tuple = (-1, None)

        self.counters = {
            "prompt_tokens_total": 0,
            "generation_tokens_total": 0,
            "requests_total": 0,
            "requests_finished_total": 0,
            "requests_failed_total": 0,
            "prefill_steps_total": 0,
            "prefill_tokens_total": 0,
            "prefill_packed_steps_total": 0,
            "decode_steps_total": 0,
            "decode_windows_total": 0,
            "preemptions_total": 0,
            "engine_fatal_total": 0,
            "prefix_cached_tokens_total": 0,
            # per-request prefix-cache outcome (a resume does not count)
            "prefix_cache_hits_total": 0,
            "prefix_cache_misses_total": 0,
            "requests_expired_total": 0,
            "requests_shed_total": 0,       # 429s (bumped by the server)
            "host_kv_spilled_pages_total": 0,
            "host_kv_restored_pages_total": 0,
            # speculation: the three spec_* totals are the n-gram
            # proposer's, the spec_draft_* ones the draft model's
            "spec_steps_total": 0,
            "spec_proposed_tokens_total": 0,
            "spec_accepted_tokens_total": 0,
            "spec_draft_steps_total": 0,
            "spec_draft_rows_total": 0,
            "spec_draft_proposed_tokens_total": 0,
            "spec_draft_accepted_tokens_total": 0,
            # KV movement: colocated hand-offs, transient transfer
            # failures recomputed; the pool's and the disk tier's
            # counters reach /metrics only with those on
            "pd_device_handoffs_total": 0,
            "kv_import_retries_total": 0,
            "kv_pool_fetches_total": 0,
            "kv_pool_fetched_tokens_total": 0,
            "kv_pool_fetch_failures_total": 0,
            "kv_pool_published_total": 0,
            "kv_tier_host_hits_total": 0,
            "kv_tier_disk_hits_total": 0,
            "kv_tier_import_tokens_total": 0,
            "kv_tier_spill_drops_total": 0,
        }
        # tracing + flight recorder: bounded, always on, host clocks
        # only — recording is a deque append, scrapes snapshot.  The
        # server's metrics registry adopts the histograms
        self.tracer = RingTracer(cfg.trace_capacity)
        self.timeline = StepTimeline(cfg.timeline_capacity)
        self.step_hist = Histogram(
            "kaito:engine_step_seconds", "Scheduler step wall time", None,
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5))
        self.queue_wait_hist = Histogram(
            "kaito:queue_wait_seconds",
            "Submit-to-admission queue wait", None,
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0, 30.0))
        self.prefill_pack_hist = Histogram(
            "kaito:engine_prefill_pack_size",
            "Sequences packed per prefill dispatch", None,
            buckets=(1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0))
        self.prefill_wait_hist = Histogram(
            "kaito:prefill_queue_wait_seconds",
            "Staged-to-first-prefill-dispatch wait", None,
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0))
        self._prefill_pack_note = 0
        self._gap_last = 0.0
        # true per-token inter-token latency (cfg.itl_enabled, else
        # KAITO_ITL): _emit stamps the host clock as it retires each
        # token and observes the gap since the request's previous one.
        # Off: itl_hist is None and _emit does no extra work
        self.itl_enabled = bool(cfg.itl_enabled or os.environ.get(
            "KAITO_ITL", "") in ("1", "true"))
        self.itl_hist: Optional[Histogram] = None
        # the server wires this to SLOWatchdog.observe_itl(gap, tenant)
        self.itl_observer = None
        self._itl_time = time.monotonic
        if self.itl_enabled:
            self._itl_stall_s = max(1e-6, float(cfg.slo_itl_p99_ms) * 1e-3)
            self.counters["itl_stalls_total"] = 0
            self.itl_hist = Histogram(
                "kaito:inter_token_latency_seconds",
                "True per-token inter-token latency (gap between "
                "consecutive emitted tokens of one request)", None,
                buckets=(0.002, 0.005, 0.01, 0.02, 0.04, 0.06, 0.08,
                         0.1, 0.25, 0.5, 1.0, 2.5))
        ra = cfg.decode_run_ahead
        if ra is None:
            ra = AUTO_RUN_AHEAD_CUDA if self.device.type == "cuda" else 1
        self.run_ahead = max(1, int(ra))

        self.window: Optional[DecodeWindow] = None
        if not _eager_decode:
            capture = self.mesh is None and self.device.type == "cuda"
            self.window = DecodeWindow(self._decode_step, S, self.pages_per_seq,
                                       _STOP_WIDTH, self.device, capture,
                                       self.counters)
            if self.mesh is not None:
                logger.info("tensor parallel: decode windows run eagerly, not as "
                            "CUDA graphs (ROADMAP item 35)")
        # the verify window (and the draft's scan) share the decode
        # window's graph pool; they capture where it does
        self.spec_verify: Optional[VerifyWindow] = None
        if cfg.speculative_ngram > 0 or self.spec_draft is not None:
            W = cfg.speculative_ngram + 1
            if self.spec_draft is not None:
                W = max(cfg.speculative_draft_k, cfg.speculative_ngram) + 1
            capture = self.window is not None and self.window.capture
            pool = self.window.pool if capture else None
            B = cfg.speculative_max_batch
            if self.spec_draft is not None:
                self.spec_draft.attach(B, W, capture, pool)
            self.spec_verify = VerifyWindow(self, B, W, capture, pool, self.spec_draft)
        # two host copies of window traces: one in flight, one retiring
        self._readbacks = (TraceReadback(self.device), TraceReadback(self.device))
        self._windows = 0
        self._stop_epoch = -1
        # the async pipeline (docs/decode-loop.md of the JAX package):
        # fields to upload before the next dispatch, the window in
        # flight (K, its readback), and the device-idle gap before each
        # dispatch
        self._dirty: set[str] = set(self._STATE_FIELDS)
        self._inflight: Optional[tuple] = None
        self._last_ready_t = 0.0
        self.dispatch_gap_hist: Optional[Histogram] = None
        if self.async_dispatch:
            self.counters["h2d_uploads_total"] = 0
            self.dispatch_gap_hist = Histogram(
                "kaito:engine_dispatch_gap_seconds",
                "Host-side gap between decode dispatches (device idle "
                "between windows; ~0 when the pipeline is primed)", None,
                buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                         0.01, 0.025, 0.05, 0.1, 0.25))
            logger.info("async decode dispatch enabled (two-deep pipeline, "
                        "device-resident loop state)")
        # sampled device-time attribution.  Off by default: no sampler
        # thread, no kaito:device_* families, /debug/device 403
        self.devprof: Optional[DeviceProfiler] = None
        if cfg.devprof_interval_s > 0:
            self.devprof = DeviceProfiler(
                interval_s=cfg.devprof_interval_s, window_s=cfg.devprof_window_s,
                ring=cfg.devprof_ring, roofline=self._devprof_roofline(),
                tokens_fn=lambda: self.counters["generation_tokens_total"],
                cuda=self.device.type == "cuda",
                captures_fn=lambda: sum(n for k, n in self.counters.items()
                                        if k.endswith("_captures_total")),
                dispatches_fn=lambda: sum(self.counters[k] for k in (
                    "prefill_steps_total", "decode_windows_total", "spec_steps_total",
                    "spec_draft_steps_total")))
            logger.info("device profiler enabled: %.3gs window every %.3gs",
                        self.devprof.window_s, self.devprof.interval_s)
            # a capture drops the window open on the engine thread
            for graphs in (self.window, self.spec_verify,
                           self.spec_draft.scan if self.spec_draft is not None else None):
                if graphs is not None:
                    graphs.before_capture = self.devprof.before_capture

    # ------------------------------------------------------------------
    # Construction helpers
    # ------------------------------------------------------------------

    def _init_adapters(self) -> None:
        """The JAX engine's boot path: with ``adapter_slots`` the two-tier
        cache (its lanes allocated now, the directory's adapters loaded
        into it); else the directory's adapters stacked into fixed lanes,
        or merged into the base weights when the model has no sites.
        Nothing at all without adapter config."""
        cfg = self.cfg
        self.adapter_index: dict[str, int] = {}
        self.adapters_merged = False
        self.adapter_cache: Optional[AdapterCache] = None
        # refusal reason -> count (kaito:adapter_load_failures_total)
        self.adapter_load_failures: dict[str, int] = {}
        if cfg.adapter_slots > 0 and not self.model.is_mla:
            self.adapter_cache = AdapterCache(
                self.model, slots=cfg.adapter_slots, rmax=cfg.adapter_rmax,
                base_model=self.md.name, host_bytes=cfg.adapter_host_bytes,
                allow_base_mismatch=cfg.adapter_allow_base_mismatch)
            self.adapter_cache.busy_fn = self._adapter_busy
            self.adapter_load_failures = self.adapter_cache.load_failures
            # the cache's residency map, mutated in place
            self.adapter_index = self.adapter_cache.name_to_slot
            for name, path in discover_adapters(cfg.adapters_dir).items():
                try:
                    self.adapter_cache.load_from_path(name, path)
                except AdapterLoadError:
                    pass        # counted and logged by the cache
        elif cfg.adapters_dir or cfg.adapter_slots > 0:
            if cfg.adapter_slots > 0:
                logger.warning("adapter cache requested but MLA has no adapter "
                               "sites; falling back to boot-time discovery")
            serve_lora, self.adapter_index = load_adapter_stacks(
                self.model, cfg.adapters_dir, self.md.name,
                allow_base_mismatch=cfg.adapter_allow_base_mismatch,
                refusals=self.adapter_load_failures)
            if serve_lora:
                self.model.set_lora(serve_lora)
            elif discover_adapters(cfg.adapters_dir):
                if self.mesh is not None:
                    raise NotImplementedError(
                        "merging adapters into tensor-parallel shards")
                # no sites (MLA) or no routable targets: merge into the base
                # weights, so the advertised adapters still take effect
                self.model.load_params(apply_adapters_to_params(
                    self.model, self.model.param_tree(), cfg.adapters_dir))
                self.adapters_merged = True

    def _devprof_roofline(self) -> dict:
        """The card's peaks and the model's weight stream for devprof's
        achieved-vs-peak window rates (no per-sequence KV term: the
        batch changes mid-window, so the weights are the stable lower
        bound).  A CPU engine, or a card the peak table lacks, gets 0
        peaks."""
        card = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "")
        return roofline(card, self.cfg.quantization, self.md.arch.param_count())

    def _resolve_comm_overlap(self) -> bool:
        """The collective-compute overlap gate (``cfg.comm_overlap``; None
        follows KAITO_COMM_OVERLAP, off when unset).  It engages only on a
        TP >= 2 mesh whose ring axis divides the hidden size, heads and
        intermediate width, and then sends decode's row-parallel
        projections through the pipelined ring; otherwise it stays off
        with a warning."""
        cfg, arch = self.cfg, self.md.arch
        co = cfg.comm_overlap if cfg.comm_overlap is not None else (
            os.environ.get("KAITO_COMM_OVERLAP", "").strip().lower()
            not in ("", "0", "false", "off"))
        if not co:
            return False
        ax = ring_axis(SERVE_RULES)
        tp = self.mesh.size(ax) if ax and self.mesh is not None else 1
        if tp >= 2 and arch.hidden_size % tp == 0 and arch.num_heads % tp == 0 \
                and arch.intermediate_size % tp == 0:
            self.model.overlap = True
            logger.info("collective-compute overlap: ring TP decode (%s=%d, %d "
                        "hops per projection)", ax, tp, tp - 1)
            return True
        logger.warning("comm-overlap requested but not applicable (ring axis=%s "
                       "size=%d, embed=%d heads=%d intermediate=%d must all "
                       "divide); keeping the unoverlapped path", ax, tp,
                       arch.hidden_size, arch.num_heads, arch.intermediate_size)
        return False

    def _derive_max_pages(self) -> int:
        """Size the page pool from free device memory, measured with
        ``torch.cuda.mem_get_info`` after the weights are resident; the
        CPU sizes for ``max_num_seqs`` full contexts.  A tensor-parallel
        page holds 1/n of the KV heads on each shard, and a device holds
        a page for every shard it carries, so the pool is sized by the
        device with the least room per page."""
        cap = self.cfg.max_num_seqs * self.pages_per_seq
        if self.device.type == "cpu":
            self.sizing_report = {"source": "seq-cap"}
            return cap + 1
        kv_dtype = _DTYPES[self.cfg.kv_dtype]
        el = torch.empty((), dtype=kv_dtype).element_size()
        page_bytes = self.md.kv_bytes_per_token(el) * self.cfg.page_size
        if kv_cache_is_quantized(kv_dtype):
            # each page also carries its fp32 k and v scales per layer and head
            page_bytes += scale_bytes_per_page(self.md.arch)
        devices = self.mesh.devices if self.mesh is not None else [self.device]
        pages, report = None, []
        for dev in dict.fromkeys(devices):
            share = devices.count(dev) / len(devices)
            free, total = torch.cuda.mem_get_info(dev)
            reserve = max(int(total * _RESERVE_FRACTION), _RESERVE_MIN_BYTES)
            fit = int(max(free - reserve, 0) // (page_bytes * share))
            pages = fit if pages is None else min(pages, fit)
            report.append({"device": str(dev), "device_total_bytes": int(total),
                           "free_after_weights_bytes": int(free),
                           "reserve_bytes": reserve})
        self.sizing_report = dict(report[0], source="measured",
                                  weights_bytes=self.model.param_bytes())
        if len(report) > 1:
            self.sizing_report["devices"] = report
        return max(2, min(pages, cap) + 1)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket {self.buckets[-1]}")

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the engine's device; on the card through pinned
        memory, so the copy does not block the host."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    @property
    def num_waiting(self) -> int:
        return self._waiting_count

    @property
    def num_running(self) -> int:
        return int(self.active.sum())

    def submit(self, prompt_tokens: list[int], params: SamplingParams,
               req_id: Optional[str] = None,
               trace_id: Optional[str] = None,
               timeout_s: Optional[float] = None,
               tenant: str = "", priority: str = "",
               adapter: str = "", export_kv: bool = False,
               pool_blocks: Optional[list] = None) -> Request:
        """Queue a request.  ``timeout_s`` (else ``request_timeout_s``;
        0 is none) sets its deadline; ``tenant`` and ``priority`` (a
        class name) place it under QoS; ``adapter`` names its LoRA
        adapter (ValueError when unknown; a demoted one faults back in
        here).  ``export_kv`` (the P/D prefill role) stages the prompt's
        KV where the request finishes; ``pool_blocks`` (the prompt's
        block hashes) publishes its whole pages to the KV pool."""
        self._validate_submit(prompt_tokens, params)
        self._resolve_adapter(adapter)
        return self._enqueue(Request(
            req_id or "", list(prompt_tokens), params, adapter=adapter,
            export_kv=export_kv, pool_blocks=list(pool_blocks or [])),
            "req", trace_id, timeout_s, tenant, priority)

    def _validate_submit(self, prompt_tokens: list[int], params: SamplingParams) -> None:
        n = len(prompt_tokens)
        if n < 1:
            raise ValueError("prompt must hold at least one token")
        if n >= self.cfg.max_model_len:
            raise ValueError(f"prompt length {n} exceeds max_model_len "
                             f"{self.cfg.max_model_len}")
        if n + 1 > self._capacity_tokens:
            raise ValueError(f"prompt length {n} exceeds KV pool capacity "
                             f"{self._capacity_tokens} tokens")
        if params.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {params.max_tokens}")

    def _enqueue(self, req: Request, prefix: str, trace_id: Optional[str],
                 timeout_s: Optional[float], tenant: str, priority: str) -> Request:
        """Queue a validated request (every submit path): its QoS
        identity, deadline and trace id, and ``<prefix>-<count>`` for an
        id the caller left empty."""
        req.tenant, req.priority = self._resolve_qos(tenant, priority)
        req.deadline = self._deadline_for(timeout_s)
        with self._lock:
            self.counters["requests_total"] += 1
            req.req_id = req.req_id or f"{prefix}-{self.counters['requests_total']}"
            req.trace_id = trace_id or req.trace_id or req.req_id
            self._waiting_count += 1
            if self.qos is None:
                self.waiting.append(req)
            else:
                self._qos_push_locked(req)
        self._wake.set()
        return req

    # -- KV movement (P/D and the cluster KV pool) ------------------------

    def _validate_kv_meta(self, meta: dict, n_prompt: int,
                          strict_shape: bool = False) -> None:
        """Refuse an incompatible hand-off in the REQUEST thread (a clean
        4xx) before it reaches the scheduler: model identity, token count
        and dtype always; with ``strict_shape`` (the colocated device
        path, whose slabs land in the pool as they are) the slab's layer
        count, page count and per-page layout too.  Chunked imports are
        checked chunk by chunk as they assemble."""
        if meta.get("model") not in ("", None, self.md.name):
            raise ValueError(f"KV transfer model mismatch: {meta.get('model')} "
                             f"!= {self.md.name}")
        if meta.get("n_tokens") not in (None, n_prompt):
            raise ValueError(f"KV transfer token mismatch: client sent {n_prompt} "
                             f"prompt tokens, staged slab holds {meta.get('n_tokens')}")
        self._check_wire_dtype(meta, "KV transfer")
        shape = meta.get("shape")
        if not strict_shape or not shape:
            return
        shape = tuple(int(s) for s in shape)
        c = self._shard_caches()
        tail = list(c[0].k.shape[2:])
        tail[1] *= len(c)
        n_pages = -(-n_prompt // self.cfg.page_size)
        # the page count is a floor: an exporter may ship a rounded-up slab
        if len(shape) != 5 or shape[0] != c[0].k.shape[0] \
                or shape[2:] != tuple(tail) or shape[1] < n_pages:
            raise ValueError(
                f"KV slab incompatible with this engine: wire shape {shape}, pool "
                f"expects ({c[0].k.shape[0]}, >={n_pages}) + {tuple(tail)} (layers, "
                f"prompt pages, page_size, kv heads, head dim)")

    def _check_wire_dtype(self, meta: dict, what: str) -> None:
        wire = meta.get("dtype")
        pool = self._shard_caches()[0].k.dtype
        if wire is not None and wire_dtype(wire) != pool:
            raise ValueError(f"{what} dtype mismatch: wire {wire} vs pool "
                             f"{str(pool).removeprefix('torch.')} — prefill and decode "
                             f"roles must run the same --kv-cache-dtype")

    def submit_with_kv(self, prompt_tokens: list[int], first_token: int,
                       meta: dict, payload: bytes, params: SamplingParams,
                       req_id: Optional[str] = None,
                       timeout_s: Optional[float] = None,
                       trace_id: Optional[str] = None,
                       tenant: str = "", priority: str = "") -> Request:
        """Decode-role entry: continue a prefilled request from a one-shot
        transfer of its KV pages (``pd.export_kv``'s payload)."""
        self._validate_submit(prompt_tokens, params)
        self._validate_kv_meta(meta, len(prompt_tokens))
        return self._enqueue(Request(req_id or "", list(prompt_tokens), params,
                                     kv_import=(meta, payload, first_token)),
                             "pd", trace_id or meta.get("trace_id"), timeout_s,
                             tenant, priority)

    def submit_with_kv_device(self, prompt_tokens: list[int], first_token: int,
                              meta: dict, slabs, params: SamplingParams,
                              req_id: Optional[str] = None,
                              timeout_s: Optional[float] = None,
                              trace_id: Optional[str] = None,
                              tenant: str = "", priority: str = "",
                              adapter: str = "", event=None) -> Request:
        """Colocated decode entry: the prefill engine lives in this
        process, and its staged canonical slabs (``device_slabs()``) are
        copied device to device into this engine's pages (a peer copy
        across two cards), ordered after ``event``, the export's gather
        event.  ``adapter`` continues under the prefill's adapter (the
        server checks the staged meta first)."""
        self._validate_submit(prompt_tokens, params)
        self._resolve_adapter(adapter)
        self._validate_kv_meta(meta, len(prompt_tokens), strict_shape=True)
        return self._enqueue(Request(req_id or "", list(prompt_tokens), params,
                                     adapter=adapter,
                                     kv_device=(meta, slabs, first_token, event)),
                             "pd", trace_id or meta.get("trace_id"), timeout_s,
                             tenant, priority)

    def submit_with_kv_chunked(self, prompt_tokens: list[int], first_token: int,
                               meta: dict, plans, params: SamplingParams,
                               req_id: Optional[str] = None,
                               deadline_s: float = 120.0,
                               timeout_s: Optional[float] = None,
                               trace_id: Optional[str] = None,
                               tenant: str = "", priority: str = "",
                               adapter: str = "") -> Request:
        """Decode-role entry of the chunked wire: the request is admitted
        at once and the loop assembles its chunks as the caller feeds
        ``req.kv_chunked.feed(i, payload)``, beside other requests'
        decode."""
        self._validate_submit(prompt_tokens, params)
        self._resolve_adapter(adapter)
        self._validate_kv_meta(meta, len(prompt_tokens))
        return self._enqueue(Request(
            req_id or "", list(prompt_tokens), params, adapter=adapter,
            kv_chunked=ChunkedImport(meta, list(plans), first_token, deadline_s=deadline_s),
            kv_retries=max(0, self.cfg.kv_import_retries)),
            "pd", trace_id or meta.get("trace_id"), timeout_s, tenant, priority)

    def submit_with_kv_prefix(self, prompt_tokens: list[int], meta: dict, plans,
                              n_prefix_tokens: int, params: SamplingParams,
                              req_id: Optional[str] = None,
                              deadline_s: float = 30.0,
                              timeout_s: Optional[float] = None,
                              trace_id: Optional[str] = None,
                              tenant: str = "", priority: str = "",
                              adapter: str = "",
                              pool_blocks: Optional[list] = None) -> Request:
        """Cluster-pool entry: a verified whole-page PREFIX of the
        prompt's KV is on its way over the chunked wire (from a peer, the
        host store or the disk tier), and the local prefill finishes the
        rest once it lands.  Any failure falls back to a full local
        prefill."""
        self._validate_submit(prompt_tokens, params)
        self._resolve_adapter(adapter)
        if meta.get("model") not in ("", None, self.md.name):
            raise ValueError(f"KV pool model mismatch: {meta.get('model')} "
                             f"!= {self.md.name}")
        # the adapter folds into the hash chain, but the meta decides:
        # KV computed under another adapter's deltas never imports
        if str(meta.get("adapter") or "") != (adapter or ""):
            raise ValueError(f"KV pool adapter mismatch: entry "
                             f"{meta.get('adapter') or 'base'!r} vs request "
                             f"{adapter or 'base'!r}")
        self._check_wire_dtype(meta, "KV pool")
        ps = self.cfg.page_size
        if not (0 < n_prefix_tokens < len(prompt_tokens) and n_prefix_tokens % ps == 0):
            raise ValueError(f"prefix token count {n_prefix_tokens} must be a positive "
                             f"whole-page multiple below the prompt length "
                             f"{len(prompt_tokens)}")
        return self._enqueue(Request(
            req_id or "", list(prompt_tokens), params, adapter=adapter,
            kv_chunked=ChunkedImport(meta, list(plans), -1, deadline_s=deadline_s),
            kv_prefix_tokens=n_prefix_tokens, pool_blocks=list(pool_blocks or [])),
            "kvp", trace_id, timeout_s, tenant, priority)

    # -- multi-LoRA admin ------------------------------------------------

    def _resolve_adapter(self, adapter: str) -> None:
        """Validate an adapter for a submission; with the cache, a demoted
        one is faulted back into a slot on the engine thread."""
        if not adapter:
            return
        if self.adapter_cache is not None:
            try:
                self._on_engine_thread(lambda: self.adapter_cache.ensure(adapter))
            except KeyError:
                raise ValueError(f"unknown adapter {adapter!r}") from None
        elif adapter not in self.adapter_index:
            raise ValueError(f"unknown adapter {adapter!r}")

    def _adapter_busy(self, name: str) -> bool:
        """In-flight work references the adapter: a slot's request
        (prefilling or decoding) or a queued one.  A busy adapter is
        pinned: the cache neither evicts nor overwrites it."""
        if getattr(self, "_tenant_queues", None) is None:
            return False        # boot: nothing in flight yet
        if any(s.request is not None and s.request.adapter == name
               for s in self.slots):
            return True
        with self._lock:
            if any(r.adapter == name for r in self.waiting):
                return True
            return any(r.adapter == name for q in self._tenant_queues.values()
                       for r in q)

    def adapter_snapshot(self) -> Optional[dict]:
        """The ``GET /v1/adapters`` payload; None when the cache is off."""
        if self.adapter_cache is None:
            return None
        return self.adapter_cache.snapshot()

    def load_adapter_dynamic(self, name: str, path: str) -> int:
        """Hot-load an artifact directory into a slot (POST /v1/adapters):
        read here, written into its lane on the engine thread.  Raises
        AdapterLoadError (a ValueError) on refusal, AdapterBusyError when
        in-flight work pins the adapter."""
        if self.adapter_cache is None:
            raise RuntimeError("adapter cache is not enabled")
        adapter, r, scaling, base = self.adapter_cache.read(name, path)
        return self._on_engine_thread(lambda: self.adapter_cache.install(
            name, adapter, r=r, scaling=scaling, base=base))

    def delete_adapter(self, name: str) -> bool:
        """Drop an adapter from both tiers (DELETE /v1/adapters), on the
        engine thread.  AdapterBusyError while in-flight work pins it."""
        if self.adapter_cache is None:
            raise RuntimeError("adapter cache is not enabled")
        return self._on_engine_thread(lambda: self.adapter_cache.remove(name))

    def _adapter_live(self) -> bool:
        """Whether a slot holds an adapter request: windows then read the
        lanes."""
        return bool(self.slot_adapters.any())

    def _deadline_for(self, timeout_s: Optional[float]) -> Optional[float]:
        """Absolute monotonic deadline from a per-request timeout,
        falling back to the server default (0 = no deadline)."""
        t = timeout_s if timeout_s else self.cfg.request_timeout_s
        return (self._now() + float(t)) if t else None

    def _resolve_qos(self, tenant: str, priority: str) -> tuple[str, int]:
        """(tenant id, numeric class priority) for a submission.  With
        QoS off the tenant rides along for tracing only and priority
        stays 0."""
        if self.qos is None:
            return tenant or "", 0
        t = tenant or DEFAULT_TENANT
        return t, self.qos.class_of(t, priority).priority

    def score_prompt(self, tokens: list[int]) -> list:
        """log p of each prompt token given its prefix, None for the
        first (the ``echo`` + ``logprobs`` + ``max_tokens: 0`` contract).
        The prompt pads to a multiple of 128 tokens (at least 128),
        outside the prefill buckets, so any prompt under max_model_len
        scores.  The forward runs on the engine thread between two
        steps (:meth:`_on_engine_thread`); its failure is raised here."""
        n = len(tokens)
        if n < 1:
            return []
        if n >= self.cfg.max_model_len:
            raise ValueError(f"prompt length {n} exceeds max_model_len "
                             f"{self.cfg.max_model_len}")
        bucket = max(128, -(-n // 128) * 128)
        buf = np.zeros((1, bucket), np.int32)
        buf[0, :n] = tokens
        lens = np.asarray([n], np.int32)
        lp = self._on_engine_thread(lambda: self.model.score(
            self._tensor(buf), self._tensor(lens)).cpu().numpy())
        return [None] + [float(x) for x in lp[:n - 1]]

    def _on_engine_thread(self, fn):
        """``fn()`` run on the engine thread between two steps, its
        result returned (its exception raised) here; inline when no loop
        runs, or when called from the loop.  A launch from another
        thread would land inside a decode window's capture, and the
        kernels' per-card workspaces and launch counters are the loop's."""
        t = self._thread
        if t is None or not t.is_alive() or threading.current_thread() is t:
            with torch.no_grad():
                return fn()
        job = _Job(fn)
        self._jobs.put(job)
        self._wake.set()
        while not job.done.wait(0.5):
            if not t.is_alive() and not job.done.is_set():
                raise RuntimeError("the engine stopped before the job ran")
        if job.error is not None:
            raise job.error
        return job.value

    def _run_jobs(self) -> None:
        while True:
            try:
                job = self._jobs.get_nowait()
            except queue.Empty:
                return
            with torch.no_grad():
                job.run()

    def abort(self, req: Request) -> None:
        """Cancel; the scheduler retires the slot at its next touch."""
        req.aborted = True
        self._wake.set()

    def generate(self, prompt: str, params: Optional[SamplingParams] = None) -> str:
        """Blocking single-request helper (needs a started engine)."""
        req = self.submit(self.tokenizer.encode(prompt), params or SamplingParams())
        return self.tokenizer.decode(list(req.stream()))

    def start(self):
        if self.devprof is not None:
            # the engine thread opens and closes the sampler's windows;
            # the profiler's first start (seconds) runs before it does
            self.devprof.attached = True
            self.devprof.start()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="engine-loop")
        self._thread.start()

    def _enqueue_spill(self, entry: PoolEntry) -> None:
        """The pool store's eviction hook, on whatever thread evicted
        (usually the engine loop finishing a request): a non-blocking
        put; a full queue drops the victim, which is always safe."""
        try:
            self._spill_q.put_nowait(entry)
        except queue.Full:
            self.counters["kv_tier_spill_drops_total"] += 1

    def _spill_worker(self) -> None:
        """Demote evicted pool entries to the disk tier, off the engine
        loop (serializing a chunk may wait on its export's drain)."""
        while True:
            entry = self._spill_q.get()
            if entry is None:
                return
            try:
                self.kv_tier.spill(entry)
            except Exception:
                logger.exception("kv_tier spill of %s failed", entry.key)

    def stop(self):
        if self.devprof is not None:
            self.devprof.stop()
        self._stop.set()
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=30)
        if self._spill_thread is not None:
            self._spill_q.put(None)
            self._spill_thread.join(timeout=10)
            self._spill_thread = None
        # nothing else would deliver end-of-stream to in-flight clients
        self._fail_all()
        while True:
            try:
                self._jobs.get_nowait().fail(RuntimeError("the engine stopped"))
            except queue.Empty:
                break

    # ------------------------------------------------------------------
    # Scheduler loop
    # ------------------------------------------------------------------

    def _loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        dp = self.devprof
        while not self._stop.is_set():
            if dp is not None:
                dp.at_step_boundary()
            self._run_jobs()
            try:
                did_work = self.step()
            except Exception:
                # a scheduler-loop failure must not strand waiting clients
                logger.exception("engine loop failure; failing in-flight requests")
                self.counters["engine_fatal_total"] += 1
                self._fail_all()
                continue
            if not did_work:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
        if dp is not None:
            dp.at_step_boundary(closing=True)

    def _pop_waiting(self) -> Optional[Request]:
        with self._lock:
            if self.qos is not None:
                return self._qos_pop_locked()
            if not self.waiting:
                return None
            self._waiting_count -= 1
            return self.waiting.popleft()

    def _requeue_front(self, req: Request):
        with self._lock:
            self._waiting_count += 1
            if self.qos is None:
                self.waiting.appendleft(req)
            else:
                self._qos_push_locked(req, front=True)

    # -- QoS admission queues ------------------------------------------
    #
    # Per-tenant deques behind the same num_waiting/_pop/_requeue
    # surface: admission pops strict-priority across classes and
    # deficit-round-robin across tenants within a class, so one noisy
    # tenant can neither starve a guaranteed class nor crowd out its
    # own-priority peers beyond its weight.  All helpers assume
    # self._lock is held.

    def _qos_push_locked(self, req: Request, front: bool = False) -> None:
        q = self._tenant_queues.get(req.tenant)
        if q is None:
            q = self._tenant_queues[req.tenant] = collections.deque()
        order = self._drr_order.setdefault(req.priority, collections.deque())
        if front:
            q.appendleft(req)
            if req.tenant in order:
                order.remove(req.tenant)
            order.appendleft(req.tenant)
            # a preempted resume must not wait out a DRR rotation: top
            # the tenant's deficit up to one service
            self._drr_deficit[req.tenant] = max(
                self._drr_deficit.get(req.tenant, 0.0), 1.0)
        else:
            q.append(req)
            if req.tenant not in order:
                order.append(req.tenant)

    def _qos_pop_locked(self) -> Optional[Request]:
        for prio in sorted(self._drr_order, reverse=True):
            order = self._drr_order[prio]
            # every full rotation grants each tenant its weight of
            # deficit (weight >= 1), so two passes guarantee a service
            for _ in range(2 * len(order) + 1):
                if not order:
                    break
                t = order[0]
                q = self._tenant_queues.get(t)
                if not q:
                    # emptied by an expiry sweep
                    order.popleft()
                    self._drr_deficit.pop(t, None)
                    continue
                if self._drr_deficit.get(t, 0.0) < 1.0:
                    self._drr_deficit[t] = (self._drr_deficit.get(t, 0.0)
                                            + self.qos.weight_of(t))
                    order.rotate(-1)
                    continue
                self._drr_deficit[t] -= 1.0
                req = q.popleft()
                self._waiting_count -= 1
                if not q:
                    del self._tenant_queues[t]
                    order.remove(t)
                    self._drr_deficit.pop(t, None)
                if not order:
                    del self._drr_order[prio]
                return req
            if not order:
                del self._drr_order[prio]
        return None

    def num_waiting_for(self, tenant: str) -> int:
        """Waiting-queue depth for ONE tenant (per-tenant rate-limit
        budgets); the global count with QoS off."""
        if self.qos is None:
            return self._waiting_count
        with self._lock:
            q = self._tenant_queues.get(tenant)
            return len(q) if q else 0

    def _peek_waiting_priority(self) -> Optional[int]:
        """Highest priority class with a queued request (QoS only)."""
        with self._lock:
            for prio in sorted(self._drr_order, reverse=True):
                if any(self._tenant_queues.get(t) for t in self._drr_order[prio]):
                    return prio
        return None

    def _fail_request(self, req: Request) -> None:
        req.finish_reason = "error"
        req.finish_time = time.monotonic()
        if req.error is None:
            req.error = {"status": 500, "type": "internal_error",
                         "message": f"request {req.req_id} failed in the engine"}
        if self.host_kv is not None:
            self.host_kv.discard(req.req_id)
        self.counters["requests_failed_total"] += 1
        self._finish_trace(req)
        req.out.put(None)

    def _expire_request(self, req: Request) -> None:
        """Deadline abort: a 408 structured error; the request consumes
        no (or no more) device time."""
        req.finish_reason = "deadline"
        req.finish_time = time.monotonic()
        if req.error is None:
            req.error = {"status": 408, "type": "deadline_exceeded",
                         "message": f"request {req.req_id} exceeded its "
                                    f"deadline before completing"}
        if self.host_kv is not None:
            self.host_kv.discard(req.req_id)
        self.counters["requests_expired_total"] += 1
        self._finish_trace(req)
        req.out.put(None)

    def _sweep_deadlines(self) -> bool:
        """The deadline sweep, at most every :data:`_DEADLINE_SWEEP_S`.
        A slot's expiry evicts it, which reads the host mirrors: with a
        window in flight and a live slot under a deadline, the pipeline
        drains first."""
        now = self._now()
        if now - self._last_deadline_sweep < _DEADLINE_SWEEP_S:
            return False
        self._last_deadline_sweep = now
        if self._inflight is not None and any(
                s.request is not None and s.request.deadline is not None
                for s in self.slots):
            self._drain_pipeline()
        return self._expire_deadlines()

    def _expire_deadlines(self) -> bool:
        """Sweep expired requests out of the waiting queue and the
        slots.  Queue expiry spends no device time; slot expiry frees
        the pages mid-decode.  A slot expiring mid-prefill commits no
        page to the prefix cache."""
        now = self._now()

        def dead(r):
            return r.deadline is not None and now > r.deadline

        with self._lock:
            if self.qos is not None:
                expired = []
                for tenant in list(self._tenant_queues):
                    q = self._tenant_queues[tenant]
                    gone = [r for r in q if dead(r)]
                    if gone:
                        keep = collections.deque(r for r in q if not dead(r))
                        if keep:
                            self._tenant_queues[tenant] = keep
                        else:
                            # the pop path lazily sweeps the DRR order
                            del self._tenant_queues[tenant]
                        self._waiting_count -= len(gone)
                        expired.extend(gone)
            else:
                expired = [r for r in self.waiting if dead(r)]
                if expired:
                    self.waiting = collections.deque(
                        r for r in self.waiting if not dead(r))
                    self._waiting_count = len(self.waiting)
        for r in expired:
            self._expire_request(r)
        did = bool(expired)
        for i, slot in enumerate(self.slots):
            req = slot.request
            if req is not None and dead(req):
                self._evict_slot(i, commit=not slot.prefilling)
                self._expire_request(req)
                did = True
        return did

    def _finish_trace(self, req: Request) -> None:
        """Record the request's decode + end-to-end spans and, when it
        crossed ``slow_request_threshold_s``, log its span tree."""
        end = req.finish_time or time.monotonic()
        if req.first_token_time is not None:
            self.tracer.record("decode", req.trace_id, req.first_token_time,
                               end - req.first_token_time,
                               tokens=len(req.output_tokens))
        self.tracer.record("request", req.trace_id, req.submit_time,
                           end - req.submit_time, req_id=req.req_id,
                           finish=req.finish_reason or "stop",
                           preemptions=req.preemptions)
        thr = self.cfg.slow_request_threshold_s
        if thr and end - req.submit_time >= thr:
            logger.warning(
                "slow request %s (trace %s): %.3fs e2e >= %.3fs threshold\n%s",
                req.req_id, req.trace_id, end - req.submit_time, thr,
                format_span_tree(self.tracer.spans(req.trace_id)))

    def _fail_all(self):
        # a failure may leave a window in flight: forget it and upload
        # every field from the (authoritative) host mirrors next time
        self._inflight = None
        self._mark_state_dirty()
        for i, slot in enumerate(self.slots):
            if slot.request is not None:
                req = slot.request
                self._evict_slot(i, commit=False)
                self._fail_request(req)
        while (req := self._pop_waiting()) is not None:
            self._fail_request(req)
        if self.prefix_cache is not None:
            # after a failed step the pool's contents are not trusted:
            # the tree must not advertise them
            self.prefix_cache = PrefixCache(self._num_pages, self.cfg.page_size)
            self.allocator = self.prefix_cache

    def _evict_slot(self, slot_idx: int, commit: bool = True):
        """Return a slot's pages to the pool and clear it.

        ``commit`` feeds the written-token prefix into the radix tree
        for future prefix hits; the failure path passes False.  Only
        tokens whose KV landed are committed: the final sampled token's
        KV never lands (the slot retires before a step would write it).
        The pages shared at admission are released with their tokens
        even when the slot wrote fewer (a preempted prefill whose whole
        prompt was cached), so their references always return."""
        slot = self.slots[slot_idx]
        if self.prefix_cache is not None and (slot.request.adapter
                                              or slot.request.imported):
            # exclusive pages: an adapter's KV carries its deltas, an
            # import's pages hold foreign bytes
            self.prefix_cache.release_uncommitted([], slot.pages)
        elif self.prefix_cache is not None:
            tokens = slot.request.resume_tokens()[:max(slot.written,
                                                       slot.shared_tokens)]
            if commit:
                self.prefix_cache.release(tokens, slot.pages)
            else:
                self.prefix_cache.release_uncommitted(tokens, slot.pages)
        else:
            self.allocator.release(slot.pages)
        sp = slot.request.params
        if sp.temperature > 0.0 or sp.top_k > 0 or sp.top_p < 1.0 \
                or sp.min_p > 0.0 or sp.has_penalties:
            self.sampling.reset_slot(slot_idx)
        # speculation state is per slot: draft pages and position return
        # to the draft pool, the depth controller restarts, and the
        # n-gram index drops (rebuilt from resume_tokens on re-admission)
        if self.spec_draft is not None:
            self.spec_draft.release_slot(slot_idx)
        if self.spec_ctl is not None:
            self.spec_ctl.reset(slot_idx)
        self._ngram_idx.pop(slot_idx, None)
        self._release_grammar(slot_idx)
        self.slots[slot_idx] = _Slot()
        self.active[slot_idx] = False
        self._remaining[slot_idx] = 0
        self.slot_adapters[slot_idx] = 0
        self._batch_epoch += 1
        self._mark_state_dirty("active", "left", "slot_adapters")

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduler iteration; False when idle.

        Decode-priority: every iteration with active slots runs one
        decode window; prefill advances one budgeted round every
        ``prefill_interleave`` decode steps (every iteration when nothing
        is decoding).  With ``async_dispatch`` the fused windows go
        through the two-deep pipeline (:meth:`_step_async`).

        Every non-idle iteration appends one bounded timeline record
        (wall time, batch shape, token mix, KV pressure, preemption and
        shed deltas) and observes ``kaito:engine_step_seconds``, from
        host clocks and host mirrors only."""
        c = self.counters
        before = (c["prefill_steps_total"], c["decode_steps_total"],
                  c["generation_tokens_total"], c["prefill_tokens_total"],
                  c["preemptions_total"], c["requests_expired_total"],
                  c["requests_shed_total"])
        t0 = time.monotonic()
        did = self._step_async() if self.async_dispatch else self._step_sync()
        if did:
            wall = time.monotonic() - t0
            self.step_hist.observe(wall)
            extra = {}
            if self.async_dispatch:
                # host-side idle between the previous window's readback
                # and this step's dispatch; ~0 whenever the pipeline was
                # primed
                extra["dispatch_gap"] = round(self._gap_last, 6)
                self._gap_last = 0.0
            if self._prefill_pack_note:
                extra["prefill_pack"] = self._prefill_pack_note
                self._prefill_pack_note = 0
            self.timeline.add(
                t0, wall, **extra,
                running=self.num_running,
                waiting=self.num_waiting,
                prefill_steps=c["prefill_steps_total"] - before[0],
                decode_steps=c["decode_steps_total"] - before[1],
                decode_tokens=c["generation_tokens_total"] - before[2],
                prefill_tokens=c["prefill_tokens_total"] - before[3],
                preemptions=c["preemptions_total"] - before[4],
                expired=c["requests_expired_total"] - before[5],
                shed=c["requests_shed_total"] - before[6],
                kv_pages_used=(self.allocator.num_pages - 1
                               - self.allocator.available))
        return did

    def _tick_exports(self) -> None:
        """The export registry's upkeep, at most once a second."""
        now = time.monotonic()
        if now - self._last_export_tick >= 1.0:
            self._last_export_tick = now
            self.kv_exports.tick()

    def _step_sync(self) -> bool:
        """The synchronous loop's iteration (see :meth:`step`)."""
        did0 = self._sweep_deadlines()
        self._tick_exports()
        # reserve BEFORE admitting: growth of running sequences must not
        # be starved by a fresh admission grabbing the last pages
        la = 1
        if self.active.any():
            la = self._decode_lookahead()
            self._ensure_decode_pages(la)
        did = self._admit_new() or did0
        if self._advance_imports():
            did = True
        decoding = bool(self.active.any())
        steps_run = 0
        if decoding:
            steps_run = self._decode_speculative() if self._spec_ok() else 0
            if not steps_run:
                # recompute after admission: ensure-pages may have preempted
                la2 = self._decode_lookahead()
                if la2 > 1:
                    if did or la2 > la:
                        self._ensure_decode_pages(la2)
                    self._decode_multi(la2)
                else:
                    self._decode_once()
                steps_run = la2
            did = True
        # prefill cadence counts DECODE STEPS, not iterations
        self._decode_since_prefill += steps_run
        if (not decoding) or self.cfg.prefill_interleave <= 1 \
                or self._decode_since_prefill >= self.cfg.prefill_interleave:
            if self._advance_prefills():
                did = True
                self._decode_since_prefill = 0
        return did

    def _admit_new(self) -> bool:
        """Fill every free slot from the waiting queue (bookkeeping only;
        prefill compute happens in _advance_prefills)."""
        admitted = False
        while True:
            free_slot = next((i for i, s in enumerate(self.slots)
                              if s.request is None), None)
            if free_slot is None:
                # slot-level QoS preemption: a queued higher-priority
                # request claims a slot from a strictly lower class
                # instead of waiting out its whole decode
                if self.qos is not None:
                    nxt = self._peek_waiting_priority()
                    victim = (None if nxt is None
                              else self._newest_slot(below_priority=nxt))
                    if victim is not None:
                        self._preempt_slot(victim)
                        continue
                return admitted
            req = self._pop_waiting()
            if req is None:
                return admitted
            if req.aborted:
                if self.host_kv is not None:
                    self.host_kv.discard(req.req_id)
                req.finish_reason = req.finish_reason or "abort"
                req.out.put(None)
                admitted = True
                continue
            if req.deadline is not None and self._now() > req.deadline:
                # queue expiry at admission: no device time spent
                self._expire_request(req)
                admitted = True
                continue
            if req.adapter and not self._adapter_resident(req):
                admitted = True
                continue
            if req.params.grammar is not None:
                verdict = self._reserve_grammar_table(req.params.grammar)
                if verdict == "wait":
                    self._requeue_front(req)
                    return admitted  # table rows come free with a slot
                if verdict is not None:
                    req.error = {"status": 503, "type": "grammar_table_full",
                                 "message": verdict}
                    self._fail_request(req)
                    admitted = True
                    continue
            if not self._admit(req, free_slot):
                return admitted      # page OOM: requeued, stall admission
            admitted = True

    def _adapter_resident(self, req: Request) -> bool:
        """Make sure an adapter request's adapter holds a lane before it
        is admitted (a load since its submission may have evicted it:
        fault it back in); if it cannot, the request fails alone (503
        ``adapter_unavailable``)."""
        if req.adapter in self.adapter_index:
            return True
        try:            # only the cache's residency changes after submission
            self.adapter_cache.ensure(req.adapter)
            return True
        except (KeyError, AdapterLoadError) as e:
            req.error = {"status": 503, "type": "adapter_unavailable",
                         "message": f"adapter {req.adapter!r} could not be "
                                    f"loaded: {e}"}
        self._fail_request(req)
        return False

    def _admit(self, req: Request, free_slot: int) -> bool:
        """Reserve the prompt's pages (plus one decode token) and stage
        the request into a slot; decode grows the page list later.  With
        the prefix cache, the whole prompt pages already committed are
        shared and prefill starts after them."""
        t_adm = time.monotonic()
        tokens = req.resume_tokens()
        n = len(tokens)
        ps = self.cfg.page_size
        pages_needed = -(-(n + 1) // ps)
        has_spill = (self.host_kv is not None and not req.imported
                     and self.host_kv.has(req.req_id))
        # one page of headroom per decoding slot, so an admission does
        # not trigger immediate grow-preempt churn; under QoS a higher
        # class evicts lower-class sequences for room (each eviction
        # also shrinks the headroom, so it is recomputed)
        while self.allocator.available < pages_needed + int(self.active.sum()):
            if not self._preempt_one_lower(req):
                self._requeue_front(req)
                return False
        shared = cached = 0
        exclusive = True
        if self.prefix_cache is not None:
            # an adapter's KV carries its k/v deltas, a spilled sequence
            # restores its host pages over its slot's and an import writes
            # foreign bytes: their pages are exclusive (an empty-token
            # acquire shares nothing)
            exclusive = bool(req.adapter) or has_spill or req.imported
            res = self.prefix_cache.acquire([] if exclusive else tokens, n + 1)
            if res is None:
                self._requeue_front(req)
                return False
            pages, shared = res
            # at least one suffix token must run to produce logits; the
            # overlap rewrites identical KV into the shared page
            cached = min(shared, n - 1)
        else:
            pages = self.allocator.alloc(pages_needed)
        slot = self.slots[free_slot]
        self.page_tables[free_slot] = 0
        self.page_tables[free_slot, :len(pages)] = pages
        self.slot_adapters[free_slot] = self.adapter_index.get(req.adapter, 0)
        self._mark_state_dirty("page_tables", "slot_adapters")
        slot.request = req
        slot.pages = list(pages)
        self._admit_seq += 1
        slot.seq = self._admit_seq
        slot.prefilling = True
        slot.prefill_pos = cached
        slot.shared_tokens = shared
        slot.prefill_tokens = tokens
        now = time.monotonic()
        slot.staged_t0 = now
        # queue wait only on the first admission: a resume after
        # preemption would count the whole lifetime as queue time
        if req.first_token_time is None and not req.preemptions:
            self.queue_wait_hist.observe(now - req.submit_time)
            self.tracer.record("queue.wait", req.trace_id, req.submit_time,
                               now - req.submit_time)
        self.tracer.record("admit", req.trace_id, t_adm, now - t_adm,
                           slot=free_slot, cached_tokens=cached,
                           pages=len(pages), resume=req.preemptions)
        if cached:
            self.counters["prefix_cached_tokens_total"] += cached
        if self.prefix_cache is not None and not req.preemptions and not exclusive:
            self.counters["prefix_cache_hits_total" if cached
                          else "prefix_cache_misses_total"] += 1
        p = req.params
        # the slot's keys: the request's seed, else its request count
        seed = p.seed or self.counters["requests_total"]
        self.sampling.set_slot(free_slot, temperature=p.temperature, top_k=p.top_k,
                               top_p=p.top_p, presence=p.presence_penalty,
                               frequency=p.frequency_penalty,
                               repetition=p.repetition_penalty, min_p=p.min_p,
                               seed=seed)
        if self.spec_draft is not None:
            self.spec_draft.reseed(free_slot, seed)
        if p.has_penalties:
            self._ensure_penalty_state()
            V = self.md.arch.vocab_size
            row = np.bincount(np.asarray(req.output_tokens, np.int64),
                              minlength=V)[:V].astype(np.int32)
            self.token_counts[free_slot] = self._tensor(row)
            # repetition penalty sees the PROMPT too (vLLM parity)
            seen = np.zeros((V,), bool)
            seen[np.clip(np.asarray(req.prompt_tokens), 0, V - 1)] = True
            self.prompt_seen[free_slot] = self._tensor(seen)
        if p.grammar is not None:
            self._install_grammar(free_slot, req)
        if req.kv_import is not None:
            self._start_imported(req, free_slot)
        elif req.kv_device is not None:
            self._start_device_import(req, free_slot)
        elif req.kv_chunked is not None:
            self._start_chunked_import(req, free_slot)
        elif has_spill:
            # resumed from host pages with no prefill, else recomputed
            self._try_restore(req, free_slot)
        return True

    def _start_imported(self, req: Request, free_slot: int) -> None:
        """Decode-role start, one-shot transfer: write the pages in place
        and decode from the prompt boundary (no prefill)."""
        meta, payload, first = req.kv_import
        n = len(req.prompt_tokens)
        slot = self.slots[free_slot]
        t0 = time.monotonic()
        import_kv(self.cache, slot.pages[:-(-n // self.cfg.page_size)], payload, meta)
        self.tracer.record("kv.import", req.trace_id, t0, time.monotonic() - t0,
                           bytes=len(payload))
        self._begin_imported(free_slot, first, n)

    def _start_device_import(self, req: Request, free_slot: int) -> None:
        """Colocated decode start: ONE device-to-device copy of the prefill
        engine's staged slabs into this engine's pages, ordered after the
        export's gather event; the bytes never touch the host."""
        meta, slabs, first, event = req.kv_device
        n = len(req.prompt_tokens)
        n_pages = -(-n // self.cfg.page_size)
        slot = self.slots[free_slot]
        t0 = time.monotonic()
        # the staged slab may hold more pages than the prompt needs
        import_arrays(self.cache, slot.pages[:n_pages],
                      *[t[:, :n_pages] for t in slabs], after=event)
        self.tracer.record("kv.import.device", req.trace_id, t0,
                           time.monotonic() - t0, pages=n_pages)
        # drop the slab references (the prefill engine's device copy)
        # and keep the field as the marker that the pages are foreign
        req.kv_device = (meta, None, first, None)
        self.counters["pd_device_handoffs_total"] += 1
        self._begin_imported(free_slot, first, n)

    def _start_chunked_import(self, req: Request, free_slot: int) -> None:
        """Decode-role start of the chunked wire: the slot parks as
        ``importing`` until :meth:`_advance_imports` has every chunk."""
        self.slots[free_slot].importing = True
        if not req.prompt_counted:
            self.counters["prompt_tokens_total"] += len(req.prompt_tokens)
            req.prompt_counted = True

    def _begin_imported(self, slot_idx: int, first: int, n: int) -> None:
        req = self.slots[slot_idx].request
        if not req.prompt_counted:
            self.counters["prompt_tokens_total"] += n
            req.prompt_counted = True
        self._begin_decode(slot_idx, first, n)

    def _advance_imports(self) -> bool:
        """Assemble arrived chunks of the importing slots into host
        buffers (a bounded amount a call, so a large transfer never
        stalls the others' decode), then ONE in-place write and the
        decode start when the last one lands.  A transient failure
        (the puller's network) with retries left recomputes locally; a
        pool fetch's failure always does; anything else fails the
        request with a 502."""
        did = False
        for i, slot in enumerate(self.slots):
            req = slot.request
            if req is None or not slot.importing:
                continue
            ci = req.kv_chunked
            err, transient = ci.error, ci.transient
            if err is None:
                try:
                    FAILPOINTS.fire("engine.kv_import", req_id=req.req_id)
                    if ci.assemble():
                        did = True
                    if ci.complete and req.kv_prefix_tokens > 0:
                        self._finish_prefix_import(i, ci)
                        did = True
                    elif ci.complete:
                        n = len(req.prompt_tokens)
                        n_pages = -(-n // self.cfg.page_size)
                        # _begin_decode writes loop state the window in
                        # flight advances on the device
                        self._drain_pipeline()
                        t0 = time.monotonic()
                        import_arrays(self.cache, slot.pages[:n_pages],
                                      *ci.full_arrays())
                        self.tracer.record("kv.import.chunked", req.trace_id, t0,
                                           time.monotonic() - t0, pages=n_pages)
                        slot.importing = False
                        self._begin_imported(i, ci.first_token, n)
                        did = True
                except Exception as e:
                    # assembly and write failures are not transient: the
                    # bytes are wrong, and the same transfer fails again
                    err, transient = f"{type(e).__name__}: {e}", False
            if err is None:
                continue
            self._evict_slot(i, commit=False)
            did = True
            if req.kv_prefix_tokens > 0:
                # the pool is an optimization: any fetch failure recomputes
                req.kv_chunked = None
                req.kv_prefix_tokens = 0
                self.counters["kv_pool_fetch_failures_total"] += 1
                logger.warning("KV pool fetch for %s failed (%s); recomputing "
                               "locally", req.req_id, err)
                self._requeue_front(req)
            elif transient and req.kv_retries > 0:
                req.kv_retries -= 1
                req.kv_chunked = None
                self.counters["kv_import_retries_total"] += 1
                logger.warning("KV import for %s failed transiently (%s); falling "
                               "back to local recompute", req.req_id, err)
                self._requeue_front(req)
            else:
                logger.warning("KV import failed for %s: %s", req.req_id, err)
                req.error = {"status": 502, "type": "kv_transfer_failed",
                             "message": f"KV import failed: {err}"}
                self._fail_request(req)
        return did

    def _finish_prefix_import(self, i: int, ci: ChunkedImport) -> None:
        """Write a completed pool fetch's verified whole-page prefix into
        the slot's pages and hand the slot back to the prefill scheduler
        for the rest; the local store then holds the prefix too."""
        slot = self.slots[i]
        req = slot.request
        ps = self.cfg.page_size
        n_use = req.kv_prefix_tokens // ps
        # copies, not views: a view would pin the whole assembly buffers
        # for as long as the replicated store entry lives
        arrs = [a[:, :n_use].clone() for a in ci.full_arrays()]
        t0 = time.monotonic()
        import_arrays(self.cache, slot.pages[:n_use], *arrs)
        self.tracer.record("kv.pool.import", req.trace_id, t0, time.monotonic() - t0,
                           pages=n_use)
        slot.importing = False
        slot.prefill_pos = max(slot.prefill_pos, req.kv_prefix_tokens)
        self.counters["kv_pool_fetches_total"] += 1
        self.counters["kv_pool_fetched_tokens_total"] += req.kv_prefix_tokens
        if self.kv_pool is not None and len(req.pool_blocks) >= n_use:
            blocks = list(req.pool_blocks[:n_use])
            key = pool_key(blocks)
            if not self.kv_pool.has(key):
                exp = HostExport(*arrs, n_tokens=n_use * ps, model=self.md.name,
                                 prompt_tokens=req.prompt_tokens[:n_use * ps])
                self.kv_pool.put(PoolEntry(key=key, blocks=blocks, n_tokens=n_use * ps,
                                           n_pages=n_use, export=exp,
                                           nbytes=meta_nbytes(exp.meta)))

    # ------------------------------------------------------------------
    # Prefill
    # ------------------------------------------------------------------

    def _advance_prefills(self) -> bool:
        """One prefill round: ``prefill_pack`` > 1 (0 = KAITO_PREFILL_PACK,
        else up to ``max_num_seqs``) spreads the token budget over a pack
        of staged slots; 1 is the serial round-robin scheduler."""
        pack = int(self.cfg.prefill_pack)
        if pack <= 0:
            pack = int(os.environ.get("KAITO_PREFILL_PACK", "0") or "0")
        if pack <= 0:
            pack = self.cfg.max_num_seqs
        if pack <= 1:
            return self._advance_prefill_single()
        return self._advance_prefill_pack(pack)

    def _staged(self) -> list[int]:
        return [i for i, s in enumerate(self.slots)
                if s.request is not None and s.prefilling and not s.importing]

    def _advance_prefill_single(self) -> bool:
        """ONE bounded prefill chunk for one staged slot (round-robin)."""
        idxs = self._staged()
        if not idxs:
            return False
        i = idxs[self._prefill_rr % len(idxs)]
        self._prefill_rr += 1
        slot = self.slots[i]
        n = len(slot.prefill_tokens)
        pos = slot.prefill_pos
        take = min(n - pos, max(self.cfg.max_prefill_tokens, self.cfg.page_size))
        rows = [(i, pos, take, n)]
        t0 = time.monotonic()
        if pos == 0 and take == n:
            logits = self._dispatch_prefill_fresh(rows)
        else:
            logits = self._dispatch_prefill_ctx(rows)
        self._complete(self._advance_rows(rows, logits, t0, packed=False))
        return True

    def _advance_prefill_pack(self, pack_limit: int) -> bool:
        """Token-budget prefill (docs/prefill.md): a PACK of staged slots,
        in admission order, whose chunks fill ``max_prefill_tokens`` as
        an aggregate budget.  Fresh-complete prompts segment-pack into
        one row per adapter (a single one takes the fresh family; an MLA
        model, which has no packed prefill, batches them on the batch
        axis per bucket); continuation chunks batch on the batch axis per
        bucket."""
        staged = sorted(self._staged(), key=lambda i: (-self.slots[i].request.priority,
                                                       self.slots[i].seq))
        if not staged:
            return False
        left = max(self.cfg.max_prefill_tokens, self.cfg.page_size)
        picks: list[tuple[int, int, int, int]] = []  # (slot, pos, take, n)
        for i in staged:
            if len(picks) >= pack_limit or left <= 0:
                break
            slot = self.slots[i]
            n = len(slot.prefill_tokens)
            pos = slot.prefill_pos
            take = min(n - pos, left)
            if take < n - pos and picks and take < self.cfg.page_size:
                # sub-page tail of the budget: leave it whole for the
                # next round instead of fragmenting a long prompt
                break
            picks.append((i, pos, take, n))
            left -= take
        if not picks:
            return False
        mla = self.model.is_mla
        groups: dict[tuple, list] = {}
        for p in picks:
            _, pos, take, n = p
            if pos == 0 and take == n:
                gk = (("fresh", self._bucket(take)) if mla
                      else ("seg", int(self.slot_adapters[p[0]])))
            else:
                gk = ("ctx", self._bucket(take))
            groups.setdefault(gk, []).append(p)
        completed = []
        for gk, rows in groups.items():
            t0 = time.monotonic()
            if gk[0] == "seg" and len(rows) > 1:
                logits = self._dispatch_prefill_packed(rows)
                self.counters["prefill_packed_steps_total"] += 1
            elif gk[0] == "ctx":
                logits = self._dispatch_prefill_ctx(rows)
            else:
                logits = self._dispatch_prefill_fresh(rows)
            completed += self._advance_rows(rows, logits, t0, packed=True)
        self._complete(completed)
        return True

    def _advance_rows(self, rows, logits, t0: float, packed: bool) -> list:
        """Book one dispatch's chunks (dispatched at ``t0``; ``packed``
        from the pack scheduler) and trace each; the rows whose prompt
        is done."""
        dur = time.monotonic() - t0
        self.counters["prefill_steps_total"] += 1
        self.counters["prefill_tokens_total"] += sum(r[2] for r in rows)
        self.prefill_pack_hist.observe(float(len(rows)) if packed else 1.0)
        if packed:
            self._prefill_pack_note = max(self._prefill_pack_note, len(rows))
        done = []
        for row, (i, pos, take, n) in enumerate(rows):
            slot = self.slots[i]
            wait = 0.0
            if not slot.prefill_t0:
                slot.prefill_t0 = t0
                slot.prefill_base = pos
                if slot.staged_t0:
                    wait = max(0.0, t0 - slot.staged_t0)
                self.prefill_wait_hist.observe(wait)
            attrs = dict(pos=pos, tokens=take, bucket=self._bucket(take),
                         slot=i, cp=False)
            if packed:
                attrs["pack"] = len(rows)
            self.tracer.record("prefill.chunk", slot.request.trace_id, t0, dur,
                               **attrs, queue_wait=round(wait, 6))
            slot.prefill_pos = pos + take
            if slot.prefill_pos >= n:
                done.append((i, n, logits[row:row + 1]))
        return done

    def _complete(self, completed) -> None:
        """Sample the first token of every prompt finished this round
        (one sampler call) and start decoding them."""
        if not completed:
            return
        idxs = [i for (i, _, _) in completed]
        toks, lps = self._sample_first_batch(
            idxs, torch.cat([lg for (_, _, lg) in completed]))
        t_done = time.monotonic()
        for (i, n, _), tok, lp in zip(completed, toks, lps):
            slot = self.slots[i]
            req = slot.request
            if slot.prefill_t0:
                # the sampler read the logits back, so the elapsed time
                # covers the real compute (and the scheduler's
                # interleaving): the recompute rate of the break-even
                self.pd_costs.note_prefill(n - slot.prefill_base,
                                           t_done - slot.prefill_t0)
            if not req.prompt_counted:
                # resume-after-preempt re-prefills prompt+generated; only
                # the original prompt counts
                self.counters["prompt_tokens_total"] += len(req.prompt_tokens)
                req.prompt_counted = True
            self._begin_decode(i, tok, n, first_lp=lp)

    @phase_scope("prefill")
    def _dispatch_prefill_fresh(self, rows):
        """Fresh-complete prompts on the batch axis: tokens [B, bucket]."""
        bucket = self._bucket(max(n for (_, _, _, n) in rows))
        B = len(rows)
        toks = np.zeros((B, bucket), np.int32)
        tls = np.zeros((B,), np.int32)
        for j, (i, _, _, n) in enumerate(rows):
            toks[j, :n] = self.slots[i].prefill_tokens
            tls[j] = n
        idxs = [r[0] for r in rows]
        self.cache, logits, _ = self.model.prefill(
            self.cache, self._tensor(toks), self._tensor(tls),
            self._tensor(self.page_tables[idxs]), adapter_ids=self._ids_tensor(idxs))
        return logits

    def _ids_tensor(self, idxs) -> Optional[torch.Tensor]:
        """The lanes of slots ``idxs`` on the device, or None when all are
        the base's (the model then runs no adapter site)."""
        a = self.slot_adapters[idxs]
        return self._tensor(a) if a.any() else None

    @phase_scope("prefill")
    def _dispatch_prefill_ctx(self, rows):
        """Chunks on the batch axis, each attending over its own paged
        history (earlier chunks + itself) from ``start_pos``."""
        bucket = self._bucket(max(take for (_, _, take, _) in rows))
        B = len(rows)
        toks = np.zeros((B, bucket), np.int32)
        tls = np.zeros((B,), np.int32)
        sps = np.zeros((B,), np.int32)
        for j, (i, pos, take, _) in enumerate(rows):
            toks[j, :take] = self.slots[i].prefill_tokens[pos:pos + take]
            tls[j] = take
            sps[j] = pos
        idxs = [r[0] for r in rows]
        self.cache, logits, _ = self.model.prefill(
            self.cache, self._tensor(toks), self._tensor(tls),
            self._tensor(self.page_tables[idxs]), start_pos=self._tensor(sps),
            adapter_ids=self._ids_tensor(idxs))
        return logits

    @phase_scope("prefill_packed")
    def _dispatch_prefill_packed(self, rows):
        """Segment packing: S fresh prompts concatenated into ONE padded
        row with per-token segment ids, positions and page targets (for
        an int8 cache also the pack's pages and each token's index into
        them, pads pointing one past the end).  The rows share one
        adapter.  Returns last-token logits [S, V] in pack order."""
        ps = self.cfg.page_size
        T = self._bucket(sum(take for (_, _, take, _) in rows))
        S = len(rows)
        toks = np.zeros((1, T), np.int32)
        segs = np.full((1, T), -1, np.int32)
        poss = np.zeros((1, T), np.int32)
        tok_pages = np.full((T,), NULL_PAGE, np.int32)
        last_idx = np.zeros((S,), np.int32)
        pack_pages: list[int] = []
        tok_pgslot = np.zeros((T,), np.int32)
        off = 0
        for si, (i, _, take, _) in enumerate(rows):
            toks[0, off:off + take] = self.slots[i].prefill_tokens
            segs[0, off:off + take] = si
            rel = np.arange(take, dtype=np.int32)
            poss[0, off:off + take] = rel
            table = self.page_tables[i]
            tok_pages[off:off + take] = table[rel // ps]
            tok_pgslot[off:off + take] = len(pack_pages) + rel // ps
            pack_pages += table[:-(-take // ps)].tolist()
            last_idx[si] = off + take - 1
            off += take
        tok_pgslot[off:] = len(pack_pages)
        quant = self._kv_quantized
        self.cache, logits, _ = self.model.prefill_packed(
            self.cache, self._tensor(toks), self._tensor(segs), self._tensor(poss),
            self._tensor(tok_pages), self._tensor(last_idx),
            self._tensor(np.asarray(pack_pages, np.int32)) if quant else None,
            self._tensor(tok_pgslot) if quant else None,
            adapter_ids=self._ids_tensor([rows[0][0]]))
        return logits

    def _sample_first_batch(self, idxs: list[int], logits
                            ) -> tuple[list[int], list[float]]:
        """First-token sampling for every sequence completing in a
        prefill round: one sampler call over the gathered rows."""
        sub = self.sampling.select(idxs)
        counts = seen = None
        if self.token_counts is not None:
            sel = self._tensor(np.asarray(idxs, np.int64))
            counts, seen = self.token_counts[sel], self.prompt_seen[sel]
        grows = None
        if any(self._gram_slots[i] is not None for i in idxs):
            # each row's current mask row (the zero row when unconstrained)
            grows = self._gmask[self._tensor(self._gram_state[idxs].astype(np.int64))]
        tok = sample(logits, sub, counts, seen, grammar_rows=grows)
        if sub.gates()[0]:
            # a draw split the selected rows' keys
            self.sampling.scatter_keys(idxs, sub)
        lps = chosen_logprob(logits, tok)
        return tok.cpu().tolist(), lps.cpu().tolist()

    def _begin_decode(self, slot_idx: int, first: int, n: int,
                      first_lp: Optional[float] = None):
        """Move a slot to decoding after its prompt KV is in place and
        emit the first token."""
        slot = self.slots[slot_idx]
        req = slot.request
        slot.prefilling = False
        slot.position = n
        slot.remaining = min(req.params.max_tokens - len(req.output_tokens),
                             self.cfg.max_model_len - n,
                             self._capacity_tokens - n)
        self.positions[slot_idx] = n
        self.active[slot_idx] = True
        self.last_tokens[slot_idx] = first
        self._remaining[slot_idx] = slot.remaining
        self._batch_epoch += 1
        self._mark_state_dirty("positions", "active", "last_tokens", "left")
        if self._gram_slots[slot_idx] is not None:
            # the first token advances the host mirror below; a window
            # since admission may have uploaded the state before it
            self._mark_state_dirty("gstate")
        if req.first_token_time is None:
            req.first_token_time = time.monotonic()
        if req.params.has_penalties and self.token_counts is not None:
            self.token_counts[slot_idx, first] += 1
        self._emit(slot_idx, first, logprob=first_lp)

    # ------------------------------------------------------------------
    # Page growth + preemption
    # ------------------------------------------------------------------

    def _alloc_one_page(self) -> Optional[int]:
        if self.prefix_cache is not None:
            got = self.prefix_cache.alloc_raw(1)
            return got[0] if got else None
        try:
            return self.allocator.alloc(1)[0]
        except MemoryError:
            return None

    def _preempt_slot(self, victim: int):
        """Preempt a slot back to the front of the waiting queue; its
        generated tokens become part of the prompt on resume.  With the
        host tier, a sequence that will resume spills its written KV to
        host RAM first, so its resume is a page restore, not a
        recompute."""
        req = self.slots[victim].request
        logger.info("preempting %s (slot %d) to reclaim KV pages",
                    req.req_id, victim)
        will_requeue = len(req.resume_tokens()) + 1 <= self._capacity_tokens
        if will_requeue:
            # a length-capped sequence would leak a maximal host entry
            self._spill_slot(victim)
        req.preemptions += 1
        self.counters["preemptions_total"] += 1
        self.tracer.record("preempt", req.trace_id, time.monotonic(), 0.0,
                           slot=victim)
        self._evict_slot(victim, commit=True)
        # imported KV is spent (evicted above, uncommitted): the resume
        # takes the normal prefill path, and a pool fetch is spent too
        req.kv_import = req.kv_chunked = req.kv_device = None
        req.kv_prefix_tokens = 0
        if not will_requeue:
            # the sequence already fills the whole pool and cannot be
            # re-admitted; every token was emitted — finish at the cap
            req.finish_reason = "length"
            req.finish_time = time.monotonic()
            self._finish_trace(req)
            req.out.put(None)
            self.counters["requests_finished_total"] += 1
            return
        self._requeue_front(req)

    def _shard_caches(self) -> list:
        """The page pools of every shard (one without a mesh)."""
        return self.cache if isinstance(self.cache, list) else [self.cache]

    def _spill_slot(self, slot_idx: int) -> None:
        """Copy a decoding slot's written KV pages into the host pool
        (device-to-host, not waited for) ahead of its eviction; no-op
        when the tier is off or the slot is mid-prefill.  Each shard of a
        tensor-parallel pool spills its own pages."""
        slot = self.slots[slot_idx]
        req = slot.request
        if self.host_kv is None or slot.prefilling or req.kv_import is not None \
                or req.kv_chunked is not None:
            return
        written = slot.position
        n_pages = -(-written // self.cfg.page_size)
        if n_pages < 1:
            return
        # ids padded to a power of two onto the null page (whose content
        # is garbage by design), as the JAX engine pads its gathers
        ids = np.zeros((1 << (n_pages - 1).bit_length(),), np.int64)
        ids[:n_pages] = slot.pages[:n_pages]
        t0 = time.monotonic()
        try:
            k, v, ks, vs = [], [], [], []
            for c in self._shard_caches():
                idx = torch.from_numpy(ids).to(c.k.device)
                pk, pv = gather_pages(c.k, c.v, idx)
                k.append(pk)
                v.append(pv)
                if c.k_scale is not None:
                    sk, sv = gather_pages(c.k_scale, c.v_scale, idx)
                    ks.append(sk)
                    vs.append(sv)
            stored = self.host_kv.put(req.req_id, k, v, written,
                                      k_scale=ks or None, v_scale=vs or None)
            self.tracer.record("kv.spill", req.trace_id, t0, time.monotonic() - t0,
                               pages=n_pages, stored=stored)
            if stored:
                self.counters["host_kv_spilled_pages_total"] += n_pages
            # else: the entry can never fit; resume recomputes
        except Exception:
            # the spill is an optimization: a failed copy must not take
            # the request (or the engine) with it; resume recomputes
            logger.exception("host-KV spill failed for %s; resume will "
                             "recompute", req.req_id)
            self.host_kv.discard(req.req_id)

    def _try_restore(self, req: Request, free_slot: int) -> bool:
        """Resume a spilled sequence by copying its host pages into the
        slot's freshly acquired pages, in place (the pool tensors, whose
        addresses every captured window and verify graph holds, are
        never replaced), and start decoding where it left off: its
        pending input is its last emitted token, whose KV the next
        decode step writes.  False (the slot then prefills) when the
        entry was dropped or is stale."""
        entry = self.host_kv.pop(req.req_id)
        if entry is None:
            return False
        slot = self.slots[free_slot]
        ps = self.cfg.page_size
        n_pages = -(-entry.written // ps)
        if len(slot.pages) < n_pages or entry.written != len(req.resume_tokens()) - 1:
            return False
        ids = np.zeros((entry.n_pages,), np.int64)
        ids[:n_pages] = slot.pages[:n_pages]
        t0 = time.monotonic()
        for j, c in enumerate(self._shard_caches()):
            idx = torch.from_numpy(ids).to(c.k.device)
            scatter_pages(c.k, c.v, idx, entry.k[j], entry.v[j], entry.events[j])
            if entry.k_scale is not None and c.k_scale is not None:
                scatter_pages(c.k_scale, c.v_scale, idx, entry.k_scale[j],
                              entry.v_scale[j])
        self.tracer.record("kv.restore", req.trace_id, t0, time.monotonic() - t0,
                           pages=n_pages)
        self.counters["host_kv_restored_pages_total"] += n_pages
        slot.prefilling = False
        slot.prefill_tokens = []
        slot.position = entry.written
        slot.remaining = min(req.params.max_tokens - len(req.output_tokens),
                             self.cfg.max_model_len - entry.written,
                             self._capacity_tokens - entry.written)
        self.positions[free_slot] = entry.written
        self.active[free_slot] = True
        self.last_tokens[free_slot] = req.output_tokens[-1]
        self._remaining[free_slot] = slot.remaining
        self._batch_epoch += 1
        self._mark_state_dirty("positions", "active", "last_tokens", "left")
        if self._gram_slots[free_slot] is not None:
            self._mark_state_dirty("gstate")
        logger.debug("restored %s: %d pages, resuming at %d", req.req_id,
                     n_pages, entry.written)
        return True

    def _newest_slot(self, below_priority: Optional[int] = None) -> Optional[int]:
        """Preemption victim.  QoS off: the newest-admitted sequence.
        With QoS: the newest sequence of the LOWEST priority class
        present.  ``below_priority`` restricts candidates to strictly
        lower classes (admission never evicts a peer or better)."""
        cands = [i for i, s in enumerate(self.slots) if s.request is not None]
        if below_priority is not None:
            cands = [i for i in cands
                     if self.slots[i].request.priority < below_priority]
        if not cands:
            return None
        if self.qos is None:
            return max(cands, key=lambda i: self.slots[i].seq)
        return max(cands, key=lambda i: (-self.slots[i].request.priority,
                                         self.slots[i].seq))

    def _preempt_one_lower(self, req: Request) -> bool:
        """Admission-side preemption (QoS only): evict one strictly
        lower-priority sequence to make page room for ``req``; False
        when nothing lower is running."""
        if self.qos is None:
            return False
        victim = self._newest_slot(below_priority=req.priority)
        if victim is None:
            return False
        self._preempt_slot(victim)
        return True

    def _ensure_decode_pages(self, lookahead: int = 1):
        """Every active slot must own the pages its next ``lookahead``
        KV writes land in; when the pool is dry the newest sequence
        yields — even if it is the one that needs the page."""
        for i, slot in enumerate(self.slots):
            if not self.active[i] or slot.request is None:
                continue
            needed = self._pages_needed(slot, lookahead)
            while len(slot.pages) < needed:
                page = self._alloc_one_page()
                if page is not None:
                    self.page_tables[i, len(slot.pages)] = page
                    slot.pages.append(page)
                    self._mark_state_dirty("page_tables")
                    continue
                victim = self._newest_slot()
                if victim is None or victim == i:
                    self._preempt_slot(i)
                    break
                self._preempt_slot(victim)

    def _ensure_penalty_state(self):
        """First penalized admission: allocate the [S, V] histogram and
        prompt mask, kept for the engine's life (a captured window keeps
        their pointers; their liveness keys new windows)."""
        if self.token_counts is None:
            S, V = len(self.slots), self.md.arch.vocab_size
            logger.info("allocating penalty state (%d x %d)", S, V)
            self.token_counts = torch.zeros((S, V), dtype=torch.int32,
                                            device=self.device)
            self.prompt_seen = torch.zeros((S, V), dtype=torch.bool,
                                           device=self.device)

    # ------------------------------------------------------------------
    # Grammar-constrained decoding state
    # ------------------------------------------------------------------

    def _grammar_live(self) -> bool:
        """Whether any slot holds a grammar: decode then masks."""
        return any(gs is not None for gs in self._gram_slots)

    def _grammar_key(self) -> Optional[int]:
        """A graph's grammar key: the table's capacity while a slot is
        constrained (the graph reads the table), else None (it does not,
        and is the graph an unconstrained engine captures)."""
        return self._gram_table.capacity if self._grammar_live() else None

    def _grammar_room(self) -> Optional[int]:
        """Bytes a larger grammar table may take on the device: free
        memory and the allocator's unused cached blocks, less
        ``_GRAMMAR_HEADROOM_BYTES``; None on the CPU (no limit)."""
        if self.device.type != "cuda":
            return None
        free, _ = torch.cuda.mem_get_info(self.device)
        cached = (torch.cuda.memory_reserved(self.device)
                  - torch.cuda.memory_allocated(self.device))
        return free + cached - _GRAMMAR_HEADROOM_BYTES

    def _alloc_grammar_table(self, cap: int) -> tuple:
        V = self._gram_table.V
        return (torch.empty((cap, V), dtype=torch.float32, device=self.device),
                torch.empty((cap, V), dtype=torch.int32, device=self.device))

    def _reserve_grammar_table(self, g) -> Optional[str]:
        """Before anything is reserved for a request under grammar ``g``,
        make sure the device table can take the rows its install pins.
        If the table must grow, the larger buffers are allocated here,
        beside the old ones, which stay in use until the install moves
        to them; so a failed allocation changes nothing.  Returns None
        when the rows fit; "wait" when they do not, but a constrained
        slot's rows will come free; else why they never fit."""
        if self._gram_table is None:
            V = self.md.arch.vocab_size
            logger.info("allocating grammar table (vocab %d)", V)
            self._gram_table = GrammarTable(V)
        cap = self._gram_table.capacity_for(g)
        if self._gram_next is not None and self._gram_next[0].shape[0] == cap:
            return None
        self._gram_next = None
        if self._gmask is not None and self._gmask.shape[0] == cap:
            return None
        nbytes = cap * self._gram_table.V * 8
        room = self._grammar_room()
        if room is None or nbytes <= room:
            try:
                self._gram_next = self._alloc_grammar_table(cap)
                return None
            except torch.OutOfMemoryError:
                pass
        if self._grammar_live():
            return "wait"
        return (f"the grammar table needs {cap} rows ({nbytes / 2**20:.0f} MiB) on "
                f"the device, more than its free memory can spare "
                f"({max(room or 0, 0) / 2**20:.0f} MiB)")

    def _refresh_grammar_device(self) -> None:
        """Bring the device table up to the host table's version, in the
        same buffers and in stream order behind any window in flight: an
        install into spare rows writes only its span, a repack at the
        same capacity the whole table.  A new capacity moves to the
        buffers ``_reserve_grammar_table`` allocated and writes them
        whole; the graphs that read the old ones are dropped (their keys
        carry the old capacity, so none would replay)."""
        tbl = self._gram_table
        if tbl.version == self._gram_version:
            return
        cap = tbl.capacity
        if self._gmask is None or self._gmask.shape[0] != cap:
            if self._gmask is not None:
                old = self._gmask.shape[0]
                if self.device.type == "cuda":
                    # no replay that reads the old buffers is still queued
                    torch.cuda.synchronize(self.device)
                self.grammar_device_stats["graphs_dropped"] += \
                    self._drop_grammar_graphs(old)
            (self._gmask, self._gtrans), self._gram_next = self._gram_next, None
            lo, hi = 0, cap
        elif tbl.mask is not self._gram_host:
            lo, hi = 0, cap                 # repacked: every base moved
        else:
            lo, hi = self._gram_used, tbl.used   # the installed span
        self._gmask[lo:hi].copy_(torch.from_numpy(tbl.mask[lo:hi]))
        self._gtrans[lo:hi].copy_(torch.from_numpy(tbl.trans[lo:hi]))
        st = self.grammar_device_stats
        st["uploads"] += 1
        st["upload_bytes"] += (hi - lo) * tbl.V * 8
        st["last_upload_rows"] = hi - lo
        self._gram_host, self._gram_used = tbl.mask, tbl.used
        self._gram_version = tbl.version

    def _drop_grammar_graphs(self, cap: int) -> int:
        """Drop every graph keyed on the grammar table of ``cap`` rows (the
        last element of a window's and a verify graph's key)."""
        n = 0
        if self.window is not None:
            n += self.window.drop(lambda k: k[1][-1] == cap)
        if self.spec_verify is not None:
            n += self.spec_verify.drop(lambda k: k[-1] == cap)
        if self.spec_draft is not None and self.spec_draft.scan is not None:
            n += self.spec_draft.scan.drop(lambda k: k[2] == cap)
        return n

    def _sync_gram_state(self) -> None:
        """Recompute every constrained slot's absolute table row from the
        host mirrors (a repack moves bases; admission and eviction change
        membership) and mark it for upload."""
        tbl = self._gram_table
        for i, gs in enumerate(self._gram_slots):
            if gs is None:
                self._gram_state[i] = 0
                continue
            if gs.version != tbl.version:
                gs.base = tbl.base_of(gs.grammar.key)
                gs.version = tbl.version
            self._gram_state[i] = gs.base + gs.state
        self._mark_state_dirty("gstate")

    def _install_grammar(self, slot_idx: int, req: Request) -> None:
        """Pin the request's compiled grammar into the packed table (the
        device copy follows at once) and build the slot's host mirror.
        A resume after preemption replays the generated tokens through
        the automaton, so the mask continues where the slot left off."""
        g = req.params.grammar
        base = self._gram_table.acquire(g)
        gs = GrammarSlot(grammar=g, base=base, version=self._gram_table.version)
        for t in req.output_tokens:
            gs.advance(int(t))
        self._gram_slots[slot_idx] = gs
        if not req.preemptions and not req.output_tokens:
            self.grammar_cache.requests_total += 1
        self._refresh_grammar_device()
        self._sync_gram_state()

    def _release_grammar(self, slot_idx: int) -> None:
        gs = self._gram_slots[slot_idx]
        if gs is None:
            return
        self._gram_table.release(gs.grammar.key)
        self._gram_slots[slot_idx] = None
        self._gram_state[slot_idx] = 0
        self._mark_state_dirty("gstate")

    def _truncate_for_grammar(self, slot_idx: int, p: list) -> list:
        """Clip a speculative proposal at its first grammar-invalid token
        (walking the automaton on the host, the slot's state untouched):
        the prefix left is all that masked verification could accept."""
        gs = self._gram_slots[slot_idx]
        if gs is None or not p:
            return p
        st, out = gs.state, []
        for t in p:
            if not gs.grammar.allows(st, int(t)):
                break
            out.append(t)
            st = gs.grammar.advance(st, int(t))
        return out

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def _decode_inputs(self):
        """Device inputs of the eager reference loop's decode steps, the
        page tables at the full width the decode window passes, and the
        slots' adapter lanes (None while no slot holds an adapter)."""
        aids = self._tensor(self.slot_adapters) if self._adapter_live() else None
        return (self._tensor(self.last_tokens), self._tensor(self.positions),
                self._tensor(self.page_tables), self._tensor(self.active), aids)

    def _decode_step(self, tok, pos, pt, act, grammar_rows=None, aids=None):
        """One model step + sampling on the device (under the rows'
        grammar masks when given, through the rows' adapter lanes
        ``aids`` when given); (next, logprob under the model)."""
        self.cache, logits = self.model.decode(self.cache, tok, pos, pt, act,
                                               adapter_ids=aids)
        nxt = sample(logits, self.sampling, self.token_counts, self.prompt_seen,
                     active=act, grammar_rows=grammar_rows)
        lp = chosen_logprob(logits, nxt)
        if self.token_counts is not None:
            rows = torch.arange(nxt.shape[0], device=self.device)
            self.token_counts[rows, nxt.long()] += act.to(torch.int32)
        return nxt, lp

    @phase_scope("decode")
    def _decode_once(self):
        if self.window is not None:
            self._decode_window(1)
            return
        tok, pos, pt, act, aids = self._decode_inputs()
        grows = None
        if self._grammar_live():
            grows = self._gmask[self._tensor(self._gram_state.astype(np.int64))]
        nxt, lps = self._decode_step(tok, pos, pt, act, grows, aids)
        self.counters["decode_steps_total"] += 1
        self.counters["decode_windows_total"] += 1
        toks, lps = nxt.cpu().tolist(), lps.cpu().tolist()
        for i, slot in enumerate(self.slots):
            if not self.active[i]:
                continue
            self.positions[i] += 1
            slot.position += 1
            self._emit(i, toks[i], logprob=lps[i])
            self.last_tokens[i] = toks[i]

    def _decode_lookahead(self) -> int:
        """How many decode steps the next window may fuse: ``run_ahead``
        in steady state, at most ``fused_under_load`` while requests wait
        or prefill, 1 when an abort is pending or a stop set overflows
        the device stop matrix; clamped to the batch's largest remaining
        budget (a power of two) and to what the free pool covers."""
        K = self.run_ahead
        if K <= 1:
            return 1
        busy = self.num_waiting > 0
        max_rem = 0
        for i, s in enumerate(self.slots):
            if s.request is None:
                continue
            if s.request.aborted:
                return 1
            if s.prefilling:
                busy = True
                continue
            if self.active[i]:
                if len(self._stop_set(s.request)) > _STOP_WIDTH:
                    return 1
                max_rem = max(max_rem, s.remaining)
        if busy:
            K = min(K, self.cfg.fused_under_load)
            if K <= 1:
                return 1
        if max_rem < K:
            K = 1 << max(0, max_rem.bit_length() - 1)
        while K > 1 and not self._lookahead_fits(K):
            K //= 2
        return max(1, K)

    def _pages_needed(self, slot: _Slot, lookahead: int) -> int:
        """Pages a decoding slot must own for its next ``lookahead`` KV
        writes (positions [position, position + steps - 1])."""
        steps = max(1, min(lookahead, slot.remaining))
        return (slot.position + steps - 1) // self.cfg.page_size + 1

    def _lookahead_fits(self, K: int) -> bool:
        extra = 0
        for i, slot in enumerate(self.slots):
            if self.active[i] and slot.request is not None:
                extra += max(0, self._pages_needed(slot, K) - len(slot.pages))
        return extra <= self.allocator.available

    def _stop_ids(self) -> np.ndarray:
        """[S, _STOP_WIDTH] stop ids of the active slots, -1 padded (a
        wider stop set takes single steps, whose host _emit stops it)."""
        stop = np.full((len(self.slots), _STOP_WIDTH), -1, np.int32)
        for i, slot in enumerate(self.slots):
            if slot.request is None or not self.active[i]:
                continue
            ids = sorted(self._stop_set(slot.request))[:_STOP_WIDTH]
            stop[i, :len(ids)] = ids
        return stop

    def _stop_matrix(self) -> torch.Tensor:
        """Device stop ids for the eager reference loop, cached on the
        batch epoch."""
        epoch, dev = self._stop_cache
        if epoch == self._batch_epoch and dev is not None:
            return dev
        dev = self._tensor(self._stop_ids())
        self._stop_cache = (self._batch_epoch, dev)
        return dev

    @phase_scope("decode")
    def _decode_multi(self, K: int):
        """K decode steps in one window: sampling, stop detection and
        budgets on the device (a slot that stops goes inactive and
        writes no more KV), one readback, then the host replays the
        window through the single-step _emit path."""
        if self.window is not None:
            self._decode_window(K)
            return
        tok, pos, pt, act, aids = self._decode_inputs()
        grammar = None
        if self._grammar_live():
            grammar = (self._gmask, self._gtrans, self._tensor(self._gram_state))
        (toks, acts, lps), _ = run_steps(self._decode_step, K, tok, pos, pt, act,
                                         self._tensor(self._remaining),
                                         self._stop_matrix(), grammar, aids)
        self.counters["decode_steps_total"] += K
        self.counters["decode_windows_total"] += 1
        self._replay_window(toks.cpu().numpy(), acts.cpu().numpy(),
                            lps.cpu().numpy())

    # ------------------------------------------------------------------
    # The decode window, synchronous and async
    # ------------------------------------------------------------------

    def _host_state(self, name: str) -> np.ndarray:
        return {"last_tokens": self.last_tokens, "positions": self.positions,
                "active": self.active, "page_tables": self.page_tables,
                "left": self._remaining, "gstate": self._gram_state,
                "slot_adapters": self.slot_adapters}[name]

    def _dispatch(self, K: int, fields) -> tuple:
        """Upload ``fields`` of the loop state (and the stop matrix and
        sampling knobs where they changed), run one K-step window and
        enqueue its trace's readback.  Returns the window (K, readback)
        and how many host-to-device copies it made."""
        w = self.window
        # the gstate and slot_adapters inputs only while a window reads
        # them (a slot holds a grammar, an adapter): every admission of one
        # marks its field for upload again
        lora = self._adapter_live()
        n = w.upload({f: self._host_state(f) for f in fields
                      if (f != "gstate" or self._grammar_live())
                      and (f != "slot_adapters" or lora)})
        if self._stop_epoch != self._batch_epoch:
            n += w.upload({"stop": self._stop_ids()})
            self._stop_epoch = self._batch_epoch
        n += int(self.sampling.refresh())
        gcap = self._grammar_key()
        out = w.run(K, (self.sampling.gates(), self.token_counts is not None, lora,
                        gcap),
                    None if gcap is None else (self._gmask, self._gtrans), lora)
        rb = self._readbacks[self._windows % 2]
        self._windows += 1
        rb.enqueue(out)
        self.counters["decode_steps_total"] += K
        self.counters["decode_windows_total"] += 1
        return (K, rb), n

    @phase_scope("decode")
    def _decode_window(self, K: int) -> None:
        """The synchronous loop's window: every field from the host
        mirrors, then the trace replayed on the host."""
        win, _ = self._dispatch(K, self._STATE_FIELDS)
        self._retire_window(win)

    def _retire_window(self, win) -> None:
        """Wait for a window's readback (its event, not the device) and
        replay its trace through _emit."""
        _, rb = win
        toks, acts, lps = rb.wait()
        self._last_ready_t = time.monotonic()
        self._replay_window(toks, acts, lps)

    def _mark_state_dirty(self, *names: str) -> None:
        """The host changed loop-state mirrors: upload them at the next
        async dispatch (no-op when the async loop is off).  With no
        names, every field."""
        if self.async_dispatch:
            self._dirty.update(names or self._STATE_FIELDS)

    def _drain_pipeline(self) -> None:
        """Retire the window in flight, if any: the host mirrors are then
        reconciled, and paths that read them (preempt, evict, abort,
        admission) are safe."""
        win, self._inflight = self._inflight, None
        if win is not None:
            self._retire_window(win)

    def _must_drain(self) -> bool:
        """Host-side batch changes that may run this step: an admission
        (waiting work and a free slot, or QoS, which may preempt for
        one), a slot mid-prefill (its _begin_decode writes loop state),
        or a pending abort."""
        if self._inflight is None:
            return False
        if self._waiting_count > 0 and (
                self.qos is not None or any(s.request is None for s in self.slots)):
            return True
        return any(s.request is not None and ((s.prefilling and not s.importing)
                                              or s.request.aborted)
                   for s in self.slots)

    def _needs_sync_decode(self) -> bool:
        """What only the single-step host loop handles: a pending abort
        and a stop set wider than the device matrix."""
        for i, s in enumerate(self.slots):
            if s.request is None:
                continue
            if s.request.aborted:
                return True
            if self.active[i] and len(self._stop_set(s.request)) > _STOP_WIDTH:
                return True
        return False

    @phase_scope("decode")
    def _decode_async(self, K: int) -> None:
        """Dispatch one K-step window from the device-resident loop state
        (uploading only what the host dirtied) and enqueue its readback;
        then retire the previous window, which the device has finished
        or is finishing while this one queues behind it."""
        if self._inflight is not None and self._dirty & self._DEVICE_ADVANCED:
            # the host mirrors of scan-advanced fields lag the window in
            # flight: uploading them now would roll the device state back
            self._drain_pipeline()
        fields = [f for f in self._STATE_FIELDS if f in self._dirty]
        self._dirty.clear()
        t = time.monotonic()
        # the device idles only when nothing was in flight
        gap = (max(0.0, t - self._last_ready_t)
               if self._inflight is None and self._last_ready_t else 0.0)
        win, uploads = self._dispatch(K, fields)
        self.counters["h2d_uploads_total"] += uploads
        self.dispatch_gap_hist.observe(gap)
        self._gap_last = gap
        prev, self._inflight = self._inflight, win
        if prev is not None:
            self._retire_window(prev)

    def _step_async(self) -> bool:
        """The async twin of :meth:`step`: the same decode-priority
        schedule, but fused windows go through the two-deep pipeline, and
        the host replays window N while window N+1 runs."""
        did0 = self._sweep_deadlines()
        self._tick_exports()
        if self._must_drain():
            self._drain_pipeline()
        pend = self._inflight[0] if self._inflight is not None else 0
        la = 1
        if self.active.any():
            la = self._decode_lookahead()
            if pend and not self._lookahead_fits(la + pend):
                # the reservation must also cover the window in flight;
                # when the pool cannot, drain so preemption is safe
                self._drain_pipeline()
                pend = 0
            self._ensure_decode_pages(la + pend)
        did = self._admit_new() or did0
        if self._advance_imports():
            did = True
        decoding = bool(self.active.any())
        steps_run = 0
        if decoding:
            if self._needs_sync_decode():
                self._drain_pipeline()
                self._decode_once()
                self._mark_state_dirty()
                steps_run = 1
            elif self._spec_ok():
                # a verify round depends on the last one's accepted length:
                # depth one, from the reconciled host mirrors
                self._drain_pipeline()
                steps_run = self._decode_speculative()
                self._mark_state_dirty()
            if not steps_run and self.active.any():
                la2 = self._decode_lookahead()
                pend = self._inflight[0] if self._inflight is not None else 0
                while la2 > 1 and not self._lookahead_fits(la2 + pend):
                    la2 //= 2
                if pend and not self._lookahead_fits(la2 + pend):
                    self._drain_pipeline()
                    pend = 0
                if did or la2 + pend > la:
                    self._ensure_decode_pages(la2 + pend)
                self._decode_async(la2)
                steps_run = la2
            did = True
        elif self._inflight is not None:
            # nothing active on the host: the trailing window may still
            # hold final tokens
            self._drain_pipeline()
            did = True
        self._decode_since_prefill += steps_run
        if (not decoding) or self.cfg.prefill_interleave <= 1 \
                or self._decode_since_prefill >= self.cfg.prefill_interleave:
            if self._advance_prefills():
                did = True
                self._decode_since_prefill = 0
        return did

    def _replay_window(self, toks, acts, lps):
        """Replay a window's [K, S] trace through _emit (stop handling,
        eviction, streaming); acts[k] is the device's active mask before
        step k."""
        toks, acts, lps = toks.tolist(), acts.tolist(), lps.tolist()
        for tk, ak, lk in zip(toks, acts, lps):
            for i, slot in enumerate(self.slots):
                # slot.request goes None when _emit retires it mid-window
                if not ak[i] or slot.request is None:
                    continue
                self.positions[i] += 1
                slot.position += 1
                self._emit(i, tk[i], logprob=lk[i])
                self.last_tokens[i] = tk[i]

    # ------------------------------------------------------------------
    # Speculative decoding
    # ------------------------------------------------------------------

    def _spec_ok(self) -> bool:
        """Speculate only when it is exact: the engine opted in, and every
        active slot is greedy (n-gram) or greedy / pure temperature
        (draft: rejection sampling keeps the target's distribution); no
        penalties, top-k/top-p/min-p masks or pending aborts, which
        change the distribution mid-window; at most
        ``speculative_max_batch`` active slots."""
        if self.spec_verify is None:
            return False
        draft = self.spec_draft is not None
        n_active = 0
        for i, s in enumerate(self.slots):
            if s.request is None or not self.active[i]:
                continue
            n_active += 1
            p = s.request.params
            if p.has_penalties or s.request.aborted:
                return False
            if p.temperature > 0.0:
                if not draft:
                    return False
                if p.top_k > 0 or p.top_p < 1.0 or p.min_p > 0.0:
                    return False
        return 0 < n_active <= self.cfg.speculative_max_batch

    def _propose(self, slot_idx: int, req: Request) -> list[int]:
        """Prompt lookup: the tokens that followed the latest earlier
        occurrence of the sequence's trailing n-gram, from the slot's
        :class:`NgramIndex` (built once from resume_tokens, appended to
        by ``_emit``)."""
        k = self.cfg.speculative_min_match
        K = self.cfg.speculative_ngram
        if K <= 0:
            return []
        idx = self._ngram_idx.get(slot_idx)
        if idx is None or idx.k != k:
            idx = self._ngram_idx[slot_idx] = NgramIndex(k, req.resume_tokens())
        return idx.propose(K)

    @property
    def spec_depth(self) -> float:
        """Mean adaptive speculation depth over active slots (0 when draft
        speculation is off, idle, or fallen back)."""
        if self.spec_ctl is None:
            return 0.0
        return self.spec_ctl.mean_depth([i for i, s in enumerate(self.slots)
                                         if s.request is not None and self.active[i]])

    def _verify(self, rows: list[int], windows: list[list[int]], prop_len,
                draft: Optional[dict] = None) -> tuple:
        """One verify round over the compact rows (``windows`` the host
        part of each row's window, ``prop_len`` its proposal length;
        ``draft`` the draft path's per-row temperature, one-hot flag,
        draft flag and slot map).  A constrained row verifies under its
        grammar: the window walks the automaton from the row's table row
        (``gstate``) along the proposal.  Returns the window's (tokens,
        emitted counts, logprobs) per row.  Each row verifies through its
        adapter's lane; the draft model (if any) proposes from the base."""
        v = self.spec_verify
        L, B = v.layout, v.B
        host = L.host(B)
        toks = np.zeros((B, v.W), np.int32)
        sp = np.zeros((B,), np.int32)
        pl = np.zeros((B,), np.int32)
        gst = np.zeros((B,), np.int32)
        aids = np.zeros((B,), np.int32)
        pt = np.zeros((B, self.pages_per_seq), np.int32)
        for r, i in enumerate(rows):
            toks[r, :len(windows[r])] = windows[r]
            sp[r] = self.slots[i].position
            pl[r] = prop_len[r]
            gst[r] = self._gram_state[i]
            aids[r] = self.slot_adapters[i]
            pt[r] = self.page_tables[i]
        tl = np.where(np.arange(B) < len(rows), pl + 1, 0).astype(np.int32)
        for name, a in (("tokens", toks), ("true_lens", tl), ("start_pos", sp),
                        ("prop_len", pl), ("gstate", gst), ("aids", aids),
                        ("page_tables", pt)):
            L.put(host, name, a)
        any_random = False
        if draft is not None:
            L.put(host, "temperature", draft["temps"])
            L.put(host, "onehot", draft["onehot"].astype(np.int32))
            L.put(host, "use_draft", draft["use_draft"].astype(np.int32))
            L.put(host, "slot", np.where(draft["slot_map"] >= 0, draft["slot_map"],
                                         self.spec_draft.spare))
            any_random = bool(np.any(draft["temps"] > 0.0))
        pages = -(-int((sp + tl).max()) // self.cfg.page_size)
        return v.run(host, width_bucket(pages, self.pages_per_seq), any_random,
                     self._verify_grammar(rows), lora=bool(aids.any()))

    def _verify_grammar(self, rows: list[int]) -> Optional[tuple]:
        """(capacity, gmask, gtrans) when a row of this round is
        constrained, else None: the key part and tables of the verify
        window and the draft scan."""
        if not any(self._gram_slots[i] is not None for i in rows):
            return None
        return (self._gram_table.capacity, self._gmask, self._gtrans)

    def _emit_window(self, i: int, tokens: list[int], lps: list[float]) -> None:
        """Emit a verify window's tokens for slot ``i``; a slot retired
        mid-window (stop, budget, abort, deadline) emits no more."""
        slot = self.slots[i]
        for j, t in enumerate(tokens):
            if self.slots[i] is not slot:
                break           # _emit retired it (eviction replaces the slot)
            self.positions[i] += 1
            slot.position += 1
            self._emit(i, t, logprob=lps[j])
            self.last_tokens[i] = t

    def _decode_speculative(self) -> int:
        """One verify round over a compact batch of the speculating slots
        (padded to ``speculative_max_batch``, so one graph serves every
        round).  Every covered slot advances by its accepted proposal
        prefix plus one bonus token.  Returns the most tokens any slot
        emitted (the prefill cadence's clock), or 0 when speculation
        should not run this step (no proposal anywhere, or the page pool
        cannot fund the window without preempting): the caller then
        decodes plainly."""
        if self.spec_draft is not None:
            return self._decode_speculative_draft()
        W = self.cfg.speculative_ngram + 1
        rows: list[int] = []
        proposals: list[list[int]] = []
        for i, slot in enumerate(self.slots):
            if slot.request is None or not self.active[i]:
                continue
            # never speculate past the budget, nor past what the grammar allows
            rows.append(i)
            proposals.append(self._truncate_for_grammar(
                i, self._propose(i, slot.request)[:max(0, slot.remaining - 1)]))
        if not any(proposals):
            return 0
        if not self._lookahead_fits(W):
            # speculative pages never preempt a running sequence
            return 0
        self._ensure_decode_pages(W)
        out, n_emit, lps = self._verify(
            rows, [[int(self.last_tokens[i])] + p for i, p in zip(rows, proposals)],
            [len(p) for p in proposals])
        self.counters["decode_steps_total"] += 1
        self.counters["spec_steps_total"] += 1
        max_emitted = 0
        for r, (i, p) in enumerate(zip(rows, proposals)):
            if self.slots[i].request is None:
                continue
            self.counters["spec_proposed_tokens_total"] += len(p)
            self.counters["spec_accepted_tokens_total"] += n_emit[r] - 1
            self._emit_window(i, out[r][:n_emit[r]], lps[r])
            max_emitted = max(max_emitted, n_emit[r])
        return max_emitted

    def _decode_speculative_draft(self) -> int:
        """The draft-model round: every active slot is one row of a single
        ``[B, W]`` verify window.  Draft-mode rows carry the draft's
        proposal at the controller's depth; fallback rows an n-gram
        proposal (one-hot q); rows with nothing to propose ride along as
        a plain one-token step.  Acceptance is rejection sampling inside
        the verify graph, so sampled slots speculate too and greedy stays
        exact.  Returns the most tokens any slot emitted, or 0 to fall
        through to plain decode (every slot fallen back with no n-gram
        hit)."""
        cfg = self.cfg
        runner, ctl = self.spec_draft, self.spec_ctl
        W = max(cfg.speculative_draft_k, cfg.speculative_ngram) + 1
        rows = [i for i, slot in enumerate(self.slots)
                if slot.request is not None and self.active[i]]
        if not rows:
            return 0
        B = cfg.speculative_max_batch
        # plan each slot's draft depth (0: no draft proposal this round;
        # its draft KV may still be catching up)
        depths: dict[int, int] = {}
        for i in rows:
            slot = self.slots[i]
            depth = 0
            if ctl.mode(i) == "draft":
                depth = min(ctl.depth(i), max(0, slot.remaining - 1),
                            cfg.speculative_draft_k)
                if depth > 0:
                    pos = slot.position
                    if not (runner.sync(i, pos, slot.request.resume_tokens)
                            and runner.ensure_pages(i, pos + depth)):
                        depth = 0     # mid catch-up: a plain step this round
            depths[i] = depth
        k_exec = max(depths.values())
        if k_exec > 0:
            # power-of-two scan lengths, clamped to the window's W - 1
            k_exec = min(1 << (k_exec - 1).bit_length(), W - 1)
            # the scan writes k_exec draft positions for every drafting
            # row: a slot that cannot hold them rides along plainly
            for i in rows:
                if depths[i] > 0 and not runner.ensure_pages(
                        i, self.slots[i].position + k_exec):
                    depths[i] = 0
            if not any(depths[i] > 0 for i in rows):
                k_exec = 0
        # n-gram proposals of the fallback rows
        proposals: dict[int, list[int]] = {}
        for i in rows:
            p: list[int] = []
            if depths[i] == 0 and ctl.mode(i) == "ngram":
                if cfg.speculative_ngram > 0:
                    slot = self.slots[i]
                    p = self._propose(i, slot.request)[:max(0, min(slot.remaining - 1,
                                                                   W - 1))]
                # probation ticks whether or not the n-gram proposer is on:
                # it is what re-arms the draft
                ctl.note_fallback_round(i)
            proposals[i] = p
        if k_exec == 0 and not any(proposals.values()):
            return 0              # plain decode: nothing to verify
        if not self._lookahead_fits(W):
            return 0              # speculative pages never preempt
        self._ensure_decode_pages(W)
        # a constrained fallback row verifies only its grammar-valid prefix
        # (the draft's rows propose under the mask already)
        proposals = {i: self._truncate_for_grammar(i, p) for i, p in proposals.items()}

        slot_map = np.full((B,), -1, np.int64)
        temps = np.zeros((B,), np.float32)
        onehot = np.ones((B,), bool)
        draft_rows = np.zeros((B,), bool)
        last = np.zeros((B,), np.int32)
        sp = np.zeros((B,), np.int32)
        for r, i in enumerate(rows):
            slot = self.slots[i]
            slot_map[r] = i
            sp[r] = slot.position
            temps[r] = slot.request.params.temperature
            last[r] = int(self.last_tokens[i])
            draft_rows[r] = depths[i] > 0
            # draft rows verify against the draft's q; n-gram and empty
            # rows are deterministic proposers (one-hot q)
            onehot[r] = depths[i] <= 0
        if k_exec > 0:
            # constrained rows draft under their grammar from their row
            gst = np.zeros((B,), np.int32)
            gst[:len(rows)] = self._gram_state[rows]
            runner.propose(slot_map, last, sp, temps, draft_rows, k_exec,
                           gst, self._verify_grammar(rows))
        prop_len = [depths[i] if depths[i] > 0 else len(proposals[i]) for i in rows]
        out, n_emit, lps = self._verify(
            rows, [[int(last[r])] + proposals[i] for r, i in enumerate(rows)],
            prop_len, dict(temps=temps, onehot=onehot, use_draft=draft_rows,
                           slot_map=slot_map))
        self.counters["decode_steps_total"] += 1
        self.counters["spec_steps_total"] += 1
        if k_exec > 0:
            self.counters["spec_draft_steps_total"] += 1
        max_emitted = 0
        for r, i in enumerate(rows):
            slot = self.slots[i]
            if slot.request is None:
                continue
            a = n_emit[r] - 1       # the accepted proposal prefix
            if depths[i] > 0:
                self.counters["spec_draft_rows_total"] += 1
                self.counters["spec_draft_proposed_tokens_total"] += prop_len[r]
                self.counters["spec_draft_accepted_tokens_total"] += a
                ctl.observe(i, prop_len[r], a)
            elif prop_len[r]:
                self.counters["spec_proposed_tokens_total"] += prop_len[r]
                self.counters["spec_accepted_tokens_total"] += a
            self._emit_window(i, out[r][:n_emit[r]], lps[r])
            if self.slots[i] is slot and depths[i] > 0:
                # the scan wrote draft KV at sp .. sp + k_exec - 1: after a
                # full accept the new position is one past it, which the
                # next round's sync backfills
                runner.commit(i, min(slot.position, int(sp[r]) + k_exec))
            max_emitted = max(max_emitted, n_emit[r])
        return max_emitted

    def _stage_export(self, slot_idx: int) -> None:
        """The prefill role's export: the prompt's pages gathered on the
        device (an event recorded after the gather) and put in the
        registry; the host drain starts with the first host consumer, so
        a colocated decode engine takes the device copy instead."""
        slot = self.slots[slot_idx]
        req = slot.request
        n = len(req.prompt_tokens)
        n_pages = -(-n // self.cfg.page_size)
        t0 = time.monotonic()
        exp = stage_export(self.cache, slot.pages[:n_pages], n_tokens=n,
                           model=self.md.name, prompt_tokens=list(req.prompt_tokens),
                           first_token=req.output_tokens[0], lazy_drain=True,
                           trace_id=req.trace_id)
        if req.adapter:
            # the decode role reuses same-adapter KV only (a base export
            # keeps the JAX writer's meta byte for byte)
            exp.meta["adapter"] = req.adapter
        self.kv_exports.put(req.req_id, exp)
        self.tracer.record("kv.export.stage", req.trace_id, t0, time.monotonic() - t0,
                           pages=n_pages)

    def _publish_prefix(self, slot_idx: int) -> None:
        """Publish a finished request's whole-page prompt prefix into the
        pool store: the device gather here, the host drain on the
        export's own thread.  An adapter request publishes under its
        adapter-seeded chain, and its meta names the adapter."""
        slot = self.slots[slot_idx]
        req = slot.request
        if not req.pool_blocks:
            return
        ps = self.cfg.page_size
        # whole pages, never more than hash blocks (the advert pairs page
        # i with block hash i)
        n_pages = min(len(req.prompt_tokens) // ps, len(req.pool_blocks))
        if n_pages * ps < (self.cfg.kv_pool_min_tokens or ps):
            return
        blocks = list(req.pool_blocks[:n_pages])
        key = pool_key(blocks)
        if self.kv_pool.has(key):
            return
        t0 = time.monotonic()
        exp = stage_export(self.cache, slot.pages[:n_pages], n_tokens=n_pages * ps,
                           model=self.md.name,
                           prompt_tokens=req.prompt_tokens[:n_pages * ps],
                           first_token=-1, trace_id=req.trace_id)
        if req.adapter:
            exp.meta["adapter"] = req.adapter
        self.kv_pool.put(PoolEntry(key=key, blocks=blocks, n_tokens=n_pages * ps,
                                   n_pages=n_pages, export=exp,
                                   nbytes=meta_nbytes(exp.meta)))
        self.counters["kv_pool_published_total"] += 1
        self.tracer.record("kv.pool.publish", req.trace_id, t0, time.monotonic() - t0,
                           pages=n_pages)

    def _stop_set(self, req: Request) -> set:
        stop_ids = set(req.params.stop_token_ids)
        eos = self.tokenizer.eos_token_id
        if eos is not None and not req.params.ignore_eos:
            stop_ids.add(eos)
        return stop_ids

    def _emit(self, slot_idx: int, token: int, logprob: Optional[float] = None):
        """Deliver one generated token; retire the slot when finished."""
        slot = self.slots[slot_idx]
        req = slot.request
        if self.itl_hist is not None:
            # the one stamp site every retire path shares (single steps,
            # a replayed window, the async loop's replay): the instant
            # the host hands the token to the client
            now = self._itl_time()
            last = req.last_emit_time
            req.last_emit_time = now
            if last is not None:
                gap = now - last
                self.itl_hist.observe(gap)
                if gap > self._itl_stall_s:
                    self.counters["itl_stalls_total"] += 1
                obs = self.itl_observer
                if obs is not None:
                    obs(gap, req.tenant)
        req.output_tokens.append(token)
        gs = self._gram_slots[slot_idx]
        if gs is not None:
            # the host mirror of the device grammar state (a window
            # advanced the device's already): exact for the next sync
            # upload, a preemption's replay and speculation's walks
            gs.advance(token)
            self._gram_state[slot_idx] = gs.base + gs.state
        ngram_idx = self._ngram_idx.get(slot_idx)
        if ngram_idx is not None:
            ngram_idx.append(token)
        if req.params.logprobs:
            req.output_logprobs.append(logprob)
        slot.remaining -= 1
        self._remaining[slot_idx] = slot.remaining
        self.counters["generation_tokens_total"] += 1
        stop_ids = self._stop_set(req)
        if token not in stop_ids:
            req.out.put(token)
        if token in stop_ids or slot.remaining <= 0 or req.aborted:
            req.finish_reason = "stop" if token in stop_ids else "length"
            req.finish_time = time.monotonic()
            # both gathers run before _evict_slot, while the pages still
            # hold the request's KV (the gathers copy them)
            if req.export_kv:
                self._stage_export(slot_idx)
            if self.kv_pool is not None:
                try:
                    self._publish_prefix(slot_idx)
                except Exception:
                    # an optimization: it never takes the request down
                    logger.exception("KV pool publish failed for %s", req.req_id)
            self._finish_trace(req)
            req.out.put(None)
            if self.host_kv is not None:
                self.host_kv.discard(req.req_id)
            self._evict_slot(slot_idx, commit=True)
            self.counters["requests_finished_total"] += 1
