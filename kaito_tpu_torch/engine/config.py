"""Engine configuration.

The serving-side contract the reference exposes through vLLM flags +
the KAITO config file (``inference_api.py:64-160`` merges
``--kaito-config-file`` YAML over the vLLM arg surface).  Our config is
a dataclass consumed by the engine, the scheduler and the HTTP server;
the workload generator renders it into the pod command line.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass
class EngineConfig:
    model: str = "tiny-llama-test"      # preset name or HF id
    max_model_len: int = 0               # 0 = model's own limit, capped by HBM
    page_size: int = 64                  # KV tokens per page
    max_num_seqs: int = 8                # concurrent decode slots
    max_pages: int = 0                   # 0 = derive from HBM budget
    max_prefill_tokens: int = 512        # prefill chunk budget per step
    prefill_interleave: int = 2          # decode steps between prefill chunks
    # packed multi-sequence prefill (docs/prefill.md): the per-step
    # prefill budget above becomes an AGGREGATE token budget spread over
    # a PACK of staged slots (segment packing for fresh prompts,
    # batch-axis packing for same-bucket context chunks), so concurrent
    # arrivals stop serializing at batch 1.  0 = auto (pack up to
    # max_num_seqs); 1 reproduces the serial round-robin scheduler
    # byte-identically.
    prefill_pack: int = 0
    prefill_buckets: tuple[int, ...] = (128, 256, 512, 1024, 2048, 4096)
    dtype: str = "bfloat16"
    # KV page-pool dtype: "bfloat16" | "float32" | "int8".  int8 stores
    # quantized codes plus per-page-per-head fp32 scales (kv_cache.py):
    # ~2x pages at equal HBM and half the decode-step KV read.
    kv_dtype: str = "bfloat16"
    # weight-only quantization: "" (off) | "int8" (per-out-channel
    # symmetric) | "int4" (packed two-per-byte, per-group g=128
    # per-out-channel scales; fused Pallas dequant matmul on TPU —
    # docs/quantization.md).  Decode is param-bandwidth-bound, so
    # halving/quartering weight bytes is a direct throughput lever;
    # the reference's vLLM surface exposes the same knob as
    # --quantization.
    quantization: str = ""
    seed: int = 0
    tensor_parallel: int = 1             # TP degree (mesh "tensor" axis)
    expert_parallel: int = 1             # EP degree (mesh "expert" axis)
    pipeline_parallel: int = 1           # PP stages (mesh "pipeline" axis)
    # context-parallel prefill (mesh "sequence" axis): long prompts run
    # as ONE ring-attention prefill sharded over the sequence axis
    # instead of serial chunks — TTFT scales ~1/sequence_parallel while
    # decode stays TP (the KV pool is replicated over the axis).
    sequence_parallel: int = 1
    cp_min_tokens: int = 2048            # prompts >= this take the CP path
    cp_q_tile: int = 1024                # ring query tile (memory bound)
    pp_microbatches: int = 4             # decode microbatches through the ring
    data_parallel: int = 1               # engine replica groups
    use_pallas: Optional[bool] = None    # the JAX engine's Pallas switch; the port ignores it
    # fused decode steps per dispatch when the batch is in steady-state
    # decode (no prefills staged, queue empty): one lax.scan dispatch
    # runs K steps with on-device sampling + stop detection, amortizing
    # the per-step host round-trip.  None = auto: 1 on the CPU;
    # on CUDA engine.AUTO_RUN_AHEAD_CUDA, measured on an H100 (PERF.md)
    decode_run_ahead: Optional[int] = None
    # fused decode steps per dispatch while requests are waiting or
    # prefilling (the sustained-admission regime).  Smaller than
    # decode_run_ahead so admissions and prefill chunks keep a bounded
    # latency; 0 restores the round-2 collapse-to-single-step behavior
    fused_under_load: int = 4
    # zero-bubble decode loop (docs/decode-loop.md): device-resident
    # loop state plus a two-deep dispatch pipeline that overlaps host
    # postprocess (stop replay, streaming, scheduling) with device
    # compute.  None = follow KAITO_ASYNC_DISPATCH (off when unset);
    # True/False force it.  Off keeps the synchronous loop
    # byte-identical to before (no new metric families).
    async_dispatch: Optional[bool] = None
    # collective-compute overlap for TP decode (docs/multichip.md):
    # decompose the row-parallel projections' output all-reduce into
    # pipelined reduce-scatter + all-gather ring hops (ppermute), each
    # overlapped with the next chunk's partial matmul, and stream the
    # next layer's quantized slab into VMEM while the hops drain.
    # None = follow KAITO_COMM_OVERLAP (off when unset); True/False
    # force it.  Off keeps dispatch, numerics and the /metrics
    # exposition byte-identical; the gate only ever engages on a
    # TP>=2 mesh (never PP/single-chip, never prefill).
    comm_overlap: Optional[bool] = None
    # n-gram (prompt-lookup) speculative decoding: propose up to N
    # continuation tokens by matching the trailing n-gram against the
    # sequence's own context, verify them in ONE windowed dispatch, and
    # emit the accepted prefix + a bonus token — exact greedy
    # equivalence, no draft model.  0 = off.  Engages only when every
    # active slot is greedy and the batch is at most
    # speculative_max_batch (the [B, W, V] verify logits stay small;
    # speculation pays off in the low-batch latency regime anyway).
    speculative_ngram: int = 0
    speculative_min_match: int = 2
    speculative_max_batch: int = 8
    # draft-model speculative decoding (docs/speculative.md): a small
    # co-resident draft preset proposes up to speculative_draft_k
    # tokens per slot, the target verifies the window in one forward,
    # and Leviathan rejection sampling keeps sampled traffic
    # distribution-identical (greedy stays bit-exact).  A per-slot
    # accept-rate controller adapts the depth and falls back to the
    # n-gram proposer (then plain decode) on sustained-poor acceptance.
    # "" = off; the value names a catalog preset sharing the target's
    # tokenizer (validated at load).
    speculative_draft: str = ""
    speculative_draft_k: int = 4
    speculative_draft_weights_dir: str = ""   # "" = synthetic weights
    # serving-side knobs carried over from the reference wrapper surface
    port: int = 5000
    served_model_name: str = ""
    adapters_dir: str = ""               # LoRA adapter discovery dir
    # dynamic multi-LoRA serving (docs/multi-lora.md): a fixed-capacity
    # HBM slot table of stacked adapter factors sized [L, slots+1, in,
    # rmax] at boot, so hot-loading an adapter over /v1/adapters is an
    # in-place buffer write — zero recompiles — and eviction demotes to
    # a host-RAM LRU tier that faults back in on the next request.
    # 0 = off: the static boot-discovery path (and the /v1/adapters 403,
    # the metrics exposition) stay byte-identical to before.
    adapter_slots: int = 0
    adapter_rmax: int = 16               # max servable adapter rank
    adapter_host_bytes: int = 256 << 20  # host-RAM overflow tier budget
    # base-model mismatch is load-REFUSAL (counted as
    # kaito:adapter_load_failures_total{reason="base_mismatch"}) unless
    # this escape hatch is set — serving wrong-base deltas silently was
    # the old (round-1) warning behavior
    adapter_allow_base_mismatch: bool = False
    # comma-separated URL/scheme prefixes POST /v1/adapters may pull
    # from ("" = local paths only, same trust model as
    # pd_source_allowlist)
    adapter_source_allowlist: str = ""
    weights_dir: str = ""                # safetensors checkpoint dir ("" = synthetic)
    disable_rate_limit: bool = False
    enable_prefix_caching: bool = True   # native radix-tree prefix reuse
    host_kv_offload_bytes: int = 0       # host-RAM KV spill tier (0 = off)
    pd_enabled: bool = False             # P/D side-channel routes (MRI roles)
    pd_source_allowlist: str = ""        # comma URL prefixes for KV pulls
    max_queue_len: int = 256
    # cluster-wide KV pool (docs/kv-pool.md): replicas publish whole-page
    # prompt-prefix KV into a per-replica store served over the chunked
    # PD wire; the EPP aggregates adverts into a prefix->holder index
    # and either routes to the holder or tells the picked replica to
    # fetch.  Default OFF: with the pool disabled, scheduling behavior
    # and the /metrics exposition are byte-identical to before.
    kv_pool_enabled: bool = False
    kv_pool_bytes: int = 1 << 30         # host bytes for the prefix store
    kv_pool_min_tokens: int = 0          # min prefix tokens to publish
    # (0 = one KV page, i.e. page_size tokens)
    # tier-3 SSD spill under the pool (docs/kv-pool.md "Tier 3: SSD"):
    # entries evicted from the host LRU demote to a bounded slab
    # directory instead of vanishing, and pool misses probe it before
    # remote peers and before recompute.  0 = no disk tier (no spill
    # thread, no kv_tier metric families — byte-identical off).
    kv_pool_disk_bytes: int = 0
    kv_pool_disk_dir: str = ""           # "" = <tempdir>/kaito-kv-tier
    # cap /debug/kv_pool adverts to the freshest N entries per scrape
    # (0 = unlimited); the EPP treats a capped advert as authoritative
    # only for the rows it lists
    kv_pool_advert_max: int = 0
    # grammar-constrained decoding (docs/structured-output.md):
    # response_format={json_schema|json_object|regex} and forced tool
    # calls compile into token-level masks applied on device.  The
    # surface is on by default but completely pay-per-use: with no
    # constrained request in flight the decode path compiles the mask
    # branch away and the /metrics exposition is byte-identical.
    # False rejects response_format/tools-constrained requests with a
    # typed 400 (fleet operators pinning the old surface).
    structured_output: bool = True
    grammar_cache_entries: int = 64      # compiled-schema LRU entries
    # DFA state cap per grammar; each state costs O(vocab) device bytes
    # in the packed mask table, so this bounds both compile time and
    # the table footprint
    grammar_max_states: int = 512
    # multi-tenant QoS (docs/qos.md): JSON tenant-class document
    # (inline, or @path to a file) parsed by engine.qos.  "" = off —
    # one implicit tenant, legacy FIFO admission and
    # newest-preempts-first eviction, byte-identical exposition.
    qos_config: str = ""
    # failure-domain isolation (docs/failure-domains.md)
    request_timeout_s: float = 0.0       # server-default deadline (0 = off);
    # clients may tighten per request via the body's "timeout" field
    kv_shed_threshold: float = 0.0       # shed new work with 429 when KV-page
    # usage crosses this fraction while a queue exists (0 = off)
    kv_import_retries: int = 1           # transient KV-transfer failures fall
    # back to local recompute this many times before failing the request
    # observability (docs/observability.md)
    slow_request_threshold_s: float = 0.0  # dump a request's span tree to the
    # log when its end-to-end latency crosses this (0 = off)
    trace_capacity: int = 8192           # span ring-buffer entries
    timeline_capacity: int = 4096        # step flight-recorder entries
    # SLO watchdog targets (runtime/slo.py; defaults = BASELINE north
    # star).  Env vars KAITO_SLO_* override these at server start.
    slo_ttft_p50_ms: float = 200.0
    slo_ttft_p99_ms: float = 1000.0
    slo_itl_p99_ms: float = 250.0
    slo_tokens_per_sec_per_chip: float = 2000.0
    slo_availability: float = 0.999
    # true per-token inter-token latency (--itl / KAITO_ITL): stamp
    # every retired token's wall time in the emit path and feed gaps
    # into kaito:inter_token_latency_seconds + the watchdog's itl_p99
    # SLI.  Off = no stamps, no families, byte-identical exposition.
    itl_enabled: bool = False
    # serving role this replica's SLO burn attributes to ("prefill" /
    # "decode"; empty = "unified").  Set by the MRI role annotation via
    # KAITO_INFERENCE_ROLE so disaggregated pools scale on the right SLO.
    role: str = ""
    # incident flight recorder (utils/flightrec.py): directory for
    # bounded JSON bundles snapshotting every debug surface on an SLO
    # page, an engine-fatal error, or SIGTERM with in-flight requests.
    # Empty = off — no watcher thread, /debug/flight 403.
    flight_dir: str = ""
    flight_max_bundles: int = 16         # LRU by mtime beyond this
    # sampled device-time attribution (engine/devprof.py).  0 = off —
    # no sampler thread, no kaito:device_* families, /debug/device 403,
    # byte-identical exposition.  >0 captures a devprof_window_s
    # torch.profiler window every devprof_interval_s and folds it into
    # comm/compute/idle buckets + per-phase device metrics.
    devprof_interval_s: float = 0.0
    devprof_window_s: float = 0.25       # capture length per sample
    devprof_ring: int = 16               # recent windows kept for /debug/device

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)

    @property
    def pages_per_seq(self) -> int:
        if not self.max_model_len:
            raise ValueError("max_model_len not resolved")
        return -(-self.max_model_len // self.page_size)
