"""Prometheus text-exposition metrics, dependency-free.

The port's own copy of ``kaito_tpu/engine/metrics.py``: the serving
metric surface the KEDA scaler, the InferencePool EPP and the benchmark
probe scrape at :5000/metrics, under the names of vLLM's ``vllm:*``
series with the ``kaito:`` prefix.  Under one ``EngineConfig`` the
port's ``/metrics`` exposes exactly the JAX server's families; a family
whose feature the port lacks reads as the JAX server's does with that
feature off.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Iterable, Optional


def process_rss_bytes() -> float:
    """Resident set size of this process, dependency-free: /proc on
    Linux, getrusage fallback elsewhere, 0.0 when neither works."""
    try:
        with open("/proc/self/statm") as f:
            return float(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        pass
    try:
        import resource

        return float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) \
            * 1024.0
    except Exception:
        return 0.0


class Counter:
    def __init__(self, name: str, help_: str, registry: "Optional[Registry]",
                 labels: tuple[str, ...] = ()):
        self.name, self.help = name, help_
        self.label_names = labels
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()
        if registry is not None:
            registry.register(self)

    def inc(self, amount: float = 1.0, **labels):
        key = tuple(str(labels.get(l, "")) for l in self.label_names)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = tuple(str(labels.get(l, "")) for l in self.label_names)
        with self._lock:
            return self._values.get(key, 0.0)

    def collect(self) -> Iterable[str]:
        with self._lock:
            values = sorted(self._values.items())
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} counter"
        if not values:
            # a labelled family with no samples emits nothing: an
            # unlabelled `name 0` here would clash with labelled
            # samples the moment the first one appears
            if not self.label_names:
                yield f"{self.name} 0"
            return
        for key, v in values:
            yield f"{self.name}{_fmt_labels(self.label_names, key)} {_fmt(v)}"


class Gauge:
    """Unlabelled (the original surface: ``.value`` / ``set(v)`` / a
    scalar ``fn``) or labelled like Counter/Histogram.  A labelled
    gauge stores one value per label set via ``set(v, **labels)``; a
    labelled ``fn`` computes the whole family at scrape time and must
    return a mapping of label-value tuples to floats (the router's
    breaker state and the SLO burn rates are time-derived, so they
    can't be stored)."""

    def __init__(self, name: str, help_: str, registry: "Optional[Registry]",
                 fn=None, labels: tuple[str, ...] = ()):
        self.name, self.help = name, help_
        self.fn = fn
        self.label_names = labels
        self.value = 0.0
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()
        if registry is not None:
            registry.register(self)

    def set(self, v: float, **labels):
        if self.label_names:
            key = tuple(str(labels.get(l, "")) for l in self.label_names)
            with self._lock:
                self._values[key] = float(v)
        else:
            self.value = float(v)

    def clear(self) -> None:
        """Drop every stored series (per-CR gauges are rebuilt from a
        full listing each resync, so deleted objects must not linger)."""
        with self._lock:
            self._values.clear()

    def collect(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} gauge"
        if self.label_names:
            if self.fn is not None:
                computed = self.fn() or {}
                items = sorted(
                    (tuple(str(x) for x in k), v)
                    for k, v in computed.items())
            else:
                with self._lock:
                    items = sorted(self._values.items())
            for key, v in items:
                yield (f"{self.name}"
                       f"{_fmt_labels(self.label_names, key)} {_fmt(v)}")
            return
        v = self.fn() if self.fn is not None else self.value
        yield f"{self.name} {_fmt(v)}"


class Histogram:
    DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                       0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

    def __init__(self, name: str, help_: str, registry: "Optional[Registry]",
                 buckets: Optional[tuple] = None,
                 labels: tuple[str, ...] = ()):
        self.name, self.help = name, help_
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self.label_names = labels
        # aggregate across all label values — `percentile()` and the
        # unlabelled exposition read these
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._total = 0
        # label-values tuple -> [counts, sum, total] (labelled families)
        self._series: dict[tuple, list] = {}
        self._lock = threading.Lock()
        if registry is not None:
            registry.register(self)

    def observe(self, v: float, **labels):
        idx = len(self.buckets)
        for i, b in enumerate(self.buckets):
            if v <= b:
                idx = i
                break
        with self._lock:
            self._sum += v
            self._total += 1
            self._counts[idx] += 1
            if self.label_names:
                key = tuple(str(labels.get(l, ""))
                            for l in self.label_names)
                s = self._series.get(key)
                if s is None:
                    s = self._series[key] = [
                        [0] * (len(self.buckets) + 1), 0.0, 0]
                s[0][idx] += 1
                s[1] += v
                s[2] += 1

    @property
    def count(self) -> int:
        """Observations so far, across all label values."""
        with self._lock:
            return self._total

    def _emit_series(self, label_names, label_values, counts, sum_,
                     total) -> Iterable[str]:
        cum = 0
        for i, b in enumerate(self.buckets):
            cum += counts[i]
            lbl = _fmt_labels(label_names + ("le",),
                              label_values + (_fmt(b),))
            yield f"{self.name}_bucket{lbl} {cum}"
        cum += counts[-1]
        lbl = _fmt_labels(label_names + ("le",), label_values + ("+Inf",))
        yield f"{self.name}_bucket{lbl} {cum}"
        lbl = _fmt_labels(label_names, label_values)
        yield f"{self.name}_sum{lbl} {_fmt(sum_)}"
        yield f"{self.name}_count{lbl} {total}"

    def collect(self) -> Iterable[str]:
        # snapshot under the lock, format outside it: a concurrent
        # observe() must never see buckets inconsistent with _count/_sum
        with self._lock:
            if self.label_names:
                series = [(k, list(s[0]), s[1], s[2])
                          for k, s in sorted(self._series.items())]
            else:
                counts, sum_, total = list(self._counts), self._sum, self._total
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} histogram"
        if self.label_names:
            for key, c, s, t in series:
                yield from self._emit_series(self.label_names, key, c, s, t)
        else:
            yield from self._emit_series((), (), counts, sum_, total)


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label_value(v) -> str:
    # exposition format: backslash first, then quote and newline
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(names, values) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label_value(v)}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


class Registry:
    def __init__(self):
        self._metrics = []

    def register(self, m):
        """Accepts any object with a ``collect() -> Iterable[str]``
        method — custom collectors (e.g. the router's breaker-state
        gauges, computed at scrape time) register alongside metrics."""
        self._metrics.append(m)

    def expose(self) -> str:
        lines: list[str] = []
        for m in self._metrics:
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"


class _GrammarCollector:
    """The gated ``kaito:grammar_*`` family: nothing until the grammar
    cache has served a constrained request (``GrammarCache.touched``), so
    a deployment that never sends ``response_format`` or ``tools`` keeps
    the same exposition.  Gated at scrape time, since the first
    constrained request can come long after registration."""

    def __init__(self, engine):
        self.engine = engine

    def collect(self) -> Iterable[str]:
        cache = self.engine.grammar_cache
        if not cache.touched:
            return
        name = "kaito:grammar_compile_seconds"
        yield f"# HELP {name} Schema/regex -> token-mask grammar compile latency"
        yield f"# TYPE {name} histogram"
        counts = list(cache.compile_bucket_counts)
        cum = 0
        for i, edge in enumerate(cache.compile_buckets):
            cum += counts[i]
            yield f'{name}_bucket{{le="{_fmt(edge)}"}} {cum}'
        cum += counts[-1]
        yield f'{name}_bucket{{le="+Inf"}} {cum}'
        yield f"{name}_sum {_fmt(cache.compile_sum_seconds)}"
        yield f"{name}_count {cache.compile_count}"
        stats = cache.stats()
        for key, help_ in (
                ("grammar_cache_hits_total",
                 "Constrained requests served a precompiled grammar"),
                ("grammar_cache_misses_total",
                 "Constrained requests that compiled a new grammar"),
                ("grammar_cache_evictions_total",
                 "Grammars LRU-evicted from the compile cache"),
                ("grammar_requests_total",
                 "Requests admitted with a decoding grammar attached"),
                ("grammar_cache_entries",
                 "Grammars resident in the compile cache")):
            mname = f"kaito:{key}"
            yield f"# HELP {mname} {help_}"
            yield f"# TYPE {mname} gauge"
            yield f"{mname} {_fmt(stats.get(key, 0))}"


def _counter_fn(engine, key: str):
    return lambda: engine.counters.get(key, 0)


class EngineMetrics:
    """The engine's metric families (names mirror vLLM's so the KEDA
    scaler/EPP configs translate 1:1).  The host KV tier's families read
    0 with the tier off; the ``kaito:kv_pool_*`` ones exist only with the
    cluster KV pool on, the ``kaito:kv_tier_*`` ones only with its disk
    tier.  The per-tenant families exist only with a QoS config
    (``qos``), the ITL ones only with the engine's ITL recorder on, the
    ``kaito:adapter_*`` ones only with the adapter cache on (or a
    boot-time refusal counted), the ``kaito:device_*`` ones only with
    the device profiler on."""

    def __init__(self, engine=None, qos=None):
        self.registry = Registry()
        r = self.registry
        # per-tenant slices exist ONLY with a QoS config: collect()
        # emits HELP/TYPE lines even for an empty family, and the
        # QoS-off exposition must stay byte-identical
        self.tenant_shed = None
        self.tenant_served = None
        if qos is not None:
            self.tenant_shed = Counter(
                "kaito:requests_shed_total",
                "Requests shed by admission control, per tenant", r,
                labels=("tenant",))
            self.tenant_served = Counter(
                "kaito:requests_served_total",
                "Requests completed, per tenant", r, labels=("tenant",))
        self.prompt_tokens = Counter(
            "kaito:prompt_tokens_total", "Prefill tokens processed", r)
        self.generation_tokens = Counter(
            "kaito:generation_tokens_total", "Tokens generated", r)
        self.request_success = Counter(
            "kaito:request_success_total", "Requests finished", r,
            labels=("finished_reason",))
        self.requests_rejected = Counter(
            "kaito:request_rejected_total", "Requests rejected (rate limit)", r)
        self.requests_shed = Counter(
            "kaito:request_shed_total",
            "Requests shed by admission control (429 + Retry-After)", r,
            labels=("reason",))
        self.ttft = Histogram(
            "kaito:time_to_first_token_seconds", "Time to first token", r)
        self.tpot = Histogram(
            "kaito:time_per_output_token_seconds",
            "Per-request MEAN time per output token "
            "((finish - first_token) / (n_out - 1)); decode stalls "
            "average out — see kaito:inter_token_latency_seconds (--itl) "
            "for true per-token gaps", r,
            buckets=(0.002, 0.005, 0.01, 0.02, 0.04, 0.06, 0.08, 0.1, 0.25,
                     0.5, 1.0))
        self.e2e_latency = Histogram(
            "kaito:e2e_request_latency_seconds", "End-to-end request latency", r)
        # process-level gauges: fleet rollups use uptime to tell a
        # restarted replica (counters reset, uptime tiny) from a quiet
        # one, and RSS to spot a leaking replica before the OOM-killer
        self._started_monotonic = time.monotonic()
        Gauge("kaito:process_uptime_seconds",
              "Seconds since this serving process started", r,
              fn=lambda: time.monotonic() - self._started_monotonic)
        Gauge("kaito:process_resident_memory_bytes",
              "Resident set size of the serving process", r,
              fn=process_rss_bytes)
        if engine is None:
            return
        # the engine owns its step/queue-wait histograms (observed from
        # the scheduler thread); expose them through this registry
        # rather than duplicating series
        for attr in ("step_hist", "queue_wait_hist", "dispatch_gap_hist",
                     "prefill_pack_hist", "prefill_wait_hist"):
            h = getattr(engine, attr, None)
            if h is not None:
                r.register(h)
        # true per-token ITL: itl_hist is None when the recorder is off,
        # so neither family exists and the exposition stays as it was
        if engine.itl_hist is not None:
            r.register(engine.itl_hist)
            Gauge("kaito:itl_stalls_total",
                  "Inter-token gaps exceeding the ITL SLO target "
                  "(--slo-itl-p99-ms)", r,
                  fn=_counter_fn(engine, "itl_stalls_total"))

        def _slots_total():
            return len(engine.slots)

        Gauge("kaito:batch_occupancy",
              "Active decode slots / max batch size", r,
              fn=lambda: engine.num_running / max(1, _slots_total()))
        # absolute slot gauges next to the ratio: fleet rollups sum
        # these across replicas (a ratio can't be summed)
        Gauge("kaito:active_slots", "Decode slots occupied right now",
              r, fn=lambda: engine.num_running)
        Gauge("kaito:slots_total", "Decode slot capacity", r,
              fn=_slots_total)
        Gauge("kaito:num_requests_running", "Active decode slots", r,
              fn=lambda: engine.num_running)
        Gauge("kaito:num_requests_waiting", "Queued requests", r,
              fn=lambda: engine.num_waiting)
        Gauge("kaito:kv_cache_usage_perc", "KV page pool usage", r,
              fn=lambda: 1.0 - engine.allocator.available /
              max(engine.allocator.num_pages - 1, 1))
        Gauge("kaito:kv_pages_total", "Total KV pages", r,
              fn=lambda: engine.allocator.num_pages - 1)
        # page size gauge: the benchmark probe derives concurrency from
        # KV capacity and must not hardcode the page size
        Gauge("kaito:kv_page_size", "Tokens per KV page", r,
              fn=lambda: engine.cfg.page_size)
        for name, help_, key in (
                ("num_preemptions_total", "Sequences preempted",
                 "preemptions_total"),
                ("prefix_cached_tokens_total",
                 "Prompt tokens served from the prefix cache",
                 "prefix_cached_tokens_total"),
                # per-request hit/miss split: the EPP judges affinity
                # quality from these
                ("prefix_cache_hits_total",
                 "Requests admitted with a nonzero cached prefix",
                 "prefix_cache_hits_total"),
                ("prefix_cache_misses_total",
                 "Cache-eligible requests admitted with no cached prefix",
                 "prefix_cache_misses_total"),
                ("host_kv_spilled_pages_total",
                 "KV pages spilled to the host offload tier",
                 "host_kv_spilled_pages_total"),
                ("host_kv_restored_pages_total",
                 "KV pages restored from the host offload tier",
                 "host_kv_restored_pages_total")):
            Gauge(f"kaito:{name}", help_, r, fn=_counter_fn(engine, key))
        # the host KV offload tier: 0 with the tier off
        def host_kv(read):
            return lambda: (read(engine.host_kv)
                            if getattr(engine, "host_kv", None) is not None else 0)

        for name, help_, read in (
                ("host_kv_bytes_used", "Bytes held by the host KV offload tier",
                 lambda p: p.used_bytes),
                ("host_kv_entries",
                 "Sequences parked in the host KV offload tier", len),
                ("host_kv_hits_total",
                 "Host KV offload pops that found the sequence", lambda p: p.hits),
                ("host_kv_misses_total",
                 "Host KV offload pops that came up empty", lambda p: p.misses),
                ("host_kv_evictions_total",
                 "Entries LRU-evicted from the host KV offload tier",
                 lambda p: p.evicted_entries)):
            Gauge(f"kaito:{name}", help_, r, fn=host_kv(read))
        if getattr(engine, "kv_pool", None) is not None:
            # the cluster KV pool: the families exist only with it on
            # (collect() emits HELP/TYPE even for a zero series)
            pool = engine.kv_pool
            for name, help_, fn in (
                    ("kv_pool_entries", "Prefix entries in the cluster KV pool store",
                     lambda: len(pool)),
                    ("kv_pool_bytes_used", "Host bytes held by the cluster KV pool store",
                     lambda: pool.used_bytes),
                    ("kv_pool_published_total", "Prefix entries published to the pool "
                     "store", lambda: pool.published_total),
                    ("kv_pool_evictions_total", "Prefix entries LRU-evicted from the pool "
                     "store", lambda: pool.evictions_total),
                    ("kv_pool_hits_total", "Pool fetch handshakes served from the store",
                     lambda: pool.hits_total),
                    ("kv_pool_misses_total", "Pool fetch handshakes that missed (evicted)",
                     lambda: pool.misses_total),
                    ("kv_pool_fetches_total", "Cross-replica prefix fetches imported",
                     _counter_fn(engine, "kv_pool_fetches_total")),
                    ("kv_pool_fetched_tokens_total", "Prompt tokens imported via "
                     "cross-replica fetch", _counter_fn(engine, "kv_pool_fetched_tokens_total")),
                    ("kv_pool_fetch_failures_total", "Prefix fetches that fell back to "
                     "local recompute", _counter_fn(engine, "kv_pool_fetch_failures_total"))):
                Gauge(f"kaito:{name}", help_, r, fn=fn)
        if getattr(engine, "kv_tier", None) is not None:
            # the pool's disk tier: the families exist only with it on
            tier = engine.kv_tier
            Gauge("kaito:kv_tier_hits_total", "Local tiered-probe hits by serving tier",
                  r, labels=("tier",),
                  fn=lambda: {("host",): float(engine.counters["kv_tier_host_hits_total"]),
                              ("disk",): float(engine.counters["kv_tier_disk_hits_total"])})
            for name, help_, fn in (
                    ("kv_tier_entries", "Prefix entries resident in the SSD tier",
                     lambda: len(tier)),
                    ("kv_tier_bytes_used", "SSD bytes held by the disk tier (slabs + "
                     "meta)", lambda: tier.used_bytes),
                    ("kv_tier_spills_total", "Host-LRU victims persisted to the SSD tier",
                     lambda: tier.spills_total),
                    ("kv_tier_evictions_total", "Entries pruned from the SSD tier by its "
                     "byte budget", lambda: tier.evictions_total),
                    ("kv_tier_errors_total", "Corrupt slabs, failed writes, truncated "
                     "reads in the SSD tier", lambda: tier.errors_total),
                    ("kv_tier_import_tokens_total", "Prompt tokens imported from the "
                     "local host/SSD tiers instead of recomputed",
                     _counter_fn(engine, "kv_tier_import_tokens_total")),
                    ("kv_tier_spill_drops_total", "Evicted entries dropped because the "
                     "spill queue was full",
                     _counter_fn(engine, "kv_tier_spill_drops_total")),
                    ("kv_tier_disk_read_bytes_per_s", "Measured EWMA SSD read bandwidth "
                     "feeding the break-even veto (0 before the first sample)",
                     lambda: engine.pd_costs.snapshot()["disk_bytes_s"] or 0.0)):
                Gauge(f"kaito:{name}", help_, r, fn=fn)
        if engine.async_dispatch:
            # the family exists only with the async loop on, like the
            # dispatch-gap histogram above
            Gauge("kaito:engine_h2d_uploads_total",
                  "Loop-state arrays uploaded host-to-device at "
                  "decode dispatch (~zero per dispatch in steady "
                  "state)", r, fn=_counter_fn(engine, "h2d_uploads_total"))
        if getattr(engine, "devprof", None) is not None:
            # sampled device-time attribution (engine/devprof.py): the
            # families exist only with devprof_interval_s > 0, and read
            # the last window (0.0 before the first one lands)
            dp = engine.devprof
            r.register(dp.capture_hist)
            Gauge("kaito:device_bucket_pct",
                  "Share of device wall in each op class for the last sampled "
                  "window (buckets + idle sum to 100)", r, labels=("bucket",),
                  fn=dp.bucket_pct)
            Gauge("kaito:device_phase_pct",
                  "Share of device wall attributed to each engine phase "
                  "(kaito/<phase>)", r, labels=("phase",), fn=dp.phase_pct)
            Gauge("kaito:device_comm_pct",
                  "Collective share of device wall, last window", r,
                  fn=dp.comm_pct)
            Gauge("kaito:device_comm_compute_overlap_pct",
                  "Share of collective time co-scheduled with compute on "
                  "another unit (hidden, not serialized)", r, fn=dp.overlap_pct)
            Gauge("kaito:device_copy_overlap_pct",
                  "Share of copy/DMA time overlapped with other work", r,
                  fn=dp.copy_overlap_pct)
            Gauge("kaito:device_idle_pct", "Idle share of device wall, last window",
                  r, fn=dp.idle_pct)
            Gauge("kaito:device_phase_attributed_pct",
                  "Share of busy device time carrying a kaito/* phase marker", r,
                  fn=lambda: dp._lastval("phase_attributed_pct"))
            Gauge("kaito:device_matmul_pct_of_peak_flops",
                  "Window decode throughput vs the card's peak FLOPs "
                  "(windowed mfu_pct)", r,
                  fn=lambda: dp._lastval("matmul_pct_of_peak_flops"))
            Gauge("kaito:device_hbm_pct_of_peak",
                  "Window weight-stream bandwidth vs the card's peak memory "
                  "bandwidth", r, fn=lambda: dp._lastval("hbm_pct_of_peak"))
            Gauge("kaito:device_windows_total",
                  "Devprof windows captured and parsed", r,
                  fn=lambda: dp.windows_total)
            Gauge("kaito:device_windows_skipped_total",
                  "Devprof windows skipped (manual profile active or profiler "
                  "refused)", r, fn=lambda: dp.windows_skipped)
            Gauge("kaito:device_window_errors_total",
                  "Devprof windows whose trace failed to parse", r,
                  fn=lambda: dp.parse_errors)
        if getattr(engine, "adapter_cache", None) is not None:
            # the multi-LoRA cache: the families exist only with it on,
            # so a server without adapter config exposes what it did
            ac = engine.adapter_cache
            Gauge("kaito:adapter_resident",
                  "Adapters resident in the HBM slot table", r, fn=lambda: len(ac))
            Gauge("kaito:adapter_slots_total", "HBM adapter slot capacity", r,
                  fn=lambda: ac.slots)
            Gauge("kaito:adapter_loads_total",
                  "Adapter installs into an HBM slot (boot, hot-load, "
                  "fault-back-in)", r, fn=lambda: ac.loads_total)
            Gauge("kaito:adapter_evictions_total",
                  "Adapters evicted or deleted from the slot table", r,
                  fn=lambda: ac.evictions_total)
            Gauge("kaito:adapter_hits_total",
                  "Submissions that found their adapter resident", r,
                  fn=lambda: ac.hits_total)
            Gauge("kaito:adapter_faults_total",
                  "Submissions that faulted their adapter back in from the "
                  "host tier", r, fn=lambda: ac.faults_total)
            Gauge("kaito:adapter_host_entries",
                  "Adapters parked in the host-RAM overflow tier", r,
                  fn=lambda: len(ac.host) if ac.host is not None else 0)
            Gauge("kaito:adapter_host_bytes_used",
                  "Bytes held by the host-RAM adapter tier", r,
                  fn=lambda: ac.host.used_bytes if ac.host is not None else 0)
        failures = getattr(engine, "adapter_load_failures", None)
        if getattr(engine, "adapter_cache", None) is not None or failures:
            # refusals by reason: with the cache on, or on the boot path
            # once a refusal was counted
            Gauge("kaito:adapter_load_failures_total",
                  "Adapter loads refused, by reason", r, labels=("reason",),
                  fn=lambda: {(k,): float(v) for k, v in (failures or {}).items()})
        for name, help_, key in (
                ("pd_device_handoffs_total",
                 "Colocated device-to-device KV hand-offs",
                 "pd_device_handoffs_total"),
                ("requests_failed_total",
                 "Requests that died request-scoped (structured error)",
                 "requests_failed_total"),
                ("requests_expired_total",
                 "Requests aborted at their deadline (408)",
                 "requests_expired_total"),
                ("kv_import_retries_total",
                 "Transient KV-transfer failures retried as local recompute",
                 "kv_import_retries_total"),
                ("engine_fatal_total",
                 "Engine-fatal failures (every in-flight request failed)",
                 "engine_fatal_total")):
            Gauge(f"kaito:{name}", help_, r, fn=_counter_fn(engine, key))
        # speculative decoding: the proposer-mode label splits the n-gram
        # and draft-model paths (accept rate per mode is a direct ratio);
        # the depth is the controller's mean over active slots
        def per_mode(ngram: str, draft: str):
            return lambda: {("ngram",): engine.counters.get(ngram, 0),
                            ("draft",): engine.counters.get(draft, 0)}

        Gauge("kaito:spec_proposed_tokens_total", "Speculative tokens proposed", r,
              labels=("mode",), fn=per_mode("spec_proposed_tokens_total",
                                            "spec_draft_proposed_tokens_total"))
        Gauge("kaito:spec_accepted_tokens_total",
              "Speculative tokens accepted by the target", r, labels=("mode",),
              fn=per_mode("spec_accepted_tokens_total",
                          "spec_draft_accepted_tokens_total"))
        Gauge("kaito:spec_depth",
              "Mean adaptive speculation depth over active slots", r,
              fn=lambda: engine.spec_depth)
        # structured output: the collector itself gates on the first
        # constrained request
        r.register(_GrammarCollector(engine))
        # the P/D cost model's live constants: 0 until the first observed
        # transfer / prefill provides a sample
        Gauge("kaito:pd_measured_net_bytes_s",
              "EWMA observed KV transfer bandwidth", r,
              fn=lambda: engine.pd_costs.snapshot()["net_bytes_s"] or 0)
        Gauge("kaito:pd_measured_prefill_tok_s",
              "EWMA observed prefill throughput", r,
              fn=lambda: engine.pd_costs.snapshot()["prefill_tok_s"] or 0)

    def observe_request(self, req) -> None:
        if req.first_token_time:
            self.ttft.observe(req.first_token_time - req.submit_time)
        if req.finish_time:
            self.e2e_latency.observe(req.finish_time - req.submit_time)
            n_out = len(req.output_tokens)
            if req.first_token_time and n_out > 1:
                self.tpot.observe(
                    (req.finish_time - req.first_token_time) / (n_out - 1))
            self.request_success.inc(finished_reason=req.finish_reason or "stop")
            if self.tenant_served is not None and req.tenant:
                self.tenant_served.inc(tenant=req.tenant)
        self.prompt_tokens.inc(len(req.prompt_tokens))
        self.generation_tokens.inc(len(req.output_tokens))
