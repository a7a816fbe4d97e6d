"""OpenAI-compatible HTTP server for the PyTorch engine.

Counterpart of the serving surface of ``kaito_tpu.engine.server``:
``/health``, ``/v1/models``, ``/v1/completions`` and
``/v1/chat/completions`` with ``"stream": true`` server-sent events, in
the same request and response shapes (``ignore_eos`` and the other vLLM
extra parameters included; ``stream_options.include_usage`` adds a
final usage chunk to a stream), and the observability surface:
``/metrics`` (the ``kaito:*`` families: the engine's, the rate
limiter's and the SLO watchdog's), ``/debug/trace`` (``?trace_id=``),
``/debug/timeline``, ``/debug/slo`` and ``/debug/flight`` (403 without
``--flight-dir``).  A client's ``X-Request-Id`` (or the trace id of a
W3C ``traceparent``) names the request's trace and is echoed on every
response, stream and error body.  429s come from the rate limiter:
queue depth, and with ``--kv-shed-threshold`` KV-page pressure.

Multi-tenant QoS (``--qos-config``): the ``X-Kaito-Tenant`` and
``X-Kaito-Priority`` headers (the body's ``tenant`` and ``priority``
as fallback) name a request's tenant and class; the limiter sheds the
tenant over its queue or token budget, and ``/metrics`` and
``/debug/slo`` gain per-tenant series.  A body's ``timeout`` (else
``--request-timeout-s``) is the request's deadline, past which it
answers 408.  ``--itl`` records every inter-token gap
(``kaito:inter_token_latency_seconds``, the watchdog's ``itl_p99``).
``n`` (1-16, not streamed) submits one engine request a choice, and
``echo`` with ``max_tokens: 0`` and ``logprobs`` scores the prompt.
Stdlib HTTP only: the engine thread does the work (prompt scoring
included), handler threads stream its queues.

Structured output: ``response_format`` (``json_object``,
``json_schema``, ``regex``) and a forced ``tool_choice`` (``required``
or a named function) compile on the request thread into a grammar the
engine masks decoding with; a structural mistake answers 400, a schema
the compiler rejects 422 ``invalid_grammar_error``, and either under
``--no-structured-output`` 400 ``structured_output_disabled``.  ``tools``
are rendered into the system message in the preset's wire format;
forced calls come back as ``tool_calls`` (streamed as argument deltas
while they decode), ``auto`` parses the reply for calls.  Every
non-streaming chat reply goes through ``parsers.parse_message``, which
splits a leading ``<think>`` block into ``reasoning_content`` on presets
with a reasoning parser.  The ``kaito:grammar_*`` families appear on
``/metrics`` with the first constrained request.

Multi-LoRA: a request's ``model`` field names its adapter (else the QoS
document's tenant -> adapter map does; a mapped adapter that is not
loaded answers 503 ``adapter_unavailable``), ``/v1/models`` lists the
adapters, and with ``--adapter-slots`` ``/v1/adapters`` hot-loads
(``POST {"name", "source"}``), lists (``GET``) and drops (``DELETE
/v1/adapters/<name>``) them: 403 with the cache off, 400 for a bad name
or source, 403 for a remote source outside
``--adapter-source-allowlist``, 409 while in-flight work pins it, 422
for a refused load, 404 for an unknown name.  Sources are local
directories (``path://`` or a bare path) and ``oras://`` pulls; a
``hub://`` pull needs the hub fetcher, which is not ported yet.

Device profiling: with ``--devprof-interval-s`` > 0 the engine samples
a ``--devprof-window-s`` torch.profiler window at that cadence;
``/debug/device`` answers its snapshot (the last window's buckets and
phases and the ring of recent windows; 403 with sampling off) and the
``kaito:device_*`` families appear on ``/metrics``.  ``/start_profile``
(optional body ``{"seconds": N}``: stop after N seconds) and
``/stop_profile`` take a trace on the engine thread and write it as a
chrome trace under ``KAITO_PROFILE_DIR``; a second start, or a stop with
none running, answers 409.  The host KV tier takes
``--kaito-kv-cache-cpu-memory-utilization`` (``KAITO_KV_CPU_MEM_UTIL``):
the fraction of the host's RAM that preempted sequences spill to.

P/D disaggregation (``--pd-enabled``, else 403): ``POST /pd/prefill``
runs a prompt on the prefill role and stages its KV; the decode role
pulls it with ``kv_transfer`` in a completion body (``source_url``,
``req_id``, ``prompt_tokens``, ``first_token``; ``"wire": "http"``
forces the chunked wire, ``force`` skips the break-even): from an engine
served in this process a device-to-device copy, else the chunked wire
(``/pd/kv/<id>/meta``, ``/pd/kv/<id>/chunk/<i>``, ``DELETE /pd/kv/<id>``;
``/pd/kv/<id>`` the whole slab).  ``--pd-source-allowlist`` bounds where
KV may come from (403); an adapter mismatch answers 409.  The cluster KV
pool (``--kv-pool``, else 403): ``/debug/kv_pool`` advertises the
published prefixes, ``/kv_pool/<key>/meta`` and ``/chunk/<i>`` serve
them, and a completion carrying ``X-Kaito-KV-Fetch`` /
``X-Kaito-KV-Fetch-Key`` fetches its prefix from that peer; with
``--kv-pool-disk-bytes`` a completion first probes this replica's host
store and slab directory.  ``/ui`` answers 501.

Run: ``python -m kaito_tpu_torch.engine.server --model
llama-3.1-8b-instruct`` (on the card; ``--device cpu`` for the CPU).
``--async-dispatch`` turns on the two-deep decode pipeline.
``--tensor-parallel-size N`` shards the model over the first N cards
(``--comm-overlap`` adds the pipelined decode ring); a mesh that puts
several shards on one device is built in Python
(``kaito_tpu_torch.parallel.mesh.build_mesh``) and its engine handed to
:func:`make_server`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from kaito_tpu_torch.device import resolve_device
from kaito_tpu_torch.engine.adapter_cache import AdapterBusyError, AdapterLoadError
from kaito_tpu_torch.engine.adapters import discover_adapters
from kaito_tpu_torch.engine.chat import render_chat
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.devprof import ManualTrace
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.kv_pool import (common_prefix_pages, pool_block_chars,
                                            pool_key, prompt_pool_blocks)
from kaito_tpu_torch.engine.pd import (ChunkPlan, pack_transfer, should_import_from_disk,
                                      should_transfer)
from kaito_tpu_torch.engine.grammar import (GrammarError, GrammarSpec, canonical_schema,
                                            spec_from_response_format,
                                            tool_envelope_schema)
from kaito_tpu_torch.engine.metrics import EngineMetrics, Gauge
from kaito_tpu_torch.engine.parsers import (StreamingToolCallParser,
                                            parse_forced_tool_call, parse_message,
                                            render_tools_prompt, tool_call_deltas)
from kaito_tpu_torch.engine.qos import valid_tenant
from kaito_tpu_torch.engine.rate_limit import RateLimiter
from kaito_tpu_torch.models.registry import get_model_by_name, resolve_speculative_draft
from kaito_tpu_torch.runtime.routing import extract_prompt_text
from kaito_tpu_torch.runtime.slo import SLOTargets, SLOWatchdog, engine_chip_count
from kaito_tpu_torch.utils.tracing import (chrome_trace, make_request_id,
                                           parse_traceparent, sanitize_request_id)

logger = logging.getLogger(__name__)

# routes of the JAX server that later slices port (ROADMAP queue 1)
_UNPORTED_GET = ("/ui",)

# the 429's message for each shed reason of RateLimiter.shed_reason
_SHED_MESSAGES = {
    "queue_full": "engine queue full, retry later",
    "tenant_queue_full": "tenant queue budget exhausted, retry later",
    "tenant_rate": "tenant token budget exhausted, retry later",
    "kv_pressure": "KV page pool saturated, retry later",
}
# most choices one request may ask for
_MAX_CHOICES = 16


def token_surface_forms(tokenizer, ids, window: int = 8) -> list:
    """Per-token surface strings by a bounded-window incremental decode:
    a few tokens of left context make byte merges and multi-byte
    codepoints decode as they do in the whole text."""
    out = []
    ids = list(ids)
    for i in range(len(ids)):
        lo = max(0, i - window)
        prev = tokenizer.decode(ids[lo:i]) if i > lo else ""
        cur = tokenizer.decode(ids[lo:i + 1])
        out.append(cur[len(prev):])
    return out


class ServerState:
    """What the handlers share: the engine, one metrics registry holding
    the engine's, the rate limiter's and the SLO watchdog's families,
    the flight recorder (with ``cfg.flight_dir`` only) and the manual
    profiler trace."""

    def __init__(self, engine: InferenceEngine, cfg: EngineConfig):
        self.engine = engine
        self.cfg = cfg
        self.model_name = cfg.served_model_name or engine.md.name
        # the boot directory's adapters (the /v1/models listing without
        # the cache, and the names a merged engine still accepts)
        self.adapters = discover_adapters(cfg.adapters_dir)
        # multi-tenant QoS: the engine parsed the config; the limiter,
        # metrics and SLO watchdog share it
        self.qos = engine.qos
        self.metrics = EngineMetrics(engine, qos=self.qos)
        self.limiter = RateLimiter(cfg.max_queue_len, cfg.disable_rate_limit,
                                   kv_shed_threshold=cfg.kv_shed_threshold,
                                   qos=self.qos)
        self.metrics.registry.register(self.limiter.probe_errors)
        # north-star SLO watchdog: config targets, KAITO_SLO_* on top
        self.slo = SLOWatchdog(
            targets=SLOTargets.from_env(SLOTargets(
                ttft_p50_s=cfg.slo_ttft_p50_ms / 1000.0,
                ttft_p99_s=cfg.slo_ttft_p99_ms / 1000.0,
                itl_p99_s=cfg.slo_itl_p99_ms / 1000.0,
                tokens_per_sec_per_chip=cfg.slo_tokens_per_sec_per_chip,
                availability=cfg.slo_availability)),
            chips=engine_chip_count(engine),
            per_tenant=self.qos is not None,
            itl_enabled=engine.itl_hist is not None,
            role=cfg.role or os.environ.get("KAITO_INFERENCE_ROLE", ""))
        self.slo.register_metrics(self.metrics.registry)
        # the engine's ITL stamps feed the watchdog's windows (gap, tenant)
        if engine.itl_hist is not None:
            engine.itl_observer = self.slo.observe_itl
        # incident flight recorder: only with a flight_dir — no dir means
        # no recorder, no watcher thread, no kaito:flight_bundles_total
        # family, and /debug/flight answers 403
        self.flight = None
        self.flight_watcher = None
        if cfg.flight_dir:
            from kaito_tpu_torch.utils.flightrec import (FlightRecorder,
                                                         FlightWatcher,
                                                         engine_flight_snapshot)

            self.flight = FlightRecorder(
                cfg.flight_dir,
                collect=lambda: engine_flight_snapshot(engine, slo=self.slo,
                                                       cfg=cfg),
                max_bundles=cfg.flight_max_bundles)
            self.flight_watcher = FlightWatcher(
                self.flight, slo_snapshot=self.slo.snapshot,
                fatal_count=lambda: int(engine.counters["engine_fatal_total"]))
            self.flight_watcher.start()
            Gauge("kaito:flight_bundles_total",
                  "Flight-recorder bundles written since process start",
                  self.metrics.registry,
                  fn=lambda: float(self.flight.bundles_total))
        # /start_profile's trace, taken on the engine thread; the lock
        # orders the routes' starts and stops with the auto-stop timer
        self.trace = ManualTrace(engine._on_engine_thread,
                                 cuda=engine.device.type == "cuda")
        self.profile_lock = threading.Lock()
        self.profile_timer: Optional[threading.Timer] = None

    def observe(self, req) -> None:
        """A finished request's latencies and tokens, into the metrics
        and the SLO watchdog."""
        self.metrics.observe_request(req)
        self.slo.observe_request(req)

    def note_tokens(self, reqs) -> None:
        """Post-paid token budgets: debit each request's prompt and
        generated tokens to its tenant."""
        for r in reqs:
            self.limiter.note_tokens(r.tenant,
                                     len(r.prompt_tokens) + len(r.output_tokens))

    def close(self) -> None:
        if self.flight_watcher is not None:
            self.flight_watcher.stop()
        # a pending /start_profile auto-stop must not fire into a
        # torn-down engine
        timer, self.profile_timer = self.profile_timer, None
        if timer is not None:
            timer.cancel()

    def stop_profile(self) -> str:
        """Stop the manual trace (the lock held) and write it; returns
        the file's path."""
        timer, self.profile_timer = self.profile_timer, None
        if timer is not None:
            timer.cancel()
        return self.trace.stop(profile_dir())

    def auto_stop_profile(self) -> None:
        """Timer target for ``/start_profile {"seconds": N}``: stop the
        trace unless a manual ``/stop_profile`` already did."""
        with self.profile_lock:
            if not self.trace.active:
                return
            try:
                logger.info("profiler trace auto-stopped -> %s", self.stop_profile())
            except Exception:
                logger.exception("profiler auto-stop failed")


def profile_dir() -> str:
    """Where ``/stop_profile`` writes its trace: ``KAITO_PROFILE_DIR``,
    else ``kaito-profile`` in the temporary directory."""
    return os.environ.get("KAITO_PROFILE_DIR",
                          os.path.join(tempfile.gettempdir(), "kaito-profile"))


class OpenAIHandler(BaseHTTPRequestHandler):
    state: ServerState  # injected via make_server
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug("%s " + fmt, self.address_string(), *args)

    # ---------------- helpers ----------------

    def _intake_trace(self):
        """This request's end-to-end trace id: the client's
        ``X-Request-Id`` wins, then the trace id of an inbound W3C
        ``traceparent``, else a fresh id.  Every response echoes it."""
        client = (sanitize_request_id(self.headers.get("X-Request-Id"))
                  or parse_traceparent(self.headers.get("traceparent")))
        # a P/D decode role adopts the prefill's trace id unless the
        # client named one
        self._rid_client = bool(client)
        self._rid = client or make_request_id()

    def _send(self, code: int, ctype: str, body: bytes,
              headers: Optional[dict] = None):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("X-Request-Id", self._rid)
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj: dict, headers: Optional[dict] = None):
        self._send(code, "application/json", json.dumps(obj).encode(), headers)

    def _error(self, code: int, message: str,
               etype: str = "invalid_request_error",
               headers: Optional[dict] = None):
        self._json(code, {"error": {"message": message, "type": etype,
                                    "request_id": self._rid}}, headers)

    def _request_error(self, req) -> None:
        """Answer with a request's structured engine error: a failure
        (5xx) or a deadline (408)."""
        err = req.error or {"status": 500, "type": "internal_error",
                            "message": "request failed in the engine"}
        self._error(int(err.get("status", 500)), err.get("message", "request failed"),
                    err.get("type", "internal_error"))

    def _intake_tenant(self, body: dict) -> Optional[tuple[str, str]]:
        """This request's (tenant id, priority-class name): the
        ``X-Kaito-Tenant`` / ``X-Kaito-Priority`` headers, the body's
        ``tenant`` / ``priority`` as fallback.  Sends a 400 and returns
        None for an invalid tenant id or, under QoS, an unknown class."""
        tenant = str(self.headers.get("X-Kaito-Tenant") or body.get("tenant") or "").strip()
        priority = str(self.headers.get("X-Kaito-Priority")
                       or body.get("priority") or "").strip()
        if tenant and not valid_tenant(tenant):
            self._error(400, "invalid tenant id (label-safe, max 64 chars)")
            return None
        qos = self.state.qos
        if priority and qos is not None and priority not in qos.classes:
            self._error(400, f"unknown priority class {priority!r}")
            return None
        return tenant, priority

    def _shed(self, shed: dict) -> None:
        """Answer 429 for a shed decision of the rate limiter and count it
        (per tenant with QoS)."""
        st = self.state
        reason, tenant = shed["reason"], shed["tenant"]
        st.metrics.requests_rejected.inc()
        st.metrics.requests_shed.inc(reason=reason)
        if st.metrics.tenant_shed is not None:
            st.metrics.tenant_shed.inc(tenant=tenant or "default")
        st.slo.note_shed(tenant=tenant)
        st.engine.counters["requests_shed_total"] += 1
        self._error(429, _SHED_MESSAGES.get(reason, "over capacity"),
                    "rate_limit_error", headers={
                        "Retry-After": st.limiter.retry_after_s(st.engine,
                                                                key=self._rid)})

    def _not_ported(self):
        self._error(501, f"{self.path} is not implemented by the PyTorch "
                         f"engine yet", "not_implemented")

    def _read_body(self) -> Optional[dict]:
        try:
            n = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(n) if n else b"{}")
        except (ValueError, json.JSONDecodeError):
            self._error(400, "invalid JSON body")
            return None
        if not isinstance(body, dict):
            self._error(400, "JSON body must be an object")
            return None
        return body

    def _sse_start(self):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("X-Request-Id", self._rid)
        self.end_headers()

    def _sse_send(self, obj) -> None:
        data = b"data: " + json.dumps(obj).encode() + b"\n\n"
        self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))

    def _sse_end(self):
        data = b"data: [DONE]\n\n"
        self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
        self.wfile.write(b"0\r\n\r\n")

    # ---------------- routes ----------------

    def do_GET(self):
        st = self.state
        self._intake_trace()
        if self.path == "/health":
            body = {"status": "ok", "device": str(st.engine.device)}
            if st.engine.sizing_report:
                body["kv_sizing"] = st.engine.sizing_report
            self._json(200, body)
        elif self.path == "/v1/models":
            models = [{"id": st.model_name, "object": "model",
                       "owned_by": "kaito-tpu", "root": st.model_name}]
            # with the cache, the adapters resident or parked now
            snap = st.engine.adapter_snapshot()
            names = (sorted({e["name"] for e in snap["resident"]}
                            | set(snap["host_tier"]))
                     if snap is not None else list(st.adapters))
            models += [{"id": name, "object": "model", "owned_by": "kaito-tpu",
                        "parent": st.model_name} for name in names]
            self._json(200, {"object": "list", "data": models})
        elif self.path == "/v1/adapters":
            self._adapters_get()
        elif self.path == "/metrics":
            self._send(200, "text/plain; version=0.0.4",
                       st.metrics.registry.expose().encode())
        elif self.path.startswith(_UNPORTED_GET):
            self._not_ported()
        elif self.path.startswith("/pd/kv/"):
            rest = self.path[len("/pd/kv/"):]
            if rest.endswith("/meta"):
                self._pd_kv_meta(rest[:-len("/meta")])
            elif "/chunk/" in rest:
                rid, _, idx = rest.partition("/chunk/")
                self._pd_kv_chunk(rid, idx)
            else:
                self._pd_kv(rest)
        elif self.path == "/debug/kv_pool":
            self._kv_pool_advert()
        elif self.path.startswith("/kv_pool/"):
            rest = self.path[len("/kv_pool/"):]
            if rest.endswith("/meta"):
                self._kv_pool_meta(rest[:-len("/meta")])
            elif "/chunk/" in rest:
                key, _, idx = rest.partition("/chunk/")
                self._kv_pool_chunk(key, idx)
            else:
                self._error(404, f"no route {self.path}")
        elif self.path.startswith("/debug/device"):
            self._debug_device()
        elif self.path.startswith("/debug/trace"):
            # ?trace_id= filters to one request's span tree;
            # metadata.dropped counts ring-overflow evictions
            q = parse_qs(urlparse(self.path).query)
            tracer = st.engine.tracer
            self._json(200, chrome_trace(tracer.spans(q.get("trace_id", [None])[0]),
                                         dropped=tracer.dropped))
        elif self.path.startswith("/debug/timeline"):
            self._json(200, st.engine.timeline.chrome_trace())
        elif self.path.startswith("/debug/slo"):
            self._json(200, st.slo.snapshot())
        elif self.path.startswith("/debug/flight"):
            self._flight_get()
        else:
            self._error(404, f"no route {self.path}")

    def do_POST(self):
        self._intake_trace()
        if self.path == "/v1/completions":
            self._completions(chat=False)
        elif self.path == "/v1/chat/completions":
            self._completions(chat=True)
        elif self.path == "/pd/prefill":
            self._pd_prefill()
        elif self.path == "/v1/adapters":
            self._adapters_post()
        elif self.path == "/start_profile":
            self._profile(start=True)
        elif self.path == "/stop_profile":
            self._profile(start=False)
        elif self.path.startswith("/debug/flight"):
            self._flight_post()
        else:
            self._error(404, f"no route {self.path}")

    def do_DELETE(self):
        self._intake_trace()
        if self.path.startswith("/pd/kv/"):
            # the decode role declined the transfer (below break-even):
            # release the staged export instead of waiting out its TTL
            if not self._pd_enabled():
                return self._error(403, "P/D disaggregation disabled on this pod")
            gone = self.state.engine.kv_exports.pop(self.path[len("/pd/kv/"):])
            self._json(200 if gone is not None else 404, {"released": gone is not None})
        elif self.path.startswith("/v1/adapters/"):
            self._adapters_delete(self.path[len("/v1/adapters/"):])
        else:
            self._error(404, f"no route {self.path}")

    # ---------------- device profiling ----------------

    def _debug_device(self):
        """The sampling profiler's snapshot: the last window's device
        time by bucket and phase, and the ring.  403 when sampling is
        off, so the devprof-off surface stays as it was."""
        dp = self.state.engine.devprof
        if dp is None:
            return self._error(403, "device profiler disabled (--devprof-interval-s)")
        self._json(200, dp.snapshot())

    def _profile(self, start: bool):
        """``/start_profile`` and ``/stop_profile``: a torch.profiler trace
        taken on the engine thread, written under ``KAITO_PROFILE_DIR``.
        A start with ``{"seconds": N}`` stops itself after N seconds."""
        st = self.state
        # the body is optional JSON; always consume it (an unread
        # payload would desync the next request on keep-alive)
        n = int(self.headers.get("Content-Length", "0") or 0)
        raw = self.rfile.read(n) if n else b""
        seconds = 0.0
        if start and raw:
            try:
                seconds = float((json.loads(raw) or {}).get("seconds", 0))
            except (ValueError, json.JSONDecodeError, AttributeError, TypeError):
                return self._error(400, "invalid JSON body")
            if seconds < 0:
                return self._error(400, "'seconds' must be >= 0")
        prof_dir = profile_dir()
        with st.profile_lock:
            try:
                if start:
                    if st.trace.active:
                        return self._error(409, "profiler already running")
                    st.trace.start()
                    body = {"status": "started", "dir": prof_dir}
                    if seconds:
                        # a fire-and-forget client cannot leave the
                        # process-wide profiler running forever
                        timer = threading.Timer(seconds, st.auto_stop_profile)
                        timer.daemon = True
                        st.profile_timer = timer
                        timer.start()
                        body["auto_stop_seconds"] = seconds
                        body["auto_stop_deadline"] = time.time() + seconds
                    logger.info("profiler trace started -> %s%s", prof_dir,
                                f" (auto-stop in {seconds:g}s)" if seconds else "")
                    return self._json(200, body)
                if not st.trace.active:
                    return self._error(409, "profiler not running")
                path = st.stop_profile()
                logger.info("profiler trace stopped -> %s", path)
                return self._json(200, {"status": "stopped", "dir": prof_dir,
                                        "file": path})
            except Exception as e:
                return self._error(500, f"profiler error: {e}", "internal_error")

    # ---------------- multi-LoRA admin ----------------

    def _adapters_get(self):
        """The cache's snapshot; 403 with the cache off."""
        snap = self.state.engine.adapter_snapshot()
        if snap is None:
            return self._error(403, "adapter cache disabled on this pod")
        self._json(200, snap)

    def _resolve_adapter_source(self, source: str) -> str:
        """A POST /v1/adapters source as a local artifact directory.
        ``path://`` (or a bare path) is operator-local trust; a remote
        pull (``hub://``, ``oras://``) needs a ``--adapter-source-allowlist``
        prefix ("" = local paths only).  ValueError: malformed (400);
        PermissionError: not allowlisted (403); RuntimeError: the pull
        failed (502)."""
        import shutil
        import subprocess
        import tempfile

        if source.startswith("path://"):
            source = source[len("path://"):]
        if "://" not in source:
            if not os.path.isdir(source):
                raise ValueError(f"adapter path {source!r} is not a directory")
            return source
        scheme = source.split("://", 1)[0]
        if scheme not in ("hub", "oras"):
            raise ValueError(f"unsupported adapter source scheme {scheme!r} "
                             f"(path://, hub://, oras://)")
        allow = [p for p in self.state.cfg.adapter_source_allowlist.split(",") if p]
        if not any(source.startswith(pref) for pref in allow):
            raise PermissionError(f"adapter source {source!r} not in "
                                  f"--adapter-source-allowlist")
        if scheme == "hub":
            raise RuntimeError(
                f"adapter pull from {source} failed: hub:// pulls need the hub "
                f"fetcher (kaito_tpu/runtime/weight_fetch.py), not ported yet "
                f"(ROADMAP queue 1, M23)")
        dest = tempfile.mkdtemp(prefix="kaito-adapter-")
        try:
            subprocess.run(["oras", "pull", source[len("oras://"):], "-o", dest],
                           check=True, capture_output=True, timeout=600)
        except Exception as e:
            shutil.rmtree(dest, ignore_errors=True)
            raise RuntimeError(f"adapter pull from {source} failed: {e}") from None
        return dest

    def _adapters_post(self):
        """Hot-load an adapter into the slot table: its lane is written in
        place, no graph is captured again."""
        st = self.state
        if st.engine.adapter_cache is None:
            return self._error(403, "adapter cache disabled on this pod")
        body = self._read_body()
        if body is None:
            return
        name = str(body.get("name") or "").strip()
        source = str(body.get("source") or "").strip()
        if not name or not source:
            return self._error(400, "'name' and 'source' are required")
        if not valid_tenant(name):
            return self._error(400, "adapter name must be label-safe (max 64 chars)")
        try:
            path = self._resolve_adapter_source(source)
        except PermissionError as e:
            return self._error(403, str(e))
        except ValueError as e:
            return self._error(400, str(e))
        except RuntimeError as e:
            return self._error(502, str(e))
        try:
            slot = st.engine.load_adapter_dynamic(name, path)
        except AdapterBusyError as e:
            return self._error(409, str(e))
        except AdapterLoadError as e:
            return self._error(422, str(e), "adapter_load_error")
        except ValueError as e:
            return self._error(400, str(e))
        self._json(200, {"loaded": name, "slot": slot})

    def _adapters_delete(self, name: str):
        """Drop an adapter from both tiers: 409 while in-flight work pins
        it, 404 when the cache holds no trace of it."""
        from urllib.parse import unquote

        st = self.state
        if st.engine.adapter_cache is None:
            return self._error(403, "adapter cache disabled on this pod")
        name = unquote(name).strip()
        try:
            gone = st.engine.delete_adapter(name)
        except AdapterBusyError as e:
            return self._error(409, str(e))
        if not gone:
            return self._error(404, f"no adapter {name!r}")
        self._json(200, {"deleted": name})

    def _request_adapter(self, model_field: str, tenant: str):
        """The adapter a completion runs: the ``model`` field's, else the
        tenant's under QoS ("" the base).  Returns (adapter, None) or
        (None, (status, message, type)) for the error to answer."""
        st = self.state
        eng = st.engine
        cache = eng.adapter_cache
        adapter = ""
        if model_field and model_field not in (st.model_name, eng.md.name):
            if model_field in eng.adapter_index or (cache is not None
                                                    and cache.has(model_field)):
                adapter = model_field
            elif not (eng.adapters_merged and model_field in st.adapters):
                return None, (404, f"model {model_field!r} not found",
                              "invalid_request_error")
        if not adapter and tenant and st.qos is not None:
            adapter = st.qos.adapter_of(tenant)
            if adapter and not (adapter in eng.adapter_index
                                or (cache is not None and cache.has(adapter))):
                return None, (503, f"tenant adapter {adapter!r} is not loaded on "
                                   f"this replica", "adapter_unavailable")
        return adapter, None

    def _flight_get(self):
        """List the flight bundles at ``/debug/flight``, fetch one at
        ``/debug/flight/<name>``; 403 without a flight directory."""
        rec = self.state.flight
        if rec is None:
            return self._error(403, "flight recorder disabled (--flight-dir)")
        rest = self.path[len("/debug/flight"):].strip("/")
        if not rest:
            return self._json(200, {"dir": rec.dir,
                                    "bundles_total": rec.bundles_total,
                                    "bundles": rec.list()})
        raw = rec.read(rest)
        if raw is None:
            return self._error(404, f"no bundle {rest!r}")
        self._send(200, "application/json", raw)

    def _flight_post(self):
        """Snapshot every debug surface into a bundle now."""
        from kaito_tpu_torch.utils.flightrec import TRIGGER_MANUAL

        rec = self.state.flight
        if rec is None:
            return self._error(403, "flight recorder disabled (--flight-dir)")
        name = rec.record(TRIGGER_MANUAL, reason="POST /debug/flight")
        if name is None:
            return self._error(500, "flight bundle write failed")
        self._json(200, {"bundle": name})

    # ---------------- P/D disaggregation ----------------

    def _pd_enabled(self) -> bool:
        return bool(self.state.cfg.pd_enabled)

    def _pd_prefill(self):
        """Prefill-role entry: run the prompt, stage its KV for the pull,
        answer the first sampled token.  The ``model`` field selects an
        adapter as on /v1/completions; the staged meta records it."""
        if not self._pd_enabled():
            return self._error(403, "P/D disaggregation disabled on this pod")
        st = self.state
        body = self._read_body()
        if body is None:
            return
        prompt = body.get("prompt", "")
        if not isinstance(prompt, str) or not prompt:
            return self._error(400, "'prompt' must be a non-empty string")
        adapter, err = self._request_adapter(body.get("model") or "", "")
        if err is not None:
            return self._error(*err)
        tokens = st.engine.tokenizer.encode(prompt)
        try:
            params = SamplingParams(
                max_tokens=1, temperature=float(body.get("temperature", 1.0)),
                top_k=int(body.get("top_k", 0) or 0),
                top_p=float(body.get("top_p", 1.0)),
                seed=int(body.get("seed", 0) or 0), ignore_eos=True)
            req = st.engine.submit(tokens, params, req_id=f"pd-{uuid.uuid4().hex[:16]}",
                                   export_kv=True, adapter=adapter, trace_id=self._rid)
        except (TypeError, ValueError) as e:
            return self._error(400, str(e))
        toks = list(req.stream())
        if not toks and req.finish_reason in ("error", "deadline"):
            return self._request_error(req)
        self._json(200, {"req_id": req.req_id, "request_id": self._rid,
                         "first_token": req.output_tokens[0],
                         "n_tokens": len(tokens), "prompt_tokens": tokens})

    def _pd_kv(self, req_id: str):
        """The whole slab in one body (small transfers); the chunked
        endpoints below are the serving path.  The pop is the claim; on a
        failure the export is put back for the retry (its blob is cached,
        so the retry reads the same bytes)."""
        if not self._pd_enabled():
            return self._error(403, "P/D disaggregation disabled on this pod")
        reg = self.state.engine.kv_exports
        exp = reg.pop(req_id)
        if exp is None:
            return self._error(404, f"no staged KV for {req_id}")
        try:
            blob = pack_transfer(exp.meta, exp.whole_blob())
        except Exception as e:
            reg.put(req_id, exp)
            return self._error(500, f"KV export drain failed: {e}")
        try:
            self._send(200, "application/octet-stream", blob)
        except OSError:
            reg.put(req_id, exp)
            raise

    def _pd_kv_meta(self, req_id: str):
        """The chunk-plan handshake: the meta, nothing consumed.  A remote
        puller is here, so the (lazy) drain starts now."""
        if not self._pd_enabled():
            return self._error(403, "P/D disaggregation disabled on this pod")
        exp = self.state.engine.kv_exports.get(req_id)
        if exp is None:
            return self._error(404, f"no staged KV for {req_id}")
        exp.ensure_draining()
        self._json(200, {"meta": exp.meta, "n_chunks": exp.n_chunks})

    def _pd_kv_chunk(self, req_id: str, idx: str):
        """Pull ONE chunk, waiting for the drain to land it; a chunk is
        consumed by its read (a second pull answers 410) and the export
        drops once every chunk is served."""
        if not self._pd_enabled():
            return self._error(403, "P/D disaggregation disabled on this pod")
        reg = self.state.engine.kv_exports
        exp = reg.get(req_id)
        if exp is None:
            return self._error(404, f"no staged KV for {req_id}")
        try:
            data = exp.get_chunk(int(idx))
        except (IndexError, ValueError) as e:
            return self._error(400, str(e))
        except KeyError as e:
            return self._error(410, str(e))
        except Exception as e:
            return self._error(500, f"chunk read failed: {e}")
        try:
            self._send(200, "application/octet-stream", data)
        except OSError:
            # the client vanished mid-write: un-consume for its retry
            exp.restage_chunk(int(idx), data)
            reg.put(req_id, exp)
            raise
        reg.drop_served(req_id)

    def _adopt_handoff_trace(self, meta: dict) -> None:
        """The decode role adopts the trace id the prefill role stamped
        into the staged meta when the client sent none: both roles' spans
        land under ONE id."""
        if not self._rid_client and meta.get("trace_id"):
            self._rid = str(meta["trace_id"])

    def _allowed_source(self, url: str) -> bool:
        allow = [p for p in self.state.cfg.pd_source_allowlist.split(",") if p]
        return not allow or any(url.startswith(pref) for pref in allow)

    def _submit_with_transfer(self, kv_src: dict, params, req_id: str, *,
                              timeout_s: float = 0.0, tenant: str = "",
                              priority: str = "", adapter: str = ""):
        """Continue decoding from a prefill role's staged KV: from an
        engine served in this process, one device-to-device copy; else
        the chunked wire (a handshake, then a puller thread feeding the
        engine while it admits the request).  A greedy request below the
        transfer-vs-recompute break-even prefills locally instead (the
        export is released); ``force`` skips that test.  Only
        same-adapter KV is reused (409).  Returns the request, or None
        once an error was sent."""
        import urllib.request

        if not self._pd_enabled():
            self._error(403, "P/D disaggregation disabled on this pod")
            return None
        url = str(kv_src.get("source_url", "")).rstrip("/")
        src_id = str(kv_src.get("req_id", ""))
        if not url or not src_id:
            self._error(400, "kv_transfer needs source_url and req_id")
            return None
        if not self._allowed_source(url):
            self._error(403, f"kv_transfer source {url!r} not in allowlist")
            return None
        prompt_tokens = list(kv_src.get("prompt_tokens") or [])
        first = int(kv_src.get("first_token", 0))
        eng = self.state.engine
        qos = dict(timeout_s=timeout_s, tenant=tenant, priority=priority)
        if kv_src.get("wire", "auto") != "http":
            src_eng = lookup_local_engine(url)
            staged = src_eng.kv_exports.pop(src_id) if src_eng is not None else None
            if staged is not None:
                # the prefill engine staged the true token list: a client
                # claiming other tokens must not decode over this slab
                if staged.prompt_tokens and prompt_tokens != staged.prompt_tokens:
                    src_eng.kv_exports.put(src_id, staged)
                    self._error(400, "kv_transfer prompt_tokens do not match the "
                                     "staged prefill")
                    return None
                if str(staged.meta.get("adapter") or "") != adapter:
                    src_eng.kv_exports.put(src_id, staged)
                    self._error(409, f"kv_transfer adapter mismatch: prefill ran "
                                     f"{staged.meta.get('adapter') or 'base'!r}, "
                                     f"request wants {adapter or 'base'!r}")
                    return None
                slabs = staged.device_slabs()
                if slabs is not None:
                    self._adopt_handoff_trace(staged.meta)
                    try:
                        return eng.submit_with_kv_device(
                            prompt_tokens, first, staged.meta, slabs, params,
                            req_id=req_id, trace_id=self._rid, adapter=adapter,
                            event=staged.event, **qos)
                    except ValueError:
                        # a refused submit keeps the prefill's result
                        src_eng.kv_exports.put(src_id, staged)
                        raise
                # a remote drain released the slabs: take the wire
                src_eng.kv_exports.put(src_id, staged)
        c0 = eng._shard_caches()[0]
        arch = eng.md.arch
        # an int8 pool moves fp32 page scales beside the codes
        scale_bpt = (8.0 * arch.num_layers * arch.num_kv_heads / max(1, eng.cfg.page_size)
                     if c0.k_scale is not None else 0.0)
        # recomputing re-samples the first token locally, which only a
        # greedy request reproduces
        if (not kv_src.get("force") and params.temperature == 0.0
                and not should_transfer(len(prompt_tokens), arch, c0.k.element_size(),
                                        scale_bytes_per_token=scale_bpt,
                                        measured=eng.pd_costs)):
            logger.info("kv_transfer below break-even (%d tokens); recomputing "
                        "locally", len(prompt_tokens))

            def release():
                # off the request path: an unreachable prefill pod adds no
                # timeout to a request that no longer needs it
                try:
                    urllib.request.urlopen(urllib.request.Request(
                        f"{url}/pd/kv/{src_id}", method="DELETE"), timeout=10)
                except Exception:
                    pass
            threading.Thread(target=release, daemon=True, name="pd-release").start()
            return eng.submit(prompt_tokens, params, req_id=req_id, adapter=adapter,
                              trace_id=self._rid, **qos)
        try:
            with urllib.request.urlopen(f"{url}/pd/kv/{src_id}/meta", timeout=30) as r:
                meta = json.loads(r.read())["meta"]
            plans = [ChunkPlan.from_json(c) for c in meta["chunks"]]
        except Exception as e:
            self._error(502, f"KV meta pull from {url} failed: {e}")
            return None
        if str(meta.get("adapter") or "") != adapter:
            self._error(409, f"kv_transfer adapter mismatch: prefill ran "
                             f"{meta.get('adapter') or 'base'!r}, request wants "
                             f"{adapter or 'base'!r}")
            return None
        self._adopt_handoff_trace(meta)
        req = eng.submit_with_kv_chunked(prompt_tokens, first, meta, plans, params,
                                         req_id=req_id, trace_id=self._rid,
                                         adapter=adapter, **qos)
        self._start_puller(req, [f"{url}/pd/kv/{src_id}/chunk/{i}"
                                 for i in range(len(plans))],
                           eng.pd_costs.note_transfer, "pd-chunk-puller")
        return req

    def _start_puller(self, req, urls: list, note, name: str) -> None:
        """A thread pulling ``urls`` into ``req``'s chunked import; its
        failure is transient (the engine then recomputes)."""
        import urllib.request

        eng = self.state.engine

        def pull():
            ci = req.kv_chunked
            u = ""
            try:
                t0, nbytes = time.monotonic(), 0
                for i, u in enumerate(urls):
                    with urllib.request.urlopen(u, timeout=120) as r:
                        data = r.read()
                    nbytes += len(data)
                    ci.feed(i, data)
                    eng._wake.set()
                # pure wire time, the link sample of the break-even
                note(nbytes, time.monotonic() - t0)
            except Exception as e:
                ci.set_error(f"chunk pull from {u} failed: {e}", transient=True)
                eng._wake.set()

        threading.Thread(target=pull, daemon=True, name=name).start()

    # ---------------- the cluster KV pool ----------------

    def _kv_pool_advert(self):
        """The holder advert for the router's prefix index: the store's
        keys with their per-page block-hash chains (metadata only)."""
        eng = self.state.engine
        pool = eng.kv_pool
        if pool is None:
            return self._error(403, "KV pool disabled on this pod")
        ps = eng.cfg.page_size
        cap = int(eng.cfg.kv_pool_advert_max)
        total = len(pool)
        entries = pool.advert(max_entries=cap)
        self._json(200, {"enabled": True, "page_size": ps,
                         "block_chars": pool_block_chars(ps), "total": total,
                         "capped": bool(cap and total > len(entries)),
                         "entries": entries})

    def _kv_pool_meta(self, key: str):
        """The fetch handshake: chunk plans plus the entry's exact prompt
        tokens (the fetcher imports only the common whole pages).  A
        dropped entry is a 404, which the fetcher treats as a miss."""
        pool = self.state.engine.kv_pool
        if pool is None:
            return self._error(403, "KV pool disabled on this pod")
        entry = pool.get(key)
        if entry is None:
            return self._error(404, f"no pool entry {key}")
        exp = entry.export
        exp.ensure_draining()
        self._json(200, {"meta": exp.meta, "n_chunks": exp.n_chunks,
                         "n_tokens": entry.n_tokens,
                         "prompt_tokens": list(exp.prompt_tokens)})

    def _kv_pool_chunk(self, key: str, idx: str):
        """ONE chunk of a pool entry over the P/D wire format, never
        consumed: an entry serves any number of fetches until evicted."""
        pool = self.state.engine.kv_pool
        if pool is None:
            return self._error(403, "KV pool disabled on this pod")
        entry = pool.peek(key)
        if entry is None:
            return self._error(410, f"pool entry {key} dropped")
        try:
            data = entry.export.get_chunk(int(idx), consume=False)
        except (IndexError, ValueError) as e:
            return self._error(400, str(e))
        except Exception as e:
            return self._error(500, f"chunk read failed: {e}")
        self._send(200, "application/octet-stream", data)

    def _submit_with_pool(self, tokens, params, req_id: str, pool_blocks, **qos):
        """With the pool on: this replica's host store and slab directory
        first (with the disk tier), then the peer an ``X-Kaito-KV-Fetch``
        header names; None when neither serves (a plain submit follows)."""
        req = None
        if self.state.engine.kv_tier is not None:
            req = self._submit_with_local_tier(tokens, params, req_id, pool_blocks, **qos)
        url = self.headers.get("X-Kaito-KV-Fetch", "")
        key = self.headers.get("X-Kaito-KV-Fetch-Key", "")
        if req is None and url and key:
            req = self._submit_with_pool_fetch(url, key, tokens, params, req_id,
                                               pool_blocks, **qos)
        return req

    def _submit_prefix(self, tokens, params, req_id, meta, plans, n_prefix,
                       pool_blocks, qos: dict):
        return self.state.engine.submit_with_kv_prefix(
            tokens, meta, plans, n_prefix, params, req_id=req_id, trace_id=self._rid,
            pool_blocks=pool_blocks, **qos)

    def _submit_with_pool_fetch(self, url: str, key: str, tokens, params, req_id: str,
                                pool_blocks, **qos):
        """Fetch the prompt's prefix from the peer the router named and
        prefill only the rest.  None on any ineligibility or failure:
        the pool only ever removes work."""
        import urllib.request

        eng = self.state.engine
        url = url.rstrip("/")
        # the P/D trust boundary bounds whose bytes enter the pool
        if not self._allowed_source(url):
            logger.info("kv_pool fetch source %s not in allowlist", url)
            return None
        try:
            with urllib.request.urlopen(f"{url}/kv_pool/{key}/meta", timeout=10) as r:
                hs = json.loads(r.read())
            meta = hs["meta"]
            plans = [ChunkPlan.from_json(c) for c in meta["chunks"]]
            entry_tokens = hs.get("prompt_tokens") or []
        except Exception as e:
            logger.info("kv_pool meta pull from %s failed: %s", url, e)
            return None
        ps = eng.cfg.page_size
        # the hashes indexed the entry; the tokens decide what imports
        n_pages = common_prefix_pages(tokens, entry_tokens, ps)
        if n_pages <= 0:
            return None
        n_prefix = n_pages * ps
        # the engine vetoes only when its own MEASURED rates disagree (a
        # fresh replica has none: the scale-out case the pool exists for)
        snap = eng.pd_costs.snapshot()
        if snap.get("net_bytes_s") and snap.get("prefill_tok_s"):
            c0 = eng._shard_caches()[0]
            arch = eng.md.arch
            scale_bpt = (8.0 * arch.num_layers * arch.num_kv_heads / max(1, ps)
                         if c0.k_scale is not None else 0.0)
            if not should_transfer(n_prefix, arch, c0.k.element_size(),
                                   scale_bytes_per_token=scale_bpt,
                                   measured=eng.pd_costs):
                logger.info("kv_pool fetch below measured break-even (%d tokens); "
                            "recomputing locally", n_prefix)
                return None
        try:
            req = self._submit_prefix(tokens, params, req_id, meta, plans, n_prefix,
                                      pool_blocks, qos)
        except ValueError as e:
            logger.info("kv_pool fetch submit rejected: %s", e)
            return None
        self._start_puller(req, [f"{url}/kv_pool/{key}/chunk/{i}"
                                 for i in range(len(plans))],
                           eng.pd_costs.note_transfer, "kv-pool-puller")
        return req

    def _submit_with_local_tier(self, tokens, params, req_id: str, pool_blocks, **qos):
        """This replica's own tiers before any peer or a recompute: the
        host store's longest resident prefix, else the slab directory's
        (a disk read below the measured break-even recomputes).  None on
        any miss or ineligibility."""
        eng = self.state.engine
        pool, tier = eng.kv_pool, eng.kv_tier
        if not pool_blocks:
            return None
        ps = eng.cfg.page_size

        def feed(req, read, note, name):
            def run():
                ci = req.kv_chunked
                try:
                    t0, fed = time.monotonic(), 0
                    for i in range(ci.n_chunks):
                        data = read(i)
                        fed += len(data)
                        ci.feed(i, data)
                        eng._wake.set()
                    if note is not None:
                        note(fed, time.monotonic() - t0)
                except Exception as e:
                    # the engine's fetch-failure path recomputes
                    ci.set_error(f"{name} failed: {e}", transient=True)
                    eng._wake.set()
            threading.Thread(target=run, daemon=True, name=name).start()

        # the host store: peek during the scan, one get() on the entry
        # chosen (a hit and an LRU touch, as a remote handshake counts)
        entry = None
        for n in range(len(pool_blocks), 0, -1):
            entry = pool.peek(pool_key(pool_blocks[:n]))
            if entry is not None:
                break
        if entry is not None:
            exp = entry.export
            n_pages = common_prefix_pages(tokens, exp.prompt_tokens, ps)
            if n_pages > 0:
                try:
                    req = self._submit_prefix(tokens, params, req_id, exp.meta,
                                              exp.plans, n_pages * ps, pool_blocks, qos)
                except ValueError as e:
                    logger.info("kv_tier host import rejected: %s", e)
                    return None
                pool.get(entry.key)
                eng.counters["kv_tier_host_hits_total"] += 1
                eng.counters["kv_tier_import_tokens_total"] += n_pages * ps
                exp.ensure_draining()
                feed(req, lambda i: exp.get_chunk(i, consume=False), None,
                     "kv-tier-host-feeder")
                return req
        hit = tier.lookup_longest(pool_blocks)
        if hit is None:
            return None
        key, dmeta = hit
        n_pages = common_prefix_pages(tokens, dmeta.get("prompt_tokens") or [], ps)
        if n_pages <= 0:
            return None
        nbytes = sum(int(x) for x in dmeta["chunk_sizes"])
        if not should_import_from_disk(nbytes, n_pages * ps, eng.pd_costs):
            logger.info("kv_tier disk read below measured break-even (%d tokens); "
                        "recomputing locally", n_pages * ps)
            return None
        try:
            meta = dmeta["meta"]
            plans = [ChunkPlan.from_json(c) for c in meta["chunks"]]
            req = self._submit_prefix(tokens, params, req_id, meta, plans,
                                      n_pages * ps, pool_blocks, qos)
        except (KeyError, ValueError) as e:
            logger.info("kv_tier disk import rejected: %s", e)
            return None
        eng.counters["kv_tier_disk_hits_total"] += 1
        eng.counters["kv_tier_import_tokens_total"] += n_pages * ps
        feed(req, lambda i: tier.read_chunk(key, i, dmeta), eng.pd_costs.note_disk_read,
             "kv-tier-disk-feeder")
        return req

    def _completions(self, chat: bool):
        st = self.state
        eng = st.engine
        body = self._read_body()
        if body is None:
            return
        qos_ids = self._intake_tenant(body)
        if qos_ids is None:
            return
        tenant, priority = qos_ids
        shed = st.limiter.shed_reason(eng, tenant=tenant)
        if shed is not None:
            return self._shed(shed)
        tools, tool_choice = body.get("tools"), body.get("tool_choice")
        if not chat and (tools is not None or tool_choice is not None):
            return self._error(400, "'tools' and 'tool_choice' are only "
                                    "supported on /v1/chat/completions")
        # structured output: response_format, tools and tool_choice are
        # validated and COMPILED here, on the request thread, before
        # admission; the engine thread only sees a compiled grammar
        forced_tools = use_tools = False
        grammar_spec = None
        try:
            if chat:
                messages = body.get("messages")
                if not isinstance(messages, list) or not messages:
                    return self._error(400, "'messages' must be a non-empty list")
                tool_setup = self._tool_intake(tools, tool_choice)
                if isinstance(tool_setup, str):
                    return self._error(400, tool_setup)
                use_tools, forced_tools, grammar_spec = tool_setup
                if use_tools:
                    # advertise the tools in the model's own call format,
                    # merged into a leading system message so templates
                    # that keep one system block see both
                    tp = render_tools_prompt(tools, mode=eng.md.tool_call_parser
                                             or "hermes")
                    messages = list(messages)
                    if messages[0].get("role") == "system":
                        messages[0] = {"role": "system", "content":
                                       messages[0].get("content", "") + "\n\n" + tp}
                    else:
                        messages = [{"role": "system", "content": tp}] + messages
                prompt_text = render_chat(eng.tokenizer, messages,
                                          model_id=eng.md.name)
            else:
                prompt = body.get("prompt", "")
                if isinstance(prompt, list):
                    prompt = prompt[0] if prompt else ""
                if not isinstance(prompt, str) or prompt == "":
                    return self._error(400, "'prompt' must be a non-empty string")
                prompt_text = prompt
            rf = body.get("response_format")
            if rf is not None:
                if grammar_spec is not None:
                    return self._error(400, "'response_format' cannot be combined "
                                            "with a forced tool_choice (both "
                                            "constrain the output grammar)")
                try:
                    grammar_spec = spec_from_response_format(rf)
                except GrammarError as e:
                    return self._error(400, str(e))
            grammar = None
            if grammar_spec is not None:
                if not st.cfg.structured_output:
                    return self._error(400, "structured output is disabled on this "
                                            "server (structured_output=false)",
                                       "structured_output_disabled")
                try:
                    grammar = eng.grammar_cache.get(grammar_spec, eng.tokenizer)
                except GrammarError as e:
                    # a well-formed request whose grammar does not compile
                    # (state cap, a tokenizer dead end, an unsupported
                    # construct)
                    return self._error(422, str(e), "invalid_grammar_error")
            if chat:
                want_lp = bool(body.get("logprobs"))
                if int(body.get("top_logprobs", 0) or 0) > 0:
                    return self._error(400, "top_logprobs alternatives are "
                                            "not supported")
            else:
                lp_param = body.get("logprobs")
                want_lp = lp_param not in (None, False, 0)
                if want_lp and int(lp_param) > 1:
                    return self._error(400, "logprobs > 1 (top-k "
                                            "alternatives) is not supported")
            stream = bool(body.get("stream", False))
            if want_lp and stream:
                return self._error(400, "logprobs are not supported with "
                                        "streaming")
            # echo + logprobs + max_tokens=0: prompt SCORING (the lm-eval
            # loglikelihood contract); echo with generation is refused
            echo = bool(body.get("echo", False)) and not chat
            if echo and int(body.get("max_tokens") or 0) > 0:
                return self._error(400, "'echo' is only supported with "
                                        "max_tokens=0 (prompt scoring)")
            n_choices = int(body.get("n", 1) or 1)
            if not 1 <= n_choices <= _MAX_CHOICES:
                return self._error(400, f"'n' must be between 1 and {_MAX_CHOICES}")
            if n_choices > 1 and stream:
                return self._error(400, "'n' > 1 is not supported with streaming")
            model_field = body.get("model") or ""
            adapter, err = self._request_adapter(model_field, tenant)
            if err is not None:
                return self._error(*err)
            params = SamplingParams(
                max_tokens=int(body.get("max_tokens") or 128),
                temperature=float(body.get("temperature", 1.0)),
                top_k=int(body.get("top_k", 0) or 0),
                top_p=float(body.get("top_p", 1.0)),
                seed=int(body.get("seed", 0) or 0),
                logprobs=want_lp,
                presence_penalty=float(body.get("presence_penalty", 0.0) or 0.0),
                frequency_penalty=float(body.get("frequency_penalty", 0.0) or 0.0),
                repetition_penalty=float(body.get("repetition_penalty", 1.0)
                                         or 1.0),
                min_p=float(body.get("min_p", 0.0) or 0.0),
                ignore_eos=bool(body.get("ignore_eos", False)),
                grammar=grammar,
            )
            include_usage = bool((body.get("stream_options") or {})
                                 .get("include_usage"))
            # per-request deadline in seconds; 0/absent falls back to
            # --request-timeout-s
            timeout_s = float(body.get("timeout", 0) or 0)
            if timeout_s < 0:
                return self._error(400, "'timeout' must be >= 0")
        except (TypeError, ValueError, AttributeError) as e:
            return self._error(400, f"bad parameter: {e}")

        stop = body.get("stop")
        stop_strs = [stop] if isinstance(stop, str) else list(stop or [])
        tokens = eng.tokenizer.encode(prompt_text)
        kv_src = body.get("kv_transfer")
        # the cluster KV pool: the request hashed the way the router
        # hashes it (the body's text, not the rendered template), the
        # adapter seeding the chain
        pool_blocks: list = []
        if eng.kv_pool is not None:
            pool_blocks = prompt_pool_blocks(extract_prompt_text(body),
                                             eng.cfg.page_size, adapter=adapter)
        if kv_src and n_choices > 1:
            return self._error(400, "'n' > 1 is not supported with KV transfer")
        if echo and kv_src:
            return self._error(400, "prompt scoring with KV transfer is not supported")
        if echo:
            return self._score_prompt(body, tokens, prompt_text, want_lp)
        if n_choices > 1 and not params.seed:
            # pin the first choice's seed now, so the choices' seeds
            # (seed + i) never collide with the engine's own
            params = dataclasses.replace(params, seed=int(uuid.uuid4().hex[:8], 16) | 1)
        req_id = f"cmpl-{uuid.uuid4().hex[:20]}"
        reqs = []
        qos = dict(timeout_s=timeout_s, tenant=tenant, priority=priority,
                   adapter=adapter)
        try:
            first = None
            if kv_src:
                first = self._submit_with_transfer(kv_src, params, req_id, **qos)
                if first is None:
                    return  # the error is sent
                tokens = first.prompt_tokens
            elif eng.kv_pool is not None:
                first = self._submit_with_pool(tokens, params, req_id, pool_blocks, **qos)
            if first is not None:
                reqs.append(first)
            for ci in range(len(reqs), n_choices):
                reqs.append(eng.submit(
                    tokens, dataclasses.replace(params, seed=params.seed + ci),
                    req_id=req_id if ci == 0 else f"{req_id}-{ci}",
                    trace_id=self._rid, pool_blocks=pool_blocks if ci == 0 else None,
                    **qos))
        except ValueError as e:
            for r in reqs:
                eng.abort(r)
            return self._error(400, str(e))
        # conversation identity (X-Kaito-Session), kept on the request
        session = self.headers.get("X-Kaito-Session", "").strip()
        if session:
            reqs[0].session = session[:128]
        obj = "chat.completion" if chat else "text_completion"
        base = {"id": req_id, "object": obj + (".chunk" if stream else ""),
                "created": int(time.time()),
                "model": model_field or st.model_name}
        if stream:
            try:
                if chat and use_tools:
                    return self._stream_tool_calls(reqs[0], base, forced_tools,
                                                   include_usage)
                return self._stream(reqs[0], base, chat, stop_strs, include_usage)
            except (BrokenPipeError, ConnectionResetError):
                # the client left mid-stream: free its slot now rather
                # than decode on to max_tokens for no reader
                eng.abort(reqs[0])
                self.close_connection = True
                return

        outs = [list(r.stream()) for r in reqs]   # drain every choice
        bad = next((r for r in reqs if r.finish_reason in ("error", "deadline")),
                   None)
        if bad is not None:
            # a failure or a deadline: the structured error (5xx / 408),
            # not a 200 with truncated text
            st.metrics.observe_request(reqs[0])
            st.slo.observe_request(bad)
            return self._request_error(bad)
        choices = [self._choice(idx, r, out_ids, chat, stop_strs, prompt_text,
                                (use_tools, forced_tools))
                   for idx, (r, out_ids) in enumerate(zip(reqs, outs))]
        completion = sum(len(o) for o in outs)
        resp = dict(base)
        resp.update({"choices": choices, "usage": {
            "prompt_tokens": len(tokens), "completion_tokens": completion,
            "total_tokens": len(tokens) + completion}})
        st.observe(reqs[0])
        st.note_tokens(reqs)
        self._json(200, resp)

    def _tool_intake(self, tools, tool_choice):
        """A chat request's tools: (use_tools, forced, grammar spec of the
        forced call's envelope or None), or the 400's message."""
        if tools is not None and (not isinstance(tools, list) or not tools or not all(
                isinstance(t, dict) for t in tools)):
            return "'tools' must be a non-empty list of tool objects"
        if tool_choice is not None and not tools:
            return "'tool_choice' requires 'tools'"
        if not tools:
            return False, False, None
        choice = tool_choice if tool_choice is not None else "auto"
        named = None
        if isinstance(choice, dict):
            named = (choice.get("function") or {}).get("name")
            if choice.get("type") != "function" or not named:
                return ("'tool_choice' object must be {\"type\": \"function\", "
                        "\"function\": {\"name\": ...}}")
        elif choice not in ("auto", "none", "required"):
            return f"unknown tool_choice {choice!r}"
        if named is None and choice != "required":
            return choice == "auto", False, None
        # a forced call: generation is constrained to the JSON envelope
        try:
            env = tool_envelope_schema(tools, names=[named] if named else None)
        except GrammarError as e:
            return str(e)
        return True, True, GrammarSpec("json_schema", canonical_schema(env))

    def _choice(self, idx, req, out_ids, chat, stop_strs, prompt_text,
                tools=(False, False)) -> dict:
        """One choice of a finished request: its text cut at the first
        stop string, with its logprobs aligned to the text returned; a
        chat reply parsed for reasoning and tool calls (``tools`` is
        (use_tools, forced))."""
        tok = self.state.engine.tokenizer
        text = tok.decode(out_ids)
        finish = req.finish_reason or "stop"
        stop_cut = False
        for s in stop_strs:
            if s in text:
                text = text[: text.find(s)]
                finish = "stop"
                stop_cut = True
        lp_block = None
        if req.params.logprobs:
            strs = token_surface_forms(tok, out_ids)
            lps = list(req.output_logprobs[:len(out_ids)])
            if stop_cut:
                kept, acc = len(out_ids), 0
                for i, s in enumerate(strs):
                    if acc >= len(text):
                        kept = i
                        break
                    acc += len(s)
                strs, lps = strs[:kept], lps[:kept]
            if chat:
                lp_block = {"content": [{"token": s, "logprob": lp,
                                         "bytes": list(s.encode())}
                                        for s, lp in zip(strs, lps)]}
            else:
                offsets, pos = [], len(prompt_text)
                for s in strs:
                    offsets.append(pos)
                    pos += len(s)
                lp_block = {"tokens": strs, "token_logprobs": lps,
                            "top_logprobs": None, "text_offset": offsets}
        if chat:
            md = self.state.engine.md
            use_tools, forced = tools
            if forced:
                # the grammar-forced envelope parses directly
                parsed = parse_forced_tool_call(text)
            else:
                parsed = parse_message(text, reasoning=bool(md.reasoning_parser),
                                       tools=use_tools, tool_mode=md.tool_call_parser)
            message = {"role": "assistant", "content": parsed.content}
            if parsed.reasoning_content is not None:
                message["reasoning_content"] = parsed.reasoning_content
            if parsed.tool_calls:
                message["tool_calls"] = parsed.tool_calls
            choice = {"index": idx, "message": message,
                      "finish_reason": parsed.finish_reason or finish}
            if lp_block is not None:
                choice["logprobs"] = lp_block
            return choice
        return {"index": idx, "text": text, "logprobs": lp_block,
                "finish_reason": finish}

    def _score_prompt(self, body: dict, tokens: list, prompt_text: str,
                      want_lp: bool):
        """completions ``echo`` + ``max_tokens: 0``: the prompt with the
        log p of each of its tokens (None first), computed on the engine
        thread.  A scoring failure answers 500."""
        st = self.state
        if not want_lp:
            return self._error(400, "'echo' with max_tokens=0 requires logprobs")
        try:
            lps = st.engine.score_prompt(tokens)
        except ValueError as e:
            return self._error(400, str(e))
        except Exception as e:
            logger.exception("prompt scoring failed")
            return self._error(500, f"prompt scoring failed: {e}", "internal_error")
        strs = token_surface_forms(st.engine.tokenizer, tokens)
        offsets, pos = [], 0
        for s in strs:
            offsets.append(pos)
            pos += len(s)
        choice = {"index": 0, "text": prompt_text, "finish_reason": "stop",
                  "logprobs": {"tokens": strs, "token_logprobs": lps,
                               "top_logprobs": None, "text_offset": offsets}}
        self._json(200, {
            "id": f"cmpl-{uuid.uuid4().hex[:20]}",
            "object": "text_completion", "created": int(time.time()),
            "model": body.get("model") or st.model_name,
            "choices": [choice],
            "usage": {"prompt_tokens": len(tokens), "completion_tokens": 0,
                      "total_tokens": len(tokens)}})

    def _stream(self, req, base, chat, stop_strs, include_usage):
        """Server-sent events of one request.  The stream opens with its
        first token: a request that fails or passes its deadline before
        one answers with its structured error instead, and one that does
        after sends the error as its last event."""
        st = self.state
        eng = st.engine
        toks = req.stream()
        first_tok = next(toks, None)
        if first_tok is None and req.finish_reason in ("error", "deadline"):
            st.observe(req)
            return self._request_error(req)
        self._sse_start()

        def chunk(delta: Optional[str], finish=None):
            c = dict(base)
            if chat:
                body = {"delta": {} if delta is None else {"content": delta}}
            else:
                body = {"text": delta or ""}
            c["choices"] = [{"index": 0, **body, "finish_reason": finish}]
            return c

        if chat:
            first = dict(base)
            first["choices"] = [{"index": 0, "delta": {"role": "assistant"},
                                 "finish_reason": None}]
            self._sse_send(first)
        sent_text, ids, stopped = "", [], False
        for tok in _chain(first_tok, toks):
            ids.append(tok)
            text = eng.tokenizer.decode(ids)
            if text.endswith("\ufffd"):
                continue  # mid-codepoint; wait for more bytes
            delta = text[len(sent_text):]
            sent_text = text
            if stop_strs and any(s in sent_text for s in stop_strs):
                cut = min(sent_text.find(s) for s in stop_strs if s in sent_text)
                delta = sent_text[:cut][len(sent_text) - len(delta):]
                eng.abort(req)
                stopped = True
            if delta:
                self._sse_send(chunk(delta))
            if stopped:
                break
        if not stopped and ids:
            tail = eng.tokenizer.decode(ids)[len(sent_text):]
            if tail:
                self._sse_send(chunk(tail))
        self._sse_send(chunk(None, "stop" if stopped else (req.finish_reason or "stop")))
        if not stopped and req.finish_reason in ("error", "deadline"):
            err = req.error or {}
            self._sse_send({"error": {"message": err.get("message", "request failed"),
                                      "type": err.get("type", "internal_error"),
                                      "code": int(err.get("status", 500)),
                                      "request_id": self._rid}})
        if include_usage:
            n_out = len(req.output_tokens)
            usage = dict(base)
            usage.update({"choices": [], "usage": {
                "prompt_tokens": len(req.prompt_tokens),
                "completion_tokens": n_out,
                "total_tokens": len(req.prompt_tokens) + n_out}})
            self._sse_send(usage)
        st.observe(req)
        st.note_tokens([req])
        self._sse_end()


    def _stream_tool_calls(self, req, base, forced: bool, include_usage: bool):
        """Server-sent events of a chat request with tools.  A forced call
        (``required`` or named) is grammar-constrained to the JSON
        envelope, so its name and argument bytes stream as they decode;
        ``auto`` buffers the whole reply and then sends EITHER its content
        or its ``tool_calls``, so a client's accumulator never sees both
        interleaved.  Errors as in :meth:`_stream`."""
        st = self.state
        eng = st.engine
        toks = req.stream()
        first_tok = next(toks, None)
        if first_tok is None and req.finish_reason in ("error", "deadline"):
            st.observe(req)
            return self._request_error(req)
        self._sse_start()

        def send(delta, finish=None):
            c = dict(base)
            c["choices"] = [{"index": 0, "delta": delta, "finish_reason": finish}]
            self._sse_send(c)

        send({"role": "assistant"})
        ids: list[int] = []
        if forced:
            parser, sent = StreamingToolCallParser(), ""
            for tok in _chain(first_tok, toks):
                ids.append(tok)
                text = eng.tokenizer.decode(ids)
                if text.endswith("\ufffd"):
                    continue  # mid-codepoint; wait for more bytes
                delta, sent = text[len(sent):], text
                for d in parser.feed(delta):
                    send({"tool_calls": [d]})
            tail = eng.tokenizer.decode(ids)[len(sent):]
            for d in parser.feed(tail) + parser.finish():
                send({"tool_calls": [d]})
            finish = "tool_calls"
        else:
            ids = list(_chain(first_tok, toks))
            parsed = parse_message(eng.tokenizer.decode(ids),
                                   reasoning=bool(eng.md.reasoning_parser), tools=True,
                                   tool_mode=eng.md.tool_call_parser)
            if parsed.content:
                send({"content": parsed.content})
            finish = req.finish_reason or "stop"
            if parsed.tool_calls:
                for d in tool_call_deltas(parsed.tool_calls):
                    send({"tool_calls": [d]})
                finish = "tool_calls"
        send({}, finish=finish)
        if include_usage:
            n_out = len(req.output_tokens)
            usage = dict(base)
            usage.update({"choices": [], "usage": {
                "prompt_tokens": len(req.prompt_tokens), "completion_tokens": n_out,
                "total_tokens": len(req.prompt_tokens) + n_out}})
            self._sse_send(usage)
        st.observe(req)
        st.note_tokens([req])
        self._sse_end()


def _chain(first, rest):
    """``first`` (unless None) then the rest of an iterator."""
    if first is None:
        return
    yield first
    yield from rest


# Colocated P/D: the engines served from this process, by base URL.  A
# kv_transfer whose source_url resolves here is a device-to-device copy
# of the staged slab: no host bounce, no wire.
_LOCAL_PD_ENGINES: dict[str, InferenceEngine] = {}
_LOCAL_PD_LOCK = threading.Lock()


def lookup_local_engine(url: str) -> Optional[InferenceEngine]:
    with _LOCAL_PD_LOCK:
        return _LOCAL_PD_ENGINES.get(url.rstrip("/"))


class _Server(ThreadingHTTPServer):
    """Registers its engine for colocated P/D, unregisters it when it
    stops serving (a reused port must not divert a lookup to a dead
    engine), and stops the server state's threads (the flight watcher)
    on close."""

    _pd_urls: tuple = ()

    def _pd_unregister(self):
        with _LOCAL_PD_LOCK:
            for u in self._pd_urls:
                if _LOCAL_PD_ENGINES.get(u) is self.state.engine:
                    del _LOCAL_PD_ENGINES[u]

    def shutdown(self):
        self._pd_unregister()
        super().shutdown()

    def server_close(self):
        self._pd_unregister()
        super().server_close()
        self.state.close()


def make_server(engine: Optional[InferenceEngine], cfg: EngineConfig,
                host: str = "0.0.0.0", port: Optional[int] = None,
                device: str = "cuda") -> ThreadingHTTPServer:
    """HTTP server over ``engine``; with ``engine=None`` it builds and
    starts an :class:`InferenceEngine` for ``cfg`` on ``device``."""
    if engine is None:
        engine = InferenceEngine(cfg, device=device)
        engine.start()
    elif engine.device != resolve_device(device):
        raise ValueError(f"engine runs on {engine.device}, server asked for "
                         f"{device!r}")
    state = ServerState(engine, cfg)
    handler = type("Handler", (OpenAIHandler,), {"state": state})
    server = _Server((host, port if port is not None else cfg.port), handler)
    server.daemon_threads = True
    server.state = state  # type: ignore[attr-defined]
    bound = server.server_address[1]
    hosts = {"127.0.0.1", "localhost"}
    if host not in ("0.0.0.0", "::", ""):
        hosts.add(host)
    server._pd_urls = tuple(f"http://{h}:{bound}" for h in sorted(hosts))
    with _LOCAL_PD_LOCK:
        for u in server._pd_urls:
            _LOCAL_PD_ENGINES[u] = engine
    return server


def parse_args(argv=None) -> tuple[EngineConfig, argparse.Namespace]:
    """The server's command line as an engine config (and the parsed
    arguments, for the options that are not config fields)."""
    ap = argparse.ArgumentParser(prog="kaito-tpu-torch-serve")
    ap.add_argument("--model", default="tiny-llama-test")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a usable card "
                         "raises")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--max-model-len", type=int, default=0)
    ap.add_argument("--max-num-seqs", type=int, default=8)
    ap.add_argument("--served-model-name", default="")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--kv-cache-dtype",
                    default=os.environ.get("KAITO_KV_CACHE_DTYPE", ""),
                    choices=["", "auto", "bfloat16", "float32", "int8"],
                    help="KV page-pool dtype; '' or 'auto' follows --dtype; "
                         "int8 stores codes with fp32 per-page-per-head scales")
    ap.add_argument("--quantization",
                    default=os.environ.get("KAITO_QUANTIZATION", ""),
                    choices=["", "int8", "int4"],
                    help="weight-only quantization of the layer projections: "
                         "'' (off), int8 (per output channel) or int4 "
                         "(packed, groups of 128 input rows)")
    ap.add_argument("--weights-dir",
                    default=os.environ.get("KAITO_WEIGHTS_DIR", ""),
                    help="safetensors checkpoint dir ('' = synthetic weights)")
    ap.add_argument("--max-pages", type=int, default=0,
                    help="KV page-pool size (0 = size from free device memory)")
    ap.add_argument("--max-prefill-tokens", type=int, default=512)
    ap.add_argument("--speculative-ngram", type=int,
                    default=int(os.environ.get("KAITO_SPEC_NGRAM", "0")),
                    help="prompt-lookup speculative decoding: propose up to N "
                         "tokens per step (0 = off; exact greedy equivalence)")
    ap.add_argument("--speculative-draft",
                    default=os.environ.get("KAITO_SPEC_DRAFT", ""),
                    help="draft preset for two-model speculative decoding, or "
                         "'auto' for the model's curated pairing (must share the "
                         "target's tokenizer; '' = off).  Greedy output stays "
                         "exact; sampled output keeps the target's distribution "
                         "(rejection sampling)")
    ap.add_argument("--speculative-draft-k", type=int,
                    default=int(os.environ.get("KAITO_SPEC_DRAFT_K", "4")),
                    help="max adaptive speculation depth per slot (the "
                         "accept-rate controller moves within [1, K] and falls "
                         "back to n-gram, then plain decode, on poor acceptance)")
    ap.add_argument("--speculative-draft-weights-dir",
                    default=os.environ.get("KAITO_SPEC_DRAFT_WEIGHTS", ""),
                    help="safetensors dir for the draft's weights ('' = synthetic)")
    ap.add_argument("--prefill-pack", type=int,
                    default=int(os.environ.get("KAITO_PREFILL_PACK", "0")),
                    help="staged sequences per prefill round (0 = auto, up "
                         "to max-num-seqs; 1 = serial round-robin)")
    ap.add_argument("--decode-run-ahead", type=int, default=None,
                    help="fused decode steps per window (default: measured "
                         "auto value)")
    ap.add_argument("--enable-prefix-caching", dest="enable_prefix_caching",
                    action="store_true", default=True)
    ap.add_argument("--no-enable-prefix-caching", dest="enable_prefix_caching",
                    action="store_false")
    ap.add_argument("--kaito-kv-cache-cpu-memory-utilization", type=float,
                    default=float(os.environ.get("KAITO_KV_CPU_MEM_UTIL", "0")),
                    help="fraction of host RAM for the KV offload tier that "
                         "preempted sequences spill to (0 disables)")
    ap.add_argument("--max-queue-len", type=int, default=256)
    ap.add_argument("--kaito-disable-rate-limit", action="store_true")
    ap.add_argument("--qos-config",
                    default=os.environ.get("KAITO_QOS_CONFIG", ""),
                    help="multi-tenant QoS classes as inline JSON or @path to a "
                         "file; '' = off (one implicit tenant, FIFO admission)")
    ap.add_argument("--request-timeout-s", type=float, default=0.0,
                    help="server-default request deadline in seconds (0 = none); "
                         "an expired request answers 408")
    ap.add_argument("--kv-shed-threshold", type=float, default=0.0,
                    help="shed new requests with 429 + Retry-After when KV page "
                         "usage crosses this fraction while a queue exists "
                         "(0 = off)")
    ap.add_argument("--itl", action="store_true",
                    default=os.environ.get("KAITO_ITL", "") in ("1", "true"),
                    help="stamp every retired token and expose true per-token "
                         "inter-token latency (kaito:inter_token_latency_seconds "
                         "and the watchdog's itl_p99 SLI); off keeps the "
                         "exposition as it is")
    ap.add_argument("--slo-itl-p99-ms", type=float,
                    default=float(os.environ.get("KAITO_SLO_ITL_P99_MS", "250")),
                    help="ITL p99 SLO target (ms); gaps beyond it count as "
                         "stalls and burn the itl_p99 budget")
    ap.add_argument("--devprof-interval-s", type=float,
                    default=float(os.environ.get("KAITO_DEVPROF_INTERVAL_S", "0")),
                    help="sampled device-time attribution: capture a short "
                         "torch.profiler window this often and fold it into "
                         "op-class buckets and engine phases on /metrics and "
                         "/debug/device (0 = off; off keeps the exposition as "
                         "it is and /debug/device answers 403)")
    ap.add_argument("--devprof-window-s", type=float,
                    default=float(os.environ.get("KAITO_DEVPROF_WINDOW_S", "0.25")),
                    help="capture length of each sampled devprof window")
    ap.add_argument("--slow-request-threshold-s", type=float, default=0.0,
                    help="dump a request's span tree to the log when its "
                         "end-to-end latency crosses this (0 = off)")
    ap.add_argument("--flight-dir",
                    default=os.environ.get("KAITO_FLIGHT_DIR", ""),
                    help="directory for incident flight-recorder bundles "
                         "(written on an SLO page, an engine-fatal error, "
                         "SIGTERM with requests in flight, or POST "
                         "/debug/flight; '' = off, /debug/flight answers 403)")
    ap.add_argument("--flight-max-bundles", type=int,
                    default=int(os.environ.get("KAITO_FLIGHT_MAX_BUNDLES", "16")),
                    help="bundles kept under --flight-dir (LRU by mtime)")
    ap.add_argument("--no-structured-output", dest="structured_output",
                    action="store_false",
                    default=os.environ.get("KAITO_STRUCTURED_OUTPUT", "1") != "0",
                    help="reject response_format and forced tool_choice with a "
                         "typed 400 (structured_output_disabled); on by default "
                         "and pay-per-use")
    ap.add_argument("--grammar-cache-entries", type=int,
                    default=int(os.environ.get("KAITO_GRAMMAR_CACHE_ENTRIES", "64")),
                    help="compiled-schema LRU entries")
    ap.add_argument("--grammar-max-states", type=int,
                    default=int(os.environ.get("KAITO_GRAMMAR_MAX_STATES", "512")),
                    help="DFA state cap per grammar; each state costs 8 bytes "
                         "per vocabulary entry in the device mask table")
    ap.add_argument("--kaito-adapters-dir", default="",
                    help="LoRA adapters to serve at boot (one subdirectory each)")
    ap.add_argument("--adapter-slots", type=int,
                    default=int(os.environ.get("KAITO_ADAPTER_SLOTS", "0")),
                    help="multi-LoRA cache: device slot-table capacity; 0 = off "
                         "(boot-time stacks only, /v1/adapters 403, no "
                         "kaito:adapter_* family)")
    ap.add_argument("--adapter-rmax", type=int,
                    default=int(os.environ.get("KAITO_ADAPTER_RMAX", "16")),
                    help="largest servable adapter rank (higher is refused: "
                         "rank_overflow)")
    ap.add_argument("--adapter-host-bytes", type=int,
                    default=int(os.environ.get("KAITO_ADAPTER_HOST_BYTES",
                                               str(256 << 20))),
                    help="host-RAM tier for evicted adapters (0 disables it)")
    ap.add_argument("--adapter-allow-base-mismatch", action="store_true",
                    default=os.environ.get("KAITO_ADAPTER_ALLOW_BASE_MISMATCH",
                                           "") == "true",
                    help="serve adapters recorded for another base model "
                         "(default: refuse, reason base_mismatch)")
    ap.add_argument("--adapter-source-allowlist",
                    default=os.environ.get("KAITO_ADAPTER_ALLOWLIST", ""),
                    help="comma-separated source prefixes POST /v1/adapters may "
                         "pull from (hub://, oras://); '' = local paths only")
    ap.add_argument("--pd-enabled", action="store_true",
                    default=os.environ.get("KAITO_PD_ENABLED", "") == "true",
                    help="P/D disaggregation: /pd/* and kv_transfer (default "
                         "KAITO_PD_ENABLED=true, else off: 403)")
    ap.add_argument("--pd-source-allowlist",
                    default=os.environ.get("KAITO_PD_ALLOWLIST", ""),
                    help="comma-separated URL prefixes KV may be pulled from "
                         "('' = any)")
    ap.add_argument("--kv-pool", action="store_true",
                    default=os.environ.get("KAITO_KV_POOL", "") == "true",
                    help="cluster-wide KV pool: publish finished prompt prefixes "
                         "and serve them over the chunked P/D wire (off keeps "
                         "/metrics as it was)")
    ap.add_argument("--kv-pool-bytes", type=int,
                    default=int(os.environ.get("KAITO_KV_POOL_BYTES", str(1 << 30))),
                    help="host bytes for the replica-local prefix store")
    ap.add_argument("--kv-pool-disk-bytes", type=int,
                    default=int(os.environ.get("KAITO_KV_POOL_DISK_BYTES", "0")),
                    help="the pool's disk tier: host-store victims demote to a "
                         "bounded slab directory, and misses probe it first (0: "
                         "none)")
    ap.add_argument("--kv-pool-disk-dir",
                    default=os.environ.get("KAITO_KV_POOL_DISK_DIR", ""),
                    help="the disk tier's slab directory ('' = "
                         "<tempdir>/kaito-kv-tier)")
    ap.add_argument("--kv-pool-advert-max", type=int,
                    default=int(os.environ.get("KAITO_KV_POOL_ADVERT_MAX", "0")),
                    help="cap /debug/kv_pool adverts to the freshest N entries "
                         "(0 = unlimited)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tensor-parallel-size", type=int,
                    default=int(os.environ.get("KAITO_TENSOR_PARALLEL", "1")),
                    help="shards over the first N cards (raises when fewer "
                         "are visible)")
    # the other mesh degrees: parsed as the JAX server parses them; any
    # degree above 1 is refused by check_ported (ROADMAP M19)
    for flag, var in (("pipeline", "KAITO_PIPELINE_PARALLEL"),
                      ("expert", "KAITO_EXPERT_PARALLEL"),
                      ("data", "KAITO_DATA_PARALLEL"),
                      ("sequence", "KAITO_SEQUENCE_PARALLEL")):
        ap.add_argument(f"--{flag}-parallel-size", type=int,
                        default=int(os.environ.get(var, "1")))
    ap.add_argument("--comm-overlap", action="store_true", default=None,
                    help="collective-compute overlap for TP decode: pipelined "
                         "ring reduce-scatter/all-gather in place of the "
                         "all-reduce, plus layer-ahead prefetch of quantized "
                         "slabs (default: follow KAITO_COMM_OVERLAP, off when "
                         "unset)")
    ap.add_argument("--async-dispatch", action="store_true", default=None,
                    help="zero-bubble decode loop: device-resident loop state "
                         "and a two-deep dispatch pipeline overlapping the "
                         "host's postprocess with the device's next window "
                         "(default: follow KAITO_ASYNC_DISPATCH, off when "
                         "unset)")
    args = ap.parse_args(argv)
    cfg = EngineConfig(
        model=args.model, port=args.port, max_model_len=args.max_model_len,
        max_num_seqs=args.max_num_seqs,
        served_model_name=args.served_model_name, dtype=args.dtype,
        kv_dtype=(args.dtype if args.kv_cache_dtype in ("", "auto")
                  else args.kv_cache_dtype),
        weights_dir=args.weights_dir, quantization=args.quantization,
        max_pages=args.max_pages,
        max_prefill_tokens=args.max_prefill_tokens,
        prefill_pack=args.prefill_pack, decode_run_ahead=args.decode_run_ahead,
        enable_prefix_caching=args.enable_prefix_caching,
        host_kv_offload_bytes=int(args.kaito_kv_cache_cpu_memory_utilization
                                  * os.sysconf("SC_PAGE_SIZE")
                                  * os.sysconf("SC_PHYS_PAGES")),
        max_queue_len=args.max_queue_len,
        disable_rate_limit=args.kaito_disable_rate_limit,
        qos_config=args.qos_config, request_timeout_s=args.request_timeout_s,
        kv_shed_threshold=args.kv_shed_threshold, itl_enabled=args.itl,
        slo_itl_p99_ms=args.slo_itl_p99_ms,
        slow_request_threshold_s=args.slow_request_threshold_s,
        structured_output=args.structured_output,
        grammar_cache_entries=args.grammar_cache_entries,
        grammar_max_states=args.grammar_max_states,
        flight_dir=args.flight_dir, flight_max_bundles=args.flight_max_bundles,
        devprof_interval_s=args.devprof_interval_s,
        devprof_window_s=args.devprof_window_s,
        seed=args.seed,
        tensor_parallel=args.tensor_parallel_size,
        pipeline_parallel=args.pipeline_parallel_size,
        expert_parallel=args.expert_parallel_size,
        data_parallel=args.data_parallel_size,
        sequence_parallel=args.sequence_parallel_size, comm_overlap=args.comm_overlap,
        async_dispatch=args.async_dispatch,
        speculative_ngram=args.speculative_ngram,
        speculative_draft=(resolve_speculative_draft(get_model_by_name(args.model),
                                                     args.speculative_draft)
                           if args.speculative_draft else ""),
        speculative_draft_k=args.speculative_draft_k,
        speculative_draft_weights_dir=args.speculative_draft_weights_dir,
        adapters_dir=args.kaito_adapters_dir, adapter_slots=args.adapter_slots,
        adapter_rmax=args.adapter_rmax, adapter_host_bytes=args.adapter_host_bytes,
        adapter_allow_base_mismatch=args.adapter_allow_base_mismatch,
        adapter_source_allowlist=args.adapter_source_allowlist,
        pd_enabled=args.pd_enabled, pd_source_allowlist=args.pd_source_allowlist,
        kv_pool_enabled=args.kv_pool, kv_pool_bytes=args.kv_pool_bytes,
        kv_pool_disk_bytes=args.kv_pool_disk_bytes,
        kv_pool_disk_dir=args.kv_pool_disk_dir,
        kv_pool_advert_max=args.kv_pool_advert_max)
    return cfg, args


def main(argv=None):
    cfg, args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = make_server(None, cfg, host=args.host, device=args.device)
    engine = server.state.engine
    if cfg.flight_dir:
        # a flight trigger: SIGTERM with requests still in flight
        # snapshots the black box before the graceful shutdown runs
        import signal

        def _on_sigterm(signum, frame):
            in_flight = engine.num_running + engine.num_waiting
            if in_flight > 0:
                server.state.flight.record(
                    "sigterm", reason=f"{in_flight} request(s) in flight")
            raise KeyboardInterrupt

        signal.signal(signal.SIGTERM, _on_sigterm)
    logger.info("serving %s on %s:%d (%s)", cfg.model, args.host, cfg.port,
                engine.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.stop()


if __name__ == "__main__":
    main()
