"""RAG service metric family (~30 Prometheus series).

Breadth parity with the reference's
``presets/ragengine/metrics/prometheus_metrics.py`` (337 LoC, ~30
histograms/counters/gauges across request/embedding/retrieval/LLM/
guardrail/index stages); series names keep the ``kaito_rag:`` prefix so
the round-1 dashboards stay valid.

``kaito_tpu.rag.metrics`` on the port's own metric types: the same
families, labels and buckets.
"""

from __future__ import annotations

import time

from kaito_tpu_torch.engine.metrics import Counter, Gauge, Histogram, Registry

_LAT = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
        10.0, 30.0)


class RAGMetrics:
    """Every series the service emits; one instance per process."""

    def __init__(self, service=None):
        self.registry = Registry()
        r = self.registry
        self._t0 = time.monotonic()

        # -- request surface ------------------------------------------
        self.requests = Counter(
            "kaito_rag:requests_total", "Requests by route/status", r,
            labels=("route", "status"))
        self.request_seconds = Histogram(
            "kaito_rag:request_seconds", "End-to-end request latency", r,
            buckets=_LAT)
        self.errors = Counter(
            "kaito_rag:errors_total", "Errors by route", r, labels=("route",))

        # -- embedding stage ------------------------------------------
        self.embedding_requests = Counter(
            "kaito_rag:embedding_requests_total", "Embedding calls", r)
        self.embedding_seconds = Histogram(
            "kaito_rag:embedding_seconds", "Embedding latency", r,
            buckets=_LAT)
        self.embedding_texts = Counter(
            "kaito_rag:embedding_texts_total", "Texts embedded", r)

        # -- retrieval stage ------------------------------------------
        self.retrieval_requests = Counter(
            "kaito_rag:retrieval_requests_total", "Retrievals", r)
        self.retrieval_seconds = Histogram(
            "kaito_rag:retrieval_seconds", "Retrieval latency", r,
            buckets=_LAT)
        self.retrieved_documents = Counter(
            "kaito_rag:retrieved_documents_total", "Documents returned", r)

        # -- index CRUD -----------------------------------------------
        self.documents_indexed = Counter(
            "kaito_rag:documents_indexed_total", "Documents added", r)
        self.documents_updated = Counter(
            "kaito_rag:documents_updated_total", "Documents updated", r)
        self.documents_deleted = Counter(
            "kaito_rag:documents_deleted_total", "Documents deleted", r)
        self.indexing_seconds = Histogram(
            "kaito_rag:indexing_seconds", "Index-build latency", r,
            buckets=_LAT)
        self.persist_ops = Counter(
            "kaito_rag:persist_total", "Index persist operations", r)
        self.load_ops = Counter(
            "kaito_rag:load_total", "Index load operations", r)

        # -- LLM stage ------------------------------------------------
        self.llm_requests = Counter(
            "kaito_rag:llm_requests_total", "Upstream LLM calls", r,
            labels=("mode",))
        self.llm_seconds = Histogram(
            "kaito_rag:llm_seconds", "Upstream LLM latency", r, buckets=_LAT)
        self.llm_errors = Counter(
            "kaito_rag:llm_errors_total", "Upstream LLM failures", r)
        self.stream_chunks = Counter(
            "kaito_rag:stream_chunks_total", "SSE chunks relayed", r)

        # -- guardrails -----------------------------------------------
        self.guardrail_scans = Counter(
            "kaito_rag:guardrails_scans_total", "Responses scanned", r)
        self.guardrail_blocked = Counter(
            "kaito_rag:guardrails_blocked_total", "Responses blocked", r)
        self.guardrail_seconds = Histogram(
            "kaito_rag:guardrails_seconds", "Scan latency", r, buckets=_LAT)
        self.guardrail_reloads = Counter(
            "kaito_rag:guardrails_policy_reloads_total", "Policy reloads", r)

        # -- service state --------------------------------------------
        Gauge("kaito_rag:uptime_seconds", "Process uptime", r,
              fn=lambda: time.monotonic() - self._t0)
        if service is not None:
            Gauge("kaito_rag:indexes", "Live indexes", r,
                  fn=lambda: len(service.indexes))
            Gauge("kaito_rag:documents", "Documents across all indexes", r,
                  fn=lambda: sum(len(ix.docs)
                                 for ix in service.indexes.values()))
            Gauge("kaito_rag:guardrails_enabled", "Guardrails active", r,
                  fn=lambda: 1.0 if service.guardrails.enabled else 0.0)
            Gauge("kaito_rag:lifecycle_hooks", "Registered lifecycle hooks", r,
                  fn=lambda: len(service.lifecycle))


class Timed:
    """Context manager: observe a histogram with elapsed seconds."""

    def __init__(self, hist: Histogram):
        self.hist = hist

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.monotonic() - self.t0)
        return False
