"""The RAG service HTTP app.

Parity with the reference's FastAPI service (``presets/ragengine/
main.py:101-876``): index CRUD, document list/update/delete,
persist/load, hybrid /retrieve, RAG-augmented ``/v1/chat/completions``
passthrough with SSE streaming and output guardrails, /metrics and
/health — on stdlib HTTP like the rest of the in-pod runtime.

``kaito_tpu.rag.app`` for the port: the same routes, bodies and
metrics.  A local embedding model runs on ``device`` (the card unless
the caller asks for the CPU); the ``native`` and ``faiss`` engines take
the flat numpy index.  Start it with ``python -m kaito_tpu_torch.rag.app``
under the RAGEngine variables of :meth:`RAGConfig.from_env`.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from kaito_tpu_torch.rag.config import RAGConfig
from kaito_tpu_torch.rag.embeddings import make_embedder
from kaito_tpu_torch.rag.guardrails import BLOCK_MESSAGE, OutputGuardrails, StreamingGuard
from kaito_tpu_torch.rag.lifecycle import LifecycleManager
from kaito_tpu_torch.rag.llm_client import LLMClient, inject_context
from kaito_tpu_torch.rag.metrics import RAGMetrics, Timed
from kaito_tpu_torch.rag.qdrant_store import QdrantDenseIndex
from kaito_tpu_torch.rag.vector_store import FlatDenseIndex, VectorIndex

logger = logging.getLogger(__name__)


class RAGService:
    def __init__(self, cfg: RAGConfig, device: str = "cuda"):
        self.cfg = cfg
        self.embedder = make_embedder(cfg, device=device)
        self.embedder = _TimedEmbedder(self.embedder, self)
        self.indexes: dict[str, VectorIndex] = {}
        self.lock = threading.RLock()
        self.llm = LLMClient(cfg.llm_inference_url, cfg.llm_access_secret,
                             cfg.llm_context_window) if cfg.llm_inference_url else None
        self.guardrails = (OutputGuardrails.from_policy_file(cfg.guardrails_policy_file)
                           if cfg.guardrails_policy_file and
                           os.path.exists(cfg.guardrails_policy_file)
                           else OutputGuardrails())

        self.lifecycle = LifecycleManager()
        self.metrics = RAGMetrics(self)
        self.registry = self.metrics.registry
        # hooks mirroring the reference lifecycle manager: load persisted
        # indexes on boot, persist on drain (when a persist dir is set)
        if cfg.persist_dir:
            self.lifecycle.on_startup(
                "load-persisted-indexes", self._load_persisted,
                critical=False)
            self.lifecycle.on_shutdown("persist-indexes", self._persist_all)
        self.lifecycle.on_startup("guardrails-policy", self.reload_guardrails,
                                  critical=False)

    def _load_persisted(self) -> None:
        base = self.cfg.persist_dir
        if not os.path.isdir(base):
            return
        for name in sorted(os.listdir(base)):
            d = os.path.join(base, name)
            if os.path.isdir(d) and os.path.exists(
                    os.path.join(d, "documents.json")):
                self.index(name, create=True).load(d)
                self.metrics.load_ops.inc()

    def _persist_all(self) -> None:
        with self.lock:
            for name, idx in self.indexes.items():
                idx.persist(os.path.join(self.cfg.persist_dir, name))
                self.metrics.persist_ops.inc()

    def _dense_factory(self):
        """Qdrant when its URL is set, else the flat index (``native``,
        ``faiss`` and any other engine): the ranking the reference's C++
        flat index gives, on the host."""
        if self.cfg.vector_db_engine == "qdrant" and self.cfg.vector_db_url:
            url = self.cfg.vector_db_url
            return lambda dim: QdrantDenseIndex(dim, url=url)
        return FlatDenseIndex

    def index(self, name: str, create: bool = False) -> VectorIndex:
        with self.lock:
            idx = self.indexes.get(name)
            if idx is None:
                if not create:
                    raise KeyError(f"index {name!r} not found")
                idx = VectorIndex(name, self.embedder,
                                  dense_factory=self._dense_factory())
                self.indexes[name] = idx
            return idx

    # guardrail reload (reference: guardrails/reload.py hot-reload watcher)
    def reload_guardrails(self) -> None:
        p = self.cfg.guardrails_policy_file
        if p and os.path.exists(p):
            self.guardrails = OutputGuardrails.from_policy_file(p)
            self.metrics.guardrail_reloads.inc()


class _TimedEmbedder:
    """Embedder wrapper feeding the embedding-stage metrics."""

    def __init__(self, inner, svc: "RAGService"):
        self._inner = inner
        self._svc = svc

    @property
    def dim(self):
        return self._inner.dim

    def embed(self, texts):
        m = self._svc.metrics
        m.embedding_requests.inc()
        m.embedding_texts.inc(len(texts))
        with Timed(m.embedding_seconds):
            return self._inner.embed(texts)


class RAGHandler(BaseHTTPRequestHandler):
    svc: RAGService
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _route(self) -> str:
        p = self.path
        if p.startswith("/v1/chat"):
            return "chat"
        if p == "/retrieve":
            return "retrieve"
        if p == "/index" or p.startswith("/indexes"):
            return "index"
        if p in ("/persist", "/load"):
            return "persistence"
        if p in ("/health", "/metrics"):
            return "system"
        return "other"

    def _record(self, code: int):
        route = self._route()
        if route == "system":
            return
        m = self.svc.metrics
        m.requests.inc(route=route, status=str(code))
        if code >= 400:
            m.errors.inc(route=route)
        if hasattr(self, "_t0"):
            m.request_seconds.observe(time.monotonic() - self._t0)

    def _json(self, code: int, obj):
        self._record(code)
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _err(self, code: int, msg: str):
        self._json(code, {"error": {"message": msg}})

    def _body(self) -> Optional[dict]:
        try:
            n = int(self.headers.get("Content-Length", "0"))
            return json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._err(400, "invalid JSON body")
            return None

    # ------------------------------------------------------------------

    def do_GET(self):
        self._t0 = time.monotonic()
        svc = self.svc
        if self.path == "/health":
            return self._json(200, {"status": "ok",
                                    "hooks": svc.lifecycle.report()})
        if self.path == "/metrics":
            body = svc.registry.expose().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path == "/indexes":
            with svc.lock:
                out = [{"name": n, "documents": len(ix.docs)}
                       for n, ix in sorted(svc.indexes.items())]
            return self._json(200, {"indexes": out})
        m = re.match(r"^/indexes/([^/]+)/documents(?:\?.*)?$", self.path)
        if m:
            try:
                idx = svc.index(m.group(1))
            except KeyError as e:
                return self._err(404, str(e))
            docs = [{"doc_id": d.doc_id, "text": d.text, "metadata": d.metadata}
                    for d in idx.list_documents()]
            return self._json(200, {"documents": docs})
        self._err(404, f"no route {self.path}")

    def do_DELETE(self):
        self._t0 = time.monotonic()
        m = re.match(r"^/indexes/([^/]+)/documents/([^/]+)$", self.path)
        if m:
            try:
                idx = self.svc.index(m.group(1))
            except KeyError as e:
                return self._err(404, str(e))
            n = idx.delete_documents([m.group(2)])
            self.svc.metrics.documents_deleted.inc(n)
            return self._json(200, {"deleted": n})
        m = re.match(r"^/indexes/([^/]+)$", self.path)
        if m:
            with self.svc.lock:
                if self.svc.indexes.pop(m.group(1), None) is None:
                    return self._err(404, f"index {m.group(1)!r} not found")
            return self._json(200, {"deleted": m.group(1)})
        self._err(404, f"no route {self.path}")

    def do_POST(self):
        self._t0 = time.monotonic()
        svc = self.svc
        if self.path == "/index":
            body = self._body()
            if body is None:
                return
            name = body.get("index_name")
            docs = body.get("documents", [])
            if not name or not isinstance(docs, list):
                return self._err(400, "index_name and documents required")
            texts = [d.get("text", "") if isinstance(d, dict) else str(d)
                     for d in docs]
            metas = [d.get("metadata", {}) if isinstance(d, dict) else {}
                     for d in docs]
            with Timed(svc.metrics.indexing_seconds):
                ids = svc.index(name, create=True).add_documents(texts, metas)
            svc.metrics.documents_indexed.inc(len(ids))
            return self._json(200, {"index_name": name, "doc_ids": ids})

        m = re.match(r"^/indexes/([^/]+)/documents/([^/]+)$", self.path)
        if m:  # update document
            body = self._body()
            if body is None:
                return
            try:
                idx = svc.index(m.group(1))
            except KeyError as e:
                return self._err(404, str(e))
            new_id = idx.update_document(m.group(2), body.get("text", ""),
                                         body.get("metadata"))
            svc.metrics.documents_updated.inc()
            return self._json(200, {"doc_id": new_id})

        if self.path == "/retrieve":
            body = self._body()
            if body is None:
                return
            name = body.get("index_name")
            query = body.get("query", "")
            if not name or not query:
                return self._err(400, "index_name and query required")
            try:
                idx = svc.index(name)
            except KeyError as e:
                return self._err(404, str(e))
            svc.metrics.retrieval_requests.inc()
            with Timed(svc.metrics.retrieval_seconds):
                hits = idx.retrieve(
                    query, top_k=int(body.get("top_k", svc.cfg.top_k)),
                    vector_weight=float(body.get("vector_weight",
                                                 svc.cfg.vector_weight)),
                    bm25_weight=float(body.get("bm25_weight",
                                               svc.cfg.bm25_weight)),
                    metadata_filter=body.get("metadata_filter"))
            svc.metrics.retrieved_documents.inc(len(hits))
            return self._json(200, {"results": hits})

        if self.path == "/persist":
            body = self._body()
            if body is None:
                return
            base = body.get("path") or svc.cfg.persist_dir
            with svc.lock:
                for name, idx in svc.indexes.items():
                    idx.persist(os.path.join(base, name))
                    svc.metrics.persist_ops.inc()
                names = sorted(svc.indexes)
            return self._json(200, {"persisted": names, "path": base})

        if self.path == "/load":
            body = self._body()
            if body is None:
                return
            base = body.get("path") or svc.cfg.persist_dir
            if not os.path.isdir(base):
                return self._err(404, f"no persisted data at {base}")
            loaded = []
            for name in sorted(os.listdir(base)):
                d = os.path.join(base, name)
                if os.path.isdir(d) and os.path.exists(
                        os.path.join(d, "documents.json")):
                    idx = svc.index(name, create=True)
                    idx.load(d)
                    svc.metrics.load_ops.inc()
                    loaded.append(name)
            return self._json(200, {"loaded": loaded})

        if self.path == "/v1/chat/completions":
            return self._chat()
        self._err(404, f"no route {self.path}")

    # ------------------------------------------------------------------

    def _chat(self):
        svc = self.svc
        if svc.llm is None:
            return self._err(503, "no LLM inference endpoint configured")
        body = self._body()
        if body is None:
            return
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            return self._err(400, "'messages' must be a non-empty list")
        index_name = body.pop("index_name", None)
        contexts = []
        if index_name:
            try:
                idx = svc.index(index_name)
            except KeyError as e:
                return self._err(404, str(e))
            query = next((m.get("content", "") for m in reversed(messages)
                          if m.get("role") == "user"), "")
            svc.metrics.retrieval_requests.inc()
            with Timed(svc.metrics.retrieval_seconds):
                contexts = idx.retrieve(query, top_k=int(body.pop(
                    "context_top_k", svc.cfg.top_k)))
            svc.metrics.retrieved_documents.inc(len(contexts))
        payload = dict(body)
        payload["messages"] = inject_context(messages, contexts,
                                             svc.llm.context_window)

        if body.get("stream"):
            self._record(200)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def send(obj):
                data = b"data: " + (obj if isinstance(obj, bytes)
                                    else json.dumps(obj).encode()) + b"\n\n"
                self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))

            svc.metrics.llm_requests.inc(mode="stream")
            guard = StreamingGuard(svc.guardrails)
            blocked = None
            for chunk in svc.llm.chat_stream(payload):
                svc.metrics.stream_chunks.inc()
                delta = (chunk.get("choices") or [{}])[0].get("delta", {})
                text = delta.get("content", "")
                if not svc.guardrails.enabled:
                    send(chunk)
                    continue
                safe, blocked = guard.feed(text)
                if blocked:
                    break
                if safe or delta.get("role"):
                    c2 = dict(chunk)
                    c2["choices"] = [dict(chunk["choices"][0])]
                    c2["choices"][0]["delta"] = {**delta, "content": safe} \
                        if "content" in delta else delta
                    send(c2)
            if svc.guardrails.enabled and not blocked:
                tail, blocked = guard.flush()
                if tail:
                    send({"choices": [{"index": 0, "delta": {"content": tail},
                                       "finish_reason": None}]})
            if blocked:
                svc.metrics.guardrail_blocked.inc()
                send({"choices": [{"index": 0, "delta": {
                    "content": BLOCK_MESSAGE.format(reason=blocked.reason)},
                    "finish_reason": "content_filter"}]})
            else:
                send({"choices": [{"index": 0, "delta": {},
                                   "finish_reason": "stop"}]})
            send(b"[DONE]")
            self.wfile.write(b"0\r\n\r\n")
            return

        import urllib.error

        svc.metrics.llm_requests.inc(mode="sync")
        try:
            with Timed(svc.metrics.llm_seconds):
                resp = svc.llm.chat(payload)
        except urllib.error.HTTPError as e:
            svc.metrics.llm_errors.inc()
            svc.metrics.errors.inc(route="chat")
            try:
                detail = json.loads(e.read()).get("error", {}).get("message", "")
            except Exception:
                detail = str(e)
            return self._err(502, f"upstream inference error ({e.code}): {detail}")
        except urllib.error.URLError as e:
            svc.metrics.llm_errors.inc()
            svc.metrics.errors.inc(route="chat")
            return self._err(502, f"upstream inference unreachable: {e.reason}")
        if svc.guardrails.enabled:
            content = (resp.get("choices") or [{}])[0].get(
                "message", {}).get("content", "")
            svc.metrics.guardrail_scans.inc()
            with Timed(svc.metrics.guardrail_seconds):
                verdict = svc.guardrails.guard(content)
            if not verdict.valid:
                svc.metrics.guardrail_blocked.inc()
                resp["choices"][0]["message"]["content"] = \
                    BLOCK_MESSAGE.format(reason=verdict.reason)
                resp["choices"][0]["finish_reason"] = "content_filter"
        if contexts:
            resp["retrieved_context"] = contexts
        self._json(200, resp)


def make_server(cfg: RAGConfig, host: str = "0.0.0.0",
                port: Optional[int] = None, device: str = "cuda") -> ThreadingHTTPServer:
    """The RAG service's HTTP server; a local embedding model runs on
    ``device``."""
    svc = RAGService(cfg, device=device)
    handler = type("Handler", (RAGHandler,), {"svc": svc})
    server = ThreadingHTTPServer((host, port if port is not None else cfg.port),
                                 handler)
    server.svc = svc  # type: ignore[attr-defined]
    return server


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kaito-tpu-torch-rag")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--device", default="cuda",
                    help="where a local embedding model runs: cuda (default) or "
                         "cpu; cuda without a usable card raises")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = RAGConfig.from_env()
    if args.port:
        cfg.port = args.port
    server = make_server(cfg, host=args.host, device=args.device)
    svc = server.svc  # type: ignore[attr-defined]
    svc.lifecycle.startup()
    svc.lifecycle.install_signal_handlers()
    logger.info("RAG service on %s:%d", args.host, cfg.port)
    try:
        server.serve_forever()
    finally:
        svc.lifecycle.shutdown()


if __name__ == "__main__":
    main()
