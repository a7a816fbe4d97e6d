"""The port's RAG service against the JAX package's, over HTTP on the CPU.

Each RAG server fronts its own package's OpenAI server on
``tiny-llama-real`` in fp32 (its checkpoint in both), the embedder the
default hashing one.  The same HTTP sequence (index, list, retrieve with
weights and filters, update, delete, persist, load, the 4xx and 404
cases, chat streamed and not with retrieved context) gives equal status
codes and bodies on both: ids and chat ids masked, retrieval scores
within 1e-6, the greedy chat replies equal token for token.  ``/metrics``
carries the same ``kaito_rag:*`` series with the same counts.  Also:
a guardrails policy whose ``MaxLength`` is shorter than the reply blocks
both replies alike (streamed: the stream ends with the block message),
a service with no upstream answers 503 in both, a local embedder through
the app retrieves what the JAX one does, the configuration, lifecycle
and LLM client agree with the JAX ones, and ``python -m
kaito_tpu_torch.rag.app`` serves, persists its indexes on SIGTERM and
loads them at the next start.
"""

import copy
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.server import make_server as jax_engine_server
from kaito_tpu.rag import app as japp
from kaito_tpu.rag import config as jconfig
from kaito_tpu.rag import lifecycle as jlife
from kaito_tpu.rag import llm_client as jllm
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine
from kaito_tpu_torch.engine.model import params_from_jax
from kaito_tpu_torch.engine.server import make_server as engine_server
from kaito_tpu_torch.rag import app as tapp
from kaito_tpu_torch.rag import config as tconfig
from kaito_tpu_torch.rag import lifecycle as tlife
from kaito_tpu_torch.rag import llm_client as tllm
from kaito_tpu_torch.rag.embeddings import LocalTorchEmbedder
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UPSTREAM = dict(model="tiny-llama-real",
                weights_dir=os.path.join(REPO, "checkpoints", "tiny-llama-real"),
                max_model_len=1024, page_size=16, max_num_seqs=4, dtype="float32",
                kv_dtype="float32", prefill_buckets=(64, 256, 1024), seed=0,
                enable_prefix_caching=False)
SCORE_ATOL = 1e-6
DOCS = [
    "Kubernetes operators reconcile desired state with controllers.",
    "Paged attention stores the KV cache in fixed-size pages.",
    "The mitochondria is the powerhouse of the cell.",
    "LoRA fine-tuning trains low-rank adapter matrices.",
    "Hopper tensor cores run wgmma instructions from shared memory.",
    "BM25 ranks documents by keyword term frequency and rarity.",
    "A flat index compares the query with every stored vector.",
    "Guardrails scan a streamed reply in a sliding window.",
]
USER = [{"role": "user", "content": "What does paged attention store?"}]


class _Served:
    def __init__(self, server, engine=None):
        self.server, self.engine = server, engine
        self.base = f"http://127.0.0.1:{server.server_address[1]}"
        threading.Thread(target=server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        if self.engine is not None:
            self.engine.stop()


@pytest.fixture(scope="module")
def upstreams():
    jeng = JaxEngine(JaxConfig(**UPSTREAM))
    jeng.start()
    teng = InferenceEngine(EngineConfig(**UPSTREAM), device="cpu")
    teng.start()
    pair = (_Served(jax_engine_server(jeng, JaxConfig(**UPSTREAM), host="127.0.0.1",
                                      port=0), jeng),
            _Served(engine_server(teng, EngineConfig(**UPSTREAM), host="127.0.0.1",
                                  port=0, device="cpu"), teng))
    yield pair
    for s in pair:
        s.close()


def _rag_pair(upstreams, **kw):
    """(JAX RAG server, the port's), each over its own package's upstream
    (``upstream=False``: none), on the numpy flat index unless ``kw``
    names another engine."""
    with_llm = kw.pop("upstream", True)
    out = []
    for mod, cfgmod, up, extra in ((japp, jconfig, upstreams[0], {}),
                                   (tapp, tconfig, upstreams[1], {"device": "cpu"})):
        cfg = cfgmod.RAGConfig(**{**dict(
            llm_inference_url=up.base if with_llm else "", llm_context_window=200,
            persist_dir="", vector_db_engine="flat"), **kw})
        out.append(_Served(mod.make_server(cfg, host="127.0.0.1", port=0, **extra)))
    return out


def _call(base, method, path, body=None, raw=None):
    data = raw if raw is not None else (None if body is None else
                                        json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read().decode(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), e.headers.get("Content-Type")


def _masked(obj):
    """A body with what differs between any two servers masked: chat ids,
    creation times and the lifecycle hooks' seconds."""
    if isinstance(obj, dict):
        return {k: ("<masked>" if k in ("id", "created", "seconds") else _masked(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_masked(v) for v in obj]
    return obj


def _body(status, text, ctype):
    if ctype and ctype.startswith("text/event-stream"):
        events = [line[6:] for line in text.splitlines() if line.startswith("data: ")]
        return status, [e if e == "[DONE]" else _masked(json.loads(e)) for e in events]
    return status, _masked(json.loads(text))


def _close(got, want, path="$"):
    """Equal structures, the floats under ``score`` within SCORE_ATOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            if k == "score":
                assert abs(got[k] - want[k]) <= SCORE_ATOL, (path, got[k], want[k])
            else:
                _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def _id(text):
    from kaito_tpu_torch.rag.vector_store import doc_id_for

    return doc_id_for(text)


def _sequence(tmp):
    """(name, method, path, body or raw bytes): the same calls on both."""
    docs = [{"text": t, "metadata": {"team": ("infra", "ml")[i % 2], "i": i}}
            for i, t in enumerate(DOCS)]
    return [
        ("health", "GET", "/health", None),
        ("index", "POST", "/index", {"index_name": "kb", "documents": docs[:5]}),
        ("index-more", "POST", "/index", {"index_name": "kb",
                                          "documents": docs[5:] + ["a bare string doc"]}),
        ("index-other", "POST", "/index", {"index_name": "other",
                                           "documents": [{"text": DOCS[0]}]}),
        ("indexes", "GET", "/indexes", None),
        ("documents", "GET", "/indexes/kb/documents", None),
        ("documents-query", "GET", "/indexes/kb/documents?limit=2", None),
        ("documents-404", "GET", "/indexes/nope/documents", None),
        ("retrieve", "POST", "/retrieve", {"index_name": "kb",
                                           "query": "paged attention kv cache"}),
        ("retrieve-k", "POST", "/retrieve", {"index_name": "kb", "query": "cell",
                                             "top_k": 2}),
        ("retrieve-weights", "POST", "/retrieve", {
            "index_name": "kb", "query": "tensor cores shared memory",
            "vector_weight": 0.2, "bm25_weight": 0.8}),
        ("retrieve-filter", "POST", "/retrieve", {
            "index_name": "kb", "query": "index vector keyword",
            "metadata_filter": {"team": "ml"}}),
        ("retrieve-no-query", "POST", "/retrieve", {"index_name": "kb"}),
        ("retrieve-404", "POST", "/retrieve", {"index_name": "nope", "query": "x"}),
        ("index-no-name", "POST", "/index", {"documents": []}),
        ("index-not-a-list", "POST", "/index", {"index_name": "kb", "documents": "x"}),
        ("bad-json", "POST", "/index", b"{not json"),
        ("update", "POST", f"/indexes/kb/documents/{_id(DOCS[2])}", {
            "text": "Mitochondria make ATP for the cell.", "metadata": {"team": "bio"}}),
        ("update-404", "POST", "/indexes/nope/documents/x", {"text": "y"}),
        ("retrieve-updated", "POST", "/retrieve", {"index_name": "kb",
                                                   "query": "ATP cell"}),
        ("delete-doc", "DELETE", f"/indexes/kb/documents/{_id(DOCS[3])}", None),
        ("delete-doc-again", "DELETE", f"/indexes/kb/documents/{_id(DOCS[3])}", None),
        ("delete-doc-404", "DELETE", "/indexes/nope/documents/x", None),
        ("persist", "POST", "/persist", {"path": tmp}),
        ("delete-index", "DELETE", "/indexes/other", None),
        ("delete-index-404", "DELETE", "/indexes/other", None),
        ("load", "POST", "/load", {"path": tmp}),
        ("load-404", "POST", "/load", {"path": tmp + "-missing"}),
        ("indexes-after-load", "GET", "/indexes", None),
        ("retrieve-after-load", "POST", "/retrieve", {"index_name": "other",
                                                      "query": "operators"}),
        ("chat", "POST", "/v1/chat/completions", {
            "index_name": "kb", "messages": USER, "max_tokens": 12,
            "temperature": 0.0, "context_top_k": 2}),
        ("chat-no-index", "POST", "/v1/chat/completions", {
            "messages": USER, "max_tokens": 6, "temperature": 0.0}),
        ("chat-stream", "POST", "/v1/chat/completions", {
            "index_name": "kb", "messages": USER, "max_tokens": 12,
            "temperature": 0.0, "context_top_k": 2, "stream": True}),
        ("chat-no-messages", "POST", "/v1/chat/completions", {"messages": []}),
        ("chat-404", "POST", "/v1/chat/completions", {"index_name": "nope",
                                                      "messages": USER}),
        ("get-404", "GET", "/nope", None),
        ("post-404", "POST", "/nope", {}),
        ("delete-404", "DELETE", "/nope", None),
    ]


def _run(srv, tmp):
    got = {}
    for name, method, path, body in _sequence(tmp):
        raw = body if isinstance(body, bytes) else None
        status, text, ctype = _call(srv.base, method, path,
                                    None if raw is not None else body, raw)
        got[name] = _body(status, text.replace(tmp, "<dir>"), ctype)
    got["metrics"] = _call(srv.base, "GET", "/metrics")[1]
    return got


@pytest.fixture(scope="module")
def answers(upstreams, tmp_path_factory):
    out = {}
    for name, srv in zip(("jax", "torch"), _rag_pair(upstreams)):
        try:
            out[name] = _run(srv, str(tmp_path_factory.mktemp(name)))
        finally:
            srv.close()
    return out


CALLS = [name for name, *_ in _sequence("/x")]


@pytest.mark.parametrize("name", CALLS)
def test_call_matches_jax(answers, name):
    _close(answers["torch"][name], answers["jax"][name])


def test_the_sequence_did_what_it_says(answers):
    t = answers["torch"]
    statuses = {name: t[name][0] for name in CALLS}
    assert {n for n, s in statuses.items() if s == 404} == {
        n for n in CALLS if n.endswith("-404")}
    assert {n for n, s in statuses.items() if s == 400} == {
        "retrieve-no-query", "index-no-name", "index-not-a-list", "bad-json",
        "chat-no-messages"}
    assert t["retrieve"][1]["results"][0]["text"] == DOCS[1]
    assert all(h["metadata"]["team"] == "ml"
               for h in t["retrieve-filter"][1]["results"])
    assert t["delete-doc"][1] == {"deleted": 1} and t["delete-doc-again"][1] == {
        "deleted": 0}
    assert t["load"][1] == {"loaded": ["kb", "other"]}
    chat = t["chat"][1]
    assert chat["choices"][0]["message"]["content"]
    assert chat["usage"]["completion_tokens"] == 12
    assert [c["doc_id"] for c in chat["retrieved_context"]] == [
        h["doc_id"] for h in t["retrieve"][1]["results"][:2]]
    events = t["chat-stream"][1]
    assert events[-1] == "[DONE]"
    assert events[-2]["choices"][0]["finish_reason"] == "stop"


def test_greedy_replies_equal_token_for_token(answers):
    for name in ("chat", "chat-no-index"):
        jc, tc = (answers[k][name][1]["choices"][0]["message"]["content"]
                  for k in ("jax", "torch"))
        assert tc == jc
    streamed = [
        "".join(e["choices"][0]["delta"].get("content") or ""
                for e in answers[k]["chat-stream"][1] if e != "[DONE]")
        for k in ("jax", "torch")]
    assert streamed[1] == streamed[0]
    assert streamed[1] == answers["torch"]["chat"][1]["choices"][0]["message"]["content"]


def _series(text):
    """{series (name and labels): value} of the kaito_rag families."""
    out = {}
    for line in text.splitlines():
        if line.startswith("kaito_rag:"):
            key, val = line.rsplit(" ", 1)
            out[key] = float(val)
    return out


def test_metrics_carry_the_same_series(answers):
    js, ts = (_series(answers[k]["metrics"]) for k in ("jax", "torch"))
    assert set(ts) == set(js)
    families = {k.split("{")[0] for k in ts}
    assert {"kaito_rag:requests_total", "kaito_rag:embedding_texts_total",
            "kaito_rag:retrieval_seconds_count", "kaito_rag:documents_indexed_total",
            "kaito_rag:llm_requests_total", "kaito_rag:stream_chunks_total",
            "kaito_rag:documents", "kaito_rag:indexes"} <= families
    timed = ("_seconds_bucket", "_seconds_sum", "uptime_seconds")
    for key, val in ts.items():
        if not any(t in key.split("{")[0] for t in timed):
            assert val == js[key], key
    assert ts['kaito_rag:documents_indexed_total'] == len(DOCS) + 2
    assert ts['kaito_rag:requests_total{route="retrieve",status="200"}'] == 6


POLICY = """
output_scanners:
  - type: max_length
    max_chars: 10
stream_window: 4
"""


def test_guardrails_block_alike(upstreams, tmp_path):
    policy = tmp_path / "policy.yaml"
    policy.write_text(POLICY)
    pair = _rag_pair(upstreams, guardrails_policy_file=str(policy))
    got = []
    try:
        for srv in pair:
            index = _call(srv.base, "POST", "/index", {"index_name": "kb",
                                                        "documents": DOCS})
            sync = _body(*_call(srv.base, "POST", "/v1/chat/completions", {
                "index_name": "kb", "messages": USER, "max_tokens": 16,
                "temperature": 0.0}))
            stream = _body(*_call(srv.base, "POST", "/v1/chat/completions", {
                "index_name": "kb", "messages": USER, "max_tokens": 16,
                "temperature": 0.0, "stream": True}))
            metrics = _series(_call(srv.base, "GET", "/metrics")[1])
            got.append((index[0], sync, stream, metrics))
    finally:
        for srv in pair:
            srv.close()
    (_, jsync, jstream, jm), (status, tsync, tstream, tm) = got
    assert status == 200
    _close(tsync, jsync)
    _close(tstream, jstream)
    choice = tsync[1]["choices"][0]
    assert choice["finish_reason"] == "content_filter"
    assert choice["message"]["content"].startswith("Response blocked")
    last = tstream[1][-2]["choices"][0]
    assert last["finish_reason"] == "content_filter"
    assert last["delta"]["content"].startswith("Response blocked")
    for key in ("kaito_rag:guardrails_blocked_total", "kaito_rag:guardrails_scans_total",
                "kaito_rag:guardrails_policy_reloads_total", "kaito_rag:guardrails_enabled"):
        assert tm[key] == jm[key], key
    assert tm["kaito_rag:guardrails_blocked_total"] == 2


def test_no_upstream_answers_503_alike(upstreams):
    pair = _rag_pair(upstreams, upstream=False)
    try:
        got = [_body(*_call(s.base, "POST", "/v1/chat/completions", {"messages": USER}))
               for s in pair]
    finally:
        for s in pair:
            s.close()
    assert got[1] == got[0] and got[1][0] == 503


def test_a_local_embedder_through_the_app_matches_jax(upstreams):
    pair = _rag_pair(upstreams, embedding_model_id="tiny-llama-test")
    try:
        jsvc, tsvc = (s.server.svc for s in pair)
        inner = jsvc.embedder._inner
        tsvc.embedder._inner = LocalTorchEmbedder(
            "tiny-llama-test", device="cpu",
            params=params_from_jax(jax.tree.map(np.asarray, inner.params),
                                   inner.model.arch))
        got = []
        for srv in pair:
            _call(srv.base, "POST", "/index", {"index_name": "kb", "documents": DOCS})
            got.append([_body(*_call(srv.base, "POST", "/retrieve", {
                "index_name": "kb", "query": q, "top_k": 4}))
                for q in ("paged attention", DOCS[4], "adapter")])
    finally:
        for s in pair:
            s.close()
    for (ts, tb), (js, jb) in zip(got[1], got[0]):
        assert ts == js == 200
        assert [h["doc_id"] for h in tb["results"]] == [h["doc_id"] for h in jb["results"]]
        for a, b in zip(tb["results"], jb["results"]):
            assert abs(a["score"] - b["score"]) <= 1e-4
    assert got[1][1][1]["results"][0]["text"] == DOCS[4]


def _tied_by_id(hits):
    """Hits in score order, hits of one score by id."""
    return sorted(hits, key=lambda h: (-round(h["score"], 5), h["doc_id"]))


def test_the_default_engine_ranks_as_the_jax_native_index(upstreams):
    """Under the default ``native`` engine the JAX service takes its C++
    flat index and the port its numpy one: every document in the same
    order with the same score, up to the order of exact ties (documents
    that share no hashed feature with the query)."""
    assert tconfig.RAGConfig().vector_db_engine == "native"
    pair = _rag_pair(upstreams, vector_db_engine="native")
    try:
        from kaito_tpu_torch.rag.vector_store import FlatDenseIndex

        assert pair[1].server.svc._dense_factory() is FlatDenseIndex
        got = []
        for srv in pair:
            _call(srv.base, "POST", "/index", {"index_name": "kb", "documents": DOCS})
            got.append([_body(*_call(srv.base, "POST", "/retrieve", {
                "index_name": "kb", "query": q, "top_k": len(DOCS)}))
                for q in ("paged attention kv cache", "cell", "tensor cores memory")])
    finally:
        for s in pair:
            s.close()
    for (ts, tb), (js, jb) in zip(got[1], got[0]):
        assert ts == js == 200 and len(tb["results"]) == len(DOCS)
        _close(_tied_by_id(tb["results"]), _tied_by_id(jb["results"]))


def test_the_dense_factory_maps_every_engine():
    from kaito_tpu_torch.rag.qdrant_store import QdrantDenseIndex
    from kaito_tpu_torch.rag.vector_store import FlatDenseIndex

    for engine, url in (("native", ""), ("faiss", ""), ("flat", ""), ("qdrant", "")):
        svc = tapp.RAGService(tconfig.RAGConfig(vector_db_engine=engine,
                                                vector_db_url=url), device="cpu")
        assert svc._dense_factory() is FlatDenseIndex
    svc = tapp.RAGService(tconfig.RAGConfig(vector_db_engine="qdrant",
                                            vector_db_url="http://127.0.0.1:9"),
                          device="cpu")
    factory = svc._dense_factory()
    assert factory is not FlatDenseIndex and callable(factory)
    assert QdrantDenseIndex.__module__ == "kaito_tpu_torch.rag.qdrant_store"


def test_config_from_env_matches(monkeypatch):
    import dataclasses

    assert dataclasses.asdict(tconfig.RAGConfig()) == dataclasses.asdict(
        jconfig.RAGConfig())
    env = {"LLM_INFERENCE_URL": "http://ws:80/v1", "LLM_ACCESS_SECRET": "s3",
           "LLM_CONTEXT_WINDOW": "4096", "EMBEDDING_MODEL_ID": "qwen3-8b",
           "REMOTE_EMBEDDING_URL": "", "VECTOR_DB_ENGINE": "qdrant",
           "VECTOR_DB_URL": "http://qdrant:6333", "GUARDRAILS_POLICY_FILE": "/p.yaml",
           "RAG_PERSIST_DIR": "/data", "RAG_PORT": "5001"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dataclasses.asdict(tconfig.RAGConfig.from_env()) == dataclasses.asdict(
        jconfig.RAGConfig.from_env())
    monkeypatch.setenv("LLM_CONTEXT_WINDOW", "")
    assert tconfig.RAGConfig.from_env().llm_context_window == \
        jconfig.RAGConfig.from_env().llm_context_window == 8192


def test_lifecycle_matches():
    def run(mod):
        calls = []
        m = mod.LifecycleManager()
        m.on_startup("a", lambda: calls.append("a"))
        m.on_startup("soft", lambda: 1 / 0, critical=False)
        m.on_shutdown("z", lambda: calls.append("z"))
        m.on_shutdown("broken", lambda: 1 / 0)
        m.startup()
        m.shutdown()
        m.shutdown()
        hard = mod.LifecycleManager()
        hard.on_startup("hard", lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            hard.startup()
        return calls, len(m), _masked(m.report()), _masked(hard.report())

    assert run(tlife) == run(jlife)


def test_llm_client_matches():
    rng = np.random.default_rng(9)
    for _ in range(40):
        msgs = [{"role": r, "content": "x" * int(rng.integers(0, 900))}
                for r in rng.choice(["system", "user", "assistant"],
                                    size=int(rng.integers(1, 4)))]
        ctx = [{"text": "c" * int(rng.integers(1, 700))}
               for _ in range(int(rng.integers(0, 6)))]
        window = int(rng.choice([64, 200, 1024, 8192]))
        assert tllm.inject_context(copy.deepcopy(msgs), ctx, window) == \
            jllm.inject_context(copy.deepcopy(msgs), ctx, window)
        payload = {"messages": msgs, "max_tokens": rng.choice([None, 0, 5, 5000])}
        for base in ("http://h:1/v1", "http://h:1/"):
            tc, jc = tllm.LLMClient(base, "", window), jllm.LLMClient(base, "", window)
            assert tc.base_url == jc.base_url
            assert tc._clamp(payload) == jc._clamp(payload)
    assert tllm.CONTEXT_TEMPLATE == jllm.CONTEXT_TEMPLATE


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_health(base, proc, limit=120.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < limit:
        if proc.poll() is not None:
            raise AssertionError(f"the service exited: {proc.stderr.read()}")
        try:
            with urllib.request.urlopen(base + "/health", timeout=5) as r:
                return json.loads(r.read())
        except OSError:
            time.sleep(0.2)
    raise AssertionError("the service did not answer /health")


def test_the_module_serves_persists_on_sigterm_and_loads_at_start(tmp_path):
    env = dict(os.environ, RAG_PERSIST_DIR=str(tmp_path / "data"),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("LLM_INFERENCE_URL", "EMBEDDING_MODEL_ID", "REMOTE_EMBEDDING_URL",
              "GUARDRAILS_POLICY_FILE", "VECTOR_DB_ENGINE", "VECTOR_DB_URL"):
        env.pop(k, None)
    reports = []
    for round_ in range(2):
        port = _free_port()
        env["RAG_PORT"] = str(port)
        proc = subprocess.Popen([sys.executable, "-m", "kaito_tpu_torch.rag.app",
                                 "--host", "127.0.0.1"], env=env, cwd=str(tmp_path),
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        base = f"http://127.0.0.1:{port}"
        try:
            health = _wait_health(base, proc)
            reports.append([(h["name"], h["phase"], h["ran"]) for h in health["hooks"]])
            if round_ == 0:
                assert _call(base, "POST", "/index", {"index_name": "kb",
                                                      "documents": DOCS})[0] == 200
            else:
                status, text, _ = _call(base, "GET", "/indexes")
                assert json.loads(text) == {"indexes": [{"name": "kb",
                                                          "documents": len(DOCS)}]}
        finally:
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            proc.stdout.close()
            proc.stderr.close()
        assert rc == 0
        assert (tmp_path / "data" / "kb" / "documents.json").exists()
    assert reports[0] == reports[1] == [
        ("load-persisted-indexes", "startup", True), ("persist-indexes", "shutdown", False),
        ("guardrails-policy", "startup", True)]
