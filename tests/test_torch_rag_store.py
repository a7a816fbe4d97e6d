"""The port's vector stores against the JAX package's, on the CPU.

- ``VectorIndex`` with ``HashingEmbedder``: the same add (with
  metadata), retrieve (hybrid at the default and other weights, dense
  and BM25 alone, metadata filters), update, delete and list sequence
  on both packages gives equal ids and scores within 1e-6; BM25, the
  flat index and ``doc_id_for`` agree on their own.
- Persistence: an index persisted by either package loads in the other
  and retrieves what the writer retrieves (both directions).
- ``QdrantDenseIndex`` against the in-process Qdrant fake of
  ``tests/test_qdrant_store.py``: the same REST sequence (upsert,
  search, native hybrid query, delete, legacy schema) gives the same
  hits, and ``sparse_terms`` the same buckets.
"""

import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from kaito_tpu.rag import qdrant_store as jq
from kaito_tpu.rag import vector_store as jvs
from kaito_tpu.rag.embeddings import HashingEmbedder as JaxHashing
from kaito_tpu_torch.rag import qdrant_store as tq
from kaito_tpu_torch.rag import vector_store as tvs
from kaito_tpu_torch.rag.embeddings import HashingEmbedder
from tests.test_qdrant_store import FakeQdrant

ATOL = 1e-6
TOPICS = ("kubernetes operators reconcile desired state",
          "paged attention stores the kv cache in pages",
          "lora trains low rank adapter matrices",
          "hopper tensor cores run wgmma from shared memory",
          "the mitochondria is the powerhouse of the cell",
          "bm25 scores keyword matches by term frequency")
FILLER = ("system", "latency", "cluster", "token", "model", "memory", "request",
          "schedule", "index", "vector", "shard", "replica")


def corpus(n=24, seed=0):
    rng = np.random.default_rng(seed)
    docs, metas = [], []
    for i in range(n):
        words = list(rng.choice(FILLER, size=int(rng.integers(3, 15))))
        docs.append(f"{TOPICS[i % len(TOPICS)]} {' '.join(words)} #{i}")
        metas.append({"team": ("infra", "ml", "web")[i % 3], "i": i})
    return docs, metas


QUERIES = (dict(query="how does paged attention manage the kv cache?"),
           dict(query="kubernetes controller reconcile", top_k=3),
           dict(query="mitochondria"),
           dict(query="adapter matrices", top_k=8, vector_weight=0.5, bm25_weight=0.5),
           dict(query="tensor cores", vector_weight=1.0, bm25_weight=0.0),
           dict(query="keyword term frequency", vector_weight=0.0, bm25_weight=1.0),
           dict(query="memory latency", metadata_filter={"team": "ml"}),
           dict(query="shard replica", top_k=50, metadata_filter={"team": "web", "i": 5}),
           dict(query="nothing matches zzzzqqq"),
           dict(query="index vector", top_k=1))


def _same_hits(got, want):
    assert [h["doc_id"] for h in got] == [h["doc_id"] for h in want]
    for g, w in zip(got, want):
        assert abs(g["score"] - w["score"]) <= ATOL
        assert (g["text"], g["metadata"]) == (w["text"], w["metadata"])


def _both(dense_j=jvs.FlatDenseIndex, dense_t=tvs.FlatDenseIndex):
    return (jvs.VectorIndex("t", JaxHashing(), dense_factory=dense_j),
            tvs.VectorIndex("t", HashingEmbedder(), dense_factory=dense_t))


def test_doc_id_and_tokenizer_match():
    docs, _ = corpus()
    for text in docs + ["", "naïve 東京", "A" * 1000]:
        assert tvs.doc_id_for(text) == jvs.doc_id_for(text)
        assert tvs._tokenize(text) == jvs._tokenize(text)


def test_bm25_matches():
    docs, _ = corpus()
    jb, tb = jvs.BM25(), tvs.BM25()
    for i, d in enumerate(docs):
        jb.add(f"d{i}", d)
        tb.add(f"d{i}", d)
    for i in (3, 7, 3):
        jb.remove(f"d{i}")
        tb.remove(f"d{i}")
    for q in QUERIES:
        assert tb.scores(q["query"]) == jb.scores(q["query"])
    assert tb.df == jb.df and tb.doc_len == jb.doc_len


def test_flat_index_matches():
    rng = np.random.default_rng(1)
    ji, ti = jvs.FlatDenseIndex(16), tvs.FlatDenseIndex(16)
    vecs = rng.standard_normal((30, 16)).astype(np.float32)
    for i, v in enumerate(vecs):
        ji.add(f"d{i}", v)
        ti.add(f"d{i}", v)
    for d in ("d4", "d29", "d0", "nope"):
        ji.remove(d)
        ti.remove(d)
    ji.add("d7", vecs[1])
    ti.add("d7", vecs[1])
    for q in rng.standard_normal((5, 16)).astype(np.float32):
        for k in (1, 5, 100):
            assert ti.search(q, k) == ji.search(q, k)
    js, ts = ji.state(), ti.state()
    assert ts["ids"] == js["ids"]
    np.testing.assert_array_equal(ts["vecs"], js["vecs"])


def test_crud_and_retrieval_sequence_matches():
    docs, metas = corpus()
    j, t = _both()
    ids = t.add_documents(docs[:16], metas[:16])
    assert ids == j.add_documents(docs[:16], metas[:16])
    assert t.add_documents(docs[16:], metas[16:]) == j.add_documents(docs[16:], metas[16:])
    for q in QUERIES:
        _same_hits(t.retrieve(**q), j.retrieve(**q))
    new_t = t.update_document(ids[2], "rewritten text about dogs and cats", {"team": "x"})
    assert new_t == j.update_document(ids[2], "rewritten text about dogs and cats",
                                      {"team": "x"})
    assert t.update_document("missing", "a new document") == \
        j.update_document("missing", "a new document")
    gone = [ids[0], ids[5], "not-an-id", ids[0]]
    assert t.delete_documents(gone) == j.delete_documents(gone) == 2
    for q in QUERIES + (dict(query="dogs and cats"), dict(query="x", metadata_filter={
            "team": "x"})):
        _same_hits(t.retrieve(**q), j.retrieve(**q))
    for limit, offset in ((100, 0), (5, 3), (10, 20)):
        got = [(d.doc_id, d.text, d.metadata) for d in t.list_documents(limit, offset)]
        want = [(d.doc_id, d.text, d.metadata) for d in j.list_documents(limit, offset)]
        assert got == want


def test_an_empty_index_retrieves_nothing():
    j, t = _both()
    assert t.retrieve("anything") == j.retrieve("anything") == []


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_persist_in_one_package_load_in_the_other(tmp_path, writer):
    docs, metas = corpus(30, seed=2)
    j, t = _both()
    src, dst = (j, t) if writer == "jax" else (t, j)
    src.add_documents(docs, metas)
    src.delete_documents([tvs.doc_id_for(docs[4])])
    src.persist(str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["dense.npz", "documents.json"]
    dst.load(str(tmp_path))
    assert set(dst.docs) == set(src.docs)
    for q in QUERIES:
        _same_hits(dst.retrieve(**q), src.retrieve(**q))
    # and the loaded index persists the same bytes of documents.json
    out = tmp_path / "again"
    dst.persist(str(out))
    assert (out / "documents.json").read_bytes() == \
        (tmp_path / "documents.json").read_bytes()


class LegacyQdrant(FakeQdrant):
    """The fake, where the collection already exists with the pre-hybrid
    unnamed-vector schema: a create answers 409 and the collection's info
    names one unnamed vector."""

    def do_PUT(self):
        parts = self.path.strip("/").split("/")
        if len(parts) == 2:
            self.store.setdefault(parts[1], {})
            return self._json(409, {"status": {"error": "already exists"}})
        return super().do_PUT()

    def do_GET(self):
        self._json(200, {"result": {"config": {"params": {"vectors": {
            "size": 4, "distance": "Dot"}}}}})


def _serve(cls):
    handler = type("H", (cls,), {"store": {}})
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(params=[FakeQdrant], ids=["fresh"])
def fakes(request):
    """Two fresh Qdrant fakes of one kind: one for each package."""
    served = [_serve(request.param) for _ in range(2)]
    yield [url for _, url in served]
    for server, _ in served:
        server.shutdown()
        server.server_close()


def test_sparse_terms_match():
    docs, _ = corpus()
    for text in docs + ["", "Repeat repeat REPEAT word", "naïve 東京 東京"]:
        assert tq.sparse_terms(text) == jq.sparse_terms(text)


def test_qdrant_dense_index_matches(fakes):
    rng = np.random.default_rng(4)
    ji = jq.QdrantDenseIndex(8, url=fakes[0])
    ti = tq.QdrantDenseIndex(8, url=fakes[1])
    assert ti.supports_hybrid == ji.supports_hybrid is True
    vecs = {f"d{i}": rng.standard_normal(8).astype(np.float32) for i in range(6)}
    for d, v in vecs.items():
        ji.add(d, v, text=f"doc {d} words")
        ti.add(d, v, text=f"doc {d} words")
    q = vecs["d3"]
    assert ti.search(q, 3) == ji.search(q, 3)
    assert ti.hybrid_search(q, "doc d2", 4) == ji.hybrid_search(q, "doc d2", 4)
    ji.remove("d3")
    ti.remove("d3")
    ti.remove("never-added")
    assert ti.search(q, 6) == ji.search(q, 6)
    assert sorted(ti.state()["ids"]) == sorted(ji.state()["ids"])


@pytest.mark.parametrize("fakes", [LegacyQdrant], ids=["legacy"], indirect=True)
def test_qdrant_legacy_collection_matches(fakes):
    """A collection that exists with the unnamed-vector schema turns
    native hybrid off in both; writes and searches go unnamed."""
    rng = np.random.default_rng(6)
    ji = jq.QdrantDenseIndex(4, url=fakes[0])
    ti = tq.QdrantDenseIndex(4, url=fakes[1])
    assert ti.supports_hybrid is ji.supports_hybrid is False
    vecs = rng.standard_normal((5, 4)).astype(np.float32)
    for i, v in enumerate(vecs):
        ji.add(f"d{i}", v, text="ignored")
        ti.add(f"d{i}", v, text="ignored")
    for q in vecs[:3]:
        assert ti.search(q, 3) == ji.search(q, 3)


def test_hybrid_store_over_qdrant_matches(fakes):
    docs, metas = corpus(18, seed=5)
    j = jvs.VectorIndex("q", JaxHashing(),
                        dense_factory=lambda dim: jq.QdrantDenseIndex(dim, url=fakes[0]))
    t = tvs.VectorIndex("q", HashingEmbedder(),
                        dense_factory=lambda dim: tq.QdrantDenseIndex(dim, url=fakes[1]))
    assert t.add_documents(docs, metas) == j.add_documents(docs, metas)
    # default weights, no filter: Qdrant's own fusion; else the local one
    for q in QUERIES:
        _same_hits(t.retrieve(**q), j.retrieve(**q))
    gone = [tvs.doc_id_for(docs[1]), tvs.doc_id_for(docs[2])]
    assert t.delete_documents(gone) == j.delete_documents(gone)
    for q in QUERIES[:4]:
        _same_hits(t.retrieve(**q), j.retrieve(**q))
