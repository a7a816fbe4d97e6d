"""Vector stores + BM25 + hybrid retrieval.

Parity with the reference's vector-store layer
(``presets/ragengine/vector_store/**``): per-index document CRUD with
content-hash ids, dense retrieval, BM25 keyword retrieval, and hybrid
weighted fusion (vector 0.7 + BM25 0.3, the reference's
HybridRetriever weights) with optional metadata filters and
persist/load.  The dense index is a flat numpy index.

A copy of ``kaito_tpu.rag.vector_store``: the same ids, scores and
persisted layout (``documents.json`` and ``dense.npz``), so an index
persisted by either package loads in the other.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import threading
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np


def doc_id_for(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:24]


@dataclass
class Document:
    doc_id: str
    text: str
    metadata: dict = field(default_factory=dict)


def _tokenize(text: str) -> list[str]:
    return re.findall(r"\w+", text.lower())


class BM25:
    """Okapi BM25 over the index's documents."""

    K1 = 1.5
    B = 0.75

    def __init__(self):
        self.doc_tokens: dict[str, Counter] = {}
        self.doc_len: dict[str, int] = {}
        self.df: Counter = Counter()

    def add(self, doc_id: str, text: str) -> None:
        toks = Counter(_tokenize(text))
        self.doc_tokens[doc_id] = toks
        self.doc_len[doc_id] = sum(toks.values())
        for term in toks:
            self.df[term] += 1

    def remove(self, doc_id: str) -> None:
        toks = self.doc_tokens.pop(doc_id, None)
        self.doc_len.pop(doc_id, None)
        if toks:
            for term in toks:
                self.df[term] -= 1
                if self.df[term] <= 0:
                    del self.df[term]

    def scores(self, query: str) -> dict[str, float]:
        n = len(self.doc_tokens)
        if n == 0:
            return {}
        avg_len = sum(self.doc_len.values()) / n
        out: dict[str, float] = defaultdict(float)
        for term in _tokenize(query):
            df = self.df.get(term)
            if not df:
                continue
            idf = math.log(1 + (n - df + 0.5) / (df + 0.5))
            for doc_id, toks in self.doc_tokens.items():
                tf = toks.get(term, 0)
                if not tf:
                    continue
                denom = tf + self.K1 * (1 - self.B + self.B *
                                        self.doc_len[doc_id] / avg_len)
                out[doc_id] += idf * tf * (self.K1 + 1) / denom
        return dict(out)


class FlatDenseIndex:
    """Normalized-dot-product flat index over numpy, on the host (the
    ``native`` and ``faiss`` engines)."""

    def __init__(self, dim: int):
        self.dim = dim
        self._vecs = np.zeros((0, dim), np.float32)
        self._ids: list[str] = []
        self._pos: dict[str, int] = {}

    def add(self, doc_id: str, vec: np.ndarray) -> None:
        if doc_id in self._pos:
            self._vecs[self._pos[doc_id]] = vec
            return
        self._pos[doc_id] = len(self._ids)
        self._ids.append(doc_id)
        self._vecs = np.concatenate([self._vecs, vec[None]], axis=0)

    def remove(self, doc_id: str) -> None:
        pos = self._pos.pop(doc_id, None)
        if pos is None:
            return
        last = len(self._ids) - 1
        if pos != last:
            self._vecs[pos] = self._vecs[last]
            moved = self._ids[last]
            self._ids[pos] = moved
            self._pos[moved] = pos
        self._ids.pop()
        self._vecs = self._vecs[:last]

    def search(self, query_vec: np.ndarray, top_k: int) -> list[tuple[str, float]]:
        if not self._ids:
            return []
        sims = self._vecs @ query_vec
        k = min(top_k, len(self._ids))
        idx = np.argpartition(-sims, k - 1)[:k]
        idx = idx[np.argsort(-sims[idx])]
        return [(self._ids[i], float(sims[i])) for i in idx]

    def state(self) -> dict:
        return {"ids": list(self._ids), "vecs": self._vecs}

    def load_state(self, state: dict) -> None:
        self._ids = list(state["ids"])
        self._vecs = np.asarray(state["vecs"], np.float32)
        self._pos = {d: i for i, d in enumerate(self._ids)}


class VectorIndex:
    """One named index: documents + dense + bm25, hybrid retrieval.
    Thread-safe via a per-index lock (the reference uses per-index
    rwlocks, ``vector_store/base.py``)."""

    def __init__(self, name: str, embedder, dense_factory=FlatDenseIndex):
        self.name = name
        self.embedder = embedder
        self.docs: dict[str, Document] = {}
        self.dense = dense_factory(embedder.dim)
        self.bm25 = BM25()
        self.lock = threading.RLock()

    # -- CRUD ----------------------------------------------------------

    def add_documents(self, texts: Sequence[str],
                      metadatas: Optional[Sequence[dict]] = None) -> list[str]:
        metadatas = metadatas or [{} for _ in texts]
        vecs = self.embedder.embed(list(texts))
        hybrid = getattr(self.dense, "supports_hybrid", False)
        ids = []
        with self.lock:
            for text, meta, vec in zip(texts, metadatas, vecs):
                doc_id = doc_id_for(text)
                self.docs[doc_id] = Document(doc_id, text, dict(meta))
                if hybrid:
                    # backend indexes the sparse form itself (qdrant
                    # native hybrid); BM25 still feeds persistence-free
                    # fallback queries
                    self.dense.add(doc_id, vec, text=text)
                else:
                    self.dense.add(doc_id, vec)
                self.bm25.add(doc_id, text)
                ids.append(doc_id)
        return ids

    def update_document(self, doc_id: str, text: str,
                        metadata: Optional[dict] = None) -> str:
        with self.lock:
            self.delete_documents([doc_id])
        return self.add_documents([text], [metadata or {}])[0]

    def delete_documents(self, doc_ids: Sequence[str]) -> int:
        removed = 0
        with self.lock:
            for d in doc_ids:
                if d in self.docs:
                    del self.docs[d]
                    self.dense.remove(d)
                    self.bm25.remove(d)
                    removed += 1
        return removed

    def list_documents(self, limit: int = 100, offset: int = 0) -> list[Document]:
        with self.lock:
            all_ids = sorted(self.docs)
            return [self.docs[d] for d in all_ids[offset:offset + limit]]

    # -- retrieval -----------------------------------------------------

    @staticmethod
    def _minmax(scores: dict[str, float]) -> dict[str, float]:
        if not scores:
            return {}
        lo, hi = min(scores.values()), max(scores.values())
        if hi - lo < 1e-12:
            return {k: 1.0 for k in scores}
        return {k: (v - lo) / (hi - lo) for k, v in scores.items()}

    def retrieve(self, query: str, top_k: int = 5,
                 vector_weight: float = 0.7, bm25_weight: float = 0.3,
                 metadata_filter: Optional[dict] = None) -> list[dict]:
        """Hybrid retrieval: when the dense backend fuses natively
        (qdrant dense+sparse RRF server-side), its ranking is used
        as-is; otherwise weighted fusion of normalized dense + BM25
        scores (reference: hybrid_retriever.py 0.7/0.3 weighted mode)."""
        with self.lock:
            qv = self.embedder.embed([query])[0]
            # the native path fuses with RRF (no weights) and can't see
            # our metadata: custom weights or filters take the local
            # fusion path, which scores the whole corpus
            native_ok = (getattr(self.dense, "supports_hybrid", False)
                         and metadata_filter is None
                         and (vector_weight, bm25_weight) == (0.7, 0.3))
            if native_ok:
                ranked = self.dense.hybrid_search(qv, query, top_k * 4)
                out = []
                for doc_id, score in ranked:
                    doc = self.docs.get(doc_id)
                    if doc is None:
                        continue
                    if metadata_filter and any(
                            doc.metadata.get(k) != v
                            for k, v in metadata_filter.items()):
                        continue
                    out.append({"doc_id": doc_id, "text": doc.text,
                                "score": round(float(score), 6),
                                "metadata": doc.metadata})
                    if len(out) >= top_k:
                        break
                return out
            dense = dict(self.dense.search(qv, top_k * 4))
            sparse = self.bm25.scores(query)
            dn, sn = self._minmax(dense), self._minmax(sparse)
            fused: dict[str, float] = defaultdict(float)
            for d, s in dn.items():
                fused[d] += vector_weight * s
            for d, s in sn.items():
                fused[d] += bm25_weight * s
            out = []
            for doc_id, score in sorted(fused.items(), key=lambda kv: -kv[1]):
                doc = self.docs.get(doc_id)
                if doc is None:
                    continue
                if metadata_filter and any(
                        doc.metadata.get(k) != v
                        for k, v in metadata_filter.items()):
                    continue
                out.append({"doc_id": doc_id, "text": doc.text,
                            "score": round(float(score), 6),
                            "metadata": doc.metadata})
                if len(out) >= top_k:
                    break
            return out

    # -- persistence ---------------------------------------------------

    def persist(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        with self.lock:
            docs = [{"doc_id": d.doc_id, "text": d.text, "metadata": d.metadata}
                    for d in self.docs.values()]
            with open(os.path.join(directory, "documents.json"), "w") as f:
                json.dump({"name": self.name, "documents": docs}, f)
            np.savez(os.path.join(directory, "dense.npz"),
                     vecs=self.dense.state()["vecs"],
                     ids=np.asarray(self.dense.state()["ids"], dtype=object))

    def load(self, directory: str) -> None:
        with open(os.path.join(directory, "documents.json")) as f:
            data = json.load(f)
        with self.lock:
            self.docs = {}
            self.bm25 = BM25()
            for d in data["documents"]:
                doc = Document(d["doc_id"], d["text"], d.get("metadata", {}))
                self.docs[doc.doc_id] = doc
                self.bm25.add(doc.doc_id, doc.text)
            z = np.load(os.path.join(directory, "dense.npz"), allow_pickle=True)
            self.dense.load_state({"ids": list(z["ids"]), "vecs": z["vecs"]})
