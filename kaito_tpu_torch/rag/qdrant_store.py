"""Qdrant backend over its REST API: dense + NATIVE server-side hybrid.

Parity with the reference's Qdrant store
(``presets/ragengine/vector_store/qdrant_store.py``, 568 LoC — its
headline feature is native dense+sparse hybrid search), minus the
client library: a urllib REST client implementing the dense-index
surface (add/remove/search/state/load_state) PLUS sparse named vectors
and a server-side hybrid query (Qdrant Query API prefetch + RRF
fusion), so fusion happens inside Qdrant instead of python-side BM25
merging when this backend is selected.

A copy of ``kaito_tpu.rag.qdrant_store``: the same REST bodies.
"""

from __future__ import annotations

import json
import logging
import re
import urllib.parse
import urllib.request
import uuid
from collections import Counter
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_SPARSE_DIM = 1 << 31


def sparse_terms(text: str) -> tuple[list[int], list[float]]:
    """Hash-bucketed term-frequency sparse vector (the IDF weighting
    happens server-side via Qdrant's sparse scoring).  Buckets use a
    STABLE hash — the vectors persist in Qdrant across process
    restarts, so the process-salted builtin hash() would break
    matching."""
    import zlib

    counts = Counter(re.findall(r"\w+", text.lower()))
    idx: dict[int, float] = {}
    for t, c in counts.items():
        bucket = zlib.crc32(t.encode()) % _SPARSE_DIM
        idx[bucket] = idx.get(bucket, 0.0) + float(c)
    indices = sorted(idx)
    return indices, [idx[i] for i in indices]


class QdrantDenseIndex:
    def __init__(self, dim: int, url: str = "http://127.0.0.1:6333",
                 collection: str = "kaito", api_key: str = ""):
        self.dim = dim
        self.base = url.rstrip("/")
        self.collection = collection
        self.api_key = api_key
        self._doc_to_point: dict[str, str] = {}
        self._point_to_doc: dict[str, str] = {}
        # legacy (pre-hybrid, unnamed-vector) collections keep working
        # dense-only; fresh collections get named dense+sparse
        self.supports_hybrid = True
        self._ensure_collection()

    # -- REST plumbing -------------------------------------------------

    def _req(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base + path, data=data, method=method,
            headers={"Content-Type": "application/json",
                     **({"api-key": self.api_key} if self.api_key else {})})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read() or b"{}")

    def _ensure_collection(self) -> None:
        try:
            self._req("PUT", f"/collections/{self.collection}", {
                "vectors": {"dense": {"size": self.dim, "distance": "Dot"}},
                "sparse_vectors": {"sparse": {}}})
        except urllib.error.HTTPError as e:
            if e.code != 409:  # already exists
                raise
            # existing collection: detect a legacy unnamed-vector schema
            # (created by the pre-hybrid release) and fall back to
            # dense-only instead of 400ing every write
            try:
                info = self._req("GET", f"/collections/{self.collection}")
                vectors = ((info.get("result") or {}).get("config") or {}) \
                    .get("params", {}).get("vectors", {})
                if "size" in vectors:     # unnamed schema
                    self.supports_hybrid = False
                    logger.warning(
                        "qdrant collection %r uses the legacy unnamed-"
                        "vector schema; native hybrid disabled (recreate "
                        "the collection to enable it)", self.collection)
            except urllib.error.HTTPError:
                pass

    # -- dense-index surface -------------------------------------------

    def add(self, doc_id: str, vec: np.ndarray,
            text: Optional[str] = None) -> None:
        point_id = self._doc_to_point.get(doc_id) or str(uuid.uuid4())
        self._doc_to_point[doc_id] = point_id
        self._point_to_doc[point_id] = doc_id
        dense = np.asarray(vec, np.float32).tolist()
        if not self.supports_hybrid:
            vectors = dense        # legacy unnamed schema
        else:
            vectors = {"dense": dense}
            if text is not None:
                indices, values = sparse_terms(text)
                vectors["sparse"] = {"indices": indices, "values": values}
        self._req("PUT", f"/collections/{self.collection}/points", {
            "points": [{"id": point_id, "vector": vectors,
                        "payload": {"doc_id": doc_id}}]})

    def remove(self, doc_id: str) -> None:
        point_id = self._doc_to_point.pop(doc_id, None)
        if point_id is None:
            return
        self._point_to_doc.pop(point_id, None)
        self._req("POST", f"/collections/{self.collection}/points/delete",
                  {"points": [point_id]})

    def _hits(self, result) -> list[tuple[str, float]]:
        if isinstance(result, dict):
            result = result.get("points", [])
        hits = []
        for r in result or []:
            doc = (r.get("payload") or {}).get("doc_id") \
                or self._point_to_doc.get(str(r.get("id")))
            if doc:
                hits.append((doc, float(r.get("score", 0.0))))
        return hits

    def search(self, query_vec: np.ndarray, top_k: int) -> list[tuple[str, float]]:
        dense = np.asarray(query_vec, np.float32).tolist()
        qspec = {"name": "dense", "vector": dense} \
            if self.supports_hybrid else dense
        out = self._req("POST", f"/collections/{self.collection}/points/search", {
            "vector": qspec, "limit": top_k, "with_payload": True})
        return self._hits(out.get("result", []))

    def hybrid_search(self, query_vec: np.ndarray, query_text: str,
                      top_k: int) -> list[tuple[str, float]]:
        """NATIVE hybrid: Qdrant fuses the dense and sparse rankings
        server-side (Query API prefetch + reciprocal-rank fusion) — the
        reference's qdrant_store.py headline behavior."""
        indices, values = sparse_terms(query_text)
        out = self._req("POST", f"/collections/{self.collection}/points/query", {
            "prefetch": [
                {"query": np.asarray(query_vec, np.float32).tolist(),
                 "using": "dense", "limit": top_k * 4},
                {"query": {"indices": indices, "values": values},
                 "using": "sparse", "limit": top_k * 4},
            ],
            "query": {"fusion": "rrf"},
            "limit": top_k,
            "with_payload": True})
        return self._hits(out.get("result", []))

    def state(self) -> dict:
        """Documents persist through the python store; vectors live in
        qdrant. Export ids only so persist/load keeps the id mapping."""
        return {"ids": list(self._doc_to_point),
                "vecs": np.zeros((0, self.dim), np.float32),
                "qdrant_points": dict(self._doc_to_point)}

    def load_state(self, state: dict) -> None:
        if "qdrant_points" in state:
            self._doc_to_point = dict(state["qdrant_points"])
            self._point_to_doc = {v: k for k, v in self._doc_to_point.items()}
            return
        for doc_id, vec in zip(state.get("ids", []),
                               np.asarray(state.get("vecs", []))):
            self.add(str(doc_id), vec)
