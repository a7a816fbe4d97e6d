"""RAGEngine kind (parity: ``api/v1beta1/ragengine_types.go:135-190``).

A copy of ``kaito_tpu.api.ragengine``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kaito_tpu_torch.api.meta import Condition, KaitoObject, ObjectMeta
from kaito_tpu_torch.api.workspace import ResourceSpec

COND_RAG_RESOURCE_READY = "ResourceReady"
COND_RAG_SERVICE_READY = "RAGEngineServiceReady"


@dataclass
class VectorDBSpec:
    engine: str = "faiss"              # faiss | qdrant | native
    url: str = ""
    access_secret: str = ""


@dataclass
class StorageSpec:
    persistent_volume: Optional[dict] = None
    vector_db: VectorDBSpec = field(default_factory=VectorDBSpec)


@dataclass
class LocalEmbedding:
    model_id: str = ""
    model_access_secret: str = ""


@dataclass
class RemoteEmbedding:
    url: str = ""
    access_secret: str = ""


@dataclass
class EmbeddingSpec:
    local: Optional[LocalEmbedding] = None
    remote: Optional[RemoteEmbedding] = None


@dataclass
class InferenceServiceSpec:
    url: str = ""
    access_secret: str = ""
    context_window_size: int = 0


@dataclass
class GuardrailsSpec:
    enabled: bool = False
    config_map_ref: str = ""


@dataclass
class RAGEngineSpec:
    compute: ResourceSpec = field(default_factory=ResourceSpec)
    storage: StorageSpec = field(default_factory=StorageSpec)
    embedding: EmbeddingSpec = field(default_factory=EmbeddingSpec)
    inference_service: InferenceServiceSpec = field(default_factory=InferenceServiceSpec)
    guardrails: GuardrailsSpec = field(default_factory=GuardrailsSpec)


@dataclass
class RAGEngineStatus:
    conditions: list[Condition] = field(default_factory=list)
    worker_nodes: list[str] = field(default_factory=list)


class RAGEngine(KaitoObject):
    kind = "RAGEngine"

    def __init__(self, meta: ObjectMeta, spec: Optional[RAGEngineSpec] = None):
        super().__init__(meta)
        self.spec = spec or RAGEngineSpec()
        self.status = RAGEngineStatus()

    def default(self) -> None:
        if not self.spec.storage.vector_db.engine:
            self.spec.storage.vector_db.engine = "faiss"

    def validate(self) -> list[str]:
        errs = []
        e = self.spec.embedding
        if (e.local is None) == (e.remote is None):
            errs.append("exactly one of embedding.local or embedding.remote required")
        if e.local is not None and not e.local.model_id:
            errs.append("embedding.local.modelID required")
        if e.remote is not None and not e.remote.url:
            errs.append("embedding.remote.url required")
        if not self.spec.inference_service.url:
            errs.append("inferenceService.url required")
        db = self.spec.storage.vector_db
        if db.engine not in ("faiss", "qdrant", "native"):
            errs.append(f"vectorDB.engine {db.engine!r} must be faiss|qdrant|native")
        if db.engine == "qdrant" and not db.url:
            errs.append("vectorDB.url required for qdrant")
        return errs
