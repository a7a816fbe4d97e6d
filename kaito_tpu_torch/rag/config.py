"""RAG service configuration — env-driven, same contract the RAGEngine
controller renders into the Deployment (reference:
``presets/ragengine/config.py`` consuming the env block from
``pkg/ragengine/manifests/manifests.go:155``).

A copy of ``kaito_tpu.rag.config``: the same fields, defaults and
variables."""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class RAGConfig:
    llm_inference_url: str = ""
    llm_access_secret: str = ""
    llm_context_window: int = 8192
    embedding_model_id: str = ""
    remote_embedding_url: str = ""
    vector_db_engine: str = "native"      # native (flat) | faiss | qdrant
    vector_db_url: str = ""
    guardrails_policy_file: str = ""
    persist_dir: str = "/mnt/rag-data"
    port: int = 5000
    top_k: int = 5
    vector_weight: float = 0.7            # hybrid fusion weights
    bm25_weight: float = 0.3

    @staticmethod
    def from_env() -> "RAGConfig":
        e = os.environ.get
        return RAGConfig(
            llm_inference_url=e("LLM_INFERENCE_URL", ""),
            llm_access_secret=e("LLM_ACCESS_SECRET", ""),
            llm_context_window=int(e("LLM_CONTEXT_WINDOW", "0") or 8192),
            embedding_model_id=e("EMBEDDING_MODEL_ID", ""),
            remote_embedding_url=e("REMOTE_EMBEDDING_URL", ""),
            vector_db_engine=e("VECTOR_DB_ENGINE", "native"),
            vector_db_url=e("VECTOR_DB_URL", ""),
            guardrails_policy_file=e("GUARDRAILS_POLICY_FILE", ""),
            persist_dir=e("RAG_PERSIST_DIR", "/mnt/rag-data"),
            port=int(e("RAG_PORT", "5000")),
        )
