"""The RAGEngine's runtime: the RAG service (``app``), its embedders,
hybrid vector stores, output guardrails and the chat passthrough to the
inference server."""
