"""Embedding backends.

Parity with the reference's embedding layer (``presets/ragengine/
embedding/``): a local model on the card or a remote OpenAI-compatible
endpoint; a deterministic hashing embedder backs tests and card-free
environments.

``kaito_tpu.rag.embeddings`` for the port: :class:`HashingEmbedder` and
:class:`RemoteEmbedder` are copies, :class:`LocalTorchEmbedder` is the
counterpart of ``LocalJaxEmbedder`` on the port's ``TransformerLM``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import re
import urllib.request
from typing import Optional, Protocol, Sequence

import numpy as np
import torch

from kaito_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

# rows of one forward at most (each row max_len tokens)
MAX_CHUNK_ROWS = 64


class Embedder(Protocol):
    dim: int

    def embed(self, texts: Sequence[str]) -> np.ndarray: ...


class HashingEmbedder:
    """Deterministic feature-hashing embedder (tokenized character
    n-grams -> signed buckets, L2-normalized). No model weights, real
    cosine-similarity semantics — the test/default backend."""

    def __init__(self, dim: int = 384):
        self.dim = dim

    def _tokens(self, text: str):
        words = re.findall(r"\w+", text.lower())
        for w in words:
            yield w
        for w in words:
            for i in range(len(w) - 2):
                yield w[i:i + 3]

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for row, text in enumerate(texts):
            for tok in self._tokens(text):
                h = int.from_bytes(
                    hashlib.md5(tok.encode()).digest()[:8], "little")
                idx = h % self.dim
                sign = 1.0 if (h >> 63) & 1 == 0 else -1.0
                out[row, idx] += sign
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-9)


class LocalTorchEmbedder:
    """Mean-pooled transformer embedding on the card (the RAGEngine
    ``embedding.local`` path), ``LocalJaxEmbedder``'s contract.

    The model is the registry's ``model_id`` (an unknown id logs a
    warning and takes ``tiny-llama-test``) as an fp32 ``TransformerLM``
    with synthetic weights from seed 0, or the tree ``params`` (the
    names of :meth:`TransformerLM.load_params`).  Each text is its
    tokens cut to ``max_len`` and padded on the right to ``max_len``;
    the cache-less forward (mode "score": the flash prefill kernel once
    a layer on the card) gives the last layer's residual stream, with
    no final norm, whose valid rows are averaged and L2-normalized.

    A list is embedded in chunks of :data:`MAX_CHUNK_ROWS` rows, where
    the JAX embedder runs one forward over the whole list: every row is
    padded to ``max_len`` and attends only within itself, so its vector
    does not depend on the chunk it lands in.  ``forwards`` counts the
    forwards run."""

    def __init__(self, model_id: str, max_len: int = 256, *,
                 device: str | torch.device = "cuda", params: Optional[dict] = None):
        from kaito_tpu_torch.engine.model import TransformerLM
        from kaito_tpu_torch.engine.tokenizer import load_tokenizer
        from kaito_tpu_torch.models.registry import get_model_by_name

        self.device = resolve_device(device)
        try:
            md = get_model_by_name(model_id)
        except KeyError:
            md = get_model_by_name("tiny-llama-test")
            logger.warning("embedding model %s unknown; using tiny fallback",
                           model_id)
        self.model_name = md.name
        self.model = TransformerLM(md.arch, dtype=torch.float32, device=self.device)
        if params is None:
            self.model.init_params(seed=0)
        else:
            self.model.load_params(params)
        self.tokenizer = load_tokenizer(md.hf_id, md.arch.vocab_size)
        self.max_len = max_len
        self.dim = md.arch.hidden_size
        self.forwards = 0

    def _forward(self, tokens: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        m = self.model
        x, kw = m._score_in(tokens, lens)
        h = m._run_layers(None, x, "score", **kw)
        self.forwards += 1
        mask = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
                < lens[:, None])
        # a select, not a product: a pad row never reaches the sum
        pooled = torch.where(mask[..., None], h, 0.0).sum(1)
        pooled = pooled / lens.clamp_min(1)[:, None].to(pooled.dtype)
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return pooled / norm.clamp_min(1e-9)

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        B = len(texts)
        toks = np.zeros((B, self.max_len), np.int32)
        lens = np.zeros((B,), np.int32)
        for i, t in enumerate(texts):
            ids = self.tokenizer.encode(t)[: self.max_len]
            toks[i, : len(ids)] = ids
            lens[i] = len(ids)
        out = np.zeros((B, self.dim), np.float32)
        with torch.inference_mode():
            for s in range(0, B, MAX_CHUNK_ROWS):
                rows = slice(s, s + MAX_CHUNK_ROWS)
                tok = torch.from_numpy(toks[rows]).to(self.device)
                ln = torch.from_numpy(lens[rows]).to(self.device)
                out[rows] = self._forward(tok, ln).cpu().numpy()
        return out


class RemoteEmbedder:
    """OpenAI-compatible /v1/embeddings endpoint."""

    def __init__(self, url: str, access_secret: str = "", dim: int = 0):
        self.url = url.rstrip("/")
        self.secret = access_secret
        self.dim = dim

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        req = urllib.request.Request(
            self.url + "/v1/embeddings" if not self.url.endswith("embeddings")
            else self.url,
            data=json.dumps({"input": list(texts)}).encode(),
            headers={"Content-Type": "application/json",
                     **({"Authorization": f"Bearer {self.secret}"}
                        if self.secret else {})})
        with urllib.request.urlopen(req, timeout=60) as resp:
            data = json.loads(resp.read())
        vecs = np.asarray([d["embedding"] for d in data["data"]], np.float32)
        if not self.dim:
            self.dim = vecs.shape[1]
        return vecs


def make_embedder(cfg, device: str | torch.device = "cuda") -> Embedder:
    """The configured embedder; only a local model touches ``device``."""
    if cfg.remote_embedding_url:
        return RemoteEmbedder(cfg.remote_embedding_url, cfg.llm_access_secret)
    if cfg.embedding_model_id:
        return LocalTorchEmbedder(cfg.embedding_model_id, device=device)
    return HashingEmbedder()
