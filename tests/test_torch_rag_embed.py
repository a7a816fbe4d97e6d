"""The port's local embedder against the JAX package's, on the CPU.

``LocalTorchEmbedder(m, device="cpu", params=params_from_jax(...))``
holds the JAX ``LocalJaxEmbedder(m)``'s synthetic weights; both embed
the same texts (the empty text, one past ``max_len`` bytes, non-ASCII)
and the vectors must agree within atol 1e-5 (fp32).  Also: an unknown
model id falls back to ``tiny-llama-test`` in both, a list past one
chunk of rows gives the JAX embedder's one forward and each text's own
vector within 1e-6, a text with no tokens at all gives the JAX
embedder's vector, the default device raises where there is no card,
and ``make_embedder`` picks the same backend as the JAX one.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from kaito_tpu.rag import embeddings as jemb
from kaito_tpu.rag.config import RAGConfig as JaxRAGConfig
from kaito_tpu_torch.engine.model import params_from_jax
from kaito_tpu_torch.rag import embeddings as temb
from kaito_tpu_torch.rag.config import RAGConfig
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
MODELS = ("tiny-llama-test", "tiny-moe-real")
TEXTS = ("",
         "Paged attention stores the KV cache in fixed-size pages.",
         "naïve café — 東京の夜 🚀 Ünïcödé",
         "kubernetes " * 40,                       # 440 bytes: cut at 256 tokens
         "a",
         "LoRA fine-tuning trains low-rank adapter matrices.\n\tTabs and newlines.")


def _tree(jax_embedder):
    return params_from_jax(jax.tree.map(np.asarray, jax_embedder.params),
                           jax_embedder.model.arch)


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for m in MODELS:
        j = jemb.LocalJaxEmbedder(m)
        out[m] = (j, temb.LocalTorchEmbedder(m, device="cpu", params=_tree(j)))
    return out


@pytest.mark.parametrize("model", MODELS)
def test_vectors_match_jax(pairs, model):
    j, t = pairs[model]
    assert t.dim == j.dim == j.model.arch.hidden_size
    want, got = j.embed(list(TEXTS)), t.embed(list(TEXTS))
    assert got.shape == want.shape == (len(TEXTS), j.dim)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("model", MODELS)
def test_one_text_at_a_time_matches_the_batch(pairs, model):
    _, t = pairs[model]
    whole = t.embed(list(TEXTS))
    for i, text in enumerate(TEXTS):
        np.testing.assert_allclose(t.embed([text])[0], whole[i], atol=1e-6, rtol=0)


def test_a_list_past_one_chunk_matches(pairs):
    """70 texts: two forwards (64 + 6 rows) against the JAX embedder's one,
    and each row against the same text embedded alone."""
    j, t = pairs["tiny-llama-test"]
    texts = [f"{TEXTS[i % len(TEXTS)]} #{i}" for i in range(temb.MAX_CHUNK_ROWS + 6)]
    f0 = t.forwards
    got = t.embed(texts)
    assert t.forwards - f0 == 2
    np.testing.assert_allclose(got, j.embed(texts), atol=ATOL, rtol=0)
    for i in (0, 63, 64, 69):
        np.testing.assert_allclose(got[i], t.embed([texts[i]])[0], atol=1e-6, rtol=0)


def test_over_long_text_is_cut_at_max_len(pairs):
    j, t = pairs["tiny-llama-test"]
    long = "x" * 300
    cut = t.tokenizer.decode(t.tokenizer.encode(long)[:t.max_len])
    np.testing.assert_allclose(t.embed([long + "tail"]), t.embed([long]), atol=1e-6)
    np.testing.assert_allclose(t.embed([long]), j.embed([cut + "y" * 50]), atol=ATOL)


class _NoTokens:
    """A tokenizer that gives the empty text no token at all (no BOS)."""

    def encode(self, text):
        return list(text.encode())


@pytest.mark.parametrize("model", MODELS)
def test_a_text_of_no_tokens_matches_jax(pairs, model):
    j, t = pairs[model]
    texts = ["", "abc", ""]
    jt, tt = j.tokenizer, t.tokenizer
    j.tokenizer = t.tokenizer = _NoTokens()
    try:
        want, got = j.embed(texts), t.embed(texts)
    finally:
        j.tokenizer, t.tokenizer = jt, tt
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert not got[0].any() and not got[2].any()


def test_unknown_model_falls_back_in_both(pairs, caplog):
    j, _ = pairs["tiny-llama-test"]
    with caplog.at_level(logging.WARNING):
        jf = jemb.LocalJaxEmbedder("BAAI/bge-small-en-v1.5")
        tf = temb.LocalTorchEmbedder("BAAI/bge-small-en-v1.5", device="cpu",
                                     params=_tree(j))
    assert sum("unknown; using tiny fallback" in r.getMessage()
               for r in caplog.records) == 2
    assert tf.model_name == "tiny-llama-test"
    assert jf.model.arch == j.model.arch and tf.dim == jf.dim == 256
    np.testing.assert_allclose(tf.embed(list(TEXTS)), jf.embed(list(TEXTS)), atol=ATOL)


def test_synthetic_weights_are_seeded():
    a = temb.LocalTorchEmbedder("tiny-llama-test", device="cpu")
    b = temb.LocalTorchEmbedder("tiny-llama-test", device="cpu")
    v = a.embed(list(TEXTS))
    np.testing.assert_array_equal(v, b.embed(list(TEXTS)))
    assert np.isfinite(v).all()


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the CPU-only machine")
def test_default_device_raises_without_a_card():
    with pytest.raises(RuntimeError, match="cuda"):
        temb.LocalTorchEmbedder("tiny-llama-test")
    with pytest.raises(RuntimeError, match="cuda"):
        temb.make_embedder(RAGConfig(embedding_model_id="tiny-llama-test"))


def test_make_embedder_picks_the_jax_backend():
    cases = (dict(), dict(remote_embedding_url="http://127.0.0.1:9/v1",
                          llm_access_secret="s"),
             dict(embedding_model_id="tiny-llama-test"))
    for kw in cases:
        want = jemb.make_embedder(JaxRAGConfig(**kw))
        got = temb.make_embedder(RAGConfig(**kw), device="cpu")
        assert type(got).__name__ == type(want).__name__.replace("Jax", "Torch")
        assert got.dim == want.dim
        if kw.get("remote_embedding_url"):
            assert (got.url, got.secret) == (want.url, want.secret)


def test_hashing_embedder_matches_jax():
    rng = np.random.default_rng(3)
    words = ["alpha", "beta", "gamma", "TPU", "GPU", "kv", "cache", "naïve", "東京"]
    texts = [" ".join(rng.choice(words, size=int(rng.integers(0, 12))))
             for _ in range(40)] + list(TEXTS)
    for dim in (384, 64):
        np.testing.assert_array_equal(temb.HashingEmbedder(dim).embed(texts),
                                      jemb.HashingEmbedder(dim).embed(texts))
