"""The RAG embedder on the card, held against the CPU.

These need an NVIDIA card and ``nvcc``; without one they skip.  On the
card (no JAX there, so without the suite's conftest):
``python -m pytest --noconftest tests/test_torch_cuda_rag.py``.

- ``LocalTorchEmbedder`` on ``tiny-llama-real``'s checkpoint (fp32) on
  the card and on the CPU: the same texts (the empty text, one past 256
  bytes, non-ASCII) give vectors within atol 1e-5, a row of no token at
  all (no visible key for the flash prefill kernel) gives the zero
  vector on both, and a list past one chunk of rows gives each text's
  own vector within 1e-6.
- Each forward launches the flash prefill kernel (K2) once a layer and
  never the plain ``prefill_attention``.
- The default device is the card.
"""

import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["", "naïve café — 東京 🚀", "x" * 400, "Paged attention stores the KV cache.",
         "LoRA trains low-rank adapters.", "a"]


@pytest.fixture(scope="module")
def pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++ for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    from kaito_tpu_torch.engine.model import TransformerLM
    from kaito_tpu_torch.engine.weights import load_safetensors_params
    from kaito_tpu_torch.models import get_model_by_name
    from kaito_tpu_torch.rag.embeddings import LocalTorchEmbedder

    md = get_model_by_name("tiny-llama-real")
    tree = load_safetensors_params(
        TransformerLM(md.arch, dtype=torch.float32, device="cpu"),
        os.path.join(REPO, "checkpoints", "tiny-llama-real"))
    return (LocalTorchEmbedder(md.name, device="cpu", params=tree),
            LocalTorchEmbedder(md.name, params=tree))


def test_card_matches_the_cpu(pair):
    cpu, card = pair
    assert card.device.type == "cuda"
    got, want = card.embed(TEXTS), cpu.embed(TEXTS)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_a_row_of_no_token_is_zero_on_both(pair):
    cpu, card = pair
    toks = torch.zeros((2, card.max_len), dtype=torch.int32)
    toks[1, :3] = torch.tensor([256, 72, 105])
    lens = torch.tensor([0, 3], dtype=torch.int32)
    with torch.inference_mode():
        got = card._forward(toks.cuda(), lens.cuda()).cpu()
        want = cpu._forward(toks, lens)
    assert torch.isfinite(got).all()
    assert float(got[0].abs().max()) == 0.0
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def _many():
    return [f"{TEXTS[i % len(TEXTS)]} #{i}" for i in range(70)]


def test_a_list_past_one_chunk_matches(pair):
    cpu, card = pair
    texts = _many()
    got = card.embed(texts)
    np.testing.assert_allclose(got, cpu.embed(texts), atol=1e-5, rtol=0)
    for i in (0, 63, 64, 69):
        np.testing.assert_allclose(got[i], card.embed([texts[i]])[0], atol=1e-6, rtol=0)


def test_each_forward_launches_k2_once_a_layer(pair, monkeypatch):
    from kaito_tpu_torch.engine import attention
    from kaito_tpu_torch.engine.ops import flash_prefill

    _, card = pair

    def plain(*a, **kw):
        raise AssertionError("the plain prefill_attention ran on the card")

    monkeypatch.setattr(attention, "prefill_attention", plain)
    k2 = flash_prefill.flash_prefill_attention_cuda
    n0, f0 = k2.launches, card.forwards
    card.embed(_many())
    forwards = card.forwards - f0
    assert forwards == 2
    assert k2.launches - n0 == card.model.arch.num_layers * forwards
