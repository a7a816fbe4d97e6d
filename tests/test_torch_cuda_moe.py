"""MoE serving on the card.

These need an NVIDIA card and ``nvcc``; without one they skip.  On the
card (no JAX there, so without the suite's conftest):
``python -m pytest --noconftest tests/test_torch_cuda_moe.py``.

- The captured decode windows emit the eager reference loop's greedy
  tokens (``_eager_decode=True``, the same seed and weights) on
  ``tiny-moe-real`` (fp32: the dense expert form; bf16: the grouped one)
  and on gpt-oss-20b's widths cut to two layers (bf16, synthetic).
- The grouped form's combine gives the same bits on two replays of one
  captured call, and the replay the eager call's bits.
- K1 and K1q at gpt-oss-20b's decode shape (64 query heads over 8 KV
  heads, head_dim 64), global and with a window of 128, against their
  plain versions, within the tolerances of
  ``tests/test_torch_cuda_kernels.py``.
"""

import dataclasses
import os

import pytest
import torch

pytestmark = pytest.mark.cuda

BIG = 1 << 30
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = [[(3 * i) % 250 + 2 for i in range(9)],
           [(5 * i) % 250 + 2 for i in range(150)],
           [(7 * i) % 250 + 2 for i in range(40)]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the decode window captures CUDA graphs)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _gpt_oss_two_layers():
    from kaito_tpu_torch.models.registry import get_model_by_name

    md = get_model_by_name("gpt-oss-20b")
    return dataclasses.replace(md, arch=dataclasses.replace(md.arch, num_layers=2))


def _engine(model, dtype, eager, **kw):
    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.engine import InferenceEngine

    md = _gpt_oss_two_layers() if model == "gpt-oss-20b" else None
    weights = ({} if md else
               dict(weights_dir=os.path.join(REPO, "checkpoints", model)))
    cfg = EngineConfig(model=model, dtype=dtype, kv_dtype=dtype, max_model_len=512,
                       page_size=16, max_num_seqs=4, prefill_buckets=(64, 256),
                       seed=0, enable_prefix_caching=False, max_pages=160,
                       decode_run_ahead=4, **weights, **kw)
    return InferenceEngine(cfg, metadata=md, device="cuda", _eager_decode=eager)


def _serve(eng, n=20):
    from kaito_tpu_torch.engine.engine import SamplingParams

    reqs = [eng.submit(list(p), SamplingParams(max_tokens=n + i, temperature=0.0,
                                               ignore_eos=True))
            for i, p in enumerate(PROMPTS)]
    for _ in range(2000):
        eng.step()
        if all(r.finish_reason for r in reqs):
            break
    assert all(r.finish_reason == "length" for r in reqs)
    return [r.output_tokens for r in reqs]


@pytest.mark.parametrize("model,dtype,impl", [
    ("tiny-moe-real", "float32", "dense"), ("tiny-moe-real", "bfloat16", "grouped"),
    ("gpt-oss-20b", "bfloat16", "grouped")])
def test_captured_windows_match_the_eager_loop(card, model, dtype, impl):
    want = _serve(_engine(model, dtype, eager=True))
    eng = _engine(model, dtype, eager=False)
    assert eng.model.moe_impl == impl and eng.window.capture
    assert _serve(eng) == want
    assert eng.counters["decode_graph_replays_total"] \
        == eng.counters["decode_windows_total"]


def test_grouped_combine_replays_bitwise(card):
    from kaito_tpu_torch.engine import nn
    from kaito_tpu_torch.models.registry import get_model_by_name

    arch = get_model_by_name("gpt-oss-20b").arch
    E, X, Im = arch.hidden_size, arch.num_experts, arch.moe_intermediate_size

    def rand(*shape):
        return (torch.randn(*shape, generator=card, device="cuda")
                / shape[-2] ** 0.5).to(torch.bfloat16)

    p = {"router": rand(E, X), "experts_gate": rand(X, E, Im),
         "experts_up": rand(X, E, Im), "experts_down": rand(X, Im, E)}
    x = torch.randn(8, E, generator=card, device="cuda").to(torch.bfloat16)
    valid = torch.tensor([True] * 5 + [False] * 3, device="cuda")
    eager = nn.moe_mlp_ragged(x, p, arch, grouped=True, valid=valid)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        nn.moe_mlp_ragged(x, p, arch, grouped=True, valid=valid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = nn.moe_mlp_ragged(x, p, arch, grouped=True, valid=valid)
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, out) and torch.equal(first, eager)
    assert torch.all(first[5:] == 0) and torch.isfinite(first).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["K1", "K1q"])
@pytest.mark.parametrize("window", [BIG, 128])
def test_decode_kernel_at_gpt_oss_shape(card, dtype, quant, window):
    """Eight sequences (one idle) over scattered pages of a two-layer
    pool, int8 codes with per-(page, head) scales for K1q.  K1q is held
    by each sequence's worst error relative to its largest magnitude, K1
    by that and the absolute error (``tests/test_torch_cuda_kernels.py``)."""
    from kaito_tpu_torch.engine.ops.decode_attention import (
        paged_decode_attention_cuda, paged_decode_attention_plain)

    lengths = [2048, 1, 37, 511, 129, 1536, 64, 0]
    B, H, Hkv, D, ps, pmax = len(lengths), 64, 8, 64, 64, 32
    P = B * pmax + 9
    q = torch.randn(B, H, D, generator=card, device="cuda").to(dtype)
    pools = [torch.randn(2, P, ps, Hkv, D, generator=card, device="cuda")
             for _ in range(2)]
    kw = dict(scale=D ** -0.5, layer=1)
    if quant:
        scales = [x.abs().amax(dim=(2, 4)) / 127.0 for x in pools]
        pools = [torch.round(x / s[:, :, None, :, None]).clamp(-127, 127).to(torch.int8)
                 for x, s in zip(pools, scales)]
        kw.update(k_scale=scales[0].contiguous(), v_scale=scales[1].contiguous())
    else:
        pools = [x.to(dtype) for x in pools]
    pt = (torch.randperm(P - 1, generator=card, device="cuda")[:B * pmax] + 1
          ).reshape(B, pmax).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out = paged_decode_attention_cuda(q, *pools, pt, lens, window, **kw)
    ref = paged_decode_attention_plain(q, *pools, pt, lens, window, **kw)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (B, H, D)
    diff = (out.float() - ref.float()).abs().flatten(1).amax(dim=1)
    rel = (diff / ref.float().abs().flatten(1).amax(dim=1).clamp_min(1e-30)).max()
    err = rel.item() if quant else max(rel.item(), diff.max().item())
    assert err <= ATOL[dtype]
