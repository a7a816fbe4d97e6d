"""The captured decode window on the card.

These need an NVIDIA card and ``nvcc``; without one they skip.  On the
card (no JAX there, so without the suite's conftest):
``python -m pytest --noconftest tests/test_torch_cuda_graphs.py``.

- The engine's captured windows emit the eager reference loop's greedy
  tokens (``_eager_decode=True``, the same seed and weights), in bf16
  and with int4 weights over int8 KV pages, sync and async, and the
  launch counters count each replay's kernels.
- A window replayed twice from the same inputs draws fresh noise, and
  two engines of one seed draw the same.
- A capture whose first decode-kernel call would allocate the kernel's
  workspace under capture still raises: the window's warm-up is what
  keeps it outside.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

BASE = dict(model="tiny-llama-test", max_model_len=256, page_size=16,
            max_num_seqs=4, dtype="bfloat16", prefill_buckets=(32, 64, 128),
            seed=0, enable_prefix_caching=False, max_pages=64)
PROMPTS = [[(3 * i) % 1900 + 2 for i in range(9)],
           [(5 * i) % 1900 + 2 for i in range(21)],
           [(7 * i) % 1900 + 2 for i in range(40)]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the decode window captures CUDA graphs)")
    return torch.device("cuda", torch.cuda.current_device())


def _mk(eager=False, **kw):
    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.engine import InferenceEngine

    return InferenceEngine(EngineConfig(**{**BASE, **kw}), device="cuda",
                           _eager_decode=eager)


def _serve(eng, n=24, **params):
    from kaito_tpu_torch.engine.engine import SamplingParams

    reqs = [eng.submit(list(p), SamplingParams(max_tokens=n + i, ignore_eos=True,
                                               **{"temperature": 0.0, **params}))
            for i, p in enumerate(PROMPTS)]
    for _ in range(2000):
        eng.step()
        if all(r.finish_reason for r in reqs):
            break
    assert all(r.finish_reason == "length" for r in reqs)
    return [r.output_tokens for r in reqs]


@pytest.mark.parametrize("quant,kv_dtype", [("", "bfloat16"), ("int4", "int8")])
@pytest.mark.parametrize("async_on", [False, True])
def test_captured_windows_match_the_eager_loop(card, quant, kv_dtype, async_on):
    from kaito_tpu_torch.engine.decode_graph import launch_counts

    kw = dict(quantization=quant, kv_dtype=kv_dtype, decode_run_ahead=4)
    want = _serve(_mk(eager=True, **kw))
    eng = _mk(async_dispatch=async_on, **kw)
    assert eng.window.capture
    before = launch_counts()
    got = _serve(eng)
    torch.cuda.synchronize()
    assert got == want
    stats = eng.window.stats()
    assert stats["captures"] >= 1 and stats["replays"] > stats["captures"]
    assert stats["pool_bytes"] > 0
    grown = {k: n - before[k] for k, n in launch_counts().items()}
    decode_counter = ("paged_decode_attention_cuda",
                      "launches_q" if kv_dtype == "int8" else "launches")
    per_step = eng.md.arch.num_layers
    # every captured window runs K1 once per layer and step, and each
    # replay counts them
    for g in stats["graphs"]:
        name = ".".join(decode_counter)
        assert g["launches"][name] == per_step * g["K"]
        assert g["nodes"]["kernel"] >= sum(g["launches"].values())
    assert grown[decode_counter] >= per_step * eng.counters["decode_steps_total"]


def test_replayed_window_draws_fresh_noise(card):
    import numpy as np

    def window_twice(eng):
        S = len(eng.slots)
        for i in range(S):
            eng.sampling.set_slot(i, temperature=1.0, top_k=0, top_p=1.0)
        eng.sampling.refresh()
        w = eng.window
        state = {"last_tokens": np.arange(S, dtype=np.int32) + 5,
                 "positions": np.full(S, 3, np.int32),
                 "active": np.ones(S, bool), "left": np.full(S, 100, np.int32),
                 "page_tables": np.arange(1, 1 + S * eng.pages_per_seq,
                                          dtype=np.int32).reshape(S, -1) % 60 + 1}
        key = (eng.sampling.gates(), False)
        outs = []
        for _ in range(2):
            w.upload(state)
            outs.append(w.run(4, key)[0].cpu().clone())
        return outs, w.stats()

    (a1, a2), stats = window_twice(_mk())
    assert stats["captures"] == 1 and stats["replays"] == 2
    assert not torch.equal(a1, a2)              # a replay draws anew
    (b1, b2), _ = window_twice(_mk())
    assert torch.equal(a1, b1) and torch.equal(a2, b2)   # one seed, one stream


def test_capture_before_the_warm_up_raises(card, monkeypatch):
    from kaito_tpu_torch.engine.engine import SamplingParams
    from kaito_tpu_torch.engine.ops import decode_attention as dec

    eng = _mk()
    # prefill only (one token): no decode window yet
    req = eng.submit(PROMPTS[0], SamplingParams(max_tokens=1, temperature=0.0))
    while not req.finish_reason:
        eng.step()
    assert eng.counters["decode_windows_total"] == 0
    monkeypatch.setattr(dec, "_WORKSPACES", {})
    w = eng.window
    out = w._outputs(1)
    side = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="outside CUDA graph capture"):
        with torch.cuda.graph(graph, stream=side):
            w._body(1, out)
    del graph
    torch.cuda.synchronize()
    # the window's own capture warms up first, and then replays
    got = _serve(eng, n=6)
    assert all(len(o) >= 6 for o in got)
    assert w.stats()["captures"] >= 1
    (ws,) = dec._WORKSPACES.values()
    assert ws.part is not None
