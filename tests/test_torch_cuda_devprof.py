"""Device-time attribution and the host KV tier through the captured
graphs, on the card.

These need an NVIDIA card and ``nvcc``; without one they skip.  On the
card (no JAX there, so without the suite's conftest):
``python -m pytest --noconftest tests/test_torch_cuda_devprof.py``.

- The sampler on replayed windows: the engine thread opens and closes a
  window while ``tiny-llama-real`` (fp32, its checkpoint) decodes eight
  sequences in captured windows; the window holds the paged decode
  kernel (K1) classified as attention, decode carries at least 95% of
  the busy time, the buckets sum to 100, and every window was a replay.
- A restore under replayed windows: the pair of ``tests/test_host_offload.py``
  in fp32 and with int8 KV through captured windows: the pool tensors
  keep their addresses, every window is a replay, the greedy tokens
  equal the same run's on the CPU (and, in fp32, the tier-off engine's),
  fewer prefill steps run than with the tier off, every page returns.
"""

import os
import threading
import time

import pytest
import torch

pytestmark = pytest.mark.cuda

REAL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "checkpoints", "tiny-llama-real")
BASE = dict(model="tiny-llama-real", weights_dir=REAL, max_model_len=256, page_size=16,
            max_num_seqs=8, dtype="float32", kv_dtype="float32",
            prefill_buckets=(32, 64, 128), seed=0, enable_prefix_caching=False,
            decode_run_ahead=4)
PAIR = dict(max_num_seqs=2, max_pages=10)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the decode window captures CUDA graphs)")
    return torch.device("cuda", torch.cuda.current_device())


def _greedy(n):
    from kaito_tpu_torch.engine.engine import SamplingParams

    return SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True)


def test_sampler_on_replayed_windows(card):
    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.engine import InferenceEngine

    eng = InferenceEngine(EngineConfig(**BASE, devprof_interval_s=3600.0,
                                       devprof_window_s=0.2), device="cuda")
    eng.start()
    try:
        reqs = [eng.submit([(7 * i + j) % 250 + 2 for j in range(20)], _greedy(200))
                for i in range(8)]
        threads = [threading.Thread(target=lambda r=r: list(r.stream()), daemon=True)
                   for r in reqs]
        for t in threads:
            t.start()
        # every sequence decoding, none prefilling
        for _ in range(2000):
            if all(len(r.output_tokens) >= 8 for r in reqs):
                break
            time.sleep(0.005)
        summary = eng.devprof.sample_window()
        for t in threads:
            t.join(timeout=120)
    finally:
        eng.stop()
    assert summary is not None and summary["n_slices"] > 0
    assert summary["n_tracks"] == 1
    assert sum(summary["bucket_pct"].values()) == pytest.approx(100.0, abs=0.01)
    busy = 100.0 - summary["bucket_pct"]["idle"]
    assert summary["phase_pct"]["decode"] >= 0.95 * busy
    assert summary["bucket_pct"]["attention"] > 0.0
    assert eng.counters["decode_graph_replays_total"] == eng.counters["decode_windows_total"]


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_restore_under_replayed_windows(card, kv):
    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.engine import InferenceEngine

    def run(device, tier):
        eng = InferenceEngine(EngineConfig(**{**BASE, **PAIR, "kv_dtype": kv},
                                           host_kv_offload_bytes=tier), device=device)
        c = eng.cache
        ptrs = [t.data_ptr() for t in (c.k, c.v)]
        reqs = [eng.submit([40, 41, 42] * 11, _greedy(100)),
                eng.submit([50, 51, 52] * 11, _greedy(40))]
        for _ in range(4000):
            if all(r.finish_reason for r in reqs):
                break
            eng.step()
        assert eng.cache is c and [t.data_ptr() for t in (c.k, c.v)] == ptrs
        if device == "cuda":
            assert eng.counters["decode_graph_replays_total"] == \
                eng.counters["decode_windows_total"]
        assert eng.allocator.available == eng.allocator.num_pages - 1
        return [list(r.output_tokens) for r in reqs], eng.counters

    got, on = run("cuda", 256 << 20)
    # the same run on the CPU (which the CPU tests hold against the JAX
    # engine's), token for token
    assert got == run("cpu", 256 << 20)[0]
    assert on["preemptions_total"] >= 1 and on["host_kv_restored_pages_total"] >= 1
    want, off = run("cuda", 0)
    assert on["prefill_steps_total"] < off["prefill_steps_total"]
    if kv == "float32":
        # a restore gives the recompute's tokens
        assert got == want
