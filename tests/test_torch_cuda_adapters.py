"""Multi-LoRA serving through the captured graphs, on the card.

These need an NVIDIA card and ``nvcc``; without one they skip.  On the
card (no JAX there, so without the suite's conftest):
``python -m pytest --noconftest tests/test_torch_cuda_adapters.py``.

- A load that evicts, a fault back in and a DELETE capture no graph
  again: the count of captured graphs and every lane's address stay as
  they were, and the batch reruns to the same tokens.
- In fp32 (``tiny-llama-real``, its checkpoint) a mixed batch (base rows
  and two adapters) through the captured windows, sync and async, equals
  each row alone and the eager reference loop, token for token; an
  n-gram verify window with adapter rows is a graph keyed on its lanes
  and gives the plain engine's tokens.
"""

import math
import os

import pytest
import torch

pytestmark = pytest.mark.cuda

REAL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "checkpoints", "tiny-llama-real")
BASE = dict(model="tiny-llama-real", weights_dir=REAL, max_model_len=256, page_size=16,
            max_num_seqs=8, dtype="float32", kv_dtype="float32",
            prefill_buckets=(32, 64, 128), seed=0, enable_prefix_caching=False,
            max_pages=128, decode_run_ahead=4)
PROMPTS = [[(3 * i) % 250 + 2 for i in range(9)], [(5 * i) % 250 + 2 for i in range(21)]]
REPEAT = [7, 11, 13, 7, 11, 13, 7, 11, 13, 7, 11]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the decode window captures CUDA graphs)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def adapters(tmp_path):
    """Three adapters on every site of tiny-llama-real, written by the
    port's own ``save_adapter`` from seeded CPU draws (one at alpha/r =
    1.5)."""
    from kaito_tpu_torch.engine.model import TransformerLM
    from kaito_tpu_torch.models import get_model_by_name
    from kaito_tpu_torch.tuning.lora import ALL_TARGETS, LoraConfig, save_adapter

    model = TransformerLM(get_model_by_name("tiny-llama-real").arch, torch.float32,
                          "cpu")
    for k, (name, r, alpha) in enumerate((("a", 4, 6), ("b", 8, 8), ("c", 2, 4))):
        gen = torch.Generator().manual_seed(70 + k)
        tree = {}
        for g in model.groups:
            tree[g.name] = {}
            for t, (i, o) in model.lora_specs()[g.name].items():
                tree[g.name][f"{t}_lora_a"] = torch.randn(
                    (g.count, i, r), generator=gen) / math.sqrt(i)
                tree[g.name][f"{t}_lora_b"] = torch.randn(
                    (g.count, r, o), generator=gen) / math.sqrt(r)
        save_adapter(str(tmp_path / name), tree,
                     LoraConfig(r=r, alpha=alpha, targets=ALL_TARGETS), "tiny-llama-real")
    return tmp_path


def _mk(adapters, eager=False, **kw):
    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.engine import InferenceEngine

    cfg = {**BASE, "adapters_dir": str(adapters), "adapter_slots": 2, **kw}
    return InferenceEngine(EngineConfig(**cfg), device="cuda", _eager_decode=eager)


def _run(eng, rows, n=16):
    from kaito_tpu_torch.engine.engine import SamplingParams

    reqs = [eng.submit(list(p), SamplingParams(max_tokens=n, temperature=0.0,
                                               ignore_eos=True), adapter=a)
            for p, a in rows]
    for _ in range(3000):
        if all(r.finish_reason for r in reqs):
            break
        eng.step()
    assert all(r.finish_reason == "length" for r in reqs)
    return [r.output_tokens for r in reqs]


ROWS = [(p, a) for a in ("", "b", "c") for p in PROMPTS]


def _captures(eng):
    return sum(v for k, v in eng.counters.items() if k.endswith("_captures_total"))


def test_churn_captures_no_graph(card, adapters):
    eng = _mk(adapters)
    assert sorted(eng.adapter_index) == ["b", "c"]        # "a" went to the host tier
    want = _run(eng, ROWS)
    _run(eng, [(PROMPTS[0], "c")], n=4)               # b is now the least recent
    before = _captures(eng)
    ptrs = {k: t.data_ptr() for k, t in eng.model.lora["dense"].items()}
    eng.load_adapter_dynamic("a2", str(adapters / "a"))   # evicts b
    assert "b" not in eng.adapter_index
    assert _run(eng, ROWS) == want                     # b faults back in
    assert eng.adapter_cache.faults_total >= 1
    assert eng.delete_adapter("a2")
    assert _run(eng, ROWS) == want
    assert _captures(eng) == before
    assert {k: t.data_ptr() for k, t in eng.model.lora["dense"].items()} == ptrs
    c = eng.counters
    assert c["decode_graph_replays_total"] >= c["decode_windows_total"] > 0
    keys = [key for (_, key) in eng.window.graphs]
    assert any(k[-2] for k in keys)                   # a window read the lanes


@pytest.mark.parametrize("async_on", [False, True])
def test_mixed_window_equals_solo_in_fp32(card, adapters, async_on):
    eng = _mk(adapters, async_dispatch=async_on)
    mixed = _run(eng, ROWS)
    assert mixed == [_run(eng, [row])[0] for row in ROWS]
    assert mixed == _run(_mk(adapters, eager=True), ROWS)
    for j in range(2, len(ROWS)):
        assert mixed[j] != mixed[j % 2]
    c = eng.counters
    assert c["decode_graph_replays_total"] >= c["decode_windows_total"] > 0


def test_verify_graph_with_adapter_rows(card, adapters):
    rows = [(REPEAT, "b"), (REPEAT, ""), (REPEAT + [3, 5], "c")]
    want = _run(_mk(adapters), rows, n=24)
    eng = _mk(adapters, speculative_ngram=4, speculative_min_match=2)
    assert _run(eng, rows, n=24) == want
    v = eng.spec_verify.stats()
    assert eng.counters["spec_steps_total"] > 0
    assert v["replays"] == eng.counters["spec_steps_total"]
    assert eng.counters["spec_verify_eager_total"] == 0
    assert any(", True, None)" in g["key"] for g in v["graphs"])
