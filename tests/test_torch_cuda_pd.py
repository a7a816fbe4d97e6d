"""The P/D hand-off through the captured graphs, on the card.

These need an NVIDIA card and ``nvcc``; without one they skip.  On the
card (no JAX there, so without the suite's conftest):
``python -m pytest --noconftest tests/test_torch_cuda_pd.py``.

- An in-place import under replayed windows: ``tiny-llama-real`` (fp32,
  its checkpoint) decodes a sequence in captured windows while a second
  one's prompt arrives over the chunked wire from a prefill engine; the
  decode pool keeps its addresses, every window is a replay, the
  imported pages equal the staged slab, and both
  sequences' greedy tokens equal the same runs on the CPU.
- The colocated device hand-off: the decode engine's copy waits on the
  export's gather event (recorded on the prefill engine's stream) and
  the decode pool's pages equal the prefill pool's after it.
"""

import os
import threading

import pytest
import torch

pytestmark = pytest.mark.cuda

REAL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "checkpoints", "tiny-llama-real")
BASE = dict(model="tiny-llama-real", weights_dir=REAL, max_model_len=256, page_size=16,
            max_num_seqs=2, dtype="float32", kv_dtype="float32",
            prefill_buckets=(32, 64, 128), seed=0, decode_run_ahead=4, pd_enabled=True)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the decode window captures CUDA graphs)")
    return torch.device("cuda", torch.cuda.current_device())


def _greedy(n):
    from kaito_tpu_torch.engine.engine import SamplingParams

    return SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True)


def _engine(device):
    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.engine import InferenceEngine

    eng = InferenceEngine(EngineConfig(**BASE), device=device)
    eng.start()
    return eng


def _staged(pre, prompt):
    req = pre.submit(prompt, _greedy(1), export_kv=True)
    list(req.stream())
    return req, pre.kv_exports.pop(req.req_id)


LONG = [(5 * j) % 250 + 3 for j in range(30)]
PROMPT = [(3 * j) % 250 + 7 for j in range(40)]


def _cpu_reference():
    eng = _engine("cpu")
    try:
        a = eng.submit(LONG, _greedy(48))
        b = eng.submit(PROMPT, _greedy(12))
        return list(a.stream()), list(b.stream())
    finally:
        eng.stop()


def _spy_imports(monkeypatch, dec):
    """The decode pool's pages gathered right after each import into it."""
    import kaito_tpu_torch.engine.engine as em
    from kaito_tpu_torch.engine import pd

    seen, inner = [], pd.import_arrays

    def spy(cache, pages, *arrs, **kw):
        inner(cache, pages, *arrs, **kw)
        if cache is dec.cache:
            seen.append([t.clone() for t in pd._gather_canonical(cache, pages)
                         if t is not None])
    monkeypatch.setattr(em, "import_arrays", spy)
    return seen


def test_in_place_import_under_replayed_windows(card, monkeypatch):
    want = _cpu_reference()
    pre, dec = _engine("cuda"), _engine("cuda")
    try:
        seen = _spy_imports(monkeypatch, dec)
        ptrs = (dec.cache.k.data_ptr(), dec.cache.v.data_ptr())
        long_req = dec.submit(LONG, _greedy(48))
        it = long_req.stream()
        first = [next(it) for _ in range(8)]          # windows captured and replaying
        staged_req, exp = _staged(pre, PROMPT)
        slab = [t.clone() for t in exp.device_slabs()]
        req = dec.submit_with_kv_chunked(PROMPT, staged_req.output_tokens[0], exp.meta,
                                         exp.plans, _greedy(12))

        def feed():
            for i in range(exp.n_chunks):
                req.kv_chunked.feed(i, exp.get_chunk(i))
                dec._wake.set()
        feeder = threading.Thread(target=feed)
        feeder.start()
        got_b = list(req.stream())
        got_a = first + list(it)
        feeder.join()
        assert (got_a, got_b) == want
        assert (dec.cache.k.data_ptr(), dec.cache.v.data_ptr()) == ptrs
        assert dec.counters["decode_graph_replays_total"] >= \
            dec.counters["decode_windows_total"]
        assert len(seen) == 1
        assert all(torch.equal(a, b) for a, b in zip(seen[0], slab))
    finally:
        pre.stop()
        dec.stop()


def test_colocated_device_handoff_waits_on_the_gather_event(card, monkeypatch):
    pre, dec = _engine("cuda"), _engine("cuda")
    try:
        seen = _spy_imports(monkeypatch, dec)
        staged_req, exp = _staged(pre, PROMPT)
        assert exp.event is not None
        slab = [t.clone() for t in exp.device_slabs()]
        req = dec.submit_with_kv_device(PROMPT, staged_req.output_tokens[0], exp.meta,
                                        exp.device_slabs(), _greedy(12), event=exp.event)
        got = list(req.stream())
        assert dec.counters["pd_device_handoffs_total"] == 1
        assert dec.counters["prefill_steps_total"] == 0
        assert len(seen) == 1
        assert all(torch.equal(a, b) for a, b in zip(seen[0], slab))
        ref = _engine("cpu")
        try:
            assert got == list(ref.submit(PROMPT, _greedy(12)).stream())
        finally:
            ref.stop()
    finally:
        pre.stop()
        dec.stop()
