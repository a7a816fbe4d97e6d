"""Async decode dispatch (M13) in the port, on the CPU.

The two-deep pipeline feeds window N+1 from window N's final carry,
still in the decode window's static buffers, while the host replays
window N's trace; any host-side batch change drains it first.  It must
be observationally the synchronous loop:

- against the JAX package: on the same weights (``params_from_jax``),
  the port's async engine emits the JAX engine's async greedy tokens at
  ``decode_run_ahead`` 4 and 1 (the prompts of
  ``tests/test_async_dispatch.py``);
- against the port's own synchronous loop: the same tokens and
  logprobs, bit for bit, greedy and sampled from one seed; the
  ``tiny-llama-real`` goldens (``fp32``, ``kv_int8``) replay through it
  (tokens exact, logprobs within atol 2e-3, as
  ``tests/test_real_checkpoint.py``); a stop token mid-window, an abort
  and a preemption with a window in flight end where the synchronous
  loop ends;
- at tensor_parallel 2 (a mesh of two CPU slots, with the comm-overlap
  ring), where the decode window runs eagerly, the async loop emits the
  synchronous loop's tokens too;
- in steady state nothing crosses to the device: ``h2d_uploads_total``
  stays flat over more than 100 dispatches;
- the gate: the config wins over ``KAITO_ASYNC_DISPATCH``, and the
  server's ``--async-dispatch`` reaches it.
"""

import json
import os

import jax
import numpy as np
import pytest

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.engine import SamplingParams as JaxParams
from kaito_tpu_torch.engine import server as tserver
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.model import params_from_jax
from kaito_tpu_torch.models import get_model_by_name
from kaito_tpu_torch.parallel.mesh import build_mesh
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(REPO, "tests", "testdata", "goldens_tiny-llama-real.json")

BASE = dict(model="tiny-llama-test", max_model_len=256, page_size=16,
            max_num_seqs=4, dtype="float32", kv_dtype="float32",
            prefill_buckets=(32, 64, 128), decode_run_ahead=4)
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11], list(range(20, 45))]


def _greedy(n, **kw):
    return SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True, **kw)


def _mk(async_on, params=None, **kw):
    return InferenceEngine(EngineConfig(**{**BASE, "async_dispatch": async_on, **kw}),
                           params=params, device="cpu")


def _drive(eng, reqs, max_steps=3000):
    for _ in range(max_steps):
        eng.step()
        if all(r.finish_reason for r in reqs):
            break
    assert all(r.finish_reason for r in reqs)
    return [list(r.output_tokens) for r in reqs]


def _run(eng, prompts, params):
    return _drive(eng, [eng.submit(list(p), params) for p in prompts])


@pytest.mark.parametrize("run_ahead,prompts,n", [
    (4, PROMPTS, 24),
    (1, [[2, 4, 6], [9, 9, 1, 1]], 16),
])
def test_matches_the_jax_async_engine(run_ahead, prompts, n):
    jeng = JaxEngine(JaxConfig(**{**BASE, "decode_run_ahead": run_ahead,
                                  "async_dispatch": True}))
    assert jeng.async_dispatch
    jp = JaxParams(max_tokens=n, temperature=0.0, ignore_eos=True)
    jreqs = [jeng.submit(list(p), jp) for p in prompts]
    want = _drive(jeng, jreqs)
    arch = get_model_by_name(BASE["model"]).arch
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params), arch)
    eng = _mk(True, params=params, decode_run_ahead=run_ahead)
    assert eng.async_dispatch
    assert _run(eng, prompts, _greedy(n)) == want
    assert all(len(o) == n for o in want)


@pytest.mark.parametrize("run_ahead", [4, 1])
@pytest.mark.parametrize("sampled", [False, True])
def test_bit_identical_to_the_sync_loop(run_ahead, sampled):
    def serve(async_on):
        eng = _mk(async_on, decode_run_ahead=run_ahead, seed=5)
        params = [SamplingParams(max_tokens=18 + i, ignore_eos=True, logprobs=True,
                                 temperature=0.9 if sampled else 0.0,
                                 top_k=30 if sampled and i % 2 else 0,
                                 repetition_penalty=1.2 if i == 1 else 1.0)
                  for i in range(len(PROMPTS))]
        reqs = [eng.submit(list(p), sp) for p, sp in zip(PROMPTS, params)]
        _drive(eng, reqs)
        return [(r.output_tokens, r.output_logprobs) for r in reqs], eng

    want, _ = serve(False)
    got, eng = serve(True)
    assert got == want
    assert eng.counters["h2d_uploads_total"] > 0
    assert eng.dispatch_gap_hist.count > 0


@pytest.mark.parametrize("kv_dtype,section", [("float32", "fp32"), ("int8", "kv_int8")])
def test_goldens_replay_through_the_async_loop(kv_dtype, section):
    cfg = EngineConfig(model="tiny-llama-real",
                       weights_dir=os.path.join(REPO, "checkpoints", "tiny-llama-real"),
                       dtype="float32", kv_dtype=kv_dtype, max_model_len=512,
                       max_num_seqs=2, prefill_buckets=(64, 128),
                       enable_prefix_caching=False, seed=0, decode_run_ahead=4,
                       async_dispatch=True)
    eng = InferenceEngine(cfg, device="cpu")
    golden = json.load(open(GOLDENS))
    # one prompt at a time, as the goldens were made (batched int8
    # prefill scales pages over the batch)
    for p in golden["prompts"]:
        want = p[section]
        req = eng.submit(list(p["prompt_tokens"]),
                         _greedy(len(want["greedy_tokens"]), logprobs=True))
        assert _drive(eng, [req])[0] == want["greedy_tokens"], p["text"]
        np.testing.assert_allclose(req.output_logprobs, want["logprobs"],
                                   rtol=0, atol=2e-3, err_msg=p["text"])
    assert eng.counters["decode_windows_total"] < eng.counters["decode_steps_total"]


def test_stop_token_mid_window():
    ref = _run(_mk(False), [[3, 1, 4, 1, 5]], _greedy(32))[0]
    stop = ref[7]
    first = ref.index(stop)
    p = _greedy(32, stop_token_ids=(stop,))
    eng = _mk(True)
    assert _run(_mk(False), [[3, 1, 4, 1, 5]], p)[0] == ref[:first + 1]
    req = eng.submit([3, 1, 4, 1, 5], p)
    assert _drive(eng, [req])[0] == ref[:first + 1]
    assert req.finish_reason == "stop"
    for _ in range(5):
        eng.step()
    assert eng.num_running == 0 and eng._inflight is None
    assert eng.allocator.available == eng.allocator.num_pages - 1


def test_abort_with_a_window_in_flight():
    p = _greedy(40)
    ref = _run(_mk(False), [[2, 4, 6]], p)[0]
    eng = _mk(True)
    victim = eng.submit([9, 8, 7], p)
    keeper = eng.submit([2, 4, 6], p)
    for _ in range(60):
        eng.step()
        if eng._inflight is not None:
            break
    assert eng._inflight is not None
    eng.abort(victim)
    _drive(eng, [victim, keeper])
    assert victim.aborted and len(victim.output_tokens) < 40
    assert keeper.output_tokens == ref
    assert eng.allocator.available == eng.allocator.num_pages - 1


def test_preemption_with_a_window_in_flight():
    """Too few pages for four sequences: preemption with the pipeline
    primed must reconcile every token in flight into the victim's resume
    tokens, and every request ends with the synchronous loop's tokens."""
    kw = dict(max_model_len=128, max_pages=14, prefill_buckets=(32, 64))
    prompts = [[10 + i, 20 + i, 30 + i] for i in range(4)]
    want = _run(_mk(False, **kw), prompts, _greedy(60))
    eng = _mk(True, **kw)
    assert _run(eng, prompts, _greedy(60)) == want
    assert eng.counters["preemptions_total"] > 0


def test_tp2_async_matches_the_sync_loop():
    def serve(async_on):
        eng = InferenceEngine(EngineConfig(**{**BASE, "async_dispatch": async_on,
                                              "tensor_parallel": 2,
                                              "comm_overlap": True}),
                              device="cpu", mesh=build_mesh(tensor=2,
                                                            devices=["cpu", "cpu"]))
        assert eng.comm_overlap and not eng.window.capture
        return _run(eng, PROMPTS[:3], _greedy(12))

    assert serve(True) == serve(False)


def test_h2d_uploads_flat_in_steady_state():
    """Page size 1024: no page growth for thousands of steps, so the
    steady state is steady; over 120 dispatches nothing is uploaded."""
    eng = _mk(True, max_model_len=4096, page_size=1024, max_num_seqs=2,
              prefill_buckets=(32,), decode_run_ahead=1)
    eng.submit([1, 2, 3], _greedy(3000))
    for _ in range(40):
        eng.step()
        if eng._inflight is not None:
            break
    assert eng._inflight is not None
    before = eng.counters["h2d_uploads_total"]
    windows = eng.counters["decode_windows_total"]
    gaps = eng.dispatch_gap_hist.count
    for _ in range(120):
        eng.step()
    assert eng.counters["h2d_uploads_total"] == before
    assert eng.counters["decode_windows_total"] - windows >= 100
    assert eng.dispatch_gap_hist.count - gaps >= 100


def test_flag_resolution(monkeypatch):
    monkeypatch.setenv("KAITO_ASYNC_DISPATCH", "1")
    assert _mk(None).async_dispatch is True
    assert _mk(False).async_dispatch is False
    monkeypatch.setenv("KAITO_ASYNC_DISPATCH", "")
    assert _mk(None).async_dispatch is False
    assert _mk(True).async_dispatch is True
    off = _mk(False)
    assert off.dispatch_gap_hist is None and "h2d_uploads_total" not in off.counters
    with pytest.raises(ValueError, match="synchronous"):
        InferenceEngine(EngineConfig(**{**BASE, "async_dispatch": True}),
                        device="cpu", _eager_decode=True)


def test_server_flag_reaches_the_engine_config(monkeypatch):
    monkeypatch.delenv("KAITO_ASYNC_DISPATCH", raising=False)
    cfg, _ = tserver.parse_args(["--model", "tiny-llama-test", "--async-dispatch"])
    assert cfg.async_dispatch is True
    cfg, _ = tserver.parse_args(["--model", "tiny-llama-test"])
    assert cfg.async_dispatch is None
