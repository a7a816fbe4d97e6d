"""Request deadlines of the port: queue expiry, slot expiry, the 408.

Every clock is the engine's injected ``_now`` (a test clock the test
moves), so nothing sleeps for a deadline to pass:

- A request that expires in the queue, found by the 50 ms sweep or at
  admission, answers 408 ``deadline_exceeded``, counts in
  ``requests_expired_total`` and burns no prompt tokens.
- A request that expires while decoding returns every page, with the
  prefix cache on and off, in the synchronous loop (single steps and
  fused windows) and the async one.
- A chunked prefill that expires mid-prompt commits no page to the
  prefix cache.
- The 408 dict is the JAX engine's.
- Over HTTP, ``timeout`` < 0 is a 400 and an expired request a 408,
  streamed or not.

All on ``tiny-llama-test`` in fp32 with ``tests/test_qos.py``'s ``BASE``.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.engine import SamplingParams as JaxParams
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.server import make_server
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

BASE = dict(model="tiny-llama-test", max_model_len=256, page_size=16,
            max_num_seqs=4, dtype="float32", kv_dtype="float32",
            prefill_buckets=(32, 64, 128), seed=0,
            enable_prefix_caching=False)
PROMPT = [(7 * i) % 1900 + 2 for i in range(20)]


class _Clock:
    """The engine's deadline clock, moved by the test."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _greedy(n):
    return SamplingParams(max_tokens=n, temperature=0.0, ignore_eos=True)


def _mk(**kw):
    eng = InferenceEngine(EngineConfig(**{**BASE, **kw}), device="cpu")
    eng._now = clock = _Clock()
    return eng, clock


def _step_until(eng, cond, max_steps=3000):
    for _ in range(max_steps):
        if cond():
            return
        eng.step()
    raise AssertionError("the engine did not get there")


def _all_pages_back(eng):
    return eng.allocator.available == eng.allocator.num_pages - 1


@pytest.mark.parametrize("where", ["sweep", "admission"])
def test_queue_expiry_burns_no_prompt_tokens(where):
    eng, clock = _mk(max_num_seqs=1)
    busy = eng.submit(PROMPT, _greedy(30))
    _step_until(eng, lambda: busy.output_tokens)
    late = eng.submit(PROMPT[:9], _greedy(4), timeout_s=0.5)
    clock.t += 1.0
    if where == "admission":
        # the sweep is throttled: the admission check finds it first
        eng._last_deadline_sweep = clock.t
        _step_until(eng, lambda: busy.finish_reason and late.finish_reason)
    else:
        eng.step()
        assert late.finish_reason == "deadline" and not busy.finish_reason
    _step_until(eng, lambda: busy.finish_reason)
    assert late.finish_reason == "deadline" and late.output_tokens == []
    assert late.error["status"] == 408 and late.error["type"] == "deadline_exceeded"
    assert list(late.stream()) == []
    assert eng.counters["requests_expired_total"] == 1
    assert eng.counters["prompt_tokens_total"] == len(PROMPT)
    assert len(busy.output_tokens) == 30 and _all_pages_back(eng)
    assert not any(s.name == "admit" for s in eng.tracer.spans(late.trace_id))


@pytest.mark.parametrize("prefix", [False, True], ids=["tree-off", "tree-on"])
@pytest.mark.parametrize("loop", ["single", "window", "async"])
def test_active_decode_expiry_returns_every_page(prefix, loop):
    kw = dict(enable_prefix_caching=prefix)
    if loop == "window":
        kw["decode_run_ahead"] = 4
    elif loop == "async":
        kw.update(decode_run_ahead=4, async_dispatch=True)
    eng, clock = _mk(**kw)
    other = eng.submit(PROMPT[::-1], _greedy(12))
    req = eng.submit(PROMPT, _greedy(200), timeout_s=10.0)
    _step_until(eng, lambda: len(req.output_tokens) >= 9)
    clock.t += 20.0
    _step_until(eng, lambda: req.finish_reason and other.finish_reason)
    eng._drain_pipeline()
    assert req.finish_reason == "deadline" and req.error["status"] == 408
    assert 9 <= len(req.output_tokens) < 200
    assert len(other.output_tokens) == 12 and other.finish_reason == "length"
    assert eng.counters["requests_expired_total"] == 1
    assert _all_pages_back(eng) and not eng.active.any()


def test_chunked_prefill_expiring_mid_prompt_commits_no_page():
    eng, clock = _mk(enable_prefix_caching=True, max_prefill_tokens=32)
    long_prompt = [(3 * i) % 1900 + 2 for i in range(100)]
    req = eng.submit(long_prompt, _greedy(4), timeout_s=1.0)
    eng.step()                       # the first chunk: two whole pages written
    slot = next(s for s in eng.slots if s.request is req)
    assert slot.prefilling and slot.prefill_pos == 32
    clock.t += 2.0
    eng._last_deadline_sweep = -1.0
    eng.step()
    assert req.finish_reason == "deadline"
    assert eng.prefix_cache.stats()["cached_pages"] == 0
    assert eng.counters["prompt_tokens_total"] == 0 and _all_pages_back(eng)
    # the same prompt served to its end commits its whole pages
    done = eng.submit(long_prompt, _greedy(4))
    _step_until(eng, lambda: done.finish_reason)
    assert eng.prefix_cache.stats()["cached_pages"] == 100 // 16


def test_deadline_dict_equals_the_jax_engine():
    jeng = JaxEngine(JaxConfig(**BASE))
    eng, _ = _mk()
    jreq = jeng.submit(PROMPT, JaxParams(max_tokens=4), req_id="cmpl-x", timeout_s=3)
    req = eng.submit(PROMPT, _greedy(4), req_id="cmpl-x", timeout_s=3)
    assert req.deadline == eng._now() + 3 and jreq.deadline is not None
    for e, r in ((jeng, jreq), (eng, req)):
        e._pop_waiting()
        e._expire_request(r)
    assert (req.finish_reason, req.error) == (jreq.finish_reason, jreq.error)
    assert eng.counters["requests_expired_total"] == jeng.counters[
        "requests_expired_total"] == 1
    spans = {s.name: s.attrs for s in eng.tracer.spans(req.trace_id)}
    assert spans["request"]["finish"] == "deadline"


def test_request_timeout_s_is_the_default_deadline():
    eng, clock = _mk(request_timeout_s=5.0)
    assert eng.submit(PROMPT, _greedy(2)).deadline == clock.t + 5.0
    assert eng.submit(PROMPT, _greedy(2), timeout_s=1.5).deadline == clock.t + 1.5
    assert _mk()[0].submit(PROMPT, _greedy(2)).deadline is None


# ---------------------------------------------------------------------------
# over HTTP
# ---------------------------------------------------------------------------

def _post(base, body):
    req = urllib.request.Request(f"{base}/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class _OffsetClock:
    """time.monotonic plus an offset the test raises."""

    def __init__(self):
        self.offset = 0.0

    def __call__(self):
        return time.monotonic() + self.offset


@pytest.fixture(scope="module")
def served():
    eng = InferenceEngine(EngineConfig(**{**BASE, "max_num_seqs": 1}), device="cpu")
    eng._now = clock = _OffsetClock()
    eng.start()
    srv = make_server(eng, eng.cfg, host="127.0.0.1", port=0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield eng, clock, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    eng.stop()


def test_negative_timeout_is_400(served):
    _, _, base = served
    status, raw = _post(base, {"prompt": "x", "timeout": -1})
    assert status == 400 and "timeout" in json.loads(raw)["error"]["message"]


@pytest.mark.parametrize("stream", [False, True])
def test_expired_request_answers_408(served, stream):
    eng, clock, base = served
    queued = eng.counters["requests_total"]
    out = {}
    th = threading.Thread(target=lambda: out.update(r=_post(base, {
        "prompt": "a queued prompt", "max_tokens": 4, "timeout": 30,
        "stream": stream})))
    eng._admit_new = lambda: False          # admission held: it stays queued
    try:
        th.start()
        while eng.counters["requests_total"] == queued:
            time.sleep(0.001)
        clock.offset += 60.0
        th.join(timeout=120)
    finally:
        del eng._admit_new
    status, raw = out["r"]
    err = json.loads(raw)["error"]
    assert status == 408 and err["type"] == "deadline_exceeded"
    assert "deadline" in err["message"]
