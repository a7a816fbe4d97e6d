"""Multi-tenant QoS of the port against the JAX package's.

- ``engine.qos.parse_qos_config`` reads the same documents to the same
  ``to_dict`` and rejects the same malformed ones; a document with a
  tenant -> adapter map (M16) parses to the same ``adapter_of``.
- A never-started JAX engine and a never-started port engine, given the
  same submissions, pop them in the same order: strict priority across
  classes, deficit round robin by weight within one, a preempted
  request requeued in front.
- The preemption scenarios of ``tests/test_qos.py`` (the newest yields
  without QoS, the lowest class yields with it, a guaranteed request
  claims the slot of a best-effort one) give the same preemption counts
  and greedy tokens in both engines, driven step by step on the same
  weights.
- ``RateLimiter.shed_reason`` / ``retry_after_s`` / ``note_tokens``
  return what the JAX limiter returns for one stub engine and one
  injected clock, over schedules hypothesis draws.
- The per-tenant metric families exist only with QoS, as in the JAX
  ``EngineMetrics``.

All on ``tiny-llama-test`` in fp32 with the JAX test's ``BASE``.
"""

import json

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.engine import SamplingParams as JaxParams
from kaito_tpu.engine.metrics import EngineMetrics as JaxMetrics
from kaito_tpu.engine.qos import parse_qos_config as jax_parse
from kaito_tpu.engine.rate_limit import RateLimiter as JaxLimiter
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.metrics import EngineMetrics
from kaito_tpu_torch.engine.model import params_from_jax
from kaito_tpu_torch.engine.qos import parse_qos_config, priority_rank, valid_tenant
from kaito_tpu_torch.engine.rate_limit import RateLimiter
from kaito_tpu_torch.models import get_model_by_name
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# tests/test_qos.py's BASE and two-class document
BASE = dict(model="tiny-llama-test", max_model_len=256, page_size=16,
            max_num_seqs=4, dtype="float32", kv_dtype="float32",
            prefill_buckets=(32, 64, 128), seed=0,
            enable_prefix_caching=False)
QOS = json.dumps({
    "classes": {
        "guaranteed": {"priority": 100, "weight": 8},
        "best-effort": {"priority": 0, "weight": 1,
                        "max_queue_len": 4, "tokens_per_s": 0},
    },
    "tenants": {"acme": "guaranteed"},
    "default_class": "best-effort",
})
DRR = {"classes": {"gold": {"priority": 10, "weight": 1},
                   "a": {"priority": 0, "weight": 4},
                   "b": {"priority": 0, "weight": 1}},
       "tenants": {"gold": "gold", "a": "a", "b": "b"}, "default_class": "b"}


def _greedy(n, jax_side=False):
    return (JaxParams if jax_side else SamplingParams)(
        max_tokens=n, temperature=0.0, ignore_eos=True)


# ---------------------------------------------------------------------------
# the document
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("doc", [
    QOS,
    json.dumps(DRR),
    '{"classes": {"only": {"priority": 3, "weight": 2, "tokens_per_s": 7.5}}}',
    '{"classes": {"a": {}, "b": {"max_queue_len": 9}}, "tenants": {"x.y-z": "b"},'
    ' "default_class": "a"}',
])
def test_parse_qos_config_matches_the_jax_package(doc, tmp_path):
    want = jax_parse(doc).to_dict()
    assert parse_qos_config(doc).to_dict() == want
    path = tmp_path / "qos.json"
    path.write_text(doc)
    got = parse_qos_config(f"@{path}")
    assert got.to_dict() == want
    for tenant in ("acme", "a", "x.y-z", "nobody"):
        for prio in ("", "guaranteed", "b"):
            jc = jax_parse(doc).class_of(tenant, prio)
            assert got.class_of(tenant, prio).priority == jc.priority
            assert got.weight_of(tenant) == jax_parse(doc).weight_of(tenant)
    assert parse_qos_config("") is None and parse_qos_config("  ") is None


@pytest.mark.parametrize("doc, msg", [
    ("{not json", "not valid JSON"),
    ("[]", "JSON object"),
    ('{"classes": {}}', "non-empty 'classes'"),
    ('{"classes": {"bad name!": {}}}', "label-safe"),
    ('{"classes": {"a": {"weight": 0}}}', "weight must be >= 1"),
    ('{"classes": {"a": {"burst": 2}}}', "unknown"),
    ('{"classes": {"a": {"tokens_per_s": -1}}}', "budgets must be >= 0"),
    ('{"classes": {"a": {}}, "tenants": {"t": "nope"}}', "unknown class"),
    ('{"classes": {"a": {}, "b": {}}}', "default_class"),
    ('{"classes": {"a": {}}, "default_class": "zz"}', "not a defined"),
    ('{"classes": {"a": {}}, "adapters": {"t": "bad adapter!"}}', "label-safe"),
])
def test_parse_qos_config_rejects_what_the_jax_package_rejects(doc, msg):
    with pytest.raises(ValueError, match=msg):
        jax_parse(doc)
    with pytest.raises(ValueError, match=msg):
        parse_qos_config(doc)


def test_adapters_map_raises_naming_m16():
    """The tenant -> adapter map (M16) parses as the JAX package's, and
    an engine takes a document that holds one."""
    doc = json.dumps({"classes": {"a": {}}, "adapters": {"acme": "acme-lora"}})
    assert jax_parse(doc).adapter_of("acme") == "acme-lora"
    assert parse_qos_config(doc).adapter_of("acme") == "acme-lora"
    assert parse_qos_config(doc).adapter_of("other") == ""
    assert parse_qos_config(doc).to_dict() == jax_parse(doc).to_dict()
    eng = InferenceEngine(EngineConfig(**{**BASE, "qos_config": doc}), device="cpu")
    assert eng.qos.adapter_of("acme") == "acme-lora"


def test_tenant_ids_and_priority_ranks():
    from kaito_tpu.engine.qos import priority_rank as jax_rank
    from kaito_tpu.engine.qos import valid_tenant as jax_valid

    for name in ("", "acme", "a" * 64, "a" * 65, "-x", "x y", "guaranteed",
                 "best-effort", "75", "5000", "custom"):
        assert valid_tenant(name) == jax_valid(name)
        assert priority_rank(name) == jax_rank(name)


# ---------------------------------------------------------------------------
# admission order
# ---------------------------------------------------------------------------

def _queued_pair(doc):
    """A never-started JAX engine and port engine under ``doc``."""
    cfg = {**BASE, "qos_config": json.dumps(doc)}
    return JaxEngine(JaxConfig(**cfg)), InferenceEngine(EngineConfig(**cfg),
                                                        device="cpu")


def _drain_order(eng):
    order = []
    while (req := eng._pop_waiting()) is not None:
        order.append(req.req_id)
    assert eng.num_waiting == 0
    return order


@pytest.mark.parametrize("script", [
    # (tenant, priority header) per submission, "R" requeues the last pop
    [("a", "")] * 5 + [("b", "")] * 5 + [("gold", "")],
    [("b", ""), ("a", ""), ("b", ""), ("a", "gold"), ("a", ""), ("b", ""),
     ("zed", ""), ("a", ""), ("b", "a")],
    [("a", "")] * 3 + ["pop", "R"] + [("b", "")] * 3 + ["pop", "pop", "R"],
])
def test_admission_order_matches_the_jax_engine(script):
    jeng, teng = _queued_pair(DRR)
    out = {}
    for eng in (jeng, teng):
        order, last = [], None
        greedy = _greedy(4, jax_side=eng is jeng)
        for i, step in enumerate(script):
            if step == "pop":
                last = eng._pop_waiting()
                order.append(last.req_id)
            elif step == "R":
                eng._requeue_front(last)
                order.append(f"requeue {last.req_id}")
            else:
                tenant, prio = step
                eng.submit([1, 2, 3], greedy, req_id=f"{tenant}{i}",
                           tenant=tenant, priority=prio)
        waiting = {t: eng.num_waiting_for(t) for t in ("a", "b", "gold", "zed")}
        out[eng is jeng] = (order + _drain_order(eng), waiting)
    assert out[False] == out[True]


def test_admission_order_without_qos_is_fifo():
    cfg = dict(BASE)
    jeng, teng = JaxEngine(JaxConfig(**cfg)), InferenceEngine(EngineConfig(**cfg),
                                                              device="cpu")
    for eng in (jeng, teng):
        greedy = _greedy(4, jax_side=eng is jeng)
        for i in range(4):
            eng.submit([1, 2], greedy, req_id=f"r{i}", tenant=("a", "b")[i % 2])
        first = eng._pop_waiting()
        eng._requeue_front(first)
        assert eng.num_waiting_for("a") == 4
    assert _drain_order(jeng) == _drain_order(teng) == ["r0", "r1", "r2", "r3"]


# ---------------------------------------------------------------------------
# preemption scenarios, both engines on the same weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, JaxEngine(JaxConfig(**BASE)).params)


def _pair(jax_params, **kw):
    cfg = {**BASE, **kw}
    arch = get_model_by_name(BASE["model"]).arch
    teng = InferenceEngine(EngineConfig(**cfg), device="cpu",
                           params=params_from_jax(jax_params, arch))
    return JaxEngine(JaxConfig(**cfg)), teng


def _step_until(eng, cond, max_steps=4000):
    for _ in range(max_steps):
        if cond():
            return
        eng.step()
    raise AssertionError("the engine did not get there")


def _scenario(eng, name, jax_side):
    """Run one of tests/test_qos.py's preemption scenarios by steps;
    (tokens, preemptions) of each request and the engine's count."""
    g = lambda n: _greedy(n, jax_side)  # noqa: E731
    if name == "newest_yields_without_qos":
        reqs = [eng.submit([40, 41, 42] * 11, g(100)),
                eng.submit([50, 51, 52] * 11, g(40))]
    elif name == "lowest_class_yields":
        reqs = [eng.submit([50, 51, 52] * 11, g(40), tenant="free"),
                eng.submit([40, 41, 42] * 11, g(100), tenant="acme")]
    elif name == "best_effort_waits":
        reqs = [eng.submit([10, 11] * 8, g(30), tenant="acme"),
                eng.submit([12, 13] * 8, g(30), tenant="acme"),
                eng.submit([60, 61] * 8, g(10), tenant="free")]
    else:   # guaranteed_claims_slot
        be = eng.submit([50, 51, 52] * 4, g(60), tenant="free")
        _step_until(eng, lambda: len(be.output_tokens) >= 3)
        reqs = [be, eng.submit([40, 41, 42] * 4, g(10), tenant="acme")]
    _step_until(eng, lambda: all(r.finish_reason for r in reqs))
    assert eng.allocator.available == eng.allocator.num_pages - 1
    return ([(list(r.output_tokens), r.preemptions) for r in reqs],
            eng.counters["preemptions_total"])


@pytest.mark.parametrize("name,kw", [
    ("newest_yields_without_qos", dict(max_num_seqs=2, max_pages=10)),
    ("lowest_class_yields", dict(max_num_seqs=2, max_pages=10, qos_config=QOS)),
    ("best_effort_waits", dict(max_num_seqs=2, max_pages=12, qos_config=QOS)),
    ("guaranteed_claims_slot", dict(max_num_seqs=1, qos_config=QOS)),
])
def test_preemption_scenarios_match_the_jax_engine(jax_params, name, kw):
    jeng, teng = _pair(jax_params, **kw)
    want = _scenario(jeng, name, True)
    got = _scenario(teng, name, False)
    assert got == want
    (first, second, *_), total = got
    assert total >= (0 if name == "best_effort_waits" else 1)
    if name == "newest_yields_without_qos":
        assert second[1] >= 1 and first[1] == 0      # the newest yielded
    elif name == "lowest_class_yields":
        assert first[1] >= 1 and second[1] == 0      # best-effort despite age
    elif name == "guaranteed_claims_slot":
        assert first[1] >= 1 and second[1] == 0 and len(first[0]) == 60
    else:
        assert first[1] == second[1] == 0


def test_prefill_pack_takes_the_higher_class_first():
    """Staged prompts pack by (-priority, admission order): a guaranteed
    prompt admitted after a best-effort one prefills first when the
    budget holds only one of them."""
    eng = InferenceEngine(EngineConfig(**{**BASE, "qos_config": QOS,
                                          "max_prefill_tokens": 32}), device="cpu")
    be = eng.submit([7] * 30, _greedy(2), tenant="free")
    eng._admit_new()
    g = eng.submit([8] * 30, _greedy(2), tenant="acme")
    eng._admit_new()
    assert [eng.slots[i].request for i in eng._staged()] == [be, g]
    eng._advance_prefills()
    assert g.output_tokens and not be.output_tokens


# ---------------------------------------------------------------------------
# the rate limiter
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class _Allocator:
    def __init__(self, available, num_pages=101):
        self.available, self.num_pages = available, num_pages


class _StubEngine:
    def __init__(self):
        self.num_waiting = 0
        self.per = {}
        self.allocator = _Allocator(100)

    def num_waiting_for(self, tenant):
        return self.per.get(tenant, 0)


METERED = json.dumps({
    "classes": {"guaranteed": {"priority": 100, "weight": 8},
                "metered": {"priority": 10, "tokens_per_s": 40, "max_queue_len": 3},
                "best-effort": {"priority": 0, "max_queue_len": 2}},
    "tenants": {"acme": "guaranteed", "meter": "metered"},
    "default_class": "best-effort"})
_TENANTS = ("", "acme", "meter", "free")
_OPS = st.one_of(
    st.tuples(st.just("shed"), st.sampled_from(_TENANTS)),
    st.tuples(st.just("retry"), st.sampled_from(("", "req-1", "cmpl-abc"))),
    st.tuples(st.just("note"), st.sampled_from(_TENANTS), st.integers(0, 400)),
    st.tuples(st.just("tick"), st.floats(0.0, 5.0)),
    st.tuples(st.just("queue"), st.integers(0, 40), st.sampled_from(_TENANTS),
              st.integers(0, 5)),
    st.tuples(st.just("pages"), st.integers(0, 100)))


def _limiters(qos, kv):
    clock = _Clock()
    args = dict(max_queue_len=16, kv_shed_threshold=kv, time_fn=clock)
    return clock, (JaxLimiter(qos=jax_parse(qos) if qos else None, **args),
                   RateLimiter(qos=parse_qos_config(qos) if qos else None, **args))


@settings(max_examples=150, deadline=None)
@given(ops=st.lists(_OPS, max_size=40), qos=st.sampled_from(("", QOS, METERED)),
       kv=st.sampled_from((0.0, 0.5, 0.9)))
def test_rate_limiter_decisions_match_the_jax_package(ops, qos, kv):
    clock, (jlim, lim) = _limiters(qos, kv)
    eng = _StubEngine()
    for op in ops:
        if op[0] == "shed":
            assert lim.shed_reason(eng, tenant=op[1]) == jlim.shed_reason(
                eng, tenant=op[1])
        elif op[0] == "retry":
            assert lim.retry_after_s(eng, key=op[1]) == jlim.retry_after_s(
                eng, key=op[1])
        elif op[0] == "note":
            jlim.note_tokens(op[1], op[2])
            lim.note_tokens(op[1], op[2])
        elif op[0] == "tick":
            clock.t += op[1]
        elif op[0] == "queue":
            eng.num_waiting = op[1]
            eng.per[op[2]] = op[3]
        else:
            eng.allocator.available = op[1]
    assert lim._buckets == jlim._buckets


def test_rate_limiter_probe_errors_and_shapes():
    class _NoAllocator:
        num_waiting = 2

    lim = RateLimiter(max_queue_len=100, kv_shed_threshold=0.9)
    assert lim.shed_reason(_NoAllocator()) is None
    assert 'kaito:rate_limit_probe_errors_total 1' in "\n".join(
        lim.probe_errors.collect())
    eng = _StubEngine()
    eng.num_waiting = 16
    assert RateLimiter(16).shed_reason(eng) == {"reason": "queue_full", "tenant": ""}
    assert RateLimiter(16, disabled=True).shed_reason(eng) is None


# ---------------------------------------------------------------------------
# metric families
# ---------------------------------------------------------------------------

def _family_names(text):
    return [line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")]


def test_tenant_families_are_gated_on_qos_as_in_the_jax_package():
    off, jax_off = EngineMetrics(), JaxMetrics()
    assert _family_names(off.registry.expose()) == _family_names(
        jax_off.registry.expose())
    assert "kaito:requests_shed_total" not in off.registry.expose()
    assert "kaito:requests_served_total" not in off.registry.expose()
    on = EngineMetrics(qos=parse_qos_config(QOS))
    jax_on = JaxMetrics(qos=jax_parse(QOS))
    for m in (on, jax_on):
        m.tenant_shed.inc(tenant="free")
        m.tenant_served.inc(tenant="acme")
    text = on.registry.expose()
    assert _family_names(text) == _family_names(jax_on.registry.expose())
    assert 'kaito:requests_shed_total{tenant="free"} 1' in text
    assert 'kaito:requests_served_total{tenant="acme"} 1' in text
