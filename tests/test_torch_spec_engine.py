"""The port's speculative engine on the CPU, against the JAX engine and
against its own plain engine.

- n-gram and self-draft speculation on ``tiny-llama-test`` (fp32, the
  JAX engine's weights carried over) give the JAX engine's greedy tokens,
  logprobs AND ``spec_*`` counters over a batch of mixed hit rates and
  budgets off the window's multiple, then a stop id inside a window, in
  the sync and async loops and at TP=2 on a CPU mesh; so does n-gram on
  a tiny MLA model.
- Against the port's plain engine: a stop token inside the window, the
  budget boundary, logprobs (rtol 1e-3 / atol 1e-4, the JAX test's),
  page growth across a page edge, mixed greedy and
  sampled draft batches (greedy rows exact), and the interactions the
  slice keeps: a deadline expiring between rounds, QoS preemption of a
  speculating slot, the prefix cache committing only accepted KV, the
  ITL recorder seeing a window's tokens as ~0 gaps.
- ``tiny-llama-real``'s goldens through both proposers (its checkpoint
  as target and as draft), and an untrained draft that the depth
  controller walks down while the output stays exact.
- Seeds: a seeded sampled request reproduces in fresh engines and in one
  engine, other seeds and slots differ, with and without speculation.
- ``/metrics``' ``kaito:spec_*`` read the counters; the server's flags
  reach the config (``auto`` takes the curated draft).
"""

import json
import os

import jax
import numpy as np
import pytest

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.engine import SamplingParams as JaxParams
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.model import params_from_jax
from kaito_tpu_torch.models import get_model_by_name
from kaito_tpu_torch.parallel.mesh import build_mesh
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL = os.path.join(REPO, "checkpoints", "tiny-llama-real")
GOLDENS = os.path.join(REPO, "tests", "testdata", "goldens_tiny-llama-real.json")

# tests/test_speculative.py's config and prompts
BASE = dict(model="tiny-llama-test", max_model_len=256, page_size=16,
            max_num_seqs=4, dtype="float32", kv_dtype="float32",
            prefill_buckets=(32, 64, 128), seed=0, enable_prefix_caching=False)
REPEAT = [7, 11, 13, 7, 11, 13, 7, 11, 13, 7, 11]
BATCH = [(REPEAT, 40), ([3, 5, 9], 24), ([1, 2, 3, 1, 2, 3, 1, 2], 24),
         ([40, 41, 42, 43], 24)]
SPEC_COUNTERS = ("decode_steps_total", "spec_steps_total",
                 "spec_proposed_tokens_total", "spec_accepted_tokens_total",
                 "spec_draft_steps_total", "spec_draft_rows_total",
                 "spec_draft_proposed_tokens_total",
                 "spec_draft_accepted_tokens_total", "generation_tokens_total")


def _greedy(n, cls=SamplingParams, **kw):
    return cls(max_tokens=n, temperature=0.0, ignore_eos=True, **kw)


def _drive(eng, reqs, max_steps=2000):
    for _ in range(max_steps):
        eng.step()
        if all(r.finish_reason for r in reqs):
            break
    assert all(r.finish_reason for r in reqs)
    return [list(r.output_tokens) for r in reqs]


def _counters(eng):
    return {k: eng.counters[k] for k in SPEC_COUNTERS}


def _serve_batch(eng, cls=SamplingParams, k=4):
    """The first ``k`` requests of BATCH together (logprobs on), then, on
    the same engine, REPEAT with a stop id its stream emits at step 7.
    Returns the tokens, logprobs and the stop request's tokens."""
    reqs = [eng.submit(list(p), _greedy(n, cls, logprobs=True)) for p, n in BATCH[:k]]
    toks = _drive(eng, reqs)
    stop = eng.submit(REPEAT, _greedy(40, cls, stop_token_ids=(toks[0][7],)))
    _drive(eng, [stop])
    assert stop.finish_reason == "stop"
    return toks, [list(r.output_logprobs) for r in reqs], list(stop.output_tokens)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's n-gram batch and self-draft greedy pair (then the
    stop request): tokens, logprobs, counters and the weights (the
    draft's are the target's)."""
    out = {}
    jn = JaxEngine(JaxConfig(**BASE, speculative_ngram=4))
    out["ngram"] = (_serve_batch(jn, JaxParams), _counters(jn))
    arch = get_model_by_name(BASE["model"]).arch
    out["params"] = params_from_jax(jax.tree.map(np.asarray, jn.params), arch)
    jd = JaxEngine(JaxConfig(**BASE, speculative_draft=BASE["model"]))
    out["draft"] = (_serve_batch(jd, JaxParams, k=2), _counters(jd))
    return out


def _port(params, mesh=None, **kw):
    eng = InferenceEngine(EngineConfig(**{**BASE, **kw}), params=params,
                          device="cpu", mesh=mesh)
    if eng.spec_draft is not None:
        eng.spec_draft.model.load_params(params)     # the JAX self-draft's weights
    return eng


def _same_run(got, want):
    """Tokens (the batch's and the stop request's) equal, logprobs within
    the JAX test's rtol 1e-3 / atol 1e-4."""
    assert got[0] == want[0] and got[2] == want[2]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("mode", ["sync", "async", "tp2"])
def test_ngram_matches_the_jax_engine(jax_runs, mode):
    want, counters = jax_runs["ngram"]
    mesh = build_mesh(tensor=2, devices=["cpu", "cpu"]) if mode == "tp2" else None
    eng = _port(jax_runs["params"], mesh=mesh, speculative_ngram=4,
                async_dispatch=mode == "async")
    _same_run(_serve_batch(eng), want)
    assert _counters(eng) == counters
    assert counters["spec_accepted_tokens_total"] > 0
    assert eng.counters["spec_verify_eager_total"] == counters["spec_steps_total"]


@pytest.mark.parametrize("mode", ["sync", "async", "tp2"])
def test_draft_matches_the_jax_engine(jax_runs, mode):
    want, counters = jax_runs["draft"]
    mesh = build_mesh(tensor=2, devices=["cpu", "cpu"]) if mode == "tp2" else None
    eng = _port(jax_runs["params"], mesh=mesh, speculative_draft=BASE["model"],
                async_dispatch=mode == "async")
    _same_run(_serve_batch(eng, k=2), want)
    assert _counters(eng) == counters
    # self-draft: full-accept rounds, the backfill keeps the draft KV exact
    assert counters["spec_draft_accepted_tokens_total"] == \
        counters["spec_draft_proposed_tokens_total"] > 0


# ---------------------------------------------------------------------------
# against the port's plain engine
# ---------------------------------------------------------------------------

def _mk(**kw):
    return InferenceEngine(EngineConfig(**{**BASE, **kw}), device="cpu")


@pytest.fixture(scope="module")
def plain():
    eng = _mk()
    r = eng.submit(REPEAT, _greedy(48, logprobs=True))
    _drive(eng, [r])
    return list(r.output_tokens), list(r.output_logprobs)


@pytest.mark.parametrize("spec", [dict(speculative_ngram=5),
                                  dict(speculative_draft=BASE["model"])])
def test_stop_token_inside_the_window(plain, spec):
    base = plain[0]
    stop = base[7]
    eng = _mk(**spec)
    req = eng.submit(REPEAT, _greedy(40, stop_token_ids=(stop,)))
    _drive(eng, [req])
    assert req.output_tokens == base[:base.index(stop) + 1]
    assert req.finish_reason == "stop"
    assert eng.num_running == 0
    assert eng.allocator.available == eng.allocator.num_pages - 1


@pytest.mark.parametrize("n", [1, 2, 7, 23])
def test_budget_boundary_is_not_overrun(plain, n):
    eng = _mk(speculative_ngram=5)
    assert _drive(eng, [eng.submit(REPEAT, _greedy(n))])[0] == plain[0][:n]


@pytest.mark.parametrize("spec", [dict(speculative_ngram=5),
                                  dict(speculative_draft=BASE["model"])])
def test_logprobs_under_speculation(plain, spec):
    eng = _mk(**spec)
    r = eng.submit(REPEAT, _greedy(20, logprobs=True))
    _drive(eng, [r])
    assert r.output_tokens == plain[0][:20]
    np.testing.assert_allclose(r.output_logprobs, plain[1][:20], rtol=1e-3, atol=1e-4)


def test_page_growth_across_a_boundary():
    prompt = list(range(1, 15)) + list(range(1, 4)) * 4
    ref = _mk()
    base = _drive(ref, [ref.submit(prompt, _greedy(48))])
    eng = _mk(speculative_ngram=6)
    assert _drive(eng, [eng.submit(prompt, _greedy(48))]) == base


_MLA = {"architectures": ["DeepseekV3ForCausalLM"], "model_type": "deepseek_v3",
        "vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "intermediate_size": 128, "max_position_embeddings": 512,
        "kv_lora_rank": 32, "qk_rope_head_dim": 16, "qk_nope_head_dim": 32,
        "v_head_dim": 32, "n_routed_experts": 0, "num_experts_per_tok": 0}


def test_mla_family_matches_the_jax_engine():
    """``tests/test_speculative.py::test_spec_mla_family``'s model: the
    latent context path verifies windows, tokens and counters the JAX
    engine's."""
    from kaito_tpu.models.autogen import metadata_from_hf_config as j_metadata
    from kaito_tpu_torch.models.autogen import metadata_from_hf_config

    jeng = JaxEngine(JaxConfig(**BASE, speculative_ngram=5),
                     metadata=j_metadata("test/mla-spec", _MLA))
    want = _drive(jeng, [jeng.submit(REPEAT, _greedy(24, JaxParams))])
    md = metadata_from_hf_config("test/mla-spec", _MLA)
    eng = InferenceEngine(EngineConfig(**BASE, speculative_ngram=5), metadata=md,
                          params=params_from_jax(jax.tree.map(np.asarray, jeng.params),
                                                 md.arch), device="cpu")
    assert _drive(eng, [eng.submit(REPEAT, _greedy(24))]) == want
    assert _counters(eng) == _counters(jeng)
    assert eng.counters["spec_steps_total"] > 0


def test_draft_mixed_batch_keeps_greedy_rows_exact(plain):
    eng = _mk(speculative_draft=BASE["model"])
    g = eng.submit(REPEAT, _greedy(20))
    s = eng.submit([3, 5, 9, 3, 5, 9], SamplingParams(max_tokens=20, temperature=0.9,
                                                      seed=5, ignore_eos=True))
    outs = _drive(eng, [g, s])
    assert outs[0] == plain[0][:20]
    assert len(outs[1]) == 20
    assert eng.counters["spec_draft_steps_total"] > 0


def test_deadline_between_rounds_retires_only_its_slot(plain):
    from tests.test_torch_deadlines import _Clock

    eng = _mk(speculative_ngram=5)
    eng._now = clock = _Clock()
    doomed = eng.submit([3, 5, 9, 3, 5, 9], _greedy(60), timeout_s=5.0)
    keep = eng.submit(REPEAT, _greedy(40))
    while len(doomed.output_tokens) < 6:
        eng.step()
    assert eng.counters["spec_steps_total"] > 0
    clock.t += 10.0
    _drive(eng, [doomed, keep])
    assert doomed.finish_reason == "deadline" and doomed.error["status"] == 408
    assert keep.output_tokens == plain[0][:40]
    assert eng.allocator.available == eng.allocator.num_pages - 1


def test_qos_preemption_of_a_speculating_slot(plain):
    from tests.test_torch_qos import QOS

    eng = _mk(speculative_ngram=5, max_num_seqs=2, qos_config=QOS)
    low = [eng.submit(REPEAT, _greedy(40)), eng.submit(REPEAT, _greedy(40))]
    while eng.counters["spec_steps_total"] < 2:
        eng.step()
    acme = eng.submit([3, 5, 9], _greedy(8), tenant="acme")
    outs = _drive(eng, low + [acme])
    assert eng.counters["preemptions_total"] >= 1
    assert outs[0] == outs[1] == plain[0][:40]
    ref = _mk()
    assert outs[2] == _drive(ref, [ref.submit([3, 5, 9], _greedy(8))])[0]


def test_prefix_cache_commits_only_accepted_kv():
    """A second request whose prompt is the first's prompt plus output
    reuses the pages speculation wrote: its greedy continuation equals a
    cold plain engine's, so no rejected position's KV was committed."""
    eng = _mk(speculative_ngram=5, enable_prefix_caching=True)
    first = _drive(eng, [eng.submit(REPEAT, _greedy(37))])[0]
    assert eng.counters["spec_accepted_tokens_total"] > 0
    prompt = REPEAT + first
    second = _drive(eng, [eng.submit(prompt, _greedy(12))])[0]
    assert eng.counters["prefix_cached_tokens_total"] >= 32
    ref = _mk()
    assert second == _drive(ref, [ref.submit(prompt, _greedy(12))])[0]


def test_itl_sees_a_window_as_gaps_of_zero():
    eng = _mk(speculative_ngram=5, itl_enabled=True)
    ticks = {"t": 0.0}
    eng._itl_time = lambda: ticks["t"]
    req = eng.submit(REPEAT, _greedy(40))
    while not req.finish_reason:
        eng.step()
        ticks["t"] += 0.01                      # one stamp instant per step
    h = eng.itl_hist
    assert h.count == 39
    # every accepted proposal shares its window's instant: a 0 gap
    assert h._counts[0] >= eng.counters["spec_accepted_tokens_total"] > 0


# ---------------------------------------------------------------------------
# goldens and the depth controller
# ---------------------------------------------------------------------------

def _real(**kw):
    cfg = dict(model="tiny-llama-real", weights_dir=REAL, dtype="float32",
               kv_dtype="float32", max_model_len=512, max_num_seqs=2,
               prefill_buckets=(64, 128), enable_prefix_caching=False, seed=0)
    cfg.update(kw)
    return InferenceEngine(EngineConfig(**cfg), device="cpu")


@pytest.fixture(scope="module")
def jax_kv_int8_ngram():
    """The JAX engine's logprobs of the golden prompts through n-gram
    speculation with int8 KV."""
    golden = json.load(open(GOLDENS))
    eng = JaxEngine(JaxConfig(
        model="tiny-llama-real", weights_dir=REAL, dtype="float32", kv_dtype="int8",
        max_model_len=512, max_num_seqs=2, prefill_buckets=(64, 128),
        enable_prefix_caching=False, seed=0, speculative_ngram=4))
    out = []
    for p in golden["prompts"]:
        n = len(p["kv_int8"]["greedy_tokens"])
        req = eng.submit(list(p["prompt_tokens"]), _greedy(n, JaxParams, logprobs=True))
        _drive(eng, [req])
        out.append(list(req.output_logprobs))
    return out


@pytest.mark.parametrize("section,spec", [
    ("fp32", dict(speculative_ngram=4)),
    ("int8", dict(speculative_ngram=4, quantization="int8")),
    ("weight_int4", dict(speculative_ngram=4, quantization="int4")),
    ("kv_int8", dict(speculative_ngram=4, kv_dtype="int8")),
    ("fp32", dict(speculative_draft="tiny-llama-real", speculative_draft_k=4,
                  speculative_draft_weights_dir=REAL)),
])
def test_goldens_through_speculation(section, spec, request):
    """Greedy tokens exact, logprobs within 2e-3 of the goldens; int8 KV's
    verify windows requantize a page's absmax over the window (ROADMAP
    queue 3), so its logprobs are held to the JAX engine's same
    speculative run instead (which reads up to 0.014 off its goldens)."""
    golden = json.load(open(GOLDENS))
    ref = request.getfixturevalue("jax_kv_int8_ngram") if section == "kv_int8" \
        else [p[section]["logprobs"] for p in golden["prompts"]]
    eng = _real(**spec)
    total = 0
    for p, want_lps in zip(golden["prompts"], ref):
        want = p[section]["greedy_tokens"]
        req = eng.submit(list(p["prompt_tokens"]), _greedy(len(want), logprobs=True))
        _drive(eng, [req])
        assert req.output_tokens == want, p["text"]
        np.testing.assert_allclose(req.output_logprobs, want_lps, rtol=0,
                                   atol=2e-3, err_msg=p["text"])
        total += len(want)
    assert eng.counters["decode_steps_total"] < total
    assert eng.counters["spec_steps_total"] > 0


def test_untrained_draft_falls_back_and_output_stays_exact():
    golden = json.load(open(GOLDENS))
    p = golden["prompts"][0]
    want = p["fp32"]["greedy_tokens"]
    eng = _real(speculative_draft="tiny-llama-real", speculative_draft_k=4)
    assert _drive(eng, [eng.submit(list(p["prompt_tokens"]),
                                   _greedy(len(want)))])[0] == want
    prop = eng.counters["spec_draft_proposed_tokens_total"]
    assert prop > 0
    assert eng.counters["spec_draft_accepted_tokens_total"] / prop < 0.9
    ctl = eng.spec_ctl
    assert ctl.depth(0) != ctl.k_init or ctl.mode(0) == "ngram" \
        or ctl.accept_ewma(0) < 0.8


def test_probation_ticks_without_the_ngram_proposer():
    eng = _mk(speculative_draft=BASE["model"])
    req = eng.submit(REPEAT, _greedy(24))
    eng.step()
    ctl = eng.spec_ctl
    ctl._mode[0] = "ngram"
    ctl._probation[0] = 2
    steps = 0
    while ctl.mode(0) == "ngram":
        assert not req.finish_reason and steps < 10
        eng.step()
        steps += 1
    assert ctl.mode(0) == "draft" and ctl.depth(0) == 1
    _drive(eng, [req])
    assert len(req.output_tokens) == 24


# ---------------------------------------------------------------------------
# seeds
# ---------------------------------------------------------------------------

def _sampled(seed, n=16):
    return SamplingParams(max_tokens=n, temperature=0.8, seed=seed, ignore_eos=True)


@pytest.mark.parametrize("spec", [dict(), dict(speculative_draft=BASE["model"])])
def test_seeded_requests_reproduce_and_seeds_differ(spec):
    a = _mk(**spec)
    first = _drive(a, [a.submit(REPEAT, _sampled(7))])[0]
    again = _drive(a, [a.submit(REPEAT, _sampled(7))])[0]   # the same slot
    b = _mk(**spec)
    fresh = _drive(b, [b.submit(REPEAT, _sampled(7))])[0]
    other = _drive(b, [b.submit(REPEAT, _sampled(8))])[0]
    assert first == again == fresh
    assert other != first


def test_choices_on_other_slots_or_seeds_differ():
    """``n`` > 1 submits its choices with seeds seed + i; each choice, and
    even one seed on two slots, draws its own key."""
    eng = _mk()
    reqs = [eng.submit(REPEAT, _sampled(7 + i)) for i in range(3)] \
        + [eng.submit(REPEAT, _sampled(7))]
    outs = _drive(eng, reqs)
    assert len({tuple(o) for o in outs}) == 4


def test_seeded_sampling_matches_the_jax_engine(jax_runs):
    """Plain decode (no speculation): the per-slot keys make sampled
    tokens the JAX engine's, token for token."""
    params = [dict(max_tokens=12, temperature=0.8, seed=3, ignore_eos=True),
              dict(max_tokens=12, temperature=1.0, top_k=20, seed=4, ignore_eos=True),
              dict(max_tokens=12, temperature=0.0, ignore_eos=True)]
    jeng = JaxEngine(JaxConfig(**BASE))
    want = _drive(jeng, [jeng.submit(list(p), JaxParams(**kw))
                         for (p, _), kw in zip(BATCH, params)])
    eng = _port(jax_runs["params"])
    got = _drive(eng, [eng.submit(list(p), SamplingParams(**kw))
                       for (p, _), kw in zip(BATCH, params)])
    assert got == want


# ---------------------------------------------------------------------------
# /metrics and the server's flags
# ---------------------------------------------------------------------------

def test_metrics_read_the_speculation_counters():
    from kaito_tpu_torch.engine.metrics import EngineMetrics

    eng = _mk(speculative_draft=BASE["model"], speculative_ngram=3)
    m = EngineMetrics(eng)
    _drive(eng, [eng.submit(REPEAT, _greedy(24))])
    lines = dict(line.rsplit(" ", 1) for line in m.registry.expose().splitlines()
                 if line.startswith("kaito:spec_"))
    c = eng.counters
    assert float(lines['kaito:spec_proposed_tokens_total{mode="draft"}']) == \
        c["spec_draft_proposed_tokens_total"] > 0
    assert float(lines['kaito:spec_accepted_tokens_total{mode="draft"}']) == \
        c["spec_draft_accepted_tokens_total"]
    assert float(lines['kaito:spec_proposed_tokens_total{mode="ngram"}']) == \
        c["spec_proposed_tokens_total"]
    assert float(lines["kaito:spec_depth"]) == eng.spec_depth


def test_server_flags_reach_the_config():
    from kaito_tpu_torch.engine.server import parse_args

    cfg, _ = parse_args(["--model", "llama-3.3-70b-instruct", "--speculative-ngram",
                         "4", "--speculative-draft", "auto", "--speculative-draft-k",
                         "3", "--speculative-draft-weights-dir", "/w"])
    assert (cfg.speculative_ngram, cfg.speculative_draft, cfg.speculative_draft_k,
            cfg.speculative_draft_weights_dir) == (4, "llama-3.1-8b-instruct", 3, "/w")
    cfg, _ = parse_args(["--model", "tiny-llama-test", "--speculative-draft", "auto"])
    assert cfg.speculative_draft == ""
    with pytest.raises(ValueError, match="vocab_size"):
        parse_args(["--model", "llama-3.1-8b-instruct", "--speculative-draft",
                    "tiny-llama-test"])
