"""The port's grammar-constrained engine on the CPU (``tiny-llama-real``,
fp32, its checkpoint in both engines), against the JAX engine and
against itself.

- A batch that mixes constrained requests (a JSON schema, a bounded
  regex, ``json_object``) with unconstrained ones gives the JAX
  engine's greedy tokens and logprobs (atol 2e-3) in the sync and async
  loops, under n-gram speculation and under self-draft speculation,
  with the same ``spec_*`` counters; the port's device table equals its
  host table, and every constrained output walks its automaton.
- Seeded constrained sampled requests give the JAX engine's tokens.
- Against the port's own runs: the unconstrained rows of a mixed batch
  are those of an unconstrained batch; a grammar that allows everything
  is bit-exact with no grammar (greedy and sampled); a preempted
  constrained slot resumes its automaton where it left off; and a table
  repack and a capacity growth while a slot decodes change none of its
  tokens.
- A table the device cannot hold (no room, or a failed allocation):
  the request that needs it waits while live rows may come free, else
  fails alone with 503; the buffers in use and every other request are
  untouched.
"""

import json
import os

import numpy as np
import pytest
import torch

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.engine import SamplingParams as JaxParams
from kaito_tpu.engine.grammar import GrammarSpec as JaxSpec
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from kaito_tpu_torch.engine.grammar import (CompiledGrammar, GrammarSpec,
                                            canonical_schema)
from kaito_tpu_torch.parallel.mesh import build_mesh
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(model="tiny-llama-real",
            weights_dir=os.path.join(REPO, "checkpoints", "tiny-llama-real"),
            max_model_len=256, page_size=16, max_num_seqs=4, dtype="float32",
            kv_dtype="float32", prefill_buckets=(32, 64, 128), seed=0,
            enable_prefix_caching=False)

SCHEMA = {"type": "object",
          "properties": {"ok": {"type": "boolean"},
                         "tag": {"type": "string", "maxLength": 4}},
          "required": ["ok", "tag"]}
GRAMMARS = {"schema": ("json_schema", canonical_schema(SCHEMA)),
            "regex": ("regex", "(the|a) [a-z]{2,6}( [a-z]{2,6}){0,4}\\."),
            "object": ("json_object", "")}
JSON_PROMPT = '{"ok":true,"tag":"ab"} {"ok":false,"tag":"abc"} {"ok":true,"tag":"'
# (prompt, grammar name or None, max_tokens)
BATCH = [(JSON_PROMPT, "schema", 40), ("Once upon a time the", "regex", 40),
         ("The meaning of life is", None, 24), (JSON_PROMPT, "object", 30)]
SPEC_COUNTERS = ("decode_steps_total", "spec_steps_total",
                 "spec_proposed_tokens_total", "spec_accepted_tokens_total",
                 "spec_draft_steps_total", "spec_draft_rows_total",
                 "spec_draft_proposed_tokens_total",
                 "spec_draft_accepted_tokens_total", "generation_tokens_total")
MODES = {"sync": {}, "async": dict(async_dispatch=True, decode_run_ahead=4),
         "ngram": dict(speculative_ngram=4),
         "draft": dict(speculative_draft="tiny-llama-real", speculative_draft_k=4,
                       speculative_draft_weights_dir=BASE["weights_dir"])}


def _drive(eng, reqs, max_steps=3000):
    for _ in range(max_steps):
        if all(r.finish_reason for r in reqs):
            break
        eng.step()
    assert all(r.finish_reason for r in reqs)
    return [list(r.output_tokens) for r in reqs]


def _grammar(eng, name, spec_cls=GrammarSpec):
    return eng.grammar_cache.get(spec_cls(*GRAMMARS[name]), eng.tokenizer)


def _serve(eng, params_cls, spec_cls, temperature=0.0, seed=0):
    """BATCH together; (tokens, logprobs, finish reasons)."""
    reqs = []
    for prompt, gname, n in BATCH:
        g = _grammar(eng, gname, spec_cls) if gname else None
        reqs.append(eng.submit(eng.tokenizer.encode(prompt), params_cls(
            max_tokens=n, temperature=temperature, seed=seed, logprobs=True,
            grammar=g)))
    toks = _drive(eng, reqs)
    return toks, [list(r.output_logprobs) for r in reqs], \
        [r.finish_reason for r in reqs]


def _walks(g, toks, eos):
    """Every token allowed from the state before it; True if the walk
    ends accepting (after an EOS, or cut by the budget: a prefix)."""
    st = 0
    for t in toks:
        assert g.allows(st, t), (toks, t)
        if t == eos:
            return g.accepts(st)
        st = g.advance(st, t)
    return True


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's greedy batch in each mode (with the counters),
    and its seeded sampled batch in the sync loop."""
    out = {}
    for mode, kw in MODES.items():
        jeng = JaxEngine(JaxConfig(**BASE, **kw))
        out[mode] = (_serve(jeng, JaxParams, JaxSpec),
                     {k: jeng.counters.get(k, 0) for k in SPEC_COUNTERS})
        if mode == "sync":
            out["sampled"] = _serve(jeng, JaxParams, JaxSpec, temperature=0.8, seed=11)
    return out


def _port(**kw):
    mesh = None
    if kw.get("tensor_parallel", 1) > 1:
        mesh = build_mesh(tensor=kw["tensor_parallel"], devices=["cpu"] * 2)
    return InferenceEngine(EngineConfig(**{**BASE, **kw}), device="cpu", mesh=mesh)


@pytest.mark.parametrize("mode", list(MODES) + ["tp2"])
def test_constrained_greedy_matches_the_jax_engine(jax_runs, mode):
    """Each mode against the JAX engine's same mode; TP=2 (a CPU mesh,
    its window run eagerly) against the JAX engine's sync loop."""
    eng = _port(**(dict(tensor_parallel=2) if mode == "tp2" else MODES[mode]))
    got = _serve(eng, SamplingParams, GrammarSpec)
    (want, want_counters) = jax_runs["sync" if mode == "tp2" else mode]
    assert got[0] == want[0]
    assert got[2] == want[2]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)
    counters = {k: eng.counters.get(k, 0) for k in SPEC_COUNTERS}
    assert counters == want_counters
    if mode in ("ngram", "draft"):
        assert counters["spec_steps_total"] > 0
    eos = eng.tokenizer.eos_token_id
    for (prompt, gname, _), toks in zip(BATCH, got[0]):
        if gname:
            assert _walks(_grammar(eng, gname), toks, eos)
    assert "\"ok\":" in eng.tokenizer.decode(got[0][0])
    json.loads(eng.tokenizer.decode([t for t in got[0][0] if t != eos]))
    # the device table holds the host table
    tbl = eng._gram_table
    assert np.array_equal(eng._gmask.numpy(), tbl.mask)
    assert np.array_equal(eng._gtrans.numpy(), tbl.trans)
    assert eng.grammar_cache.requests_total == 3


def test_seeded_constrained_sampling_matches_the_jax_engine(jax_runs):
    got = _serve(_port(), SamplingParams, GrammarSpec, temperature=0.8, seed=11)
    want = jax_runs["sampled"]
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)
    # the same seed reproduces in the async loop
    again = _serve(_port(**MODES["async"]), SamplingParams, GrammarSpec,
                   temperature=0.8, seed=11)
    assert again[0] == got[0]


@pytest.mark.parametrize("mode", ["sync", "async", "ngram"])
def test_unconstrained_rows_of_a_mixed_batch_are_unchanged(mode):
    def run(with_grammar):
        eng = _port(**MODES[mode])
        reqs = []
        for i, (prompt, gname, n) in enumerate(BATCH):
            g = _grammar(eng, gname) if gname and with_grammar else None
            reqs.append(eng.submit(eng.tokenizer.encode(prompt), SamplingParams(
                max_tokens=n, temperature=0.0, grammar=g)))
        return _drive(eng, reqs)

    mixed, plain = run(True), run(False)
    assert mixed[2] == plain[2]
    assert mixed[0] != plain[0]          # the grammar did act


def _all_ones(vocab):
    return CompiledGrammar(key="allow-all", kind="regex",
                           allow=np.ones((1, vocab), dtype=bool),
                           nxt=np.zeros((1, vocab), dtype=np.int32),
                           accepting=np.ones((1,), dtype=bool), eos_id=257,
                           compile_seconds=0.0)


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_an_all_allowing_grammar_is_bit_exact(temperature):
    eng = _port()
    g = _all_ones(eng.md.arch.vocab_size)
    out = []
    for grammar in (g, None, g):
        r = eng.submit(eng.tokenizer.encode("Once upon a time"), SamplingParams(
            max_tokens=16, temperature=temperature, seed=3, ignore_eos=True,
            logprobs=True, grammar=grammar))
        _drive(eng, [r])
        out.append((list(r.output_tokens), list(r.output_logprobs)))
    assert out[0] == out[1] == out[2]


def test_preempted_slot_resumes_its_grammar():
    eng = _port()
    g = _grammar(eng, "schema")
    alone = eng.submit(eng.tokenizer.encode(JSON_PROMPT), SamplingParams(
        max_tokens=40, temperature=0.0, grammar=g))
    want = _drive(eng, [alone])[0]

    eng = _port()
    g = _grammar(eng, "schema")
    req = eng.submit(eng.tokenizer.encode(JSON_PROMPT), SamplingParams(
        max_tokens=40, temperature=0.0, grammar=g))
    for _ in range(200):
        eng.step()
        if len(req.output_tokens) >= 6:
            break
    assert 6 <= len(req.output_tokens) < len(want)
    slot = next(i for i, s in enumerate(eng.slots) if s.request is req)
    state = eng._gram_slots[slot].state
    eng._preempt_slot(slot)
    assert eng._gram_slots[slot] is None and eng._gram_state[slot] == 0
    eng._admit_new()                      # re-admitted: the automaton replayed
    slot = next(i for i, s in enumerate(eng.slots) if s.request is req)
    assert eng._gram_slots[slot].state == state
    assert _drive(eng, [req])[0] == want
    assert req.preemptions == 1


@pytest.mark.parametrize("mode", ["sync", "async", "ngram"])
def test_table_repack_and_growth_mid_stream_change_no_token(mode):
    """A constrained request decodes while other requests install and
    release grammars: a resident span below it (from a finished request)
    makes the first install repack the 64-row table at the same capacity,
    moving the request's span down; the second install doubles the
    capacity.  The request's tokens are those of its run without them."""
    def constrained(eng, pattern, prompt, n):
        g = eng.grammar_cache.get(GrammarSpec("regex", pattern), eng.tokenizer)
        # EOS does not stop it: the request decodes its whole budget
        return eng.submit(eng.tokenizer.encode(prompt), SamplingParams(
            max_tokens=n, temperature=0.0, ignore_eos=True, grammar=g))

    def run(churn):
        eng = _port(**MODES[mode])
        _drive(eng, [constrained(eng, "w{10}", "x", 1)])     # resident at row 1
        req = constrained(eng, GRAMMARS["regex"][1], "Once upon a time the", 48)
        bases, caps, others = [], [], []
        for step in range(3000):
            if req.finish_reason:
                break
            if churn and step in (1, 3):
                others.append(constrained(eng, "x{20}" if step == 1 else "y{40}",
                                          "x", 2))
            eng.step()
            slot = next((i for i, s in enumerate(eng.slots) if s.request is req), None)
            if slot is not None:
                bases.append(eng._gram_slots[slot].base)
                caps.append(eng._gram_table.capacity)
        _drive(eng, others)
        tbl = eng._gram_table
        assert np.array_equal(eng._gmask.numpy(), tbl.mask)
        assert np.array_equal(eng._gtrans.numpy(), tbl.trans)
        return list(req.output_tokens), bases, caps

    want, _, _ = run(False)
    got, bases, caps = run(True)
    assert got == want
    assert bases[0] == 12 and bases[-1] == 1         # the span moved
    assert caps[0] == 64 and caps[-1] == 128         # and the table grew


def test_admission_beside_a_decoding_window_keeps_the_grammar():
    """A constrained request admitted while another decodes: in the async
    loop a window uploads its (start) state before its prefill ends, and
    the first token must then re-mark it, or the next window masks from
    the state before that token.  The port's tokens walk the automaton
    and equal the JAX engine's sync loop's (the JAX engine's async loop
    misses that re-mark and breaks the grammar here)."""
    pattern = "(ab|cd)+ x{3,5}"

    def run(eng, params_cls, spec_cls):
        g = eng.grammar_cache.get(spec_cls("regex", pattern), eng.tokenizer)
        first = eng.submit(eng.tokenizer.encode("Once upon a time"), params_cls(
            max_tokens=60, temperature=0.0, ignore_eos=True))
        for _ in range(3):
            eng.step()
        req = eng.submit(eng.tokenizer.encode("Then"), params_cls(
            max_tokens=30, temperature=0.0, ignore_eos=True, grammar=g))
        _drive(eng, [first, req])
        assert _walks(g, req.output_tokens, eng.tokenizer.eos_token_id)
        return list(req.output_tokens)

    want = run(JaxEngine(JaxConfig(**BASE)), JaxParams, JaxSpec)
    assert run(_port(**MODES["async"]), SamplingParams, GrammarSpec) == want
    assert run(_port(), SamplingParams, GrammarSpec) == want


def test_device_table_equals_the_host_table_past_the_tokenizer_vocab():
    """``tiny-llama-test`` has 2048 logits columns and a 258-token byte
    tokenizer: the columns past the tokenizer's are -inf and self loops
    on installed rows.  An install into spare rows uploads only its span,
    a repack at the same capacity and a growth the whole table; after
    each, the device table is the host table, and constrained output
    walks its automaton."""
    eng = InferenceEngine(EngineConfig(
        model="tiny-llama-test", max_model_len=128, page_size=16, max_num_seqs=4,
        dtype="float32", kv_dtype="float32", prefill_buckets=(32, 64), seed=0,
        enable_prefix_caching=False), device="cpu")
    assert eng.md.arch.vocab_size > eng.tokenizer.vocab_size
    caps, rows = set(), {}
    for pattern in ("w{10}", "(ab|cd)+", "x{40}", "y{60}", "z{60}"):
        g = eng.grammar_cache.get(GrammarSpec("regex", pattern), eng.tokenizer)
        spare = eng._gram_table is not None and \
            eng._gram_table.used + g.n_states <= eng._gram_table.capacity
        reqs = [eng.submit([5, 6, 7], SamplingParams(max_tokens=6, temperature=0.0,
                                                     ignore_eos=True, grammar=g))]
        if pattern == "z{60}":         # live beside y{60}: the table grows
            g2 = eng.grammar_cache.get(GrammarSpec("regex", "y{60}"), eng.tokenizer)
            reqs.append(eng.submit([8, 9], SamplingParams(
                max_tokens=6, temperature=0.0, ignore_eos=True, grammar=g2)))
        _drive(eng, reqs)
        for r in reqs:
            assert _walks(r.params.grammar, r.output_tokens, eng.tokenizer.eos_token_id)
        tbl = eng._gram_table
        caps.add(tbl.capacity)
        assert np.array_equal(eng._gmask.numpy(), tbl.mask)
        assert np.array_equal(eng._gtrans.numpy(), tbl.trans)
        rows[pattern] = (eng.grammar_device_stats["last_upload_rows"],
                         g.n_states if spare else tbl.capacity)
    assert caps == {64, 128}
    assert all(got == want for got, want in rows.values()), rows
    assert rows["(ab|cd)+"][0] < 64 and rows["z{60}"][0] == 128


def _regex_request(eng, pattern, prompt, n):
    g = eng.grammar_cache.get(GrammarSpec("regex", pattern), eng.tokenizer)
    return eng.submit(eng.tokenizer.encode(prompt), SamplingParams(
        max_tokens=n, temperature=0.0, ignore_eos=True, grammar=g))


def _alone(pattern, prompt, n):
    eng = _port()
    return _drive(eng, [_regex_request(eng, pattern, prompt, n)])[0]


def test_a_table_the_device_cannot_hold_fails_only_its_request():
    """With no device memory to spare, the first constrained request
    needs a table that does not fit, and no live grammar would free
    rows: it fails alone with 503 ``grammar_table_full`` before anything
    is reserved for it, and an unconstrained request beside it gives its
    tokens alone.  With the room back, a constrained request is served."""
    ref = _port()
    plain = SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True)
    want = _drive(ref, [ref.submit(ref.tokenizer.encode("The meaning"), plain)])[0]
    eng = _port()
    eng._grammar_room = lambda: 0
    bad = _regex_request(eng, "w{10}", "x", 8)
    ok = eng.submit(eng.tokenizer.encode("The meaning"), plain)
    assert _drive(eng, [bad, ok])[1] == want
    assert bad.finish_reason == "error" and not bad.output_tokens
    assert bad.error["status"] == 503 and bad.error["type"] == "grammar_table_full"
    assert eng._gmask is None and eng._gram_next is None
    assert eng.counters["requests_failed_total"] == 1
    del eng._grammar_room
    r = _regex_request(eng, "w{10}", "x", 8)
    assert _drive(eng, [r])[0] == _alone("w{10}", "x", 8)
    assert np.array_equal(eng._gmask.numpy(), eng._gram_table.mask)


@pytest.mark.parametrize("how", ["no-room", "allocation-fails"])
def test_a_growth_the_device_cannot_hold_waits_for_live_rows(how):
    """A constrained request decodes under a 61-row grammar in the
    64-row table; a second one's 61 rows would double it.  When the
    device cannot hold the larger table (no room, or the allocation
    raises), the second request waits, the first decodes on in the same
    buffers, and the second is admitted into the 64-row table once the
    first's rows come free: each gives its tokens alone.  A grammar too
    large for the table alone then fails by itself, the old buffers and
    the host table untouched."""
    eng = _port()
    first = _regex_request(eng, "y{60}", "Once upon", 24)
    while len(first.output_tokens) < 2:
        eng.step()
    gmask, cap = eng._gmask, eng._gram_table.capacity
    if how == "no-room":
        eng._grammar_room = lambda: 0
    else:
        def boom(cap):
            raise torch.OutOfMemoryError("CUDA out of memory")
        eng._alloc_grammar_table = boom
    second = _regex_request(eng, "z{60}", "Then", 16)
    for _ in range(3):
        eng.step()
    assert not second.output_tokens and not any(s.request is second for s in eng.slots)
    got = _drive(eng, [first, second])
    assert got == [_alone("y{60}", "Once upon", 24), _alone("z{60}", "Then", 16)]
    assert second.first_token_time > first.finish_time
    assert eng._gmask is gmask and eng._gram_table.capacity == cap == 64
    big = _regex_request(eng, "q{60}r{40}", "x", 4)      # 101 rows: 128 alone
    ok = eng.submit(eng.tokenizer.encode("x"), SamplingParams(max_tokens=4,
                                                              temperature=0.0))
    _drive(eng, [big, ok])
    assert big.error["type"] == "grammar_table_full" and ok.finish_reason == "length"
    assert eng._gmask is gmask and eng._gram_table.capacity == 64
    assert np.array_equal(eng._gmask.numpy(), eng._gram_table.mask)
