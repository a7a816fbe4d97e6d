"""Grammar-constrained decoding through the captured graphs, on the card.

These need an NVIDIA card and ``nvcc``; without one they skip.  On the
card (no JAX there, so without the suite's conftest):
``python -m pytest --noconftest tests/test_torch_cuda_grammar.py``.

- Constrained and unconstrained requests together: the captured windows
  (sync and async) emit the eager reference loop's greedy tokens, and
  the constrained outputs walk their automata.
- The grammar table grows while a constrained request decodes: the
  graphs keyed on the old capacity are dropped, the next window is
  captured on the new table, the device table equals the host's, and
  the tokens are the eager loop's.
- Under n-gram speculation the verify window under a grammar is a graph
  keyed by the table's capacity, and the tokens are the plain engine's.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

BASE = dict(model="tiny-llama-test", max_model_len=256, page_size=16,
            max_num_seqs=4, dtype="bfloat16", prefill_buckets=(32, 64, 128),
            seed=0, enable_prefix_caching=False, max_pages=64, decode_run_ahead=4)
SCHEMA = '{"type":"object","properties":{"ok":{"type":"boolean"},' \
         '"n":{"enum":[1,2,3]}},"required":["ok","n"]}'
WORDS = "([a-z]+ )*"
PROMPTS = [[(3 * i) % 250 + 2 for i in range(9)],
           [(5 * i) % 250 + 2 for i in range(21)],
           [(7 * i) % 250 + 2 for i in range(40)]]


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


def _grammar(eng, kind, source):
    from kaito_tpu_torch.engine.grammar import GrammarSpec

    return eng.grammar_cache.get(GrammarSpec(kind, source), eng.tokenizer)


def _submit(eng, prompt, n, grammar=None):
    from kaito_tpu_torch.engine.engine import SamplingParams

    return eng.submit(list(prompt), SamplingParams(
        max_tokens=n, temperature=0.0, ignore_eos=True, grammar=grammar))


def _drive(eng, reqs, hook=None):
    for step in range(3000):
        if all(r.finish_reason for r in reqs):
            break
        eng.step()
        if hook is not None:
            reqs = reqs + hook(step)
    assert all(r.finish_reason == "length" for r in reqs)
    return reqs


def _walks(g, tokens, eos):
    st = 0
    for t in tokens:
        assert g.allows(st, t), (tokens, t)
        if t == eos:
            return
        st = g.advance(st, t)


def _mixed(eng):
    gs = [None, _grammar(eng, "json_schema", SCHEMA), _grammar(eng, "regex", WORDS)]
    reqs = _drive(eng, [_submit(eng, p, 20 + 3 * i, g)
                        for i, (p, g) in enumerate(zip(PROMPTS, gs))])
    for r, g in zip(reqs[1:], gs[1:]):
        _walks(g, r.output_tokens, eng.tokenizer.eos_token_id)
    return [r.output_tokens for r in reqs]


@pytest.mark.parametrize("async_on", [False, True])
def test_constrained_windows_match_the_eager_loop(card, async_on):
    want = _mixed(_mk(eager=True))
    eng = _mk(async_dispatch=async_on)
    assert _mixed(eng) == want
    keys = [key for (_, key) in eng.window.graphs]
    assert any(k[-1] == eng._gram_table.capacity for k in keys)
    c = eng.counters
    assert c["decode_graph_replays_total"] >= c["decode_windows_total"] > 0


def _growth(eng):
    """A constrained request decodes; at step 3 two more grammars go live
    whose rows pass the table's capacity.  Returns the first request's
    tokens and the capacities before and after."""
    main = _submit(eng, PROMPTS[1], 40, _grammar(eng, "regex", WORDS))
    cap = {}

    def hook(step):
        if step != 3:
            return []
        cap["before"] = eng._gram_table.capacity
        return [_submit(eng, PROMPTS[0], 12, _grammar(eng, "regex", f"{c}{{60}}"))
                for c in "ab"]

    _drive(eng, [main], hook)
    cap["after"] = eng._gram_table.capacity
    return main.output_tokens, cap


def test_capture_after_table_growth(card):
    want, _ = _growth(_mk(eager=True))
    eng = _mk()
    got, cap = _growth(eng)
    assert got == want
    assert cap == {"before": 64, "after": 128}
    assert eng.grammar_device_stats["graphs_dropped"] > 0
    keys = [key for (_, key) in eng.window.graphs]
    assert all(k[-1] in (None, 128) for k in keys) and any(k[-1] == 128 for k in keys)
    tbl = eng._gram_table
    assert torch.equal(eng._gmask.cpu(), torch.from_numpy(tbl.mask))
    assert torch.equal(eng._gtrans.cpu(), torch.from_numpy(tbl.trans))


def test_verify_graph_under_a_grammar(card):
    prompt = [ord(c) for c in "abc def ghi " * 6]

    def run(**kw):
        eng = _mk(**kw)
        g = _grammar(eng, "regex", WORDS)
        r = _drive(eng, [_submit(eng, prompt, 32, g)])[0]
        _walks(g, r.output_tokens, eng.tokenizer.eos_token_id)
        return eng, r.output_tokens

    _, want = run()
    eng, got = run(speculative_ngram=4, speculative_min_match=2)
    assert got == want
    v = eng.spec_verify.stats()
    assert eng.counters["spec_steps_total"] > 0
    assert v["replays"] == eng.counters["spec_steps_total"]
    assert eng.counters["spec_verify_eager_total"] == 0
    assert all(g["key"].endswith(f"{eng._gram_table.capacity})") for g in v["graphs"])
