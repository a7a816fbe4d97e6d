"""The port's grammar compiler (``kaito_tpu_torch.engine.grammar``, its
own copy) against the JAX package's: the compiled tables of regexes,
character classes with bounds, JSON schemas (objects, arrays, enums,
const, bounded strings and numbers), ``json_object`` and the tool
envelope equal bit for bit on the byte tokenizers of ``tiny-llama-real``
and ``tiny-llama-test`` and on a tokenizer of multi-character tokens;
the same errors come with the same class and message; the request
helpers agree; a scripted run of ``GrammarTable`` (a repack that moves
bases, a capacity doubling) leaves the same arrays, spans and version;
and ``GrammarCache`` counts the same hits, misses and evictions."""

import numpy as np
import pytest

from kaito_tpu.engine import grammar as jg
from kaito_tpu.engine.tokenizer import load_tokenizer as jax_load_tokenizer
from kaito_tpu_torch.engine import grammar as tg
from kaito_tpu_torch.engine.tokenizer import load_tokenizer
from kaito_tpu_torch.models import get_model_by_name

TOOLS = [{"type": "function", "function": {
    "name": "get_weather",
    "parameters": {"type": "object",
                   "properties": {"city": {"enum": ["Paris", "Rome"]},
                                  "days": {"type": "integer"}},
                   "required": ["city"]}}},
    {"type": "function", "function": {"name": "noop"}}]

GRAMMARS = {
    "regex": ("regex", "ab+c?"),
    "regex-alt": ("regex", "(yes|no|maybe)!?"),
    "class-bounds": ("regex", "[a-c]{2,3}"),
    "class-neg": ("regex", "[^x-z0-9]{1,4}\\.[0-9]+"),
    "class-escapes": ("regex", "\\d{3}-\\w+\\s?"),
    "object": ("json_schema", {"type": "object",
                               "properties": {"ok": {"type": "boolean"},
                                              "tag": {"type": "string",
                                                      "maxLength": 4}},
                               "required": ["ok", "tag"]}),
    "object-optional": ("json_schema", {"type": "object", "properties": {
        "n": {"type": "integer"}, "x": {"type": "number"},
        "z": {"type": "null"}}, "required": ["n"]}),
    "array": ("json_schema", {"type": "array", "items": {"type": "integer"},
                              "minItems": 1, "maxItems": 3}),
    "enum": ("json_schema", {"enum": ["red", "green", 3, None]}),
    "const": ("json_schema", {"const": {"k": [1, "two"]}}),
    "nested": ("json_schema", {"type": "object", "properties": {
        "items": {"type": "array", "items": {"type": "object", "properties": {
            "id": {"type": "integer"}, "flag": {"type": "boolean"}},
            "required": ["id"]}, "maxItems": 2}}}),
    "any-of": ("json_schema", {"anyOf": [{"type": "boolean"},
                                         {"type": "string", "maxLength": 2}]}),
    "json_object": ("json_object", ""),
    "tool-required": ("tool", None),
    "tool-named": ("tool", ["get_weather"]),
}


class Words:
    """A tokenizer of multi-character tokens: the byte-level fallback
    never takes this path, so it exercises the trie over decoded
    strings (specials and a token that decodes to nothing are skipped)."""

    _TOKENS = ["{", "}", '"', ":", ",", "true", "false", "null", "ok", "tag", "ab",
               "a", "b", "c", "re", "d", "red", "green", "gr", "een", "3", "1", "0",
               "-", ".", "e", " ", "", "x", "y", "n", "u", "l", "t", "r", "s", "f",
               "[", "]", "k", "w", "o", "two", "id", "i", "flag", "g", "items"]

    def __init__(self):
        self.vocab_size = len(self._TOKENS) + 2
        self.bos_token_id = self.vocab_size - 2
        self.eos_token_id = self.vocab_size - 1

    def decode(self, ids):
        return "".join(self._TOKENS[i] for i in ids if i < len(self._TOKENS))


def _tokenizers():
    out = {}
    for model in ("tiny-llama-real", "tiny-llama-test"):
        md = get_model_by_name(model)
        out[model] = (lambda md=md: load_tokenizer(md.hf_id, md.arch.vocab_size),
                      lambda md=md: jax_load_tokenizer(md.hf_id, md.arch.vocab_size))
    out["words"] = (Words, Words)
    return out


TOKENIZERS = _tokenizers()


def _source(mod, kind, source):
    if kind == "tool":
        return "json_schema", mod.canonical_schema(
            mod.tool_envelope_schema(TOOLS, names=source))
    if kind == "json_schema":
        return kind, mod.canonical_schema(source)
    return kind, source


def _compile(mod, tok, name, **kw):
    kind, source = _source(mod, *GRAMMARS[name])
    return mod.compile_grammar(kind, source, tok, **kw)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:       # the class and message are compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("tok", list(TOKENIZERS))
@pytest.mark.parametrize("name", list(GRAMMARS))
def test_compiled_tables_match(name, tok):
    make_port, make_jax = TOKENIZERS[tok]
    got = _outcome(lambda: _compile(tg, make_port(), name))
    want = _outcome(lambda: _compile(jg, make_jax(), name))
    assert got[0] == want[0], (got, want)
    if got[0] != "ok":
        assert got[1] == want[1]
        return
    g, j = got[1], want[1]
    assert g.key == j.key and g.kind == j.kind and g.eos_id == j.eos_id
    assert np.array_equal(g.allow, j.allow)
    assert np.array_equal(g.nxt, j.nxt)
    assert np.array_equal(g.accepting, j.accepting)
    assert np.array_equal(g.mask_rows_f32(), j.mask_rows_f32())
    assert g.mask_rows_f32().dtype == np.float32


@pytest.mark.parametrize("case", ["dead-end", "state-cap", "unknown-kind",
                                  "bad-json", "bad-regex", "lookaround",
                                  "huge-repeat", "schema-too-large", "bad-schema"])
def test_same_errors(case):
    class NoDigits:
        vocab_size = 258
        bos_token_id, eos_token_id = 256, 257

        def decode(self, ids):
            return "".join(chr(i) for i in ids if 0 <= i < 256 and not chr(i).isdigit())

    calls = {
        "dead-end": lambda m, tok: m.compile_grammar("regex", "[0-9]+", NoDigits()),
        "state-cap": lambda m, tok: m.compile_grammar("regex", "a{60}", tok,
                                                      max_states=16),
        "unknown-kind": lambda m, tok: m.compile_grammar("nope", "", tok),
        "bad-json": lambda m, tok: m.compile_grammar("json_schema", "{", tok),
        "bad-regex": lambda m, tok: m.compile_grammar("regex", "(ab", tok),
        "lookaround": lambda m, tok: m.compile_grammar("regex", "(?=a)b", tok),
        "huge-repeat": lambda m, tok: m.compile_grammar("regex", "a{1000}", tok),
        "schema-too-large": lambda m, tok: m.canonical_schema({"enum": ["x" * 100000]}),
        "bad-schema": lambda m, tok: m.compile_grammar(
            "json_schema", m.canonical_schema({"type": "tuple"}), tok),
    }
    make_port, make_jax = TOKENIZERS["tiny-llama-real"]
    got = _outcome(lambda: calls[case](tg, make_port()))
    want = _outcome(lambda: calls[case](jg, make_jax()))
    assert got[0] == want[0] == "GrammarError"
    assert got[1] == want[1]


RESPONSE_FORMATS = (None, {"type": "text"}, {"type": "json_object"},
                    {"type": "json_schema", "json_schema": {"schema": {"type": "boolean"}}},
                    {"type": "json_schema", "json_schema": {"schema": True}},
                    {"type": "regex", "regex": "a+"}, {"type": "regex", "pattern": "b"},
                    "x", {"type": "yaml"}, {"type": "json_schema"},
                    {"type": "json_schema", "json_schema": {"schema": 7}},
                    {"type": "regex", "regex": ""})


@pytest.mark.parametrize("rf", RESPONSE_FORMATS, ids=range(len(RESPONSE_FORMATS)))
def test_spec_from_response_format_matches(rf):
    got = _outcome(lambda: tg.spec_from_response_format(rf))
    want = _outcome(lambda: jg.spec_from_response_format(rf))
    if got[0] == "ok" and got[1] is not None:
        got = ("ok", (got[1].kind, got[1].source, got[1].key))
        want = ("ok", (want[1].kind, want[1].source, want[1].key))
    assert got == want


@pytest.mark.parametrize("names", [None, ["get_weather"], ["noop"], ["missing"]])
def test_tool_envelope_schema_matches(names):
    assert _outcome(lambda: tg.tool_envelope_schema(TOOLS, names)) == \
        _outcome(lambda: jg.tool_envelope_schema(TOOLS, names))


def _table_script(mod, tok, before_acquire=None):
    """acquire/release a run of grammars through one table: a refcounted
    re-acquire, a release, an install that repacks at the same capacity
    (a live span moves), then one that doubles the capacity.  Returns the
    table's state after every step; ``before_acquire(table, grammar)``
    runs before each acquire."""
    def g(kind, src):
        return mod.compile_grammar(kind, src, tok)

    a, b = g("regex", "ab{1,20}"), g("regex", "[a-c]{2,3}")
    c, d = g("regex", "x{40}"), g("regex", "y{60}z{40}")
    tbl = mod.GrammarTable(vocab_size=300, initial_rows=48)
    states = []

    def snap():
        states.append((tbl.capacity, tbl.used, tbl.version,
                       {k: list(v) for k, v in tbl.spans.items()},
                       tbl.mask.copy(), tbl.trans.copy()))

    for op, gr in (("acquire", a), ("acquire", b), ("acquire", a), ("release", a),
                   ("release", a), ("acquire", c), ("acquire", d), ("release", b),
                   ("acquire", b)):
        if op == "acquire":
            if before_acquire is not None:
                before_acquire(tbl, gr)
            tbl.acquire(gr)
        else:
            tbl.release(gr.key)
        snap()
    return states


def test_grammar_table_script_matches():
    make_port, make_jax = TOKENIZERS["tiny-llama-real"]
    got, want = _table_script(tg, make_port()), _table_script(jg, make_jax())
    # the script repacks at one capacity (b moves down) and then doubles
    caps = [s[0] for s in got]
    assert caps[0] == 64 and caps[-1] == 256 and 128 not in caps[:5]
    assert got[5][3][tg.grammar_key("regex", "[a-c]{2,3}")][0] == 1
    for (gc, gu, gv, gs, gm, gt), (wc, wu, wv, ws, wm, wt) in zip(got, want):
        assert (gc, gu, gv, gs) == (wc, wu, wv, ws)
        assert np.array_equal(gm, wm) and np.array_equal(gt, wt)


def test_capacity_for_predicts_the_capacity_acquire_leaves():
    """The port's ``GrammarTable.capacity_for``, which sizes the device
    table before an install, gives the capacity each acquire of the
    script leaves: a resident grammar, spare rows, the repack at one
    capacity and the doubling."""
    predicted = []
    states = _table_script(tg, TOKENIZERS["tiny-llama-real"][0](),
                           lambda tbl, g: predicted.append(tbl.capacity_for(g)))
    after = [s[0] for s, op in zip(states, "AAARRAARA") if op == "A"]
    assert predicted == after and after[-1] > after[0]


def test_grammar_cache_matches():
    make_port, make_jax = TOKENIZERS["tiny-llama-real"]
    specs = ["a+", "b+", "a+", "c+", "b+", "a+", "d+", "d+"]

    def run(mod, tok):
        cache = mod.GrammarCache(entries=2)
        touched = [cache.touched]
        for s in specs:
            cache.get(mod.GrammarSpec("regex", s), tok)
            touched.append(cache.touched)
        return cache.stats(), cache.compile_count, sum(cache.compile_bucket_counts), \
            len(cache), touched

    assert run(tg, make_port()) == run(jg, make_jax())


def test_slot_mirror_matches():
    make_port, make_jax = TOKENIZERS["tiny-llama-real"]
    text = b'{"ok":true,"tag":"ab"}'

    def walk(mod, tok):
        g = _compile(mod, tok, "object")
        slot = mod.GrammarSlot(grammar=g, base=5)
        seen = []
        for t in list(text) + [ord("?"), g.eos_id]:
            seen.append((slot.state, slot.allows(t), slot.accepting()))
            slot.advance(t)
        return seen

    assert walk(tg, make_port()) == walk(jg, make_jax())
