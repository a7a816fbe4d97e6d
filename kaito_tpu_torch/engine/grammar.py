"""Grammar-constrained decoding: JSON schema / regex -> token automata.

The serving-side counterpart of vLLM's guided decoding (the reference
operator's agentic surface).  A schema compiles once into a char-level
DFA (Outlines-style: regex AST -> Thompson NFA -> subset DFA), which is
then lowered against the tokenizer into two dense tables:

    allow[state, token] : bool   -- token may be emitted in this state
    next[state, token]  : int32  -- DFA state after emitting it

Decode steps pay a single gather-and-add of -inf rows on device (see
``sampler.sample``); the host side advances one int per emitted token.
Compiled grammars live in a bounded LRU (``GrammarCache``) keyed by a
schema hash, so hot agent schemas compile once and every subsequent
request is an O(1) lookup.  ``GrammarTable`` packs the masks of all
live grammars into one device-resident table so a whole heterogeneous
batch is served by one gather — a constrained request never serializes
the step or forces a per-request retrace.

Everything here is host-side numpy + pure python; torch enters only in
the sampler/engine, which consume the packed tables.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class GrammarError(ValueError):
    """Malformed / unsupported / oversized grammar input.

    Raised during request validation and schema compilation — always in
    the HTTP request thread, never the scheduler step thread — so the
    server can turn it into a typed 4xx body."""


# Caps keep compilation O(small) and deny pathological schemas a seat
# in the step thread's memory budget.
MAX_SCHEMA_BYTES = 64 * 1024
MAX_REGEX_LEN = 4096
_MAX_REPEAT = 64          # {m,n} duplication cap (also maxItems/maxLength)
_MAX_SCHEMA_DEPTH = 12

# ---------------------------------------------------------------------------
# Regex AST
#
# Nodes are plain tuples:
#   ("lit", ch)                  single char
#   ("class", frozenset, neg)    char class (neg=True => complement)
#   ("cat", [nodes])             concatenation (empty => epsilon)
#   ("alt", [nodes])             alternation
#   ("star"|"plus"|"opt", node)
#   ("rep", node, m, n)          bounded repeat; n=None => unbounded
#   ("objseq", [members], [optional]) JSON-object property sequence —
#        built natively into the NFA so optional properties stay linear
#        (a comma-correct alternation expansion is exponential)
# ---------------------------------------------------------------------------

_DIGITS = frozenset("0123456789")
_WORD = frozenset("abcdefghijklmnopqrstuvwxyz"
                  "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_SPACE = frozenset(" \t\n\r\f\v")
_HEX = frozenset("0123456789abcdefABCDEF")


class _RegexParser:
    """A compact regex subset: literals, escapes (incl. \\d \\w \\s and
    their complements), ``[...]`` classes with ranges/negation, ``.``,
    ``* + ? {m} {m,} {m,n}``, ``|`` and ``(...)`` / ``(?:...)`` groups.
    Anchors/backrefs/lookaround are rejected with a clear error."""

    def __init__(self, src: str):
        if len(src) > MAX_REGEX_LEN:
            raise GrammarError(
                f"regex too long: {len(src)} > {MAX_REGEX_LEN} chars")
        self.s = src
        self.i = 0

    def parse(self):
        node = self._alt()
        if self.i != len(self.s):
            raise GrammarError(
                f"unexpected {self.s[self.i]!r} at regex offset {self.i}")
        return node

    def _peek(self) -> Optional[str]:
        return self.s[self.i] if self.i < len(self.s) else None

    def _alt(self):
        branches = [self._cat()]
        while self._peek() == "|":
            self.i += 1
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        items = []
        while True:
            c = self._peek()
            if c is None or c in "|)":
                break
            items.append(self._repeat())
        if len(items) == 1:
            return items[0]
        return ("cat", items)

    def _repeat(self):
        node = self._atom()
        while True:
            c = self._peek()
            if c == "*":
                node, self.i = ("star", node), self.i + 1
            elif c == "+":
                node, self.i = ("plus", node), self.i + 1
            elif c == "?":
                node, self.i = ("opt", node), self.i + 1
            elif c == "{":
                node = ("rep", node, *self._bounds())
            else:
                return node

    def _bounds(self):
        j = self.s.find("}", self.i)
        if j < 0:
            raise GrammarError("unterminated {m,n} bound")
        body = self.s[self.i + 1:j]
        self.i = j + 1
        parts = body.split(",")
        try:
            if len(parts) == 1:
                m = n = int(parts[0])
            elif len(parts) == 2:
                m = int(parts[0]) if parts[0] else 0
                n = int(parts[1]) if parts[1] else None
            else:
                raise ValueError(body)
        except ValueError:
            raise GrammarError(f"bad repeat bound {{{body}}}") from None
        if m < 0 or (n is not None and (n < m or n > _MAX_REPEAT)) \
                or m > _MAX_REPEAT:
            raise GrammarError(
                f"repeat bound {{{body}}} outside [0, {_MAX_REPEAT}]")
        return m, n

    def _atom(self):
        c = self._peek()
        if c is None:
            raise GrammarError("unexpected end of regex")
        if c == "(":
            self.i += 1
            if self.s.startswith("?:", self.i):
                self.i += 2
            elif self._peek() == "?":
                raise GrammarError(
                    "lookaround / named groups are not supported")
            node = self._alt()
            if self._peek() != ")":
                raise GrammarError("unbalanced parenthesis")
            self.i += 1
            return node
        if c == "[":
            return self._char_class()
        if c == "\\":
            return self._escape(in_class=False)
        if c == ".":
            self.i += 1
            return ("class", frozenset("\n"), True)
        if c in "*+?{":
            raise GrammarError(f"dangling quantifier {c!r}")
        if c in "^$":
            raise GrammarError(
                f"anchor {c!r} is not supported (patterns are implicitly "
                "anchored)")
        self.i += 1
        return ("lit", c)

    def _escape(self, in_class: bool):
        self.i += 1
        c = self._peek()
        if c is None:
            raise GrammarError("dangling backslash")
        self.i += 1
        table = {"d": (_DIGITS, False), "D": (_DIGITS, True),
                 "w": (_WORD, False), "W": (_WORD, True),
                 "s": (_SPACE, False), "S": (_SPACE, True)}
        if c in table:
            chars, neg = table[c]
            return ("class", chars, neg)
        lit = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v",
               "0": "\0"}.get(c, c)
        if c.isalnum() and c not in "ntrfv0":
            raise GrammarError(f"unsupported escape \\{c}")
        return ("lit", lit) if not in_class else ("cls-lit", lit)

    def _char_class(self):
        self.i += 1  # '['
        neg = self._peek() == "^"
        if neg:
            self.i += 1
        chars: set[str] = set()
        first = True
        while True:
            c = self._peek()
            if c is None:
                raise GrammarError("unterminated character class")
            if c == "]" and not first:
                self.i += 1
                return ("class", frozenset(chars), neg)
            first = False
            if c == "\\":
                node = self._escape(in_class=True)
                if node[0] == "class":
                    if node[2]:
                        raise GrammarError(
                            "negated escape inside character class")
                    chars |= node[1]
                    continue
                lo = node[1]
            else:
                self.i += 1
                lo = c
            if self._peek() == "-" and self.i + 1 < len(self.s) \
                    and self.s[self.i + 1] != "]":
                self.i += 1
                hi = self._peek()
                if hi == "\\":
                    hi = self._escape(in_class=True)[1]
                else:
                    self.i += 1
                if ord(hi) < ord(lo):
                    raise GrammarError(f"bad class range {lo}-{hi}")
                chars |= {chr(o) for o in range(ord(lo), ord(hi) + 1)}
            else:
                chars.add(lo)


def _regex_ast(pattern: str):
    """Parse a pattern (stripping optional ^...$ anchors — matching is
    always whole-string here)."""
    if pattern.startswith("^"):
        pattern = pattern[1:]
    if pattern.endswith("$") and not pattern.endswith("\\$"):
        pattern = pattern[:-1]
    return _RegexParser(pattern).parse()


# ---------------------------------------------------------------------------
# JSON schema -> regex AST (compact canonical JSON: no inter-token
# whitespace, so the emitted text always round-trips json.loads)
# ---------------------------------------------------------------------------

def _lit_str(text: str):
    return ("cat", [("lit", ch) for ch in text])


def _json_literal(value):
    """AST matching exactly json.dumps(value) (compact separators)."""
    return _lit_str(json.dumps(value, separators=(",", ":"),
                               ensure_ascii=True))


# one JSON string character: printable ASCII except " and \, or an
# escape sequence (\" \\ \/ \b \f \n \r \t \uXXXX).  Plain chars stay
# ASCII-only so byte-level tokenizers can never be steered into an
# invalid UTF-8 sequence mid-string; non-ASCII content remains
# expressible through \uXXXX escapes.
_STR_PLAIN = ("class",
              frozenset(chr(o) for o in range(0x20, 0x7F)
                        if o not in (0x22, 0x5C)), False)
_STR_ESC = ("cat", [("lit", "\\"), ("alt", [
    ("class", frozenset('"\\/bfnrt'), False),
    ("cat", [("lit", "u")] + [("class", _HEX, False)] * 4),
])])
_STR_CHAR = ("alt", [_STR_PLAIN, _STR_ESC])

_NUMBER_RE = r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?"
_INTEGER_RE = r"-?(0|[1-9][0-9]*)"


def _string_ast(schema: dict):
    if "pattern" in schema:
        body = _regex_ast(str(schema["pattern"]))
        return ("cat", [("lit", '"'), body, ("lit", '"')])
    lo = int(schema.get("minLength", 0))
    hi = schema.get("maxLength")
    if hi is None:
        body = ("star", _STR_CHAR) if lo == 0 \
            else ("cat", [("rep", _STR_CHAR, lo, lo), ("star", _STR_CHAR)])
    else:
        hi = int(hi)
        if hi > _MAX_REPEAT:
            raise GrammarError(
                f"maxLength {hi} exceeds grammar cap {_MAX_REPEAT}")
        if lo > hi:
            raise GrammarError(f"minLength {lo} > maxLength {hi}")
        body = ("rep", _STR_CHAR, lo, hi)
    return ("cat", [("lit", '"'), body, ("lit", '"')])


def _array_ast(schema: dict, depth: int):
    item = _schema_ast(schema.get("items", {}), depth + 1)
    lo = int(schema.get("minItems", 0))
    hi = schema.get("maxItems")
    if hi is not None:
        hi = int(hi)
        if hi > _MAX_REPEAT:
            raise GrammarError(
                f"maxItems {hi} exceeds grammar cap {_MAX_REPEAT}")
        if lo > hi:
            raise GrammarError(f"minItems {lo} > maxItems {hi}")
    more = ("cat", [("lit", ","), item])
    if lo == 0:
        if hi == 0:
            inner = ("cat", [])
        else:
            tail = ("star", more) if hi is None \
                else ("rep", more, 0, hi - 1)
            inner = ("opt", ("cat", [item, tail]))
    else:
        tail = ("star", more) if hi is None \
            else ("rep", more, lo - 1, hi - 1)
        inner = ("cat", [item, ("rep", more, lo - 1, lo - 1)]) \
            if hi is not None and hi == lo else ("cat", [item, tail])
    return ("cat", [("lit", "["), inner, ("lit", "]")])


def _object_ast(schema: dict, depth: int):
    props = schema.get("properties", {})
    if not isinstance(props, dict):
        raise GrammarError("object 'properties' must be a mapping")
    required = schema.get("required")
    # OpenAI structured-output convention: with no explicit required
    # list every declared property is required (deterministic output
    # order, no exponential optional expansion in the common case)
    req = set(props) if required is None else set(required)
    unknown = req - set(props)
    if unknown:
        raise GrammarError(f"required names undeclared properties: "
                           f"{sorted(unknown)}")
    members, optional = [], []
    for name, sub in props.items():
        member = ("cat", [_json_literal(str(name)), ("lit", ":"),
                          _schema_ast(sub, depth + 1)])
        members.append(member)
        optional.append(name not in req)
    return ("cat", [("lit", "{"), ("objseq", members, optional),
                    ("lit", "}")])


def _value_ast(depth_budget: int):
    """Generic JSON value, structurally bounded to ``depth_budget``
    nesting levels (the json_object builtin)."""
    scalar = ("alt", [_string_ast({}), _regex_ast(_NUMBER_RE),
                      _lit_str("true"), _lit_str("false"),
                      _lit_str("null")])
    if depth_budget <= 0:
        return scalar
    inner = _value_ast(depth_budget - 1)
    member = ("cat", [_string_ast({}), ("lit", ":"), inner])
    obj = ("cat", [("lit", "{"),
                   ("opt", ("cat", [member,
                                    ("star", ("cat", [("lit", ","),
                                                      member]))])),
                   ("lit", "}")])
    arr = ("cat", [("lit", "["),
                   ("opt", ("cat", [inner,
                                    ("star", ("cat", [("lit", ","),
                                                      inner]))])),
                   ("lit", "]")])
    return ("alt", [scalar, obj, arr])


def _json_object_ast(depth_budget: int = 2):
    """Top level of the ``json_object`` builtin: any JSON object,
    structurally bounded to two levels of nesting below the root —
    deeper nesting multiplies DFA states ~4x per level (depth 3 alone
    exceeds the default 512-state cap), and mask rows cost O(vocab)
    device bytes each."""
    inner = _value_ast(depth_budget - 1)
    member = ("cat", [_string_ast({}), ("lit", ":"), inner])
    return ("cat", [("lit", "{"),
                    ("opt", ("cat", [member,
                                     ("star", ("cat", [("lit", ","),
                                                       member]))])),
                    ("lit", "}")])


def _schema_ast(schema, depth: int = 0):
    if depth > _MAX_SCHEMA_DEPTH:
        raise GrammarError(
            f"schema nesting exceeds {_MAX_SCHEMA_DEPTH} levels")
    if schema is True or schema == {}:
        return _value_ast(2)
    if not isinstance(schema, dict):
        raise GrammarError(f"schema must be an object, got "
                           f"{type(schema).__name__}")
    if "$ref" in schema or "$defs" in schema or "definitions" in schema:
        raise GrammarError("$ref / $defs schemas are not supported "
                           "(inline the referenced schema)")
    if "const" in schema:
        return _json_literal(schema["const"])
    if "enum" in schema:
        values = schema["enum"]
        if not isinstance(values, list) or not values:
            raise GrammarError("enum must be a non-empty list")
        return ("alt", [_json_literal(v) for v in values])
    for comb in ("anyOf", "oneOf"):
        if comb in schema:
            branches = schema[comb]
            if not isinstance(branches, list) or not branches:
                raise GrammarError(f"{comb} must be a non-empty list")
            return ("alt", [_schema_ast(b, depth + 1) for b in branches])
    t = schema.get("type")
    if isinstance(t, list):
        if not t:
            raise GrammarError("empty type list")
        return ("alt", [_schema_ast({**schema, "type": one}, depth)
                        for one in t])
    if t == "string":
        return _string_ast(schema)
    if t == "number":
        return _regex_ast(_NUMBER_RE)
    if t == "integer":
        return _regex_ast(_INTEGER_RE)
    if t == "boolean":
        return ("alt", [_lit_str("true"), _lit_str("false")])
    if t == "null":
        return _lit_str("null")
    if t == "object" or (t is None and "properties" in schema):
        return _object_ast(schema, depth)
    if t == "array":
        return _array_ast(schema, depth)
    if t is None:
        return _value_ast(2)
    raise GrammarError(f"unsupported schema type {t!r}")


# ---------------------------------------------------------------------------
# NFA (Thompson) and subset-construction DFA
# ---------------------------------------------------------------------------

class _NFA:
    def __init__(self):
        self.eps: list[list[int]] = []
        self.edges: list[list[tuple[frozenset, bool, int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def link(self, a: int, b: int) -> None:
        self.eps[a].append(b)

    def edge(self, a: int, chars: frozenset, neg: bool, b: int) -> None:
        self.edges[a].append((chars, neg, b))


def _nfa_build(node, nfa: _NFA) -> tuple[int, int]:
    kind = node[0]
    if kind == "lit" or kind == "cls-lit":
        s, e = nfa.state(), nfa.state()
        nfa.edge(s, frozenset((node[1],)), False, e)
        return s, e
    if kind == "class":
        s, e = nfa.state(), nfa.state()
        nfa.edge(s, node[1], node[2], e)
        return s, e
    if kind == "cat":
        s = e = nfa.state()
        for item in node[1]:
            fs, fe = _nfa_build(item, nfa)
            nfa.link(e, fs)
            e = fe
        return s, e
    if kind == "alt":
        s, e = nfa.state(), nfa.state()
        for item in node[1]:
            fs, fe = _nfa_build(item, nfa)
            nfa.link(s, fs)
            nfa.link(fe, e)
        return s, e
    if kind == "star" or kind == "plus" or kind == "opt":
        fs, fe = _nfa_build(node[1], nfa)
        s, e = nfa.state(), nfa.state()
        nfa.link(s, fs)
        nfa.link(fe, e)
        if kind != "plus":
            nfa.link(s, e)
        if kind != "opt":
            nfa.link(fe, fs)
        return s, e
    if kind == "rep":
        _, item, m, n = node
        parts = [item] * m
        if n is None:
            parts.append(("star", item))
        else:
            parts.extend([("opt", item)] * (n - m))
        return _nfa_build(("cat", parts), nfa)
    if kind == "objseq":
        # Linear construction for a property sequence with optional
        # members: two rails of join states — first[i] (nothing emitted
        # yet, no comma needed) and rest[i] (comma before the next
        # member).  Each member fragment is built exactly once.
        members, optional = node[1], node[2]
        n = len(members)
        first = [nfa.state() for _ in range(n + 1)]
        rest = [nfa.state() for _ in range(n + 1)]
        for i, member in enumerate(members):
            fs, fe = _nfa_build(member, nfa)
            nfa.link(first[i], fs)
            comma_s, comma_e = nfa.state(), nfa.state()
            nfa.edge(comma_s, frozenset(","), False, comma_e)
            nfa.link(rest[i], comma_s)
            nfa.link(comma_e, fs)
            nfa.link(fe, rest[i + 1])
            if optional[i]:
                nfa.link(first[i], first[i + 1])
                nfa.link(rest[i], rest[i + 1])
        end = nfa.state()
        nfa.link(first[n], end)
        nfa.link(rest[n], end)
        return first[0], end
    raise GrammarError(f"internal: unknown AST node {kind!r}")


def _eps_closure(nfa: _NFA, states: frozenset) -> frozenset:
    stack, seen = list(states), set(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


_OTHER = "\x00OTHER"   # sentinel symbol: any char outside the explicit set


def _class_matches(chars: frozenset, neg: bool, symbol: str) -> bool:
    if symbol is _OTHER:
        return neg           # a char no class names explicitly
    return (symbol in chars) != neg


@dataclass
class _DFA:
    trans: list[dict]        # per state: symbol -> next state
    accepting: list[bool]
    explicit: frozenset      # chars with their own column; rest = OTHER


def _to_dfa(ast, max_states: int) -> _DFA:
    nfa = _NFA()
    start, end = _nfa_build(ast, nfa)
    explicit: set[str] = set()
    for edges in nfa.edges:
        for chars, _neg, _dst in edges:
            explicit |= chars
    symbols = sorted(explicit) + [_OTHER]

    start_set = _eps_closure(nfa, frozenset((start,)))
    index = {start_set: 0}
    order = [start_set]
    trans: list[dict] = [{}]
    accepting = [end in start_set]
    i = 0
    while i < len(order):
        cur = order[i]
        for sym in symbols:
            nxt = set()
            for s in cur:
                for chars, neg, dst in nfa.edges[s]:
                    if _class_matches(chars, neg, sym):
                        nxt.add(dst)
            if not nxt:
                continue
            closed = _eps_closure(nfa, frozenset(nxt))
            if closed not in index:
                if len(index) >= max_states:
                    raise GrammarError(
                        f"grammar exceeds {max_states} DFA states — "
                        "simplify the schema or raise "
                        "grammar_max_states")
                index[closed] = len(order)
                order.append(closed)
                trans.append({})
                accepting.append(end in closed)
            trans[i][sym] = index[closed]
        i += 1
    return _DFA(trans=trans, accepting=accepting,
                explicit=frozenset(explicit))


# ---------------------------------------------------------------------------
# Tokenizer lowering: char DFA -> per-state vocab mask + transition table
# ---------------------------------------------------------------------------

def _token_strings(tokenizer) -> list:
    """Per-id surface strings (None = never usable: specials, empty or
    undecodable ids).  Cached on the tokenizer object — one pass per
    process per tokenizer, shared by every grammar."""
    cached = getattr(tokenizer, "_grammar_token_strings", None)
    if cached is not None:
        return cached
    V = int(tokenizer.vocab_size)
    special = set()
    for name in ("bos_token_id", "eos_token_id", "pad_token_id",
                 "unk_token_id"):
        tid = getattr(tokenizer, name, None)
        if tid is not None:
            special.add(int(tid))
    out: list = [None] * V
    from kaito_tpu_torch.engine.tokenizer import ByteTokenizer
    if isinstance(tokenizer, ByteTokenizer):
        for i in range(min(256, V)):
            out[i] = chr(i)      # latin-1 identity: byte i <-> char i
    else:
        for i in range(V):
            if i in special:
                continue
            try:
                s = tokenizer.decode([i])
            except Exception:
                continue
            if s and "�" not in s:
                out[i] = s
    for tid in special:
        if 0 <= tid < V:
            out[tid] = None
    try:
        tokenizer._grammar_token_strings = out
    except Exception:
        pass
    return out


def _token_trie(tokenizer) -> dict:
    """Trie over token strings: char -> [child, ids_ending_here]."""
    cached = getattr(tokenizer, "_grammar_token_trie", None)
    if cached is not None:
        return cached
    root: dict = {}
    for tid, s in enumerate(_token_strings(tokenizer)):
        if not s:
            continue
        node, entry = root, None
        for ch in s:
            entry = _trie_child(node, ch)
            node = entry[0]
        entry[1].append(tid)
    try:
        tokenizer._grammar_token_trie = root
    except Exception:
        pass
    return root


def _trie_child(node: dict, ch: str):
    child = node.get(ch)
    if child is None:
        child = [{}, []]
        node[ch] = child
    return child


@dataclass
class CompiledGrammar:
    """A schema lowered against one tokenizer.  ``allow``/``nxt`` are
    dense [n_states, V]; state 0 is the start state; EOS is allowed
    exactly in accepting states (and leaves the state unchanged)."""

    key: str
    kind: str
    allow: np.ndarray            # [R, V] bool
    nxt: np.ndarray              # [R, V] int32
    accepting: np.ndarray        # [R] bool
    eos_id: int
    compile_seconds: float
    _mask_f32: Optional[np.ndarray] = field(default=None, repr=False)

    @property
    def n_states(self) -> int:
        return int(self.allow.shape[0])

    @property
    def vocab_size(self) -> int:
        return int(self.allow.shape[1])

    def allows(self, state: int, token: int) -> bool:
        return bool(self.allow[state, token])

    def advance(self, state: int, token: int) -> int:
        """Host-side single-token step (mirrors the device gather)."""
        if not self.allow[state, token]:
            return state       # disallowed/EOS: state is frozen
        return int(self.nxt[state, token])

    def accepts(self, state: int) -> bool:
        return bool(self.accepting[state])

    def mask_rows_f32(self) -> np.ndarray:
        """[R, V] float32 of 0 / -inf, built once per compile."""
        if self._mask_f32 is None:
            m = np.where(self.allow, np.float32(0.0),
                         np.float32(-np.inf)).astype(np.float32)
            self._mask_f32 = m
        return self._mask_f32

    def validate_text(self, text: str) -> bool:
        """Whole-string acceptance by the char DFA (test helper)."""
        return _dfa_accepts(self._dfa, text) if self._dfa is not None \
            else True

    _dfa: Optional[_DFA] = field(default=None, repr=False)


def _dfa_accepts(dfa: _DFA, text: str) -> bool:
    q = 0
    for ch in text:
        sym = ch if ch in dfa.explicit else _OTHER
        q = dfa.trans[q].get(sym)
        if q is None:
            return False
    return dfa.accepting[q]


def compile_grammar(kind: str, source: str, tokenizer,
                    max_states: int = 512) -> CompiledGrammar:
    """Compile a grammar spec into token tables for ``tokenizer``.

    kind: "json_schema" (source = canonical schema JSON),
    "json_object" (source ignored) or "regex" (source = pattern)."""
    t0 = time.perf_counter()
    if kind == "json_schema":
        try:
            schema = json.loads(source)
        except json.JSONDecodeError as e:
            raise GrammarError(f"schema is not valid JSON: {e}") from None
        ast = _schema_ast(schema)
    elif kind == "json_object":
        ast = _json_object_ast()
    elif kind == "regex":
        ast = _regex_ast(source)
    else:
        raise GrammarError(f"unknown grammar kind {kind!r}")
    dfa = _to_dfa(ast, max_states)

    V = int(tokenizer.vocab_size)
    eos_id = int(getattr(tokenizer, "eos_token_id", V - 1))
    R = len(dfa.trans)
    allow = np.zeros((R, V), dtype=bool)
    nxt = np.zeros((R, V), dtype=np.int32)
    trie = _token_trie(tokenizer)

    for q in range(R):
        # DFS the token trie in lockstep with the char DFA: every trie
        # node reachable without hitting a dead transition marks its
        # finishing tokens as allowed from q
        stack = [(trie, q)]
        while stack:
            node, s = stack.pop()
            for ch, (child, ids) in node.items():
                sym = ch if ch in dfa.explicit else _OTHER
                s2 = dfa.trans[s].get(sym)
                if s2 is None:
                    continue
                for tid in ids:
                    allow[q, tid] = True
                    nxt[q, tid] = s2
                if child:
                    stack.append((child, s2))
        if dfa.accepting[q]:
            allow[q, eos_id] = True
            nxt[q, eos_id] = q

    # every token-reachable state must offer at least one token, or a
    # constrained row would see an all--inf mask (NaN sampling): prune
    # by rejecting the grammar outright — this only fires when the
    # tokenizer cannot spell some required character
    reach, stack = {0}, [0]
    while stack:
        q = stack.pop()
        if not allow[q].any():
            raise GrammarError(
                "grammar has a dead end: some required output cannot be "
                "spelled with this tokenizer's vocabulary")
        for s2 in np.unique(nxt[q][allow[q]]):
            if int(s2) not in reach:
                reach.add(int(s2))
                stack.append(int(s2))

    key = grammar_key(kind, source)
    return CompiledGrammar(key=key, kind=kind, allow=allow, nxt=nxt,
                           accepting=np.asarray(dfa.accepting, dtype=bool),
                           eos_id=eos_id,
                           compile_seconds=time.perf_counter() - t0,
                           _dfa=dfa)


def grammar_key(kind: str, source: str) -> str:
    h = hashlib.sha256()
    h.update(kind.encode())
    h.update(b"\0")
    h.update(source.encode())
    return h.hexdigest()[:32]


# ---------------------------------------------------------------------------
# Request-surface helpers (used by server.py)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GrammarSpec:
    """A validated, canonicalized grammar request (pre-compilation)."""
    kind: str      # "json_schema" | "json_object" | "regex"
    source: str    # canonical payload ("" for json_object)

    @property
    def key(self) -> str:
        return grammar_key(self.kind, self.source)


def canonical_schema(schema) -> str:
    """Canonical JSON text for hashing/caching (sorted keys would break
    property-order semantics, so only separators are normalized)."""
    text = json.dumps(schema, separators=(",", ":"), ensure_ascii=True)
    if len(text.encode()) > MAX_SCHEMA_BYTES:
        raise GrammarError(
            f"schema too large: {len(text.encode())} bytes > "
            f"{MAX_SCHEMA_BYTES}")
    return text


def spec_from_response_format(rf) -> Optional[GrammarSpec]:
    """Parse an OpenAI ``response_format`` body into a GrammarSpec.
    Returns None for type=text; raises GrammarError on anything
    malformed (typed 400 in the server)."""
    if rf is None:
        return None
    if not isinstance(rf, dict):
        raise GrammarError("response_format must be an object")
    rtype = rf.get("type")
    if rtype in (None, "text"):
        return None
    if rtype == "json_object":
        return GrammarSpec(kind="json_object", source="")
    if rtype == "json_schema":
        js = rf.get("json_schema")
        if not isinstance(js, dict):
            raise GrammarError(
                "response_format.json_schema must be an object")
        schema = js.get("schema")
        if not isinstance(schema, (dict, bool)):
            raise GrammarError(
                "response_format.json_schema.schema must be an object")
        return GrammarSpec(kind="json_schema",
                           source=canonical_schema(schema))
    if rtype == "regex":
        pattern = rf.get("regex") or rf.get("pattern")
        if not isinstance(pattern, str) or not pattern:
            raise GrammarError("response_format.regex must be a "
                               "non-empty string")
        return GrammarSpec(kind="regex", source=pattern)
    raise GrammarError(f"unknown response_format.type {rtype!r} "
                       "(expected text, json_object, json_schema or "
                       "regex)")


def tool_envelope_schema(tools: list, names: Optional[list] = None) -> dict:
    """JSON schema for a forced tool call: ``{"name": ..., "arguments":
    {...}}``.  ``names`` restricts to a subset (the named tool_choice);
    None allows any declared tool (tool_choice=required)."""
    branches = []
    for tool in tools:
        fn = tool.get("function", tool) if isinstance(tool, dict) else {}
        name = fn.get("name")
        if not name or (names is not None and name not in names):
            continue
        params = fn.get("parameters")
        if not isinstance(params, (dict, bool)) or params in (True, {}):
            params = {"type": "object", "properties": {}}
        branches.append({
            "type": "object",
            "properties": {"name": {"const": name}, "arguments": params},
            "required": ["name", "arguments"],
        })
    if not branches:
        raise GrammarError("tool_choice names no declared tool")
    return branches[0] if len(branches) == 1 else {"anyOf": branches}


# ---------------------------------------------------------------------------
# GrammarCache: bounded LRU of compiled grammars, keyed by schema hash
# ---------------------------------------------------------------------------

_COMPILE_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


class GrammarCache:
    """Thread-safe bounded LRU.  Compilation happens under a per-key
    build lock in the REQUEST thread (never the scheduler step thread);
    concurrent requests for the same schema compile once."""

    def __init__(self, entries: int = 64, max_states: int = 512):
        self.entries = max(1, int(entries))
        self.max_states = int(max_states)
        self._lru: OrderedDict[str, CompiledGrammar] = OrderedDict()
        self._lock = threading.Lock()
        self._building: dict[str, threading.Event] = {}
        # exposition-ready stats (metrics.py wraps these; kept as plain
        # numbers so this module stays importable without the registry)
        self.hits_total = 0
        self.misses_total = 0
        self.evictions_total = 0
        self.requests_total = 0       # constrained requests admitted
        self.compile_count = 0
        self.compile_sum_seconds = 0.0
        self.compile_bucket_counts = [0] * (len(_COMPILE_BUCKETS) + 1)
        self.compile_buckets = _COMPILE_BUCKETS

    @property
    def touched(self) -> bool:
        """True once any constrained request has hit this cache — the
        metrics gate (exposition stays byte-identical until then)."""
        return (self.hits_total + self.misses_total
                + self.requests_total) > 0

    def _observe_compile(self, seconds: float) -> None:
        self.compile_count += 1
        self.compile_sum_seconds += seconds
        for i, edge in enumerate(self.compile_buckets):
            if seconds <= edge:
                self.compile_bucket_counts[i] += 1
                return
        self.compile_bucket_counts[-1] += 1

    def get(self, spec: GrammarSpec, tokenizer) -> CompiledGrammar:
        key = spec.key
        while True:
            with self._lock:
                hit = self._lru.get(key)
                if hit is not None:
                    self._lru.move_to_end(key)
                    self.hits_total += 1
                    return hit
                ev = self._building.get(key)
                if ev is None:
                    self._building[key] = threading.Event()
                    self.misses_total += 1
                    break
            ev.wait(timeout=30.0)
        try:
            g = compile_grammar(spec.kind, spec.source, tokenizer,
                                max_states=self.max_states)
        except BaseException:
            with self._lock:
                self._building.pop(key).set()
            raise
        with self._lock:
            self._observe_compile(g.compile_seconds)
            self._lru[key] = g
            self._lru.move_to_end(key)
            while len(self._lru) > self.entries:
                self._lru.popitem(last=False)
                self.evictions_total += 1
            self._building.pop(key).set()
        return g

    def stats(self) -> dict:
        with self._lock:
            return {
                "grammar_cache_hits_total": self.hits_total,
                "grammar_cache_misses_total": self.misses_total,
                "grammar_cache_evictions_total": self.evictions_total,
                "grammar_requests_total": self.requests_total,
                "grammar_cache_entries": len(self._lru),
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)


# ---------------------------------------------------------------------------
# GrammarTable: packed device-table row allocator (engine-side)
# ---------------------------------------------------------------------------

class GrammarTable:
    """Packs the 0/-inf mask rows and transition rows of every live
    grammar into one pair of host arrays, ready for a single device
    upload.  Row 0 is the reserved unconstrained row: an all-zero mask
    and an all-zero transition row, so unconstrained slots gather a
    no-op and self-loop at state 0 forever.  Spans are refcounted per
    grammar key; zero-ref spans stay resident (warm for the next
    request with the same schema) until capacity pressure repacks the
    table.  ``version`` bumps whenever row content or layout changes —
    the engine re-uploads and remaps slot states when it observes a new
    version."""

    def __init__(self, vocab_size: int, initial_rows: int = 64):
        self.V = int(vocab_size)
        cap = 1
        while cap < max(2, initial_rows):
            cap *= 2
        self.mask = np.zeros((cap, self.V), dtype=np.float32)
        self.trans = np.zeros((cap, self.V), dtype=np.int32)
        self.used = 1                       # row 0 reserved
        self.spans: dict[str, list] = {}    # key -> [base, n_rows, refs]
        self.version = 1

    @property
    def capacity(self) -> int:
        return int(self.mask.shape[0])

    def _install(self, g: CompiledGrammar) -> int:
        n = g.n_states
        Vg = int(g.allow.shape[1])
        if Vg > self.V:
            raise GrammarError(
                f"grammar vocab {Vg} exceeds model vocab {self.V}")
        if self.used + n > self.capacity:
            self._repack(extra=n)
        base = self.used
        # the grammar is compiled at tokenizer vocab, which may be
        # narrower than the model's logits row: columns the tokenizer
        # never produces are disallowed (-inf) and self-loop
        self.mask[base:base + n, :Vg] = g.mask_rows_f32()
        self.mask[base:base + n, Vg:] = -np.inf
        # transitions are stored pre-offset (absolute row indices) so
        # the device advance is one gather with no base-add
        self.trans[base:base + n, :Vg] = g.nxt + base
        # padded columns self-loop (they are unreachable under the
        # -inf mask; this is belt-and-suspenders)
        self.trans[base:base + n, Vg:] = np.arange(
            base, base + n, dtype=np.int32)[:, None]
        self.used += n
        self.spans[g.key] = [base, n, 0]
        self.version += 1
        return base

    def _repack(self, extra: int) -> None:
        live = {k: v for k, v in self.spans.items() if v[2] > 0}
        need = 1 + sum(v[1] for v in live.values()) + extra
        cap = self.capacity
        while cap < need:
            cap *= 2
        mask = np.zeros((cap, self.V), dtype=np.float32)
        trans = np.zeros((cap, self.V), dtype=np.int32)
        used = 1
        new_spans: dict[str, list] = {}
        for key, (base, n, refs) in live.items():
            mask[used:used + n] = self.mask[base:base + n]
            trans[used:used + n] = (self.trans[base:base + n]
                                    - base + used)
            new_spans[key] = [used, n, refs]
            used += n
        self.mask, self.trans = mask, trans
        self.used, self.spans = used, new_spans
        self.version += 1

    def acquire(self, g: CompiledGrammar) -> int:
        """Pin a grammar's rows; returns the base row index."""
        span = self.spans.get(g.key)
        if span is None:
            base = self._install(g)
            span = self.spans[g.key]
        span[2] += 1
        return span[0]

    def capacity_for(self, g: CompiledGrammar) -> int:
        """The capacity ``acquire(g)`` leaves the table at: it grows only
        when g is not resident and the live grammars' rows and g's pass
        the current capacity."""
        if g.key in self.spans or self.used + g.n_states <= self.capacity:
            return self.capacity
        need = 1 + g.n_states + sum(v[1] for v in self.spans.values() if v[2] > 0)
        cap = self.capacity
        while cap < need:
            cap *= 2
        return cap

    def release(self, key: str) -> None:
        span = self.spans.get(key)
        if span is not None and span[2] > 0:
            span[2] -= 1

    def base_of(self, key: str) -> int:
        return self.spans[key][0]


@dataclass
class GrammarSlot:
    """Per-slot host mirror of the device grammar state."""
    grammar: CompiledGrammar
    base: int          # table base row at the table version below
    state: int = 0     # local DFA state (absolute row = base + state)
    version: int = 0   # GrammarTable.version this base was read at

    def advance(self, token: int) -> None:
        self.state = self.grammar.advance(self.state, token)

    def allows(self, token: int) -> bool:
        return self.grammar.allows(self.state, token)

    def accepting(self) -> bool:
        return self.grammar.accepts(self.state)
