"""The port's OpenAI server under structured output and tools, against
the JAX server on the same bodies (``tiny-llama-real``, fp32, greedy,
its checkpoint in both; ``max_model_len`` 1024 for the tool prompts).

- ``response_format`` (``json_schema``, ``json_object``, ``regex``) on
  both endpoints, forced (``required``, named) and ``auto`` tool calls,
  streamed and not: the same status, choices (tool-call ids masked) and
  usage, and for streams the same deltas.
- The error taxonomy: the same status and error type for each malformed
  body (400), each grammar the compiler rejects (422
  ``invalid_grammar_error``), and under ``structured_output=False``
  (400 ``structured_output_disabled``).
- ``/metrics``: no ``kaito:grammar_*`` line before the first constrained
  request, then the same family with the same counts.
- The chat reply's post-processing: on a preset with a reasoning parser
  the reply's ``reasoning_content`` and ``content`` are the JAX
  server's for the same generated text.
"""

import dataclasses
import json
import os
import re
import threading
import urllib.error
import urllib.request

import pytest

from kaito_tpu.engine.config import EngineConfig as JaxConfig
from kaito_tpu.engine.engine import InferenceEngine as JaxEngine
from kaito_tpu.engine.server import make_server as jax_make_server
from kaito_tpu.models import get_model_by_name as jax_model
from kaito_tpu_torch.engine.config import EngineConfig
from kaito_tpu_torch.engine.engine import InferenceEngine
from kaito_tpu_torch.engine.server import make_server, parse_args
from kaito_tpu_torch.models import get_model_by_name
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(model="tiny-llama-real",
           weights_dir=os.path.join(REPO, "checkpoints", "tiny-llama-real"),
           max_model_len=1024, page_size=16, max_num_seqs=4, dtype="float32",
           kv_dtype="float32", prefill_buckets=(64, 256, 1024), seed=0,
           enable_prefix_caching=False)
SCHEMA = {"type": "object",
          "properties": {"color": {"enum": ["red", "green", "blue"]},
                         "ok": {"type": "boolean"}},
          "required": ["color", "ok"]}
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Weather for a city",
    "parameters": {"type": "object",
                   "properties": {"city": {"enum": ["Paris", "Rome"]}},
                   "required": ["city"]}}},
    {"type": "function", "function": {
        "name": "set_alarm",
        "parameters": {"type": "object", "properties": {"on": {"type": "boolean"}},
                       "required": ["on"]}}}]
CHAT = [{"role": "user", "content": "What is the weather in Paris?"}]
GREEDY = dict(temperature=0.0, max_tokens=48)
CHAT_URL, CMPL_URL = "/v1/chat/completions", "/v1/completions"

# (name, path, body): served 200s first, in this order, on both servers
SERVED = (
    ("schema", CHAT_URL, dict(GREEDY, messages=CHAT, response_format={
        "type": "json_schema", "json_schema": {"name": "c", "schema": SCHEMA}})),
    ("object", CMPL_URL, dict(GREEDY, prompt="A JSON object: ",
                              response_format={"type": "json_object"})),
    ("regex", CMPL_URL, dict(GREEDY, prompt="The answer is ",
                             response_format={"type": "regex",
                                              "regex": "(yes|no), [a-z]{2,8}\\."})),
    ("schema-again", CMPL_URL, dict(GREEDY, prompt="{", response_format={
        "type": "json_schema", "json_schema": {"schema": SCHEMA}})),
    ("text", CHAT_URL, dict(GREEDY, messages=CHAT, response_format={"type": "text"})),
    ("required", CHAT_URL, dict(GREEDY, messages=CHAT, tools=TOOLS,
                                tool_choice="required")),
    ("named", CHAT_URL, dict(GREEDY, messages=CHAT, tools=TOOLS, tool_choice={
        "type": "function", "function": {"name": "set_alarm"}})),
    ("auto", CHAT_URL, dict(GREEDY, max_tokens=24, messages=[
        {"role": "system", "content": "Be brief."}] + CHAT, tools=TOOLS)),
    ("none", CHAT_URL, dict(GREEDY, max_tokens=16, messages=CHAT, tools=TOOLS,
                            tool_choice="none")),
    ("required-stream", CHAT_URL, dict(GREEDY, messages=CHAT, tools=TOOLS,
                                       tool_choice="required", stream=True)),
    ("auto-stream", CHAT_URL, dict(GREEDY, max_tokens=24, messages=CHAT, tools=TOOLS,
                                   stream=True)),
)
# (name, path, body): errors
ERRORS = (
    ("tools-off-chat", CMPL_URL, dict(prompt="x", tools=TOOLS)),
    ("tool-choice-off-chat", CMPL_URL, dict(prompt="x", tool_choice="auto")),
    ("tools-not-a-list", CHAT_URL, dict(messages=CHAT, tools={"a": 1})),
    ("tools-empty", CHAT_URL, dict(messages=CHAT, tools=[])),
    ("choice-without-tools", CHAT_URL, dict(messages=CHAT, tool_choice="required")),
    ("choice-unknown", CHAT_URL, dict(messages=CHAT, tools=TOOLS, tool_choice="some")),
    ("choice-object", CHAT_URL, dict(messages=CHAT, tools=TOOLS,
                                     tool_choice={"type": "function"})),
    ("choice-missing-tool", CHAT_URL, dict(messages=CHAT, tools=TOOLS, tool_choice={
        "type": "function", "function": {"name": "nope"}})),
    ("format-and-forced", CHAT_URL, dict(messages=CHAT, tools=TOOLS,
                                         tool_choice="required",
                                         response_format={"type": "json_object"})),
    ("format-type", CMPL_URL, dict(prompt="x", response_format={"type": "yaml"})),
    ("format-not-object", CMPL_URL, dict(prompt="x", response_format="json")),
    ("format-no-schema", CHAT_URL, dict(messages=CHAT,
                                        response_format={"type": "json_schema"})),
    ("format-empty-regex", CMPL_URL, dict(prompt="x", response_format={
        "type": "regex", "regex": ""})),
    ("state-cap", CMPL_URL, dict(prompt="x", response_format={
        "type": "regex", "regex": "a{64}b{64}c{64}d{64}e{64}f{64}g{64}h{64}i{9}"})),
    ("bad-regex", CMPL_URL, dict(prompt="x", response_format={
        "type": "regex", "regex": "(ab"})),
    ("unsupported-schema", CHAT_URL, dict(messages=CHAT, response_format={
        "type": "json_schema", "json_schema": {"schema": {"type": "tuple"}}})),
    ("no-messages", CHAT_URL, dict(messages=[], tools=TOOLS)),
)


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class _Served:
    def __init__(self, server, engine):
        self.server, self.engine = server, engine
        self.base = f"http://127.0.0.1:{server.server_address[1]}"
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.engine.stop()
        self.thread.join(timeout=10)


def _pair(cfg, jax_md=None, port_md=None):
    jeng = JaxEngine(JaxConfig(**cfg), metadata=jax_md)
    jeng.start()
    teng = InferenceEngine(EngineConfig(**cfg), metadata=port_md, device="cpu")
    teng.start()
    return (_Served(jax_make_server(jeng, JaxConfig(**cfg), host="127.0.0.1", port=0),
                    jeng),
            _Served(make_server(teng, EngineConfig(**cfg), host="127.0.0.1", port=0,
                                device="cpu"), teng))


def _masked(obj):
    if isinstance(obj, dict):
        return {k: ("<id>" if k == "id" and isinstance(v, str) and v.startswith("call_")
                    else _masked(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_masked(v) for v in obj]
    return obj


def _answer(status, raw, stream=False):
    """What is compared of a response: the status and, for a 200, the
    choices and usage (tool-call ids masked) or a stream's deltas; for
    an error its type."""
    if status != 200:
        return status, json.loads(raw)["error"]["type"]
    if stream:
        events = [json.loads(line[6:]) for line in raw.splitlines()
                  if line.startswith("data: {")]
        return status, [_masked(e["choices"]) for e in events], raw.rstrip().endswith(
            "data: [DONE]")
    body = json.loads(raw)
    return status, _masked(body["choices"]), body["usage"]


def _grammar_lines(text):
    return [ln for ln in text.splitlines() if "kaito:grammar_" in ln]


@pytest.fixture(scope="module")
def answers():
    jsrv, tsrv = _pair(CFG)
    out = {}
    try:
        for name, srv in (("jax", jsrv), ("torch", tsrv)):
            got = {"metrics-before": _call(srv.base + "/metrics")[1]}
            for key, path, body in SERVED + ERRORS:
                got[key] = _answer(*_call(srv.base + path, body),
                                   stream=body.get("stream", False))
            got["metrics-after"] = _call(srv.base + "/metrics")[1]
            got["table"] = srv.engine._gram_table
            out[name] = got
    finally:
        jsrv.close()
        tsrv.close()
    return out


@pytest.mark.parametrize("name", [n for n, _, _ in SERVED])
def test_served_bodies_match_the_jax_server(answers, name):
    got, want = answers["torch"][name], answers["jax"][name]
    assert got[0] == 200
    assert got == want


def test_served_bodies_are_what_was_asked(answers):
    got = answers["torch"]
    obj = json.loads(got["schema"][1][0]["message"]["content"])
    assert set(obj) == {"color", "ok"} and obj["color"] in ("red", "green", "blue")
    assert got["schema"][1][0]["finish_reason"] == "stop"
    assert re.fullmatch(r"(yes|no), [a-z]{2,8}\.", got["regex"][1][0]["text"])
    assert isinstance(json.loads(got["object"][1][0]["text"] or "{}"), dict) \
        or got["object"][1][0]["finish_reason"] == "length"
    for key, name in (("required", None), ("named", "set_alarm")):
        ch = got[key][1][0]
        assert ch["finish_reason"] == "tool_calls"
        call = ch["message"]["tool_calls"][0]["function"]
        assert name is None or call["name"] == name
        assert isinstance(json.loads(call["arguments"]), dict)
    # the streamed call's argument deltas accumulate to what parses
    deltas = [c[0]["delta"] for c in got["required-stream"][1]]
    calls = [d["tool_calls"][0] for d in deltas if "tool_calls" in d]
    assert calls[0]["function"]["name"] in ("get_weather", "set_alarm")
    args = "".join(c["function"].get("arguments", "") for c in calls)
    assert isinstance(json.loads(args), dict)
    assert got["required-stream"][1][-1][0]["finish_reason"] == "tool_calls"


@pytest.mark.parametrize("name", [n for n, _, _ in ERRORS])
def test_errors_match_the_jax_server(answers, name):
    got, want = answers["torch"][name], answers["jax"][name]
    assert got == want
    assert got[0] in (400, 422)
    if name in ("state-cap", "bad-regex", "unsupported-schema"):
        assert got == (422, "invalid_grammar_error")


def test_grammar_metrics_are_gated_and_match(answers):
    for name in ("jax", "torch"):
        assert _grammar_lines(answers[name]["metrics-before"]) == []

    def counts(text):
        # the compile histogram's count and the gauges; seconds differ
        return [ln for ln in _grammar_lines(text)
                if "compile_seconds_sum" not in ln
                and "compile_seconds_bucket" not in ln]

    got, want = (counts(answers[n]["metrics-after"]) for n in ("torch", "jax"))
    assert got == want
    # schema-again and the streamed forced call hit the cache
    assert "kaito:grammar_cache_hits_total 2" in got
    names = {ln.split()[2] for ln in _grammar_lines(answers["torch"]["metrics-after"])
             if ln.startswith("# TYPE")}
    assert names == {"kaito:grammar_compile_seconds", "kaito:grammar_cache_hits_total",
                     "kaito:grammar_cache_misses_total",
                     "kaito:grammar_cache_evictions_total",
                     "kaito:grammar_requests_total", "kaito:grammar_cache_entries"}
    tj, tt = answers["jax"]["table"], answers["torch"]["table"]
    assert (tt.capacity, tt.used, tt.version) == (tj.capacity, tj.used, tj.version)


SMALL = dict(model="tiny-llama-test", max_model_len=128, page_size=16, max_num_seqs=2,
             dtype="float32", kv_dtype="float32", prefill_buckets=(32, 128),
             enable_prefix_caching=False)


@pytest.fixture(scope="module")
def disabled():
    jsrv, tsrv = _pair(dict(SMALL, structured_output=False))
    yield jsrv, tsrv
    jsrv.close()
    tsrv.close()


@pytest.mark.parametrize("body", [
    dict(prompt="x", response_format={"type": "json_object"}),
    dict(messages=CHAT, tools=TOOLS, tool_choice="required"),
    dict(messages=CHAT, response_format={"type": "json_schema",
                                         "json_schema": {"schema": SCHEMA}}),
], ids=["format", "forced-tool", "schema"])
def test_structured_output_disabled(disabled, body):
    path = CHAT_URL if "messages" in body else CMPL_URL
    got = [_answer(*_call(srv.base + path, body)) for srv in disabled]
    assert got[0] == got[1] == (400, "structured_output_disabled")


def test_server_flags_reach_the_config(monkeypatch):
    cfg, _ = parse_args(["--no-structured-output", "--grammar-cache-entries", "9",
                         "--grammar-max-states", "77"])
    assert (cfg.structured_output, cfg.grammar_cache_entries,
            cfg.grammar_max_states) == (False, 9, 77)
    monkeypatch.setenv("KAITO_STRUCTURED_OUTPUT", "0")
    monkeypatch.setenv("KAITO_GRAMMAR_CACHE_ENTRIES", "5")
    monkeypatch.setenv("KAITO_GRAMMAR_MAX_STATES", "33")
    cfg, _ = parse_args([])
    assert (cfg.structured_output, cfg.grammar_cache_entries,
            cfg.grammar_max_states) == (False, 5, 33)


REPLIES = ("<think>Paris is in France.\nCheck the units.</think>It is 21 C.",
           "<think>still thinking",
           "No thinking here.",
           "<think>need a tool</think><tool_call>{\"name\": \"get_weather\", "
           "\"arguments\": {\"city\": \"Paris\"}}</tool_call>")


@pytest.fixture(scope="module")
def reasoning_servers():
    """Servers of a preset with a reasoning parser whose tokenizer decodes
    every reply to the text the test sets (a synthetic model does not
    think on purpose)."""
    jmd = dataclasses.replace(jax_model(SMALL["model"]), reasoning_parser="deepseek_r1",
                              tool_call_parser="hermes")
    tmd = dataclasses.replace(get_model_by_name(SMALL["model"]),
                              reasoning_parser="deepseek_r1", tool_call_parser="hermes")
    jsrv, tsrv = _pair(dict(SMALL, max_model_len=1024, prefill_buckets=(32, 1024)),
                       jmd, tmd)
    reply = {"text": ""}
    for srv in (jsrv, tsrv):
        tok = srv.engine.tokenizer
        tok.decode = lambda ids, _orig=tok.decode: reply["text"] if ids else ""
    yield jsrv, tsrv, reply
    jsrv.close()
    tsrv.close()


@pytest.mark.parametrize("tools", [False, True], ids=["plain", "auto-tools"])
@pytest.mark.parametrize("text", REPLIES, ids=range(len(REPLIES)))
def test_reasoning_split_matches_the_jax_server(reasoning_servers, text, tools):
    jsrv, tsrv, reply = reasoning_servers
    reply["text"] = text
    body = dict(messages=CHAT, max_tokens=3, temperature=0.0)
    if tools:
        body["tools"] = TOOLS
    got, want = (_answer(*_call(s.base + CHAT_URL, body)) for s in (tsrv, jsrv))
    assert got == want
    msg = got[1][0]["message"]
    if text.startswith("<think>"):
        assert msg["reasoning_content"] and "<think>" not in msg["content"]
