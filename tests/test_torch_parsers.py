"""The port's reply parsers (``kaito_tpu_torch.engine.parsers``, its own
copy) against the JAX package's on one corpus: reasoning splits, every
tool-call wire format, forced-call parsing, the streaming argument
parser over every chunking ``tests/test_parsers.py`` and
``tests/test_grammar.py`` use, the delta split of parsed calls and the
tools prompt in every mode.  Tool-call ids come from ``uuid``, so they
are compared masked."""

import dataclasses
import json

import pytest

from kaito_tpu.engine import parsers as jax_parsers
from kaito_tpu_torch.engine import parsers

MODES = ("hermes", "mistral", "llama3_json", "deepseek_v3", "phi4_mini_json", "",
         "unknown-mode")

TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Weather for a city",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}},
                   "required": ["city"]}}},
    {"type": "function", "function": {"name": "search", "parameters": {}}},
    {"name": "bare_tool", "description": "no function wrapper"}]

CORPUS = (
    "plain answer",
    "",
    "<think>step 1\nstep 2</think>The answer is 4.",
    "<think>still going",
    "<think></think>empty thought",
    "  <think>leading space</think> tail ",
    'Sure.\n<tool_call>{"name": "get_weather", "arguments": {"city": "Paris"}}'
    "</tool_call>",
    "<tool_call>{oops</tool_call>hm",
    '<think>need the weather</think><tool_call>{"name": "get_weather", '
    '"arguments": {}}</tool_call>',
    '<tool_call>{"name": "a", "arguments": {"x": 1}}</tool_call> and '
    '<tool_call>{"name": "b", "arguments": "{\\"y\\": 2}"}</tool_call>',
    '[TOOL_CALLS][{"name": "search", "arguments": {"q": "tpu"}}, '
    '{"name": "open", "arguments": {"id": 3}}]',
    "[TOOL_CALLS] not json",
    '{"name": "get_weather", "parameters": {"city": "Paris"}}',
    '{"name": "get_weather", "arguments": {"city": "Rome"}}',
    "<｜tool▁calls▁begin｜><｜tool▁call▁begin｜>function<｜tool▁sep｜>get_weather\n"
    '```json\n{"city": "Paris"}\n```<｜tool▁call▁end｜><｜tool▁calls▁end｜>'
    "<｜end▁of▁sentence｜>",
    'functools[{"name": "get_weather", "arguments": {"city": "Paris"}}]',
    'The weather tool takes a city argument, e.g. "Paris", and returns a forecast.',
    '{"not": "a call"}',
)

CHUNKS = (1, 3, 7, 1000)
FORCED = ('{"name":"get_weather","arguments":{"city":"Par\\"is","n":3}}',
          '{"name": "f", "arguments": {"x": [1, {"y": "}"}], "z": null}}',
          '{"name":"search","arguments":{}}',
          "not json at all",
          '{"name":"f","arguments":{"x":1}')


def _masked(obj):
    """``obj`` as plain data with every tool-call id replaced."""
    if dataclasses.is_dataclass(obj):
        obj = dataclasses.asdict(obj)
    if isinstance(obj, dict):
        return {k: ("<id>" if k == "id" else _masked(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_masked(v) for v in obj]
    return obj


def _message(mod, text, **kw):
    msg = mod.parse_message(text, **kw)
    return _masked(msg), msg.finish_reason


@pytest.mark.parametrize("text", CORPUS, ids=range(len(CORPUS)))
def test_split_reasoning_matches(text):
    assert parsers.split_reasoning(text) == jax_parsers.split_reasoning(text)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("text", CORPUS, ids=range(len(CORPUS)))
def test_parse_message_matches(text, mode):
    for reasoning in (True, False):
        for tools in (True, False):
            kw = dict(reasoning=reasoning, tools=tools, tool_mode=mode)
            assert _message(parsers, text, **kw) == _message(jax_parsers, text, **kw)


@pytest.mark.parametrize("name", ["parse_hermes_tool_calls", "parse_mistral_tool_calls",
                                  "parse_llama3_json_tool_calls",
                                  "parse_deepseek_tool_calls", "parse_phi4_tool_calls"])
def test_wire_format_parsers_match(name):
    for text in CORPUS:
        got = getattr(parsers, name)(text)
        want = getattr(jax_parsers, name)(text)
        assert _masked(got) == _masked(want), text


@pytest.mark.parametrize("text", FORCED + CORPUS, ids=range(len(FORCED + CORPUS)))
def test_parse_forced_tool_call_matches(text):
    got = parsers.parse_forced_tool_call(text)
    want = jax_parsers.parse_forced_tool_call(text)
    assert _masked(got) == _masked(want)
    assert got.finish_reason == want.finish_reason


def _stream(mod, text, chunk):
    p = mod.StreamingToolCallParser()
    out = []
    for i in range(0, len(text), chunk):
        out += p.feed(text[i:i + chunk])
    return _masked(out + p.finish())


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("text", FORCED, ids=range(len(FORCED)))
def test_streaming_tool_call_parser_matches(text, chunk):
    got = _stream(parsers, text, chunk)
    assert got == _stream(jax_parsers, text, chunk)
    if chunk == 1 and text == FORCED[0]:
        args = "".join(d.get("function", {}).get("arguments", "") for d in got)
        assert json.loads(args) == {"city": 'Par"is', "n": 3}


@pytest.mark.parametrize("text", CORPUS, ids=range(len(CORPUS)))
def test_tool_call_deltas_match(text):
    calls = jax_parsers.parse_message(text, tool_mode="hermes").tool_calls
    assert _masked(parsers.tool_call_deltas(calls)) == \
        _masked(jax_parsers.tool_call_deltas(calls))


@pytest.mark.parametrize("mode", MODES)
def test_render_tools_prompt_matches(mode):
    for tools in (TOOLS, TOOLS[:1], []):
        assert parsers.render_tools_prompt(tools, mode=mode) == \
            jax_parsers.render_tools_prompt(tools, mode=mode)
