"""Tool-call and reasoning-content output parsers.

The reference's presets carry per-model tool/reasoning parser configs
that vLLM applies server-side (`presets/workspace/generator/generator.go`
emits ``--tool-call-parser``/``--reasoning-parser`` flags); this module
is the engine-side counterpart: it turns raw generated text into the
OpenAI response shape — ``tool_calls`` entries for models prompted with
tools, and ``reasoning_content`` split out of think-tagged output
(DeepSeek-R1 style).

Formats covered, keyed by the preset's ``tool_call_parser`` mode
(``models/autogen.derive_parsers``), matching the reference's per-model
tool templates (tool-chat-{hermes,mistral,llama3.1-json,deepseekr1,
deepseekv3,phi4-mini}.jinja):
- hermes:         ``<tool_call>{"name": ..., "arguments": {...}}</tool_call>``
- mistral:        ``[TOOL_CALLS][{"name": ..., "arguments": {...}}, ...]``
- llama3_json:    bare JSON ``{"name": ..., "parameters": {...}}``
- deepseek_v3:    DeepSeek marker blocks (tool-sep + fenced json args)
- phi4_mini_json: ``functools[{"name": ..., "arguments": {...}}, ...]``
- reasoning: ``<think> ... </think>`` prefix

Models fine-tuned on their own call wire format perform measurably
better when prompted in it, so each preset is prompted in its own.
"""

from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass, field
from typing import Optional

_THINK_RE = re.compile(r"^\s*<think>(.*?)</think>\s*", re.S)
_HERMES_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.S)
_MISTRAL_TAG = "[TOOL_CALLS]"
_PHI4_TAG = "functools"
_DS_CALLS_RE = re.compile(
    r"<｜tool▁calls▁begin｜>(.*?)<｜tool▁calls▁end｜>", re.S)
_DS_CALL_RE = re.compile(
    r"<｜tool▁call▁begin｜>\w+<｜tool▁sep｜>([^\n<]+)\n"
    r"```json\n(.*?)\n```\s*<｜tool▁call▁end｜>", re.S)


@dataclass
class ParsedMessage:
    content: str = ""
    reasoning_content: Optional[str] = None
    tool_calls: list[dict] = field(default_factory=list)

    @property
    def finish_reason(self) -> Optional[str]:
        return "tool_calls" if self.tool_calls else None


def split_reasoning(text: str) -> tuple[Optional[str], str]:
    """DeepSeek-R1 style: leading <think>...</think> becomes
    reasoning_content; an unterminated think block (generation cut off
    mid-thought) is all reasoning."""
    m = _THINK_RE.match(text)
    if m:
        return m.group(1).strip(), text[m.end():]
    stripped = text.lstrip()
    if stripped.startswith("<think>"):
        return stripped[len("<think>"):].strip(), ""
    return None, text


def _tool_call_entry(obj: dict) -> Optional[dict]:
    name = obj.get("name")
    if not name:
        return None
    args = obj.get("arguments", obj.get("parameters", {}))
    if not isinstance(args, str):
        args = json.dumps(args)
    return {"id": f"call_{uuid.uuid4().hex[:24]}",
            "type": "function",
            "function": {"name": name, "arguments": args}}


def parse_hermes_tool_calls(text: str) -> tuple[list[dict], str]:
    calls = []
    for m in _HERMES_RE.finditer(text):
        try:
            entry = _tool_call_entry(json.loads(m.group(1)))
        except json.JSONDecodeError:
            continue
        if entry:
            calls.append(entry)
    if calls:
        text = _HERMES_RE.sub("", text).strip()
    return calls, text


def parse_mistral_tool_calls(text: str) -> tuple[list[dict], str]:
    i = text.find(_MISTRAL_TAG)
    if i < 0:
        return [], text
    payload = text[i + len(_MISTRAL_TAG):].strip()
    try:
        decoded = json.JSONDecoder().raw_decode(payload)
    except json.JSONDecodeError:
        return [], text
    objs, end = decoded
    if isinstance(objs, dict):
        objs = [objs]
    if not isinstance(objs, list):
        return [], text          # scalar after the tag: not a tool call
    calls = [e for e in (_tool_call_entry(o) for o in objs
                         if isinstance(o, dict)) if e]
    if not calls:
        return [], text
    rest = (text[:i] + payload[end:]).strip()
    return calls, rest


def parse_llama3_json_tool_calls(text: str) -> tuple[list[dict], str]:
    """llama-3.1 JSON tool format: the reply IS a bare JSON object
    ``{"name": ..., "parameters": {...}}`` (several may follow,
    ``;``-separated).  Only a leading object counts — JSON quoted
    mid-prose is content, not a call."""
    dec = json.JSONDecoder()
    calls = []
    rest = text.strip()
    while rest.startswith("{"):
        try:
            obj, end = dec.raw_decode(rest)
        except json.JSONDecodeError:
            break
        if not (isinstance(obj, dict) and obj.get("name")
                and ("parameters" in obj or "arguments" in obj)):
            break
        entry = _tool_call_entry(obj)
        if not entry:
            break
        calls.append(entry)
        rest = rest[end:].lstrip()
        if rest.startswith(";"):
            rest = rest[1:].lstrip()
    return (calls, rest) if calls else ([], text)


def parse_deepseek_tool_calls(text: str) -> tuple[list[dict], str]:
    """DeepSeek V3/R1 marker blocks (tool-chat-deepseekv3.jinja):
    ``<｜tool▁call▁begin｜>function<｜tool▁sep｜>NAME\\n```json\\nARGS\\n```
    <｜tool▁call▁end｜>`` wrapped in calls-begin/end markers."""
    calls = []
    block = _DS_CALLS_RE.search(text)
    scope = block.group(1) if block else text
    for m in _DS_CALL_RE.finditer(scope):
        try:
            args = json.loads(m.group(2))
        except json.JSONDecodeError:
            continue
        entry = _tool_call_entry({"name": m.group(1).strip(),
                                  "arguments": args})
        if entry:
            calls.append(entry)
    if not calls:
        return [], text
    if block:
        rest = (text[:block.start()] + text[block.end():]).strip()
    else:
        rest = _DS_CALL_RE.sub("", text).strip()
    rest = rest.replace("<｜end▁of▁sentence｜>", "").strip()
    return calls, rest


def parse_phi4_tool_calls(text: str) -> tuple[list[dict], str]:
    """phi-4-mini functools format: ``functools[{...}, ...]`` (no
    closing marker, tool-chat-phi4-mini.jinja)."""
    i = text.find(_PHI4_TAG + "[")
    if i < 0:
        return [], text
    payload = text[i + len(_PHI4_TAG):]
    try:
        objs, end = json.JSONDecoder().raw_decode(payload)
    except json.JSONDecodeError:
        return [], text
    if not isinstance(objs, list):
        return [], text
    calls = [e for e in (_tool_call_entry(o) for o in objs
                         if isinstance(o, dict)) if e]
    if not calls:
        return [], text
    return calls, (text[:i] + payload[end:]).strip()


_TOOL_PARSERS = {
    "hermes": parse_hermes_tool_calls,
    "mistral": parse_mistral_tool_calls,
    "llama3_json": parse_llama3_json_tool_calls,
    "deepseek_v3": parse_deepseek_tool_calls,
    "phi4_mini_json": parse_phi4_tool_calls,
}


def parse_message(text: str, reasoning: bool = True,
                  tools: bool = True, tool_mode: str = "") -> ParsedMessage:
    """Full output post-processing: reasoning split, then tool-call
    extraction — the preset's parser mode first, hermes fallback (a
    model drifting to the prompt's example format must still parse)."""
    reasoning_content = None
    if reasoning:
        reasoning_content, text = split_reasoning(text)
    calls: list[dict] = []
    if tools:
        primary = _TOOL_PARSERS.get(tool_mode)
        if primary is not None:
            calls, text = primary(text)
        if not calls and primary is not parse_hermes_tool_calls:
            calls, text = parse_hermes_tool_calls(text)
        if not calls and primary is None:
            calls, text = parse_mistral_tool_calls(text)
    return ParsedMessage(content=text, reasoning_content=reasoning_content,
                         tool_calls=calls)


def parse_forced_tool_call(text: str) -> ParsedMessage:
    """Parse a grammar-forced tool call (docs/structured-output.md):
    with ``tool_choice`` required/named the generation is constrained
    to the pure-JSON envelope ``{"name": ..., "arguments": {...}}``, so
    extraction is a direct json.loads — no wire-format scan, no
    fallback chain.  A parse failure here would mean the grammar let an
    invalid envelope through; surface it as plain content rather than
    500 the request."""
    try:
        obj = json.loads(text)
    except json.JSONDecodeError:
        return ParsedMessage(content=text)
    entry = _tool_call_entry(obj) if isinstance(obj, dict) else None
    if entry is None:
        return ParsedMessage(content=text)
    return ParsedMessage(content="", tool_calls=[entry])


def tool_call_deltas(calls: list[dict]) -> list[dict]:
    """OpenAI streaming shape for a finished set of tool calls: one
    opening delta per call (id + name + empty arguments) followed by
    one arguments delta — what a client-side accumulator expects."""
    out = []
    for i, c in enumerate(calls):
        fn = c["function"]
        out.append({"index": i, "id": c["id"], "type": "function",
                    "function": {"name": fn["name"], "arguments": ""}})
        if fn["arguments"]:
            out.append({"index": i,
                        "function": {"arguments": fn["arguments"]}})
    return out


class StreamingToolCallParser:
    """Incremental ``tool_calls`` deltas for a grammar-forced call.

    The forced envelope is canonical compact JSON with a fixed property
    order — ``{"name":"...","arguments":{...}}`` — so the name is
    extractable as soon as its closing quote lands, and everything
    between ``"arguments":`` and the envelope's closing brace streams
    through as argument bytes the moment it arrives.  ``feed`` returns
    the deltas unlocked by each text increment; ``finish`` flushes
    whatever a truncated generation left."""

    _NAME_RE = re.compile(r'^\s*\{"name":"((?:[^"\\]|\\.)*)"\s*,'
                          r'\s*"arguments":')

    def __init__(self):
        self.buf = ""
        self.call_id = f"call_{uuid.uuid4().hex[:24]}"
        self._args_from: Optional[int] = None  # buf offset of args value
        self._sent_args = 0                    # arg chars already emitted
        self._done = False

    def feed(self, text_delta: str) -> list[dict]:
        self.buf += text_delta
        out: list[dict] = []
        if self._args_from is None:
            m = self._NAME_RE.match(self.buf)
            if not m:
                return out
            self._args_from = m.end()
            name = json.loads(f'"{m.group(1)}"')
            out.append({"index": 0, "id": self.call_id,
                        "type": "function",
                        "function": {"name": name, "arguments": ""}})
        if not self._done:
            chunk = self._pending_args()
            if chunk:
                self._sent_args += len(chunk)
                out.append({"index": 0,
                            "function": {"arguments": chunk}})
        return out

    def finish(self) -> list[dict]:
        return self.feed("")

    def _pending_args(self) -> str:
        """Argument chars that are safely part of the value: scan from
        the args offset tracking brace depth and string state; the
        brace that returns the ENVELOPE to depth 0 is the terminator
        and never streams."""
        s = self.buf[self._args_from:]
        depth, in_str, esc = 1, False, False   # envelope brace is open
        for j, ch in enumerate(s):
            if esc:
                esc = False
                continue
            if in_str:
                if ch == "\\":
                    esc = True
                elif ch == '"':
                    in_str = False
                continue
            if ch == '"':
                in_str = True
            elif ch in "{[":
                depth += 1
            elif ch in "}]":
                depth -= 1
                if depth == 0:
                    self._done = True
                    return s[self._sent_args:j]
        # mid-value: emit everything except a possible trailing escape
        end = len(s) - 1 if esc else len(s)
        return s[self._sent_args:end]


def _tool_specs(tools: list[dict]) -> list[dict]:
    specs = []
    for t in tools or []:
        fn = t.get("function", t)
        specs.append({"name": fn.get("name", ""),
                      "description": fn.get("description", ""),
                      "parameters": fn.get("parameters", {})})
    return specs


def render_tools_prompt(tools: list[dict], mode: str = "hermes") -> str:
    """System-message block advertising the tools in the call wire
    format the model was fine-tuned on (mode = the preset's
    tool_call_parser; hermes for unknown modes)."""
    specs = _tool_specs(tools)
    listing = json.dumps(specs, indent=2)
    if mode == "llama3_json":
        return (
            "You have access to the following functions. To call a "
            "function, please respond with JSON for a function call. "
            'Respond in the format {"name": function name, "parameters": '
            "dictionary of argument name and its value}. "
            "Do not use variables.\n\n" + listing
        )
    if mode == "mistral":
        return (
            "[AVAILABLE_TOOLS]" + json.dumps(specs) + "[/AVAILABLE_TOOLS]\n"
            "To call a tool, reply with exactly:\n"
            '[TOOL_CALLS][{"name": "<tool-name>", "arguments": {...}}]'
        )
    if mode == "deepseek_v3":
        return (
            "## Tools\n\nYou have access to the following tools:\n"
            + listing
            + "\n\nFor each function call, you should return an object "
            "like:\n<｜tool▁call▁begin｜>function<｜tool▁sep｜>"
            "<function_name>\n```json\n<function_arguments_in_json_format>"
            "\n```<｜tool▁call▁end｜>\nWrap all calls between "
            "<｜tool▁calls▁begin｜> and <｜tool▁calls▁end｜>."
        )
    if mode == "phi4_mini_json":
        return (
            "You have access to the following tools:\n" + listing
            + "\n\nIf you decide to call functions:\n"
            "  * prefix function calls with the functools marker "
            "(no closing marker required)\n"
            "  * format all calls as a single JSON list: "
            'functools[{"name": "<tool-name>", "arguments": {...}}, ...]'
        )
    return (
        "You have access to the following tools:\n" + listing
        + "\n\nTo call a tool, reply with exactly:\n"
        + '<tool_call>{"name": "<tool-name>", "arguments": {...}}'
        + "</tool_call>"
    )
