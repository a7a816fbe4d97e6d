"""Chat-message formatting.

The reference ships per-model jinja chat templates
(``presets/workspace/inference/chat_templates/*.jinja``, 14 files) fed
to vLLM's ``--chat-template``.  We prefer the HF tokenizer's own
template when locally available; otherwise a model-family template
(llama-3, chatml/qwen, gemma, phi, mistral-inst, deepseek) selected
from the model id, falling back to generic ChatML.
"""

from __future__ import annotations

import json
from typing import Mapping, Optional, Sequence


def normalize_tool_messages(messages: Sequence[Mapping]) -> list:
    """Flatten tool-protocol messages into plain role/content turns.

    The per-family templates only understand ``{"role", "content"}``
    pairs, but multi-turn tool conversations carry two extra shapes the
    OpenAI API defines: assistant messages with a ``tool_calls`` list
    (and often null content), and ``role: "tool"`` result messages.
    Rendering those verbatim would drop the calls and emit an unknown
    role token, so the follow-up generation loses the context of what
    it called and what came back.

    Assistant tool calls are rendered as the same compact JSON envelope
    the constrained decoder emits (``{"name": ..., "arguments": ...}``),
    so the transcript the model sees round-trips its own output format.
    Tool results become ``tool`` turns with the call name folded into
    the content; templates without a native tool role still render them
    as a distinct turn.
    """
    out = []
    for m in messages:
        role = m.get("role", "user")
        if role == "assistant" and m.get("tool_calls"):
            parts = []
            content = m.get("content") or ""
            if content:
                parts.append(content)
            for call in m.get("tool_calls") or ():
                fn = (call or {}).get("function") or {}
                args = fn.get("arguments", "{}")
                if not isinstance(args, str):
                    args = json.dumps(args, separators=(",", ":"))
                parts.append(json.dumps(
                    {"name": fn.get("name", ""), "arguments": args},
                    separators=(",", ":")))
            out.append({"role": "assistant", "content": "\n".join(parts)})
        elif role == "tool":
            content = m.get("content") or ""
            if not isinstance(content, str):
                content = json.dumps(content, separators=(",", ":"))
            name = m.get("name") or ""
            if name:
                content = f"{name}: {content}"
            out.append({"role": "tool", "content": content})
        else:
            out.append(dict(m))
    return out


def _llama3(messages) -> str:
    out = ["<|begin_of_text|>"]
    for m in messages:
        out.append(f"<|start_header_id|>{m.get('role', 'user')}"
                   f"<|end_header_id|>\n\n"
                   f"{m.get('content', '').strip()}<|eot_id|>")
    out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def _chatml(messages) -> str:
    out = []
    for m in messages:
        out.append(f"<|im_start|>{m.get('role', 'user')}\n"
                   f"{m.get('content', '')}<|im_end|>\n")
    out.append("<|im_start|>assistant\n")
    return "".join(out)


def _gemma(messages) -> str:
    out = ["<bos>"]
    for m in messages:
        role = "model" if m.get("role") == "assistant" else "user"
        out.append(f"<start_of_turn>{role}\n{m.get('content', '')}<end_of_turn>\n")
    out.append("<start_of_turn>model\n")
    return "".join(out)


def _phi3(messages) -> str:
    """phi-3 / phi-3.5 (reference phi-3.jinja): ``<|role|>`` turns, no
    BOS, content trimmed."""
    out = []
    for m in messages:
        out.append(f"<|{m.get('role', 'user')}|>\n"
                   f"{m.get('content', '').strip()}<|end|>\n")
    out.append("<|assistant|>\n")
    return "".join(out)


def _phi3_small(messages) -> str:
    """phi-3-small (reference phi-3-small.jinja): the phi-3 body with a
    leading BOS (phi-3-small's tokenizer BOS is ``<|endoftext|>``)."""
    return "<|endoftext|>" + _phi3(messages)


def _phi4(messages) -> str:
    """phi-4 / phi-4-mini (reference phi-4.jinja +
    tool-chat-phi4-mini.jinja): ChatML-with-``<|im_sep|>`` turns — NOT
    the phi-3 shape; the two families diverged at phi-4."""
    out = []
    for m in messages:
        out.append(f"<|im_start|>{m.get('role', 'user')}<|im_sep|>"
                   f"{m.get('content', '')}<|im_end|>")
    out.append("<|im_start|>assistant<|im_sep|>")
    return "".join(out)


def _mistral(messages) -> str:
    """mistral-instruct (reference mistral-instruct.jinja): a leading
    system message rides after the BOS as plain text (NOT inside the
    first [INST]); content is trimmed.  A NON-leading system message —
    where the reference jinja raise_exception's on the broken
    alternation — folds into the next user turn instead of being
    dropped or failing the request."""
    msgs = list(messages)
    lead = ""
    if msgs and msgs[0].get("role") == "system":
        lead = msgs[0].get("content", "").strip() + "\n\n"
        msgs = msgs[1:]
    out = ["<s>" + lead]
    pending_system = ""
    for m in msgs:
        role, content = m.get("role"), m.get("content", "").strip()
        if role == "system":
            pending_system = content
        elif role == "user":
            body = (f"{pending_system}\n\n{content}" if pending_system
                    else content)
            pending_system = ""
            out.append(f"[INST] {body} [/INST]")
        elif role == "assistant":
            out.append(f" {content}</s>")
        elif role == "tool":
            # mistral wire format carries tool results in their own
            # bracketed block, not inside [INST]
            out.append(f"[TOOL_RESULTS] {content} [/TOOL_RESULTS]")
    if pending_system:
        # a TRAILING system message (no user turn after it) still has
        # to steer the generation — emit it as its own instruction
        # block instead of silently dropping it
        out.append(f"[INST] {pending_system} [/INST]")
    return "".join(out)


def _deepseek(messages, strip_think: bool = False) -> str:
    """DeepSeek V3/R1 and the R1 distills (reference templates
    deepseek-r1-distill-*.jinja, tool-chat-deepseek{r1,v3}.jinja): the
    system prompt — wherever it appears — is COLLECTED and emitted once
    after the BOS, then ``<｜User｜>``/``<｜Assistant｜>`` turns.  The
    reasoning variants (``strip_think``) drop everything before the
    final ``</think>`` from prior assistant turns, exactly like the
    reference distill templates."""
    system = ""
    for m in messages:               # LAST system wins (reference ns.
        if m.get("role") == "system":  # system_prompt overwrite loop)
            system = m.get("content", "")
    out = ["<｜begin▁of▁sentence｜>" + system]
    for m in messages:
        role, content = m.get("role"), m.get("content", "")
        if role == "user":
            out.append(f"<｜User｜>{content}")
        elif role == "tool":
            # no dedicated tool turn in the distill templates — feed
            # the result back as a user turn so it isn't dropped
            out.append(f"<｜User｜>{content}")
        elif role == "assistant":
            if strip_think and "</think>" in content:
                content = content.split("</think>")[-1]
            out.append(f"<｜Assistant｜>{content}<｜end▁of▁sentence｜>")
    out.append("<｜Assistant｜>")
    return "".join(out)


def _deepseek_r1(messages) -> str:
    return _deepseek(messages, strip_think=True)


def _generic(messages) -> str:
    parts = []
    for m in messages:
        parts.append(f"<|{m.get('role', 'user')}|>\n{m.get('content', '')}\n")
    parts.append("<|assistant|>\n")
    return "".join(parts)


_FAMILY_TEMPLATES = (
    # ORDER ENCODES PRESET-LEVEL SPECIFICITY (most specific first, the
    # way tool formats key off the preset in engine/parsers.py):
    # - the R1 distills carry llama/qwen in their names but ship
    #   DeepSeek's template, and the reasoning variants strip <think>
    # - phi-3-small adds a BOS to the phi-3 shape; phi-4 switched the
    #   family to ChatML-with-<|im_sep|> (reference templates phi-3,
    #   phi-3-small, phi-4 .jinja all differ)
    (("deepseek-r1", "r1-distill"), _deepseek_r1),
    (("deepseek",), _deepseek),
    (("llama-3", "llama3"), _llama3),
    (("qwen", "chatml", "gpt-oss"), _chatml),
    (("gemma",), _gemma),
    (("phi-3-small",), _phi3_small),
    (("phi-4", "phi4"), _phi4),
    (("phi-", "phi3"), _phi3),
    (("mistral", "ministral", "mixtral"), _mistral),
)


def template_for(model_id: str):
    lowered = (model_id or "").lower()
    for keys, fn in _FAMILY_TEMPLATES:
        if any(k in lowered for k in keys):
            return fn
    return _generic


def render_chat(tokenizer, messages: Sequence[Mapping[str, str]],
                model_id: str = "") -> str:
    messages = normalize_tool_messages(messages)
    apply = getattr(tokenizer, "apply_chat_template", None)
    if apply is not None:
        try:
            return apply(list(messages), tokenize=False,
                         add_generation_prompt=True)
        except Exception:
            pass
    return template_for(model_id)(list(messages))
