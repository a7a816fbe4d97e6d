"""Workspace LLM client: chat-completion passthrough with retrieval
context injection.

Parity with the reference's inference client
(``presets/ragengine/inference/inference.py:67-340``): context-window
enforcement, max_tokens clamping, passthrough of OpenAI params, sync
and SSE streaming against the workspace endpoint.

A copy of ``kaito_tpu.rag.llm_client``.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Iterator, Optional

CONTEXT_TEMPLATE = (
    "Use the following retrieved context to answer.\n"
    "<context>\n{context}\n</context>\n")


def inject_context(messages: list[dict], contexts: list[dict],
                   context_window: int) -> list[dict]:
    """Prepend retrieved passages as a system message, trimming to fit
    the model's context window (approximate 4-chars/token budget, the
    same pragmatic clamp the reference applies)."""
    if not contexts:
        return messages
    budget_chars = max(context_window * 4 - sum(
        len(m.get("content", "")) for m in messages) - 512, 0)
    parts, used = [], 0
    for c in contexts:
        t = c["text"]
        if used + len(t) > budget_chars:
            break
        parts.append(t)
        used += len(t)
    if not parts:
        return messages
    ctx_msg = {"role": "system",
               "content": CONTEXT_TEMPLATE.format(context="\n---\n".join(parts))}
    return [ctx_msg] + list(messages)


class LLMClient:
    def __init__(self, base_url: str, access_secret: str = "",
                 context_window: int = 8192):
        self.base_url = base_url.rstrip("/")
        if self.base_url.endswith("/v1"):
            self.base_url = self.base_url[:-3]
        self.secret = access_secret
        self.context_window = context_window

    def _request(self, payload: dict) -> urllib.request.Request:
        return urllib.request.Request(
            f"{self.base_url}/v1/chat/completions",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json",
                     **({"Authorization": f"Bearer {self.secret}"}
                        if self.secret else {})})

    def _clamp(self, payload: dict) -> dict:
        payload = dict(payload)
        approx_prompt = sum(len(m.get("content", "")) for m in
                            payload.get("messages", [])) // 4
        room = max(self.context_window - approx_prompt - 16, 16)
        payload["max_tokens"] = min(int(payload.get("max_tokens") or 256), room)
        return payload

    def chat(self, payload: dict) -> dict:
        payload = self._clamp({**payload, "stream": False})
        with urllib.request.urlopen(self._request(payload), timeout=600) as r:
            return json.loads(r.read())

    def chat_stream(self, payload: dict) -> Iterator[dict]:
        """Yields parsed SSE chunk objects from the upstream."""
        payload = self._clamp({**payload, "stream": True})
        resp = urllib.request.urlopen(self._request(payload), timeout=600)
        for raw in resp:
            line = raw.strip()
            if not line.startswith(b"data: "):
                continue
            data = line[6:]
            if data == b"[DONE]":
                return
            yield json.loads(data)
