"""Prefix-block hashes of a request body, as the router computes them.

The port's own copy of the part of ``kaito_tpu/runtime/routing.py`` the
cluster KV pool needs: the chained FNV-1a block hashes of a prompt's
bytes (``prefix_blocks``), the adapter seed folded into the chain
(``adapter_seed``) and the prompt text the hashes are taken over
(``extract_prompt_text``).  The engine's pool publisher and the
router's prefix index must hash the same bytes the same way, bit for
bit, or the cluster index never matches.
"""

from __future__ import annotations

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def _fnv1a(data: bytes, seed: int) -> int:
    h = (_FNV_OFFSET ^ seed) & _MASK64
    for byte in data:
        h = ((h ^ byte) * _FNV_PRIME) & _MASK64
    return h


def adapter_seed(adapter: str) -> int:
    """Chain seed folding a LoRA adapter name into the block hashes: KV
    computed under adapter deltas must never hash-match base KV (or
    another adapter's) for the same text.  "" (the base) is seed 0."""
    return _fnv1a(adapter.encode("utf-8", "replace"), 0) if adapter else 0


def prefix_blocks(text: str, block_chars: int, seed: int = 0) -> list[int]:
    """Chained block hashes of a prompt prefix: block i's hash folds in
    block i-1's, so equal blocks at different depths hash differently.
    A trailing partial block is dropped (only whole KV pages are ever
    reused).  ``seed`` namespaces the whole chain (``adapter_seed``)."""
    if block_chars <= 0:
        return []
    data = text.encode("utf-8", "replace")
    out: list[int] = []
    parent = seed & _MASK64
    for i in range(len(data) // block_chars):
        parent = _fnv1a(data[i * block_chars:(i + 1) * block_chars], parent)
        out.append(parent)
    return out


def extract_prompt_text(obj) -> str:
    """The prompt string the hashes are taken over, from a parsed request
    body: ``prompt``, else the ``messages`` with their role markers (so
    the same content under another role maps to other blocks)."""
    if not isinstance(obj, dict):
        return ""
    prompt = obj.get("prompt")
    if isinstance(prompt, str):
        return prompt
    msgs = obj.get("messages")
    if isinstance(msgs, list):
        return "".join(f"<{m.get('role', '')}>{m.get('content', '')}"
                       for m in msgs if isinstance(m, dict))
    return ""
