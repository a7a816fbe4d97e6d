"""Tokenizer access.

Prefers a local HuggingFace tokenizer (the reference relies on HF
tokenizers inside vLLM); in network-less environments (tests, synthetic
benches) falls back to a byte-level tokenizer so the whole serving path
stays exercisable end-to-end.
"""

from __future__ import annotations

from typing import Optional, Protocol, Sequence


class Tokenizer(Protocol):
    bos_token_id: Optional[int]
    eos_token_id: Optional[int]

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes + BOS/EOS. Vocab 258."""

    vocab_size = 258

    def __init__(self):
        self.bos_token_id = 256
        self.eos_token_id = 257

    def encode(self, text: str) -> list[int]:
        return [self.bos_token_id] + list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


def load_tokenizer(hf_id: str, vocab_size: int) -> Tokenizer:
    """HF tokenizer if locally cached, else byte-level fallback."""
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(hf_id, local_files_only=True)
        if tok.vocab_size <= vocab_size:
            return tok
    except Exception:
        pass
    return ByteTokenizer()
