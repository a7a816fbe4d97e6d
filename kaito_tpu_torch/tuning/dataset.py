"""Dataset loading & formatting for tuning jobs.

The port's own copy of ``kaito_tpu.tuning.dataset`` (numpy only):
jsonl/json/plain-text files from the data dir, instruction/response or
messages formats, tokenize, pad into fixed-length examples with loss
masks, and seeded batches.  The same data, tokenizer and seeds give the
JAX package's examples and batches.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class DatasetConfig:
    data_dir: str = ""
    instruction_column: str = "instruction"
    response_column: str = "response"
    messages_column: str = "messages"
    context_column: str = "context"
    max_seq_len: int = 512
    train_split: float = 0.95
    shuffle_seed: int = 0


def _iter_records(data_dir: str) -> Iterator[dict]:
    for fname in sorted(os.listdir(data_dir)):
        path = os.path.join(data_dir, fname)
        if fname.endswith(".jsonl"):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield json.loads(line)
        elif fname.endswith(".json"):
            with open(path) as f:
                data = json.load(f)
            if isinstance(data, list):
                yield from data
        elif fname.endswith(".txt"):
            with open(path) as f:
                for para in f.read().split("\n\n"):
                    if para.strip():
                        yield {"text": para.strip()}


def format_record(rec: dict, cfg: DatasetConfig) -> tuple[str, str]:
    """Returns (prompt, response); response tokens carry the loss."""
    if cfg.messages_column in rec:
        msgs = rec[cfg.messages_column]
        prompt_parts, response = [], ""
        for m in msgs:
            if m.get("role") == "assistant":
                response = m.get("content", "")
            else:
                prompt_parts.append(f"<|{m.get('role','user')}|>\n{m.get('content','')}")
        return "\n".join(prompt_parts) + "\n<|assistant|>\n", response
    if cfg.instruction_column in rec:
        ctx = rec.get(cfg.context_column, "")
        prompt = rec[cfg.instruction_column] + (f"\n{ctx}" if ctx else "") + "\n"
        return prompt, str(rec.get(cfg.response_column, ""))
    return "", str(rec.get("text", ""))


def build_examples(tokenizer, cfg: DatasetConfig):
    """Tokenize + pad to max_seq_len. Returns dict of numpy arrays:
    tokens [N, T+1] and mask [N, T] (loss on response tokens only)."""
    eos = tokenizer.eos_token_id
    T = cfg.max_seq_len
    toks_out, mask_out = [], []
    for rec in _iter_records(cfg.data_dir):
        prompt, response = format_record(rec, cfg)
        p_ids = tokenizer.encode(prompt) if prompt else []
        r_ids = [t for t in tokenizer.encode(response)
                 if t != tokenizer.bos_token_id]
        ids = (p_ids + r_ids)[: T]
        if eos is not None and len(ids) < T:
            ids = ids + [eos]
        if len(ids) < 2:
            continue
        row = np.zeros(T + 1, np.int32)
        row[: len(ids)] = ids
        # loss mask over predicted positions: response tokens only
        mask = np.zeros(T, np.float32)
        start = max(len(p_ids) - 1, 0)
        mask[start: len(ids) - 1] = 1.0
        toks_out.append(row)
        mask_out.append(mask)
    if not toks_out:
        raise ValueError(f"no training records found in {cfg.data_dir}")
    tokens = np.stack(toks_out)
    masks = np.stack(mask_out)
    rng = np.random.RandomState(cfg.shuffle_seed)
    order = rng.permutation(len(tokens))
    tokens, masks = tokens[order], masks[order]
    n_train = max(1, int(len(tokens) * cfg.train_split))
    return ({"tokens": tokens[:n_train], "mask": masks[:n_train]},
            {"tokens": tokens[n_train:], "mask": masks[n_train:]})


def batches(data: dict, batch_size: int, seed: int = 0,
            drop_last: bool = False) -> Iterator[dict]:
    n = len(data["tokens"])
    rng = np.random.RandomState(seed)
    order = rng.permutation(n)
    for i in range(0, n, batch_size):
        idx = order[i: i + batch_size]
        if len(idx) < batch_size:
            if drop_last or len(idx) == 0:
                return
            # pad the final batch by repetition to keep shapes static
            idx = np.concatenate([idx, order[: batch_size - len(idx)]])
        yield {"tokens": data["tokens"][idx], "mask": data["mask"][idx]}
