"""Token sampling: greedy / temperature / top-k / top-p / min-p, with
presence, frequency and repetition penalties, batched over slots.

Counterpart of ``kaito_tpu.engine.sampler``.  Per-slot knobs live in a
:class:`SamplingState`: host numpy arrays (the engine sets them at
admission) mirrored on the device.  The gates that decide which masking
passes run — any random row, any top-k/top-p row, any min-p row — read
the host arrays, so a fused multi-step decode window never waits on the
device to decide them.  Random draws come from one ``torch.Generator``
per engine (Gumbel-max over the masked logits); they are not the JAX
package's threefry draws, so sampled tokens are compared by
distribution, never token for token.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from kaito_tpu_torch.device import resolve_device

_FIELDS = ("temperature", "top_k", "top_p", "presence", "frequency",
           "repetition", "min_p")
_NEUTRAL = {"temperature": 0.0, "top_k": 0, "top_p": 1.0, "presence": 0.0,
            "frequency": 0.0, "repetition": 1.0, "min_p": 0.0}


@dataclass
class SamplingState:
    """Per-slot sampling knobs, shape [B], plus the engine's generator."""

    temperature: np.ndarray   # 0 => greedy
    top_k: np.ndarray         # 0 => disabled
    top_p: np.ndarray         # 1.0 => disabled
    presence: np.ndarray      # 0 => disabled (OpenAI presence_penalty)
    frequency: np.ndarray     # 0 => disabled (OpenAI frequency_penalty)
    repetition: np.ndarray    # 1 => disabled (HF/vLLM repetition_penalty)
    min_p: np.ndarray         # 0 => disabled (vLLM min_p)
    generator: torch.Generator
    device: torch.device
    _dev: dict = field(default_factory=dict, repr=False)

    @staticmethod
    def create(batch: int, seed: int = 0,
               device: str | torch.device = "cuda") -> "SamplingState":
        """Neutral knobs for ``batch`` slots; the generator and the
        device mirrors live on ``device`` (the card unless the CPU is
        asked for)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        arrays = {f: np.full((batch,), _NEUTRAL[f],
                             np.int32 if f == "top_k" else np.float32)
                  for f in _FIELDS}
        return SamplingState(**arrays, generator=gen, device=dev)

    def reset_slot(self, i: int) -> None:
        """Greedy/no-mask/no-penalty row (retirement)."""
        for f in _FIELDS:
            getattr(self, f)[i] = _NEUTRAL[f]
        self._dev.clear()

    def set_slot(self, i: int, *, temperature: float, top_k: int,
                 top_p: float, presence: float = 0.0, frequency: float = 0.0,
                 repetition: float = 1.0, min_p: float = 0.0) -> None:
        vals = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                    presence=presence, frequency=frequency,
                    repetition=repetition, min_p=min_p)
        for f, v in vals.items():
            getattr(self, f)[i] = v
        self._dev.clear()

    def select(self, idxs) -> "SamplingState":
        """The rows ``idxs`` as a state of their own (same generator)."""
        idxs = np.asarray(idxs, np.int64)
        return SamplingState(**{f: getattr(self, f)[idxs].copy() for f in _FIELDS},
                             generator=self.generator, device=self.device)

    def dev(self, name: str) -> torch.Tensor:
        """Device copy of one knob, uploaded once per change."""
        t = self._dev.get(name)
        if t is None:
            t = self._dev[name] = torch.from_numpy(getattr(self, name)).to(self.device)
        return t

    @property
    def any_penalty(self) -> bool:
        return bool(np.any((self.presence != 0.0) | (self.frequency != 0.0)
                           | (self.repetition != 1.0)))


def chosen_logprob(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """log p(token) per row under the UNMODIFIED model distribution
    (OpenAI logprobs semantics).  logits [B, V] fp32, tokens [B]."""
    lse = torch.logsumexp(logits, dim=-1)
    chosen = torch.gather(logits, 1, tokens.long()[:, None])[:, 0]
    return chosen - lse


def apply_penalties(logits: torch.Tensor, state: SamplingState,
                    counts: torch.Tensor,
                    prompt_seen: Optional[torch.Tensor] = None) -> torch.Tensor:
    """vLLM semantics: presence/frequency consider OUTPUT tokens only
    (``counts``, [B, V] int32 histogram); repetition considers prompt AND
    output (``prompt_seen``, [B, V] bool)."""
    if not state.any_penalty:
        return logits
    c = counts.float()
    out_seen = c > 0
    rep_seen = out_seen if prompt_seen is None else (out_seen | prompt_seen)
    rep = state.dev("repetition")[:, None]
    l = torch.where(rep_seen & (logits > 0), logits / rep,
                    torch.where(rep_seen, logits * rep, logits))
    return l - state.dev("frequency")[:, None] * c \
        - state.dev("presence")[:, None] * out_seen.float()


def _mask_topk_topp(scaled: torch.Tensor, state: SamplingState) -> torch.Tensor:
    V = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = state.dev("top_k").long().clamp(0, V)
    kth = torch.gather(sorted_desc, 1, (k - 1).clamp_min(0)[:, None])
    out = torch.where((k[:, None] > 0) & (scaled < kth), -torch.inf, scaled)
    # top-p (nucleus): keep the smallest prefix of the sorted
    # distribution with cumulative prob >= p
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    cutoff_idx = (cum < state.dev("top_p")[:, None]).sum(dim=-1)
    cutoff_val = torch.gather(sorted_desc, 1, cutoff_idx.clamp(max=V - 1)[:, None])
    return torch.where(out < cutoff_val, -torch.inf, out)


def _mask_min_p(scaled: torch.Tensor, state: SamplingState) -> torch.Tensor:
    # drop tokens whose prob is below min_p * max_prob
    min_p = state.dev("min_p")
    mx = scaled.amax(dim=-1, keepdim=True)
    thresh = mx + torch.log(min_p.clamp_min(1e-10))[:, None]
    keep_all = (min_p <= 0.0)[:, None]
    return torch.where(keep_all | (scaled >= thresh), scaled, -torch.inf)


def sample(logits: torch.Tensor, state: SamplingState, counts=None,
           prompt_seen=None, uniforms: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """One token per row, int32 [B].  logits: [B, V] fp32; counts and
    prompt_seen: the optional [B, V] penalty state.  ``uniforms``
    ([B, V] in (0, 1)) replaces the generator's draws, so a test can
    feed the same noise to two implementations."""
    if counts is not None and counts.shape == logits.shape:
        logits = apply_penalties(logits, state, counts, prompt_seen)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    random_row = state.temperature > 0.0
    if not random_row.any():
        return greedy
    temp = state.dev("temperature").clamp_min(1e-6)[:, None]
    scaled = logits / temp
    if np.any(random_row & ((state.top_k > 0) | (state.top_p < 1.0))):
        scaled = _mask_topk_topp(scaled, state)
    if np.any(random_row & (state.min_p > 0.0)):
        scaled = _mask_min_p(scaled, state)
    if uniforms is None:
        uniforms = torch.rand(scaled.shape, generator=state.generator,
                              device=scaled.device)
    u = uniforms.clamp(1e-20, 1.0 - 1e-7)
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return torch.where(state.dev("temperature") > 0.0, sampled.to(torch.int32),
                       greedy)
