"""Token sampling: greedy / temperature / top-k / top-p / min-p, with
presence, frequency and repetition penalties, batched over slots.

Counterpart of ``kaito_tpu.engine.sampler``.  Per-slot knobs live in a
:class:`SamplingState`: host numpy arrays (the engine sets them at
admission) mirrored on the device in one buffer per knob, kept for the
state's life and refreshed in place, so a captured decode graph keeps
reading them.  The gates that decide which passes run — any random row,
any top-k/top-p row, any min-p row, any penalty (:meth:`SamplingState.gates`)
— read the host arrays, so a fused multi-step decode window never waits
on the device to decide them, and a captured window is keyed by them.
Random draws come from one ``torch.Generator`` per engine (Gumbel-max
over the masked logits); they are not the JAX package's threefry draws,
so sampled tokens are compared by distribution, never token for token.
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
_TORCH = {np.int32: torch.int32, np.float32: torch.float32}


@dataclass
class SamplingState:
    """Per-slot sampling knobs, shape [B], plus the engine's generator.

    The host arrays are authoritative; :meth:`set_slot` and
    :meth:`reset_slot` mark the device mirrors stale and :meth:`refresh`
    copies every knob into its buffer (through pinned staging on the
    card), which :meth:`dev` does on first use after a change."""

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
    _stage: dict = field(default_factory=dict, repr=False)
    _copied: Optional[torch.cuda.Event] = field(default=None, repr=False)
    _stale: bool = field(default=True, repr=False)

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
        self._stale = True

    def set_slot(self, i: int, *, temperature: float, top_k: int,
                 top_p: float, presence: float = 0.0, frequency: float = 0.0,
                 repetition: float = 1.0, min_p: float = 0.0) -> None:
        vals = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                    presence=presence, frequency=frequency,
                    repetition=repetition, min_p=min_p)
        for f, v in vals.items():
            getattr(self, f)[i] = v
        self._stale = True

    def select(self, idxs) -> "SamplingState":
        """The rows ``idxs`` as a state of their own (same generator)."""
        idxs = np.asarray(idxs, np.int64)
        return SamplingState(**{f: getattr(self, f)[idxs].copy() for f in _FIELDS},
                             generator=self.generator, device=self.device)

    def refresh(self) -> bool:
        """Copy the host knobs into the device buffers if a slot changed
        since the last copy; True when it copied.  Raises under CUDA graph
        capture: a captured copy would replay stale staging."""
        if not self._stale:
            return False
        cuda = self.device.type == "cuda"
        if cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("sampling knobs changed during CUDA graph capture; "
                               "refresh them before capturing")
        if self._copied is not None:
            self._copied.synchronize()      # the staging is free to rewrite
        for f in _FIELDS:
            a = getattr(self, f)
            if f not in self._dev:
                self._dev[f] = torch.empty(a.shape, dtype=_TORCH[a.dtype.type],
                                           device=self.device)
                self._stage[f] = torch.empty(a.shape, dtype=_TORCH[a.dtype.type],
                                             pin_memory=cuda)
            self._stage[f].copy_(torch.from_numpy(a))
            self._dev[f].copy_(self._stage[f], non_blocking=cuda)
        if cuda:
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(self.device))
        self._stale = False
        return True

    def dev(self, name: str) -> torch.Tensor:
        """The device buffer of one knob (the same tensor for the state's
        life), refreshed first if a slot changed."""
        self.refresh()
        return self._dev[name]

    @property
    def any_penalty(self) -> bool:
        return bool(np.any((self.presence != 0.0) | (self.frequency != 0.0)
                           | (self.repetition != 1.0)))

    def gates(self) -> tuple[bool, bool, bool, bool]:
        """(any random row, any random top-k/top-p row, any random min-p
        row, any penalty row): the host gates that decide which passes
        :func:`sample` runs, and part of a captured window's key."""
        rnd = self.temperature > 0.0
        return (bool(rnd.any()),
                bool(np.any(rnd & ((self.top_k > 0) | (self.top_p < 1.0)))),
                bool(np.any(rnd & (self.min_p > 0.0))),
                self.any_penalty)


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
    random_row, topk_topp, min_p, _ = state.gates()
    if counts is not None and counts.shape == logits.shape:
        logits = apply_penalties(logits, state, counts, prompt_seen)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not random_row:
        return greedy
    temp = state.dev("temperature").clamp_min(1e-6)[:, None]
    scaled = logits / temp
    if topk_topp:
        scaled = _mask_topk_topp(scaled, state)
    if min_p:
        scaled = _mask_min_p(scaled, state)
    if uniforms is None:
        uniforms = torch.rand(scaled.shape, generator=state.generator,
                              device=scaled.device)
    u = uniforms.clamp(1e-20, 1.0 - 1e-7)
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return torch.where(state.dev("temperature") > 0.0, sampled.to(torch.int32),
                       greedy)
