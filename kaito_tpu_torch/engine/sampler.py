"""Token sampling: greedy / temperature / top-k / top-p / min-p, with
presence, frequency and repetition penalties, batched over slots; and
the speculative verifier's rejection sampler.

Counterpart of ``kaito_tpu.engine.sampler``.  Per-slot knobs live in a
:class:`SamplingState`: host numpy arrays (the engine sets them at
admission) mirrored on the device in one buffer per knob, kept for the
state's life and refreshed in place, so a captured decode graph keeps
reading them.  The gates that decide which passes run — any random row,
any top-k/top-p row, any min-p row, any penalty (:meth:`SamplingState.gates`)
— read the host arrays, so a fused multi-step decode window never waits
on the device to decide them, and a captured window is keyed by them.

Random draws are the JAX package's, bit for bit: each row owns a
threefry-2x32 key (two uint32 words, held in an int64 ``[B, 2]`` device
buffer), set at admission to ``fold_in(PRNGKey(seed), slot)`` and split
in place at each draw (``new, sub = split(key)``), and a draw is
``jax.random.categorical(sub, logits)``: Gumbel noise from the uniform
of the key's counter-mode bits (``bits >> 9`` as a float in [1, 2)),
added to the logits, then the argmax.  Every step is plain integer and
float arithmetic on tensors (:func:`threefry2x32` works on Python ints
as well), so the key buffer lives inside a captured window and no
``torch.Generator`` is involved.  Seeded requests therefore reproduce,
and sampled tokens compare with the JAX engine's token for token.
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

# ---------------------------------------------------------------------------
# threefry-2x32 keys (jax.random's default implementation)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000
_F32_TINY = float(np.finfo(np.float32).tiny)


def threefry2x32(k0, k1, x0, x1):
    """The threefry-2x32 hash of counters (x0, x1) under key (k0, k1):
    JAX's ``threefry2x32_p`` (20 rounds, 5 key injections).  Works on
    Python ints and on int64 tensors holding uint32 values (broadcast);
    returns the two output words, each in [0, 2**32).  Only the low 32
    bits of x0 are kept between rounds (an add's low bits do not depend
    on the high ones), so x0 is masked once at the end."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & _M32
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0 & _M32, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.key_data(jax.random.PRNGKey(seed))`` for an integer
    seed (32-bit JAX: the high word 0, the low word the seed mod 2**32)."""
    return 0, int(seed) & _M32


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in`` on host key words."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M32)


def slot_key(seed: int, slot: int) -> tuple[int, int]:
    """A slot's key at admission: ``fold_in(PRNGKey(seed), slot)``."""
    return fold_in(prng_key(seed), slot)


def split_keys(keys: torch.Tensor, n: int) -> list[torch.Tensor]:
    """``jax.random.split(key, n)`` of every row of ``keys`` [..., 2]
    (int64 words): the i-th piece is ``fold_in(key, i)`` (JAX's
    partitionable split counts (0, i))."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., :1], keys[..., 1:], 0, i)      # [..., n]
    return list(torch.stack([y0, y1], dim=-1).unbind(-2))


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per row and counter, int64 [B, n]: JAX's
    partitionable ``random_bits(key, 32, (n,))`` of each row's key
    (counters (0, j), the two output words xored)."""
    j = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], 0, j[None, :])
    return y0 ^ y1


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, 1.0)`` of each
    row, fp32 [B, n]: the top 23 bits as the mantissa of a float in
    [1, 2), less one, scaled into [minval, 1)."""
    bits = (random_bits(keys, n) >> 9) | _F32_ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    span = float(torch.tensor(1.0, dtype=torch.float32) - lo)   # fp32 rounding, as JAX
    return torch.clamp_min(floats * span + float(lo), float(lo))


def gumbel_noise(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` (mode "low") of each row."""
    return -torch.log(-torch.log(uniform(keys, n, _F32_TINY)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, row)`` of each row: the argmax of
    the row plus its key's Gumbel noise.  int64 [B]."""
    return torch.argmax(gumbel_noise(keys, logits.shape[-1]) + logits, dim=-1)


# ---------------------------------------------------------------------------
# per-slot state
# ---------------------------------------------------------------------------

@dataclass
class SamplingState:
    """Per-slot sampling knobs, shape [B], and per-slot PRNG keys.

    The host arrays of the knobs are authoritative; :meth:`set_slot` and
    :meth:`reset_slot` mark the device mirrors stale and :meth:`refresh`
    copies every knob into its buffer (through pinned staging on the
    card), which :meth:`dev` does on first use after a change.  The keys
    live on the device only (a draw advances them there, in place);
    :meth:`set_slot` stages a slot's new key, which the next refresh
    writes into its row."""

    temperature: np.ndarray   # 0 => greedy
    top_k: np.ndarray         # 0 => disabled
    top_p: np.ndarray         # 1.0 => disabled
    presence: np.ndarray      # 0 => disabled (OpenAI presence_penalty)
    frequency: np.ndarray     # 0 => disabled (OpenAI frequency_penalty)
    repetition: np.ndarray    # 1 => disabled (HF/vLLM repetition_penalty)
    min_p: np.ndarray         # 0 => disabled (vLLM min_p)
    keys: torch.Tensor        # [B, 2] int64 uint32 words, on the device
    device: torch.device
    _dev: dict = field(default_factory=dict, repr=False)
    _stage: dict = field(default_factory=dict, repr=False)
    _copied: Optional[torch.cuda.Event] = field(default=None, repr=False)
    _stale: bool = field(default=True, repr=False)
    _new_keys: dict = field(default_factory=dict, repr=False)

    @staticmethod
    def create(batch: int, seed: int = 0,
               device: str | torch.device = "cuda") -> "SamplingState":
        """Neutral knobs for ``batch`` slots, the keys
        ``split(PRNGKey(seed), batch)``; the device mirrors and the keys
        live on ``device`` (the card unless the CPU is asked for)."""
        dev = resolve_device(device)
        arrays = {f: np.full((batch,), _NEUTRAL[f],
                             np.int32 if f == "top_k" else np.float32)
                  for f in _FIELDS}
        root = prng_key(seed)
        keys = torch.tensor([fold_in(root, i) for i in range(batch)],
                            dtype=torch.int64, device=dev)
        return SamplingState(**arrays, keys=keys, device=dev)

    def reset_slot(self, i: int) -> None:
        """Greedy/no-mask/no-penalty row (retirement); the key stays
        (admission reseeds it)."""
        for f in _FIELDS:
            getattr(self, f)[i] = _NEUTRAL[f]
        self._stale = True

    def set_slot(self, i: int, *, temperature: float, top_k: int,
                 top_p: float, presence: float = 0.0, frequency: float = 0.0,
                 repetition: float = 1.0, min_p: float = 0.0,
                 seed: int = 0) -> None:
        """Admission: the row's knobs, and its key
        ``fold_in(PRNGKey(seed), i)`` (the engine passes the request's
        seed, else its request count)."""
        vals = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                    presence=presence, frequency=frequency,
                    repetition=repetition, min_p=min_p)
        for f, v in vals.items():
            getattr(self, f)[i] = v
        self._new_keys[i] = slot_key(seed, i)
        self._stale = True

    def select(self, idxs) -> "SamplingState":
        """The rows ``idxs`` as a state of their own, with a copy of
        their keys (:meth:`scatter_keys` writes a draw's keys back)."""
        idxs = np.asarray(idxs, np.int64)
        keys = self.key_buffer()[torch.from_numpy(idxs).to(self.device)]
        return SamplingState(**{f: getattr(self, f)[idxs].copy() for f in _FIELDS},
                             keys=keys, device=self.device)

    def scatter_keys(self, idxs, sub: "SamplingState") -> None:
        """Write the keys of ``sub`` (a :meth:`select` of ``idxs``) back
        into their rows."""
        idx = torch.from_numpy(np.asarray(idxs, np.int64)).to(self.device)
        self.key_buffer().index_copy_(0, idx, sub.keys)

    def refresh(self) -> bool:
        """Copy the host knobs into the device buffers, and staged keys
        into their rows, if a slot changed since the last copy; True when
        it copied.  Raises under CUDA graph capture: a captured copy
        would replay stale staging."""
        if not self._stale:
            return False
        cuda = self.device.type == "cuda"
        if cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("sampling knobs changed during CUDA graph capture; "
                               "refresh them before capturing")
        if self._copied is not None:
            self._copied.synchronize()      # the staging is free to rewrite
        B = self.temperature.shape[0]
        rows = np.zeros((B,), bool)
        words = np.zeros((B, 2), np.int64)
        for i, k in self._new_keys.items():
            rows[i] = True
            words[i] = k
        host = dict({f: getattr(self, f) for f in _FIELDS},
                    key_rows=rows, key_words=words)
        for f, a in host.items():
            if f not in self._dev:
                dt = torch.from_numpy(a[:0]).dtype
                self._dev[f] = torch.empty(a.shape, dtype=dt, device=self.device)
                self._stage[f] = torch.empty(a.shape, dtype=dt, pin_memory=cuda)
            if f.startswith("key_") and not self._new_keys:
                continue
            self._stage[f].copy_(torch.from_numpy(a))
            self._dev[f].copy_(self._stage[f], non_blocking=cuda)
        if self._new_keys:
            self.keys.copy_(torch.where(self._dev["key_rows"][:, None],
                                        self._dev["key_words"], self.keys))
            self._new_keys.clear()
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

    def key_buffer(self) -> torch.Tensor:
        """The ``[B, 2]`` key buffer (the same tensor for the state's
        life), staged keys written first."""
        self.refresh()
        return self.keys

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
           prompt_seen=None, uniforms: Optional[torch.Tensor] = None,
           active: Optional[torch.Tensor] = None,
           grammar_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token per row, int32 [B].  logits: [B, V] fp32; counts and
    prompt_seen: the optional [B, V] penalty state; grammar_rows: the
    optional [B, V] fp32 0 / -inf grammar masks, gathered per row and
    added after the penalties and before temperature, so the greedy,
    top-k/top-p, min-p and categorical paths all honour them (an
    unconstrained row carries an all-zero row).  When any row
    samples, every row's key splits (``new, sub = split(key)``), the
    draw is ``categorical(sub, scaled logits)``, and the keys of the
    ``active`` rows (every row when None) advance to ``new`` in place;
    an all-greedy batch leaves the keys alone.  ``uniforms`` ([B, V] in
    (0, 1)) replaces the keys' uniforms, so a test can feed the same
    noise to two implementations."""
    random_row, topk_topp, min_p, _ = state.gates()
    if counts is not None and counts.shape == logits.shape:
        logits = apply_penalties(logits, state, counts, prompt_seen)
    if grammar_rows is not None:
        logits = logits + grammar_rows
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not random_row:
        return greedy
    temp = state.dev("temperature").clamp_min(1e-6)[:, None]
    scaled = logits / temp
    if topk_topp:
        scaled = _mask_topk_topp(scaled, state)
    if min_p:
        scaled = _mask_min_p(scaled, state)
    keys = state.key_buffer()
    new, sub = split_keys(keys, 2)
    if uniforms is None:
        noise = gumbel_noise(sub, scaled.shape[-1])
    else:
        noise = -torch.log(-torch.log(uniforms.clamp(1e-20, 1.0 - 1e-7)))
    sampled = torch.argmax(noise + scaled, dim=-1)
    keys.copy_(new if active is None else torch.where(active[:, None], new, keys))
    return torch.where(state.dev("temperature") > 0.0, sampled.to(torch.int32),
                       greedy)


# ---------------------------------------------------------------------------
# speculative verification
# ---------------------------------------------------------------------------

def accepted_prefix(accept: torch.Tensor) -> torch.Tensor:
    """The length of each row's leading run of True, int64 [B]."""
    return (torch.cumsum((~accept).to(torch.int32), dim=-1) == 0).sum(dim=-1)


def spec_verify_sample(target_logits: torch.Tensor, draft_logits: torch.Tensor,
                       proposal: torch.Tensor, prop_len: torch.Tensor,
                       temperature: torch.Tensor, onehot_q: torch.Tensor,
                       keys: torch.Tensor, any_random: bool = True,
                       uniforms: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None,
                       grammar_rows: Optional[torch.Tensor] = None):
    """Leviathan-style speculative verification
    (``kaito_tpu.engine.sampler.spec_verify_sample``): accept a prefix of
    the proposal, then draw one token from the residual distribution; the
    emitted stream is distribution-identical to sampling the target
    autoregressively, and greedy rows (temperature 0) are exactly
    prefix-accept + argmax.

    target_logits [B, W, V] fp32 (W = K + 1 window positions);
    draft_logits [B, K, V] fp32 (the draft's distribution at each
    proposed position; ignored where ``onehot_q`` or temperature 0);
    proposal [B, K] int; prop_len [B] valid proposal tokens;
    temperature [B]; onehot_q [B] bool (deterministic proposers);
    keys [B, 2] the speculation-private keys: each row's key splits into
    (new, k_u, k_cat), ``uniform(k_u, (K,))`` decides acceptance and
    ``categorical(k_cat, log residual)`` the extra token.
    ``any_random`` False (every row greedy, a host gate) skips the
    residual's Gumbel draw, whose token a greedy row never takes.
    ``uniforms`` [B, K] and ``noise`` [B, V] (Gumbel) replace the keys'
    draws, for tests.  ``grammar_rows`` [B, W, V] fp32 of 0 / -inf
    grammar masks per window position: the verify distribution
    renormalizes under the mask (the softmax of masked logits is the
    constrained conditional), so constrained rows keep speculating.

    Returns (out [B, W] int32, n_emit [B] int32, lps [B, W] fp32,
    new_keys [B, 2]); out[:, :n_emit] are the emitted tokens, lps the
    log p of each under the unmodified target distribution."""
    B, W, V = target_logits.shape
    K = W - 1
    dev = target_logits.device
    masked = target_logits if grammar_rows is None \
        else target_logits + grammar_rows
    greedy_row = temperature <= 0.0
    temp = temperature.clamp_min(1e-6)[:, None, None]
    vocab = torch.arange(V, device=dev)
    p_soft = torch.softmax(masked / temp, dim=-1)
    p_hot = (vocab == torch.argmax(masked, dim=-1)[..., None]).to(p_soft.dtype)
    p = torch.where(greedy_row[:, None, None], p_hot, p_soft)      # [B, W, V]
    q_soft = torch.softmax(draft_logits / temp, dim=-1)
    prop = proposal.long()
    q_hot = (vocab == prop[..., None]).to(q_soft.dtype)
    det = (onehot_q | greedy_row)[:, None, None]
    q = torch.where(det, q_hot, q_soft)                             # [B, K, V]

    j = torch.arange(K, device=dev)[None, :]
    valid = j < prop_len.long()[:, None]                            # [B, K]
    p_prop = torch.gather(p[:, :K], 2, prop[..., None])[..., 0]
    q_prop = torch.gather(q, 2, prop[..., None])[..., 0]
    ratio = p_prop / q_prop.clamp_min(1e-20)

    new_keys, k_u, k_cat = split_keys(keys, 3)
    u = uniform(k_u, K) if uniforms is None else uniforms
    accept = (u < ratio) & valid
    # the longest accepted PREFIX (one rejection stops the row)
    n = accepted_prefix(accept)                                     # [B]

    # residual at the first rejected position: max(p - q, 0) normalized;
    # past the proposal the residual is the target itself (the bonus)
    idx = n[:, None, None].expand(B, 1, V)
    p_n = torch.gather(p, 1, idx)[:, 0]                             # [B, V]
    q_pad = torch.cat([q, q.new_zeros((B, 1, V))], dim=1)
    q_n = torch.gather(q_pad, 1, idx)[:, 0]
    q_n = torch.where((n < prop_len.long())[:, None], q_n, 0.0)
    resid = (p_n - q_n).clamp_min(0.0)
    rs = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(rs > 1e-12, resid / rs.clamp_min(1e-12), p_n)
    extra = torch.argmax(resid, dim=-1)
    if any_random:
        g = gumbel_noise(k_cat, V) if noise is None else noise
        drawn = torch.argmax(g + torch.log(resid.clamp_min(1e-38)), dim=-1)
        # greedy rows stay draw-free: a one-hot residual's argmax
        extra = torch.where(greedy_row, extra, drawn)

    jj = torch.arange(W, device=dev)[None, :]
    prop_pad = torch.cat([prop, prop.new_zeros((B, 1))], dim=1)
    out = torch.where(jj < n[:, None], prop_pad, 0)
    out = torch.where(jj == n[:, None], extra[:, None], out)
    logp = torch.log_softmax(target_logits, dim=-1)
    lps = torch.gather(logp, 2, out[..., None])[..., 0]
    return out.to(torch.int32), (n + 1).to(torch.int32), lps, new_keys
