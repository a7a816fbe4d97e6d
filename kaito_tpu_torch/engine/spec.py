"""Speculative decoding: the n-gram and draft-model proposers and the
captured verify window.

Counterpart of ``kaito_tpu.engine.spec`` and of the verify programs of
``kaito_tpu.engine.engine`` (``_verify_fn``, ``_verify_accept_fn``):

* :class:`NgramIndex` — a request's prompt-lookup index, append-updated
  as tokens are emitted (host code, copied).
* :class:`DepthController` — per-slot adaptive depth: an accept-rate
  EWMA drives AIMD on K, and sustained-poor acceptance falls the slot
  back to the n-gram proposer, then plain decode, with a probation
  window before the draft is retried (host code, copied).
* :class:`VerifyWindow` — the target's ``[B, W]`` verification forward
  over static buffers, captured as one CUDA graph per key on one card:
  the window's tokens, lengths, start positions, page tables and the
  proposal lengths come in one packed host copy; the greedy targets
  and their logprobs (n-gram) or the Leviathan accept rule
  (``sampler.spec_verify_sample``, draft) run inside the graph; one
  packed ``[B, 2W + 1]`` int32 copy comes back (tokens, emitted
  counts, logprobs).  Nothing inside reads a length back to the host:
  the page tables are cut to a power-of-two width bucket that the host
  picks from its own positions, and each width is a graph of its own.
* :class:`DraftRunner` — the co-resident draft model: its own page
  pool, per-slot tables and positions, a speculation-private key per
  slot, the eager catch-up prefill (``sync``) and the K-step proposal
  scan, captured as one graph per ``k_exec``.  The scan writes its
  proposals and the draft's logits into buffers the verify graph reads,
  so a draft round reads nothing back before the verify.

Under a grammar both stay graphs: each row carries its absolute row of
the engine's packed grammar table (``gstate``); the scan masks the
draft's logits with ``gmask[row]`` and advances ``row = gtrans[row,
token]`` as it proposes (the masked logits are the draft's q), and the
verify walks the same automaton along each row's proposal to give every
window position its mask.  A graph that reads the table is keyed by the
table's capacity, so an engine that grows the table drops it
(:meth:`StaticGraphs.drop`); unconstrained rounds capture the graphs
they always did.

The draft pool is private: a draft page is never taken from the
target's allocator, so speculation never preempts.  A round's proposal
scan writes draft KV at positions ``p .. p + k_exec - 1``; after a round
that accepted ``a`` of ``k_exec`` proposals the engine commits
``min(p + a + 1, p + k_exec)``: after a full-accept round the last
accepted token's KV was never written, and ``sync`` backfills that gap
at the start of the next round.

One difference from the JAX engine: a slot's speculation key is set at
admission from the request's seed (``fold_in(PRNGKey(seed + 7919),
slot)``, :meth:`DraftRunner.reseed`), where the JAX engine keeps one
stream per slot for the engine's life; so a seeded sampled request
reproduces under draft speculation as it does without it.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from kaito_tpu_torch.engine.decode_graph import StaticGraphs
from kaito_tpu_torch.engine.devprof import phase_scope
from kaito_tpu_torch.engine.kv_cache import create_kv_cache
from kaito_tpu_torch.engine.model import TransformerLM, greedy_targets
from kaito_tpu_torch.engine.sampler import (accepted_prefix, categorical, fold_in,
                                            prng_key, slot_key, spec_verify_sample,
                                            split_keys)
from kaito_tpu_torch.models.registry import (draft_compatibility_errors,
                                             get_model_by_name)

logger = logging.getLogger(__name__)

# the speculation keys' seed offset (the JAX DraftRunner's PRNGKey(seed + 7919))
SPEC_KEY_SALT = 7919


class NgramIndex:
    """Last-occurrence index over one request's token stream.

    A dict maps each ``k``-gram (that has at least one following token)
    to its NEWEST start offset.  ``append`` is O(1) amortized per
    emitted token; ``propose`` is one dict probe.  The gram ending at
    the current tail is indexed only once a token follows it — a lookup
    never matches the tail itself — and a match older than the trailing
    window is a miss.  Memory stays O(window): the retained token buffer
    is trimmed and stale dict entries are swept as the stream grows.
    """

    def __init__(self, k: int, tokens, window: int = 4096):
        self.k = k
        self.window = max(int(window), k + 1)
        toks = [int(t) for t in tokens]
        self.n = len(toks)                 # absolute stream length
        self.off = max(0, self.n - self.window)   # abs index of buf[0]
        self.tokens = toks[self.off:]      # trailing retained buffer
        self.last: dict[tuple, int] = {}   # gram -> newest ABS start
        for end in range(k - 1, len(self.tokens) - 1):
            self.last[tuple(self.tokens[end - k + 1:end + 1])] = \
                self.off + end - k + 1
        self._sweep_at = self.n + self.window

    def append(self, tok: int) -> None:
        self.tokens.append(int(tok))
        self.n += 1
        m = self.n - 2                # previous tail ABS index: it now
        if m - self.k + 1 >= self.off:  # has a follower, gram is usable
            rel = m - self.off
            self.last[tuple(self.tokens[rel - self.k + 1:rel + 1])] = \
                m - self.k + 1
        if len(self.tokens) > 2 * self.window:   # amortized front trim
            cut = len(self.tokens) - self.window
            del self.tokens[:cut]
            self.off += cut
        if self.n >= self._sweep_at:  # periodic stale-entry sweep
            lo = self.n - self.window
            self.last = {g: s for g, s in self.last.items() if s >= lo}
            self._sweep_at = self.n + self.window

    def propose(self, max_tokens: int) -> list[int]:
        if self.n < self.k + 1 or max_tokens <= 0:
            return []
        start = self.last.get(tuple(self.tokens[-self.k:]))
        if start is None or start < self.n - self.window:
            return []   # no occurrence inside the trailing window
        lo = start + self.k - self.off
        return self.tokens[lo:lo + max_tokens]


class DepthController:
    """Per-slot adaptive speculation depth (AIMD on an accept-rate EWMA).

    Modes per slot: ``"draft"`` (propose with the draft model at depth
    ``k``) and ``"ngram"`` (fall back to the prompt-lookup proposer; a
    probation countdown retries the draft at depth 1).  When the n-gram
    proposer also finds nothing the engine's speculative step returns 0
    and the slot decodes plainly: draft → n-gram → plain decode.
    """

    def __init__(self, slots: int, k_max: int, *, k_init: int = 2,
                 alpha: float = 0.25, raise_at: float = 0.8,
                 lower_at: float = 0.4, fallback_below: float = 0.2,
                 fallback_patience: int = 4, probation_rounds: int = 16):
        self.k_max = max(1, int(k_max))
        self.k_init = min(max(1, k_init), self.k_max)
        self.alpha = alpha
        self.raise_at = raise_at
        self.lower_at = lower_at
        self.fallback_below = fallback_below
        self.fallback_patience = fallback_patience
        self.probation_rounds = probation_rounds
        self._k = [self.k_init] * slots
        self._ewma: list = [None] * slots
        self._bad = [0] * slots
        self._mode = ["draft"] * slots
        self._probation = [0] * slots

    def depth(self, i: int) -> int:
        return self._k[i] if self._mode[i] == "draft" else 0

    def mode(self, i: int) -> str:
        return self._mode[i]

    def accept_ewma(self, i: int) -> float:
        return float(self._ewma[i]) if self._ewma[i] is not None else 0.0

    def observe(self, i: int, proposed: int, accepted: int) -> None:
        """Record one draft verification round for slot ``i``."""
        if proposed <= 0:
            return
        rate = accepted / proposed
        e = self._ewma[i]
        self._ewma[i] = rate if e is None else \
            self.alpha * rate + (1.0 - self.alpha) * e
        if rate >= self.raise_at:                       # additive increase
            self._k[i] = min(self._k[i] + 1, self.k_max)
        elif rate < self.lower_at:                      # multiplicative decrease
            self._k[i] = max(1, self._k[i] // 2)
        if self._ewma[i] < self.fallback_below:
            self._bad[i] += 1
            if self._bad[i] >= self.fallback_patience:
                self._mode[i] = "ngram"
                self._probation[i] = self.probation_rounds
                self._bad[i] = 0
                self._ewma[i] = None
                self._k[i] = 1
        else:
            self._bad[i] = 0

    def note_fallback_round(self, i: int) -> None:
        """Tick the probation countdown while slot ``i`` rides the
        n-gram fallback; at zero the draft model is retried at depth 1."""
        if self._mode[i] != "ngram":
            return
        self._probation[i] -= 1
        if self._probation[i] <= 0:
            self._mode[i] = "draft"
            self._k[i] = 1
            self._ewma[i] = None
            self._bad[i] = 0

    def reset(self, i: int) -> None:
        self._k[i] = self.k_init
        self._ewma[i] = None
        self._bad[i] = 0
        self._mode[i] = "draft"
        self._probation[i] = 0

    def mean_depth(self, idxs) -> float:
        ks = [self.depth(i) for i in idxs]
        return sum(ks) / len(ks) if ks else 0.0


def grammar_rows(gtrans: torch.Tensor, gstart: torch.Tensor, prop: torch.Tensor,
                 prop_len: torch.Tensor) -> torch.Tensor:
    """[B, K + 1] absolute grammar-table rows of a verify window: the
    rows' start ``gstart`` [B], then the automaton advanced along each
    row's proposal ``prop`` [B, K]; a position past ``prop_len`` keeps
    the last state.  Position j holds the state before the token
    verified at j."""
    st = gstart.long()
    rows = [st]
    for j in range(prop.shape[1]):
        st = torch.where(j < prop_len, gtrans[st, prop[:, j].long()].long(), st)
        rows.append(st)
    return torch.stack(rows, dim=1)


def width_bucket(pages: int, pages_per_seq: int) -> int:
    """Page-table columns a window's attention reads: the power of two
    at or above ``pages`` (the rows' history and window), at most the
    table's width."""
    return min(pages_per_seq, 1 << max(0, pages - 1).bit_length())


class _Packed:
    """Column layout of a packed ``[B, C]`` int32 input: name -> (start,
    width).  A float column holds its fp32 bits."""

    def __init__(self, widths: dict[str, int]):
        self.cols, off = {}, 0
        for name, w in widths.items():
            self.cols[name] = (off, w)
            off += w
        self.width = off

    def view(self, buf: torch.Tensor, name: str) -> torch.Tensor:
        a, w = self.cols[name]
        return buf[:, a:a + w] if w > 1 else buf[:, a]

    def host(self, B: int) -> np.ndarray:
        return np.zeros((B, self.width), np.int32)

    def put(self, host: np.ndarray, name: str, values) -> None:
        a, w = self.cols[name]
        v = np.asarray(values)
        if v.dtype == np.float32:
            v = v.view(np.int32)
        if w > 1:
            host[:, a:a + v.shape[1]] = v
        else:
            host[:, a] = v


class VerifyWindow(StaticGraphs):
    """The target's ``[B, W]`` verify window over static buffers.

    ``engine`` is the serving engine (its model, cache and counters);
    ``B`` its ``speculative_max_batch``, ``W`` the window.  With
    ``draft`` (a :class:`DraftRunner`) the draft path's accept rule runs
    in the window, reading the scan's proposals and logits; otherwise
    the greedy one.  ``capture`` (one card) captures one graph per
    (width bucket, whether any row samples) and replays it; else the
    same body runs eagerly.  ``counters`` gains
    ``spec_verify_graph_{captures,replays}_total`` and
    ``spec_verify_eager_total``."""

    def __init__(self, engine, B: int, W: int, capture: bool, pool=None,
                 draft: Optional["DraftRunner"] = None):
        self.engine, self.B, self.W, self.draft = engine, B, W, draft
        self.layout = _Packed(dict(tokens=W, true_lens=1, start_pos=1, prop_len=1,
                                   temperature=1, onehot=1, use_draft=1, slot=1,
                                   gstate=1, aids=1, page_tables=engine.pages_per_seq))
        dev = engine.device
        packed = torch.zeros((B, self.layout.width), dtype=torch.int32, device=dev)
        super().__init__({"packed": packed}, dev, capture, engine.counters,
                         "spec_verify_graph", pool)
        self.out = torch.zeros((B, 2 * W + 1), dtype=torch.int32, device=dev)
        self._host = torch.empty(self.out.shape, dtype=torch.int32,
                                 pin_memory=dev.type == "cuda")
        engine.counters.setdefault("spec_verify_eager_total", 0)

    def _in(self, name: str) -> torch.Tensor:
        return self.layout.view(self.inputs["packed"], name)

    def _body(self, width: int, any_random: bool, grammar: Optional[tuple],
              lora: bool = False) -> None:
        eng, W, K = self.engine, self.W, self.W - 1
        toks = self._in("tokens")
        tl, sp = self._in("true_lens"), self._in("start_pos")
        prop_len = self._in("prop_len")
        pt = self._in("page_tables")[:, :width]
        aids = self._in("aids") if lora else None
        if self.draft is None:
            eng.cache, logits = eng.model.verify_window_logits(eng.cache, toks, tl,
                                                               pt, sp, aids)
            grows = None
            if grammar is not None:
                _, gmask, gtrans = grammar
                grows = gmask[grammar_rows(gtrans, self._in("gstate"), toks[:, 1:],
                                           prop_len)]
            # the targets are the argmax of the (masked) logits, their
            # logprobs the model's
            targets, lps = greedy_targets(logits, grows)
            j = torch.arange(K, device=toks.device)[None, :]
            hit = (toks[:, 1:] == targets[:, :K]) & (j < prop_len[:, None])
            # the accepted proposals ARE the targets: emit targets[:a + 1]
            n_emit = accepted_prefix(hit) + 1
            out = targets
        else:
            d = self.draft
            use = (self._in("use_draft") != 0)[:, None]
            j = torch.arange(K, device=toks.device)[None, :]
            prop = torch.where(use & (j < prop_len[:, None]), d.props, toks[:, 1:])
            toks = torch.cat([toks[:, :1], prop], dim=1)
            eng.cache, logits = eng.model.verify_window_logits(eng.cache, toks, tl,
                                                               pt, sp, aids)
            slot = self._in("slot").long()
            grows = None
            if grammar is not None:
                _, gmask, gtrans = grammar
                grows = gmask[grammar_rows(gtrans, self._in("gstate"), prop, prop_len)]
            out, n_emit, lps, new_keys = spec_verify_sample(
                logits, d.dlogits, prop, prop_len,
                self._in("temperature").view(torch.float32),
                self._in("onehot") != 0, d.keys[slot], any_random=any_random,
                grammar_rows=grows)
            d.keys.index_copy_(0, slot, new_keys)
        self.out[:, :W] = out
        self.out[:, W] = n_emit
        self.out[:, W + 1:] = lps.view(torch.int32)

    def _neutral(self):
        """Rows skipped (no window tokens, the null page only, the keys'
        spare row, the unconstrained grammar row) for the warm-up."""
        buf = self.inputs["packed"]
        saved = buf.clone()
        self._in("true_lens").zero_()
        self._in("page_tables").zero_()
        self._in("gstate").zero_()
        self._in("aids").zero_()
        self._in("slot").fill_(self.draft.spare if self.draft is not None else 0)
        return lambda: buf.copy_(saved)

    @phase_scope("verify")
    def run(self, host: np.ndarray, width: int, any_random: bool,
            grammar: Optional[tuple] = None, lora: bool = False) -> tuple:
        """One verify round from the packed host inputs (``layout``):
        upload, run, read back.  ``grammar`` is None or the engine's
        (capacity, gmask, gtrans) when a row is constrained; ``lora``
        whether a row verifies through an adapter lane (its ``aids``
        column); the graph is keyed by (width, any_random, lora,
        capacity).  Returns (tokens [B][W], emitted counts [B], logprobs
        [B][W]) as lists."""
        self.upload({"packed": host})
        if self.capture:
            key = (width, any_random, lora,
                   grammar[0] if grammar is not None else None)
            self.replay(key, lambda: (lambda: self._body(width, any_random, grammar,
                                                         lora),
                                      self._neutral, None))
        else:
            self._body(width, any_random, grammar, lora)
            self.counters["spec_verify_eager_total"] += 1
        if self._cuda:
            self._host.copy_(self.out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        else:
            self._host.copy_(self.out)
        h = self._host.numpy()
        W = self.W
        return (h[:, :W].tolist(), h[:, W].tolist(),
                h[:, W + 1:].copy().view(np.float32).tolist())


class DraftRunner:
    """The co-resident draft model and its private paged KV state.

    Owns the draft's weights (synthetic from ``cfg.seed``, or
    ``cfg.speculative_draft_weights_dir``), a page pool sized so every
    slot can hold a full context (``max_num_seqs * pages_per_seq + 1``
    pages, floating point: the draft model's dtype when the target's KV
    is int8), per-slot
    page tables and positions, a speculation-private key per slot (a
    ``[S + 1, 2]`` device buffer, the last row a spare that padded rows
    write), the eager catch-up prefill and the captured proposal scan.
    The scan's proposals (``props``, ``[B, W - 1]``) and logits
    (``dlogits``, ``[B, W - 1, V]`` fp32) stay on the device for the
    verify window.
    """

    def __init__(self, engine):
        cfg = engine.cfg
        self.cfg = cfg
        self.md = get_model_by_name(cfg.speculative_draft)
        errs = draft_compatibility_errors(engine.md, self.md)
        if errs:
            raise ValueError("speculative draft pairing rejected: " + "; ".join(errs))
        self.engine = engine
        self.device = engine.device
        dtype = engine.model.dtype
        self.model = TransformerLM(self.md.arch, dtype=dtype, device=self.device)
        t0 = time.monotonic()
        if cfg.speculative_draft_weights_dir:
            from kaito_tpu_torch.engine.weights import load_safetensors_params

            logger.info("loading draft checkpoint from %s",
                        cfg.speculative_draft_weights_dir)
            self.model.load_params(load_safetensors_params(
                self.model, cfg.speculative_draft_weights_dir))
        else:
            self.model.init_params(cfg.seed)
        self.page_size = cfg.page_size
        self.pages_per_seq = engine.pages_per_seq
        self.buckets = engine.buckets
        S = cfg.max_num_seqs
        num_pages = S * self.pages_per_seq + 1
        kv_dtype = dtype if cfg.kv_dtype == "int8" else \
            {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.kv_dtype]
        self.cache = create_kv_cache(self.md.arch, num_pages, cfg.page_size,
                                     kv_dtype, self.device)
        from kaito_tpu_torch.engine.engine import PageAllocator

        self.alloc = PageAllocator(num_pages)
        self.tables = np.zeros((S, self.pages_per_seq), np.int32)
        self.pages: list[list[int]] = [[] for _ in range(S)]
        self.pos = np.zeros((S,), np.int64)     # draft KV valid prefix
        root = prng_key(cfg.seed + SPEC_KEY_SALT)
        self.spare = S
        self.keys = torch.tensor([list(fold_in(root, i)) for i in range(S)] + [[0, 0]],
                                 dtype=torch.int64, device=self.device)
        self.scan: Optional[StaticGraphs] = None
        logger.info("speculative draft: %s (%d layers, vocab %d), %d KV pages x %d "
                    "tokens (%.2f GiB), k_max=%d, ready in %.1fs", self.md.name,
                    self.md.arch.num_layers, self.md.arch.vocab_size, num_pages,
                    cfg.page_size, 2 * self.cache.k.nbytes / 2**30,
                    cfg.speculative_draft_k, time.monotonic() - t0)

    def attach(self, B: int, W: int, capture: bool, pool=None) -> None:
        """The proposal scan's static buffers (``B`` rows, up to ``W - 1``
        steps) and its graphs."""
        dev = self.device
        self.layout = _Packed(dict(last=1, positions=1, active=1, temperature=1,
                                   slot=1, gstate=1, page_tables=self.pages_per_seq))
        self.props = torch.zeros((B, W - 1), dtype=torch.int32, device=dev)
        self.dlogits = torch.zeros((B, W - 1, self.md.arch.vocab_size),
                                   dtype=torch.float32, device=dev)
        packed = torch.zeros((B, self.layout.width), dtype=torch.int32, device=dev)
        self.scan = StaticGraphs({"packed": packed}, dev, capture,
                                 self.engine.counters, "spec_draft_graph", pool)

    # -- per-slot paged state ------------------------------------------

    def release_slot(self, i: int) -> None:
        if self.pages[i]:
            self.alloc.release(self.pages[i])
            self.pages[i] = []
            self.tables[i, :] = 0
        self.pos[i] = 0

    def reseed(self, i: int, seed: int) -> None:
        """Admission: slot ``i``'s speculation key from the request's
        seed, ``fold_in(PRNGKey(seed + 7919), i)``."""
        self.keys[i] = torch.tensor(slot_key(seed + SPEC_KEY_SALT, i),
                                    dtype=torch.int64)

    def ensure_pages(self, i: int, tokens_total: int) -> bool:
        """Grow slot ``i``'s draft page list to cover ``tokens_total``
        tokens; False when the slot would exceed its per-seq cap (the
        pool itself cannot run dry)."""
        need = -(-tokens_total // self.page_size)
        if need > self.pages_per_seq:
            return False
        have = len(self.pages[i])
        if need <= have:
            return True
        try:
            new = self.alloc.alloc(need - have)
        except MemoryError:
            return False
        for j, p in enumerate(new):
            self.tables[i, have + j] = p
        self.pages[i].extend(new)
        return True

    # -- catch-up prefill ----------------------------------------------

    @phase_scope("draft")
    def sync(self, i: int, position: int, tokens_fn) -> bool:
        """Bring slot ``i``'s draft KV up to the target position (KV
        written for ``tokens[0:position]``), one chunk of at most the
        largest bucket a call; True when caught up.  The first chunk
        after admission is a fresh prefill (K2), later ones attend over
        the draft's paged history.  ``tokens_fn`` materializes the
        slot's token list."""
        cur = int(self.pos[i])
        if cur == position:
            return True
        if cur > position:   # defensive: the target rewound under us
            self.release_slot(i)
            cur = 0
        if not self.ensure_pages(i, position):
            return False
        gap = [int(t) for t in tokens_fn()[cur:position]]
        if not gap:
            self.pos[i] = position
            return True
        bucket = next((b for b in self.buckets if b >= len(gap)), self.buckets[-1])
        gap = gap[:bucket]
        arr = np.zeros((1, bucket), np.int32)
        arr[0, :len(gap)] = gap
        t = self.engine._tensor
        self.cache, _, _ = self.model.prefill(
            self.cache, t(arr), t(np.asarray([len(gap)], np.int32)),
            t(self.tables[i:i + 1]),
            start_pos=None if cur == 0 else t(np.asarray([cur], np.int32)))
        self.pos[i] = cur + len(gap)
        return int(self.pos[i]) == position

    # -- K-step proposal scan ------------------------------------------

    def _scan_in(self, name: str) -> torch.Tensor:
        return self.layout.view(self.scan.inputs["packed"], name)

    def _scan_body(self, k: int, any_random: bool, grammar: Optional[tuple]) -> None:
        tok, pos = self._scan_in("last"), self._scan_in("positions")
        active = self._scan_in("active") != 0
        # the decode kernel takes contiguous page tables
        pt = self._scan_in("page_tables").contiguous()
        temp = self._scan_in("temperature").view(torch.float32)
        slot = self._scan_in("slot").long()
        keys = self.keys[slot]
        rnd = temp > 0.0
        if grammar is not None:
            _, gmask, gtrans = grammar
            gr = self._scan_in("gstate").long()
        for s in range(k):
            self.cache, logits = self.model.decode(self.cache, tok, pos, pt, active)
            logits = logits.float()
            if grammar is not None:
                # a constrained row proposes under its mask, and the
                # masked logits are the q its tokens were drawn from
                logits = logits + gmask[gr]
            nxt = torch.argmax(logits, dim=-1)
            if any_random:
                keys, sub = split_keys(keys, 2)
                drawn = categorical(sub, logits / temp.clamp_min(1e-6)[:, None])
                nxt = torch.where(rnd, drawn, nxt)
            nxt = nxt.to(torch.int32)
            self.props[:, s] = nxt
            self.dlogits[:, s] = logits
            if grammar is not None:
                gr = gtrans[gr, nxt.long()].long()
            tok, pos = nxt, pos + 1
        if any_random:
            # only the drafting rows' keys advance
            self.keys.index_copy_(0, torch.where(active, slot, self.spare), keys)

    def _scan_neutral(self):
        active = self._scan_in("active")
        saved = active.clone()
        active.zero_()
        return lambda: active.copy_(saved)

    @phase_scope("draft")
    def propose(self, slot_map, last, positions, temps, active, k: int,
                gstate=None, grammar: Optional[tuple] = None) -> None:
        """The k-step draft scan over the compact verify batch (``slot_map``
        engine slot per row, -1 padding; ``active`` the rows that draft
        this round, the others ride along on the null page); the
        proposals and logits land in ``props`` / ``dlogits``.  With
        ``grammar`` (the engine's (capacity, gmask, gtrans)) each row
        drafts under its grammar from its table row in ``gstate``."""
        L = self.layout
        host = L.host(len(slot_map))
        idx = np.where(slot_map >= 0, slot_map, self.spare)
        L.put(host, "last", last)
        L.put(host, "positions", positions)
        L.put(host, "active", np.asarray(active, np.int32))
        L.put(host, "temperature", np.asarray(temps, np.float32))
        L.put(host, "slot", idx)
        if gstate is not None:
            L.put(host, "gstate", gstate)
        L.put(host, "page_tables", self.tables[np.minimum(idx, len(self.tables) - 1)]
              * (slot_map >= 0)[:, None])
        self.scan.upload({"packed": host})
        any_random = bool(np.any(np.asarray(temps) > 0.0))
        if self.scan.capture:
            key = (k, any_random, grammar[0] if grammar is not None else None)
            self.scan.replay(key, lambda: (lambda: self._scan_body(k, any_random, grammar),
                                           self._scan_neutral, None))
        else:
            self._scan_body(k, any_random, grammar)

    def commit(self, i: int, new_position: int) -> None:
        """After a verify round: advance the draft KV valid prefix (the
        engine passes min(new target position, p + k_exec), never past
        what the scan wrote; ``sync`` prefills any gap next round)."""
        self.pos[i] = new_position
