"""Config-driven transformer LM, dense GQA families.

Counterpart of ``kaito_tpu.engine.model``.  Parameters keep the JAX
package's stacked layout — one ``[num_layers, ...]`` tensor per layer
weight, ``[in, out]`` projections — held in an ``nn.Module``; the JAX
layer scan becomes a Python loop over layers that reads each layer as a
view of the stack and writes the KV page pools in place.

Attention goes through the kernel wrappers of ``engine.ops``: the
Hopper kernels for tensors on the card, their plain versions for
tensors on the CPU.  Prompt chunks that follow earlier chunks use
``attention.paged_context_attention``, which has no kernel.

Under weight quantization (``engine.quant``) each layer stack's
projections are QTensor dicts ``{"q8"|"q4": int8, "scale": fp32}`` that
``nn.linear`` routes to the fused dequant matmul; with an int8 KV cache
the page writes take their quantizing ``_q`` forms and attention reads
the pages with their scales.

MoE and MLA families, and yarn/longrope rope scaling, are not ported yet
and raise.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch
from torch import nn as tnn

from kaito_tpu_torch.device import resolve_device
from kaito_tpu_torch.engine import attention as attn
from kaito_tpu_torch.engine import nn
from kaito_tpu_torch.engine.kv_cache import (
    KVCache, write_decode_tokens, write_decode_tokens_q,
    write_packed_prefill_tokens, write_packed_prefill_tokens_q,
    write_prefill_tokens, write_prefill_tokens_q)
from kaito_tpu_torch.engine.ops.decode_attention import \
    paged_decode_attention_cuda
from kaito_tpu_torch.engine.ops.flash_prefill import (
    flash_prefill_attention_cuda, flash_prefill_packed_cuda)
from kaito_tpu_torch.engine.quant import (is_qtensor, is_quantized_leaf,
                                          quantize_weight)
from kaito_tpu_torch.models.metadata import AttentionKind, ModelArch

VOCAB_ALIGN = 128
_BIG_WINDOW = 1 << 30


def _name_salt(name: str) -> int:
    """Stable per-parameter seed salt (Python's hash() is salted per
    process)."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


@dataclass(frozen=True)
class LayerGroup:
    name: str          # "dense"
    start: int
    count: int
    moe: bool


def _layer_groups(arch: ModelArch) -> tuple[LayerGroup, ...]:
    if arch.num_experts > 0:
        raise NotImplementedError(
            "MoE models are not ported yet (ROADMAP queue 1, M17)")
    return (LayerGroup("dense", 0, arch.num_layers, False),)


def _to_torch(a) -> torch.Tensor:
    """numpy array (bfloat16 included, via its bits) -> CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(np_tree: dict, arch: ModelArch) -> dict:
    """The JAX param pytree, passed as numpy arrays (``jax.tree.map(
    np.asarray, params)``), as this port's parameter tree: the same
    names and the same stacked groups of ``_layer_groups``, as CPU
    tensors.  A tree from ``quantize_params`` keeps its QTensor dicts:
    int8 codes stay int8 and scales fp32.  Feed it to
    :meth:`TransformerLM.load_params`."""
    out: dict = {}
    for key, val in np_tree.items():
        if isinstance(val, dict):
            if key == "serve_lora":
                raise NotImplementedError(
                    "adapters are not ported yet (ROADMAP queue 1, M16)")
            out[key] = {n: ({k: _to_torch(x) for k, x in a.items()}
                            if isinstance(a, dict) else _to_torch(a))
                        for n, a in val.items()}
        else:
            out[key] = _to_torch(val)
    names = {g.name for g in _layer_groups(arch)}
    missing = names - set(out)
    if missing:
        raise KeyError(f"param tree lacks layer groups {sorted(missing)}")
    return out


def _check_qtensor(name: str, w: dict, full: tuple) -> None:
    """A QTensor for a ``full`` = [L, in, out] weight: int8 codes
    [L, in, out] ("q8") or [L, in/2, out] ("q4"), fp32 scales [L, out]
    or [L, G, out] over whole groups."""
    L, K, N = full
    if "q8" in w:
        codes, want, sshape = w["q8"], full, (L, N)
    else:
        codes, want = w["q4"], (L, K // 2, N)
        G = w["scale"].shape[-2] if w["scale"].dim() == 3 else 0
        sshape = (L, G, N) if G and K % G == 0 and (K // G) % 2 == 0 else None
    if codes.dtype != torch.int8 or tuple(codes.shape) != want \
            or w["scale"].dtype != torch.float32 or sshape is None \
            or tuple(w["scale"].shape) != sshape:
        raise ValueError(
            f"param {name!r}: QTensor codes {codes.dtype} {tuple(codes.shape)}, "
            f"scale {w['scale'].dtype} {tuple(w['scale'].shape)} do not fit "
            f"the weight {full}")


class TransformerLM(tnn.Module):
    """Dense GQA transformer; parameters live in the module, KV pools in
    an explicit :class:`KVCache` written in place."""

    def __init__(self, arch: ModelArch, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda"):
        super().__init__()
        if arch.attention_kind == AttentionKind.MLA:
            raise NotImplementedError(
                "MLA attention is not ported yet (ROADMAP queue 1, M17)")
        self.arch = arch
        self.dtype = dtype
        self.device = resolve_device(device)
        self.groups = _layer_groups(arch)
        self.vocab_padded = -(-arch.vocab_size // VOCAB_ALIGN) * VOCAB_ALIGN
        self._inv_freq_global = nn.rope_frequencies(arch, self.device)
        self._rope_mscale = nn.rope_attention_factor(arch)
        self._inv_freq_local = self._inv_freq_global
        if arch.sliding_window_pattern and arch.sliding_window:
            # gemma-3 sliding layers use unscaled theta=10k rope
            local = replace(arch, rope_theta=10000.0, rope_scaling=None)
            self._inv_freq_local = nn.rope_frequencies(local, self.device)
        self.top = tnn.ParameterDict()
        # per layer group: plain leaves, and one ParameterDict per QTensor
        self.stacks = tnn.ModuleDict()
        self.qstacks = tnn.ModuleDict()

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def _layer_specs(self) -> dict[str, tuple[int, ...]]:
        a = self.arch
        E, H, Hkv, D, I = (a.hidden_size, a.num_heads, a.num_kv_heads,
                           a.head_dim, a.intermediate_size)
        specs = {
            "attn_norm": (E,),
            "q": (E, H * D),
            "k": (E, Hkv * D),
            "v": (E, Hkv * D),
            "o": (H * D, E),
        }
        if a.qkv_bias or a.linear_bias:
            specs.update({"q_bias": (H * D,), "k_bias": (Hkv * D,),
                          "v_bias": (Hkv * D,)})
        if a.linear_bias:
            specs["o_bias"] = (E,)
        if a.qk_norm:
            specs["q_norm"] = (D,)
            specs["k_norm"] = (D,)
        if a.norm_type == "layernorm":
            specs["attn_norm_bias"] = (E,)
        if not a.parallel_residual:
            specs["mlp_norm"] = (E,)
            if a.norm_type == "layernorm":
                specs["mlp_norm_bias"] = (E,)
        if a.pre_post_norm:
            specs["post_attn_norm"] = (E,)
            specs["post_mlp_norm"] = (E,)
        if a.gated_mlp:
            specs["gate"] = (E, I)
        specs["up"] = (E, I)
        specs["down"] = (I, E)
        if a.linear_bias:
            specs["up_bias"] = (I,)
            specs["down_bias"] = (E,)
        return specs

    def _top_specs(self) -> dict[str, tuple[int, ...]]:
        a = self.arch
        E = a.hidden_size
        specs = {"embed": (self.vocab_padded, E), "final_norm": (E,)}
        if a.norm_type == "layernorm":
            specs["final_norm_bias"] = (E,)
        if not a.tie_word_embeddings:
            specs["lm_head"] = (self.vocab_padded, E)
        return specs

    def init_params(self, seed: int = 0, quantization: str = "") -> None:
        """Synthetic weights with the JAX package's shapes and scales:
        0.02 normal for the top level, 1/sqrt(fan_in) normal per layer,
        ones for norms (zeros with a norm offset), zeros for biases.
        Each tensor draws from its own seeded ``torch.Generator`` on the
        target device, so values do not depend on draw order.  Under
        ``quantization`` each stacked projection is quantized right after
        it is drawn, so the device holds the quantized tree plus at most
        one full-precision leaf."""
        gen = torch.Generator(device=self.device)

        def normal(shape, std, salt):
            gen.manual_seed((seed * 1_000_003 + salt) & 0x7FFF_FFFF_FFFF_FFFF)
            t = torch.empty(shape, dtype=self.dtype, device=self.device)
            return t.normal_(0.0, std, generator=gen)

        def norm_fill(shape):
            fill = 0.0 if self.arch.norm_offset else 1.0
            return torch.full(shape, fill, dtype=self.dtype, device=self.device)

        tree: dict = {}
        for name, shape in self._top_specs().items():
            if "norm" in name:
                tree[name] = (torch.zeros(shape, dtype=self.dtype, device=self.device)
                              if "bias" in name else norm_fill(shape))
            else:
                tree[name] = normal(shape, 0.02, _name_salt(name))
        for gi, g in enumerate(self.groups):
            layer: dict = {}
            for name, shape in self._layer_specs().items():
                full = (g.count,) + shape
                if "norm" in name and "bias" not in name:
                    layer[name] = norm_fill(full)
                elif "bias" in name:
                    layer[name] = torch.zeros(full, dtype=self.dtype,
                                              device=self.device)
                else:
                    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                    layer[name] = normal(full, 1.0 / math.sqrt(fan_in),
                                         _name_salt(name) + 7919 * (gi + 1))
                    if quantization and is_quantized_leaf(g.name, name):
                        layer[name] = quantize_weight(layer[name], quantization)
            tree[g.name] = layer
        self.load_params(tree)

    def load_params(self, tree: dict, quantization: str = "") -> None:
        """Install a parameter tree (names and stacked shapes of
        :meth:`init_params`), moved to the model's device and dtype.
        QTensor leaves keep their own dtypes (int8 codes, fp32 scales);
        under ``quantization`` a plain projection is cast to the model
        dtype, then quantized, one tensor at a time."""
        def param(t, dtype=self.dtype):
            return tnn.Parameter(t.to(device=self.device, dtype=dtype),
                                 requires_grad=False)

        for name, shape in self._top_specs().items():
            if tuple(tree[name].shape) != shape:
                raise ValueError(f"param {name!r}: shape {tuple(tree[name].shape)} "
                                 f"!= {shape}")
            self.top[name] = param(tree[name])
        for g in self.groups:
            stack, qstack = tnn.ParameterDict(), tnn.ModuleDict()
            for name, shape in self._layer_specs().items():
                full = (g.count,) + shape
                t = tree[g.name][name]
                if quantization and is_quantized_leaf(g.name, name) \
                        and not is_qtensor(t):
                    if tuple(t.shape) != full:
                        raise ValueError(f"param {g.name}.{name!r}: shape "
                                         f"{tuple(t.shape)} != {full}")
                    t = quantize_weight(t.to(device=self.device, dtype=self.dtype),
                                        quantization)
                if is_qtensor(t):
                    _check_qtensor(f"{g.name}.{name}", t, full)
                    qstack[name] = tnn.ParameterDict(
                        {k: param(x, x.dtype) for k, x in t.items()})
                    continue
                if tuple(t.shape) != full:
                    raise ValueError(f"param {g.name}.{name!r}: shape "
                                     f"{tuple(t.shape)} != {full}")
                stack[name] = param(t)
            self.stacks[g.name] = stack
            self.qstacks[g.name] = qstack

    def param_tree(self) -> dict:
        """The parameters as a nested dict of tensors (QTensor dicts for
        quantized projections)."""
        tree = {k: v for k, v in self.top.items()}
        for g in self.groups:
            tree[g.name] = {k: v for k, v in self.stacks[g.name].items()}
            tree[g.name].update({k: dict(v.items())
                                 for k, v in self.qstacks[g.name].items()})
        return tree

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    # ------------------------------------------------------------------
    # Flags / rope tables
    # ------------------------------------------------------------------

    def _window(self, layer: int) -> Optional[int]:
        """Sliding window of ``layer`` (None for a model without one,
        _BIG_WINDOW for a global layer of a mixed model)."""
        a = self.arch
        if not a.sliding_window:
            return None
        if a.sliding_window_pattern and (layer + 1) % a.sliding_window_pattern == 0:
            return _BIG_WINDOW
        return int(a.sliding_window)

    @property
    def _scale(self) -> float:
        a = self.arch
        denom = a.query_pre_attn_scalar if a.query_pre_attn_scalar else a.head_dim
        return 1.0 / math.sqrt(denom)

    # ------------------------------------------------------------------
    # Layer body
    # ------------------------------------------------------------------

    def _norm(self, x, p, name):
        a = self.arch
        if a.norm_type == "layernorm":
            return nn.layer_norm(x, p[name], p.get(f"{name}_bias"), a.rms_norm_eps)
        return nn.rms_norm(x, p[name], a.rms_norm_eps, a.norm_offset)

    def _attn_qkv(self, x, p, positions, window):
        """q/k/v heads with norms and rope applied.  x: [B, T, E];
        positions: [B, T] absolute positions."""
        a = self.arch
        B, T, _ = x.shape
        q = nn.linear(x, p["q"])
        k = nn.linear(x, p["k"])
        v = nn.linear(x, p["v"])
        if "q_bias" in p:
            q, k, v = q + p["q_bias"], k + p["k_bias"], v + p["v_bias"]
        q = q.reshape(B, T, a.num_heads, a.head_dim)
        k = k.reshape(B, T, a.num_kv_heads, a.head_dim)
        v = v.reshape(B, T, a.num_kv_heads, a.head_dim)
        if a.qk_norm:
            q = nn.rms_norm(q, p["q_norm"], a.rms_norm_eps, a.norm_offset)
            k = nn.rms_norm(k, p["k_norm"], a.rms_norm_eps, a.norm_offset)
        if window is None or window >= _BIG_WINDOW:
            inv_freq, mscale = self._inv_freq_global, self._rope_mscale
        else:
            inv_freq, mscale = self._inv_freq_local, 1.0
        q = nn.apply_rope(q, positions, inv_freq, a.head_dim, mscale=mscale)
        k = nn.apply_rope(k, positions, inv_freq, a.head_dim, mscale=mscale)
        return q, k, v

    def _layer(self, x, p, cache: KVCache, li: int, mode: str, *,
               positions, page_tables, lengths, true_lens, active,
               start_pos=None, packed=None):
        """One transformer block over layer ``li`` of the pools."""
        a = self.arch
        B, T, _ = x.shape
        window = self._window(li)
        win = window if window is not None else _BIG_WINDOW
        h = self._norm(x, p, "attn_norm")
        q, k_new, v_new = self._attn_qkv(h, p, positions, window)
        ck, cv = cache.k, cache.v
        ks, vs = cache.k_scale, cache.v_scale      # None unless int8 pools
        ps = ck.shape[2]
        softcap = a.attn_logit_softcap

        if mode == "prefill_packed":
            seg_ids, tok_pages, pack_pages, tok_pgslot = packed
            offsets = positions[0] % ps
            if ks is not None:
                write_packed_prefill_tokens_q(ck, ks, k_new, pack_pages, tok_pgslot,
                                              offsets, layer=li)
                write_packed_prefill_tokens_q(cv, vs, v_new, pack_pages, tok_pgslot,
                                              offsets, layer=li)
            else:
                write_packed_prefill_tokens(ck, k_new, tok_pages, offsets, layer=li)
                write_packed_prefill_tokens(cv, v_new, tok_pages, offsets, layer=li)
            out = flash_prefill_packed_cuda(
                q, k_new, v_new, seg_ids, positions, win,
                scale=self._scale, softcap=softcap)
        elif mode == "prefill":
            start = (start_pos if start_pos is not None
                     else torch.zeros((B,), dtype=torch.int32, device=x.device))
            if ks is not None:
                write_prefill_tokens_q(ck, ks, k_new, page_tables, start, true_lens,
                                       ps, layer=li)
                write_prefill_tokens_q(cv, vs, v_new, page_tables, start, true_lens,
                                       ps, layer=li)
            else:
                write_prefill_tokens(ck, k_new, page_tables, start, true_lens, ps,
                                     layer=li)
                write_prefill_tokens(cv, v_new, page_tables, start, true_lens, ps,
                                     layer=li)
            if start_pos is not None:
                # chunk attends over earlier chunks + itself
                out = attn.paged_context_attention(
                    q, ck, cv, page_tables, start, true_lens, scale=self._scale,
                    sliding_window=window, logit_softcap=softcap, layer=li,
                    k_scale=ks, v_scale=vs)
            else:
                out = flash_prefill_attention_cuda(
                    q, k_new, v_new, true_lens, win, scale=self._scale,
                    softcap=softcap)
        else:
            pos0 = positions[:, 0]
            if ks is not None:
                write_decode_tokens_q(ck, ks, k_new[:, 0], page_tables, pos0, ps,
                                      active, layer=li)
                write_decode_tokens_q(cv, vs, v_new[:, 0], page_tables, pos0, ps,
                                      active, layer=li)
            else:
                write_decode_tokens(ck, k_new[:, 0], page_tables, pos0, ps, active,
                                    layer=li)
                write_decode_tokens(cv, v_new[:, 0], page_tables, pos0, ps, active,
                                    layer=li)
            out = paged_decode_attention_cuda(
                q[:, 0], ck, cv, page_tables, lengths, win,
                scale=self._scale, softcap=softcap, layer=li,
                k_scale=ks, v_scale=vs)[:, None]
        o_in = out.reshape(B, T, a.num_heads * a.head_dim)
        attn_out = nn.linear(o_in, p["o"])
        if "o_bias" in p:
            attn_out = attn_out + p["o_bias"]
        if a.parallel_residual:
            return x + attn_out + nn.mlp(h, p, a)
        if a.pre_post_norm:
            attn_out = self._norm(attn_out, p, "post_attn_norm")
        x = x + attn_out
        mlp_out = nn.mlp(self._norm(x, p, "mlp_norm"), p, a)
        if a.pre_post_norm:
            mlp_out = self._norm(mlp_out, p, "post_mlp_norm")
        return x + mlp_out

    def _run_layers(self, cache: KVCache, x, mode, **kw):
        for g in self.groups:
            stack, qstack = self.stacks[g.name], self.qstacks[g.name]
            for i in range(g.count):
                p = {name: t[i] for name, t in stack.items()}
                # a QTensor's layer: {"q8"|"q4": codes[i], "scale": scale[i]}
                p.update({name: {k: t[i] for k, t in qt.items()}
                          for name, qt in qstack.items()})
                x = self._layer(x, p, cache, g.start + i, mode, **kw)
        return x

    # ------------------------------------------------------------------
    # Forward passes
    # ------------------------------------------------------------------

    def _embed(self, tokens):
        x = self.top["embed"][tokens.long()].to(self.dtype)
        if self.arch.embedding_multiplier:
            x = x * torch.tensor(self.arch.embedding_multiplier,
                                 dtype=self.dtype, device=x.device)
        return x

    def _logits(self, x):
        """fp32 logits [..., vocab_size]: bf16 inputs, fp32 accumulation
        and output, as the JAX package's dot_general with
        preferred_element_type=float32."""
        a = self.arch
        head = self.top["embed"] if a.tie_word_embeddings else self.top["lm_head"]
        x2 = x.reshape(-1, x.shape[-1])
        if x2.dtype == torch.float32:
            logits = x2 @ head.t()
        elif x2.is_cuda:
            logits = torch.mm(x2, head.t(), out_dtype=torch.float32)
        else:
            logits = x2.float() @ head.float().t()
        logits = nn.softcap(logits, a.final_logit_softcap)
        return logits.reshape(*x.shape[:-1], -1)[..., : a.vocab_size]

    def prefill(self, cache: KVCache, tokens, true_lens, page_tables,
                start_pos=None):
        """Prompts (or prompt suffixes when ``start_pos`` marks earlier
        chunks already in the pages).  tokens: [B, T] padded chunks;
        true_lens: [B] int32 valid new tokens; page_tables: [B, pmax]
        int32.  Returns (cache, last_logits [B, V] fp32, last_hidden
        [B, E]); the cache is written in place."""
        B, T = tokens.shape
        rel = torch.arange(T, dtype=torch.int32, device=tokens.device)
        rel = rel[None, :].expand(B, T)
        positions = rel if start_pos is None else rel + start_pos[:, None]
        x = self._embed(tokens)
        x = self._run_layers(cache, x, "prefill", positions=positions,
                             page_tables=page_tables, lengths=true_lens,
                             true_lens=true_lens, active=None,
                             start_pos=start_pos)
        x = self._norm(x, self.top, "final_norm")
        idx = (true_lens.long() - 1).clamp_min(0)
        last = x[torch.arange(B, device=x.device), idx]
        return cache, self._logits(last), last

    def prefill_packed(self, cache: KVCache, tokens, seg_ids, positions,
                       tok_pages, last_idx, pack_pages=None, tok_pgslot=None):
        """Segment-packed prefill: S fresh prompts in ONE padded row.
        tokens/seg_ids/positions: [1, T] int32 (segment -1 = pad,
        positions within the segment); tok_pages: [T] page per token;
        last_idx: [S] packed index of each segment's final token.  An
        int8 cache also needs pack_pages ([n_pg] the segments' pages)
        and tok_pgslot ([T] each token's index into them, n_pg for
        pads).  Returns (cache, last_logits [S, V] fp32, last_hidden
        [S, E])."""
        if cache.quantized and (pack_pages is None or tok_pgslot is None):
            raise ValueError("an int8 KV cache needs pack_pages and tok_pgslot")
        x = self._embed(tokens)
        x = self._run_layers(cache, x, "prefill_packed", positions=positions,
                             page_tables=None, lengths=None, true_lens=None,
                             active=None,
                             packed=(seg_ids, tok_pages, pack_pages, tok_pgslot))
        x = self._norm(x, self.top, "final_norm")
        last = x[0, last_idx.long()]
        return cache, self._logits(last), last

    def decode(self, cache: KVCache, tokens, positions, page_tables,
               active=None):
        """One decode step.  tokens: [B] last sampled token; positions:
        [B] int32 their positions (lengths after the write are
        positions + 1).  Rows that ``active`` marks off write to the
        null page and attend over nothing (length 0; their logits are
        meaningless), so their positions need not fit ``page_tables``.
        Returns (cache, logits [B, V] fp32)."""
        pos2 = positions[:, None].to(torch.int32)
        lengths = (positions + 1).to(torch.int32)
        if active is not None:
            lengths = torch.where(active, lengths, 0).to(torch.int32)
        x = self._embed(tokens[:, None])
        x = self._run_layers(cache, x, "decode", positions=pos2,
                             page_tables=page_tables, lengths=lengths,
                             true_lens=None, active=active)
        x = self._norm(x, self.top, "final_norm")
        return cache, self._logits(x[:, 0])
