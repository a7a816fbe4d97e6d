#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``kaito_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, in
order; any failure exits non-zero and prints no result:

1. Card and build: the card's name and power limit (``nvidia-smi``),
   then every kernel under ``kaito_tpu_torch/csrc/`` built from the
   checkout with ``nvcc``.
2. Kernels against their plain versions on the card, at Llama-3.1-8B
   shapes, in bf16 and fp32: paged decode (K1), flash prefill over a
   fresh chunk (K2) and over a segment-packed row (K3) at T = 512, 256
   and 200 (ragged), with windows of 128 and 32 tokens, a softcap, and
   packed layouts of four segments and of many 1-3-token ones (K2 and
   K3 are timed at T = 512 and at T = 256, the bucket of phase 4's
   200-token prompt), paged decode
   over int8 pages with scales (K1q, over the K1 pools quantized), and
   the fused dequant matmuls of int8 (K4) and int4 (K5) weights at the
   four projection shapes with 1, 5, 8, 9, 16, 17, 64, 65, 200 and 256
   rows (bf16 calls of 17-256 rows take the wide path, whose launch
   counter must follow), timed at 1, 8, 16 and 200 rows at every shape
   and also at 64 and 256 rows at gate/up; and K6, the int8 and
   int4 kernels with the next layer's slab prefetched into L2, at the
   TP=2 ring-chunk shapes (o and down chunks, strided views), whose
   output must be bitwise K4/K5's.  The decode-row path (bf16, 1-16
   rows) logs its plan at each shape and ptxas's register and spill
   lines (a spill fails the run), its merge counters must read zero
   after the checks, and one K5 and one K6 call captured in a CUDA
   graph must match the plain version (and the eager kernel, bitwise)
   when replayed after new x is copied into its input and after an
   eager call with more partials.  K1 runs with the
   page-table width the full-width engine gives it at its context limit,
   and is also timed at the live width the engine passes and with one
   live sequence beside idle (length-0) rows; K1q is timed at both
   widths too.  The K1/K1q plan (splits, CTAs, scratch) and ptxas's
   register and spill lines for ``decode_attention.cu`` are logged (a
   spill fails the run), the merge counters must read zero after the
   checks, and one K1 and one K1q call captured in a CUDA graph must
   match the plain version when replayed after new lengths and page
   tables are copied into its inputs (and after an eager call at a
   larger batch).  Tolerances: fp32 atol
   1e-4 (the kernels sum in another order than the plain versions);
   bf16 atol 2e-2 (P is rounded to bf16 before the PV product, relative
   to a different running max in each); for K4 and K5 relative to the
   output's largest magnitude (K6 the same as K4/K5); K1 and K1q (K1q
   only so) also relative to each sequence's largest magnitude, since a
   long sequence comes out far smaller than a short one.  The reading
   of a kernel that loses one split of the longest sequence (the plain
   version without that split's pages) is logged beside them and must
   fail that check.  Each kernel,
   its plain version and
   one PyTorch call as a yardstick (``scaled_dot_product_attention``;
   ``torch.matmul`` against the dequantized bf16 weight for K4/K5) are
   timed with CUDA events on the card's clock (behind a sleep kernel, so
   host issue does not enter), and the host time each kernel call takes
   is recorded beside it.  K4/K5 and their yardstick cycle through copies
   of the weight that together exceed the 50 MB L2, as a decode step
   finds each weight cold; K6 is also timed by what its prefetch buys:
   the next layer's K4/K5 call right after K6, against the same call
   right after a K4/K5 call without the prefetch.
3. Goldens: ``tiny-llama-real`` in fp32 through the port's engine on the
   card must reproduce the ``fp32``, ``int8``, ``weight_int4`` and
   ``kv_int8`` sections of ``tests/testdata/goldens_tiny-llama-real.json``
   (greedy tokens exact, logprobs within atol 2e-3); then at
   tensor_parallel 2 (all four) and 4 (all but ``weight_int4``, which
   that degree refuses), each with the comm-overlap ring off and on, on
   a mesh of the first cards or, on a one-card machine, of slots that
   all map onto that card.
4. Full width: the port's HTTP server serves ``llama-3.1-8b-instruct``
   (all 32 layers, bf16, synthetic weights from seed 0): one completion,
   one streamed chat, then four concurrent 100-400-token prompts (a
   prefill pack) and one 700-token prompt (a continuation chunk).  Every
   response must be well formed and carry its ``max_tokens``; the launch
   counts of K1, K2 and K3, zeroed just before this phase, must each
   have grown.  TTFT, decode tokens/s and the inter-token gaps of one
   sequence alone are printed beside the card.
5. Quantized, full width: the server, configured by its own command line
   (``--quantization int4 --kv-cache-dtype int8``), serves the same model
   and request mix; then a shorter ``--quantization int8`` leg (bf16 KV).
   The launch counts of K5 and K1q (int4 leg) and of K4 (int8 leg), and
   of K5's and K4's launches on the wide (prefill-row) path, are zeroed
   before each leg and must grow.
6. Tensor parallel, full width: the same model at TP=2 with the
   comm-overlap ring, its engine built on an explicit mesh (two cards, or
   two slots of one card, which the log names) and handed to
   ``make_server``: int4 weights + int8 KV with the request mix of phase
   5 (K6 int4, K5, K1q, K2 and K3 must launch), then int8 weights with
   bf16 KV without the burst (K6 int8 and K1).  On one card a ring hop
   moves nothing, so these legs time no transfer.

The last three lines of standard output are the card line, one JSON
object with the kernel records, and ``{"ok": true, "device": ...}``.
``--phase2-only`` stops after phase 2 and prints the kernel records
(without launch counts) and no result line; ``--first-leg-only`` skips
phase 3 and every server leg after phase 4's bf16 one (with
``--profile``, the quickest reading of TTFT and prefill device time)
and prints no result line either; nor does ``--leg NAME`` (one of
``bf16``, ``int4-kv8``, ``int8``, ``tp2-int4-kv8``, ``tp2-int8``), which
builds the kernels and runs that server leg alone, phases 2 and 3
skipped: with ``--profile``, the quickest reading of a leg's TTFT and of
its quantized matmuls' device time per 200-token prefill, in one call
for a parent tree and this one.  ``--sweep-run-ahead`` adds
a decode sweep over ``decode_run_ahead`` at
full width, with the rule that picks the engine's CUDA auto value
(:func:`pick_run_ahead`; PERF.md).  On a machine with two cards or more,
each phase 6 leg runs on the first two cards and again with both shards
on the first card, so one run compares a real ring hop with none.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import traceback
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
FP32_ATOL, BF16_ATOL = 1e-4, 2e-2
BIG = 1 << 30
SLEEP_CYCLES = 100_000_000   # ~50 ms of GPU clock: longer than any queue of calls


# every kernel of the port: (record name, wrapper module, wrapper, the
# wrapper's launch counter for that kernel)
_OPS = "kaito_tpu_torch.engine.ops."
KERNELS = (
    ("paged_decode_attention", _OPS + "decode_attention",
     "paged_decode_attention_cuda", "launches"),
    ("flash_prefill_attention", _OPS + "flash_prefill",
     "flash_prefill_attention_cuda", "launches"),
    ("flash_prefill_packed", _OPS + "flash_prefill",
     "flash_prefill_packed_cuda", "launches"),
    ("paged_decode_attention_int8kv", _OPS + "decode_attention",
     "paged_decode_attention_cuda", "launches_q"),
    ("quant_matmul_int8", _OPS + "quant_matmul", "quant_matmul_cuda",
     "launches_int8"),
    ("quant_matmul_int4", _OPS + "quant_matmul", "quant_matmul_cuda",
     "launches_int4"),
    ("quant_matmul_int8_pf", _OPS + "quant_matmul", "quant_matmul_cuda",
     "launches_int8_pf"),
    ("quant_matmul_int4_pf", _OPS + "quant_matmul", "quant_matmul_cuda",
     "launches_int4_pf"),
)


# K4/K5's launches on the wide (prefill-row) path: (counter name, the
# kernel record it belongs to, the wrapper's counter)
WIDE_COUNTERS = (
    ("quant_matmul_int8_wide", "quant_matmul_int8", "launches_int8_wide"),
    ("quant_matmul_int4_wide", "quant_matmul_int4", "launches_int4_wide"),
)


class SmokeFailure(RuntimeError):
    pass


def _counter(name):
    """(wrapper, counter attribute) of the kernel record or wide-path
    counter ``name``."""
    for wide, record, attr in WIDE_COUNTERS:
        if name == wide:
            return _counter(record)[0], attr
    _, mod, fn, attr = next(k for k in KERNELS if k[0] == name)
    return getattr(importlib.import_module(mod), fn), attr


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(card ms, host ms) per call of ``fn``.  A sleep kernel holds the
    stream while the host queues all ``iters`` calls, so the CUDA events
    time the card's work back to back, not the rate at which Python
    issues it; the host time is how long each call held the issuing
    thread."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host * 1e3 / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# Decode lengths of phase 2: eight live sequences up to 2048 tokens
K1_LENGTHS = [2048, 1, 37, 511, 1000, 1536, 64, 1999]
K1_SINGLE = [230] + [0] * 7      # one live sequence, seven idle rows (length 0)


def _path_pages_per_seq() -> int:
    """Page-table width of the full-width config when a sequence reaches
    its context limit (the widest table the engine passes to K1)."""
    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.models.registry import get_model_by_name

    md = get_model_by_name("llama-3.1-8b-instruct")
    return EngineConfig(model=md.name,
                        max_model_len=min(md.max_model_len, 8192)).pages_per_seq


def _decode_case(torch, dtype, lengths, window, softcap, gen, pmax):
    B, H, Hkv, D, ps, L = len(lengths), 32, 8, 128, 64, 2
    P = B * pmax + 57
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    ck = torch.randn(L, P, ps, Hkv, D, generator=gen, device="cuda").to(dtype)
    cv = torch.randn(L, P, ps, Hkv, D, generator=gen, device="cuda").to(dtype)
    # pages scattered through the pool; page 0 stays the null page
    perm = torch.randperm(P - 1, generator=gen, device="cuda")[: B * pmax] + 1
    pt = perm.reshape(B, pmax).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    args = (q, ck, cv, pt, lens, window)
    kw = dict(scale=1.0 / math.sqrt(D), softcap=softcap, layer=1)
    return args, kw


def _quantize_pool(torch, pool):
    """A [L, P, ps, Hkv, D] pool as int8 codes and fp32 scales per
    (layer, page, head), as the int8 page writes leave them."""
    x = pool.float()
    scale = x.abs().amax(dim=(2, 4)) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.round(x / safe[:, :, None, :, None]).clamp(-127, 127)
    return codes.to(torch.int8), scale.contiguous()


def _time_decode(torch, args, kw, label):
    """K1 (or K1q, when ``kw`` holds scales), its plain version and SDPA
    on one bf16 case; SDPA attends over the live pages gathered (and
    dequantized) into a contiguous [B, Hkv, S, D] copy in q's dtype (the
    gather itself is not timed)."""
    from kaito_tpu_torch.engine.ops.decode_attention import (
        paged_decode_attention_cuda, paged_decode_attention_plain)

    q, ck, cv, pt, lens, _ = args
    B, H, D = q.shape
    Hkv, ps = ck.shape[3], ck.shape[2]
    quant = kw.get("k_scale") is not None
    ms, host_ms = time_ms(lambda: paged_decode_attention_cuda(*args, **kw))
    plain_ms = time_ms(lambda: paged_decode_attention_plain(*args, **kw), iters=5)[0]
    n_pg = -(-int(lens.max()) // ps)
    S = n_pg * ps
    live_pt = pt[:, :n_pg].long()

    def gathered(pool, scale):
        x = pool[1][live_pt]
        if scale is not None:
            x = x.float() * scale[1][live_pt][:, :, None, :, None]
        return x.to(q.dtype).reshape(B, S, Hkv, D).transpose(1, 2).contiguous()

    kg, vg = gathered(ck, kw.get("k_scale")), gathered(cv, kw.get("v_scale"))
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None].long())
    mask = mask[:, None, None, :]
    qs = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask,
                                      scale=kw["scale"], enable_gqa=True))[0]
    live = int(lens.sum())
    el = q.element_size()
    nbytes = 2 * B * H * D * el + 2 * live * Hkv * D * ck.element_size() \
        + pt.numel() * 4 + B * 4
    if quant:
        # the fp32 k and v scales of every live page and KV head
        nbytes += 2 * sum(-(-int(n) // ps) for n in lens.tolist()) * Hkv * 4
    b_ms, b_by = bound(nbytes, 4.0 * live * H * D)
    log(f"{'K1q' if quant else 'K1'} {label}: {ms:.4f} ms (plain {plain_ms:.4f}, "
        f"SDPA {library_ms:.4f}, bound {b_ms:.5f} by {b_by}; host {host_ms:.4f} ms "
        f"per call)")
    return dict(case=label, table_width=pt.shape[1], ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by, host_ms=host_ms)


def _build_lines(build_logs, source, kernel=""):
    """ptxas's entry, register and spill lines for csrc/``source`` (empty
    when the library was already built), only those of the kernels whose
    mangled name holds ``kernel``; and the spill lines among them, each
    with its kernel's name (a spill is a defect)."""
    lines, spills, name = [], [], ""
    for ln in build_logs.get(source, "").splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?([\w$]+)", ln)
        if m:
            name = m.group(1)
        if kernel not in name or not any(w in ln for w in ("entry function", "registers",
                                                           "spill")):
            continue
        lines.append(ln.strip())
        if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln)):
            spills.append(f"{name}: {ln.strip()}")
    return lines, spills


def _seq_rel_err(out, ref) -> float:
    """The worst error of a sequence of a [B, H, D] output relative to
    that sequence's largest magnitude."""
    diff = (out.float() - ref.float()).abs().flatten(1).amax(dim=1)
    return (diff / ref.float().abs().flatten(1).amax(dim=1).clamp_min(1e-30)).max().item()


def _decode_errs(out, ref) -> tuple[float, float]:
    """(absolute, per-sequence relative) error of a K1/K1q output."""
    return (out.float() - ref.float()).abs().max().item(), _seq_rel_err(out, ref)


def _dropped_split_reading(torch, args, kw, sms):
    """What the checks read for a kernel that loses the second split of
    the longest sequence (global window): the plain version with that
    split's pages left out of the sequence, against the plain version.
    Returns (absolute, relative to the batch's largest magnitude,
    per-sequence relative)."""
    from kaito_tpu_torch.engine.ops.decode_attention import (
        decode_plan, decode_split, paged_decode_attention_plain)

    q, ck, cv, pt, lens, win = args
    B, H, D = q.shape
    ps, Hkv = ck.shape[2], ck.shape[3]
    b = int(lens.argmax())
    n = int(lens[b])
    _, t0, t1, n_live = decode_split(n, win, ps, decode_plan(B, H, Hkv, D, sms).n_split, 1)
    if n_live < 3:
        raise SmokeFailure(f"the longest sequence has {n_live} splits, not a middle one")
    pt2, lens2 = pt.clone(), lens.clone()
    keep = torch.cat([pt[b, :t0 // ps], pt[b, t1 // ps:]])
    pt2[b, :keep.numel()] = keep
    lens2[b] = n - (t1 - t0)
    ref = paged_decode_attention_plain(*args, **kw).float()
    bad = paged_decode_attention_plain(q, ck, cv, pt2, lens2, win, **kw).float()
    e = (bad - ref).abs().max().item()
    return e, e / ref.abs().max().item(), _seq_rel_err(bad, ref)


def _check_decode_graph(torch, full, gen):
    """One K1 and one K1q call (bf16, the main case) captured in a CUDA
    graph and replayed after new lengths and page-table contents are
    copied into the static inputs; each replay against the plain version.
    Before the replays, an eager call at a batch whose plan needs more
    scratch and counters: the workspace must not move under the graph.
    Returns the worst error of each (K1 the larger of absolute and
    per-sequence relative, K1q per-sequence relative)."""
    from kaito_tpu_torch.engine.ops.decode_attention import (
        paged_decode_attention_cuda, paged_decode_attention_plain, workspace)

    worst = {}
    for quant in (False, True):
        args, kw = _decode_case(torch, torch.bfloat16, K1_LENGTHS, BIG, None, gen, full)
        q, ck, cv, pt, lens, win = args
        if quant:
            (ck, ks), (cv, vs) = _quantize_pool(torch, ck), _quantize_pool(torch, cv)
            kw = dict(kw, k_scale=ks, v_scale=vs)
        run = lambda: paged_decode_attention_cuda(q, ck, cv, pt, lens, win, **kw)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run()
        ws = workspace(q.device)
        ptrs = (ws.part.data_ptr(), ws.counters.data_ptr())
        big, bkw = _decode_case(torch, torch.bfloat16, [300 + 37 * i for i in range(16)],
                                BIG, None, gen, 20)
        if quant:
            (k8, ks), (v8, vs) = _quantize_pool(torch, big[1]), _quantize_pool(torch, big[2])
            big, bkw = (big[0], k8, v8) + big[3:], dict(bkw, k_scale=ks, v_scale=vs)
        eb, rb = _decode_errs(paged_decode_attention_cuda(*big, **bkw),
                              paged_decode_attention_plain(*big, **bkw))
        err = rb if quant else max(eb, rb)
        if (ws.part.data_ptr(), ws.counters.data_ptr()) != ptrs:
            raise SmokeFailure("the decode workspace moved under a captured graph")
        del big
        for lengths in (list(reversed(K1_LENGTHS)), K1_SINGLE, [4000, 0, 1, 2, 3, 64, 65,
                                                                 8000]):
            lens.copy_(torch.tensor(lengths, dtype=torch.int32))
            P = ck.shape[1]
            pt.copy_((torch.randperm(P - 1, generator=gen, device="cuda")[:pt.numel()]
                      + 1).reshape(pt.shape).to(torch.int32))
            graph.replay()
            ref = paged_decode_attention_plain(q, ck, cv, pt, lens, win, **kw).float()
            torch.cuda.synchronize()
            e, r = _decode_errs(out, ref)
            err = max(err, r if quant else max(e, r))
        worst["K1q" if quant else "K1"] = err
        del graph
    log(f"K1/K1q CUDA graph replays (new lengths and tables): max err {worst}")
    if worst["K1"] > BF16_ATOL or worst["K1q"] > BF16_ATOL:
        raise SmokeFailure(f"K1/K1q replayed from a CUDA graph disagree: {worst}")
    return worst


def check_decode(torch, records, build_logs):
    from kaito_tpu_torch.engine.ops.decode_attention import (
        decode_plan, paged_decode_attention_cuda, paged_decode_attention_plain,
        workspace)

    lines, spills = _build_lines(build_logs, "decode_attention.cu")
    for ln in lines:
        log(f"  decode_attention.cu: {ln}")
    if spills:
        raise SmokeFailure(f"decode_attention.cu spills: {spills}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B in (len(K1_LENGTHS), 1):
        plan = decode_plan(B, 32, 8, 128, sms)
        log(f"K1/K1q plan, B={B} H=32 Hkv=8 D=128 on {sms} SMs: n_split "
            f"{plan.n_split}, {plan.ctas} CTAs, {plan.scratch_floats} scratch floats "
            f"(any table width)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    full = _path_pages_per_seq()
    err = {torch.bfloat16: 0.0, torch.float32: 0.0}
    err_r, err_q = dict(err), dict(err)
    cases = [(K1_LENGTHS, w, c) for w, c in ((BIG, None), (300, None), (BIG, 30.0))]
    cases.append((K1_SINGLE, BIG, None))
    for dtype in (torch.bfloat16, torch.float32):
        for lengths, window, softcap in cases:
            args, kw = _decode_case(torch, dtype, lengths, window, softcap, gen,
                                    full)
            out = paged_decode_attention_cuda(*args, **kw)
            ref = paged_decode_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            e, r = _decode_errs(out, ref)
            err[dtype] = max(err[dtype], e)
            err_r[dtype] = max(err_r[dtype], r)
            # K1q over the same pools quantized to int8
            (q, ck, cv, pt, lens, win) = args
            (k8, ks), (v8, vs) = _quantize_pool(torch, ck), _quantize_pool(torch, cv)
            qargs, qkw = (q, k8, v8, pt, lens, win), dict(kw, k_scale=ks, v_scale=vs)
            out = paged_decode_attention_cuda(*qargs, **qkw)
            ref = paged_decode_attention_plain(*qargs, **qkw).float()
            torch.cuda.synchronize()
            eq = _seq_rel_err(out, ref)
            err_q[dtype] = max(err_q[dtype], eq)
            log(f"K1/K1q {dtype} lengths={lengths} window={window} softcap={softcap} "
                f"page table width {full}: K1 max err {e:.3g}, per sequence "
                f"relative {r:.3g} / K1q per sequence relative {eq:.3g}")
    for name, bad in (("K1", err), ("K1 per sequence", err_r)):
        if bad[torch.bfloat16] > BF16_ATOL or bad[torch.float32] > FP32_ATOL:
            raise SmokeFailure(f"{name} disagrees with its plain version: {bad}")
    if err_q[torch.bfloat16] > BF16_ATOL or err_q[torch.float32] > FP32_ATOL:
        raise SmokeFailure(f"K1q disagrees with its plain version: {err_q}")
    if workspace(torch.device("cuda", 0)).counters.any():
        raise SmokeFailure("K1/K1q left a merge counter above zero")
    # a kernel that loses one split must fail the per-sequence check
    args, kw = _decode_case(torch, torch.bfloat16, K1_LENGTHS, BIG, None, gen, full)
    q, ck, cv, pt, lens, win = args
    (k8, ks), (v8, vs) = _quantize_pool(torch, ck), _quantize_pool(torch, cv)
    dropped = {"K1": _dropped_split_reading(torch, args, kw, sms),
               "K1q": _dropped_split_reading(torch, (q, k8, v8, pt, lens, win),
                                             dict(kw, k_scale=ks, v_scale=vs), sms)}
    del args, ck, cv, k8, v8
    for name, (e, rel, seq) in dropped.items():
        log(f"{name} with the second split of the longest sequence lost: max err "
            f"{e:.3g}, relative to the batch {rel:.3g}, per sequence {seq:.3g}")
        if seq <= BF16_ATOL:
            raise SmokeFailure(f"{name}'s check does not see a lost split: {seq}")
    graph_err = _check_decode_graph(torch, full, gen)
    # timed at the widest page table the engine passes, and at the live
    # width it passes when no sequence is longer than these
    timed = []
    for lengths, pmax, label in (
            (K1_LENGTHS, full, f"8 live sequences <= 2048 tokens, table width {full}"),
            (K1_LENGTHS, 2048 // 64, "8 live sequences <= 2048 tokens, table width 32"),
            (K1_SINGLE, full, f"1 live sequence of 230 tokens, table width {full}"),
            (K1_SINGLE, 4, "1 live sequence of 230 tokens, table width 4")):
        args, kw = _decode_case(torch, torch.bfloat16, lengths, BIG, None, gen, pmax)
        timed.append(_time_decode(torch, args, kw, label))
    main = timed[0]
    plan = decode_plan(len(K1_LENGTHS), 32, 8, 128, sms)
    records["paged_decode_attention"] = dict(
        name="paged_decode_attention", route="cuda",
        source="kaito_tpu_torch/csrc/decode_attention.cu",
        replaces="kaito_tpu/engine/ops/decode_attention.py:199",
        shape=f"B=8 H=32 Hkv=8 D=128 ps=64 lengths<=2048 table width {full} bf16",
        max_abs_err=err[torch.bfloat16], max_err_bf16=err[torch.bfloat16],
        max_err_fp32=err[torch.float32], max_seq_rel_err_bf16=err_r[torch.bfloat16],
        max_seq_rel_err_fp32=err_r[torch.float32], lost_split_err=dropped["K1"],
        graph_replay_err=graph_err["K1"],
        ms=main["ms"], kernel_ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"],
        host_ms=main["host_ms"], n_split=plan.n_split, ctas=plan.ctas, cases=timed)
    # K1q at the main case, at both table widths: the same pools quantized
    # to int8
    timed_q = []
    for pmax, label in ((full, timed[0]["case"]), (2048 // 64, timed[1]["case"])):
        args, kw = _decode_case(torch, torch.bfloat16, K1_LENGTHS, BIG, None, gen, pmax)
        (q, ck, cv, pt, lens, win) = args
        (k8, ks), (v8, vs) = _quantize_pool(torch, ck), _quantize_pool(torch, cv)
        del ck, cv
        timed_q.append(_time_decode(torch, (q, k8, v8, pt, lens, win),
                                    dict(kw, k_scale=ks, v_scale=vs), label))
    tq = timed_q[0]
    records["paged_decode_attention_int8kv"] = dict(
        name="paged_decode_attention_int8kv", route="cuda",
        source="kaito_tpu_torch/csrc/decode_attention.cu",
        replaces="kaito_tpu/engine/ops/decode_attention.py:76",
        shape=f"B=8 H=32 Hkv=8 D=128 ps=64 lengths<=2048 table width {full} "
              f"bf16 q, int8 pages + fp32 scales",
        max_abs_err=err_q[torch.bfloat16], max_rel_err_bf16=err_q[torch.bfloat16],
        max_rel_err_fp32=err_q[torch.float32], lost_split_err=dropped["K1q"],
        graph_replay_err=graph_err["K1q"],
        ms=tq["ms"], kernel_ms=tq["ms"],
        plain_ms=tq["plain_ms"], bound_ms=tq["bound_ms"], bound_by=tq["bound_by"],
        library_ms=tq["library_ms"], host_ms=tq["host_ms"], n_split=plan.n_split,
        ctas=plan.ctas, cases=timed_q)


# projection shapes of Llama-3.1-8B, [K, N]
PROJ_SHAPES = {"q/o": (4096, 4096), "k/v": (4096, 1024),
               "gate/up": (4096, 14336), "down": (14336, 4096)}
L2_BYTES = 50 << 20


def _cold_cycle(tensors_of, nbytes):
    """Copies of a weight (``tensors_of()`` makes one) that together
    exceed twice the L2, and a function handing out the next one."""
    copies = [tensors_of() for _ in range(max(2, -(-2 * L2_BYTES // nbytes)))]
    it = iter(range(1 << 62))
    return lambda: copies[next(it) % len(copies)]


# K4/K5 rows checked at every projection shape (1-16: the decode-row path
# in bf16, 17-256 the wide path) and timed: every shape at 1, 8, 16 and
# 200 rows, gate/up also at these
QM_CHECK_ROWS = (1, 5, 8, 9, 16, 17, 64, 65, 200, 256)
QM_TIME_ROWS = (1, 8, 16, 200)
QM_TIME_ROWS_GATE_UP = (1, 8, 16, 64, 200, 256)


def check_quant_matmul(torch, records, build_logs):
    """K4 and K5 against their plain version at the projection shapes,
    rows 1-256 (``QM_CHECK_ROWS``), bf16 and fp32, with the wide-path
    counter growing on every bf16 call of 17-256 rows; then timed in bf16
    at 1, 8, 16 and 200 rows (gate/up also at 64 and 256) beside
    torch.matmul against the dequantized bf16 weight.  The decode-row
    path's ptxas lines are logged (a spill fails the run), its plan at
    each shape too, and its merge counters must read zero after the
    checks."""
    from kaito_tpu_torch.engine.ops import quant_matmul as qm
    from kaito_tpu_torch.engine.ops.quant_matmul import (quant_matmul_cuda,
                                                         quant_matmul_plain)
    from kaito_tpu_torch.engine.quant import dequant_weight, quantize_weight

    lines, spills = _build_lines(build_logs, "quant_matmul.cu", "decode_kernel")
    for ln in lines:
        log(f"  quant_matmul.cu decode rows: {ln}")
    if spills:
        raise SmokeFailure(f"quant_matmul.cu's decode-row kernels spill: {spills}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (K, N) in dict(PROJ_SHAPES, **{f"TP=2 {k} chunk": (K, N // 2)
                                               for k, (K, N) in PF_SHAPES.items()}).items():
        for scheme in ("int8", "int4"):
            p = qm.decode_plan(8, K, N, K // 128 if scheme == "int4" else 1,
                               scheme == "int4", sms)
            log(f"decode-row plan {scheme} {label} [{K}x{N}] at 8 rows: "
                f"{N // qm.DECODE_TN * p.n_split} CTAs, {p.n_split} K slices of "
                f"{p.kc} in-rows")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for scheme, name, replaces in (
            ("int8", "quant_matmul_int8", "kaito_tpu/engine/ops/quant_matmul.py:109"),
            ("int4", "quant_matmul_int4", "kaito_tpu/engine/ops/quant_matmul.py:129")):
        err = {torch.bfloat16: 0.0, torch.float32: 0.0}
        err_wide = 0.0
        timed = []
        wide = f"launches_{scheme}_wide"
        for label, (K, N) in PROJ_SHAPES.items():
            w = quantize_weight(torch.randn(K, N, generator=gen, device="cuda")
                                / math.sqrt(K), scheme)
            for rows in QM_CHECK_ROWS:
                for dtype in (torch.bfloat16, torch.float32):
                    x = torch.randn(rows, K, generator=gen, device="cuda").to(dtype)
                    before = getattr(quant_matmul_cuda, wide)
                    out = quant_matmul_cuda(x, w)
                    ref = quant_matmul_plain(x, w).float()
                    torch.cuda.synchronize()
                    e = (out.float() - ref).abs().max().item() / max(
                        ref.abs().max().item(), 1e-30)
                    err[dtype] = max(err[dtype], e)
                    on_wide = dtype == torch.bfloat16 and 16 < rows <= 256
                    if getattr(quant_matmul_cuda, wide) - before != int(on_wide):
                        raise SmokeFailure(f"{name} {label} rows {rows} {dtype}: the "
                                           f"wide path's counter did not follow")
                    if on_wide:
                        err_wide = max(err_wide, e)
            log(f"{name} {label} [{K}x{N}] rows {QM_CHECK_ROWS}: max relative err "
                f"bf16 {err[torch.bfloat16]:.3g} (wide path {err_wide:.3g}) fp32 "
                f"{err[torch.float32]:.3g}")
            for rows in (QM_TIME_ROWS_GATE_UP if label == "gate/up" else QM_TIME_ROWS):
                timed.append(_time_quant_matmul(torch, w, rows, K, N, scheme,
                                                f"{label} [{K}x{N}] rows {rows}",
                                                gen, dequant_weight))
            del w
        if err[torch.bfloat16] > BF16_ATOL or err[torch.float32] > FP32_ATOL:
            raise SmokeFailure(f"{name} disagrees with its plain version: {err}")
        if qm.decode_workspace(torch.device("cuda", 0)).counters.any():
            raise SmokeFailure(f"{name}: a decode-row merge counter is not back at zero")
        main = next(t for t in timed if t["case"].startswith("gate/up") and
                    t["case"].endswith("rows 8"))
        prefill = next(t for t in timed if t["case"].startswith("gate/up") and
                       t["case"].endswith("rows 200"))
        records[name] = dict(
            name=name, route="cuda", source="kaito_tpu_torch/csrc/quant_matmul.cu",
            replaces=replaces,
            shape=f"x [8, 4096] bf16 @ {scheme} W [4096, 14336] (gate/up)",
            max_abs_err=err[torch.bfloat16], max_rel_err_bf16=err[torch.bfloat16],
            max_rel_err_wide=err_wide, max_rel_err_fp32=err[torch.float32],
            prefill_ms=prefill["ms"], prefill_library_ms=prefill["library_ms"],
            prefill_bound_ms=prefill["bound_ms"], ms=main["ms"], kernel_ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=main["library_ms"],
            host_ms=main["host_ms"], cases=timed)


def _time_quant_matmul(torch, w, rows, K, N, scheme, label, gen, dequant_weight):
    from kaito_tpu_torch.engine.ops.quant_matmul import (quant_matmul_cuda,
                                                         quant_matmul_plain)

    x = torch.randn(rows, K, generator=gen, device="cuda").to(torch.bfloat16)
    wbytes = sum(t.numel() * t.element_size() for t in w.values())
    nxt = _cold_cycle(lambda: {k: t.clone() for k, t in w.items()}, wbytes)
    ms, host_ms = time_ms(lambda: quant_matmul_cuda(x, nxt()))
    plain_ms = time_ms(lambda: quant_matmul_plain(x, nxt()), iters=5)[0]
    del nxt
    deq = dequant_weight(w, torch.bfloat16)
    nxt_lib = _cold_cycle(lambda: deq.clone(), deq.numel() * 2)
    library_ms = time_ms(lambda: torch.matmul(x, nxt_lib()))[0]
    del nxt_lib, deq
    nbytes = 2 * rows * K + wbytes + 2 * rows * N
    b_ms, b_by = bound(nbytes, 2.0 * rows * K * N)
    log(f"{scheme} {label}: {ms:.4f} ms (plain {plain_ms:.4f}, torch.matmul bf16 "
        f"{library_ms:.4f}, bound {b_ms:.5f} by {b_by}; host {host_ms:.4f} ms per "
        f"call)")
    return dict(case=label, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by, host_ms=host_ms)


# one TP=2 shard's row-parallel planes of Llama-3.1-8B, [K / 2, N]; the
# ring multiplies column chunks of N / 2
PF_SHAPES = {"o": (2048, 4096), "down": (7168, 4096)}


def _time_second(torch, first, second, iters: int = 20, warmup: int = 3) -> float:
    """Card ms of ``second()`` when it runs right after ``first()``: CUDA
    events around each ``second`` call only, behind a sleep kernel."""
    for _ in range(warmup):
        first()
        second()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for a, b in pairs:
        first()
        a.record()
        second()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def check_quant_matmul_pf(torch, records):
    """K6 at the TP=2 ring-chunk shapes of Llama-3.1-8B (o and down
    chunks [K, 2048 of 4096 columns], strided views of the shard's plane),
    rows 1, 8 and 200, bf16 and fp32: its output must be bitwise K4/K5's
    on the same views and within their tolerances of the plain version.
    Then timed at 8 rows in bf16: K6 itself; the K4/K5 call on the next
    slab right after K6 prefetched it, against the same call right after
    a K4/K5 call that did not (the next slab cold); K6's bound (both
    slabs' bytes); and torch.matmul over the dequantized bf16 chunk.
    Every timed call cycles through copies of the planes that together
    exceed the L2."""
    from kaito_tpu_torch.engine.ops.overlap_collectives import _slice_out
    from kaito_tpu_torch.engine.ops.quant_matmul import (
        prefetch_ok, quant_matmul_cuda, quant_matmul_plain)
    from kaito_tpu_torch.engine.quant import dequant_weight, quantize_weight

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    for scheme, name, replaces in (
            ("int8", "quant_matmul_int8_pf", "kaito_tpu/engine/ops/quant_matmul.py:193"),
            ("int4", "quant_matmul_int4_pf", "kaito_tpu/engine/ops/quant_matmul.py:199")):
        err = {torch.bfloat16: 0.0, torch.float32: 0.0}
        timed = []
        for label, (K, N) in PF_SHAPES.items():
            def planes():
                return tuple(quantize_weight(torch.randn(K, N, generator=gen,
                                                         device="cuda")
                                             / math.sqrt(K), scheme) for _ in range(2))
            w, w_next = planes()
            nc = N // 2
            for c in (0, 1):
                wc, pc = _slice_out(w, c * nc, nc), _slice_out(w_next, c * nc, nc)
                if not prefetch_ok(wc, pc):
                    raise SmokeFailure(f"{name} {label}: prefetch_ok refused the "
                                       f"ring chunk")
                for rows in (1, 8, 200):
                    for dtype in (torch.bfloat16, torch.float32):
                        x = torch.randn(rows, K, generator=gen, device="cuda").to(dtype)
                        out = quant_matmul_cuda(x, wc, pc)
                        base = quant_matmul_cuda(x, wc)
                        ref = quant_matmul_plain(x, wc).float()
                        torch.cuda.synchronize()
                        if not torch.equal(out, base):
                            raise SmokeFailure(
                                f"{name} {label} chunk {c} rows {rows} {dtype}: not "
                                f"bitwise equal to the kernel without prefetch")
                        e = (out.float() - ref).abs().max().item() / max(
                            ref.abs().max().item(), 1e-30)
                        err[dtype] = max(err[dtype], e)
            log(f"{name} {label} chunk [{K}x{nc} of {N}] rows 1/8/200: bitwise equal "
                f"to K4/K5; max relative err bf16 {err[torch.bfloat16]:.3g} fp32 "
                f"{err[torch.float32]:.3g}")
            rows = 8
            x = torch.randn(rows, K, generator=gen, device="cuda").to(torch.bfloat16)
            pair_bytes = 2 * sum(t.numel() * t.element_size() for t in w.values())
            nxt = _cold_cycle(planes, pair_bytes)
            chunk = lambda t: _slice_out(t, 0, nc)   # noqa: E731
            def k6():
                live, ahead = nxt()
                return quant_matmul_cuda(x, chunk(live), chunk(ahead))

            ms, host_ms = time_ms(k6)
            state = {}

            def first(pf):
                state["w"] = nxt()
                a, b = chunk(state["w"][0]), chunk(state["w"][1])
                return quant_matmul_cuda(x, a, b) if pf else quant_matmul_cuda(x, a)

            warm = _time_second(torch, lambda: first(True),
                                lambda: quant_matmul_cuda(x, chunk(state["w"][1])))
            cold = _time_second(torch, lambda: first(False),
                                lambda: quant_matmul_cuda(x, chunk(state["w"][1])))
            plain_ms = time_ms(lambda: quant_matmul_plain(x, chunk(nxt()[0])), iters=5)[0]
            del nxt, state
            deq = dequant_weight(chunk(w), torch.bfloat16)
            nxt_lib = _cold_cycle(lambda: deq.clone(), deq.numel() * 2)
            library_ms = time_ms(lambda: torch.matmul(x, nxt_lib()))[0]
            del nxt_lib, deq
            slab = sum(t.numel() * t.element_size() for t in chunk(w).values())
            b_ms, b_by = bound(2 * rows * K + 2 * slab + 2 * rows * nc,
                               2.0 * rows * K * nc)
            log(f"{name} {label} chunk rows {rows}: {ms:.4f} ms (plain {plain_ms:.4f}, "
                f"torch.matmul bf16 {library_ms:.4f}, bound {b_ms:.5f} by {b_by}; "
                f"host {host_ms:.4f}); next layer's call after the prefetch "
                f"{warm:.4f} ms, after no prefetch {cold:.4f} ms")
            timed.append(dict(case=f"{label} chunk [{K}x{nc} of {N}] rows {rows}",
                              ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=b_ms, bound_by=b_by, host_ms=host_ms,
                              next_call_prefetched_ms=warm, next_call_cold_ms=cold))
            del w, w_next
        if err[torch.bfloat16] > BF16_ATOL or err[torch.float32] > FP32_ATOL:
            raise SmokeFailure(f"{name} disagrees with its plain version: {err}")
        main = next(t for t in timed if t["case"].startswith("down"))
        records[name] = dict(
            name=name, route="cuda", source="kaito_tpu_torch/csrc/quant_matmul.cu",
            replaces=replaces,
            shape=f"x [8, 7168] bf16 @ {scheme} W [7168, 2048 of 4096 columns] "
                  f"(TP=2 down ring chunk) + the next layer's chunk prefetched",
            max_abs_err=err[torch.bfloat16], max_rel_err_bf16=err[torch.bfloat16],
            max_rel_err_fp32=err[torch.float32], bitwise_equal_to_no_prefetch=True,
            ms=main["ms"], kernel_ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], host_ms=main["host_ms"],
            next_call_prefetched_ms=main["next_call_prefetched_ms"],
            next_call_cold_ms=main["next_call_cold_ms"], cases=timed)


def check_quant_graph(torch, records):
    """One K5 call (x [8, 4096] @ int4 gate/up [4096, 14336]) and one K6
    call (x [8, 7168] @ the int4 TP=2 down ring chunk [7168, 2048 of 4096],
    the next chunk prefetched) captured in a CUDA graph; each replayed
    after new x is copied into its input, then again after an eager call
    of 16 rows over the whole plane (more partials than the captured plan):
    every replay against the plain version (relative to the output's
    largest magnitude, ``BF16_ATOL``) and bitwise against the eager
    kernel; the card's workspace must not move and its merge counters
    must read zero."""
    from kaito_tpu_torch.engine.ops import quant_matmul as qm
    from kaito_tpu_torch.engine.ops.overlap_collectives import _slice_out
    from kaito_tpu_torch.engine.quant import quantize_weight

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def weight(K, N):
        return quantize_weight(torch.randn(K, N, generator=gen, device="cuda")
                               / math.sqrt(K), "int4")

    def rel_err(out, ref):
        return (out.float() - ref.float()).abs().max().item() / max(
            ref.float().abs().max().item(), 1e-30)

    worst = {}
    for name, (K, N), chunk in (("quant_matmul_int4", PROJ_SHAPES["gate/up"], None),
                                ("quant_matmul_int4_pf", PF_SHAPES["down"], 2)):
        w, w_next = weight(K, N), weight(K, N)
        live = _slice_out(w, 0, N // chunk) if chunk else w
        ahead = _slice_out(w_next, 0, N // chunk) if chunk else None
        x = torch.randn(8, K, generator=gen, device="cuda").to(torch.bfloat16)
        run = lambda: qm.quant_matmul_cuda(x, live, ahead)   # noqa: E731
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        ws = qm.decode_workspace(x.device)
        ptrs = (ws.part.data_ptr(), ws.counters.data_ptr())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = run()
        err = 0.0
        for larger in (False, False, True, False):
            if larger:
                # 16 rows over the whole plane: more partials than the
                # captured plan (twice the rows; at down also twice the
                # columns of the ring's chunk)
                x16 = torch.randn(16, K, generator=gen, device="cuda").to(torch.bfloat16)
                err = max(err, rel_err(qm.quant_matmul_cuda(x16, w),
                                       qm.quant_matmul_plain(x16, w)))
                continue
            x.copy_(torch.randn(8, K, generator=gen, device="cuda").to(torch.bfloat16))
            graph.replay()
            eager = qm.quant_matmul_cuda(x, live)
            ref = qm.quant_matmul_plain(x, live)
            torch.cuda.synchronize()
            if not torch.equal(out, eager):
                raise SmokeFailure(f"{name} replayed from a CUDA graph is not bitwise the "
                                   f"eager kernel")
            err = max(err, rel_err(out, ref))
        if (ws.part.data_ptr(), ws.counters.data_ptr()) != ptrs:
            raise SmokeFailure("the quant matmul's decode workspace moved under a graph")
        if ws.counters.any():
            raise SmokeFailure(f"{name}: a merge counter is not back at zero after replays")
        worst[name] = err
        records[name]["graph_replay_max_rel_err"] = err
        del graph, w, w_next
    log(f"K5/K6 CUDA graph replays (new x, then after a larger call): max relative "
        f"err {worst}")
    if max(worst.values()) > BF16_ATOL:
        raise SmokeFailure(f"K5/K6 replayed from a CUDA graph disagree: {worst}")


def _flash_inputs(torch, dtype, T, gen, B=1, H=32, Hkv=8, D=128):
    q = torch.randn(B, T, H, D, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, T, Hkv, D, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, T, Hkv, D, generator=gen, device="cuda").to(dtype)
    return q, k, v


def _packed_layout(torch, T, seg_lens):
    segs = torch.full((1, T), -1, dtype=torch.int32)
    poss = torch.zeros((1, T), dtype=torch.int32)
    off = 0
    for si, n in enumerate(seg_lens):
        segs[0, off:off + n] = si
        poss[0, off:off + n] = torch.arange(n, dtype=torch.int32)
        off += n
    return segs.cuda(), poss.cuda()


# phase 2's packed layouts: (T, segment lengths); pads fill the rest
FLASH_PACKED = {512: (100, 150, 120, 90),          # 460 tokens + 52 pad
                256: (50, 75, 60, 45)}             # 230 tokens + 26 pad
# many short segments (1-3 tokens) and one that spans three 64-key tiles
SHORT_SEGMENTS = (1, 2, 3) * 20 + (1, 3, 170) + (2,) * 10


def _time_flash(torch, T, gen, scale):
    """K2 and K3 bf16 at B=1, T, H=32, Hkv=8, D=128: the kernel, the plain
    version, one SDPA call for the same function, and the bound."""
    from kaito_tpu_torch.engine.ops.flash_prefill import (
        flash_prefill_attention_cuda, flash_prefill_attention_plain,
        flash_prefill_packed_cuda, flash_prefill_packed_plain)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    seg_lens = FLASH_PACKED[T]
    segs, poss = _packed_layout(torch, T, seg_lens)
    q, k, v = _flash_inputs(torch, torch.bfloat16, T, gen)
    H, D = q.shape[2], q.shape[3]
    tl = torch.tensor([T], dtype=torch.int32, device="cuda")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    io_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    ms2, host2 = time_ms(lambda: flash_prefill_attention_cuda(q, k, v, tl, BIG,
                                                             scale=scale))
    plain2 = time_ms(lambda: flash_prefill_attention_plain(q, k, v, tl, BIG,
                                                           scale=scale), iters=5)[0]
    lib2 = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, scale=scale,
                                enable_gqa=True))[0]
    b2, by2 = bound(io_bytes + 4, 4.0 * H * D * T * (T + 1) / 2)
    ms3, host3 = time_ms(lambda: flash_prefill_packed_cuda(q, k, v, segs, poss, BIG,
                                                           scale=scale))
    plain3 = time_ms(lambda: flash_prefill_packed_plain(q, k, v, segs, poss, BIG,
                                                        scale=scale), iters=5)[0]
    sq, sk = segs[0][:, None], segs[0][None, :]
    pq, pk = poss[0][:, None], poss[0][None, :]
    mask = ((sq == sk) & (sq >= 0) & (pk <= pq))[None, None]
    lib3 = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask, scale=scale,
                                enable_gqa=True))[0]
    b3, by3 = bound(io_bytes + 2 * T * 4,
                    sum(4.0 * H * D * n * (n + 1) / 2 for n in seg_lens))
    log(f"T={T} bf16: K2 {ms2:.4f} ms (plain {plain2:.4f}, SDPA causal "
        f"{lib2:.4f}, bound {b2:.5f} by {by2}); K3 segments {seg_lens} "
        f"{ms3:.4f} ms (plain {plain3:.4f}, SDPA block mask {lib3:.4f}, bound "
        f"{b3:.5f} by {by3})")
    return (dict(ms=ms2, host_ms=host2, plain_ms=plain2, library_ms=lib2,
                 bound_ms=b2, bound_by=by2),
            dict(ms=ms3, host_ms=host3, plain_ms=plain3, library_ms=lib3,
                 bound_ms=b3, bound_by=by3, segments=seg_lens))


def check_flash(torch, records):
    from kaito_tpu_torch.engine.ops.flash_prefill import (
        flash_prefill_attention_cuda, flash_prefill_attention_plain,
        flash_prefill_packed_cuda, flash_prefill_packed_plain)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    err2 = {torch.bfloat16: 0.0, torch.float32: 0.0}
    err3 = dict(err2)
    # (T, H, Hkv, D) x (true_len, window, softcap) for K2; the packed
    # layouts of K3 at each T
    shapes = ((512, 32, 8, 128), (256, 32, 8, 128), (200, 8, 2, 64),
              (200, 32, 8, 128))
    for dtype in (torch.bfloat16, torch.float32):
        for T, H, Hkv, D in shapes:
            scale = 1.0 / math.sqrt(D)
            for true_len, window, softcap in ((T, BIG, None), (T * 3 // 5, 128, None),
                                              (T - 7, BIG, 30.0), (T, 32, None)):
                q, k, v = _flash_inputs(torch, dtype, T, gen, H=H, Hkv=Hkv, D=D)
                tl = torch.tensor([true_len], dtype=torch.int32, device="cuda")
                out = flash_prefill_attention_cuda(q, k, v, tl, window, scale=scale,
                                                   softcap=softcap)
                ref = flash_prefill_attention_plain(q, k, v, tl, window, scale=scale,
                                                    softcap=softcap)
                torch.cuda.synchronize()
                e = (out.float() - ref.float())[:, :true_len].abs().max().item()
                err2[dtype] = max(err2[dtype], e)
                log(f"K2 {dtype} T={T} H={H} Hkv={Hkv} D={D} true_len={true_len} "
                    f"window={window} softcap={softcap}: max err {e:.3g}")
            layouts = [FLASH_PACKED.get(T, (T // 3, T // 4, T // 5))]
            if T == 512:
                layouts.append(SHORT_SEGMENTS)
            for seg_lens in layouts:
                segs, poss = _packed_layout(torch, T, seg_lens)
                valid = sum(seg_lens)
                for window, softcap in ((BIG, None), (64, None), (BIG, 30.0),
                                        (32, None)):
                    q, k, v = _flash_inputs(torch, dtype, T, gen, H=H, Hkv=Hkv, D=D)
                    out = flash_prefill_packed_cuda(q, k, v, segs, poss, window,
                                                    scale=scale, softcap=softcap)
                    ref = flash_prefill_packed_plain(q, k, v, segs, poss, window,
                                                     scale=scale, softcap=softcap)
                    torch.cuda.synchronize()
                    if not torch.isfinite(out.float()).all():
                        raise SmokeFailure(f"K3 {dtype} T={T}: non-finite output")
                    e = (out.float() - ref.float())[:, :valid].abs().max().item()
                    err3[dtype] = max(err3[dtype], e)
                    log(f"K3 {dtype} T={T} D={D} {len(seg_lens)} segments "
                        f"({valid} tokens) window={window} softcap={softcap}: "
                        f"max err {e:.3g}")

    scale = 1.0 / math.sqrt(128)
    t512 = _time_flash(torch, 512, gen, scale)
    t256 = _time_flash(torch, 256, gen, scale)
    for name, i, src_line, shape in (
            ("flash_prefill_attention", 0, 225,
             "B=1 T=512 H=32 Hkv=8 D=128 causal bf16"),
            ("flash_prefill_packed", 1, 163,
             "B=1 T=512 (segments 100,150,120,90 + 52 pad) H=32 Hkv=8 D=128 bf16")):
        err = (err2, err3)[i]
        records[name] = dict(
            name=name, route="cuda", source="kaito_tpu_torch/csrc/flash_prefill.cu",
            replaces=f"kaito_tpu/engine/ops/flash_prefill.py:{src_line}",
            shape=shape, max_abs_err=err[torch.bfloat16],
            max_err_bf16=err[torch.bfloat16], max_err_fp32=err[torch.float32],
            kernel_ms=t512[i]["ms"], t256=t256[i], **t512[i])
    for name, err in (("K2", err2), ("K3", err3)):
        if err[torch.bfloat16] > BF16_ATOL or err[torch.float32] > FP32_ATOL:
            raise SmokeFailure(f"{name} disagrees with its plain version: {err}")


# ---------------------------------------------------------------------------
# Phase 3: goldens
# ---------------------------------------------------------------------------

# golden section -> (quantization, kv_dtype) of the engine that replays it
GOLDEN_MODES = {"fp32": ("", "float32"), "int8": ("int8", "float32"),
                "weight_int4": ("int4", "float32"), "kv_int8": ("", "int8")}


def tp_mesh(torch, n, shared=False):
    """A tensor-parallel mesh of n slots: the first n cards, or, with
    ``shared`` or on a machine with fewer, every slot on the first card."""
    from kaito_tpu_torch.parallel.mesh import build_mesh

    if torch.cuda.device_count() >= n and not shared:
        return build_mesh(tensor=n)
    return build_mesh(tensor=n, devices=["cuda:0"] * n)


def check_goldens(section, tp=1, overlap=False):
    """Replay one golden section; at ``tp`` > 1 on a :func:`tp_mesh`,
    with the comm-overlap decode ring on or off."""
    import torch

    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams

    golden = json.load(open(os.path.join(
        REPO, "tests", "testdata", "goldens_tiny-llama-real.json")))
    quant, kv_dtype = GOLDEN_MODES[section]
    cfg = EngineConfig(model="tiny-llama-real",
                       weights_dir=os.path.join(REPO, "checkpoints",
                                                "tiny-llama-real"),
                       dtype="float32", kv_dtype=kv_dtype, max_model_len=512,
                       max_num_seqs=2, prefill_buckets=(64, 128),
                       enable_prefix_caching=False, quantization=quant, seed=0,
                       tensor_parallel=tp, comm_overlap=overlap)
    eng = InferenceEngine(cfg, device="cuda",
                          mesh=tp_mesh(torch, tp) if tp > 1 else None)
    if eng.comm_overlap != overlap:
        raise SmokeFailure(f"{section} TP={tp}: comm_overlap={eng.comm_overlap}, "
                           f"asked {overlap}")
    eng.start()
    worst = 0.0
    try:
        for p in golden["prompts"]:
            want = p[section]["greedy_tokens"]
            req = eng.submit(list(p["prompt_tokens"]), SamplingParams(
                max_tokens=len(want), temperature=0.0, ignore_eos=True,
                logprobs=True))
            got = list(req.stream())
            if got != want:
                raise SmokeFailure(f"{section} golden tokens differ for "
                                   f"{p['text']!r}: {got} != {want}")
            d = max(abs(a - b) for a, b in zip(req.output_logprobs,
                                               p[section]["logprobs"]))
            worst = max(worst, d)
            if d > 2e-3:
                raise SmokeFailure(f"{section} golden logprobs off by {d:.3g} "
                                   f"for {p['text']!r}")
    finally:
        eng.stop()
    log(f"goldens {section} TP={tp} overlap={overlap}: {len(golden['prompts'])} "
        f"prompts exact, worst logprob diff {worst:.3g}")
    return worst


# TP golden replays: (tensor_parallel, sections); each with overlap off
# and on.  int4 is refused at TP=4: a shard of tiny-llama-real's o
# projection would hold 64 in-rows, not a whole group of 128
TP_GOLDENS = ((2, ("fp32", "int8", "weight_int4", "kv_int8")),
              (4, ("fp32", "int8", "kv_int8")))


# ---------------------------------------------------------------------------
# Phase 4: the full-width server
# ---------------------------------------------------------------------------

def _post(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _prompt(n_bytes: int, salt: int) -> str:
    words = ("kernel page prefill decode tensor window segment cache model "
             "token batch stream").split()
    out, i = [], salt
    while len(" ".join(out)) < n_bytes - 1:
        out.append(words[i % len(words)])
        i = i * 7 + 3
    return " ".join(out)[: n_bytes - 1]   # the byte tokenizer adds a BOS


def _completion(base, prompt, max_tokens, **extra):
    t0 = time.perf_counter()
    status, raw = _post(f"{base}/v1/completions", dict(
        prompt=prompt, max_tokens=max_tokens, temperature=0.0, ignore_eos=True,
        **extra))
    dt = time.perf_counter() - t0
    resp = json.loads(raw)
    if status != 200 or resp.get("object") != "text_completion":
        raise SmokeFailure(f"bad completion response {status}: {raw[:300]!r}")
    ch = resp["choices"][0]
    if not isinstance(ch.get("text"), str) or ch.get("finish_reason") != "length":
        raise SmokeFailure(f"malformed choice {ch}")
    if resp["usage"]["completion_tokens"] != max_tokens:
        raise SmokeFailure(f"asked {max_tokens} tokens, got {resp['usage']}")
    return resp, dt


def _stream_chat(base, max_tokens):
    req = urllib.request.Request(
        f"{base}/v1/chat/completions",
        data=json.dumps(dict(
            messages=[{"role": "user", "content": "Name three prime numbers."}],
            max_tokens=max_tokens, temperature=0.0, ignore_eos=True, stream=True,
            stream_options={"include_usage": True})).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            line = line.decode().strip()
            if line.startswith("data: "):
                events.append(line[len("data: "):])
    if not events or events[-1] != "[DONE]":
        raise SmokeFailure(f"stream did not end with [DONE]: {events[-3:]}")
    chunks = [json.loads(e) for e in events[:-1]]
    if chunks[0]["choices"][0]["delta"].get("role") != "assistant":
        raise SmokeFailure(f"stream lacks the role chunk: {chunks[0]}")
    if not any(c["choices"] and c["choices"][0]["finish_reason"] == "length"
               for c in chunks):
        raise SmokeFailure("stream lacks a finish_reason=length chunk")
    usage = chunks[-1].get("usage") or {}
    if usage.get("completion_tokens") != max_tokens:
        raise SmokeFailure(f"stream asked {max_tokens} tokens, usage {usage}")
    if any(c["object"] != "chat.completion.chunk" for c in chunks):
        raise SmokeFailure("stream chunk with a wrong object type")
    return len(chunks)


def run_server_phase(flags, counted, label, burst=True, run_ahead_sweep=False,
                     profile=False, tp=1, shared=False):
    """Serve ``llama-3.1-8b-instruct`` at full width with the server's
    command-line ``flags`` and drive the request mix (``burst=False``
    leaves out the concurrent burst).  At ``tp`` > 1 the engine is built
    on a :func:`tp_mesh` and handed to ``make_server``.  Returns the
    launch counts of the kernel records ``counted``, zeroed just before
    the requests, and the leg's statistics."""
    import torch

    from kaito_tpu_torch.engine.engine import InferenceEngine
    from kaito_tpu_torch.engine.server import make_server, parse_args

    cfg, _ = parse_args(["--model", "llama-3.1-8b-instruct", "--dtype", "bfloat16",
                         "--max-num-seqs", "8", "--seed", "0", *flags])
    t0 = time.perf_counter()
    if tp > 1:
        mesh = tp_mesh(torch, tp, shared)
        engine = InferenceEngine(cfg, device="cuda", mesh=mesh)
        if not engine.comm_overlap:
            raise SmokeFailure(f"{label}: the comm-overlap gate did not engage")
        engine.start()
        server = make_server(engine, cfg, host="127.0.0.1", port=0, device="cuda")
        log(f"{label}: {mesh}; shards share one card: {mesh.shared}")
    else:
        server = make_server(None, cfg, host="127.0.0.1", port=0, device="cuda")
    engine = server.state.engine
    torch.cuda.synchronize()
    log(f"{label}: 8B engine up in {time.perf_counter() - t0:.1f}s: "
        f"{engine.model.param_bytes() / 2**30:.2f} GiB weights, KV "
        f"{cfg.kv_dtype}, {engine.sizing_report}")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    stats = {}
    try:
        for name in counted:
            fn, attr = _counter(name)
            setattr(fn, attr, 0)
        status, raw = _get(f"{base}/health")
        if status != 200 or json.loads(raw)["status"] != "ok":
            raise SmokeFailure(f"/health answered {status} {raw!r}")
        status, raw = _get(f"{base}/v1/models")
        if status != 200 or json.loads(raw)["data"][0]["id"] != engine.md.name:
            raise SmokeFailure(f"/v1/models answered {status} {raw!r}")
        status, _ = _get(f"{base}/metrics")
        if status != 501:
            raise SmokeFailure(f"/metrics (not ported) answered {status}")

        resp, _ = _completion(base, _prompt(60, 1), 16, logprobs=1)
        lps = resp["choices"][0]["logprobs"]["token_logprobs"]
        if len(lps) != 16 or not all(math.isfinite(x) and x <= 0 for x in lps):
            raise SmokeFailure(f"bad logprobs {lps}")
        n_chunks = _stream_chat(base, 16)
        log(f"completion + streamed chat ok ({n_chunks} SSE chunks)")

        if burst:
            stats.update(_burst(base, engine))
        # TTFT and decode rate of one request alone
        p = _prompt(200, 30)
        ttft = min(_completion(base, p, 1)[1] for _ in range(3))
        t_long = min(_completion(base, p, 129)[1] for _ in range(2))
        # inter-token gaps of one sequence alone, as the engine delivers them
        single = _itl(_timed_tokens(engine, p, 129))
        stats.update(ttft_ms=ttft * 1e3, decode_tok_s=128 / (t_long - ttft),
                     prompt_tokens=200, run_ahead=engine.run_ahead,
                     tensor_parallel=tp, comm_overlap=engine.comm_overlap,
                     shared_card=bool(tp > 1 and engine.mesh.shared),
                     weights_gib=engine.model.param_bytes() / 2**30,
                     kv_pages=engine.sizing_report.get("pages"),
                     single_stream=single)
        log(f"{label}: one sequence at run_ahead={engine.run_ahead}: "
            f"{single['decode_tok_s']:.2f} tok/s, ITL p50/p90/max "
            f"{single['itl_p50_ms']:.1f}/{single['itl_p90_ms']:.1f}/"
            f"{single['itl_max_ms']:.1f} ms")
        torch.cuda.synchronize()
        launches = {name: getattr(*_counter(name)) for name in counted}
        log(f"{label}: launches {launches}; decode steps "
            f"{engine.counters['decode_steps_total']}")
        if run_ahead_sweep:
            stats["run_ahead_sweep"] = sweep_run_ahead(engine)
        if profile:
            stats["profile"] = profile_request(engine, base)
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=30)
    return launches, stats


def _burst(base, engine):
    """A long decode in flight, then four concurrent 100-400-token
    prompts (they stage together, so their prefill forms a pack) and one
    700-token prompt (a continuation chunk)."""
    results, errors = {}, []

    def run(key, prompt, n):
        try:
            results[key] = _completion(base, prompt, n)
        except Exception as e:   # reported below; the phase fails
            errors.append(f"{key}: {e!r}")

    bg = threading.Thread(target=run, args=("bg", _prompt(40, 2), 96))
    bg.start()
    time.sleep(0.5)
    burst = [threading.Thread(target=run, args=(f"c{i}", _prompt(n, 10 + i), 32))
             for i, n in enumerate((120, 250, 330, 400))]
    burst.append(threading.Thread(target=run, args=("long", _prompt(700, 20), 32)))
    t_burst = time.perf_counter()
    for t in burst:
        t.start()
    for t in burst + [bg]:
        t.join(timeout=600)
    t_burst = time.perf_counter() - t_burst
    if errors or len(results) != 6:
        raise SmokeFailure(f"concurrent requests failed: {errors}")
    packs = engine.counters["prefill_packed_steps_total"]
    log(f"burst of 5 ok in {t_burst:.2f}s; packed prefill dispatches {packs}")
    return dict(burst_s=t_burst, burst_completion_tokens=32 * 5,
                packed_prefill_dispatches=packs)


def _release_card(torch):
    """Drop a finished leg's engine (its cycles included) and hand the
    cached blocks back, so the next leg sizes its pool from a free card."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"card memory after release: {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated")


def profile_request(engine, base):
    """torch.profiler over one 200-token prefill alone
    (:func:`_profile_prefill`), then over one request alone (200-token
    prompt, 33 output tokens): wall time, device busy time, kernel
    launches and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _completion(base, _prompt(200, 50), 8)           # warm
    prefill = _profile_prefill(base)
    steps0 = engine.counters["decode_steps_total"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _completion(base, _prompt(200, 51), 33)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()   # the trace holds every kernel the request ran
    steps = engine.counters["decode_steps_total"] - steps0
    rows = _device_rows(prof)
    busy = sum(r[2] for r in rows)
    flash = sum(r[2] for r in rows if "flash" in r[0])
    log(f"profile: flash prefill kernels (K2, K3) {flash:.3f} device ms in "
        f"{sum(r[1] for r in rows if 'flash' in r[0])} launches")
    quant = sum(r[2] for r in rows if "quant_matmul" in r[0])
    res = dict(wall_ms=wall * 1e3, device_busy_ms=busy, flash_device_ms=flash,
               quant_matmul_device_ms=quant,
               device_idle_share=1.0 - busy / (wall * 1e3),
               kernel_launches=sum(r[1] for r in rows), decode_steps=steps,
               prefill=prefill,
               top=[dict(name=k[:80], count=c, ms=ms) for k, c, ms in rows[:12]])
    log(f"profile: wall {res['wall_ms']:.1f} ms, device busy {busy:.1f} ms, "
        f"{res['kernel_launches']} kernel launches, {steps} decode steps")
    for r in res["top"]:
        log(f"  {r['ms']:8.2f} ms  x{r['count']:5d}  {r['name']}")
    return res


def _device_rows(prof):
    """(kernel name, launches, device ms) of every kernel in a profile."""
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0 and "CPU" not in str(getattr(e, "device_type", "")):
            rows.append((e.key, e.count, dev / 1e3))
    return sorted(rows, key=lambda r: -r[2])


def _profile_prefill(base):
    """torch.profiler over one 200-token prompt answered with one token:
    the prefill alone.  Its wall time (the request's TTFT under the
    profiler), device busy time, and the device time and launches of the
    quantized matmul kernels (K4/K5, with any split-K reduction) by
    kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _completion(base, _prompt(200, 52), 1)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    quant = [r for r in rows if "quant_matmul" in r[0]]
    res = dict(wall_ms=wall * 1e3, device_busy_ms=sum(r[2] for r in rows),
               quant_matmul_device_ms=sum(r[2] for r in quant),
               quant_matmul_launches=sum(r[1] for r in quant),
               quant_matmul_kernels=[dict(name=k[:100], count=c, ms=ms)
                                     for k, c, ms in quant])
    log(f"profile, one 200-token prefill: wall {res['wall_ms']:.1f} ms, device busy "
        f"{res['device_busy_ms']:.2f} ms, quant matmul {res['quant_matmul_device_ms']:.3f}"
        f" ms in {res['quant_matmul_launches']} launches")
    for r in res["quant_matmul_kernels"]:
        log(f"  {r['ms']:8.3f} ms  x{r['count']:5d}  {r['name']}")
    return res


def _timed_tokens(engine, prompt: str, n: int) -> list[float]:
    """Submit one greedy request straight to the serving engine and stamp
    the host clock as each token is delivered (the moment the server
    could stream it)."""
    from kaito_tpu_torch.engine.engine import SamplingParams

    req = engine.submit(engine.tokenizer.encode(prompt), SamplingParams(
        max_tokens=n, temperature=0.0, ignore_eos=True))
    stamps = [time.perf_counter() for _ in req.stream()]
    if len(stamps) != n:
        raise SmokeFailure(f"asked {n} tokens, got {len(stamps)}")
    return stamps


def _quantile(xs, f):
    xs = sorted(xs)
    i = f * (len(xs) - 1)
    lo = int(math.floor(i))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (i - lo)


def _itl(stamps) -> dict:
    gaps = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    return dict(decode_tok_s=len(gaps) / (stamps[-1] - stamps[0]),
                itl_p50_ms=_quantile(gaps, 0.5), itl_p90_ms=_quantile(gaps, 0.9),
                itl_max_ms=max(gaps))


def pick_run_ahead(single: dict) -> int:
    """The smallest fused window whose single-stream median decode rate
    beats K=1's by more than the larger of the two interquartile ranges;
    1 when none does."""
    def iqr(v):
        return _quantile(v, 0.75) - _quantile(v, 0.25)

    base = single[1]
    for k in sorted(single):
        if k == 1:
            continue
        gain = _quantile(single[k], 0.5) - _quantile(base, 0.5)
        if gain > max(iqr(base), iqr(single[k])):
            return k
    return 1


def sweep_run_ahead(engine, values=(1, 2, 4, 8, 16), reps=6):
    """Decode rate and inter-token latency per fused-window size K,
    ``reps`` rounds with the order of the sizes reversed every other
    round, on two workloads through the serving engine: one sequence
    alone (200-token prompt, 129 tokens; tokens/s over its 128 decode
    gaps, and the gaps' p50/p90/max), and 8 concurrent requests of 128
    tokens (aggregate tokens/s, prefill included)."""
    single = {k: [] for k in values}
    itl = {k: [] for k in values}
    conc = {k: [] for k in values}
    errors = []

    def run(i):
        try:
            _timed_tokens(engine, _prompt(64, 40 + i), 128)
        except Exception as e:   # reported below; the sweep fails
            errors.append(repr(e))

    for rep in range(reps):
        for k in (values if rep % 2 == 0 else values[::-1]):
            engine.run_ahead = k
            r = _itl(_timed_tokens(engine, _prompt(200, 60 + rep), 129))
            single[k].append(r["decode_tok_s"])
            itl[k].append(r)
            ths = [threading.Thread(target=run, args=(i,)) for i in range(8)]
            t0 = time.perf_counter()
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=600)
            conc[k].append(8 * 128 / (time.perf_counter() - t0))
            if errors:
                raise SmokeFailure(f"sweep requests failed: {errors}")
    pick = pick_run_ahead(single)
    for k in values:
        med = {f: _quantile([r[f] for r in itl[k]], 0.5)
               for f in ("itl_p50_ms", "itl_p90_ms", "itl_max_ms")}
        log(f"run_ahead={k}: single " + " ".join(f"{x:.2f}" for x in single[k])
            + f" tok/s (median {_quantile(single[k], 0.5):.2f}, IQR "
            f"{_quantile(single[k], 0.75) - _quantile(single[k], 0.25):.2f}); "
            f"ITL median of p50/p90/max {med['itl_p50_ms']:.1f}/"
            f"{med['itl_p90_ms']:.1f}/{med['itl_max_ms']:.1f} ms; concurrent8 "
            + " ".join(f"{x:.1f}" for x in conc[k]) + " tok/s")
    log(f"run_ahead pick (smallest K beating K=1 by more than the IQR): {pick}")
    return dict(single=single, itl=itl, concurrent8=conc, pick=pick)


_TP2 = ["--tensor-parallel-size", "2", "--comm-overlap"]
# the server legs of phases 4-6: (name for --leg, label, server flags,
# counters that must grow, burst, tensor-parallel degree)
LEGS = (("bf16", "phase 4, bf16", [],
         ("paged_decode_attention", "flash_prefill_attention", "flash_prefill_packed"),
         True, 1),
        ("int4-kv8", "phase 5, int4 weights + int8 KV",
         ["--quantization", "int4", "--kv-cache-dtype", "int8"],
         ("quant_matmul_int4", "quant_matmul_int4_wide",
          "paged_decode_attention_int8kv"), True, 1),
        ("int8", "phase 5, int8 weights", ["--quantization", "int8"],
         ("quant_matmul_int8", "quant_matmul_int8_wide"), False, 1),
        ("tp2-int4-kv8", "phase 6, TP=2 int4 weights + int8 KV, comm overlap",
         ["--quantization", "int4", "--kv-cache-dtype", "int8", *_TP2],
         ("quant_matmul_int4_pf", "quant_matmul_int4", "paged_decode_attention_int8kv",
          "flash_prefill_attention", "flash_prefill_packed"), True, 2),
        ("tp2-int8", "phase 6, TP=2 int8 weights, comm overlap",
         ["--quantization", "int8", *_TP2],
         ("quant_matmul_int8_pf", "paged_decode_attention"), False, 2))


def _watchdog(seconds: float) -> None:
    """Fail the run (exit 1, no result) if it has not finished in time:
    a hung request must not hold the card until an outer limit."""
    def fire():
        log(f"FAIL: not finished after {seconds:.0f}s")
        os._exit(1)

    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep-run-ahead", action="store_true",
                    help="also sweep decode_run_ahead at full width")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one full-width request of each server "
                         "leg with torch.profiler")
    ap.add_argument("--phase2-only", action="store_true",
                    help="stop after phase 2 (build and kernel checks) and print "
                         "the kernel records without launches; no result line")
    ap.add_argument("--first-leg-only", action="store_true",
                    help="skip the goldens (phase 3) and every server leg after "
                         "phase 4's bf16 one; no result line")
    ap.add_argument("--leg", choices=[name for name, *_ in LEGS],
                    help="build the kernels and run this one server leg alone "
                         "(phases 2 and 3 skipped; with --profile, the quickest "
                         "reading of its TTFT and prefill device time); no result "
                         "line")
    ap.add_argument("--time-limit", type=float, default=1100.0,
                    help="seconds after which the run fails")
    args = ap.parse_args(argv)
    _watchdog(args.time_limit)
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False; this script needs a card")
        return 2
    try:
        import kaito_tpu_torch
    except ImportError as e:
        log(f"FAIL: the kaito_tpu_torch package is not beside this script: {e}")
        return 2
    pkg = os.path.dirname(os.path.abspath(kaito_tpu_torch.__file__))
    if os.path.dirname(pkg) != REPO:
        log(f"FAIL: kaito_tpu_torch imported from {pkg}, not from this checkout")
        return 2
    try:
        # fp32 matmuls in full fp32 (the goldens' precision), not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
        from kaito_tpu_torch.ops import build

        t0 = time.perf_counter()
        logs = build.build_all(ptxas_verbose=True)
        log(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f}s")
        for name, text in logs.items():
            for line in text.splitlines():
                if any(w in line for w in ("entry function", "registers", "spill",
                                           "setmaxnreg", "arning")):
                    log(f"  {name}: {line.strip()}")

        records: dict = {}
        alone = args.first_leg_only or args.leg is not None
        with torch.no_grad():
            if args.leg is None:
                check_decode(torch, records, logs)
                check_flash(torch, records)
                check_quant_matmul(torch, records, logs)
                check_quant_matmul_pf(torch, records)
                check_quant_graph(torch, records)
            if args.phase2_only:
                print(card)
                print(json.dumps({"kernels": [records[k[0]] for k in KERNELS]}))
                return 0
            golden_err = {} if alone else {
                sec: check_goldens(sec) for sec in GOLDEN_MODES}
            for tp, sections in () if alone else TP_GOLDENS:
                for sec in sections:
                    for ov in (False, True):
                        golden_err[f"{sec} TP={tp} overlap={ov}"] = check_goldens(
                            sec, tp, ov)
            _release_card(torch)
            # with two cards or more, each TP leg runs on the first two and
            # again with both shards on the first, so one run compares a real
            # ring hop with none
            placements = ((", two cards", False), (", one card", True)) \
                if torch.cuda.device_count() >= 2 else (("", True),)
            legs = [(label + where, flags, counted, burst, tp, shared)
                    for name, label, flags, counted, burst, tp in LEGS
                    if args.leg in (None, name)
                    for where, shared in (placements if tp > 1 else (("", False),))]
            if args.first_leg_only:
                legs = legs[:1]
            stats = {}
            for i, (label, flags, counted, burst, tp, shared) in enumerate(legs):
                launches, stats[label] = run_server_phase(
                    flags, counted, label, burst=burst,
                    run_ahead_sweep=args.sweep_run_ahead and i == 0,
                    profile=args.profile, tp=tp, shared=shared)
                _release_card(torch)
                for name in launches:
                    if launches[name] <= 0:
                        raise SmokeFailure(f"{name} never launched in {label}")
                    if alone:
                        continue
                    wide = next((w for w in WIDE_COUNTERS if w[0] == name), None)
                    rec = records[wide[1] if wide else name]
                    key = "launches_wide" if wide else "launches"
                    if key not in rec:
                        rec[key] = launches[name]
                    else:
                        rec.setdefault(key + "_by_leg", {})[label] = launches[name]
                log(f"{label} on {card}: TTFT {stats[label]['ttft_ms']:.1f} ms "
                    f"({stats[label]['prompt_tokens']}-token prompt, alone), decode "
                    f"{stats[label]['decode_tok_s']:.1f} tok/s (one sequence)")
        if alone:
            print(json.dumps({"server_legs": stats}))
            return 0
        log(f"golden logprob diffs {golden_err}")
        print(json.dumps({"server_legs": stats,
                          "golden_max_logprob_diff": golden_err}))
        print(card)
        print(json.dumps({"kernels": [records[k[0]] for k in KERNELS]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except Exception:
        log("FAIL:\n" + traceback.format_exc())
        return 1


if __name__ == "__main__":
    sys.exit(main())
