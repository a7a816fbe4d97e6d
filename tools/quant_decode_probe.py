"""Probe of the quantized matmul's decode-row path (K4/K5 at 1-16 bf16
rows) on one card: what its time depends on, beyond phase 2 of
``chip_smoke.py``.

Run from the root of a checkout (the one whose ``kaito_tpu_torch`` it
imports), on a card:

    python3 tools/quant_decode_probe.py calls            # any tree with the port
    python3 tools/quant_decode_probe.py splits           # a tree with decode_plan

``calls`` times ``quant_matmul_cuda`` at the Llama-3.1-8B projections,
int8 and int4, 1/8/16 rows, three ways: back to back behind a sleep
kernel (CUDA events, as phase 2 does), each call alone on an idle card
(torch.profiler's device time of the call's kernels, as ``--leg NAME
--profile`` reads them in serving), and the host time of one call (the
wrapper's Python and the launch) while the stream is held.  ``splits``
times K5 and K4 at k/v and q/o, 8, 9 and 16 rows, at every split the
plan can take (the SM count passed to the C entry picks it), back to
back and alone.  The weights are cycled past the L2, as in phase 2.
Each prints one JSON line per case; nothing is checked.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))   # the checkout's root

SHAPES = {"q/o": (4096, 4096), "k/v": (4096, 1024),
          "gate/up": (4096, 14336), "down": (14336, 4096)}
L2_BYTES = 50 << 20
SLEEP_CYCLES = 100_000_000


def cold_weights(K, N, scheme, gen):
    """Copies of one quantized [K, N] weight that together exceed twice
    the L2, and a function handing out the next one."""
    from kaito_tpu_torch.engine.quant import quantize_weight

    w = quantize_weight(torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5, scheme)
    nbytes = sum(t.numel() * t.element_size() for t in w.values())
    copies = [{k: t.clone() for k, t in w.items()}
              for _ in range(max(2, -(-2 * L2_BYTES // nbytes)))]
    state = {"i": 0}

    def nxt():
        state["i"] += 1
        return copies[state["i"] % len(copies)]
    return nxt


def back_to_back_ms(fn, iters=50):
    """Card ms per call, the calls queued behind a sleep kernel."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def alone_ms(fn, iters=50):
    """Device ms per call of every kernel the call launches, each call on
    an idle card (synchronized before and after), read by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
            torch.cuda.synchronize()
    dev, launches = 0.0, 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0)
        if t > 0 and "quant_matmul" in e.key:
            dev += t / 1e3
            launches += e.count
    return dev / iters, launches / iters


def host_ms(fn, iters=200):
    """Median host ms of one call, the stream held by a sleep kernel."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def calls(gen):
    from kaito_tpu_torch.engine.ops.quant_matmul import quant_matmul_cuda

    for label, (K, N) in SHAPES.items():
        for scheme in ("int8", "int4"):
            nxt = cold_weights(K, N, scheme, gen)
            for rows in (1, 8, 16):
                x = torch.randn(rows, K, generator=gen, device="cuda").to(torch.bfloat16)
                fn = lambda: quant_matmul_cuda(x, nxt())   # noqa: E731
                alone, launches = alone_ms(fn)
                print(json.dumps(dict(probe="calls", shape=label, scheme=scheme, rows=rows,
                                      back_to_back_ms=back_to_back_ms(fn), alone_ms=alone,
                                      launches_per_call=launches, host_ms=host_ms(fn))),
                      flush=True)
            del nxt


def splits(gen):
    from kaito_tpu_torch.engine.ops import quant_matmul as qm

    sms_card = torch.cuda.get_device_properties(0).multi_processor_count
    ws = qm.decode_workspace(torch.device("cuda", 0))
    fn_c = qm._kernel()
    stream = torch.cuda.current_stream().cuda_stream
    for label in ("k/v", "q/o"):
        K, N = SHAPES[label]
        for scheme in ("int4", "int8"):
            int4 = scheme == "int4"
            groups = K // 128 if int4 else 1
            nxt = cold_weights(K, N, scheme, gen)
            for rows in (8, 9, 16):
                x = torch.randn(rows, K, generator=gen, device="cuda").to(torch.bfloat16)
                out = torch.empty(rows, N, dtype=torch.bfloat16, device="cuda")
                # the first SM count (from the card's down) giving each split
                by_split = {}
                for sms in range(sms_card, 0, -1):
                    p = qm.decode_plan(rows, K, N, groups, int4, sms)
                    by_split.setdefault(p.n_split, (sms, p))

                for n_split, (sms, plan) in sorted(by_split.items(), reverse=True):
                    def fn(sms=sms):
                        w = nxt()
                        codes, scale = (w["q4"], w["scale"]) if int4 else (w["q8"], w["scale"])
                        rc = fn_c(x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                                  out.data_ptr(), ws.part.data_ptr(), ws.part.numel(),
                                  ws.counters.data_ptr(), rows, K, N, groups, int(int4), 1,
                                  codes.stride(0), scale.stride(0) if int4 else N, sms,
                                  ctypes.c_void_p(stream))
                        if rc:
                            raise RuntimeError(f"launch failed: {rc}")
                    print(json.dumps(dict(probe="splits", shape=label, scheme=scheme,
                                          rows=rows, n_split=n_split, kc=plan.kc,
                                          ctas=N // qm.DECODE_TN * n_split,
                                          plan_of_card=sms == sms_card,
                                          back_to_back_ms=back_to_back_ms(fn),
                                          alone_ms=alone_ms(fn)[0])), flush=True)
            del nxt


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", choices=("calls", "splits"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    {"calls": calls, "splits": splits}[args.probe](gen)


if __name__ == "__main__":
    main()
