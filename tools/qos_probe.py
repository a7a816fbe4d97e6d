"""Phase 9 of ``chip_smoke.py`` (the QoS leg: a guaranteed tenant's TTFT
alone and under a best-effort flood) alone in a fresh process, after one
precondition that stands for something the script's earlier phases leave
in the process.

Cases (each in its own child process, the kernels built first):

- ``none``: nothing before the leg (``chip_smoke.py --leg qos-bf16``);
- ``heap``: 160,000 more objects the collector tracks, alive for the
  process (the whole script holds ~330k at phase 9's start, the leg
  alone ~170k);
- ``heap-frozen``: the same, then ``gc.freeze()``;
- ``cupti``: one ``torch.profiler`` trace over the host and the card
  before the leg, as phases 4-8 run one in every leg;
- ``cpu-pool``: a CPU matmul first, which starts PyTorch's intra-op
  thread pool, as phase 3's CPU reference engines do;
- ``goldens``: phase 3's fp32 and int8-KV (warm, against a CPU engine)
  golden replays first;
- ``goldens-released``: the same, then cuBLAS's workspaces handed back
  as ``chip_smoke.py`` does at every phase start;
- ``phase4``: phase 4's whole bf16 leg first (served, profiled, held
  against the eager loop);
- ``all``: ``heap``, ``cupti`` and ``cpu-pool`` together.

Each prints one JSON line: acme's TTFT p50 alone and loaded (ms), the
gate's limit, the garbage collections during the two (count, total and
longest ms by generation), the host microseconds of an eager launch at
the leg's start, and whether the gate held.

    python3 tools/qos_probe.py                 # every case
    python3 tools/qos_probe.py none cupti none # some, in this order

With ``QOS_PROBE_LOGS=DIR`` each child's log goes to ``DIR/<i>-<case>.err``.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("none", "heap", "heap-frozen", "cupti", "cpu-pool", "goldens",
         "goldens-released", "phase4", "all")
_KEEP: list = []


def _rss_gib() -> float:
    with open("/proc/self/status") as f:
        kb = next(int(ln.split()[1]) for ln in f if ln.startswith("VmRSS:"))
    return kb / 2**20


def run_case(name: str) -> dict:
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke
    from kaito_tpu_torch.ops import build

    build.build_all()
    if name in ("cpu-pool", "all"):
        a = torch.randn(2048, 2048)
        (a @ a).sum().item()
    if name in ("goldens", "goldens-released"):
        with torch.no_grad():
            chip_smoke.check_goldens("fp32")
            chip_smoke.check_goldens("kv_int8", warm=True)
        chip_smoke._release_card(torch)
        if name == "goldens-released":
            torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.empty_cache()
    if name == "phase4":
        _, label, model, flags, counted, burst, tp, layers, absent = chip_smoke.LEGS[0]
        with torch.no_grad():
            chip_smoke.run_server_phase(flags, counted, label, burst=burst, model=model,
                                        layers=layers, absent=absent)
        chip_smoke._release_card(torch)
    if name in ("heap", "heap-frozen", "all"):
        _KEEP.extend({"i": i, "v": [i]} for i in range(80_000))
        gc.collect()
        if name == "heap-frozen":
            gc.freeze()
    if name in ("cupti", "all"):
        from torch.profiler import ProfilerActivity, profile

        x = torch.zeros(1024, device="cuda")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            for _ in range(300):
                x.add_(1)
            torch.cuda.synchronize()
    out = {"case": name, "card": chip_smoke.card_line(),
           "gc_objects": len(gc.get_objects()),
           "os_threads": len(os.listdir("/proc/self/task")),
           "allocated_gib": torch.cuda.memory_allocated() / 2**30,
           "rss_gib": _rss_gib(),
           "launch_us": chip_smoke._launch_us(torch)}
    t0 = time.perf_counter()
    gc.collect()
    out["gc_full_ms"] = (time.perf_counter() - t0) * 1e3
    try:
        with torch.no_grad():
            _, stats = chip_smoke.run_qos_phase(chip_smoke.QOS_LEG[1])
        o = stats["overload"]
        out.update(alone_ms=o["acme_ttft_p50_alone_ms"], loaded_ms=o["acme_ttft_p50_loaded_ms"],
                   spans=o["ttft_parts"], gc=o["gc"], gate="held")
    except chip_smoke.SmokeFailure as e:
        out.update(gate="failed", error=str(e)[:300])
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["case"]:
        print(json.dumps(run_case(argv[1])), flush=True)
        return 0
    logs = os.environ.get("QOS_PROBE_LOGS", "")
    if logs:
        os.makedirs(logs, exist_ok=True)
    for i, name in enumerate(argv or CASES):
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "case", name],
                           capture_output=True, text=True, timeout=900)
        if logs:
            with open(os.path.join(logs, f"{i}-{name}.err"), "w") as f:
                f.write(p.stderr)
        line = next((ln for ln in reversed(p.stdout.splitlines())
                     if ln.startswith("{")), None)
        res = json.loads(line) if line else {"case": name, "rc": p.returncode,
                                             "stderr": p.stderr[-3000:]}
        # the collections of a leg that failed its gate: the leg's log line
        res.setdefault("gc_log", next((ln.split("garbage collections ", 1)[1]
                                       for ln in reversed(p.stderr.splitlines())
                                       if "garbage collections " in ln), None))
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
