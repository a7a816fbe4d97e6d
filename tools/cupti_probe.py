"""What one ``torch.profiler`` trace over the card leaves behind: the
host's cost of a kernel launch before and after it, in one process.

Each case runs in a fresh child process on the card and prints one JSON
line: the host microseconds a small eager kernel launch costs
(``x.add_(1)`` on a 1024-element tensor, 4000 launches, the median of
five rounds), before anything, after a CUDA graph capture and replay,
and after a profiler trace over the host and the card (a few hundred
launches) has stopped; and the process's OS threads at each point.

Cases: ``plain`` (no profiler), ``profiled`` (torch's defaults),
``profiled-teardown`` (the same with ``TEARDOWN_CUPTI=1`` in the child's
environment, asking the profiler to detach CUPTI when it stops) and
``cpu-only`` (a profiler trace over the host only).

    python3 tools/cupti_probe.py            # every case, one child each
    python3 tools/cupti_probe.py case NAME  # one case in this process
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

CASES = ("plain", "profiled", "profiled-teardown", "cpu-only")
ROUNDS, LAUNCHES = 5, 4000


def _threads() -> int:
    return len(os.listdir("/proc/self/task"))


def launch_us(torch, x) -> float:
    """Median host microseconds a launch of ``x.add_(1)`` costs."""
    times = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LAUNCHES):
            x.add_(1)
        times.append((time.perf_counter() - t0) / LAUNCHES * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def run_case(name: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1024, device="cuda")
    launch_us(torch, x)                       # first calls, allocator warm
    out = {"case": name, "card": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "TEARDOWN_CUPTI": os.environ.get("TEARDOWN_CUPTI"),
           "before_us": launch_us(torch, x), "threads_before": _threads()}
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            x.add_(1)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(8):
            x.add_(1)
    g.replay()
    out["after_graph_us"] = launch_us(torch, x)
    if name != "plain":
        acts = [ProfilerActivity.CPU] + ([] if name == "cpu-only"
                                         else [ProfilerActivity.CUDA])
        with profile(activities=acts) as prof:
            for _ in range(300):
                x.add_(1)
            g.replay()
            torch.cuda.synchronize()
        out["profiled_events"] = len(prof.events())
        # a second trace, as a process that profiles each leg takes one
        with profile(activities=acts):
            for _ in range(300):
                x.add_(1)
            torch.cuda.synchronize()
    out["after_profile_us"] = launch_us(torch, x)
    out["threads_after"] = _threads()
    time.sleep(2.0)
    out["after_2s_us"] = launch_us(torch, x)
    g.replay()
    torch.cuda.synchronize()
    out["graph_replays_ok"] = True
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["case"]:
        print(json.dumps(run_case(argv[1])), flush=True)
        return 0
    rc = 0
    for name in CASES:
        env = dict(os.environ)
        env.pop("TEARDOWN_CUPTI", None)
        if name == "profiled-teardown":
            env["TEARDOWN_CUPTI"] = "1"
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "case", name],
                           env=env, capture_output=True, text=True, timeout=300)
        line = next((ln for ln in reversed(p.stdout.splitlines())
                     if ln.startswith("{")), None)
        print(line or json.dumps({"case": name, "rc": p.returncode,
                                  "stderr": p.stderr[-2000:]}), flush=True)
        rc |= p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
