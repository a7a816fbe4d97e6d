"""Probe of torch.profiler on one card: which thread's ranges a trace
records, and how the kernels of a replayed CUDA graph tie to their launch.

Run from the root of a checkout, on a card:

    python3 tools/devprof_probe.py

A worker thread loops one "step": a captured CUDA graph replayed inside
``record_function("kaito/decode")``, then an eager matmul inside
``record_function("kaito/prefill")`` / ``record_function("attention")``,
a softmax and a device-to-host copy.  Two designs take a trace of it,
each in a fresh process (the first trace of a process initializes the
profiler; ``--warm`` takes and drops one trace on the main thread first):

- ``sampler``: another thread starts the profiler while the worker runs,
  sleeps 0.2 s, stops it;
- ``worker``: the worker thread itself starts and stops it at a step
  boundary.

``python3 tools/devprof_probe.py cost`` reads what a window costs: a
CUDA graph of N small kernels (N = 500, 2700: a Llama-3.1-8B decode step
is ~2700) replayed R times inside a trace taken on this thread, while a
second Python thread counts loop turns (it needs the interpreter lock):
the seconds ``stop()`` and ``export_chrome_trace`` take, the counting
thread's rate during each against its rate alone, the kernel events and
the trace's size.

``python3 tools/devprof_probe.py split`` splits a window's stop into its
parts on the same graphs, with the trace taken through the low-level
profiler API (``torch.autograd.profiler.profile`` entered by hand):
``torch.autograd._disable_profiler()`` (Kineto gathers its results in
C++), the Python parse of every event into ``FunctionEvent``s (what
``torch.profiler.profile.stop()`` runs after it) and the trace write
(``_ProfilerResult.save``, what ``export_chrome_trace`` calls), each with
its seconds and the counting thread's turns a second; then the write
again on a second thread while this one counts.

``python3 tools/devprof_probe.py engine [MODEL]`` times the device
profiler's windows in a serving engine (default ``llama-3.1-8b-instruct``
at full width in bf16, synthetic weights; ``tiny-llama-real`` from its
checkpoint): eight sequences decode in captured windows while the
sampler takes three windows; it prints each scheduler step's seconds
outside and inside a window, and the seconds of each window's start and
stop on the engine thread, and each window's summary.

For each design it prints one JSON line: the events by category, the
``user_annotation`` names and the threads they came from, how many
kernels (and memcpys) carry a ``correlation`` that a ``cuda_runtime``
event of the trace also carries and under which runtime call, whether
a graph replay's kernels share the ``cudaGraphLaunch``'s correlation,
the process and thread names, one event of each device category, and
the seconds ``stop()`` and ``export_chrome_trace`` took.  Nothing fails
but an exception.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _graph(x, w):
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(2):
            torch.relu(x @ w)
    torch.cuda.current_stream().wait_stream(s)
    with torch.cuda.graph(g):
        y = torch.relu(x @ w)
        y.add_(1.0)
    return g


def _step(g, x, w):
    with record_function("kaito/decode"):
        g.replay()
    with record_function("kaito/prefill"):
        with record_function("attention"):
            y = x @ w
        torch.softmax(y, -1)
        y[:4, :4].cpu()


def _summary(path: str, stop_s: float, export_s: float) -> dict:
    with open(path) as f:
        doc = json.load(f)
    evs = doc.get("traceEvents", [])
    cats = collections.Counter(e.get("cat") for e in evs)
    runtime = {}
    for e in evs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                runtime[c] = e
    tied = collections.Counter()
    untied = collections.Counter()
    graph_corr = collections.Counter()
    for e in evs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        c = (e.get("args") or {}).get("correlation")
        r = runtime.get(c)
        if r is None:
            untied[e.get("cat")] += 1
        else:
            tied[f"{e.get('cat')} <- {r.get('name')}"] += 1
            if r.get("name") == "cudaGraphLaunch":
                graph_corr[c] += 1
    names = {}
    for e in evs:
        if e.get("ph") == "M" and (e.get("name") == "thread_name" or (
                e.get("name") == "process_labels" and e.get("pid") in (0, os.getpid()))):
            names[f"{e['name']} {e.get('pid')}/{e.get('tid')}"] = (e.get("args") or {})
    annotations = collections.Counter(
        f"{e.get('name')} @ {e.get('tid')}" for e in evs
        if e.get("cat") == "user_annotation")
    samples = {}
    for e in evs:
        cat = e.get("cat")
        if cat in DEVICE_CATS + ("cuda_runtime", "gpu_user_annotation") \
                and cat not in samples:
            samples[cat] = e
    return dict(categories=dict(cats), annotations=dict(annotations),
                device_events_tied=dict(tied), device_events_untied=dict(untied),
                kernels_per_graph_launch=sorted(set(graph_corr.values())),
                names=names, samples=samples, stop_s=stop_s, export_s=export_s,
                n_events=len(evs))


def run(design: str, out_dir: str) -> dict:
    x = torch.randn(512, 512, device="cuda")
    w = torch.randn(512, 512, device="cuda")
    g = _graph(x, w)
    torch.cuda.synchronize()
    done = threading.Event()
    result = {}

    def take():
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        return prof

    def finish(prof):
        t0 = time.perf_counter()
        prof.stop()
        stop_s = time.perf_counter() - t0
        path = os.path.join(out_dir, f"{design}.trace.json")
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        result["summary"] = _summary(path, stop_s, time.perf_counter() - t0)

    stop = threading.Event()
    started = threading.Event()

    def worker():
        prof = None
        i = 0
        while not stop.is_set():
            if design == "worker" and i == 10:
                prof = take()
            if design == "worker" and i == 30:
                finish(prof)
                stop.set()
            _step(g, x, w)
            started.set()
            time.sleep(0.005)
            i += 1
        torch.cuda.synchronize()
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    if design == "sampler":
        started.wait(60)
        t0 = time.perf_counter()
        prof = take()
        result["start_s"] = time.perf_counter() - t0
        time.sleep(0.2)
        finish(prof)
        stop.set()
    done.wait(60)
    t.join(60)
    return dict(design=design, start_s=result.get("start_s"), **result["summary"])


def cost(n_kernels: int, replays: int) -> dict:
    """What one trace of ``replays`` replays of a graph of ``n_kernels``
    kernels costs to stop and to write, and how much of that time the
    stopping thread holds the interpreter lock."""
    x = torch.zeros(1024, device="cuda")
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        x.add_(1.0)
    torch.cuda.current_stream().wait_stream(s)
    with torch.cuda.graph(g):
        for _ in range(n_kernels):
            x.add_(1.0)
    torch.cuda.synchronize()
    ticks = [0]
    done = threading.Event()

    def tick():
        while not done.is_set():
            ticks[0] += 1

    t = threading.Thread(target=tick, daemon=True)
    t.start()

    def rate(fn):
        n0, t0 = ticks[0], time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        return dt, (ticks[0] - n0) / dt

    _, alone = rate(lambda: time.sleep(0.3))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    for _ in range(replays):
        with record_function("kaito/decode"):
            g.replay()
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    stop_s, stop_rate = rate(prof.stop)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        export_s, export_rate = rate(lambda: prof.export_chrome_trace(path))
        size = os.path.getsize(path)
        with open(path) as f:
            kernels = sum(1 for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel")
    done.set()
    t.join()
    return dict(n_kernels=n_kernels, replays=replays, kernel_events=kernels,
                replay_s=replay_s, stop_s=stop_s, export_s=export_s,
                trace_mib=size / 2**20, ticks_per_s_alone=alone,
                ticks_per_s_during_stop=stop_rate,
                ticks_per_s_during_export=export_rate)


def split(n_kernels: int, replays: int) -> dict:
    """``cost``'s trace stopped through the low-level API, part by part
    (see the module's docstring)."""
    from torch.autograd.profiler import profile as autograd_profile

    x = torch.zeros(1024, device="cuda")
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        x.add_(1.0)
    torch.cuda.current_stream().wait_stream(s)
    with torch.cuda.graph(g):
        for _ in range(n_kernels):
            x.add_(1.0)
    torch.cuda.synchronize()
    ticks = [0]
    done = threading.Event()

    def tick():
        while not done.is_set():
            ticks[0] += 1

    t = threading.Thread(target=tick, daemon=True)
    t.start()

    def rate(fn):
        n0, t0 = ticks[0], time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        return dt, (ticks[0] - n0) / dt

    _, alone = rate(lambda: time.sleep(0.3))
    out = dict(n_kernels=n_kernels, replays=replays, ticks_per_s_alone=alone)
    with tempfile.TemporaryDirectory() as tmp:
        for part in ("main", "thread"):
            prof = autograd_profile(use_device="cuda", use_kineto=True)
            prof.__enter__()
            for _ in range(replays):
                with record_function("kaito/decode"):
                    g.replay()
            torch.cuda.synchronize()
            res = []
            path = os.path.join(tmp, f"{part}.json")
            if part == "main":
                out["disable_s"], out["ticks_per_s_during_disable"] = rate(
                    lambda: res.append(torch.autograd._disable_profiler()))
                out["parse_s"], out["ticks_per_s_during_parse"] = rate(
                    lambda: prof._parse_kineto_results(res[0]))
                out["save_s"], out["ticks_per_s_during_save"] = rate(
                    lambda: res[0].save(path))
                with open(path) as f:
                    out["kernel_events"] = sum(1 for e in json.load(f)["traceEvents"]
                                               if e.get("cat") == "kernel")
                out["trace_mib"] = os.path.getsize(path) / 2**20
            else:
                res.append(torch.autograd._disable_profiler())
                # the write on a second thread while this one counts
                n, t0 = [0], time.perf_counter()
                w = threading.Thread(target=res[0].save, args=(path,))
                w.start()
                while w.is_alive():
                    n[0] += 1
                out["save_on_thread_s"] = time.perf_counter() - t0
                out["main_turns_per_s_during_thread_save"] = n[0] / out["save_on_thread_s"]
            del prof, res
    done.set()
    t.join()
    return out


def engine_probe(model: str, windows: int = 3) -> dict:
    """Step, start and stop seconds of the device profiler's windows in
    an engine decoding eight sequences (see the module's docstring)."""
    import statistics
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from kaito_tpu_torch.engine.config import EngineConfig
    from kaito_tpu_torch.engine.engine import InferenceEngine, SamplingParams

    kw = dict(dtype="bfloat16", kv_dtype="bfloat16")
    if model == "tiny-llama-real":
        kw = dict(dtype="float32", kv_dtype="float32", weights_dir=os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "checkpoints", "tiny-llama-real"))
    cfg = EngineConfig(model=model, max_model_len=2048, max_num_seqs=8, seed=0,
                       devprof_interval_s=3600.0, devprof_window_s=0.25, **kw)
    eng = InferenceEngine(cfg, device="cuda")
    dp = eng.devprof
    steps, marks = [], []
    step, opener, closer = eng.step, dp._open, dp._close

    def timed_step():
        t0 = time.perf_counter()
        did = step()
        steps.append((t0, time.perf_counter() - t0, dp._win is not None, did))
        return did

    def timed(kind, fn):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            marks.append((kind, t0, time.perf_counter() - t0))
            return out
        return run

    eng.step = timed_step
    dp._open, dp._close = timed("open", opener), timed("close", closer)
    t_start = time.perf_counter()
    eng.start()
    start_s = time.perf_counter() - t_start
    reqs = [eng.submit([(7 * i + j) % 250 + 2 for j in range(40)], SamplingParams(
        max_tokens=1500, temperature=0.0, ignore_eos=True)) for i in range(8)]
    while not all(len(r.output_tokens) >= 64 for r in reqs):
        time.sleep(0.01)
    summaries = []
    for _ in range(windows):
        s = dp.sample_window()
        summaries.append(None if s is None else {k: s[k] for k in (
            "capture_s", "n_slices", "wall_us", "busy_us", "bucket_pct", "window_tokens")})
        time.sleep(0.5)
    for r in reqs:
        eng.abort(r)
    eng.stop()
    busy = [d for _, d, w, did in steps if did and not w]
    inside = [round(d, 4) for _, d, w, did in steps if did and w]
    return dict(model=model, engine_start_s=start_s,
                step_s_outside=dict(n=len(busy), median=statistics.median(busy),
                                    max=max(busy)),
                step_s_inside=inside, marks=[(k, round(d, 4)) for k, _, d in marks],
                windows=summaries)


def main() -> None:
    import subprocess
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "engine":
        model = sys.argv[2] if len(sys.argv) > 2 else "llama-3.1-8b-instruct"
        print(json.dumps(engine_probe(model)))
        return
    if len(sys.argv) > 1 and sys.argv[1] == "split":
        p = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        p.start()
        p.stop()
        print(json.dumps(dict(torch=torch.__version__, card=torch.cuda.get_device_name(0))))
        for n, r in ((2700, 10), (2700, 25), (2700, 50)):
            print(json.dumps(cost(n, r)))
            print(json.dumps(split(n, r)))
        return
    if len(sys.argv) > 1 and sys.argv[1] == "cost":
        p = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        p.start()
        p.stop()
        for n, r in ((500, 10), (2700, 10), (2700, 25), (2700, 50)):
            print(json.dumps(cost(n, r)))
        return
    if len(sys.argv) > 1 and sys.argv[1] in ("sampler", "worker"):
        if "--warm" in sys.argv:
            p = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            p.start()
            torch.zeros(1, device="cuda").add_(1)
            p.stop()
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps(run(sys.argv[1], tmp), default=str))
        return
    print(json.dumps(dict(torch=torch.__version__, cuda=torch.version.cuda,
                          card=torch.cuda.get_device_name(0))))
    for args in (["sampler"], ["sampler", "--warm"], ["worker"], ["worker", "--warm"]):
        out = subprocess.run([sys.executable, __file__, *args], capture_output=True,
                             text=True, timeout=300)
        print(" ".join(args), out.stdout.strip().splitlines()[-1] if out.stdout.strip()
              else f"no output: {out.stderr[-400:]}")


if __name__ == "__main__":
    main()
