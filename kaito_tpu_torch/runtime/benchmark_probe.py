"""Self-benchmark startup probe.

Parity with the reference's in-cluster benchmark
(``presets/workspace/inference/vllm/benchmark_entrypoint.py``): runs as
the leader pod's startup probe, waits for /health, derives a safe
concurrency from the engine's KV-capacity gauges, drives a fixed load
(60 s, 2048-token prompts / 256-token outputs), snapshots the token
counters, and emits ``KAITO_BENCHMARK_CONFIG`` / ``KAITO_BENCHMARK_RESULT``
JSON lines (through /proc/1/fd/1 in-pod so the controller can tail
them), exiting 0/1.

The port's own copy of ``kaito_tpu/runtime/benchmark_probe.py``: the
same ``KAITO_BENCHMARK_CONFIG`` / ``KAITO_BENCHMARK_RESULT`` lines and
keys, read from the port server's own families.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.request

BENCHMARK_DURATION_S = 60
BENCHMARK_INPUT_LEN = 2048
BENCHMARK_OUTPUT_LEN = 256


def _emit(tag: str, payload: dict, sink: str) -> None:
    line = f"{tag}{json.dumps(payload)}\n"
    try:
        with open(sink, "w") as f:
            f.write(line)
    except OSError:
        sys.stdout.write(line)
        sys.stdout.flush()


def _get(url: str, timeout: float = 10.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def _metric(metrics_text: str, name: str) -> float:
    """Sum every series of a family: a labelled family (e.g. a counter
    split by reason, or a DP facade exporting per-group series) exposes
    several lines, and reading only the first one under-counts."""
    total = 0.0
    seen = False
    for line in metrics_text.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{"):
            try:
                total += float(line.rsplit(" ", 1)[1])
                seen = True
            except ValueError:
                pass
    return total if seen else 0.0


def wait_healthy(base: str, deadline_s: float) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        try:
            if json.loads(_get(base + "/health"))["status"] == "ok":
                return True
        except Exception:
            pass
        time.sleep(5)
    return False


def derive_concurrency(base: str, input_len: int, output_len: int) -> int:
    """Concurrency from live KV capacity (the reference reads vLLM's
    cache-config gauges; we read kaito:kv_pages_total and the
    kaito:kv_page_size gauge the engine exports)."""
    m = _get(base + "/metrics")
    pages = _metric(m, "kaito:kv_pages_total")
    page_size = _metric(m, "kaito:kv_page_size") or 64
    capacity_tokens = pages * page_size
    per_seq = input_len + output_len
    return max(1, min(int(capacity_tokens // max(per_seq, 1)) or 1, 64))


def run_benchmark(base: str, *, duration_s: float = BENCHMARK_DURATION_S,
                  input_len: int = BENCHMARK_INPUT_LEN,
                  output_len: int = BENCHMARK_OUTPUT_LEN,
                  concurrency: int = 0, sink: str = "/proc/1/fd/1") -> dict:
    if concurrency <= 0:
        concurrency = derive_concurrency(base, input_len, output_len)
    cfg = {"engine": "kaito-tpu", "engine_version": "0.1.0",
           "input_len": input_len, "output_len": output_len,
           "duration_s": duration_s, "max_concurrency": concurrency}
    _emit("KAITO_BENCHMARK_CONFIG", cfg, sink)

    before = _get(base + "/metrics")
    gen0 = _metric(before, "kaito:generation_tokens_total")
    prompt_text = "benchmark " * max(input_len // 10, 1)

    stop = time.monotonic() + duration_s
    ttfts: list[float] = []     # time to FIRST streamed chunk, per request
    errors = [0]
    lock = threading.Lock()

    def worker():
        while time.monotonic() < stop:
            t0 = time.monotonic()
            body = json.dumps({
                "prompt": prompt_text, "max_tokens": output_len,
                "temperature": 1.0, "stream": True}).encode()
            try:
                req = urllib.request.Request(
                    base + "/v1/completions", data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req,
                                            timeout=duration_s + 120) as r:
                    first = None
                    for line in r:
                        if first is None and line.startswith(b"data:"):
                            first = time.monotonic() - t0
                    if first is not None:
                        with lock:
                            ttfts.append(first)
            except Exception:
                errors[0] += 1

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(concurrency)]
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration_s + 180)
    elapsed = time.monotonic() - t_start

    after = _get(base + "/metrics")
    gen1 = _metric(after, "kaito:generation_tokens_total")
    total_tokens = gen1 - gen0
    tpm = total_tokens / max(elapsed, 1e-6) * 60.0
    # client-observed TTFT from the streamed first chunk (not whole-
    # request latency); avg from the engine histogram for comparison
    ttfts.sort()
    ttft_p50 = ttfts[len(ttfts) // 2] if ttfts else 0.0
    ttft_avg = _metric(after, "kaito:time_to_first_token_seconds_sum") / \
        max(_metric(after, "kaito:time_to_first_token_seconds_count"), 1)
    result = {
        "vllm_total_tpm": round(tpm, 1),          # key kept for dashboard parity
        "total_tpm": round(tpm, 1),
        "generation_tokens": int(total_tokens),
        "ttft_p50_ms": round(ttft_p50 * 1000, 1),
        "ttft_avg_ms": round(ttft_avg * 1000, 1),
        "ttft_samples": len(ttfts),
        "elapsed_s": round(elapsed, 1),
        "errors": errors[0],
        "max_concurrency": concurrency,
    }
    try:
        health = json.loads(_get(base + "/health"))
        if isinstance(health, dict) and health.get("hbm_sizing"):
            # engine's self-measured HBM sizing + estimator drift rides
            # into status.performance alongside the throughput numbers
            result["hbm_sizing"] = health["hbm_sizing"]
    except Exception:
        pass
    try:
        slo = json.loads(_get(base + "/debug/slo"))
        if isinstance(slo, dict) and "alerts" in slo:
            # SLO verdict rides along so the workspace controller can
            # fold it into the SLOHealthy condition (runtime/slo.py)
            result["slo"] = {k: slo.get(k) for k in
                             ("healthy", "alerts", "burn_rates", "targets")}
            result["slo"]["sli"] = (slo.get("sli") or {}).get("fast")
    except Exception:
        pass
    _emit("KAITO_BENCHMARK_RESULT", result, sink)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base-url", default="http://127.0.0.1:5000")
    ap.add_argument("--duration", type=float, default=BENCHMARK_DURATION_S)
    ap.add_argument("--input-len", type=int, default=BENCHMARK_INPUT_LEN)
    ap.add_argument("--output-len", type=int, default=BENCHMARK_OUTPUT_LEN)
    ap.add_argument("--concurrency", type=int, default=0)
    ap.add_argument("--sink", default="/proc/1/fd/1")
    ap.add_argument("--health-deadline", type=float, default=1800)
    args = ap.parse_args(argv)
    if not wait_healthy(args.base_url, args.health_deadline):
        print("engine never became healthy", file=sys.stderr)
        return 1
    result = run_benchmark(
        args.base_url, duration_s=args.duration, input_len=args.input_len,
        output_len=args.output_len, concurrency=args.concurrency,
        sink=args.sink)
    return 0 if result["generation_tokens"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
