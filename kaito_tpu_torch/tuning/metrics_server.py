"""Tuning metrics sidecar: ``python -m kaito_tpu_torch.tuning.metrics_server
--results-dir DIR [--port 5000]``.

Counterpart of ``kaito_tpu.tuning.metrics_server``: serves the
trainer's ``training_metrics.json`` as Prometheus text (``/metrics``,
the ``kaito:tuning_*`` gauges, byte for byte the JAX sidecar's for the
same payload) and JSON (``/progress``), and ``/health``.
"""

from __future__ import annotations

import argparse
import json
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kaito_tpu_torch.tuning.trainer import METRICS_FILE, SENTINEL


def render_metrics(m: dict, done: bool) -> str:
    """The sidecar's Prometheus payload (in the engine's ``kaito:``
    namespace, so one scrape config covers both)."""
    lines = [
        "# HELP kaito:tuning_step Last trainer optimizer step",
        "# TYPE kaito:tuning_step gauge",
        f"kaito:tuning_step {m.get('step', 0)}",
        "# HELP kaito:tuning_loss Last reported training loss",
        "# TYPE kaito:tuning_loss gauge",
        f"kaito:tuning_loss {m.get('loss', 0.0)}",
        "# HELP kaito:tuning_tokens_per_second Trainer throughput",
        "# TYPE kaito:tuning_tokens_per_second gauge",
        f"kaito:tuning_tokens_per_second {m.get('tokens_per_second', 0.0)}",
        "# HELP kaito:tuning_completed 1 once the job sentinel file exists",
        "# TYPE kaito:tuning_completed gauge",
        f"kaito:tuning_completed {1 if done else 0}",
    ]
    return "\n".join(lines) + "\n"


class Handler(BaseHTTPRequestHandler):
    results_dir = ""

    def log_message(self, *a):
        pass

    def _read(self) -> dict:
        try:
            with open(os.path.join(self.results_dir, METRICS_FILE)) as f:
                return json.load(f)
        except Exception:
            return {}

    def do_GET(self):
        if self.path == "/health":
            body = b'{"status": "ok"}'
            ctype = "application/json"
        elif self.path == "/metrics":
            done = os.path.exists(os.path.join(self.results_dir, SENTINEL))
            body = render_metrics(self._read(), done).encode()
            ctype = "text/plain; version=0.0.4"
        elif self.path == "/progress":
            body = json.dumps(self._read()).encode()
            ctype = "application/json"
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def make_server(results_dir: str, port: int = 5000,
                host: str = "0.0.0.0") -> ThreadingHTTPServer:
    handler = type("H", (Handler,), {"results_dir": results_dir})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--results-dir", required=True)
    args = ap.parse_args(argv)
    make_server(args.results_dir, args.port).serve_forever()


if __name__ == "__main__":
    main()
