"""Distributed health checks for multi-host slices.

Parity with the reference's ``multi-node-health-check.py`` (liveness =
Ray GCS state on the leader, readiness = leader vLLM /health): on TPU
the leader (pod ordinal 0) serves HTTP, workers are healthy iff the JAX
coordinator is reachable — the process would have crashed out of the
collective otherwise, so worker health is "coordinator TCP open AND my
engine process alive".

The port's own copy of ``kaito_tpu/runtime/health.py``.  The worker
check reads the coordinator's TCP port whatever the engine behind it;
``TPU_WORKER_ID`` is read as the JAX module reads it, so a pod of either
package reports the same ordinal.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import urllib.request


def pod_ordinal() -> int:
    """StatefulSet ordinal from the pod hostname suffix (or TPU_WORKER_ID)."""
    if "TPU_WORKER_ID" in os.environ:
        return int(os.environ["TPU_WORKER_ID"])
    host = os.environ.get("HOSTNAME", socket.gethostname())
    tail = host.rsplit("-", 1)[-1]
    return int(tail) if tail.isdigit() else 0


def leader_http_healthy(base: str, timeout: float = 5.0) -> bool:
    try:
        with urllib.request.urlopen(base + "/health", timeout=timeout) as r:
            return json.loads(r.read()).get("status") == "ok"
    except Exception:
        return False


def coordinator_reachable(addr: str, timeout: float = 5.0) -> bool:
    host, _, port = addr.rpartition(":")
    try:
        with socket.create_connection((host, int(port or 8476)), timeout=timeout):
            return True
    except OSError:
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", default="auto", choices=["auto", "leader", "worker"])
    ap.add_argument("--base-url", default="http://127.0.0.1:5000")
    ap.add_argument("--coordinator",
                    default=os.environ.get("KAITO_COORDINATOR", ""))
    args = ap.parse_args(argv)

    role = args.role
    if role == "auto":
        role = "leader" if pod_ordinal() == 0 else "worker"
    if role == "leader":
        ok = leader_http_healthy(args.base_url)
    else:
        ok = coordinator_reachable(args.coordinator) if args.coordinator else True
    print(json.dumps({"role": role, "healthy": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
