"""Data-parallel HTTP front: round-robin across N engine backends.

This is now a THIN compatibility front over the shared routing data
path in ``kaito_tpu_torch/runtime/routing.py`` (docs/routing.md): the circuit
breaker, ``/health`` prober, jittered idempotent retry, SSE byte relay,
chunked-body handling, X-Request-Id propagation, and SIGTERM drain all
live there, shared verbatim with the first-party endpoint picker
(``kaito_tpu_torch/runtime/epp.py``) that the InferencePool's ``extensionRef``
resolves to.  What remains here is only the classic policy — blind
round robin — plus the historical module surface that tests, dryruns
and single-node deployments import.

The in-miniature data plane of the repo's replica tier: in production,
InferenceSet replicas sit behind the rendered Service/InferencePool and
the EPP picks endpoints (``controllers/inferenceset.py``); the
reference's analogue is vLLM ``--data-parallel-size`` over Ray plus its
routing sidecar (``preset_inferences.go:909-985``).  This router is the
same contract as ONE process you can boot in tests, dryruns, and
single-node deployments: each backend is a fully independent engine
server (its own process, its own devices), and requests — including
SSE streams — relay byte-for-byte.

Failure-domain design (docs/failure-domains.md):

- Each backend carries a **circuit breaker**: consecutive connect
  failures open it with exponentially-backed-off cooldowns (capped);
  when the cooldown lapses the breaker is **half-open** — the next
  request probes it, and one success closes it again (``mark_up``).
- **Health probes**: an optional background thread GETs ``/health`` per
  backend, closing breakers as replicas recover without spending a
  client request on the probe.
- **Retry with jittered backoff**: idempotent requests (GET/DELETE and
  the stateless POST inference routes) retry against alternate replicas
  — across backends immediately, and across full cycles after a
  jittered sleep — as long as no response byte has reached the client.
- **Graceful drain**: SIGTERM stops accepting (503 + Retry-After),
  lets in-flight relays finish, then exits — the InferenceSet
  rolling-update contract.

The port's own copy of ``kaito_tpu/runtime/dp_router.py`` over the
port's ``runtime/routing.py``.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading

# Re-exported so existing imports (tests, helpers, bench harnesses)
# keep working against the historical dp_router module surface.
from kaito_tpu_torch.runtime.routing import (BREAKER_THRESHOLD,  # noqa: F401
                                             DOWN_COOLDOWN_MAX_S, DOWN_COOLDOWN_S,
                                             HOP_HEADERS, IDEMPOTENT_POST_PREFIXES,
                                             RETRY_BACKOFF_S, RETRY_CYCLES, Backend,
                                             HealthProber, RoutingCore, _retryable,
                                             make_routing_server)

logger = logging.getLogger(__name__)

# historical name: the backend class predates the shared routing lib
_Backend = Backend


class DPRouter(RoutingCore):
    """Round-robin chooser over backends, shared by handler threads.

    Pure policy: ``RoutingCore`` owns the breaker/drain/metrics state
    and its default ``candidates`` IS round robin, so this subclass
    only pins down the historical constructor (a list of URL strings).
    """

    def __init__(self, backends: list[str]):
        super().__init__(backends)


def make_router_server(router, host: str = "0.0.0.0", port: int = 0,
                       probe_interval_s: float = 0.0):
    """Historical entry point; the relay itself is the shared one."""
    return make_routing_server(router, host, port,
                               probe_interval_s=probe_interval_s)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kaito-tpu-dp-router")
    ap.add_argument("--backend", action="append", required=True,
                    help="backend base URL (repeat per replica)")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--health-probe-interval-s", type=float, default=2.0,
                    help="per-backend /health probe cadence (0 = off)")
    ap.add_argument("--drain-timeout-s", type=float, default=30.0,
                    help="SIGTERM grace: max seconds to finish in-flight "
                         "requests before exit")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    router = DPRouter(args.backend)
    srv = make_router_server(router, args.host, args.port,
                             probe_interval_s=args.health_probe_interval_s)

    def _term(signum, frame):
        # graceful drain: stop accepting, finish in-flight, exit — the
        # rolling-update contract (new requests get 503 + Retry-After,
        # the Gateway retries them on another replica)
        logger.info("SIGTERM: draining %d in-flight request(s)",
                    router.inflight)
        threading.Thread(target=lambda: (router.drain(args.drain_timeout_s),
                                         srv.shutdown()),
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    logger.info("dp router on :%d -> %s", srv.server_address[1],
                args.backend)
    srv.serve_forever()
    logger.info("dp router exited cleanly")


if __name__ == "__main__":
    main()
