"""Queue-depth rate limiting, as the default server builds it.

The port's own copy of the ``qos=None`` branch of
``kaito_tpu/engine/rate_limit.py`` (the reference's vLLM wrapper
contract, ``--kaito-disable-rate-limit``): when the number of
queued-but-not-running requests reaches the cap, new work is rejected
with HTTP 429 so the Gateway/EPP retries another replica instead of
piling onto this one.  Per-tenant budgets and KV-pressure shedding come
with QoS (ROADMAP queue 1, item 29).
"""

from __future__ import annotations

import zlib
from typing import Optional

from kaito_tpu_torch.engine.metrics import Counter


class RateLimiter:
    def __init__(self, max_queue_len: int, disabled: bool = False):
        self.max_queue_len = max_queue_len
        self.disabled = disabled
        # a broken pressure probe silently disables KV shedding — the
        # family is exposed as the JAX server exposes it (it stays 0
        # without KV shedding).  Registry-less; the server adopts it
        # into the shared registry.
        self.probe_errors = Counter(
            "kaito:rate_limit_probe_errors_total",
            "Allocator pressure-probe failures in shed_reason "
            "(shedding decision fell back to queue depth only)", None)

    def shed_reason(self, engine) -> Optional[str]:
        """Why a NEW request should be shed right now ("queue_full"),
        or None to admit."""
        if not self.disabled and engine.num_waiting >= self.max_queue_len:
            return "queue_full"
        return None

    def retry_after_s(self, engine, key: str = "") -> int:
        """Advisory Retry-After: scales with the backlog so a deep
        queue pushes clients further out, plus a deterministic
        per-request spread (hash of ``key``, typically the request id)
        so clients shed in the same window don't synchronize their
        retries onto the same instant.  No ``key`` = no jitter."""
        base = min(30, 1 + engine.num_waiting // 8)
        if not key:
            return base
        spread = max(1, base // 2)
        return min(30, base + zlib.crc32(key.encode()) % (spread + 1))
