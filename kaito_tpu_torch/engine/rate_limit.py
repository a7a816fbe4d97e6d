"""Queue-depth and per-tenant rate limiting.

The port's own copy of ``kaito_tpu/engine/rate_limit.py``.  Same
contract as the reference's vLLM wrapper rate limiter
(``presets/workspace/inference/vllm/rate_limit.py`` +
``--kaito-disable-rate-limit``): when the number of queued-but-not-
running requests exceeds the cap, new work is rejected with HTTP 429 so
the Gateway/EPP retries another replica instead of piling onto this one.

With a QoS config (``engine/qos.py``) the limiter additionally enforces
per-tenant budgets so 429s land on the tenant over budget instead of on
everyone:

- ``max_queue_len`` per class — a tenant's waiting-queue share.
- ``tokens_per_s`` per class — a burst-capable token bucket, POST-PAID:
  the shed check runs before tokenization, so actual prompt + generated
  tokens are debited at completion and a tenant sheds once its balance
  goes negative.  The bucket refills at the sustained rate with
  ``BURST_SECONDS`` of headroom.
"""

from __future__ import annotations

import time
import zlib
from typing import Optional

from kaito_tpu_torch.engine.metrics import Counter
from kaito_tpu_torch.engine.qos import BURST_SECONDS, QoSConfig


class RateLimiter:
    def __init__(self, max_queue_len: int, disabled: bool = False,
                 kv_shed_threshold: float = 0.0,
                 qos: Optional[QoSConfig] = None,
                 time_fn=time.monotonic):
        self.max_queue_len = max_queue_len
        self.disabled = disabled
        self.kv_shed_threshold = kv_shed_threshold
        self.qos = qos
        self._time = time_fn
        # per-tenant token buckets: tenant -> (balance, last_refill)
        self._buckets: dict[str, tuple[float, float]] = {}
        # a broken pressure probe silently disables KV shedding — count
        # it so operators see the probe failing instead of inferring it
        # from an absence of kv_pressure sheds.  Registry-less; the
        # server adopts it into the shared registry.
        self.probe_errors = Counter(
            "kaito:rate_limit_probe_errors_total",
            "Allocator pressure-probe failures in shed_reason "
            "(shedding decision fell back to queue depth only)", None)

    def admit(self, num_waiting: int) -> bool:
        if self.disabled:
            return True
        return num_waiting < self.max_queue_len

    def _bucket_balance(self, tenant: str, rate: float) -> float:
        """Current token balance for ``tenant``, refilled to now."""
        now = self._time()
        balance, last = self._buckets.get(
            tenant, (rate * BURST_SECONDS, now))
        balance = min(rate * BURST_SECONDS, balance + rate * (now - last))
        self._buckets[tenant] = (balance, now)
        return balance

    def note_tokens(self, tenant: str, n: int) -> None:
        """Debit ``n`` actual tokens (prompt + generated) against the
        tenant's bucket at completion time — post-paid, since prompt
        length is unknown when the shed check runs."""
        if self.disabled or self.qos is None or not tenant:
            return
        rate = self.qos.class_of(tenant).tokens_per_s
        if rate <= 0:
            return
        balance = self._bucket_balance(tenant, rate)
        self._buckets[tenant] = (balance - n, self._time())

    def shed_reason(self, engine, tenant: str = "") -> Optional[dict]:
        """Why a NEW request should be shed right now, or None to admit.

        Returns ``{"reason": ..., "tenant": ...}`` so the HTTP layer
        can attribute the 429 and the per-tenant shed counter to the
        tenant that is actually over budget.  Pressure signals, in
        order: per-tenant queue budget, per-tenant token rate, global
        queue depth, and — when ``kv_shed_threshold`` is set — KV-page
        exhaustion while a queue exists (admitting more work would only
        grow the preempt churn, not the throughput)."""
        if self.disabled:
            return None
        if self.qos is not None and tenant:
            cls = self.qos.class_of(tenant)
            if cls.max_queue_len > 0:
                waiting_fn = getattr(engine, "num_waiting_for", None)
                depth = (waiting_fn(tenant) if waiting_fn is not None
                         else engine.num_waiting)
                if depth >= cls.max_queue_len:
                    return {"reason": "tenant_queue_full", "tenant": tenant}
            if cls.tokens_per_s > 0 \
                    and self._bucket_balance(tenant, cls.tokens_per_s) < 0:
                return {"reason": "tenant_rate", "tenant": tenant}
        if engine.num_waiting >= self.max_queue_len:
            return {"reason": "queue_full", "tenant": tenant}
        if self.kv_shed_threshold > 0 and engine.num_waiting > 0:
            try:
                alloc = engine.allocator
                used = 1.0 - alloc.available / max(1, alloc.num_pages - 1)
            except (AttributeError, ZeroDivisionError):
                # engines without a page pool (aggregates, stubs) have
                # no KV pressure signal; anything else counts as a
                # broken probe and must stay visible
                self.probe_errors.inc()
                return None
            if used >= self.kv_shed_threshold:
                return {"reason": "kv_pressure", "tenant": tenant}
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
