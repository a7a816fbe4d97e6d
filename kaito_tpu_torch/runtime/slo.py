"""SLO watchdog: continuous north-star burn-rate tracking.

The port's own copy of ``kaito_tpu/runtime/slo.py``.

Turns the raw serving histograms into an operator-consumable health
signal: rolling multi-window SLIs (TTFT p50/p99, generated tokens per
second per chip, availability) evaluated against configurable targets
defaulting to the BASELINE north star (>= 2000 tok/s/chip, p50 TTFT
< 200 ms), with Google-SRE-style multi-window burn-rate alerting —
state per SLI is ``ok`` (budget intact), ``warn`` (the fast 5m window
is burning), or ``page`` (both the 5m and 1h windows are burning, so
the breach is sustained, not a blip).

Exported two ways: ``kaito:slo_*`` gauges on the engine's ``/metrics``
registry, and a ``/debug/slo`` JSON endpoint on the engine server.

Burn-rate math: each SLI is a good/total ratio with an error budget
``1 - target_fraction``; burn = bad_fraction / budget.  Burn > 1 means
the budget is being spent faster than allowed.  The p50 TTFT target is
expressed as "50% of requests must see first token within the target",
so burn_rate > 1 is exactly "the observed p50 exceeds the target".

Everything takes an injectable clock so the unit tier can step time
deterministically.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

# multi-window pair (seconds): the fast window detects, the slow
# window confirms (classic 5m/1h page rule)
WINDOW_FAST_S = 300.0
WINDOW_SLOW_S = 3600.0

STATE_OK = "ok"
STATE_WARN = "warn"
STATE_PAGE = "page"
_STATE_CODE = {STATE_OK: 0, STATE_WARN: 1, STATE_PAGE: 2}

_MAX_SAMPLES = 65536


@dataclass
class SLOTargets:
    """North-star defaults (BASELINE.json); every field has an env
    override so a deployment can tune without a code change."""

    ttft_p50_s: float = 0.200            # p50 TTFT < 200 ms
    ttft_p99_s: float = 1.0              # tail TTFT
    itl_p99_s: float = 0.250             # tail inter-token gap (per token)
    tokens_per_sec_per_chip: float = 2000.0
    availability: float = 0.999          # success / (success+fail+shed)
    # fraction of requests/tokens that must meet each latency bound
    ttft_p50_fraction: float = 0.50
    ttft_p99_fraction: float = 0.99
    itl_p99_fraction: float = 0.99

    @classmethod
    def from_env(cls, base: "Optional[SLOTargets]" = None) -> "SLOTargets":
        t = base or cls()

        def f(env: str, cur: float, scale: float = 1.0) -> float:
            raw = os.environ.get(env, "")
            try:
                return float(raw) * scale if raw else cur
            except ValueError:
                return cur

        return cls(
            ttft_p50_s=f("KAITO_SLO_TTFT_P50_MS", t.ttft_p50_s, 1e-3),
            ttft_p99_s=f("KAITO_SLO_TTFT_P99_MS", t.ttft_p99_s, 1e-3),
            itl_p99_s=f("KAITO_SLO_ITL_P99_MS", t.itl_p99_s, 1e-3),
            tokens_per_sec_per_chip=f("KAITO_SLO_TOKENS_PER_SEC_PER_CHIP",
                                      t.tokens_per_sec_per_chip),
            availability=f("KAITO_SLO_AVAILABILITY", t.availability),
            ttft_p50_fraction=t.ttft_p50_fraction,
            ttft_p99_fraction=t.ttft_p99_fraction,
            itl_p99_fraction=t.itl_p99_fraction,
        )

    def to_dict(self) -> dict:
        return {
            "ttft_p50_ms": round(self.ttft_p50_s * 1000, 3),
            "ttft_p99_ms": round(self.ttft_p99_s * 1000, 3),
            "itl_p99_ms": round(self.itl_p99_s * 1000, 3),
            "tokens_per_sec_per_chip": self.tokens_per_sec_per_chip,
            "availability": self.availability,
        }


class WindowSeries:
    """Timestamped samples pruned to the longest window (bounded)."""

    def __init__(self, max_window_s: float, time_fn: Callable[[], float]):
        self.max_window_s = max_window_s
        self.time_fn = time_fn
        self._samples: "collections.deque[tuple[float, float]]" = \
            collections.deque(maxlen=_MAX_SAMPLES)
        self._lock = threading.Lock()

    def add(self, value: float) -> None:
        now = self.time_fn()
        with self._lock:
            self._samples.append((now, float(value)))
            self._prune(now)

    def _prune(self, now: float) -> None:
        cutoff = now - self.max_window_s
        while self._samples and self._samples[0][0] < cutoff:
            self._samples.popleft()

    def values(self, window_s: float) -> list[float]:
        now = self.time_fn()
        with self._lock:
            self._prune(now)
            cutoff = now - window_s
            return [v for t, v in self._samples if t >= cutoff]

    def total(self, window_s: float) -> float:
        return sum(self.values(window_s))


def _percentile(values: list[float], q: float) -> float:
    if not values:
        return 0.0
    xs = sorted(values)
    idx = min(len(xs) - 1, max(0, int(q * len(xs))))
    return xs[idx]


def _ratio_burn(bad: float, total: float, budget: float) -> float:
    """bad_fraction / error_budget; 0 when there is no traffic."""
    if total <= 0:
        return 0.0
    return (bad / total) / max(budget, 1e-9)


def _alert_state(burn_fast: float, burn_slow: float) -> str:
    if burn_fast > 1.0 and burn_slow > 1.0:
        return STATE_PAGE
    if burn_fast > 1.0:
        return STATE_WARN
    return STATE_OK


class SLOWatchdog:
    """Feed it per-request observations; read back burn-rate states.

    All feed methods are cheap (deque append under a lock) and safe
    from handler threads.  ``chips`` is the serving slice's chip count
    so tok/s normalizes to the per-chip north star.
    """

    def __init__(self, targets: Optional[SLOTargets] = None, chips: int = 1,
                 windows: tuple[float, float] = (WINDOW_FAST_S,
                                                WINDOW_SLOW_S),
                 time_fn: Callable[[], float] = time.monotonic,
                 per_tenant: bool = False, itl_enabled: bool = False,
                 role: str = ""):
        self.targets = targets or SLOTargets()
        self.chips = max(1, int(chips))
        self.window_fast_s, self.window_slow_s = windows
        self.time_fn = time_fn
        self._t0 = time_fn()
        slow = self.window_slow_s
        self.ttft = WindowSeries(slow, time_fn)
        self.tokens = WindowSeries(slow, time_fn)     # per-request counts
        self.success = WindowSeries(slow, time_fn)
        self.failure = WindowSeries(slow, time_fn)
        self.shed = WindowSeries(slow, time_fn)
        # per-token inter-token gaps (--itl): the itl_p99 SLI and its
        # gauges only exist when the engine-side stamping is on, so the
        # ITL-off exposition stays byte-identical
        self.itl_enabled = bool(itl_enabled)
        self.itl = WindowSeries(slow, time_fn)
        # P/D role attribution: "prefill" / "decode" / "unified"; a
        # non-empty role adds the kaito:slo_role info gauge
        self._role_set = bool(role)
        self.role = role or "unified"
        # per-tenant QoS slices: only with a QoS config —
        # the gauges they feed must not exist in the QoS-off exposition
        self.per_tenant = per_tenant
        self._tenant_ttft: dict[str, WindowSeries] = {}
        self._tenant_shed: dict[str, WindowSeries] = {}
        self._tenant_itl: dict[str, WindowSeries] = {}

    # -- feeds ---------------------------------------------------------

    def _tenant_series(self, store: dict, tenant: str) -> WindowSeries:
        s = store.get(tenant)
        if s is None:
            s = store[tenant] = WindowSeries(self.window_slow_s,
                                             self.time_fn)
        return s

    def observe_ttft(self, seconds: float, tenant: str = "") -> None:
        self.ttft.add(seconds)
        if self.per_tenant and tenant:
            self._tenant_series(self._tenant_ttft, tenant).add(seconds)

    def observe_itl(self, seconds: float, tenant: str = "") -> None:
        """One inter-token gap (the engine's retire-path stamp)."""
        self.itl.add(seconds)
        if self.per_tenant and tenant:
            self._tenant_series(self._tenant_itl, tenant).add(seconds)

    def note_tokens(self, n: int) -> None:
        if n > 0:
            self.tokens.add(n)

    def note_shed(self, n: int = 1, tenant: str = "") -> None:
        self.shed.add(n)
        if self.per_tenant and tenant:
            self._tenant_series(self._tenant_shed, tenant).add(n)

    def observe_request(self, req) -> None:
        """Feed one finished engine Request (the server calls this next
        to EngineMetrics.observe_request)."""
        if getattr(req, "first_token_time", None):
            self.observe_ttft(req.first_token_time - req.submit_time,
                              tenant=getattr(req, "tenant", ""))
        self.note_tokens(len(getattr(req, "output_tokens", ()) or ()))
        if getattr(req, "finish_time", None) or \
                getattr(req, "finish_reason", None):
            ok = getattr(req, "finish_reason", None) not in \
                ("error", "deadline")
            (self.success if ok else self.failure).add(1)

    # -- per-tenant view -----------------------------------------------

    def tenant_snapshot(self) -> dict:
        """Fast-window TTFT p50 and shed count per tenant — the
        degradation ladder's observable: a guaranteed tenant's p50
        holds while best-effort sheds climb."""
        out: dict = {}
        for t in sorted(set(self._tenant_ttft) | set(self._tenant_shed)
                        | set(self._tenant_itl)):
            ttfts = (self._tenant_ttft[t].values(self.window_fast_s)
                     if t in self._tenant_ttft else [])
            shed = (self._tenant_shed[t].total(self.window_fast_s)
                    if t in self._tenant_shed else 0.0)
            out[t] = {"ttft_p50_s": round(_percentile(ttfts, 0.50), 6),
                      "ttft_samples": len(ttfts),
                      "shed": int(shed)}
            if self.itl_enabled:
                itls = (self._tenant_itl[t].values(self.window_fast_s)
                        if t in self._tenant_itl else [])
                out[t]["itl_p99_s"] = round(_percentile(itls, 0.99), 6)
                out[t]["itl_samples"] = len(itls)
        return out

    # -- evaluation ----------------------------------------------------

    def _window_elapsed(self, window_s: float) -> float:
        """Effective rate denominator: a process younger than the
        window must not dilute tok/s by time it never served."""
        return max(1e-6, min(window_s, self.time_fn() - self._t0))

    def _eval_window(self, window_s: float) -> dict:
        t = self.targets
        ttfts = self.ttft.values(window_s)
        n = len(ttfts)
        bad_p50 = sum(1 for v in ttfts if v > t.ttft_p50_s)
        bad_p99 = sum(1 for v in ttfts if v > t.ttft_p99_s)
        ok = self.success.total(window_s)
        fail = self.failure.total(window_s)
        shed = self.shed.total(window_s)
        total = ok + fail + shed
        toks = self.tokens.total(window_s)
        tok_s_chip = toks / self._window_elapsed(window_s) / self.chips
        out = {
            "ttft_p50_s": round(_percentile(ttfts, 0.50), 6),
            "ttft_p99_s": round(_percentile(ttfts, 0.99), 6),
            "ttft_samples": n,
            "availability": round(ok / total, 6) if total else 1.0,
            "requests": int(total),
            "tokens_per_sec_per_chip": round(tok_s_chip, 3),
            "burn": {
                "ttft_p50": _ratio_burn(bad_p50, n, 1 - t.ttft_p50_fraction),
                "ttft_p99": _ratio_burn(bad_p99, n, 1 - t.ttft_p99_fraction),
                "availability": _ratio_burn(fail + shed, total,
                                            1 - t.availability),
            },
            # throughput is a floor, not a ratio SLI: burning means
            # serving below target while traffic exists
            "throughput_burning": bool(
                toks > 0 and tok_s_chip < t.tokens_per_sec_per_chip),
        }
        if self.itl_enabled:
            itls = self.itl.values(window_s)
            bad_itl = sum(1 for v in itls if v > t.itl_p99_s)
            out["itl_p50_s"] = round(_percentile(itls, 0.50), 6)
            out["itl_p99_s"] = round(_percentile(itls, 0.99), 6)
            out["itl_samples"] = len(itls)
            out["burn"]["itl_p99"] = _ratio_burn(
                bad_itl, len(itls), 1 - t.itl_p99_fraction)
        return out

    def snapshot(self) -> dict:
        """The ``/debug/slo`` payload."""
        fast = self._eval_window(self.window_fast_s)
        slow = self._eval_window(self.window_slow_s)
        slis = ("ttft_p50", "ttft_p99", "availability") + \
            (("itl_p99",) if self.itl_enabled else ())
        burn_rates = {
            sli: {"fast": round(fast["burn"][sli], 4),
                  "slow": round(slow["burn"][sli], 4)}
            for sli in slis
        }
        alerts = {
            sli: _alert_state(b["fast"], b["slow"])
            for sli, b in burn_rates.items()
        }
        alerts["throughput"] = _alert_state(
            1.5 if fast["throughput_burning"] else 0.0,
            1.5 if slow["throughput_burning"] else 0.0)
        # single worst fast-window burn across every SLI (throughput
        # folded in as its synthetic 1.5/0.0): the one field a fleet
        # scraper reads per replica
        burn_max = max([b["fast"] for b in burn_rates.values()]
                       + [1.5 if fast["throughput_burning"] else 0.0])
        fast.pop("burn"), slow.pop("burn")
        fast.pop("throughput_burning"), slow.pop("throughput_burning")
        out = {
            "burn_max": round(burn_max, 4),
            "role": self.role,
            "targets": self.targets.to_dict(),
            "windows": {"fast_s": self.window_fast_s,
                        "slow_s": self.window_slow_s},
            "chips": self.chips,
            "sli": {"fast": fast, "slow": slow},
            "burn_rates": burn_rates,
            "alerts": alerts,
            "healthy": all(a != STATE_PAGE for a in alerts.values()),
        }
        if self.per_tenant:
            out["tenants"] = self.tenant_snapshot()
        return out

    # -- exposition ----------------------------------------------------

    def register_metrics(self, registry) -> None:
        """Attach the ``kaito:slo_*`` families to a metrics Registry.
        Everything is computed at scrape time from the windows, so the
        labelled-``fn`` Gauge form fits exactly."""
        from kaito_tpu_torch.engine.metrics import Gauge

        def _burns() -> dict:
            snap = self.snapshot()
            out = {}
            for sli, b in snap["burn_rates"].items():
                out[(sli, "5m")] = b["fast"]
                out[(sli, "1h")] = b["slow"]
            return out

        def _states() -> dict:
            snap = self.snapshot()
            return {(sli,): _STATE_CODE[state]
                    for sli, state in snap["alerts"].items()}

        Gauge("kaito:slo_burn_rate",
              "Error-budget burn rate per SLI and window (>1 = burning)",
              registry, labels=("sli", "window"), fn=_burns)
        Gauge("kaito:slo_alert_state",
              "Burn-rate alert state per SLI (0=ok, 1=warn, 2=page)",
              registry, labels=("sli",), fn=_states)
        Gauge("kaito:slo_ttft_p50_seconds",
              "Rolling fast-window TTFT p50", registry,
              fn=lambda: self._eval_window(self.window_fast_s)["ttft_p50_s"])
        Gauge("kaito:slo_tokens_per_sec_per_chip",
              "Rolling fast-window generated tokens/s/chip", registry,
              fn=lambda: self._eval_window(
                  self.window_fast_s)["tokens_per_sec_per_chip"])
        Gauge("kaito:slo_availability",
              "Rolling fast-window availability", registry,
              fn=lambda: self._eval_window(self.window_fast_s)["availability"])
        Gauge("kaito:slo_healthy",
              "1 while no SLI is in the page state", registry,
              fn=lambda: 1.0 if self.snapshot()["healthy"] else 0.0)
        if self.itl_enabled:
            # ITL-only families — the itl_p99 entry in burn_rates /
            # alerts above is likewise gated, so the ITL-off exposition
            # stays byte-identical
            Gauge("kaito:slo_itl_p50_seconds",
                  "Rolling fast-window inter-token latency p50", registry,
                  fn=lambda: self._eval_window(
                      self.window_fast_s)["itl_p50_s"])
            Gauge("kaito:slo_itl_p99_seconds",
                  "Rolling fast-window inter-token latency p99", registry,
                  fn=lambda: self._eval_window(
                      self.window_fast_s)["itl_p99_s"])
        if self._role_set:
            Gauge("kaito:slo_role",
                  "Info gauge: the serving role this replica's SLO burn "
                  "attributes to", registry, labels=("role",),
                  fn=lambda: {(self.role,): 1.0})
        if self.per_tenant:
            # QoS-only families — registering them unconditionally
            # would add HELP/TYPE lines to the QoS-off exposition
            def _tenant_ttfts() -> dict:
                return {(t,): s["ttft_p50_s"]
                        for t, s in self.tenant_snapshot().items()}

            def _tenant_sheds() -> dict:
                return {(t,): float(s["shed"])
                        for t, s in self.tenant_snapshot().items()}

            Gauge("kaito:slo_tenant_ttft_p50_seconds",
                  "Rolling fast-window TTFT p50 per tenant", registry,
                  labels=("tenant",), fn=_tenant_ttfts)
            Gauge("kaito:slo_tenant_shed",
                  "Fast-window requests shed per tenant", registry,
                  labels=("tenant",), fn=_tenant_sheds)
            if self.itl_enabled:
                def _tenant_itls() -> dict:
                    return {(t,): s.get("itl_p99_s", 0.0)
                            for t, s in self.tenant_snapshot().items()}

                Gauge("kaito:slo_tenant_itl_p99_seconds",
                      "Rolling fast-window inter-token latency p99 per "
                      "tenant", registry, labels=("tenant",),
                      fn=_tenant_itls)


def engine_chip_count(engine) -> int:
    """Cards behind a server: the distinct CUDA devices of the engine's
    mesh, 1 without a mesh (and for a mesh of CPU slots)."""
    mesh = getattr(engine, "mesh", None)
    if mesh is None:
        return 1
    return max(1, len({str(d) for d in mesh.devices
                       if getattr(d, "type", "") == "cuda"}))
