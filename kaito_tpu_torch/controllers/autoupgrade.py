"""Auto-upgrade runner.

Parity: ``pkg/controllers/autoupgrade/runner.go:58-300`` — a periodic
(non-reconciler) runner: inside the InferenceSet's cron maintenance
window, label one not-yet-upgraded child workspace at a time with the
upgrade-to-version annotation; the workspace controller then swaps the
StatefulSet image and the benchmark re-runs.

A copy of ``kaito_tpu.controllers.autoupgrade``.
"""

from __future__ import annotations

from datetime import datetime, timedelta, timezone
from typing import Optional

from kaito_tpu_torch.api.meta import condition_true
from kaito_tpu_torch.api.workspace import (
    ANNOTATION_UPGRADE_TO,
    COND_INFERENCE_READY,
    LABEL_CREATED_BY_INFERENCESET,
)
from kaito_tpu_torch.controllers.runtime import Store, update_with_retry
from kaito_tpu_torch.k8s.events import record_event


def cron_matches(cron: str, at: datetime) -> bool:
    """Minimal 5-field cron matcher (minute hour dom month dow)."""
    fields = cron.split()
    if len(fields) != 5:
        raise ValueError(f"invalid cron {cron!r}")
    values = [at.minute, at.hour, at.day, at.month, at.isoweekday() % 7]

    def match(spec: str, v: int) -> bool:
        if spec == "*":
            return True
        for part in spec.split(","):
            if part.startswith("*/"):
                if v % int(part[2:]) == 0:
                    return True
            elif "-" in part:
                lo, hi = part.split("-")
                if int(lo) <= v <= int(hi):
                    return True
            elif part.isdigit() and int(part) == v:
                return True
        return False

    return all(match(s, v) for s, v in zip(fields, values))


def _expand(spec: str, lo: int, hi: int) -> list[int]:
    """Expand one cron field to its sorted allowed values in [lo, hi].
    ``*/n`` keeps the matcher's semantics (v % n == 0, not lo+k*n)."""
    if spec == "*":
        return list(range(lo, hi + 1))
    vals: set[int] = set()
    for part in spec.split(","):
        if part.startswith("*/"):
            step = int(part[2:])
            vals.update(v for v in range(lo, hi + 1) if v % step == 0)
        elif "-" in part:
            a, b = part.split("-")
            vals.update(range(int(a), int(b) + 1))
        elif part.isdigit():
            vals.add(int(part))
    return sorted(v for v in vals if lo <= v <= hi)


def last_fire(cron: str, at: datetime) -> Optional[datetime]:
    """Most recent cron fire time <= ``at`` (minute resolution).

    Direct computation: expand each field once, walk back day-by-day
    until a day matches dom/month/dow, then take the largest allowed
    (hour, minute) within bound.  O(fields + days scanned) instead of
    the old minute-by-minute probe over the whole window — a 7-day
    window probed the matcher 10,080 times per InferenceSet per tick.
    Returns None when nothing fired in the past year (e.g. a Feb-30
    cron)."""
    fields = cron.split()
    if len(fields) != 5:
        raise ValueError(f"invalid cron {cron!r}")
    minutes = _expand(fields[0], 0, 59)
    hours = _expand(fields[1], 0, 23)
    doms = set(_expand(fields[2], 1, 31))
    months = set(_expand(fields[3], 1, 12))
    dows = set(_expand(fields[4], 0, 6))
    if not (minutes and hours and doms and months and dows):
        return None
    at = at.replace(second=0, microsecond=0)
    day = at.replace(hour=0, minute=0)
    for back in range(366):
        d = day - timedelta(days=back)
        if not (d.month in months and d.day in doms
                and d.isoweekday() % 7 in dows):
            continue
        if back:
            return d.replace(hour=hours[-1], minute=minutes[-1])
        # today: largest allowed (hour, minute) not after `at`
        for h in reversed(hours):
            if h > at.hour:
                continue
            for m in reversed(minutes):
                if h < at.hour or m <= at.minute:
                    return d.replace(hour=h, minute=m)
        # nothing fired yet today — keep walking back
    return None


class AutoUpgradeRunner:
    """Call tick() on an interval (the manager wires this at ~1/min)."""

    def __init__(self, store: Store, target_version: str):
        self.store = store
        self.target_version = target_version

    def in_window(self, iset, at: Optional[datetime] = None) -> bool:
        au = iset.spec.auto_upgrade
        if not au.enabled or not au.maintenance_window.cron:
            return False
        at = (at or datetime.now(timezone.utc)).replace(second=0,
                                                        microsecond=0)
        # within `duration` minutes after the most recent cron fire
        fire = last_fire(au.maintenance_window.cron, at)
        return fire is not None and (at - fire) < timedelta(
            minutes=au.maintenance_window.duration_minutes)

    def tick(self, at: Optional[datetime] = None) -> Optional[str]:
        """Upgrade at most one workspace; returns its name if any."""
        for iset in self.store.list("InferenceSet"):
            if not self.in_window(iset, at):
                continue
            children = self.store.list(
                "Workspace", iset.metadata.namespace,
                labels={LABEL_CREATED_BY_INFERENCESET: iset.metadata.name})
            # one at a time: wait for any in-flight upgrade to go ready
            in_flight = [c for c in children
                         if c.metadata.annotations.get(ANNOTATION_UPGRADE_TO)
                         == self.target_version
                         and not condition_true(c.status.conditions,
                                                COND_INFERENCE_READY)]
            if in_flight:
                continue
            for c in children:
                if c.metadata.annotations.get(ANNOTATION_UPGRADE_TO) != self.target_version:
                    def annotate(o):
                        o.metadata.annotations[ANNOTATION_UPGRADE_TO] = \
                            self.target_version
                    update_with_retry(self.store, "Workspace",
                                      c.metadata.namespace, c.metadata.name,
                                      annotate)
                    record_event(self.store, iset, "Normal",
                                 "UpgradeWindowFired",
                                 f"maintenance window open; upgrading "
                                 f"{c.metadata.name} to "
                                 f"{self.target_version}")
                    record_event(self.store, c, "Normal", "UpgradeStarted",
                                 f"auto-upgrade to {self.target_version} "
                                 f"triggered by maintenance window")
                    return c.metadata.name
        return None
