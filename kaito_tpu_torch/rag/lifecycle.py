"""Service lifecycle hook manager.

Parity with the reference's ``presets/ragengine/lifecycle/manager.py``
(326 LoC): ordered, named startup/shutdown hooks with per-hook timing
and failure policy — startup failures abort boot (a half-initialized
service must not pass its readiness probe), shutdown hooks always all
run (best-effort drain).

A copy of ``kaito_tpu.rag.lifecycle``.
"""

from __future__ import annotations

import logging
import signal
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

logger = logging.getLogger(__name__)


@dataclass
class Hook:
    name: str
    fn: Callable[[], None]
    phase: str              # "startup" | "shutdown"
    critical: bool = True   # startup: abort boot on failure
    ran: bool = False
    error: Optional[str] = None
    seconds: float = 0.0


class LifecycleManager:
    def __init__(self):
        self._hooks: list[Hook] = []
        self._shutdown_started = False

    def __len__(self) -> int:
        return len(self._hooks)

    def on_startup(self, name: str, fn: Callable[[], None],
                   critical: bool = True) -> None:
        self._hooks.append(Hook(name, fn, "startup", critical))

    def on_shutdown(self, name: str, fn: Callable[[], None]) -> None:
        self._hooks.append(Hook(name, fn, "shutdown", critical=False))

    def _run(self, hook: Hook) -> None:
        t0 = time.monotonic()
        try:
            hook.fn()
            hook.error = None
        except Exception as e:
            hook.error = str(e)
            logger.exception("%s hook %r failed", hook.phase, hook.name)
            if hook.phase == "startup" and hook.critical:
                raise
        finally:
            hook.ran = True
            hook.seconds = time.monotonic() - t0
            logger.info("%s hook %r: %.3fs%s", hook.phase, hook.name,
                        hook.seconds,
                        f" (failed: {hook.error})" if hook.error else "")

    def startup(self) -> None:
        for hook in [h for h in self._hooks if h.phase == "startup"]:
            self._run(hook)

    def shutdown(self) -> None:
        if self._shutdown_started:
            return
        self._shutdown_started = True
        for hook in [h for h in self._hooks if h.phase == "shutdown"]:
            self._run(hook)

    def report(self) -> list[dict]:
        return [{"name": h.name, "phase": h.phase, "ran": h.ran,
                 "seconds": round(h.seconds, 3), "error": h.error}
                for h in self._hooks]

    def install_signal_handlers(self) -> None:
        """SIGTERM (pod deletion) drains through the shutdown hooks."""
        def handler(signum, frame):
            logger.info("signal %d: running shutdown hooks", signum)
            self.shutdown()
            raise SystemExit(0)

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)
