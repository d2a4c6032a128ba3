"""Clock abstraction: the port's copy of kubeflow_tpu/utils/clock.py.

Every controller takes an injected `Clock`, so culling, idleness and
backoff are testable under a `FakeClock`.  The session store stamps
snapshots with `now()`; tests pass any object with a `now()` method (the
reference's FakeClock among them).
"""

from __future__ import annotations

import time


class Clock:
    """The one home of direct time calls: everything else takes an
    injected Clock so FakeClock runs stay deterministic."""

    def now(self) -> float:
        return time.time()

    def now_iso(self) -> str:
        return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(self.now()))

    def monotonic(self) -> float:
        """Monotonic reading for interval arithmetic (rate limiters,
        retry deadlines), never compared against now()."""
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class FakeClock(Clock):
    def __init__(self, start: float = 1_700_000_000.0) -> None:
        self._now = start

    def now(self) -> float:
        return self._now

    def monotonic(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        # a FakeClock sleep advances logical time instead of blocking
        if seconds > 0:
            self.advance(seconds)

    def advance(self, seconds: float) -> None:
        self._now += seconds

    def set(self, t: float) -> None:
        self._now = t


def parse_iso(ts: str) -> float:
    """RFC3339 parse accepting fractional seconds and offsets (real
    Jupyter reports e.g. 2026-07-29T10:00:00.533016Z)."""
    from datetime import datetime, timezone

    s = ts.strip()
    if s.endswith(("Z", "z")):
        s = s[:-1] + "+00:00"
    dt = datetime.fromisoformat(s)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp()


__all__ = ["Clock", "FakeClock", "parse_iso"]
