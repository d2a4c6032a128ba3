"""The wall clock the session store stamps snapshots with: the port's
copy of kubeflow_tpu/utils/clock.py's `Clock`.  Tests pass any object
with a `now()` method (the reference's FakeClock among them)."""

from __future__ import annotations

import time


class Clock:
    """Wall-clock seconds; the one place the session store reads time."""

    def now(self) -> float:
        return time.time()


__all__ = ["Clock"]
