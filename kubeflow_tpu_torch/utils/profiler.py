"""Continuous sampling profiler: always-on CPU attribution per
(controller, phase).

The port's copy of kubeflow_tpu/utils/profiler.py.

A post-mortem cProfile artifact, written on a load-test budget failure,
is useless for "what is the manager burning CPU on RIGHT NOW", and cProfile's tracing overhead is far
too high to leave on in production.  Podracer (arXiv:2104.06272) makes
the case that sharded-worker throughput claims are only trustworthy when
per-worker utilization is measured continuously, not sampled after the
fact.  This module is the standing equivalent:

  - a sampling thread wakes every `interval_s` of real time, grabs every
    thread's current Python frame (`sys._current_frames()`), and
    collapses it into a flamegraph-style stack string;
  - each sample is attributed to the `(controller, phase)` the sampled
    thread was inside, read from the live span-stack mirror
    (`tracing.live_span_stacks()`) — the same contextvar spine the
    flight recorder rides, so profile buckets line up with trace phases;
  - aggregation is a bounded collapsed-stack store (overflow counts are
    kept, never silently dropped), served at loopback `/debug/profile`
    as JSON or flamegraph-ready collapsed text (`?format=collapsed`);
  - the profiler measures ITSELF: time spent inside sampling passes over
    elapsed wall time is exported as
    `notebook_profiler_overhead_ratio`, so "can this stay always-on" is
    a gauge, not a guess (the fleet soak gates it under 5%).

Wall-clock sampling is deliberately REAL time: a FakeClock stands
still while reconciles execute, so
logical-time sampling would never fire; tier-1 tests keep the sampler
off (ENABLE_CONTINUOUS_PROFILER defaults false) and drive `sample_once`
/ `_record` directly for determinism.
"""

from __future__ import annotations

import os.path
import sys
import threading
import time
from typing import Optional

from . import tracing
from .metrics import Registry

# attribution labels for samples taken outside any live span (the HTTP
# serving thread, the watch fan-out, the sampler's idle peers)
UNATTRIBUTED = "-"


def register_profiler_metrics(registry: Registry) -> tuple:
    """The profiler metric families (registered by NotebookMetrics so
    the inventory is stable even with the sampler off; a started
    profiler re-registers identically and feeds the same objects)."""
    overhead = registry.gauge(
        "notebook_profiler_overhead_ratio",
        "Fraction of wall time the continuous profiler spent sampling "
        "(0 while disabled)")
    if registry.get("notebook_profiler_samples_total") is None:
        # first registration: pin the disabled-state samples so the
        # series exists in every scrape (0 until a profiler starts)
        overhead.set(0.0)
    samples = registry.counter(
        "notebook_profiler_samples_total",
        "Thread stack samples taken by the continuous profiler")
    return overhead, samples


def collapse_frame(frame, max_depth: int = 64) -> str:
    """Flamegraph collapsed-stack rendering of one thread's live frame:
    root-first `file:func` segments joined by `;`."""
    parts: list[str] = []
    f = frame
    while f is not None and len(parts) < max_depth:
        code = f.f_code
        parts.append(f"{os.path.basename(code.co_filename)}:{code.co_name}")
        f = f.f_back
    return ";".join(reversed(parts))


def attribute(spans) -> tuple[str, str]:
    """(controller, phase) attribution from a live span stack: the
    innermost span carrying each attribute wins (a `render` phase span
    inside a `reconcile` root yields ("notebook", "render"); a root with
    no phase child open yet attributes to the controller's own time)."""
    controller = phase = ""
    for span in reversed(spans):
        if not phase and "phase" in span.attributes:
            phase = str(span.attributes["phase"])
        if not controller and "controller" in span.attributes:
            controller = str(span.attributes["controller"])
        if controller and phase:
            break
    if controller and not phase:
        phase = "reconcile"
    return controller or UNATTRIBUTED, phase or UNATTRIBUTED


class ContinuousProfiler:
    """Sampling wall-clock profiler thread; see module docstring.

    Bounds: at most `max_stacks` distinct (controller, phase, stack)
    keys; samples past the bound are counted in `overflow_samples` (and
    reported by /debug/profile) instead of growing memory."""

    def __init__(self, registry: Optional[Registry] = None,
                 interval_s: float = 0.01, max_stacks: int = 2048,
                 max_depth: int = 64) -> None:
        self.interval_s = max(interval_s, 0.001)
        self.max_stacks = max_stacks
        self.max_depth = max_depth
        self._lock = threading.Lock()
        # (controller, phase, collapsed stack) -> sample count
        self._stacks: dict[tuple[str, str, str], int] = {}
        self.samples_total = 0
        self.overflow_samples = 0
        self.passes = 0
        self._busy_s = 0.0
        self._started_mono = 0.0
        self._stopped_mono = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.overhead_gauge = None
        self.samples_counter = None
        if registry is not None:
            self.overhead_gauge, self.samples_counter = \
                register_profiler_metrics(registry)
            self.overhead_gauge.set_function(self.overhead_ratio)

    # -- lifecycle ------------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()
        self._started_mono = time.monotonic()
        self._stopped_mono = 0.0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="continuous-profiler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
        self._thread = None
        if self._started_mono > 0.0 and self._stopped_mono == 0.0:
            # freeze the overhead denominator: a stopped profiler's ratio
            # must read stable, not decay toward zero as wall time passes
            self._stopped_mono = time.monotonic()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — the profiler must never
                pass           # take down the process it observes

    # -- sampling -------------------------------------------------------------
    def sample_once(self) -> int:
        """One sampling pass over every thread but the sampler itself;
        returns the number of stacks recorded.  Public so tests can
        drive sampling deterministically with the thread off."""
        t0 = time.monotonic()
        me = threading.get_ident()
        frames = sys._current_frames()
        stacks = tracing.live_span_stacks()
        n = 0
        for tid, frame in frames.items():
            if tid == me:
                continue
            controller, phase = attribute(stacks.get(tid, ()))
            self._record(controller, phase,
                         collapse_frame(frame, self.max_depth))
            n += 1
        if self.samples_counter is not None and n:
            self.samples_counter.inc(n)
        self._busy_s += time.monotonic() - t0
        self.passes += 1
        return n

    def _record(self, controller: str, phase: str, stack: str) -> None:
        key = (controller, phase, stack)
        with self._lock:
            self.samples_total += 1
            if key in self._stacks:
                self._stacks[key] += 1
            elif len(self._stacks) < self.max_stacks:
                self._stacks[key] = 1
            else:
                self.overflow_samples += 1

    # -- self-measurement -----------------------------------------------------
    def overhead_ratio(self) -> float:
        """Sampling time over elapsed wall time since start() (0 before
        the first start) — the always-on budget gauge."""
        if self._started_mono <= 0.0:
            return 0.0
        end = self._stopped_mono or time.monotonic()
        elapsed = end - self._started_mono
        if elapsed <= 0.0:
            return 0.0
        return min(self._busy_s / elapsed, 1.0)

    # -- read side (/debug/profile) -------------------------------------------
    def snapshot(self, top: int = 0) -> dict:
        """JSON body for /debug/profile: aggregated stacks (count-desc),
        per-(controller, phase) rollups, bounds, and self-overhead."""
        with self._lock:
            items = sorted(self._stacks.items(), key=lambda kv: -kv[1])
            overflow = self.overflow_samples
            total = self.samples_total
        if top:
            items = items[:top]
        by_phase: dict[str, int] = {}
        for (controller, phase, _stack), count in items:
            k = f"{controller}/{phase}"
            by_phase[k] = by_phase.get(k, 0) + count
        return {
            "enabled": self.running,
            "interval_s": self.interval_s,
            "samples_total": total,
            "passes": self.passes,
            "distinct_stacks": len(items),
            "overflow_samples": overflow,
            "overhead_ratio": round(self.overhead_ratio(), 6),
            "by_controller_phase": dict(
                sorted(by_phase.items(), key=lambda kv: -kv[1])),
            "stacks": [
                {"controller": c, "phase": p, "stack": s, "count": n}
                for (c, p, s), n in items
            ],
        }

    def collapsed(self) -> str:
        """Flamegraph collapsed-stack text: `controller;phase;frames N`
        per line — feed straight to flamegraph.pl / speedscope."""
        with self._lock:
            items = sorted(self._stacks.items())
        return "\n".join(
            f"{c};{p};{s} {n}" for (c, p, s), n in items) + ("\n" if items
                                                             else "")

    def clear(self) -> None:
        with self._lock:
            self._stacks.clear()
            self.samples_total = 0
            self.overflow_samples = 0


__all__ = ["ContinuousProfiler", "attribute", "collapse_frame",
           "register_profiler_metrics", "UNATTRIBUTED"]
