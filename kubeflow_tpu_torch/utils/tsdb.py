"""Bounded in-process time-series store with tiered downsampling: the
port's copy of kubeflow_tpu/utils/tsdb.py.

A scrape is a point in time; a loadtest (or an incident) is a curve.  The
flight recorder retains recent *attempts*, the SLO engine retains burn
*windows* — but nothing retains "p99 ready-time, queue depth, and stage
latency as functions of time", so "where does the curve bend as the fleet
grows" is unanswerable after the fact.  This module is that retained
history: a tiny TSDB fed once per ``NotebookMetrics.scrape()`` with a
handful of pre-selected series.

Storage per series is a three-tier downsampling ring:

  raw   — every sample, deque(maxlen=raw_capacity)
  10s   — fold into 10-second buckets (count/sum/min/max/last)
  60s   — fold into 60-second buckets

Folding happens at append time (no background compaction thread), every
tier is a bounded deque, and the whole store is O(series x capacity)
memory.  Tier capacities default to ~85 minutes of raw history at a 10s
scrape cadence, ~2.8 hours at 10s resolution and ~17 hours at 60s —
enough to carry a whole loadtest or an incident window in a diagnostics
bundle.

Timestamps are INJECTED (``sample(t, values)``): the store never reads a
clock, so it is FakeClock-deterministic in tests.  Queryable at
``/debug/timeline?series=...&tier=...`` and captured wholesale into the
``ops/diagnose`` bundle via ``dump()``, so a run's p99-vs-time curve is
reconstructable offline.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque

TIERS = ("raw", "10s", "60s")
_TIER_WIDTH = {"10s": 10.0, "60s": 60.0}


class TimeSeriesStore:
    """See module docstring.  `max_series` bounds the name space (extra
    series are dropped, counted in `dropped_series_total`) so a label
    explosion upstream cannot grow this store without bound."""

    def __init__(self, raw_capacity: int = 512,
                 tier10_capacity: int = 1024,
                 tier60_capacity: int = 1024,
                 max_series: int = 256) -> None:
        self.raw_capacity = raw_capacity
        self.tier_capacity = {"10s": tier10_capacity,
                              "60s": tier60_capacity}
        self.max_series = max_series
        self._lock = threading.Lock()
        # name -> {"raw": deque[(t, v)], "10s": deque[bucket],
        #          "60s": deque[bucket]} with bucket =
        #          {"t": start, "count", "sum", "min", "max", "last"}
        self._series: "OrderedDict[str, dict]" = OrderedDict()
        self.samples_total = 0
        self.dropped_series_total = 0

    # -- write side (NotebookMetrics.scrape) ----------------------------------
    def sample(self, t: float, values: dict) -> None:
        """Record one observation per named series at injected time `t`.
        Non-finite / non-numeric values are skipped."""
        with self._lock:
            for name, value in values.items():
                try:
                    v = float(value)
                except (TypeError, ValueError):
                    continue
                if v != v or v in (float("inf"), float("-inf")):
                    continue
                s = self._series.get(name)
                if s is None:
                    if len(self._series) >= self.max_series:
                        self.dropped_series_total += 1
                        continue
                    s = {"raw": deque(maxlen=self.raw_capacity),
                         "10s": deque(maxlen=self.tier_capacity["10s"]),
                         "60s": deque(maxlen=self.tier_capacity["60s"])}
                    self._series[name] = s
                s["raw"].append((t, v))
                for tier, width in _TIER_WIDTH.items():
                    bucket_t = (t // width) * width
                    ring = s[tier]
                    head = ring[-1] if ring else None
                    if head is not None and head["t"] == bucket_t:
                        head["count"] += 1
                        head["sum"] += v
                        head["min"] = min(head["min"], v)
                        head["max"] = max(head["max"], v)
                        head["last"] = v
                    else:
                        ring.append({"t": bucket_t, "count": 1, "sum": v,
                                     "min": v, "max": v, "last": v})
                self.samples_total += 1

    # -- read side (/debug/timeline, ops/diagnose, loadtest) ------------------
    def series_names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def query(self, name: str, tier: str = "raw") -> dict:
        """One series at one tier.  Raw points are [t, v] pairs; the
        downsampled tiers return the folded bucket dicts (count/sum/min/
        max/last, plus a derived mean).  Unknown series/tier yields an
        empty point list with an `error` field rather than raising —
        the debug surface must never 500."""
        if tier not in TIERS:
            return {"series": name, "tier": tier, "points": [],
                    "error": "unknown tier (expected %s)" % (TIERS,)}
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return {"series": name, "tier": tier, "points": [],
                        "error": "unknown series"}
            if tier == "raw":
                points = [[t, v] for (t, v) in s["raw"]]
            else:
                points = [{**b, "mean": b["sum"] / b["count"]}
                          for b in s[tier]]
            return {"series": name, "tier": tier, "points": points}

    def dump(self) -> dict:
        """Every series at every tier — the diagnostics-bundle capture
        that makes a run's curves reconstructable offline."""
        with self._lock:
            out = {}
            for name, s in self._series.items():
                out[name] = {
                    "raw": [[t, v] for (t, v) in s["raw"]],
                    "10s": [dict(b) for b in s["10s"]],
                    "60s": [dict(b) for b in s["60s"]],
                }
            return {
                "samples_total": self.samples_total,
                "dropped_series_total": self.dropped_series_total,
                "bounds": {"raw_capacity": self.raw_capacity,
                           "tier10_capacity": self.tier_capacity["10s"],
                           "tier60_capacity": self.tier_capacity["60s"],
                           "max_series": self.max_series},
                "series": out,
            }

    def snapshot(self) -> dict:
        """The /debug/timeline body when no ?series= is asked for: the
        inventory plus bounds, so an operator can discover what to query."""
        with self._lock:
            inventory = {
                name: {"raw_points": len(s["raw"]),
                       "10s_buckets": len(s["10s"]),
                       "60s_buckets": len(s["60s"])}
                for name, s in self._series.items()
            }
        return {
            "tiers": list(TIERS),
            "samples_total": self.samples_total,
            "dropped_series_total": self.dropped_series_total,
            "bounds": {"raw_capacity": self.raw_capacity,
                       "tier10_capacity": self.tier_capacity["10s"],
                       "tier60_capacity": self.tier_capacity["60s"],
                       "max_series": self.max_series},
            "series": inventory,
        }

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
            self.samples_total = 0
            self.dropped_series_total = 0


__all__ = ["TimeSeriesStore", "TIERS"]
