"""Minimal Prometheus-style metrics registry: the port's copy of
kubeflow_tpu/utils/metrics.py, which is stdlib only.

Counters, gauges and histograms with labels and the text exposition
(Prometheus 0.0.4, or OpenMetrics with exemplars).  The worker's
training families (runtime/metrics.py) render through it, and the
controller scrapes the same exposition format and keeps the same family
inventory (ci/metrics_drift_check.sh), so `Registry.render()` must give
the reference's bytes for the same observations: the code below is the
reference's, unchanged.  Histograms follow the Prometheus data model:
cumulative `_bucket` series with an `le` label (the implicit `+Inf`
included), `_sum` and `_count`.  A duplicate registration with another
shape raises; an identical one returns the existing family.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Optional

# Per-family label-set cap (cardinality guard): past this many distinct
# label sets, new ones fold into a reserved "other" series instead of
# growing the registry — a per-namespace family can never explode a
# scrape.  Families opt out with max_label_sets=0; the env knob is read
# once per Registry so tests can override it.
DEFAULT_MAX_LABEL_SETS = 1024

# The reserved label value every overflowing label set folds into.
OVERFLOW_LABEL = "other"


class _Metric:
    def __init__(self, name: str, help_: str, label_names: tuple[str, ...],
                 max_label_sets: int = 0):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self.max_label_sets = max_label_sets
        self.labelsets_dropped = 0
        self._values: dict[tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def _admit(self, known, key: tuple[str, ...]) -> tuple[str, ...]:
        """Resolve a label-set key against the cardinality cap: known keys
        and keys under the cap pass through; the rest fold into the
        reserved ``("other", ...)`` series and count a drop.  Called under
        ``self._lock`` with the metric's key store."""
        if not self.label_names or self.max_label_sets <= 0 \
                or key in known or len(known) < self.max_label_sets:
            return key
        self.labelsets_dropped += 1
        return (OVERFLOW_LABEL,) * len(self.label_names)

    def labels(self, *values: str) -> "_Child":
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got {values}"
            )
        return _Child(self, tuple(values))

    def _set(self, key: tuple[str, ...], v: float) -> None:
        with self._lock:
            self._values[self._admit(self._values, key)] = v

    def _add(self, key: tuple[str, ...], v: float) -> None:
        with self._lock:
            key = self._admit(self._values, key)
            self._values[key] = self._values.get(key, 0.0) + v

    def _observe(self, key: tuple[str, ...], v: float,
                 exemplar: Optional[dict] = None) -> None:
        raise TypeError(f"{self.name}: observe() requires a histogram")

    def value(self, *values: str) -> float:
        return self._values.get(tuple(values), 0.0)

    def kind(self) -> str:
        raise NotImplementedError

    def collect(self) -> dict[tuple[str, ...], float]:
        return dict(self._values)

    def _label_str(self, key: tuple[str, ...], extra: str = "") -> str:
        parts = [f'{n}="{val}"' for n, val in zip(self.label_names, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def sample_lines(self, openmetrics: bool = False) -> list[str]:
        lines = []
        for key, v in sorted(self.collect().items()):
            lines.append(f"{self.name}{self._label_str(key)} {v:g}")
        return lines


class _Child:
    def __init__(self, metric: _Metric, key: tuple[str, ...]):
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        self._metric._add(self._key, amount)

    def set(self, v: float) -> None:
        self._metric._set(self._key, v)

    def observe(self, v: float, exemplar: Optional[dict] = None) -> None:
        self._metric._observe(self._key, v, exemplar)


class Counter(_Metric):
    def kind(self) -> str:
        return "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._add((), amount)


class Gauge(_Metric):
    def kind(self) -> str:
        return "gauge"

    def set(self, v: float) -> None:
        self._set((), v)

    def set_function(self, fn: Callable[[], float]) -> None:
        # a labeled gauge has no single value for one callback to feed; the
        # callback would render an unlabeled sample inside a labeled family,
        # which Prometheus rejects
        if self.label_names:
            raise ValueError(
                f"{self.name}: set_function() requires an unlabeled gauge "
                f"(labels {self.label_names} declared)")
        self._fn = fn

    def collect(self) -> dict[tuple[str, ...], float]:
        fn = getattr(self, "_fn", None)
        if fn is not None:
            self._set((), float(fn()))
        return super().collect()


# The Prometheus client_golang DefBuckets — what controller-runtime's
# reconcile-time histogram uses below its long exponential tail; plenty of
# resolution for both sub-ms in-memory reconciles and multi-second backoffs.
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram (`le`-labeled `_bucket` series plus
    `_sum`/`_count`), the exposition shape of
    controller_runtime_reconcile_time_seconds."""

    def __init__(self, name: str, help_: str, label_names: tuple[str, ...],
                 buckets: Optional[tuple[float, ...]] = None,
                 max_label_sets: int = 0):
        super().__init__(name, help_, label_names,
                         max_label_sets=max_label_sets)
        bounds = tuple(sorted(set(buckets if buckets is not None
                                  else DEFAULT_BUCKETS)))
        if not bounds:
            raise ValueError(f"{name}: histogram needs at least one bucket")
        self.buckets = bounds  # upper bounds, +Inf implicit
        # key -> per-bucket counts (len(buckets)+1, last is +Inf)
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}
        # key -> bucket index -> (labels, observed value): the most recent
        # exemplar per bucket, pinned to the bucket the observation FELL in
        # so the OpenMetrics invariant (exemplar value <= le) holds
        self._exemplars: dict[tuple[str, ...],
                              dict[int, tuple[dict, float]]] = {}

    def kind(self) -> str:
        return "histogram"

    def observe(self, v: float, exemplar: Optional[dict] = None) -> None:
        self._observe((), v, exemplar)

    def _observe(self, key: tuple[str, ...], v: float,
                 exemplar: Optional[dict] = None) -> None:
        with self._lock:
            key = self._admit(self._counts, key)
            counts = self._counts.setdefault(
                key, [0] * (len(self.buckets) + 1))
            idx = len(self.buckets)
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    counts[i] += 1
                    idx = i
                    break
            else:
                counts[-1] += 1
            self._sums[key] = self._sums.get(key, 0.0) + v
            if exemplar:
                self._exemplars.setdefault(key, {})[idx] = (
                    {str(k): str(val) for k, val in exemplar.items()},
                    float(v))

    def _set(self, key: tuple[str, ...], v: float) -> None:
        raise TypeError(f"{self.name}: set() is not valid on a histogram")

    def _add(self, key: tuple[str, ...], v: float) -> None:
        raise TypeError(f"{self.name}: inc() is not valid on a histogram")

    # -- read side (tests assert on these) ------------------------------------
    def count_value(self, *values: str) -> int:
        with self._lock:
            return sum(self._counts.get(tuple(values), ()))

    def sum_value(self, *values: str) -> float:
        with self._lock:
            return self._sums.get(tuple(values), 0.0)

    def bucket_counts(self, *values: str) -> dict[float, int]:
        """Cumulative count per upper bound (inf included), as exposed."""
        with self._lock:
            counts = self._counts.get(tuple(values),
                                      [0] * (len(self.buckets) + 1))
            out: dict[float, int] = {}
            running = 0
            for bound, c in zip(self.buckets, counts):
                running += c
                out[bound] = running
            out[float("inf")] = running + counts[-1]
            return out

    def value(self, *values: str) -> float:
        return float(self.count_value(*values))

    def collect(self) -> dict[tuple[str, ...], float]:
        with self._lock:
            return {k: float(sum(c)) for k, c in self._counts.items()}

    def exemplar(self, *values: str) -> dict[float, tuple[dict, float]]:
        """Bucket upper bound -> (labels, observed value) for the stored
        exemplars of one label set (tests assert on this)."""
        with self._lock:
            stored = self._exemplars.get(tuple(values), {})
            bounds = self.buckets + (float("inf"),)
            return {bounds[i]: (dict(lbl), v)
                    for i, (lbl, v) in stored.items()}

    @staticmethod
    def _exemplar_suffix(ex: Optional[tuple[dict, float]]) -> str:
        if not ex:
            return ""
        labels, v = ex
        inner = ",".join(f'{k}="{val}"' for k, val in sorted(labels.items()))
        return " # {%s} %g" % (inner, v)

    def sample_lines(self, openmetrics: bool = False) -> list[str]:
        lines = []
        with self._lock:
            items = sorted(self._counts.items())
            sums = dict(self._sums)
            exemplars = {k: dict(v) for k, v in self._exemplars.items()}
        for key, counts in items:
            ex = exemplars.get(key, {}) if openmetrics else {}
            running = 0
            for i, (bound, c) in enumerate(zip(self.buckets, counts)):
                running += c
                le = 'le="%g"' % bound
                lines.append(
                    f"{self.name}_bucket"
                    f"{self._label_str(key, le)} {running}"
                    f"{self._exemplar_suffix(ex.get(i))}")
            total = running + counts[-1]
            inf = 'le="+Inf"'
            lines.append(
                f"{self.name}_bucket"
                f"{self._label_str(key, inf)} {total}"
                f"{self._exemplar_suffix(ex.get(len(self.buckets)))}")
            lines.append(
                f"{self.name}_sum{self._label_str(key)} "
                f"{sums.get(key, 0.0):g}")
            lines.append(f"{self.name}_count{self._label_str(key)} {total}")
        return lines


class Registry:
    def __init__(self, max_label_sets: Optional[int] = None) -> None:
        # METRICS_MAX_LABEL_SETS: per-family cap inherited by every metric
        # registered without an explicit max_label_sets (0 disables)
        if max_label_sets is None:
            try:
                max_label_sets = int(os.environ.get(
                    "METRICS_MAX_LABEL_SETS", DEFAULT_MAX_LABEL_SETS))
            except ValueError:
                max_label_sets = DEFAULT_MAX_LABEL_SETS
        self.max_label_sets = max(0, max_label_sets)
        self._metrics: list[_Metric] = []
        self._by_name: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._by_name.get(metric.name)
            if existing is not None:
                identical = (
                    type(existing) is type(metric)
                    and existing.help == metric.help
                    and existing.label_names == metric.label_names
                    and getattr(existing, "buckets", None)
                    == getattr(metric, "buckets", None)
                )
                if identical:
                    return existing
                raise ValueError(
                    f"metric {metric.name!r} already registered as a "
                    f"{existing.kind()} with labels {existing.label_names}; "
                    "duplicate families render two HELP/TYPE blocks, which "
                    "Prometheus rejects")
            self._metrics.append(metric)
            self._by_name[metric.name] = metric
            return metric

    def _cap(self, max_label_sets: Optional[int]) -> int:
        return (self.max_label_sets if max_label_sets is None
                else max(0, max_label_sets))

    def counter(
        self, name: str, help_: str = "", labels: tuple[str, ...] = (),
        max_label_sets: Optional[int] = None,
    ) -> Counter:
        m = self._register(Counter(name, help_, tuple(labels),
                                   max_label_sets=self._cap(max_label_sets)))
        assert isinstance(m, Counter)
        return m

    def gauge(
        self, name: str, help_: str = "", labels: tuple[str, ...] = (),
        max_label_sets: Optional[int] = None,
    ) -> Gauge:
        m = self._register(Gauge(name, help_, tuple(labels),
                                 max_label_sets=self._cap(max_label_sets)))
        assert isinstance(m, Gauge)
        return m

    def histogram(
        self, name: str, help_: str = "", labels: tuple[str, ...] = (),
        buckets: Optional[tuple[float, ...]] = None,
        max_label_sets: Optional[int] = None,
    ) -> Histogram:
        m = self._register(Histogram(name, help_, tuple(labels),
                                     buckets=buckets,
                                     max_label_sets=self._cap(
                                         max_label_sets)))
        assert isinstance(m, Histogram)
        return m

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._by_name.get(name)

    def families(self) -> list[tuple[str, str]]:
        """(name, kind) per registered family, in registration order — the
        inventory ci/metrics_drift_check.sh diffs against its golden list."""
        with self._lock:
            return [(m.name, m.kind()) for m in self._metrics]

    def labelsets_dropped(self) -> dict[str, int]:
        """Family -> cumulative label sets folded into the reserved
        'other' series.  A plain dict (not an auto-registered family) so
        a combined scrape over several registries exports ONE
        metrics_labelsets_dropped_total counter fed from all of them."""
        with self._lock:
            metrics = list(self._metrics)
        return {m.name: m.labelsets_dropped for m in metrics
                if m.labelsets_dropped > 0}

    def render(self, openmetrics: bool = False) -> str:
        """Text exposition.  Default: Prometheus text format 0.0.4.  With
        `openmetrics=True`: OpenMetrics 1.0 — counter families declared
        without the `_total` sample suffix, histogram buckets annotated
        with their stored exemplars.  The `# EOF` terminator is the
        SERVING layer's job (one per exposition, and this registry may be
        only part of a combined scrape body)."""
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            family = m.name
            if openmetrics and m.kind() == "counter" and \
                    family.endswith("_total"):
                family = family[: -len("_total")]
            lines.append(f"# HELP {family} {m.help}")
            lines.append(f"# TYPE {family} {m.kind()}")
            lines.extend(m.sample_lines(openmetrics=openmetrics))
        return "\n".join(lines) + "\n"


def register_cardinality_metrics(registry: Registry) -> Counter:
    """The guard's visibility counter: label sets folded into 'other' by
    the per-family cap, by family.  Registered by NotebookMetrics (and fed
    there from every scraped registry's labelsets_dropped()); bounded by
    the number of families, so it needs no cap of its own."""
    return registry.counter(
        "metrics_labelsets_dropped_total",
        "Label sets folded into the reserved 'other' series by the "
        "per-family cardinality cap (METRICS_MAX_LABEL_SETS)",
        labels=("family",), max_label_sets=0)
