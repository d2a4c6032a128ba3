"""Control-plane aggregation of worker data-plane telemetry: the port's
copy of kubeflow_tpu/core/telemetry.py.

Workers publish rolling summaries (runtime/telemetry.py TelemetryAgent)
into their pod's `notebooks.kubeflow.org/telemetry` annotation; this
module is the watch-fed read side.  A `WorkerTelemetryAggregator`
registers an incremental aggregate on the InformerCache (the
`add_aggregate` pattern: O(changed) per watch event, O(series) per
read, zero API calls), rolls per-worker summaries into per-notebook and
fleet series, and exports them:

  - `notebook_dataplane_tokens_per_second{namespace,name}` — sum over
    the slice's workers;
  - `notebook_dataplane_mfu_ratio{namespace,name}` — mean worker MFU
    (SPMD workers run the same program; the mean is the slice MFU);
  - `notebook_dataplane_step_time_seconds{namespace,name}` — the MAX
    worker step time (a synced slice steps at its slowest worker);
  - `notebook_dataplane_straggler{namespace,name}` — 1 while straggler
    detection fires: the slowest worker exceeds `straggler_ratio` x the
    slice median step time (with at least `min_workers` reporting).
    Firing also emits ONE Warning event naming the worker and a
    `dataplane.straggler` span event — observability only, no healing
    action (healing remains the RecoveryEngine's job, and a slow-but-
    alive worker is not a disruption).
  - `notebook_dataplane_straggler_checks_total{result}` and
    `notebook_dataplane_mfu_checks_total{result}` — per-evaluation
    verdict counters the SLO engine's (knob-disabled) `straggler_rate`
    and `fleet_mfu` objectives burn against.

`evaluate()` runs at every metrics scrape (NotebookMetrics wires it, the
same contract as the SLO engine); without a cache it brute-forces over
`api.list("Pod")` — the degraded-backend fallback every census has.
"""

from __future__ import annotations

import json
from typing import Optional

from ..utils import tracing
from ..utils.metrics import Registry

# MUST match runtime.telemetry.TELEMETRY_ANNOTATION / SUMMARY_VERSION —
# duplicated literals because core must not import the runtime package
# (tests/test_telemetry.py asserts the pair stays in sync)
TELEMETRY_ANNOTATION = "notebooks.kubeflow.org/telemetry"
SUMMARY_VERSION = 1

NOTEBOOK_NAME_LABEL = "notebook-name"

EVENT_STRAGGLER = "DataPlaneStraggler"
EVENT_STRAGGLER_CLEARED = "DataPlaneStragglerCleared"

_TRACER = tracing.get_tracer("kubeflow_tpu_torch.core.telemetry")

_SEP = "\x1f"
# per-worker stats carried through the aggregate, one group key each
_FIELDS = ("tokens_per_s", "step_time_s", "mfu")


def register_dataplane_metrics(registry: Registry) -> dict:
    """The data-plane rollup families (registered by NotebookMetrics so
    the inventory is stable whether or not an aggregator is attached;
    the aggregator re-registers identically and feeds the same
    objects)."""
    return {
        "tokens_per_second": registry.gauge(
            "notebook_dataplane_tokens_per_second",
            "Aggregate training/decode throughput reported by a "
            "notebook's workers",
            labels=("namespace", "name")),
        "mfu_ratio": registry.gauge(
            "notebook_dataplane_mfu_ratio",
            "Mean worker MFU (0-1, runtime.roofline definition) per "
            "notebook",
            labels=("namespace", "name")),
        "step_time_seconds": registry.gauge(
            "notebook_dataplane_step_time_seconds",
            "Slowest-worker rolling step time per notebook (a synced "
            "slice steps at its slowest worker)",
            labels=("namespace", "name")),
        "straggler": registry.gauge(
            "notebook_dataplane_straggler",
            "Whether straggler detection currently fires for the "
            "notebook (slowest worker beyond the ratio of the slice "
            "median)",
            labels=("namespace", "name")),
        "straggler_checks": registry.counter(
            "notebook_dataplane_straggler_checks_total",
            "Per-notebook straggler evaluations by verdict "
            "(ok | straggler)",
            labels=("result",)),
        "mfu_checks": registry.counter(
            "notebook_dataplane_mfu_checks_total",
            "Per-notebook fleet-MFU evaluations by verdict (ok | low; "
            "checked against DATAPLANE_MFU_TARGET when set)",
            labels=("result",)),
    }


def parse_pod_telemetry(pod) -> Optional[dict]:
    """(notebook, worker, summary) contribution of one pod, or None for
    pods without a well-formed telemetry annotation."""
    nb = pod.metadata.labels.get(NOTEBOOK_NAME_LABEL)
    if not nb:
        return None
    payload = pod.metadata.annotations.get(TELEMETRY_ANNOTATION)
    if not payload:
        return None
    try:
        summary = json.loads(payload)
    except (ValueError, TypeError):
        return None
    if not isinstance(summary, dict) or summary.get("v") != SUMMARY_VERSION:
        return None
    return {"notebook": nb, "worker": pod.name, "summary": summary}


class WorkerTelemetryAggregator:
    """Roll per-worker telemetry annotations into per-notebook series;
    see module docstring."""

    AGGREGATE = "dataplane-telemetry"

    def __init__(self, api, registry: Registry, clock,
                 cache=None, recorder=None,
                 straggler_ratio: float = 1.5,
                 min_workers: int = 2,
                 mfu_target: float = 0.0) -> None:
        self.api = api
        self.clock = clock
        self.cache = cache
        self.recorder = recorder  # kube.EventRecorder (None = no events)
        self.straggler_ratio = max(straggler_ratio, 1.0)
        self.min_workers = max(min_workers, 2)
        self.mfu_target = mfu_target
        m = register_dataplane_metrics(registry)
        self.tokens_gauge = m["tokens_per_second"]
        self.mfu_gauge = m["mfu_ratio"]
        self.step_gauge = m["step_time_seconds"]
        self.straggler_gauge = m["straggler"]
        self.straggler_checks = m["straggler_checks"]
        self.mfu_checks = m["mfu_checks"]
        # (ns, nb) -> straggling worker name, for fire/clear transitions
        self._stragglers: dict[tuple[str, str], str] = {}
        # series emitted by the last evaluation — a notebook whose
        # workers stopped reporting must read 0, not stale
        self._seen: set[tuple[str, str]] = set()
        self._last: dict = {"notebooks": {}, "stragglers": [], "fleet": {}}
        self.evaluations = 0
        if self.cache is not None:
            try:
                self.cache.add_aggregate("Pod", self.AGGREGATE,
                                         self._pod_contrib)
            except Exception:  # noqa: BLE001 — degraded backend: the
                self.cache = None  # list-scan fallback serves instead

    # -- cache aggregate ------------------------------------------------------
    @classmethod
    def _pod_contrib(cls, pod) -> dict:
        """Per-pod contribution: one group per (notebook, worker, field).
        A worker's key is unique to its pod, so the per-group 'sum' IS
        the worker's current value and updates replace it O(1)."""
        parsed = parse_pod_telemetry(pod)
        if parsed is None:
            return {}
        s = parsed["summary"]
        out = {}
        for fld in _FIELDS:
            v = s.get(fld)
            if isinstance(v, (int, float)):
                out[_SEP.join((pod.namespace, parsed["notebook"],
                               parsed["worker"], fld))] = float(v)
        return out

    def _worker_stats(self) -> dict[tuple[str, str], dict[str, dict]]:
        """(ns, notebook) -> worker -> {field: value}, from the cache's
        incremental sums or the pod-list fallback."""
        out: dict[tuple[str, str], dict[str, dict]] = {}
        if self.cache is not None:
            sums = self.cache.aggregate("Pod", self.AGGREGATE)
        else:
            sums = {}
            for pod in self.api.list("Pod"):
                sums.update(self._pod_contrib(pod))
        for key, v in sums.items():
            ns, nb, worker, fld = key.split(_SEP)
            out.setdefault((ns, nb), {}).setdefault(worker, {})[fld] = v
        return out

    # -- evaluation (scrape-time) ---------------------------------------------
    def evaluate(self) -> dict:
        """Recompute the rollup, update gauges/counters, and transition
        straggler state.  Deterministic under FakeClock; NotebookMetrics
        calls this from every scrape."""
        self.evaluations += 1
        stats = self._worker_stats()
        notebooks: dict[str, dict] = {}
        stragglers: list[dict] = []
        seen: set[tuple[str, str]] = set()
        for (ns, nb), workers in sorted(stats.items()):
            complete = {w: f for w, f in workers.items()
                        if all(k in f for k in _FIELDS)}
            if not complete:
                continue
            seen.add((ns, nb))
            tokens = sum(f["tokens_per_s"] for f in complete.values())
            mfu = (sum(f["mfu"] for f in complete.values())
                   / len(complete))
            steps = sorted((f["step_time_s"], w)
                           for w, f in complete.items())
            slowest_time, slowest_worker = steps[-1]
            # lower-middle median: for even worker counts the upper
            # middle could BE the straggler, hiding it from its own
            # baseline (the 2-worker degenerate case otherwise never
            # fires)
            median = steps[(len(steps) - 1) // 2][0]
            straggling = (
                len(complete) >= self.min_workers and median > 0
                and slowest_time > self.straggler_ratio * median)
            self.tokens_gauge.labels(ns, nb).set(tokens)
            self.mfu_gauge.labels(ns, nb).set(mfu)
            self.step_gauge.labels(ns, nb).set(slowest_time)
            self.straggler_gauge.labels(ns, nb).set(
                1.0 if straggling else 0.0)
            self.straggler_checks.labels(
                "straggler" if straggling else "ok").inc()
            if self.mfu_target > 0:
                self.mfu_checks.labels(
                    "low" if mfu < self.mfu_target else "ok").inc()
            else:
                self.mfu_checks.labels("ok").inc()
            entry = {
                "workers": {w: dict(f) for w, f in sorted(complete.items())},
                "tokens_per_s": tokens,
                "mfu": mfu,
                "step_time_s": slowest_time,
                "median_step_time_s": median,
                "straggler": slowest_worker if straggling else None,
            }
            notebooks[f"{ns}/{nb}"] = entry
            if straggling:
                stragglers.append({
                    "namespace": ns, "name": nb,
                    "worker": slowest_worker,
                    "step_time_s": slowest_time,
                    "median_step_time_s": median,
                    "ratio": slowest_time / median,
                })
            self._transition(ns, nb, straggling, slowest_worker,
                             slowest_time, median)
        # notebooks that vanished (or stopped reporting) read 0, and a
        # firing straggler clears rather than lingering
        for ns, nb in self._seen - seen:
            self.tokens_gauge.labels(ns, nb).set(0.0)
            self.mfu_gauge.labels(ns, nb).set(0.0)
            self.step_gauge.labels(ns, nb).set(0.0)
            self.straggler_gauge.labels(ns, nb).set(0.0)
            self._transition(ns, nb, False, "", 0.0, 0.0)
        self._seen = seen
        self._last = {
            "notebooks": notebooks,
            "stragglers": stragglers,
            "fleet": {
                "notebooks": len(notebooks),
                "tokens_per_s": sum(
                    e["tokens_per_s"] for e in notebooks.values()),
                "mfu_mean": (sum(e["mfu"] for e in notebooks.values())
                             / len(notebooks)) if notebooks else 0.0,
                "stragglers": len(stragglers),
            },
        }
        return self._last

    def _transition(self, ns: str, nb: str, straggling: bool,
                    worker: str, slowest: float, median: float) -> None:
        key = (ns, nb)
        prev = self._stragglers.get(key)
        if straggling and prev != worker:
            self._stragglers[key] = worker
            msg = (f"worker {worker} step time {slowest:.3f}s exceeds "
                   f"{self.straggler_ratio:g}x the slice median "
                   f"{median:.3f}s")
            self._emit_event(ns, nb, "Warning", EVENT_STRAGGLER, msg)
            with _TRACER.start_span("dataplane.straggler", attributes={
                    "namespace": ns, "notebook": nb,
                    "worker": worker}) as span:
                span.add_event("straggler.detected", {
                    "worker": worker, "step_time_s": slowest,
                    "median_step_time_s": median})
        elif not straggling and prev is not None:
            del self._stragglers[key]
            self._emit_event(
                ns, nb, "Normal", EVENT_STRAGGLER_CLEARED,
                f"worker {prev} rejoined the slice pace")

    def _emit_event(self, ns: str, nb: str, etype: str, reason: str,
                    message: str) -> None:
        if self.recorder is None:
            return
        getter = self.cache.get if self.cache is not None \
            else self.api.try_get
        try:
            notebook = getter("Notebook", ns, nb)
            if notebook is not None:
                self.recorder.event(notebook, etype, reason, message)
        except Exception:  # noqa: BLE001 — telemetry must never take
            pass           # down the scrape path over an event write

    # -- read side (/debug/fleet, ops.diagnose) -------------------------------
    def snapshot(self) -> dict:
        """The /debug/fleet `dataplane` section: a fresh evaluation's
        per-notebook rollup, active stragglers, and fleet totals (an
        operator hitting /debug/fleet between scrapes must see the
        current annotations, not the last scrape's)."""
        self.evaluate()
        out = dict(self._last)
        out["evaluations"] = self.evaluations
        out["straggler_ratio"] = self.straggler_ratio
        return out


__all__ = [
    "EVENT_STRAGGLER", "EVENT_STRAGGLER_CLEARED", "SUMMARY_VERSION",
    "TELEMETRY_ANNOTATION", "WorkerTelemetryAggregator",
    "parse_pod_telemetry", "register_dataplane_metrics",
]
