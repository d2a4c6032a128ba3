"""Per-notebook lifecycle stage ledger: critical-path attribution of
event->ready wall time.  The port's copy of kubeflow_tpu/utils/lifecycle.py.

Every latency signal so far is either a point-in-time scrape (histograms,
SLO burn windows) or a per-attempt trace — none of them answers "where did
THIS notebook's 40 seconds between the create event and Ready actually
go?".  This module assembles that answer from hooks that already exist:
the Manager feeds each finished reconcile root span (the same call site
that feeds the flight recorder), and the ledger folds the attempt stream
into a **causally ordered, non-overlapping partition** of each notebook's
event->ready window:

  event cause -> queue_wait -> [handoff_wait] -> schedule_warm|schedule_cold
    -> render/apply/status (in-attempt phase spans) -> pod_schedule
    -> pod_start -> retry_backoff / recovery_wait excursions -> ready

Keyed ``(namespace, name, generation)`` so a spec update opens a fresh
ledger entry instead of polluting the finished one; bounded like the
flight recorder (LRU over ``max_notebooks``).  Post-ready recover/migrate
spans are recorded as excursions — attributed to their stage histograms
but excluded from the conservation window.

**Conservation is the falsifiability contract**: the partition is built by
a watermark sweep over all attempts (notebook controller AND scheduler —
per-key serialization is per (controller, key), so their windows may
overlap and must be clipped), which makes

    sum(attributed stage durations) == ready_ts - cause_ts

hold *by construction*; any double-count, overlap, or leak in the
bookkeeping breaks the equality, and `conservation()` / `violations()`
expose the residual against an independently measured wall time,
across kills, handoffs, and recovery excursions.

Stage durations export as ``notebook_stage_duration_seconds{stage}``
histograms (exemplar trace ids resolve at /debug/traces) and as a
fleet-wide critical-path ranking — mean and p99 contribution per stage —
at /debug/criticalpath.  Utils idiom: plain locks, injected timestamps
only (all times come from span/event stamps, which follow
``tracing.set_clock``), O(bounds) memory, never raises into the reconcile
loop's feed path.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Optional

from .metrics import Registry

# The closed stage vocabulary (bounded label set — Prometheus cardinality
# discipline).  `schedule_wait` is an internal placeholder resolved to
# warm/cold at finalize; it never leaves the ledger.
STAGE_QUEUE_WAIT = "queue_wait"
# time parked behind the tenancy admission gate (quota / fair share /
# preemption fence, core/scheduler.py) — distinct from queue_wait (the
# workqueue) and schedule_* (capacity): the gang was not even in line
STAGE_QUOTA_WAIT = "quota_wait"
STAGE_HANDOFF_WAIT = "handoff_wait"
STAGE_SCHEDULE_WARM = "schedule_warm"
STAGE_SCHEDULE_COLD = "schedule_cold"
STAGE_RENDER = "render"
STAGE_APPLY = "apply"
STAGE_STATUS = "status"
STAGE_POD_SCHEDULE = "pod_schedule"
STAGE_POD_START = "pod_start"
STAGE_RETRY_BACKOFF = "retry_backoff"
STAGE_RECOVERY_WAIT = "recovery_wait"
STAGE_RECOVER = "recover"
STAGE_MIGRATE = "migrate"
STAGE_PROMOTE = "promote"
STAGE_OTHER = "reconcile_other"

_SCHEDULE_WAIT = "_schedule_wait"  # placeholder, resolved warm/cold

STAGES = (
    STAGE_QUEUE_WAIT, STAGE_QUOTA_WAIT, STAGE_HANDOFF_WAIT,
    STAGE_SCHEDULE_WARM,
    STAGE_SCHEDULE_COLD, STAGE_RENDER, STAGE_APPLY, STAGE_STATUS,
    STAGE_POD_SCHEDULE, STAGE_POD_START, STAGE_RETRY_BACKOFF,
    STAGE_RECOVERY_WAIT, STAGE_RECOVER, STAGE_MIGRATE, STAGE_PROMOTE,
    STAGE_OTHER,
)

# phase attribute (controllers' child spans) -> ledger stage
_PHASE_STAGES = {
    "render": STAGE_RENDER,
    "apply": STAGE_APPLY,
    "status": STAGE_STATUS,
    "schedule": _SCHEDULE_WAIT,
    "recover": STAGE_RECOVER,
    "migrate": STAGE_MIGRATE,
    "promote": STAGE_PROMOTE,
}

# Ready-time spans minutes at fleet scale, far past reconcile-time's
# DefBuckets — these cover 50ms render phases through 10-minute cold
# provisioning waits.
STAGE_BUCKETS = (0.05, 0.25, 1.0, 5.0, 15.0, 30.0, 60.0,
                 120.0, 300.0, 600.0)

# Controllers whose attempts reconcile a Notebook key and therefore
# belong on its lifecycle timeline (event-reemit reconciles Events,
# warm-pool reconciles TPUWarmPool objects).
_TRACKED_CONTROLLERS = ("notebook", "slice-scheduler")


def register_lifecycle_metrics(registry: Registry):
    """The lifecycle metric family (registered by NotebookMetrics so the
    inventory is stable whether or not a ledger is attached; the ledger
    re-registers identically and gets the same object back)."""
    return registry.histogram(
        "notebook_stage_duration_seconds",
        "Attributed duration of one lifecycle stage on a notebook's "
        "event->ready critical path (conserving partition; see "
        "/debug/criticalpath)",
        labels=("stage",), buckets=STAGE_BUCKETS)


@dataclass
class _Attempt:
    """One reconcile attempt projected onto a notebook's timeline."""

    controller: str
    manager_id: str
    start: float
    end: float
    trace_id: str
    # in-attempt (start, end, stage) phase segments, sorted by (start, end)
    segments: list = field(default_factory=list)
    # stage of the idle gap AFTER this attempt; None preserves the prior
    next_hint: Optional[str] = None
    ready_ts: Optional[float] = None
    saw_cold: bool = False


@dataclass
class _Entry:
    """Ledger state for one (ns, name, generation)."""

    namespace: str
    name: str
    generation: int
    cause_ts: Optional[float] = None
    attempts: list = field(default_factory=list)
    finalized: bool = False
    ready_ts: float = 0.0
    wall_s: float = 0.0
    attributed_s: float = 0.0
    stages: dict = field(default_factory=dict)
    trace_id: str = ""


def _walk_spans(span):
    yield span
    for child in span.children:
        yield from _walk_spans(child)


class LifecycleLedger:
    """See module docstring.  Fed by the Manager with each finished
    reconcile root span; one ledger may serve a whole sharded fleet
    (every replica's manager points at the same object), which is what
    lets handoff/adoption waits be attributed: a manager-id change
    between consecutive attempts marks the gap as handoff_wait."""

    def __init__(self, registry: Optional[Registry] = None,
                 max_notebooks: int = 4096,
                 samples_per_stage: int = 2048,
                 keep_conservation: int = 4096,
                 tolerance: float = 0.05,
                 excursions_per_notebook: int = 32) -> None:
        self.max_notebooks = max_notebooks
        self.samples_per_stage = samples_per_stage
        self.tolerance = tolerance
        self.excursions_per_notebook = excursions_per_notebook
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        # (ns, name) -> bounded ring of post-ready excursion records, so
        # recovery/migrate/promote churn is explainable after the fact
        # (excursions_total alone says "how many", not "what")
        self._excursion_log: "OrderedDict[tuple, deque]" = OrderedDict()
        # latest observed generation per (ns, name) — scheduler attempts
        # carry it too, but a stale cache read may omit it
        self._gen: "OrderedDict[tuple, int]" = OrderedDict()
        # aggregates over finalized ledgers
        self._stage_total: dict[str, float] = {}
        self._stage_count: dict[str, int] = {}
        self._stage_samples: dict[str, deque] = {}
        # ns -> {"ready": deque, "stages": {stage: [count, total]}}
        self._ns: dict[str, dict] = {}
        self._conservation: deque = deque(maxlen=keep_conservation)
        self._violations: deque = deque(maxlen=keep_conservation)
        self.finalized_total = 0
        self.excursions_total = 0
        self._max_rel_err = 0.0
        self._hist = (register_lifecycle_metrics(registry)
                      if registry is not None else None)

    # -- write side (Manager, on root-span completion) -------------------------
    def observe_attempt(self, rec, root_span, manager_id: str = "") -> None:
        """Fold one finished reconcile attempt into its notebook's ledger.
        `rec` is the FlightRecorder's AttemptRecord for the same span (the
        Manager produces both at one call site); `manager_id` identifies
        the feeding replica so shard handoffs are attributable."""
        if root_span is None or rec is None:
            return
        attrs = root_span.attributes
        controller = str(attrs.get("controller", ""))
        if controller not in _TRACKED_CONTROLLERS:
            return
        ns = str(attrs.get("namespace", ""))
        name = str(attrs.get("name", ""))
        if not name:
            return
        attempt = self._project(controller, manager_id, rec, root_span)
        with self._lock:
            gen = int(attrs.get("generation", 0) or 0)
            nskey = (ns, name)
            if gen > 0:
                self._gen[nskey] = gen
                self._gen.move_to_end(nskey)
                while len(self._gen) > self.max_notebooks:
                    self._gen.popitem(last=False)
            else:
                gen = self._gen.get(nskey, 1)
            key = (ns, name, gen)
            entry = self._entries.get(key)
            if entry is not None and entry.finalized:
                self._record_excursions(entry, attempt)
                return
            if entry is None:
                entry = _Entry(namespace=ns, name=name, generation=gen)
                self._entries[key] = entry
                while len(self._entries) > self.max_notebooks:
                    self._entries.popitem(last=False)
            self._entries.move_to_end(key)
            cause = attrs.get("cause_ts")
            if entry.cause_ts is None:
                entry.cause_ts = (float(cause) if cause is not None
                                  else rec.start_time)
            entry.attempts.append(attempt)
            entry.trace_id = attempt.trace_id or entry.trace_id
            if attempt.ready_ts is not None:
                self._finalize(key, entry, attempt.ready_ts)

    def _project(self, controller: str, manager_id: str, rec,
                 root_span) -> _Attempt:
        """Summarize one root span tree into an _Attempt: in-attempt phase
        segments plus the hint for what the notebook waits on next."""
        a = _Attempt(controller=controller, manager_id=manager_id,
                     start=rec.start_time, end=rec.end_time,
                     trace_id=rec.trace_id)
        waiting_on = ""
        saw_backoff_wait = False
        saw_queued = False
        for span in _walk_spans(root_span):
            stage = _PHASE_STAGES.get(str(span.attributes.get("phase", "")))
            if stage is not None and span is not root_span:
                a.segments.append((span.start_time, span.end_time, stage))
            for ev in span.events:
                if ev.name == "notebook.ready":
                    a.ready_ts = ev.timestamp
                elif ev.name == "notebook.waiting":
                    waiting_on = str(ev.attributes.get("on", ""))
                elif ev.name == "schedule.wait":
                    a.saw_cold = True
                elif ev.name == "schedule.queued":
                    saw_queued = True
                elif ev.name == "schedule.placed":
                    waiting_on = "placed"
                elif ev.name == "recovery.backoff_wait":
                    saw_backoff_wait = True
        a.segments.sort(key=lambda s: (s[0], s[1]))
        result = rec.result
        if saw_queued or waiting_on == "quota_wait":
            # the admission gate parked the gang this attempt: the idle
            # gap that follows is quota_wait, regardless of the requeue
            # the gate returns to re-examine the line
            a.next_hint = STAGE_QUOTA_WAIT
        elif result in ("error", "requeue"):
            a.next_hint = STAGE_RETRY_BACKOFF
        elif saw_backoff_wait:
            a.next_hint = STAGE_RECOVERY_WAIT
        elif a.saw_cold or waiting_on == "scheduling":
            a.next_hint = _SCHEDULE_WAIT
        elif waiting_on == "placed":
            a.next_hint = STAGE_QUEUE_WAIT
        elif waiting_on == "pod_schedule":
            a.next_hint = STAGE_POD_SCHEDULE
        elif waiting_on == "pod_start":
            a.next_hint = STAGE_POD_START
        return a

    # -- the conserving partition ---------------------------------------------
    def _finalize(self, key: tuple, entry: _Entry, ready_ts: float) -> None:
        """Watermark sweep: partition [cause_ts, ready_ts] across every
        recorded attempt's execution window and phase segments, classify
        the gaps by the standing wait hint, and fold the result into the
        fleet aggregates.  Called under the lock."""
        t0 = entry.cause_ts if entry.cause_ts is not None else ready_ts
        tr = max(ready_ts, t0)
        attempts = sorted(entry.attempts, key=lambda a: (a.start, a.end))
        saw_cold = any(a.saw_cold for a in attempts)
        stages: dict[str, float] = {}

        def add(stage: str, dur: float) -> None:
            if dur > 0.0:
                if stage == _SCHEDULE_WAIT:
                    stage = (STAGE_SCHEDULE_COLD if saw_cold
                             else STAGE_SCHEDULE_WARM)
                stages[stage] = stages.get(stage, 0.0) + dur

        def clip(t: float, lo: float) -> float:
            return min(max(t, lo), tr)

        watermark = t0
        hint: Optional[str] = None
        prev: Optional[_Attempt] = None
        for a in attempts:
            gap_stage = STAGE_QUEUE_WAIT if prev is None \
                else (hint or STAGE_QUEUE_WAIT)
            if prev is not None and a.manager_id and prev.manager_id \
                    and a.manager_id != prev.manager_id:
                gap_stage = STAGE_HANDOFF_WAIT
            start = clip(a.start, watermark)
            add(gap_stage, start - watermark)
            watermark = start
            for (s, e, st) in a.segments:
                s2, e2 = clip(s, watermark), clip(e, watermark)
                add(STAGE_OTHER, s2 - watermark)
                add(st, e2 - s2)
                watermark = max(watermark, e2)
            end = clip(a.end, watermark)
            add(STAGE_OTHER, end - watermark)
            watermark = max(watermark, end)
            if a.next_hint is not None:
                hint = a.next_hint
            prev = a
        add(hint or STAGE_OTHER, tr - watermark)

        entry.finalized = True
        entry.ready_ts = tr
        entry.stages = stages
        entry.wall_s = tr - t0
        entry.attributed_s = sum(stages.values())
        entry.attempts = []  # the partition replaces the raw attempt log
        self.finalized_total += 1

        rel_err = (abs(entry.attributed_s - entry.wall_s)
                   / entry.wall_s) if entry.wall_s > 1e-9 else 0.0
        self._max_rel_err = max(self._max_rel_err, rel_err)
        record = {
            "namespace": entry.namespace, "name": entry.name,
            "generation": entry.generation, "wall_s": entry.wall_s,
            "attributed_s": entry.attributed_s, "rel_err": rel_err,
            "trace_id": entry.trace_id,
        }
        self._conservation.append(record)
        if rel_err > self.tolerance:
            self._violations.append(record)

        exemplar = ({"trace_id": entry.trace_id}
                    if entry.trace_id else None)
        for stage, dur in stages.items():
            self._stage_total[stage] = \
                self._stage_total.get(stage, 0.0) + dur
            self._stage_count[stage] = self._stage_count.get(stage, 0) + 1
            samples = self._stage_samples.get(stage)
            if samples is None:
                samples = deque(maxlen=self.samples_per_stage)
                self._stage_samples[stage] = samples
            samples.append(dur)
            if self._hist is not None:
                self._hist.labels(stage).observe(dur, exemplar=exemplar)
        nsagg = self._ns.get(entry.namespace)
        if nsagg is None:
            nsagg = {"ready": deque(maxlen=self.samples_per_stage),
                     "stages": {}}
            self._ns[entry.namespace] = nsagg
        nsagg["ready"].append(entry.wall_s)
        for stage, dur in stages.items():
            st = nsagg["stages"].setdefault(stage, [0, 0.0])
            st[0] += 1
            st[1] += dur

    def _record_excursions(self, entry: _Entry, attempt: _Attempt) -> None:
        """Post-ready recover/migrate/promote work: attributed to its stage
        histogram but outside the conserved event->ready window.  Called
        under the lock."""
        exemplar = ({"trace_id": attempt.trace_id}
                    if attempt.trace_id else None)
        nskey = (entry.namespace, entry.name)
        for (s, e, stage) in attempt.segments:
            if stage not in (STAGE_RECOVER, STAGE_MIGRATE, STAGE_PROMOTE):
                continue
            dur = max(e - s, 0.0)
            self.excursions_total += 1
            ring = self._excursion_log.get(nskey)
            if ring is None:
                ring = deque(maxlen=self.excursions_per_notebook)
                self._excursion_log[nskey] = ring
                while len(self._excursion_log) > self.max_notebooks:
                    self._excursion_log.popitem(last=False)
            self._excursion_log.move_to_end(nskey)
            ring.append({
                "stage": stage, "duration_s": dur, "start": s, "end": e,
                "trace_id": attempt.trace_id,
                "generation": entry.generation,
            })
            self._stage_total[stage] = \
                self._stage_total.get(stage, 0.0) + dur
            self._stage_count[stage] = self._stage_count.get(stage, 0) + 1
            samples = self._stage_samples.get(stage)
            if samples is None:
                samples = deque(maxlen=self.samples_per_stage)
                self._stage_samples[stage] = samples
            samples.append(dur)
            if self._hist is not None:
                self._hist.labels(stage).observe(dur, exemplar=exemplar)

    # -- read side (/debug/criticalpath, loadtest, tests) ----------------------
    @staticmethod
    def _p99(samples) -> float:
        """Nearest-rank p99 (same convention as loadtest/convergence.py)."""
        if not samples:
            return 0.0
        ordered = sorted(samples)
        n = len(ordered)
        return ordered[min(max((99 * n + 99) // 100 - 1, 0), n - 1)]

    def ranking(self) -> list[dict]:
        """Fleet-wide critical path: per stage, the mean and p99
        contribution to event->ready, ranked by total attributed time."""
        with self._lock:
            grand = sum(self._stage_total.values()) or 1.0
            out = []
            for stage, total in self._stage_total.items():
                count = self._stage_count.get(stage, 0)
                samples = self._stage_samples.get(stage, ())
                out.append({
                    "stage": stage,
                    "count": count,
                    "total_s": total,
                    "mean_s": total / count if count else 0.0,
                    "p99_s": self._p99(samples),
                    "share": total / grand,
                })
            out.sort(key=lambda r: r["total_s"], reverse=True)
            return out

    def conservation(self) -> dict:
        """The falsifiability summary: every finalized ledger's attributed
        sum vs its measured event->ready wall time."""
        with self._lock:
            recs = list(self._conservation)
            mean_err = (sum(r["rel_err"] for r in recs) / len(recs)
                        if recs else 0.0)
            return {
                "finalized": self.finalized_total,
                "checked": len(recs),
                "violations": len(self._violations),
                "tolerance": self.tolerance,
                "max_rel_err": self._max_rel_err,
                "mean_rel_err": mean_err,
            }

    def violations(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._violations]

    def conservation_records(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._conservation]

    def namespace_rollup(self) -> dict:
        """Per-namespace ready-time and stage-latency aggregates — the
        'tenants' view in /debug/fleet."""
        with self._lock:
            out = {}
            for ns, agg in self._ns.items():
                ready = agg["ready"]
                out[ns] = {
                    "ready_count": len(ready),
                    "ready_mean_s": (sum(ready) / len(ready)
                                     if ready else 0.0),
                    "ready_p99_s": self._p99(ready),
                    "stages": {
                        stage: {"count": c, "total_s": t,
                                "mean_s": t / c if c else 0.0}
                        for stage, (c, t) in sorted(agg["stages"].items())
                    },
                }
            return out

    def pending_count(self) -> int:
        with self._lock:
            return sum(1 for e in self._entries.values() if not e.finalized)

    def entry(self, namespace: str, name: str,
              generation: int) -> Optional[dict]:
        """One notebook's finalized partition (tests, /debug drill-down)."""
        with self._lock:
            e = self._entries.get((namespace, name, generation))
            if e is None:
                return None
            return {
                "namespace": e.namespace, "name": e.name,
                "generation": e.generation, "finalized": e.finalized,
                "cause_ts": e.cause_ts, "ready_ts": e.ready_ts,
                "wall_s": e.wall_s, "attributed_s": e.attributed_s,
                "stages": dict(e.stages), "trace_id": e.trace_id,
                "attempts": len(e.attempts),
            }

    def latest_entry(self, namespace: str, name: str) -> Optional[dict]:
        """The notebook's most recent generation's partition (the
        diagnosis engine's entry point — callers don't know generations)."""
        with self._lock:
            gen = self._gen.get((namespace, name))
        if gen is None:
            return None
        return self.entry(namespace, name, gen)

    def excursions(self, namespace: str, name: str) -> list[dict]:
        """The bounded post-ready excursion ring for one notebook:
        recover/migrate/promote records with stage, duration, trace_id."""
        with self._lock:
            ring = self._excursion_log.get((namespace, name))
            return [dict(r) for r in ring] if ring else []

    def stage_p99s(self) -> dict[str, float]:
        """Stage -> p99 seconds over the retained samples (the TSDB's
        per-scrape stage series)."""
        with self._lock:
            return {stage: self._p99(samples)
                    for stage, samples in self._stage_samples.items()}

    def snapshot(self) -> dict:
        """The /debug/criticalpath body."""
        base = {
            "bounds": {
                "max_notebooks": self.max_notebooks,
                "samples_per_stage": self.samples_per_stage,
            },
            "stages": list(STAGES),
            "ranking": self.ranking(),
            "conservation": self.conservation(),
            "violations": self.violations(),
            "namespaces": self.namespace_rollup(),
        }
        with self._lock:
            base["pending"] = sum(
                1 for e in self._entries.values() if not e.finalized)
            base["excursions_total"] = self.excursions_total
            base["excursion_objects"] = len(self._excursion_log)
        return base

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._gen.clear()
            self._excursion_log.clear()
            self._stage_total.clear()
            self._stage_count.clear()
            self._stage_samples.clear()
            self._ns.clear()
            self._conservation.clear()
            self._violations.clear()
            self.finalized_total = 0
            self.excursions_total = 0
            self._max_rel_err = 0.0


__all__ = ["LifecycleLedger", "register_lifecycle_metrics", "STAGES",
           "STAGE_BUCKETS"]
