"""Causal diagnosis engine: per-notebook root-cause explanation and
fleet-wide change-point detection over the fused telemetry spine.

The port's copy of kubeflow_tpu/utils/diagnosis.py.

The control plane has six independent telemetry streams — spans + flight
recorder, SLO burn alerts, per-stage lifecycle ledger, in-process TSDB,
data-plane straggler rollup, tenant metering — but answering "why was
this notebook slow?" or "what changed at 14:03?" still meant an operator
hand-joining /debug endpoints.  This module is the join, with two halves
sharing one evidence model:

* **Per-notebook explainer** — ``explain(namespace, name)`` fuses the
  flight recorder's attempt history (including injected FaultRecords
  riding ``AttemptRecord.faults``), the lifecycle ledger's stage
  partition and excursion ring, Notebook status records (sliceRecovery,
  sessionState, replication/promotion), Events, the data-plane straggler
  rollup, tenant-metering noisy-neighbor flags, SLO alert exemplars, and
  overlapping change-point findings into a **ranked causal chain**::

      ready 92.0s vs fleet p50 8.0s <= schedule_cold 71.0s (77% of wall)
        <= fault plan 'api-degrade' injected 3 faults
        <= change point in stage_p99.retry_backoff at t=...

  Every link cites its evidence (trace_id, event, metric sample).
  Ranking is deterministic: causes backed by *direct* evidence (faults
  in the attempt record, an active straggler verdict, a promotion
  excursion, a noisy-neighbor flag) score ``10 + x`` and always outrank
  causes inferred from stage shares alone (share <= 1), so an injected
  degradation names itself rather than its symptom.

* **Fleet change-point detector** — a bounded, injected-clock
  **level-latch** detector over the TSDB's raw tier.  Per watched
  series it latches a baseline level (mean of the first ``window``
  points) and a spread (max deviation in that window); each evaluation
  it compares the tail-window mean against the latched level and fires
  when the shift clears ``max(min_abs, shift_factor*spread,
  rel_factor*|level|)``.  On fire it re-latches at the new level —
  one deduped finding per shift: a step fires exactly once, stationary
  noise never fires, a ramp fires at least once.  Each finding is
  correlated against the discrete event timeline (fault injections,
  promotions, shard membership epochs, warm-pool resizes, straggler
  onsets, noisy-neighbor flags, recovery excursions) within
  ``lookback_s`` and emitted with the matched event kind on the bounded
  ``notebook_changepoints_total{series,matched}`` counter.

Both halves run off injected clocks only (the detector consumes TSDB
sample timestamps, never a wall clock), hold no locks during reconcile
(the Manager feed is one deque append), and degrade to partial verdicts
when a stream is absent — a missing component never raises.

Served at ``/debug/explain?object=ns/name`` and ``/debug/changepoints``
(loopback only), summarized in ``/debug/fleet``, and captured by
``ops/diagnose`` (``export()`` is the bundle's section), so both
verdicts reconstruct offline from a bundle (``changepoints_from_bundle``
re-runs the detector over the bundle's raw curves).
"""

from __future__ import annotations

from collections import deque
from typing import Optional

from .metrics import Registry

# Closed cause taxonomy: every explainer verdict names one of these, so
# operators (and the chaos soak) can assert on the category rather than
# parse prose.
CAUSE_FAULT_INJECTION = "fault_injection"
CAUSE_SLOW_WORKER = "slow_worker"
CAUSE_PRIMARY_FAILOVER = "primary_failover"
CAUSE_NOISY_NEIGHBOR = "noisy_neighbor"
CAUSE_RECOVERY = "recovery"
CAUSE_COLD_SCHEDULE = "cold_schedule"
CAUSE_SHARD_HANDOFF = "shard_handoff"
CAUSE_QUEUE_BACKLOG = "queue_backlog"
CAUSE_NOMINAL = "nominal"

CAUSES = (
    CAUSE_FAULT_INJECTION, CAUSE_SLOW_WORKER, CAUSE_PRIMARY_FAILOVER,
    CAUSE_NOISY_NEIGHBOR, CAUSE_RECOVERY, CAUSE_COLD_SCHEDULE,
    CAUSE_SHARD_HANDOFF, CAUSE_QUEUE_BACKLOG, CAUSE_NOMINAL,
)

# Closed event-kind vocabulary for the discrete timeline — doubles as the
# bounded `matched` label set on notebook_changepoints_total.
EVENT_FAULT = "fault"
EVENT_PROMOTION = "promotion"
EVENT_RECOVERY = "recovery"
EVENT_SHARD_EPOCH = "shard_epoch"
EVENT_NOISY_NEIGHBOR = "noisy_neighbor"
EVENT_SLOW_WORKER = "slow_worker"
EVENT_WARMPOOL_RESIZE = "warmpool_resize"
MATCH_NONE = "none"

EVENT_KINDS = (
    EVENT_FAULT, EVENT_PROMOTION, EVENT_RECOVERY, EVENT_SHARD_EPOCH,
    EVENT_NOISY_NEIGHBOR, EVENT_SLOW_WORKER, EVENT_WARMPOOL_RESIZE,
)

# When a shift window correlates with events of several kinds, the most
# causally-specific kind wins the `matched` label (a fault plan explains
# a promotion better than the reverse).
_KIND_PRIORITY = {k: i for i, k in enumerate((
    EVENT_FAULT, EVENT_PROMOTION, EVENT_SLOW_WORKER, EVENT_NOISY_NEIGHBOR,
    EVENT_SHARD_EPOCH, EVENT_WARMPOOL_RESIZE, EVENT_RECOVERY))}

# TSDB series the detector watches (plus every `stage_p99.<stage>` series
# — the stage vocabulary is closed, so the label set stays bounded).
WATCHED_SERIES = (
    "ready_p99_s", "event_to_reconcile_p99_s", "workqueue_depth",
    "workqueue_backoff_pending", "criticalpath_violations",
    "metering_violations", "dataplane_stragglers",
    "reconcile_errors_delta", "promotions_delta",
)
_STAGE_PREFIX = "stage_p99."


def register_diagnosis_metrics(registry: Registry) -> dict:
    """The diagnosis family (registered by NotebookMetrics so the
    inventory is stable whether or not an engine is attached; the engine
    re-registers identically and gets the same object back)."""
    return {
        "changepoints": registry.counter(
            "notebook_changepoints_total",
            "Level shifts detected in watched TSDB series, labeled by "
            "series and the correlated discrete-event kind "
            "(see /debug/changepoints)",
            labels=("series", "matched")),
    }


def watched_series(name: str) -> bool:
    """Whether the detector tracks this TSDB series."""
    return name in WATCHED_SERIES or name.startswith(_STAGE_PREFIX)


class _LevelLatch:
    """Per-series level-shift state machine (see module docstring).

    ``push(t, v)`` returns a finding dict when the tail-window mean has
    shifted past the threshold, else None; the latch then re-anchors at
    the new level so one shift yields exactly one finding.
    """

    def __init__(self, window: int = 5, shift_factor: float = 4.0,
                 rel_factor: float = 0.25, min_abs: float = 0.5) -> None:
        if window < 2:
            raise ValueError("window must be >= 2")
        self.window = window
        self.shift_factor = shift_factor
        self.rel_factor = rel_factor
        self.min_abs = min_abs
        self.level: Optional[float] = None
        self.spread = 0.0
        self._tail: deque = deque(maxlen=window)

    def _threshold(self) -> float:
        return max(self.min_abs, self.shift_factor * self.spread,
                   self.rel_factor * abs(self.level))

    def push(self, t: float, v: float) -> Optional[dict]:
        self._tail.append((float(t), float(v)))
        if len(self._tail) < self.window:
            return None
        values = [p[1] for p in self._tail]
        mean = sum(values) / len(values)
        dev = max(abs(x - mean) for x in values)
        if self.level is None:
            # first full window latches the baseline
            self.level = mean
            self.spread = dev
            return None
        delta = mean - self.level
        if abs(delta) <= self._threshold():
            # quiet: let the spread estimate relax toward the current
            # noise amplitude so a settled post-shift series re-arms
            self.spread = min(self.spread, dev)
            return None
        finding = {
            "t_start": self._tail[0][0],
            "t_end": self._tail[-1][0],
            "baseline": self.level,
            "level": mean,
            "delta": delta,
            "direction": "up" if delta > 0 else "down",
        }
        # re-latch at the NEWEST point (where the series is heading, not
        # the transition-straddling tail mean) with the spread measured
        # around it, so the settling half of a step is suppressed and one
        # shift yields exactly one finding
        newest = self._tail[-1][1]
        self.level = newest
        self.spread = max(abs(x - newest) for x in values)
        return finding


def detect_level_shifts(points, *, window: int = 5,
                        shift_factor: float = 4.0, rel_factor: float = 0.25,
                        min_abs: float = 0.5) -> list[dict]:
    """Offline detector: run the level latch over a full raw series
    (``[[t, v], ...]``) and return every shift.  Same math as the online
    engine, so a diagnose bundle's curves reconstruct the live verdicts."""
    latch = _LevelLatch(window=window, shift_factor=shift_factor,
                        rel_factor=rel_factor, min_abs=min_abs)
    out = []
    for point in points:
        t, v = point[0], point[1]
        hit = latch.push(t, v)
        if hit is not None:
            out.append(hit)
    return out


def correlate_events(events, t_start: float, t_end: float,
                     lookback_s: float = 120.0) -> list[dict]:
    """Discrete-timeline events that could explain a shift window:
    anything from ``lookback_s`` before the window opened through its
    end (causes precede or accompany their symptoms)."""
    lo, hi = t_start - lookback_s, t_end
    return [e for e in events if lo <= e["t"] <= hi]


def matched_kind(matched: list[dict]) -> str:
    """The bounded `matched` label: the most causally-specific event
    kind in the correlation window, or "none"."""
    if not matched:
        return MATCH_NONE
    return min((e["kind"] for e in matched),
               key=lambda k: _KIND_PRIORITY.get(k, len(_KIND_PRIORITY)))


class DiagnosisEngine:
    """See module docstring.  One engine serves a whole sharded fleet
    (every replica's manager points at the same object, exactly like the
    lifecycle ledger)."""

    def __init__(self, clock, *, registry: Optional[Registry] = None,
                 recorder=None, lifecycle=None, slo_engine=None,
                 metering=None, tsdb=None, dataplane=None, fleet=None,
                 api=None,
                 window: int = 5, shift_factor: float = 4.0,
                 rel_factor: float = 0.25, min_abs: float = 0.5,
                 lookback_s: float = 120.0,
                 max_findings: int = 256, max_events: int = 512) -> None:
        self.clock = clock
        self.recorder = recorder
        self.lifecycle = lifecycle
        self.slo_engine = slo_engine
        self.metering = metering
        self.tsdb = tsdb
        self.dataplane = dataplane
        self.fleet = fleet
        self.api = api
        self.window = window
        self.shift_factor = shift_factor
        self.rel_factor = rel_factor
        self.min_abs = min_abs
        self.lookback_s = lookback_s
        self.max_findings = max_findings
        self.max_events = max_events
        self._registry = registry
        self._counter = (register_diagnosis_metrics(registry)["changepoints"]
                         if registry is not None else None)
        self._latches: dict[str, _LevelLatch] = {}
        self._consumed: dict[str, float] = {}
        self._events: deque = deque(maxlen=max_events)
        self._findings: deque = deque(maxlen=max_findings)
        self._seq = 0
        self.evaluations = 0
        # diff state for the discrete feeds
        self._last_epoch: Optional[int] = None
        self._last_flagged: set = set()
        self._last_stragglers: set = set()
        self._last_warmpool: Optional[float] = None

    # -- discrete event timeline (write side) ---------------------------------
    def _push_event(self, t: float, kind: str, detail: str,
                    object_key: str = "", trace_id: str = "") -> None:
        if self._events:
            last = self._events[-1]
            if (last["kind"] == kind and last["object"] == object_key
                    and last["detail"] == detail
                    and abs(t - last["t"]) <= 5.0):
                last["count"] += 1
                last["t"] = t
                return
        self._events.append({
            "t": t, "kind": kind, "detail": detail,
            "object": object_key, "trace_id": trace_id, "count": 1,
        })

    def observe_attempt(self, rec) -> None:
        """Manager feed (same call site as the SLO engine / ledger /
        metering): mine one finished attempt for discrete evidence.
        Must never raise into the reconcile loop."""
        if rec is None:
            return
        t = rec.end_time
        for fault in rec.faults or ():
            detail = str(fault.get("fault.rule")
                         or fault.get("fault.action") or "injected")
            self._push_event(t, EVENT_FAULT, detail, rec.object_key,
                             rec.trace_id)
        phases = rec.phases or {}
        # presence, not duration: a FakeClock promotion completes in zero
        # span time and is still a promotion
        if "promote" in phases:
            self._push_event(t, EVENT_PROMOTION,
                             f"promote {phases['promote']:.3f}s",
                             rec.object_key, rec.trace_id)
        if "recover" in phases or "migrate" in phases:
            dur = phases.get("recover", 0.0) + phases.get("migrate", 0.0)
            self._push_event(t, EVENT_RECOVERY, f"recover {dur:.3f}s",
                             rec.object_key, rec.trace_id)

    def _observe_discrete(self, now: float) -> None:
        """Diff the slow-moving control-plane surfaces into timeline
        events (called once per evaluation, off the injected clock)."""
        if self.fleet is not None:
            try:
                epoch = int(self.fleet.shard_snapshot().get("epoch", 0))
            except Exception:  # noqa: BLE001 — evidence is best-effort
                epoch = self._last_epoch
            if epoch is not None and epoch != self._last_epoch:
                if self._last_epoch is not None:
                    self._push_event(
                        now, EVENT_SHARD_EPOCH,
                        f"epoch {self._last_epoch}->{epoch}")
                self._last_epoch = epoch
        if self.metering is not None:
            try:
                flagged = set(self.metering.flagged())
            except Exception:  # noqa: BLE001
                flagged = self._last_flagged
            for ns in sorted(flagged - self._last_flagged):
                self._push_event(now, EVENT_NOISY_NEIGHBOR,
                                 f"tenant {ns} flagged noisy")
            self._last_flagged = flagged
        if self.dataplane is not None:
            # the scrape path already ran dataplane.evaluate() this cycle;
            # read its latched result rather than re-evaluating (which
            # would double the aggregator's check counters)
            last = getattr(self.dataplane, "_last", None) or {}
            stragglers = {
                (s["namespace"], s["name"], s["worker"])
                for s in last.get("stragglers", ())}
            for ns, nb, worker in sorted(stragglers
                                         - self._last_stragglers):
                self._push_event(now, EVENT_SLOW_WORKER,
                                 f"worker {worker} straggling",
                                 f"{ns}/{nb}")
            self._last_stragglers = stragglers
        if self._registry is not None:
            gauge = self._registry.get("notebook_warmpool_size")
            if gauge is not None:
                try:
                    size = sum(gauge.collect().values())
                except Exception:  # noqa: BLE001
                    size = self._last_warmpool
                if size is not None and size != self._last_warmpool:
                    if self._last_warmpool is not None:
                        self._push_event(
                            now, EVENT_WARMPOOL_RESIZE,
                            f"warm pool {self._last_warmpool:g}"
                            f"->{size:g}")
                    self._last_warmpool = size

    # -- change-point detection (evaluate side) -------------------------------
    def evaluate(self) -> list[dict]:
        """One detection round (called from the scrape path after the
        TSDB sample lands, and from /debug/changepoints): consume new
        raw points per watched series, emit one finding per shift."""
        self.evaluations += 1
        now = self.clock.now()
        self._observe_discrete(now)
        new: list[dict] = []
        if self.tsdb is None:
            return new
        for name in self.tsdb.series_names():
            if not watched_series(name):
                continue
            points = self.tsdb.query(name, tier="raw").get("points") or []
            latch = self._latches.get(name)
            if latch is None:
                latch = self._latches[name] = _LevelLatch(
                    window=self.window, shift_factor=self.shift_factor,
                    rel_factor=self.rel_factor, min_abs=self.min_abs)
            consumed = self._consumed.get(name)
            for t, v in points:
                if consumed is not None and t <= consumed:
                    continue
                hit = latch.push(t, v)
                if hit is not None:
                    new.append(self._emit(name, hit, now))
            if points:
                self._consumed[name] = points[-1][0]
        return new

    def _emit(self, series: str, hit: dict, now: float) -> dict:
        matched = correlate_events(list(self._events), hit["t_start"],
                                   hit["t_end"], self.lookback_s)
        kind = matched_kind(matched)
        alerts = []
        if self.slo_engine is not None:
            try:
                alerts = sorted(a.objective
                                for a in self.slo_engine.firing())
            except Exception:  # noqa: BLE001
                alerts = []
        self._seq += 1
        finding = dict(hit)
        finding.update({
            "seq": self._seq, "series": series, "detected_at": now,
            "matched": kind,
            "events": matched[-8:],
            "alerts": alerts,
        })
        self._findings.append(finding)
        if self._counter is not None:
            self._counter.labels(series, kind).inc()
        return finding

    def findings(self) -> list[dict]:
        return list(self._findings)

    # -- per-notebook explainer -----------------------------------------------
    def _object_events(self, namespace: str, name: str) -> list[dict]:
        """Warning/Normal Events recorded against the notebook (apiserver
        read; best-effort)."""
        if self.api is None:
            return []
        try:
            out = []
            for ev in self.api.list("Event", namespace=namespace):
                inv = ev.body.get("involvedObject") or {}
                if inv.get("name") == name:
                    out.append({
                        "reason": ev.body.get("reason", ""),
                        "type": ev.body.get("type", ""),
                        "message": ev.body.get("message", ""),
                        "count": ev.body.get("count", 1),
                    })
            return out[-16:]
        except Exception:  # noqa: BLE001
            return []

    def _fleet_p50_ready(self) -> float:
        """Fleet median ready time from the ledger's namespace rollup
        (the symptom link's baseline)."""
        if self.lifecycle is None:
            return 0.0
        try:
            walls = []
            for agg in self.lifecycle.namespace_rollup().values():
                if agg.get("ready_count"):
                    walls.append(agg.get("ready_mean_s", 0.0))
            if not walls:
                return 0.0
            walls.sort()
            return walls[len(walls) // 2]
        except Exception:  # noqa: BLE001
            return 0.0

    def explain(self, namespace: str, name: str) -> dict:
        """The ranked causal chain for one notebook (see module
        docstring).  Never raises: an unknown object returns a verdict-
        less body with an "error" field."""
        key = f"{namespace}/{name}"
        now = self.clock.now()
        attempts = []
        if self.recorder is not None:
            try:
                attempts = self.recorder.attempts(key)
            except Exception:  # noqa: BLE001
                attempts = []
        entry = None
        excursions = []
        if self.lifecycle is not None:
            try:
                entry = self.lifecycle.latest_entry(namespace, name)
            except Exception:  # noqa: BLE001
                entry = None
            try:
                excursions = self.lifecycle.excursions(namespace, name)
            except Exception:  # noqa: BLE001
                excursions = []
        base = {"object": key, "generated_at": now, "cause": "",
                "verdict": "", "chain": [], "candidates": []}
        if not attempts and entry is None:
            base["error"] = "no recorded evidence for object"
            return base

        status = self._object_status(namespace, name)
        events = self._object_events(namespace, name)
        trace_ids = {a.trace_id for a in attempts if a.trace_id}
        if entry and entry.get("trace_id"):
            trace_ids.add(entry["trace_id"])

        candidates = self._rank(key, attempts, entry, excursions, status,
                                events)
        chain = self._chain(key, attempts, entry, candidates)
        top = candidates[0]
        base.update({
            "cause": top["cause"],
            "verdict": " <= ".join(link["claim"] for link in chain),
            "chain": chain,
            "candidates": candidates,
            "evidence": {
                "attempts": len(attempts),
                "trace_ids": sorted(trace_ids)[:8],
                "entry": entry,
                "excursions": excursions[-8:],
                "status": status,
                "events": events,
                "alerts": self._object_alerts(trace_ids),
            },
        })
        return base

    def _object_status(self, namespace: str, name: str) -> dict:
        if self.api is None:
            return {}
        try:
            nb = self.api.try_get("Notebook", namespace, name)
            if nb is None:
                return {}
            st = nb.status
            out = {}
            for field_name in ("sessionState", "sliceRecovery"):
                if st.get(field_name):
                    out[field_name] = st.get(field_name)
            repl = st.get("replication") or {}
            if repl.get("promotion"):
                out["promotion"] = repl["promotion"]
            if "primary" in repl:
                out["primary"] = repl["primary"]
            return out
        except Exception:  # noqa: BLE001
            return {}

    def _object_alerts(self, trace_ids: set) -> list[str]:
        """Firing SLO objectives whose latched exemplar is one of this
        object's traces."""
        if self.slo_engine is None:
            return []
        try:
            return sorted(a.objective for a in self.slo_engine.firing()
                          if a.trace_id and a.trace_id in trace_ids)
        except Exception:  # noqa: BLE001
            return []

    def _rank(self, key: str, attempts, entry, excursions, status,
              events) -> list[dict]:
        """Deterministic candidate ranking.  Direct evidence scores
        ``10 + x``; stage-share inference scores ``share`` (<= 1);
        ``nominal`` floors the list so there is always a verdict."""
        stages = dict((entry or {}).get("stages") or {})
        wall = (entry or {}).get("wall_s") or 0.0
        grand = sum(stages.values()) or wall or 1.0
        candidates = []

        fault_attempts = [a for a in attempts if a.faults]
        if fault_attempts:
            n = sum(len(a.faults) for a in fault_attempts)
            rules = sorted({str(f.get("fault.rule", "injected"))
                            for a in fault_attempts for f in a.faults})
            candidates.append({
                "cause": CAUSE_FAULT_INJECTION,
                "score": 10.0 + min(n, 100) / 100.0,
                "detail": (f"fault plan {'/'.join(rules[:3])} injected "
                           f"{n} faults across "
                           f"{len(fault_attempts)} attempts"),
                "evidence": {"trace_id": fault_attempts[-1].trace_id,
                             "faults": n, "rules": rules[:8]},
            })

        straggler = self._straggler_for(key)
        if straggler is not None:
            candidates.append({
                "cause": CAUSE_SLOW_WORKER,
                "score": 10.0 + min(straggler.get("ratio", 0.0), 10.0) / 10.0,
                "detail": (f"worker {straggler.get('worker', '?')} step time "
                           f"{straggler.get('step_time_s', 0.0):.3f}s is "
                           f"{straggler.get('ratio', 0.0):.1f}x the slice "
                           "median"),
                "evidence": {"straggler": straggler, "metric":
                             "notebook_dataplane_step_time_seconds"},
            })

        promote_s = stages.get("promote", 0.0) + sum(
            x["duration_s"] for x in excursions if x["stage"] == "promote")
        if promote_s > 0.0 or status.get("promotion"):
            ex = next((x for x in reversed(excursions)
                       if x["stage"] == "promote"), None)
            candidates.append({
                "cause": CAUSE_PRIMARY_FAILOVER,
                "score": 10.0 + min(promote_s, 100.0) / 100.0,
                "detail": (f"primary failover: follower promoted in "
                           f"{promote_s:.3f}s"),
                "evidence": {"promotion": status.get("promotion"),
                             "trace_id": (ex or {}).get("trace_id", "")},
            })

        flagged = set()
        if self.metering is not None:
            try:
                flagged = set(self.metering.flagged())
            except Exception:  # noqa: BLE001
                flagged = set()
        ns = key.split("/", 1)[0]
        noisy_others = sorted(flagged - {ns})
        if noisy_others:
            candidates.append({
                "cause": CAUSE_NOISY_NEIGHBOR,
                "score": 9.0,
                "detail": (f"tenant {noisy_others[0]} flagged noisy while "
                           "this notebook queued"),
                "evidence": {"flagged": noisy_others,
                             "metric":
                             "notebook_tenant_fairness_checks_total"},
            })

        recover_s = (stages.get("recover", 0.0)
                     + stages.get("recovery_wait", 0.0)
                     + sum(x["duration_s"] for x in excursions
                           if x["stage"] in ("recover", "migrate")))
        if recover_s > 0.0 or status.get("sliceRecovery"):
            candidates.append({
                "cause": CAUSE_RECOVERY,
                "score": min(recover_s / grand, 1.0) + (
                    0.5 if status.get("sliceRecovery") else 0.0),
                "detail": f"slice recovery consumed {recover_s:.3f}s",
                "evidence": {"sliceRecovery": status.get("sliceRecovery"),
                             "seconds": recover_s},
            })

        cold_s = stages.get("schedule_cold", 0.0)
        if cold_s > 0.0:
            candidates.append({
                "cause": CAUSE_COLD_SCHEDULE,
                "score": cold_s / grand,
                "detail": (f"schedule_cold {cold_s:.3f}s "
                           f"({cold_s / grand:.0%} of wall): warm-pool "
                           "miss, gang provisioned cold"),
                "evidence": {"stage": "schedule_cold", "seconds": cold_s,
                             "metric": "notebook_warmpool_hits_total"},
            })

        handoff_s = stages.get("handoff_wait", 0.0)
        if handoff_s > 0.0:
            bump = 0.5 if any(e["kind"] == EVENT_SHARD_EPOCH
                              for e in self._events) else 0.0
            candidates.append({
                "cause": CAUSE_SHARD_HANDOFF,
                "score": handoff_s / grand + bump,
                "detail": (f"handoff_wait {handoff_s:.3f}s waiting for "
                           "shard ownership transfer"),
                "evidence": {"stage": "handoff_wait",
                             "seconds": handoff_s},
            })

        queue_s = (stages.get("queue_wait", 0.0)
                   + stages.get("retry_backoff", 0.0))
        if queue_s > 0.0:
            candidates.append({
                "cause": CAUSE_QUEUE_BACKLOG,
                "score": queue_s / grand,
                "detail": (f"queue_wait+retry_backoff {queue_s:.3f}s "
                           "behind the workqueue"),
                "evidence": {"seconds": queue_s,
                             "metric": "workqueue_depth"},
            })

        candidates.append({
            "cause": CAUSE_NOMINAL,
            "score": 0.01,
            "detail": (f"ready in {wall:.3f}s" if wall
                       else "no ready window recorded"),
            "evidence": {"wall_s": wall},
        })
        candidates.sort(key=lambda c: (-c["score"], c["cause"]))
        return candidates

    def _straggler_for(self, key: str) -> Optional[dict]:
        if self.dataplane is None:
            return None
        last = getattr(self.dataplane, "_last", None) or {}
        for s in last.get("stragglers", ()):
            if f"{s['namespace']}/{s['name']}" == key:
                return dict(s)
        return None

    def _chain(self, key: str, attempts, entry, candidates) -> list[dict]:
        """Symptom <= binding stage <= cause <= correlation, each link
        citing its evidence."""
        chain = []
        wall = (entry or {}).get("wall_s") or 0.0
        trace = ((entry or {}).get("trace_id")
                 or (attempts[-1].trace_id if attempts else ""))
        p50 = self._fleet_p50_ready()
        if wall:
            claim = f"ready {wall:.1f}s"
            if p50:
                claim += f" vs fleet p50 {p50:.1f}s"
            chain.append({"claim": claim, "evidence": {
                "trace_id": trace, "metric": "notebook_ready_seconds"}})
        else:
            dur = attempts[-1].duration_s if attempts else 0.0
            chain.append({
                "claim": f"last attempt {dur:.3f}s, not ready",
                "evidence": {"trace_id": trace}})
        stages = dict((entry or {}).get("stages") or {})
        if stages:
            binding = max(sorted(stages), key=lambda s: stages[s])
            share = stages[binding] / (sum(stages.values()) or 1.0)
            chain.append({
                "claim": (f"{binding} {stages[binding]:.1f}s "
                          f"({share:.0%} of wall)"),
                "evidence": {"trace_id": trace,
                             "metric": "notebook_stage_duration_seconds"},
            })
        top = candidates[0]
        if top["cause"] != CAUSE_NOMINAL:
            chain.append({"claim": top["detail"],
                          "evidence": top["evidence"]})
        correlated = self._correlated_finding(entry, attempts)
        if correlated is not None:
            chain.append({
                "claim": (f"change point in {correlated['series']} "
                          f"({correlated['direction']} "
                          f"{correlated['baseline']:.2f}"
                          f"->{correlated['level']:.2f}) at "
                          f"t={correlated['t_start']:.0f}"),
                "evidence": {"series": correlated["series"],
                             "seq": correlated["seq"],
                             "matched": correlated["matched"]},
            })
        return chain

    def _correlated_finding(self, entry, attempts) -> Optional[dict]:
        """A change-point finding overlapping this object's activity
        window, preferring the most recent."""
        if not self._findings:
            return None
        lo = hi = None
        if entry and entry.get("cause_ts"):
            lo = entry["cause_ts"]
            hi = entry.get("ready_ts") or self.clock.now()
        elif attempts:
            lo = attempts[0].start_time
            hi = attempts[-1].end_time
        if lo is None:
            return None
        for f in reversed(self._findings):
            if f["t_start"] <= hi + self.lookback_s \
                    and f["t_end"] >= lo - self.lookback_s:
                return f
        return None

    # -- alert annotation (/debug/alerts satellite) ---------------------------
    def one_line_cause(self, trace_id: str) -> str:
        """The explainer's one-line verdict for the object owning a
        trace, or "" — never an error (the /debug/alerts contract)."""
        try:
            if not trace_id or self.recorder is None:
                return ""
            for rec in reversed(self.recorder.attempts()):
                if rec.trace_id == trace_id:
                    ns, _, name = rec.object_key.partition("/")
                    return self.explain(ns, name).get("verdict", "")
            return ""
        except Exception:  # noqa: BLE001
            return ""

    def annotate_alerts(self, snapshot: dict) -> dict:
        """Return the SLO snapshot with a `diagnosis` line attached to
        each firing alert's exemplar trace."""
        try:
            out = dict(snapshot)
            firing = []
            for alert in out.get("firing", []):
                a = dict(alert)
                a["diagnosis"] = self.one_line_cause(a.get("trace_id", ""))
                firing.append(a)
            out["firing"] = firing
            return out
        except Exception:  # noqa: BLE001
            return snapshot

    # -- read side (/debug/changepoints, /debug/fleet, ops.diagnose) ----------
    def snapshot(self) -> dict:
        """The /debug/changepoints body."""
        return {
            "enabled": True,
            "evaluations": self.evaluations,
            "params": {
                "window": self.window, "shift_factor": self.shift_factor,
                "rel_factor": self.rel_factor, "min_abs": self.min_abs,
                "lookback_s": self.lookback_s,
            },
            "bounds": {"max_findings": self.max_findings,
                       "max_events": self.max_events},
            "watched": sorted(self._latches),
            "changepoints": list(self._findings),
            "timeline": list(self._events),
        }

    def fleet_summary(self) -> dict:
        """The /debug/fleet `diagnosis` section (kept light)."""
        return {
            "evaluations": self.evaluations,
            "changepoints": len(self._findings),
            "timeline_events": len(self._events),
            "recent": list(self._findings)[-5:],
        }

    def export(self, max_objects: int = 64) -> dict:
        """The ops/diagnose bundle section: the snapshot plus a verdict
        per recorded object, so explanations reconstruct offline."""
        out = self.snapshot()
        explanations = {}
        if self.recorder is not None:
            try:
                keys = sorted(self.recorder.objects())[:max_objects]
            except Exception:  # noqa: BLE001
                keys = []
            for key in keys:
                ns, _, name = key.partition("/")
                explanations[key] = self.explain(ns, name)
        out["explanations"] = explanations
        return out

    def clear(self) -> None:
        self._latches.clear()
        self._consumed.clear()
        self._events.clear()
        self._findings.clear()
        self._seq = 0
        self.evaluations = 0
        self._last_epoch = None
        self._last_flagged = set()
        self._last_stragglers = set()
        self._last_warmpool = None


def changepoints_from_bundle(bundle: dict, *, window: int = 5,
                             shift_factor: float = 4.0,
                             rel_factor: float = 0.25, min_abs: float = 0.5,
                             lookback_s: float = 120.0) -> list[dict]:
    """Offline reconstruction: re-run the detector over a diagnose
    bundle's raw TSDB curves and correlate against the bundle's captured
    discrete timeline — the same verdicts the live engine emitted."""
    series = (bundle.get("timeline") or {}).get("series") or {}
    events = (bundle.get("diagnosis") or {}).get("timeline") or []
    out = []
    for name in sorted(series):
        if not watched_series(name):
            continue
        raw = series[name].get("raw") or []
        for hit in detect_level_shifts(raw, window=window,
                                       shift_factor=shift_factor,
                                       rel_factor=rel_factor,
                                       min_abs=min_abs):
            matched = correlate_events(events, hit["t_start"], hit["t_end"],
                                       lookback_s)
            finding = dict(hit)
            finding.update({"series": name,
                            "matched": matched_kind(matched),
                            "events": matched[-8:]})
            out.append(finding)
    return out


def merge_timelines(bundles: list[dict]) -> dict:
    """`ops/diagnose --merge` satellite: fold each bundle's TSDB capture
    into one merged per-series curve, timestamp-sorted with a per-replica
    source tag, so sharded-fleet change-point analysis works offline
    across per-replica bundles."""
    merged: dict[str, list] = {}
    sources = []
    for i, bundle in enumerate(bundles):
        source = str(bundle.get("source") or f"bundle-{i}")
        sources.append(source)
        series = (bundle.get("timeline") or {}).get("series") or {}
        for name, tiers in series.items():
            for t, v in tiers.get("raw") or []:
                merged.setdefault(name, []).append(
                    {"t": t, "v": v, "source": source})
    for points in merged.values():
        points.sort(key=lambda p: (p["t"], p["source"]))
    return {
        "sources": sources,
        "series": {name: merged[name] for name in sorted(merged)},
        "points_total": sum(len(p) for p in merged.values()),
    }


__all__ = [
    "CAUSES", "CAUSE_COLD_SCHEDULE", "CAUSE_FAULT_INJECTION",
    "CAUSE_NOISY_NEIGHBOR", "CAUSE_NOMINAL", "CAUSE_PRIMARY_FAILOVER",
    "CAUSE_QUEUE_BACKLOG", "CAUSE_RECOVERY", "CAUSE_SHARD_HANDOFF",
    "CAUSE_SLOW_WORKER", "DiagnosisEngine", "EVENT_KINDS",
    "WATCHED_SERIES", "changepoints_from_bundle", "correlate_events",
    "detect_level_shifts", "matched_kind", "merge_timelines",
    "register_diagnosis_metrics", "watched_series",
]
