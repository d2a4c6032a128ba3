"""Fleet SLO engine: objectives, multi-window burn rates, and alerts.

The port's copy of kubeflow_tpu/utils/slo.py.

The control plane has fleet-scale telemetry (latency histograms, error
counters), but that gives no *verdicts*: nothing says whether the fleet is
meeting its objectives, and nobody watched the streams between loadtest
runs.  NotebookOS (arXiv:2503.20591) argues interactive notebook
platforms live or die on control-plane reaction latency at fleet scale —
which needs a standing signal, not a post-hoc benchmark.  This module is
that signal, in the SRE error-budget formulation:

  - an **Objective** declares a target over an existing metric stream
    (p99 latency under a threshold, reconcile error rate under a cap,
    warm-pool hit rate over a floor).  Objectives come from config
    (`SLO_*` knobs, utils/config.py `default_objectives`), not code.
  - the engine snapshots the cumulative good/bad counts at each
    `evaluate()` (every /metrics scrape calls it) and computes **burn
    rates** over sliding windows (default 5m/1h) off the injected Clock:
    burn = (bad fraction in window) / (allowed bad fraction).  burn > 1
    means the error budget is being spent faster than it accrues.
  - exported families: `notebook_slo_burn_rate{objective,window}`,
    `notebook_slo_error_budget_remaining_ratio{objective}` (long
    window), and `notebook_slo_alert_firing{objective}`.
  - **alerts** follow the multi-window multi-burn pattern: fire when
    EVERY window burns above `burn_threshold` (the short window makes it
    react, the long window keeps blips from paging), resolve when the
    short window recovers.  One active alert per objective (dedup across
    scrapes); history is bounded; each alert latches an exemplar
    trace_id from the attempt stream the Manager feeds
    (`observe_attempt`), so an alert pivots straight into the flight
    recorder (`/debug/traces/<trace_id>`).

Everything reads the injected clock and existing Registry objects — the
engine adds no locks to the reconcile path and costs O(objectives ×
windows) per evaluation.  Served at loopback `/debug/alerts` (main.py).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from .metrics import Histogram, Registry

# objective kinds (bounded set: the `objective` metric label enumerates
# the configured objective NAMES, the kinds just drive the math)
KIND_LATENCY = "latency"      # histogram: p(target_ratio) <= threshold_s
KIND_RATIO = "ratio"          # labeled counter: bad subset under budget


@dataclass(frozen=True)
class Objective:
    """One declared objective over an existing metric family.

    `target_ratio` is the good fraction the SLO promises (0.99 = p99 for
    latency objectives; 1 - max_error_rate for ratio objectives); the
    error budget is `1 - target_ratio` of events per window.

    latency kind: `metric` names a Histogram; an observation is good
    when it lands at or under `threshold_s` (snapped to the nearest
    bucket upper bound >= threshold, the finest the exposition can
    answer; a threshold above every bound counts everything good).

    ratio kind: `metric` names a labeled Counter; `label` selects the
    label dimension, `bad_values` the label values that spend budget,
    and `total_values` restricts the denominator (None = every series,
    e.g. error-rate counts all results; a hit-rate objective counts only
    hit+miss so bypasses are neutral)."""

    name: str
    kind: str
    metric: str
    description: str = ""
    target_ratio: float = 0.99
    threshold_s: float = 0.0                      # latency kind
    label: str = ""                               # ratio kind
    bad_values: tuple[str, ...] = ()              # ratio kind
    total_values: Optional[tuple[str, ...]] = None  # ratio kind

    @property
    def budget_fraction(self) -> float:
        return max(1.0 - self.target_ratio, 1e-9)


@dataclass
class Alert:
    """One fire->resolve lifecycle of an objective's burn alert."""

    objective: str
    fired_at: float
    state: str = "firing"         # firing | resolved
    resolved_at: float = 0.0
    burn_rates: dict = field(default_factory=dict)  # window label -> burn
    trace_id: str = ""            # exemplar: a budget-spending attempt
    seq: int = 0                  # monotonic per engine (dedup audit)

    def to_dict(self) -> dict:
        return {
            "objective": self.objective,
            "state": self.state,
            "fired_at": self.fired_at,
            "resolved_at": self.resolved_at,
            "burn_rates": dict(self.burn_rates),
            "trace_id": self.trace_id,
            "seq": self.seq,
        }


def window_label(seconds: float) -> str:
    """Human window label for the metric ("5m", "1h"), stable for
    dashboards; falls back to seconds for odd sizes."""
    s = int(seconds)
    if s >= 3600 and s % 3600 == 0:
        return f"{s // 3600}h"
    if s >= 60 and s % 60 == 0:
        return f"{s // 60}m"
    return f"{seconds:g}s"


def register_slo_metrics(registry: Registry) -> tuple:
    """The SLO metric families (registered by NotebookMetrics so the
    inventory is stable whether or not an engine is attached; the engine
    re-registers identically and gets the same objects back)."""
    burn = registry.gauge(
        "notebook_slo_burn_rate",
        "Error-budget burn rate per objective and sliding window "
        "(1.0 = spending exactly the budget)",
        labels=("objective", "window"))
    remaining = registry.gauge(
        "notebook_slo_error_budget_remaining_ratio",
        "Fraction of the long-window error budget left per objective "
        "(negative = overspent)",
        labels=("objective",))
    firing = registry.gauge(
        "notebook_slo_alert_firing",
        "Whether the burn alert of an objective is currently firing",
        labels=("objective",))
    return burn, remaining, firing


def default_objectives(cfg) -> tuple[Objective, ...]:
    """The standing fleet objectives, from CoreConfig's SLO_* knobs; a
    knob <= 0 disables its objective.  The warm-pool objective only
    exists when the slice scheduler is on (no pool, no hit rate)."""
    out = []
    if cfg.slo_time_to_ready_p99_s > 0:
        out.append(Objective(
            name="time_to_ready", kind=KIND_LATENCY,
            metric="notebook_to_ready_seconds",
            threshold_s=cfg.slo_time_to_ready_p99_s,
            description="p99 notebook creation -> all workers Ready"))
    if cfg.slo_event_to_reconcile_p99_s > 0:
        out.append(Objective(
            name="event_to_reconcile", kind=KIND_LATENCY,
            metric="notebook_event_to_reconcile_seconds",
            threshold_s=cfg.slo_event_to_reconcile_p99_s,
            description="p99 watch event -> reconcile start (control-"
                        "plane reaction latency)"))
    if cfg.slo_reconcile_error_rate > 0:
        out.append(Objective(
            name="reconcile_errors", kind=KIND_RATIO,
            metric="controller_runtime_reconcile_total",
            target_ratio=1.0 - cfg.slo_reconcile_error_rate,
            label="result", bad_values=("error",),
            description="reconcile attempts ending in error"))
    if cfg.slo_recovery_p99_s > 0:
        out.append(Objective(
            name="recovery_duration", kind=KIND_LATENCY,
            metric="notebook_disruption_recovery_seconds",
            threshold_s=cfg.slo_recovery_p99_s,
            description="p99 disruption detection -> slice Healthy"))
    # replicated-kernel objective (core/selfheal.py promote verb): the
    # tier's promise is sub-second failover, so the default ceiling is
    # 1s — an election that has to wait out follower catch-up or a
    # contended promotion record burns this budget
    if cfg.slo_promotion_p99_s > 0:
        out.append(Objective(
            name="promotion_duration", kind=KIND_LATENCY,
            metric="notebook_promotion_duration_seconds",
            threshold_s=cfg.slo_promotion_p99_s,
            description="p99 primary disruption -> follower promoted "
                        "(replicated notebooks)"))
    # time-to-placement objective (core/scheduler.py tenancy admission):
    # notebook_queue_wait_seconds observes EVERY placement (0 for gangs
    # that never queued), so its p99 under the ceiling is exactly "a
    # gang's wait behind quota/fair share/preemption stays bounded" —
    # the starvation alarm for the priority/queue machinery
    if getattr(cfg, "slo_placement_p99_s", 0.0) > 0:
        out.append(Objective(
            name="time_to_placement", kind=KIND_LATENCY,
            metric="notebook_queue_wait_seconds",
            threshold_s=cfg.slo_placement_p99_s,
            description="p99 quota/fair-share queue wait before the "
                        "placement intent lands"))
    if cfg.enable_slice_scheduler and cfg.slo_warmpool_hit_rate > 0:
        out.append(Objective(
            name="warmpool_hit_rate", kind=KIND_RATIO,
            metric="notebook_warmpool_hits_total",
            target_ratio=cfg.slo_warmpool_hit_rate,
            label="result", bad_values=("miss",),
            total_values=("hit", "miss"),
            description="warm-pool claims served from a pre-provisioned "
                        "slice"))
    # sharded-control-plane objective (kube/shard.py handoff histogram):
    # knob-disabled by default — it only means something when SHARD_COUNT
    # > 1 runs an actual fleet.  A handoff that stalls (dead member not
    # yet evicted, drain ack waiting out in-flight keys) lands in a fat
    # bucket and burns this budget, firing the multi-window alert.
    if cfg.slo_shard_handoff_p99_s > 0:
        out.append(Objective(
            name="shard_handoff", kind=KIND_LATENCY,
            metric="notebook_shard_handoff_duration_seconds",
            threshold_s=cfg.slo_shard_handoff_p99_s,
            description="p99 shard-map handoff duration (membership "
                        "commit -> completing ack)"))
    # data-plane objectives (core/telemetry.py verdict counters): both
    # knob-disabled by default — they only mean something on fleets whose
    # workers actually publish telemetry annotations
    if cfg.slo_fleet_mfu > 0:
        out.append(Objective(
            name="fleet_mfu", kind=KIND_RATIO,
            metric="notebook_dataplane_mfu_checks_total",
            target_ratio=cfg.slo_fleet_mfu,
            label="result", bad_values=("low",),
            description="per-notebook MFU evaluations at or above "
                        "DATAPLANE_MFU_TARGET"))
    if cfg.slo_straggler_rate > 0:
        out.append(Objective(
            name="straggler_rate", kind=KIND_RATIO,
            metric="notebook_dataplane_straggler_checks_total",
            target_ratio=1.0 - cfg.slo_straggler_rate,
            label="result", bad_values=("straggler",),
            description="per-notebook straggler evaluations finding the "
                        "slice stepping together"))
    # tenant-fairness objective (utils/metering.py verdict counter): each
    # metering evaluation votes ok/noisy; a noisy-neighbor episode burns
    # this budget and fires an alert whose exemplar is the latched trace
    # of the flooding tenant (TenantMeteringLedger.evaluate latches it
    # via latch_exemplar).
    if getattr(cfg, "slo_tenant_fairness", 0.0) > 0:
        out.append(Objective(
            name="tenant_fairness", kind=KIND_RATIO,
            metric="notebook_tenant_fairness_checks_total",
            target_ratio=1.0 - cfg.slo_tenant_fairness,
            label="result", bad_values=("noisy",),
            description="metering rounds finding no tenant over its fair "
                        "control-plane share while others degrade"))
    return tuple(out)


class SLOEngine:
    """Windowed burn-rate computation + alert lifecycle over existing
    metric registries; see module docstring.

    `registries` are searched in order for each objective's metric (the
    NotebookMetrics registry and the Manager's reconcile registry are
    disjoint).  Snapshots accumulate only on `evaluate()` — wire it to
    the scrape path (NotebookMetrics.scrape does) and window resolution
    follows the scrape interval, which is exactly the resolution a
    Prometheus-side burn rule would have."""

    def __init__(self, objectives, registries, clock,
                 windows: tuple[float, ...] = (300.0, 3600.0),
                 burn_threshold: float = 2.0,
                 recorder=None, max_alerts: int = 256) -> None:
        self.objectives: tuple[Objective, ...] = tuple(objectives)
        self.registries = list(registries)
        self.clock = clock
        self.windows = tuple(sorted(windows))
        self.burn_threshold = burn_threshold
        self.recorder = recorder
        self._lock = threading.Lock()
        # (t, {objective: (good, bad)}) snapshots, pruned past the long
        # window (one sample older than the boundary is kept so the
        # window-start interpolation always has an anchor)
        self._samples: deque[tuple[float, dict]] = deque()
        self._active: dict[str, Alert] = {}
        self._history: deque[Alert] = deque(maxlen=max_alerts)
        self._alert_seq = 0
        self._last_eval: dict[str, dict] = {}
        self.evaluations = 0
        # exemplar latches fed by Manager via observe_attempt(): the most
        # recent budget-spending attempt per flavor, so a firing alert
        # carries a trace id that resolves in the flight recorder
        self._last_error_trace = ""
        self._slowest_trace = ""
        self._slowest_duration = -1.0
        # objective-name -> trace id latched by an external detector
        # (e.g. the tenant metering ledger when it flags a noisy
        # neighbor); checked before the generic flavor latches
        self._latched_exemplars: dict[str, str] = {}
        reg = self.registries[0] if self.registries else Registry()
        self.burn_gauge, self.remaining_gauge, self.firing_gauge = \
            register_slo_metrics(reg)
        # baseline snapshot: burn starts measuring from engine birth, not
        # from the absolute counter values of a long-lived process
        self.evaluate()

    # -- attempt feed (Manager, on flight-recorder record) --------------------
    def observe_attempt(self, rec) -> None:
        """Latch exemplar trace ids off the completed-attempt stream
        (kube/controller.py calls this with each AttemptRecord)."""
        with self._lock:
            if rec.trace_id:
                if rec.result == "error" or rec.error:
                    self._last_error_trace = rec.trace_id
                if rec.duration_s >= self._slowest_duration:
                    self._slowest_duration = rec.duration_s
                    self._slowest_trace = rec.trace_id

    def latch_exemplar(self, objective: str, trace) -> None:
        """Pin the exemplar trace a firing alert of `objective` should
        carry.  Detectors that know the concrete culprit (the metering
        ledger's noisy tenant) feed this; `trace` is a trace id string or
        a dict with a "trace_id" key."""
        trace_id = (trace.get("trace_id", "") if isinstance(trace, dict)
                    else str(trace or ""))
        if not trace_id:
            return
        with self._lock:
            self._latched_exemplars[objective] = trace_id

    # -- metric resolution ----------------------------------------------------
    def _metric(self, name: str):
        for reg in self.registries:
            m = reg.get(name)
            if m is not None:
                return m
        return None

    def _totals(self, obj: Objective) -> tuple[float, float]:
        """Cumulative (good, bad) event counts for one objective, summed
        over every label set of its metric family."""
        m = self._metric(obj.metric)
        if m is None:
            return 0.0, 0.0
        if obj.kind == KIND_LATENCY and isinstance(m, Histogram):
            # snap the threshold to the nearest bucket upper bound >= it;
            # none (threshold above the last bound) means every finite
            # observation counts good
            snap = next((b for b in m.buckets if b >= obj.threshold_s),
                        None)
            good = total = 0.0
            for key in m.collect():
                counts = m.bucket_counts(*key)
                inf = counts[float("inf")]
                total += inf
                good += counts[snap] if snap is not None else inf
            return good, total - good
        if obj.kind == KIND_RATIO:
            try:
                idx = m.label_names.index(obj.label)
            except ValueError:
                return 0.0, 0.0
            good = bad = 0.0
            for key, v in m.collect().items():
                value = key[idx]
                if obj.total_values is not None and \
                        value not in obj.total_values:
                    continue
                if value in obj.bad_values:
                    bad += v
                else:
                    good += v
            return good, bad
        return 0.0, 0.0

    def _window_start(self, name: str, since: float) -> tuple[float, float]:
        """The (good, bad) counts at the newest snapshot taken at or
        before `since`; the engine's birth snapshot anchors windows older
        than its history."""
        anchor = (0.0, 0.0)
        for t, totals in self._samples:
            if t > since:
                break
            anchor = totals.get(name, anchor)
        return anchor

    def _exemplar_for(self, obj: Objective) -> str:
        latched = self._latched_exemplars.get(obj.name, "")
        if latched:
            return latched
        if obj.kind == KIND_RATIO and obj.bad_values == ("error",):
            return self._last_error_trace
        if obj.kind == KIND_LATENCY:
            # prefer a stored histogram exemplar from a bucket above the
            # threshold (the concrete slow observation), else the slowest
            # attempt the Manager fed us
            m = self._metric(obj.metric)
            if isinstance(m, Histogram):
                for key in m.collect():
                    for bound, (labels, _v) in sorted(
                            m.exemplar(*key).items(), reverse=True):
                        if bound > obj.threshold_s and labels.get("trace_id"):
                            return labels["trace_id"]
            return self._slowest_trace
        return ""

    # -- evaluation -----------------------------------------------------------
    def evaluate(self) -> dict[str, dict]:
        """Take a snapshot, recompute burn rates / budgets / alert state,
        update the exported gauges, and return the per-objective stats.
        Deterministic under FakeClock; call it from the scrape path or
        directly in tests."""
        now = self.clock.now()
        totals = {o.name: self._totals(o) for o in self.objectives}
        with self._lock:
            self.evaluations += 1
            if self._samples and self._samples[-1][0] > now:
                # two scrapes raced: keep the sample ring start-sorted
                # (window anchoring walks it in time order)
                now = self._samples[-1][0]
            self._samples.append((now, totals))
            # prune, keeping one anchor at/just-before the long-window edge
            horizon = now - self.windows[-1]
            while len(self._samples) > 1 and self._samples[1][0] <= horizon:
                self._samples.popleft()
            out: dict[str, dict] = {}
            for obj in self.objectives:
                good_now, bad_now = totals[obj.name]
                burns: dict[str, float] = {}
                short_events = 0.0
                for w in self.windows:
                    g0, b0 = self._window_start(obj.name, now - w)
                    dg = max(good_now - g0, 0.0)
                    db = max(bad_now - b0, 0.0)
                    window_total = dg + db
                    frac_bad = db / window_total if window_total > 0 else 0.0
                    burns[window_label(w)] = frac_bad / obj.budget_fraction
                    if w == self.windows[0]:
                        short_events = window_total
                # budget remaining over the long window: 1 - spent/allowed
                g0, b0 = self._window_start(obj.name, now - self.windows[-1])
                long_total = max(good_now - g0, 0.0) + \
                    max(bad_now - b0, 0.0)
                allowed = long_total * obj.budget_fraction
                spent = max(bad_now - b0, 0.0)
                remaining = 1.0 - spent / allowed if allowed > 0 else 1.0
                remaining = max(remaining, -10.0)  # bounded for dashboards
                self._transition_alert(obj, burns, short_events, now)
                stats = {
                    "kind": obj.kind,
                    "metric": obj.metric,
                    "description": obj.description,
                    "target_ratio": obj.target_ratio,
                    "threshold_s": obj.threshold_s or None,
                    "burn_rates": burns,
                    "budget_remaining_ratio": round(remaining, 6),
                    "events_long_window": long_total,
                    "firing": obj.name in self._active,
                }
                out[obj.name] = stats
                self._last_eval[obj.name] = stats
                for label, burn in burns.items():
                    self.burn_gauge.labels(obj.name, label).set(burn)
                self.remaining_gauge.labels(obj.name).set(remaining)
                self.firing_gauge.labels(obj.name).set(
                    1.0 if obj.name in self._active else 0.0)
            # reset the slowest-latch per evaluation so a one-off outlier
            # does not pin the exemplar forever
            self._slowest_duration = -1.0
            return out

    def _transition_alert(self, obj: Objective, burns: dict[str, float],
                          short_events: float, now: float) -> None:
        """Multi-window multi-burn lifecycle (caller holds the lock):
        fire when every window burns above threshold (and the short
        window actually saw events), resolve when the short window
        recovers.  One active alert per objective — continued breach
        across scrapes dedups into the same alert; a breach after a
        resolve fires a fresh one."""
        breach = short_events > 0 and all(
            b >= self.burn_threshold for b in burns.values())
        active = self._active.get(obj.name)
        short_label = window_label(self.windows[0])
        if breach and active is None:
            self._alert_seq += 1
            alert = Alert(objective=obj.name, fired_at=now,
                          burn_rates=dict(burns),
                          trace_id=self._exemplar_for(obj),
                          seq=self._alert_seq)
            self._active[obj.name] = alert
            self._history.append(alert)
        elif active is not None:
            if burns.get(short_label, 0.0) < self.burn_threshold:
                active.state = "resolved"
                active.resolved_at = now
                del self._active[obj.name]
            else:
                # still burning: refresh the observed rates (same alert)
                active.burn_rates = dict(burns)

    # -- read side (/debug/alerts, loadtest, tests) ---------------------------
    def firing(self) -> list[Alert]:
        with self._lock:
            return list(self._active.values())

    def alert_history(self) -> list[Alert]:
        with self._lock:
            return list(self._history)

    def snapshot(self) -> dict:
        """The /debug/alerts body: objective stats from the last
        evaluation, currently-firing alerts, and the bounded fire/resolve
        history (each alert carrying its exemplar trace_id — resolve it
        at /debug/traces/<trace_id>)."""
        with self._lock:
            return {
                "now": self.clock.now(),
                "burn_threshold": self.burn_threshold,
                "windows": [window_label(w) for w in self.windows],
                "evaluations": self.evaluations,
                "objectives": {k: dict(v)
                               for k, v in self._last_eval.items()},
                "firing": [a.to_dict() for a in self._active.values()],
                "history": [a.to_dict() for a in self._history],
            }

    def verdicts(self) -> dict[str, dict]:
        """End-of-run verdict per objective (loadtest --out records
        these): met = the long window closed within budget."""
        stats = self.evaluate()
        long_label = window_label(self.windows[-1])
        return {
            name: {
                "met": s["budget_remaining_ratio"] >= 0.0,
                "burn_rate": s["burn_rates"].get(long_label, 0.0),
                "budget_remaining_ratio": s["budget_remaining_ratio"],
                "events": s["events_long_window"],
            }
            for name, s in stats.items()
        }


__all__ = ["Alert", "Objective", "SLOEngine", "default_objectives",
           "register_slo_metrics", "window_label",
           "KIND_LATENCY", "KIND_RATIO"]
