"""Per-tenant (namespace) usage ledger: chip-second metering,
control-plane attribution, and noisy-neighbor detection.  The port's
copy of kubeflow_tpu/utils/metering.py; one GPU meters as one chip.

Every observability surface so far aggregates fleet-wide or per-notebook;
none of it answers "which tenant is consuming the chips, the workqueue,
and the apiserver — and who is being starved by whom?".  This module is
that accounting layer, and the fair-share/preemption work (ROADMAP item 3)
gates on it.  Three feeds, all push-style and all cheap:

* **Chip-seconds** — ``sample(census)`` receives the current placement
  census ``{(namespace, name): (bucket, chips)}`` (built by the caller
  from the InformerCache ``add_aggregate`` pattern over the placement
  annotation + sliceHealth, with an api-list fallback) and accrues
  ``chips x dt`` off the injected clock into per-tenant buckets:
  ``ready`` / ``scheduling`` / ``recovering`` / ``idle`` (stop-annotated
  past the cull threshold).  Per notebook the ledger keeps an interval
  meter; **conservation is the falsifiability contract**: the bucketed
  seconds of one placement interval must sum to the interval's measured
  wall time (``last_sample - interval_start``, kept independently of the
  per-bucket accumulation), tolerance-gated exactly like the lifecycle
  ledger — any double-count or bucket leak breaks the equality and shows
  up in ``conservation()`` / ``violations()``.

* **Control-plane attribution** — ``observe_dispatch`` (workqueue
  dispatch: queue-wait and event->reconcile seconds, stamped on enqueue
  in kube/controller.py next to the event-cause stamp) and
  ``ingest_apiserver`` (cumulative per-(verb, kind, namespace) counts
  from ApiServer.tenant_verb_counts(), delta'd here).  Exported as the
  bounded-cardinality ``notebook_tenant_*_total`` families.

* **Noisy-neighbor detector** — per ``evaluate()``, each tenant's
  control-plane units (dispatches + apiserver requests) over a rolling
  window of evaluation deltas are compared against fair share; a tenant
  whose window share exceeds ``fairshare_factor x (total / tenants)``
  while any *other* tenant's recent event->reconcile p99 has degraded
  past its latched baseline is flagged: exactly one deduped Warning
  event naming the tenant (EventRecorder aggregates identical events by
  count), a latched exemplar handed to the SLO engine's
  ``tenant_fairness`` objective, and a ``noisy`` fairness verdict on the
  ``notebook_tenant_fairness_checks_total`` counter.  The flag clears
  when the tenant's window share drops back under the threshold.

Cardinality is bounded twice: tenants past ``max_tenants`` fold into a
reserved ``other`` tenant (never flagged), and the metric families
themselves sit behind the registry's label-set cap (utils/metrics.py).
Utils idiom: plain locks, injected clock only, O(bounds) memory, never
raises into the reconcile loop's feed path.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Optional

from .metrics import Registry

# The closed bucket vocabulary for placed wall time (bounded label set).
BUCKET_READY = "ready"
BUCKET_SCHEDULING = "scheduling"
BUCKET_RECOVERING = "recovering"
BUCKET_IDLE = "idle"
BUCKETS = (BUCKET_READY, BUCKET_SCHEDULING, BUCKET_RECOVERING, BUCKET_IDLE)

# Reserved fold target once max_tenants distinct namespaces are tracked;
# excluded from fairness verdicts (it is not one tenant).
OTHER_TENANT = "other"

REASON_NOISY = "NoisyNeighbor"

# Dispatch units below which a tenant's window share is not judged —
# avoids flagging during near-idle periods where shares are all noise.
_MIN_WINDOW_UNITS = 10.0


def register_metering_metrics(registry: Registry) -> dict:
    """The tenant metering families (registered by NotebookMetrics so the
    inventory is stable whether or not a ledger is attached; the ledger
    re-registers identically and gets the same objects back)."""
    return {
        "chip_seconds": registry.counter(
            "notebook_tenant_chip_seconds_total",
            "Chip-seconds accrued by a tenant's placed notebooks, "
            "partitioned by lifecycle bucket (conserving partition; see "
            "/debug/tenants)",
            labels=("namespace", "bucket")),
        "apiserver": registry.counter(
            "notebook_tenant_apiserver_requests_total",
            "ApiServer requests attributed to the owning tenant, by verb",
            labels=("namespace", "verb")),
        "queue": registry.counter(
            "notebook_tenant_queue_seconds_total",
            "Workqueue seconds attributed to the owning tenant: "
            "queue_wait (enqueue->dispatch) and event_to_reconcile "
            "(cause->dispatch)",
            labels=("namespace", "phase")),
        "fairness": registry.counter(
            "notebook_tenant_fairness_checks_total",
            "Noisy-neighbor fairness verdicts per evaluation round "
            "(result=ok|noisy); the SLO tenant_fairness objective burns "
            "on the noisy share",
            labels=("result",)),
    }


class _TenantRef:
    """Duck-typed involvedObject for EventRecorder: the tenant namespace."""

    api_version = "v1"
    kind = "Namespace"

    class _Meta:
        uid = ""

    def __init__(self, namespace: str) -> None:
        self.name = namespace
        self.namespace = namespace
        self.metadata = self._Meta()


@dataclass
class _Meter:
    """One placement interval of one notebook.  ``wall`` is measured
    independently (interval_start .. last_ts) while the buckets
    accumulate per-sample deltas — conservation compares the two."""

    tenant: str
    interval_start: float
    last_ts: float
    bucket: str
    chips: float
    buckets: dict = field(default_factory=dict)


@dataclass
class _Tenant:
    """Cumulative usage plus the detector's rolling state for one
    namespace."""

    chip_seconds: dict = field(default_factory=dict)   # bucket -> seconds
    verbs: dict = field(default_factory=dict)          # verb -> count
    queue_s: float = 0.0
    e2r_s: float = 0.0
    dispatches: int = 0
    notebooks_metered: int = 0
    # detector state
    recent_e2r: deque = field(
        default_factory=lambda: deque(maxlen=512))
    baseline_p99: Optional[float] = None
    unit_deltas: deque = field(default_factory=deque)  # maxlen set at init
    units_prev: float = 0.0
    last_trace: str = ""
    flagged: bool = False
    fired_total: int = 0


class TenantMeteringLedger:
    """See module docstring.  One ledger may serve a whole sharded fleet
    (every replica's manager points at the same object), which is what
    makes tenant attribution survive shard handoffs."""

    def __init__(self, clock, registry: Optional[Registry] = None,
                 recorder=None, *,
                 max_tenants: int = 64,
                 max_notebooks: int = 4096,
                 tolerance: float = 0.05,
                 fairshare_factor: float = 3.0,
                 top_k: int = 8,
                 degrade_factor: float = 2.0,
                 degrade_floor_s: float = 1.0,
                 baseline_samples: int = 32,
                 window_evals: int = 16,
                 keep_conservation: int = 4096,
                 slo_engine=None) -> None:
        self.clock = clock
        self.recorder = recorder
        self.slo_engine = slo_engine
        self.max_tenants = max(1, max_tenants)
        self.max_notebooks = max(1, max_notebooks)
        self.tolerance = tolerance
        self.fairshare_factor = fairshare_factor
        self.top_k = max(1, top_k)
        self.degrade_factor = degrade_factor
        self.degrade_floor_s = degrade_floor_s
        self.baseline_samples = max(1, baseline_samples)
        self.window_evals = max(1, window_evals)
        self._lock = threading.Lock()
        self._meters: "OrderedDict[tuple, _Meter]" = OrderedDict()
        self._tenants: dict[str, _Tenant] = {}
        self._verb_snapshot: dict[tuple, int] = {}
        self._conservation: deque = deque(maxlen=keep_conservation)
        self._violations: deque = deque(maxlen=keep_conservation)
        self.finalized_total = 0
        self.evaluations_total = 0
        self.checks = {"ok": 0, "noisy": 0}
        self._max_rel_err = 0.0
        self._metrics = (register_metering_metrics(registry)
                         if registry is not None else None)

    # -- tenant bookkeeping ----------------------------------------------------
    def _tenant(self, namespace: str) -> tuple[str, _Tenant]:
        """Resolve (possibly folding) a namespace to its tenant record.
        Called under the lock."""
        ns = namespace or OTHER_TENANT
        if ns not in self._tenants and len(self._tenants) >= self.max_tenants:
            ns = OTHER_TENANT
        t = self._tenants.get(ns)
        if t is None:
            t = _Tenant()
            t.unit_deltas = deque(maxlen=self.window_evals)
            self._tenants[ns] = t
        return ns, t

    # -- write side: workqueue + reconcile attempts (kube/controller.py) -------
    def observe_dispatch(self, namespace: str, queue_s: float,
                         e2r_s: float) -> None:
        """One workqueue dispatch of a request owned by `namespace`:
        queue-wait and event->reconcile seconds (same clock-domain values
        the fleet histograms observe)."""
        queue_s = max(queue_s, 0.0)
        e2r_s = max(e2r_s, 0.0)
        with self._lock:
            ns, t = self._tenant(namespace)
            t.queue_s += queue_s
            t.e2r_s += e2r_s
            t.dispatches += 1
            t.recent_e2r.append(e2r_s)
            if (t.baseline_p99 is None
                    and len(t.recent_e2r) >= self.baseline_samples):
                t.baseline_p99 = self._p99(t.recent_e2r)
        if self._metrics is not None:
            q = self._metrics["queue"]
            q.labels(ns, "queue_wait").inc(queue_s)
            q.labels(ns, "event_to_reconcile").inc(e2r_s)

    def observe_attempt(self, rec) -> None:
        """Latch the most recent trace per tenant off the attempt stream
        (same call site that feeds the flight recorder) — the exemplar a
        fired fairness alert resolves at /debug/traces."""
        if rec is None or not getattr(rec, "trace_id", ""):
            return
        key = getattr(rec, "object_key", "")
        namespace = key.split("/", 1)[0] if "/" in key else ""
        if not namespace:
            return
        with self._lock:
            _, t = self._tenant(namespace)
            t.last_trace = rec.trace_id

    # -- write side: placement census (core/metrics.py scrape) -----------------
    def sample(self, census: dict, now: Optional[float] = None) -> None:
        """Accrue chip-seconds from the current placement census
        ``{(namespace, name): (bucket, chips)}``.  Notebooks that left the
        census since the previous sample are finalized (conservation
        record); re-placement opens a fresh meter."""
        if now is None:
            now = self.clock.now()
        chip_feed: list[tuple[str, str, float]] = []
        with self._lock:
            for key, (bucket, chips) in census.items():
                m = self._meters.get(key)
                if m is None:
                    ns, t = self._tenant(key[0])
                    t.notebooks_metered += 1
                    self._meters[key] = _Meter(
                        tenant=ns, interval_start=now, last_ts=now,
                        bucket=bucket, chips=float(chips))
                    self._meters.move_to_end(key)
                    continue
                dt = max(now - m.last_ts, 0.0)
                if dt > 0.0:
                    # the interval since the last sample was spent in the
                    # bucket observed THEN; the new bucket starts now
                    m.buckets[m.bucket] = m.buckets.get(m.bucket, 0.0) + dt
                    _, t = self._tenant(m.tenant)
                    t.chip_seconds[m.bucket] = \
                        t.chip_seconds.get(m.bucket, 0.0) + m.chips * dt
                    if m.chips > 0.0:
                        chip_feed.append((m.tenant, m.bucket, m.chips * dt))
                m.last_ts = now
                m.bucket = bucket
                m.chips = float(chips)
                self._meters.move_to_end(key)
            for key in [k for k in self._meters if k not in census]:
                self._finalize(key, self._meters.pop(key))
            while len(self._meters) > self.max_notebooks:
                key, m = self._meters.popitem(last=False)
                self._finalize(key, m)
        if self._metrics is not None:
            c = self._metrics["chip_seconds"]
            for ns, bucket, v in chip_feed:
                c.labels(ns, bucket).inc(v)

    def _finalize(self, key: tuple, m: _Meter) -> None:
        """Close one placement interval: the conservation check compares
        the bucketed accumulation against the independently measured wall
        time.  Called under the lock."""
        wall = max(m.last_ts - m.interval_start, 0.0)
        attributed = sum(m.buckets.values())
        rel_err = abs(attributed - wall) / wall if wall > 1e-9 else 0.0
        self._max_rel_err = max(self._max_rel_err, rel_err)
        record = {
            "namespace": key[0], "name": key[1], "tenant": m.tenant,
            "wall_s": wall, "attributed_s": attributed,
            "buckets": dict(m.buckets), "chips": m.chips,
            "rel_err": rel_err,
        }
        self._conservation.append(record)
        self.finalized_total += 1
        if rel_err > self.tolerance:
            self._violations.append(record)

    # -- write side: apiserver attribution (kube/store.py accessor) ------------
    def ingest_apiserver(self, verb_counts: dict) -> None:
        """Fold a cumulative ``{(verb, kind, namespace): count}`` snapshot
        (ApiServer.tenant_verb_counts()) into per-tenant verb totals;
        deltas are computed here so the feed is idempotent per snapshot."""
        feed: dict[tuple[str, str], float] = {}
        with self._lock:
            for k, count in verb_counts.items():
                delta = count - self._verb_snapshot.get(k, 0)
                if delta <= 0:
                    continue
                self._verb_snapshot[k] = count
                verb, _, namespace = k
                if not namespace:
                    continue  # cluster-scoped: no owning tenant
                ns, t = self._tenant(namespace)
                t.verbs[verb] = t.verbs.get(verb, 0) + delta
                feed[(ns, verb)] = feed.get((ns, verb), 0.0) + delta
        if self._metrics is not None:
            a = self._metrics["apiserver"]
            for (ns, verb), v in feed.items():
                a.labels(ns, verb).inc(v)

    # -- the detector ----------------------------------------------------------
    @staticmethod
    def _p99(samples) -> float:
        """Nearest-rank p99 (same convention as the lifecycle ledger)."""
        if not samples:
            return 0.0
        ordered = sorted(samples)
        n = len(ordered)
        return ordered[min(max((99 * n + 99) // 100 - 1, 0), n - 1)]

    def _units(self, t: _Tenant) -> float:
        return float(t.dispatches + sum(t.verbs.values()))

    def _degraded(self, t: _Tenant) -> bool:
        if t.baseline_p99 is None:
            return False
        p99 = self._p99(t.recent_e2r)
        return p99 > max(t.baseline_p99 * self.degrade_factor,
                         self.degrade_floor_s)

    def evaluate(self, census: Optional[dict] = None,
                 verb_counts: Optional[dict] = None,
                 now: Optional[float] = None) -> dict:
        """One metering round: fold the optional feeds, roll the
        per-tenant control-plane window forward, and run the
        noisy-neighbor check.  Returns {"noisy": [...], "fired": [...],
        "cleared": [...]} (tenant names)."""
        if census is not None:
            self.sample(census, now=now)
        if verb_counts is not None:
            self.ingest_apiserver(verb_counts)
        fired: list[tuple[str, str]] = []
        cleared: list[str] = []
        noisy: list[str] = []
        with self._lock:
            self.evaluations_total += 1
            real = {ns: t for ns, t in self._tenants.items()
                    if ns != OTHER_TENANT}
            for t in real.values():
                cum = self._units(t)
                t.unit_deltas.append(cum - t.units_prev)
                t.units_prev = cum
            window = {ns: sum(t.unit_deltas) for ns, t in real.items()}
            total = sum(window.values())
            n = len(real)
            if n >= 2 and total >= _MIN_WINDOW_UNITS:
                fair = total / n
                for ns, t in real.items():
                    over = window[ns] > self.fairshare_factor * fair
                    if over:
                        victim = any(self._degraded(v)
                                     for vns, v in real.items() if vns != ns)
                        if victim:
                            noisy.append(ns)
                            if not t.flagged:
                                t.flagged = True
                                t.fired_total += 1
                                fired.append((ns, t.last_trace))
                            continue
                    if t.flagged and not over:
                        t.flagged = False
                        cleared.append(ns)
                noisy.extend(ns for ns, t in real.items()
                             if t.flagged and ns not in noisy)
        if self._metrics is not None:
            self._metrics["fairness"].labels(
                "noisy" if noisy else "ok").inc()
        with self._lock:
            self.checks["noisy" if noisy else "ok"] += 1
        # side effects outside the lock: event emission and exemplar
        # latching call into other subsystems
        for ns, trace in fired:
            if self.slo_engine is not None and trace:
                try:
                    self.slo_engine.latch_exemplar(
                        "tenant_fairness",
                        {"trace_id": trace, "tenant": ns})
                except Exception:  # noqa: BLE001 — observability feed
                    pass
            if self.recorder is not None:
                try:
                    # STABLE message (no varying numbers): EventRecorder
                    # aggregates identical events by count, which is the
                    # exactly-one-Warning guarantee
                    self.recorder.event(
                        _TenantRef(ns), "Warning", REASON_NOISY,
                        f"tenant {ns} control-plane share exceeds "
                        f"{self.fairshare_factor:g}x its fair share while "
                        "other tenants' event->reconcile p99 is degraded")
                except Exception:  # noqa: BLE001 — observability feed
                    pass
        return {"noisy": sorted(noisy), "fired": [ns for ns, _ in fired],
                "cleared": sorted(cleared)}

    # -- read side (/debug/tenants, loadtest, tests) ---------------------------
    def conservation(self) -> dict:
        """The falsifiability summary: every closed placement interval's
        bucketed sum vs its measured wall time, PLUS the live meters (so
        a fleet that never releases anything still gets checked)."""
        with self._lock:
            recs = list(self._conservation)
            live_checked = 0
            live_violations = 0
            max_err = self._max_rel_err
            errs = [r["rel_err"] for r in recs]
            for m in self._meters.values():
                wall = max(m.last_ts - m.interval_start, 0.0)
                if wall <= 1e-9:
                    continue
                rel = abs(sum(m.buckets.values()) - wall) / wall
                live_checked += 1
                errs.append(rel)
                max_err = max(max_err, rel)
                if rel > self.tolerance:
                    live_violations += 1
            return {
                "finalized": self.finalized_total,
                "checked": len(recs) + live_checked,
                "live_checked": live_checked,
                "violations": len(self._violations) + live_violations,
                "tolerance": self.tolerance,
                "max_rel_err": max_err,
                "mean_rel_err": (sum(errs) / len(errs)) if errs else 0.0,
            }

    def violations(self) -> list[dict]:
        with self._lock:
            out = [dict(r) for r in self._violations]
            for key, m in self._meters.items():
                wall = max(m.last_ts - m.interval_start, 0.0)
                if wall <= 1e-9:
                    continue
                attributed = sum(m.buckets.values())
                rel = abs(attributed - wall) / wall
                if rel > self.tolerance:
                    out.append({
                        "namespace": key[0], "name": key[1],
                        "tenant": m.tenant, "wall_s": wall,
                        "attributed_s": attributed,
                        "buckets": dict(m.buckets), "chips": m.chips,
                        "rel_err": rel, "live": True,
                    })
            return out

    def tenant_table(self) -> dict:
        """Per-tenant usage rollup — the /debug/tenants table body."""
        with self._lock:
            out = {}
            for ns, t in sorted(self._tenants.items()):
                chips_total = sum(t.chip_seconds.values())
                out[ns] = {
                    "chip_seconds": dict(sorted(t.chip_seconds.items())),
                    "chip_seconds_total": chips_total,
                    "apiserver": dict(sorted(t.verbs.items())),
                    "apiserver_total": int(sum(t.verbs.values())),
                    "dispatches": t.dispatches,
                    "queue_s": t.queue_s,
                    "event_to_reconcile_s": t.e2r_s,
                    "e2r_p99_recent_s": self._p99(t.recent_e2r),
                    "e2r_p99_baseline_s": t.baseline_p99,
                    "control_units_window": sum(t.unit_deltas),
                    "notebooks_metered": t.notebooks_metered,
                    "flagged": t.flagged,
                    "fired_total": t.fired_total,
                    "last_trace": t.last_trace,
                }
            return out

    def top_consumers(self) -> dict:
        """Top-K tenants by chip-seconds and by control-plane units."""
        table = self.tenant_table()
        by_chips = sorted(table.items(),
                          key=lambda kv: kv[1]["chip_seconds_total"],
                          reverse=True)[:self.top_k]
        by_control = sorted(
            table.items(),
            key=lambda kv: kv[1]["apiserver_total"] + kv[1]["dispatches"],
            reverse=True)[:self.top_k]
        return {
            "chip_seconds": [
                {"tenant": ns, "chip_seconds": row["chip_seconds_total"]}
                for ns, row in by_chips if row["chip_seconds_total"] > 0.0],
            "control_plane": [
                {"tenant": ns,
                 "units": row["apiserver_total"] + row["dispatches"]}
                for ns, row in by_control
                if row["apiserver_total"] + row["dispatches"] > 0],
        }

    def tenant_chip_series(self) -> dict[str, float]:
        """Tenant -> cumulative chip-seconds for the top-K consumers (the
        TSDB's per-tenant series on /debug/timeline)."""
        return {row["tenant"]: row["chip_seconds"]
                for row in self.top_consumers()["chip_seconds"]}

    def flagged(self) -> list[str]:
        with self._lock:
            return sorted(ns for ns, t in self._tenants.items() if t.flagged)

    def snapshot(self) -> dict:
        """The /debug/tenants body (also embedded in /debug/fleet and the
        diagnose bundle)."""
        base = {
            "enabled": True,
            "bounds": {
                "max_tenants": self.max_tenants,
                "max_notebooks": self.max_notebooks,
                "top_k": self.top_k,
            },
            "buckets": list(BUCKETS),
            "tenants": self.tenant_table(),
            "top": self.top_consumers(),
            "conservation": self.conservation(),
            "violations": self.violations(),
        }
        with self._lock:
            base["fairness"] = {
                "fairshare_factor": self.fairshare_factor,
                "degrade_factor": self.degrade_factor,
                "degrade_floor_s": self.degrade_floor_s,
                "window_evals": self.window_evals,
                "evaluations": self.evaluations_total,
                "checks": dict(self.checks),
                "flagged": sorted(ns for ns, t in self._tenants.items()
                                  if t.flagged),
            }
            base["live_meters"] = len(self._meters)
        return base

    def clear(self) -> None:
        with self._lock:
            self._meters.clear()
            self._tenants.clear()
            self._verb_snapshot.clear()
            self._conservation.clear()
            self._violations.clear()
            self.finalized_total = 0
            self.evaluations_total = 0
            self.checks = {"ok": 0, "noisy": 0}
            self._max_rel_err = 0.0


__all__ = ["TenantMeteringLedger", "register_metering_metrics", "BUCKETS",
           "OTHER_TENANT", "REASON_NOISY"]
