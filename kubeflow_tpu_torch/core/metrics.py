"""Notebook controller metrics: the port of kubeflow_tpu/core/metrics.py.

Counters for creations, failures, cullings and cull checkpoints, the
last-cull timestamp, the first-readiness histogram, the self-healing
engine's restarts, migrations, checkpoint ages and recovery latency
(core/selfheal.py), the replicated tier's promotions, promotion latency
and fenced writes, the gang scheduler's attempts, warm-pool claims and
pool census and the tenancy layer's preemptions and queue wait
(core/scheduler.py, core/preemption.py), the watch-dispatch audit and
the workqueue families, and a scraper-style gauge that counts running
notebooks from the workload StatefulSets carrying the notebook-name
label, with the GPUs their running gangs request beside it.

The observability plane's families are registered here too, so the
inventory is the same whether or not its engines are attached: the SLO
engine (utils/slo.py), the profiler (utils/profiler.py), the lifecycle
ledger (utils/lifecycle.py), the data-plane rollup (core/telemetry.py),
the metering ledger (utils/metering.py) and the diagnosis engine
(utils/diagnosis.py).  `scrape()` feeds the attached engines in the
reference's order (data plane, metering, SLO, TSDB, diagnosis), and
`fleet_snapshot()` / `tenancy_snapshot()` are the /debug/fleet and
/debug/tenants views.

The families keep the reference's names and labels, on the port's
`utils/metrics.py` Registry.  `notebook_gpus_requested` is the twin of
the reference's `notebook_tpu_chips_requested`; everywhere else one GPU
counts as one chip (`notebook_tenant_chip_seconds_total`, the tenancy
view's `usage_chips`).  `attach_shard` feeds the sharded fleet's
`notebook_shard_*` families (kube/shard.py) at every scrape, before the
SLO engine reads the handoff histogram, and adds its `shards` section to
/debug/fleet.
"""

from __future__ import annotations

import copy
import json
from typing import Optional

from ..api.types import CONDITION_RECOVERY_EXHAUSTED, GPUSpec, InvalidError
from ..kube import ApiServer, parse_quantity
from ..utils.diagnosis import register_diagnosis_metrics
from ..utils.lifecycle import register_lifecycle_metrics
from ..utils.metering import (BUCKET_IDLE, BUCKET_READY, BUCKET_RECOVERING,
                              BUCKET_SCHEDULING, register_metering_metrics)
from ..utils.metrics import Registry, register_cardinality_metrics
from ..utils.profiler import register_profiler_metrics
from ..utils.slo import register_slo_metrics
from . import constants as C
from .telemetry import register_dataplane_metrics

# /debug/fleet health states, derived per Notebook by fleet_state(); a
# bounded set so the rollup is O(namespaces x states), never O(fleet)
FLEET_STATES = ("ready", "degraded", "recovering", "exhausted",
                "scheduling", "stopped", "pending")


def fleet_state(nb) -> str:
    """One health bucket per Notebook for the fleet rollup.  The terminal
    RecoveryExhausted condition wins (an exhausted slice reads Degraded in
    sliceHealth but has stopped consuming restarts — the operator signal);
    an active recovery budget (status.sliceRecovery with attempts) turns a
    broken slice "recovering" rather than plain "degraded"; CPU notebooks
    (no sliceHealth) bucket off readyReplicas."""
    status = nb.body.get("status") or {}
    for cond in (status.get("conditions") or []):
        if cond.get("type") == CONDITION_RECOVERY_EXHAUSTED and \
                cond.get("status") == "True":
            return "exhausted"
    health = status.get("sliceHealth")
    if health in ("Healthy",):
        return "ready"
    if health in ("Stopped", "Stopping"):
        return "stopped"
    if health in ("Scheduling", "Queued"):
        # quota/fair-share-queued gangs roll up with scheduling: both are
        # "wants chips, has none"; per-tenant queue depth lives in the
        # tenancy section of /debug/fleet, not a new fleet state
        return "scheduling"
    if health in ("Degraded", "Unhealthy"):
        recovery = status.get("sliceRecovery") or {}
        if any(e.get("attempts") for e in recovery.values()
               if isinstance(e, dict)):
            return "recovering"
        return "degraded"
    # CPU notebook (or no status yet)
    return "ready" if status.get("readyReplicas") else "pending"


def placement_gpus(nb) -> float:
    """GPUs a placed notebook's gang occupies (0.0 for a CPU notebook or
    an unresolvable shape): the twin of the reference's `placement_chips`,
    with one gang where the reference has `spec.tpu.slices`."""
    gpu = nb.spec.get("gpu") or {}
    if not gpu.get("accelerator"):
        return 0.0
    try:
        return float(GPUSpec.from_dict(gpu).validate().gpus)
    except (InvalidError, TypeError, ValueError):
        return 0.0


def metering_bucket(nb) -> str:
    """The chip-second bucket (one GPU meters as one chip) a placed
    notebook is currently accruing into: stop-annotated (culled or
    user-stopped) counts as idle, GPUs held past the cull decision;
    otherwise sliceHealth partitions placed time into ready / scheduling /
    recovering."""
    if C.STOP_ANNOTATION in (nb.metadata.annotations or {}):
        return BUCKET_IDLE
    health = (nb.body.get("status") or {}).get("sliceHealth")
    if health == "Healthy":
        return BUCKET_READY
    if health in ("Unhealthy", "Degraded"):
        return BUCKET_RECOVERING
    if health in ("Stopping", "Stopped"):
        return BUCKET_IDLE
    # Scheduling, or placed before the first health write
    return BUCKET_SCHEDULING


def histogram_quantile(hist, q: float) -> float:
    """Prometheus-style quantile estimate over ALL label sets of one
    histogram: cumulative bucket counts summed across series, then linear
    interpolation inside the target bucket (the +Inf bucket clamps to the
    largest finite bound).  Feeds the TSDB's p99-vs-time series without
    needing raw samples retained anywhere."""
    totals: dict[float, float] = {}
    for key in hist.collect():
        for bound, c in hist.bucket_counts(*key).items():
            totals[bound] = totals.get(bound, 0.0) + c
    if not totals:
        return 0.0
    count = totals.get(float("inf"), 0.0)
    if count <= 0:
        return 0.0
    rank = q * count
    bounds = sorted(b for b in totals if b != float("inf"))
    prev_bound, prev_cum = 0.0, 0.0
    for b in bounds:
        cum = totals[b]
        if cum >= rank:
            if cum == prev_cum:
                return b
            return prev_bound + (b - prev_bound) * \
                (rank - prev_cum) / (cum - prev_cum)
        prev_bound, prev_cum = b, cum
    return bounds[-1] if bounds else 0.0


class NotebookMetrics:
    def __init__(self, api: ApiServer, registry: Optional[Registry] = None,
                 manager=None):
        self.api = api
        self.registry = registry or Registry()
        self.manager = manager  # kube.Manager: its registry joins /metrics
        self.running = self.registry.gauge(
            "notebook_running",
            "Current running notebooks in the cluster",
            labels=("namespace",),
        )
        self.creation = self.registry.counter(
            "notebook_create_total",
            "Total times of creating notebooks",
            labels=("namespace",),
        )
        self.fail_creation = self.registry.counter(
            "notebook_create_failed_total",
            "Total failure times of creating notebooks",
            labels=("namespace",),
        )
        self.culling = self.registry.counter(
            "notebook_culling_total",
            "Total times of culling notebooks",
            labels=("namespace", "name"),
        )
        self.last_culling_timestamp = self.registry.gauge(
            "last_notebook_culling_timestamp_seconds",
            "Timestamp of the last notebook culling in seconds",
            labels=("namespace", "name"),
        )
        self.gpus_requested = self.registry.gauge(
            "notebook_gpus_requested",
            "GPUs requested by running notebook gangs",
            labels=("namespace",),
        )
        # first-readiness latency, observed once per notebook by the
        # NotebookReconciler off the injected clock
        self.notebook_ready_seconds = self.registry.histogram(
            "notebook_to_ready_seconds",
            "Latency from Notebook creation to all workers Ready",
            labels=("namespace",),
            buckets=(1.0, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
                     1800.0, 3600.0),
        )
        # self-healing (core/selfheal.py): slice-atomic restarts performed
        # by the recovery engine, labeled by the disruption classification
        # (a bounded set — see selfheal.REASON_*), and the
        # disruption-detected -> slice-Healthy-again latency distribution
        self.slice_restarts = self.registry.counter(
            "notebook_slice_restarts_total",
            "Slice-atomic worker restarts performed by the self-healing "
            "engine",
            labels=("namespace", "reason"),
        )
        self.disruption_recovery_seconds = self.registry.histogram(
            "notebook_disruption_recovery_seconds",
            "Latency from disruption detection to the slice reading "
            "Healthy again",
            labels=("namespace",),
            buckets=(1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0, 600.0,
                     1800.0),
        )
        # session-state tier (core/sessionstate.py + selfheal migrate verb):
        # snapshots the control plane recorded/confirmed (trigger: final |
        # cull), the checkpoint age observed at each migrate decision, and
        # the migrate-verb outcomes.  trigger/result are bounded sets —
        # selfheal.MIGRATE_* constants.
        self.checkpoint_snapshots = self.registry.counter(
            "notebook_checkpoint_snapshots_total",
            "Session checkpoints recorded or confirmed by the controllers",
            labels=("namespace", "trigger"),
        )
        self.checkpoint_age_seconds = self.registry.histogram(
            "notebook_checkpoint_age_seconds",
            "Age of the freshest session checkpoint at migrate-decision "
            "time",
            labels=("namespace",),
            buckets=(1.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0, 1800.0,
                     3600.0),
        )
        self.migrations = self.registry.counter(
            "notebook_migrations_total",
            "Checkpoint/migrate recoveries by trigger and outcome",
            labels=("trigger", "result"),
        )
        # replicated-kernel tier (spec.replication + selfheal promote
        # verb): promotion outcomes (result is the bounded selfheal
        # PROMOTE_RESULT_* set), the primary-failure -> follower-promoted
        # latency (sub-second buckets — the tier's reason to exist), and
        # session-store writes rejected by the replication epoch fence
        # (a demoted/zombie primary tried to ack state after demotion)
        self.promotions = self.registry.counter(
            "notebook_promotions_total",
            "Primary promotions attempted by the self-healing engine, by "
            "outcome",
            labels=("namespace", "result"),
        )
        self.promotion_duration_seconds = self.registry.histogram(
            "notebook_promotion_duration_seconds",
            "Latency from primary disruption detection to a follower "
            "promoted (epoch fenced, primary pointer flipped)",
            labels=("namespace",),
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0),
        )
        self.replication_fenced_writes = self.registry.counter(
            "notebook_replication_fenced_writes_total",
            "Session-store writes rejected by the replication epoch fence "
            "(zombie primary writing under lost authority)",
            labels=("namespace",),
        )
        # slice scheduler + warm pool (core/scheduler.py): per-reconcile
        # scheduling outcomes (result is the bounded scheduler.SCHEDULE_*
        # set), per-claim warm-pool outcomes (hit | miss | bypass), and the
        # per-shape pool census recomputed at scrape time from the
        # GPUWarmPool objects (state: Provisioning | Ready | Claimed)
        self.schedule_attempts = self.registry.counter(
            "notebook_schedule_attempts_total",
            "Slice-scheduler placement attempts by outcome",
            labels=("result",),
        )
        self.warmpool_hits = self.registry.counter(
            "notebook_warmpool_hits_total",
            "Warm-pool claim outcomes (hit=pre-provisioned slice claimed, "
            "miss=cold provision, bypass=pre-existing capacity)",
            labels=("result",),
        )
        self.warmpool_size = self.registry.gauge(
            "notebook_warmpool_size",
            "Warm-pool slices per accelerator-topology shape and state",
            labels=("shape", "state"),
        )
        # tenancy layer (core/scheduler.py admission gate +
        # core/preemption.py): preemption outcomes (result is the bounded
        # preemption.PREEMPT_* set, priority the victim's class — or the
        # beneficiary's for result="no-victims"), and the quota/fair-share
        # queue wait from first queuing to placement-intent written
        # (observed as 0 for gangs that never queued, so the distribution
        # is over ALL placements and its p99 is the time-to-placement SLO)
        self.preemptions = self.registry.counter(
            "notebook_preemptions_total",
            "Checkpoint-then-preempt evictions by outcome and priority "
            "class",
            labels=("result", "priority"),
        )
        self.queue_wait_seconds = self.registry.histogram(
            "notebook_queue_wait_seconds",
            "Time a gang spent queued behind quota/fair share before its "
            "placement intent was written, by priority class",
            labels=("priority",),
            buckets=(0.5, 1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0,
                     600.0, 1800.0),
        )
        # watch-dispatch audit (kube/store.py filtered fan-out): delivered
        # = callbacks actually invoked per event kind; skipped = callbacks
        # an unfiltered broadcast would have made but the per-kind
        # subscriber index spared.  skipped >> delivered on churn-heavy
        # kinds is the fleet-scale fan-out reduction, proven in numbers.
        self.watch_dispatch = self.registry.counter(
            "apiserver_watch_dispatch_total",
            "Watch dispatch outcomes per event kind on the in-memory "
            "apiserver (delivered = interested watchers invoked, skipped = "
            "watchers the filtered index never touched)",
            labels=("kind", "result"),
        )
        # workqueue / retry observability (controller-runtime exports the
        # same family: workqueue_depth, workqueue_retries_total) — scraped
        # from Manager.queue_stats() when a manager is attached.  The
        # *_total families are monotonic counters fed by deltas from the
        # scrape-state snapshot (a gauge set() from scrape state would
        # break Prometheus rate()/increase() on counter-suffixed names)
        self.workqueue_depth = self.registry.gauge(
            "workqueue_depth",
            "Current reconcile requests queued per controller",
            labels=("controller",),
        )
        self.workqueue_backoff_pending = self.registry.gauge(
            "workqueue_backoff_pending",
            "Reconcile requests waiting out a retry backoff",
            labels=("controller",),
        )
        self.workqueue_retries_total = self.registry.counter(
            "workqueue_retries_total",
            "Total rate-limited requeues scheduled per controller",
            labels=("controller",),
        )
        self.workqueue_last_backoff_seconds = self.registry.gauge(
            "workqueue_last_backoff_seconds",
            "Most recent backoff delay handed out per controller",
            labels=("controller",),
        )
        self.workqueue_longest_running = self.registry.gauge(
            "workqueue_longest_running_processor_seconds",
            "Age of the oldest reconcile currently being processed per "
            "controller (0 when idle)",
            labels=("controller",),
        )
        self.reconcile_errors_total = self.registry.counter(
            "reconcile_errors_total",
            "Reconcile requests dropped after exhausting their retry budget",
            labels=("controller",),
        )
        # fleet SLO engine families (utils/slo.py) + continuous-profiler
        # self-measurement (utils/profiler.py): registered here so the
        # metric inventory is identical whether or not an engine/profiler
        # is attached (ci/metrics_families.golden stability); the engine
        # and profiler re-register identically and feed the same objects
        self.slo_burn_rate, self.slo_budget_remaining, self.slo_firing = \
            register_slo_metrics(self.registry)
        self.profiler_overhead, self.profiler_samples = \
            register_profiler_metrics(self.registry)
        # lifecycle critical-path family (utils/lifecycle.py): registered
        # here for inventory stability; an attached LifecycleLedger
        # re-registers identically and feeds the same histogram
        self.stage_duration = register_lifecycle_metrics(self.registry)
        # data-plane rollup families (core/telemetry.py): registered here
        # so the inventory is identical whether or not a
        # WorkerTelemetryAggregator is attached; the aggregator
        # re-registers identically and feeds the same objects
        register_dataplane_metrics(self.registry)
        # tenant metering families (utils/metering.py): registered here
        # for inventory stability; an attached TenantMeteringLedger
        # re-registers identically and feeds the same counters
        register_metering_metrics(self.registry)
        # diagnosis family (utils/diagnosis.py): registered here for
        # inventory stability; an attached DiagnosisEngine re-registers
        # identically and feeds the same counter
        register_diagnosis_metrics(self.registry)
        # cardinality-guard visibility (utils/metrics.py): ONE exported
        # family fed at scrape time from every scraped registry's
        # labelsets_dropped() — per-registry auto-registration would emit
        # duplicate TYPE lines in the combined exposition
        self.labelsets_dropped = register_cardinality_metrics(self.registry)
        # active-active sharding families (kube/shard.py): registered
        # unconditionally for inventory stability; fed from an attached
        # ShardedFleet's per-replica snapshots at every scrape
        self.shard_keys_owned = self.registry.gauge(
            "notebook_shard_keys_owned",
            "Notebook keys owned by each control-plane shard replica "
            "(off its filtered informer cache)",
            labels=("shard",),
        )
        self.shard_epoch = self.registry.gauge(
            "notebook_shard_epoch",
            "Shard-map epoch as last observed by each replica (replicas "
            "disagreeing for long means a stuck membership view)",
            labels=("shard",),
        )
        self.shard_fenced_writes = self.registry.counter(
            "notebook_shard_fenced_writes_total",
            "Writes rejected by epoch fencing per shard replica (a "
            "deposed/zombie holder tried to write under lost authority)",
            labels=("shard",),
        )
        self.shard_handoff_duration = self.registry.histogram(
            "notebook_shard_handoff_duration_seconds",
            "Shard-map handoff duration, membership commit to the ack "
            "that completed it (drains + adoptions)",
            buckets=(0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0),
        )
        # ShardedFleet attached via attach_shard(); per-shard handoff
        # durations already fed into the histogram (indexed per shard)
        self.shards = None
        self._handoff_fed: dict[str, int] = {}
        # SLOEngine attached via attach_slo(): evaluated at every scrape
        # so burn rates/alerts advance at scrape resolution
        self.slo = None
        # WorkerTelemetryAggregator attached via attach_dataplane():
        # evaluated at every scrape, BEFORE the SLO engine so its verdict
        # counters are fresh when the burn rates read them
        self.dataplane = None
        # LifecycleLedger attached via attach_lifecycle(): fleet_snapshot
        # grows the per-namespace stage-latency rollup and the TSDB feed
        # samples its stage p99s
        self.lifecycle = None
        # TenantMeteringLedger attached via attach_metering(): every
        # scrape() feeds it the placement census + apiserver tenant verb
        # counts and runs the noisy-neighbor evaluation; fleet_snapshot
        # grows a `tenants` section
        self.metering = None
        # TimeSeriesStore attached via attach_tsdb(): every scrape()
        # appends one sample per selected series (the /debug/timeline and
        # diagnostics-bundle history)
        self.tsdb = None
        self._tsdb_clock = None
        # DiagnosisEngine attached via attach_diagnosis(): every scrape()
        # runs one change-point evaluation AFTER the TSDB sample lands
        # (the detector consumes the raw tier this scrape just extended);
        # fleet_snapshot grows a `diagnosis` section
        self.diagnosis = None
        # previous-scrape values behind the TSDB's *_delta series (a
        # cumulative counter can't feed a level-shift detector)
        self._tsdb_prev: dict[str, float] = {}
        # last snapshot of the manager's cumulative totals, so each scrape
        # feeds the counters exactly the delta since the previous scrape
        self._counter_snapshots: dict[tuple, float] = {}
        # shape labels emitted by the last warm-pool census — a deleted
        # pool's series must be driven to 0, not left at its last value
        self._warmpool_shapes: set[str] = set()
        # whether the cache-side census aggregates registered successfully
        # (None = not yet attempted; False = fell back to list scans, e.g.
        # a backend without the GPUWarmPool kind)
        self._census_ready: Optional[bool] = None

    def attach_manager(self, manager) -> None:
        self.manager = manager

    def attach_slo(self, engine) -> None:
        """Attach a fleet SLOEngine; every scrape() evaluates it (burn
        rates, budget gauges, alert transitions) so the SLO verdict
        advances exactly as often as anyone looks at the fleet."""
        self.slo = engine

    def attach_dataplane(self, aggregator) -> None:
        """Attach a WorkerTelemetryAggregator; every scrape() rolls the
        per-worker telemetry annotations into the notebook_dataplane_*
        series and runs straggler detection."""
        self.dataplane = aggregator

    def attach_shard(self, fleet) -> None:
        """Attach a ShardedFleet (kube/shard.py); every scrape() feeds
        the notebook_shard_* families from its replicas' snapshots and
        fleet_snapshot() grows a `shards` section."""
        self.shards = fleet

    def attach_lifecycle(self, ledger) -> None:
        """Attach a LifecycleLedger (utils/lifecycle.py); fleet_snapshot()
        grows the per-namespace stage-latency rollup and the TSDB feed
        samples the ledger's stage p99s each scrape."""
        self.lifecycle = ledger

    def attach_metering(self, ledger) -> None:
        """Attach a TenantMeteringLedger (utils/metering.py); every
        scrape() accrues chip-seconds off the placement census, folds the
        apiserver tenant verb counts, and evaluates the noisy-neighbor
        detector (before the SLO engine, whose tenant_fairness objective
        reads the verdict counter this feeds)."""
        self.metering = ledger

    def attach_tsdb(self, store, clock=None) -> None:
        """Attach a TimeSeriesStore (utils/tsdb.py); every scrape()
        appends one sample per selected series, timestamped off `clock`
        (falls back to the attached manager's clock) so the history is
        FakeClock-deterministic in tests."""
        self.tsdb = store
        self._tsdb_clock = clock

    def attach_diagnosis(self, engine) -> None:
        """Attach a DiagnosisEngine (utils/diagnosis.py); every scrape()
        runs one change-point evaluation over the TSDB's fresh raw
        points and diffs the discrete evidence surfaces, and
        fleet_snapshot() grows a `diagnosis` section."""
        self.diagnosis = engine

    def _feed_counter(self, counter, label, total: float) -> None:
        """Advance a monotonic counter to `total` using deltas against the
        previous scrape; a source reset (new manager) re-counts from zero.
        `label` is one label value or a tuple of them."""
        labels = label if isinstance(label, tuple) else (label,)
        key = (counter.name,) + labels
        prev = self._counter_snapshots.get(key, 0.0)
        if total > prev:
            counter.labels(*labels).inc(total - prev)
        elif total < prev:
            counter.labels(*labels).inc(total)
        self._counter_snapshots[key] = float(total)

    # -- census aggregates (InformerCache.add_aggregate) ----------------------
    # Group keys are SEP-joined so one aggregate carries several gauge
    # families; contributions are small exact counts.  The cache maintains
    # the sums incrementally on its watch stream, so a scrape reads
    # O(label series), never O(objects) — and never touches the apiserver.
    _SEP = "\x1f"

    @classmethod
    def _sts_census(cls, sts) -> dict:
        nb_name = (
            sts.spec.get("template", {})
            .get("metadata", {})
            .get("labels", {})
            .get(C.NOTEBOOK_NAME_LABEL)
        )
        if nb_name is None:
            return {}
        out: dict[str, float] = {}
        replicas = int(sts.spec.get("replicas", 0) or 0)
        if replicas > 0:
            # one key per (ns, notebook): the scrape counts distinct
            # keys, not their values
            out[cls._SEP.join(("run", sts.namespace, nb_name))] = 1.0
        gpus = 0.0
        for c in sts.spec.get("template", {}).get("spec", {}).get(
                "containers", []):
            q = (c.get("resources", {}).get("requests") or {}).get(
                C.GPU_RESOURCE)
            if q:
                gpus += parse_quantity(q) * replicas
        if gpus:
            out[cls._SEP.join(("gpus", sts.namespace))] = gpus
        return out

    @classmethod
    def _warmpool_census(cls, pool) -> dict:
        shape = "%s-%s" % (pool.spec.get("accelerator", ""),
                           pool.spec.get("count", ""))
        # shape presence rides along so an empty pool still zero-fills its
        # state series each scrape
        out: dict[str, float] = {cls._SEP.join(("shape", shape)): 1.0}
        for e in (pool.body.get("status", {}).get("slices") or {}).values():
            if e.get("external"):
                continue  # bypass claims are not pool capacity
            state = e.get("state", "")
            if state in C.WARMSLICE_STATES:
                key = cls._SEP.join(("state", shape, state))
                out[key] = out.get(key, 0.0) + 1.0
        return out

    @classmethod
    def _fleet_census(cls, nb) -> dict:
        """Per-Notebook contribution to the /debug/fleet rollup: one count
        under its namespace and (for GPU notebooks) its accelerator-count
        shape ("h100-80gb-8", the warm pool's), keyed by health state.  Maintained incrementally
        by InformerCache.add_aggregate — O(changed) per watch event — so
        a /debug/fleet request is O(series), never O(objects)."""
        state = fleet_state(nb)
        out = {cls._SEP.join(("ns", nb.namespace, state)): 1.0}
        gpu = nb.spec.get("gpu") or {}
        if gpu.get("accelerator"):
            shape = "%s-%s" % (gpu.get("accelerator", ""),
                               gpu.get("count", ""))
            out[cls._SEP.join(("shape", shape, state))] = 1.0
        return out

    @classmethod
    def _metering_census(cls, nb) -> dict:
        """Per-Notebook contribution to the tenant metering census: placed
        notebooks (placement annotation written by the scheduler) appear
        under (namespace, name, bucket) with their GPU count; release
        removes the key, and the ledger closes the interval.  Incremental
        via add_aggregate, so placement/release and sliceHealth
        transitions maintain it on the watch stream."""
        if C.ANNOTATION_PLACEMENT not in (nb.metadata.annotations or {}):
            return {}
        key = cls._SEP.join((nb.namespace, nb.name, metering_bucket(nb)))
        return {key: placement_gpus(nb)}

    def _ensure_census(self, cache) -> bool:
        if self._census_ready is not None:
            return self._census_ready
        try:
            cache.add_aggregate("StatefulSet", "nb-census", self._sts_census)
            cache.add_aggregate(C.WARMPOOL_KIND, "warmpool-census",
                                self._warmpool_census)
            cache.add_aggregate("Notebook", "fleet-census",
                                self._fleet_census)
            cache.add_aggregate("Notebook", "tenant-metering",
                                self._metering_census)
            self._census_ready = True
        except Exception:  # noqa: BLE001 — a backend that cannot list a
            # kind (real cluster without the CRD) falls back to scans
            self._census_ready = False
        return self._census_ready

    def scrape(self, openmetrics: bool = False) -> str:
        """Scrape-time gauge recomputation.  With an informer cache the
        census gauges read the cache's incremental aggregates — O(changed)
        per event, O(series) per scrape, zero API calls — replacing the
        per-scrape rescans of metrics.go:82-99 that fall over at fleet
        scale.  Without a cache (direct-construction unit tests, degraded
        backends) the original list-based scan still runs."""
        cache = getattr(self.manager, "cache", None)
        if cache is not None and self._ensure_census(cache):
            self._scrape_census_from_cache(cache)
        else:
            self._scrape_census_from_lists()
        # filtered watch fan-out audit (in-memory apiserver only)
        dispatch = getattr(self.api, "watch_dispatch_counts", None)
        if dispatch is not None:
            for (kind, result), total in sorted(dispatch().items()):
                self._feed_counter(self.watch_dispatch, (kind, result),
                                   total)
        if self.manager is not None:
            stats = self.manager.queue_stats()
            for name in stats["controllers"]:
                self.workqueue_depth.labels(name).set(
                    stats["depth"].get(name, 0))
                self.workqueue_backoff_pending.labels(name).set(
                    stats["backoff_pending"].get(name, 0))
                self._feed_counter(self.workqueue_retries_total, name,
                                   stats["retries_total"].get(name, 0))
                self.workqueue_last_backoff_seconds.labels(name).set(
                    stats["last_backoff_s"].get(name, 0.0))
                self.workqueue_longest_running.labels(name).set(
                    stats.get("longest_running_s", {}).get(name, 0.0))
                self._feed_counter(self.reconcile_errors_total, name,
                                   stats["errors_total"].get(name, 0))
        if self.shards is not None:
            # before the SLO engine: the handoff-stall objective reads
            # the histogram this feeds
            self._scrape_shards()
        if self.dataplane is not None:
            # data-plane rollup first: the SLO engine's straggler/MFU
            # objectives read the verdict counters this evaluation feeds
            self.dataplane.evaluate()
        if self.metering is not None:
            # metering round before the SLO engine: the tenant_fairness
            # objective reads the verdict counter this evaluation feeds
            self._feed_metering()
        # cardinality-guard visibility: fold per-family drop counts from
        # every scraped registry into the one exported counter
        self._feed_labelsets_dropped()
        if self.slo is not None:
            # burn rates / budget gauges / alert lifecycle advance at
            # scrape resolution, exactly like a Prometheus-side burn rule
            self.slo.evaluate()
        if self.tsdb is not None:
            # last, so the sample reads this scrape's fresh evaluations
            self._feed_tsdb()
        if self.diagnosis is not None:
            # after the TSDB feed: the change-point detector consumes the
            # raw point this scrape just appended
            self.diagnosis.evaluate()
        return self.render(openmetrics=openmetrics)

    def _feed_metering(self) -> None:
        """One metering round: decode the placement census (cache
        aggregate, list-scan fallback), snapshot the apiserver's tenant
        verb counts, and run the ledger's accrual + noisy-neighbor
        evaluation."""
        census: dict[tuple[str, str], tuple[str, float]] = {}
        cache = getattr(self.manager, "cache", None)
        if cache is not None and self._ensure_census(cache):
            sums = cache.aggregate("Notebook", "tenant-metering").items()
        else:
            sums_d: dict[str, float] = {}
            for nb in self.api.list("Notebook"):
                for key, v in self._metering_census(nb).items():
                    sums_d[key] = v
            sums = sums_d.items()
        for key, chips in sums:
            parts = key.split(self._SEP)
            census[(parts[0], parts[1])] = (parts[2], chips)
        verbs = getattr(self.api, "tenant_verb_counts", None)
        self.metering.evaluate(
            census=census,
            verb_counts=verbs() if verbs is not None else None)

    def _feed_labelsets_dropped(self) -> None:
        """Advance metrics_labelsets_dropped_total to the summed per-family
        drop counts of every registry this exposition scrapes."""
        regs = [self.registry]
        mgr_registry = getattr(self.manager, "metrics_registry", None)
        if mgr_registry is not None:
            regs.append(mgr_registry)
        merged: dict[str, float] = {}
        for reg in regs:
            dropped = getattr(reg, "labelsets_dropped", None)
            if dropped is None:
                continue
            for family, n in dropped().items():
                merged[family] = merged.get(family, 0.0) + n
        for family, total in sorted(merged.items()):
            self._feed_counter(self.labelsets_dropped, family, total)

    def _tsdb_delta(self, key: str, total: float) -> float:
        """Per-scrape delta of a cumulative total (floored at 0 across
        source resets) for the TSDB's *_delta series."""
        prev = self._tsdb_prev.get(key, 0.0)
        self._tsdb_prev[key] = total
        return max(total - prev, 0.0)

    def _feed_tsdb(self) -> None:
        """One TSDB sample per scrape: the handful of series whose curves
        answer 'where does it bend' — ready/reaction p99s, queue state,
        fleet size, and the lifecycle stage p99s."""
        clock = self._tsdb_clock or getattr(self.manager, "clock", None)
        if clock is None:
            return
        values: dict[str, float] = {
            "ready_p99_s": histogram_quantile(
                self.notebook_ready_seconds, 0.99),
            "event_to_reconcile_p99_s": 0.0,
            "notebooks_running": sum(
                self.running.collect().values()),
        }
        mgr_registry = getattr(self.manager, "metrics_registry", None)
        if mgr_registry is not None:
            e2r = mgr_registry.get("notebook_event_to_reconcile_seconds")
            if e2r is not None:
                values["event_to_reconcile_p99_s"] = \
                    histogram_quantile(e2r, 0.99)
            rt = mgr_registry.get("controller_runtime_reconcile_total")
            if rt is not None:
                counts = rt.collect()
                values["reconciles_total"] = sum(counts.values())
                # errored ATTEMPTS (not retry-budget drops): the rate a
                # fault-plan window actually moves
                values["reconcile_errors_delta"] = self._tsdb_delta(
                    "reconcile_errors",
                    float(sum(v for k, v in counts.items()
                              if "error" in k)))
        if self.manager is not None:
            stats = self.manager.queue_stats()
            values["workqueue_depth"] = float(
                sum(stats["depth"].values()))
            values["workqueue_backoff_pending"] = float(
                sum(stats["backoff_pending"].values()))
        # level-shift-friendly shapes for the diagnosis engine: active
        # straggler count plus per-scrape deltas of the promotion counter
        # (cumulative totals ramp forever; only their rate level-shifts)
        straggler = self.registry.get("notebook_dataplane_straggler")
        if straggler is not None:
            values["dataplane_stragglers"] = float(
                sum(straggler.collect().values()))
        promotions = self.registry.get("notebook_promotions_total")
        if promotions is not None:
            values["promotions_delta"] = self._tsdb_delta(
                "promotions", float(sum(promotions.collect().values())))
        if self.lifecycle is not None:
            for stage, p99 in self.lifecycle.stage_p99s().items():
                values["stage_p99.%s" % stage] = p99
            cons = self.lifecycle.conservation()
            values["criticalpath_finalized"] = float(cons["finalized"])
            values["criticalpath_violations"] = float(cons["violations"])
        if self.metering is not None:
            # top-K tenant chip-second curves + the conservation gate's
            # violation count over time (/debug/timeline)
            for tenant, chips in self.metering.tenant_chip_series().items():
                values["tenant_chip_seconds.%s" % tenant] = chips
            mcons = self.metering.conservation()
            values["metering_violations"] = float(mcons["violations"])
        self.tsdb.sample(clock.now(), values)

    def _scrape_shards(self) -> None:
        """Feed the notebook_shard_* families from the attached fleet:
        per-replica gauges, fenced-rejection counter deltas, and any
        handoff durations completed since the previous scrape."""
        snap = self.shards.shard_snapshot()
        for sid, rep in snap["replicas"].items():
            self.shard_keys_owned.labels(sid).set(rep["keys_owned"])
            self.shard_epoch.labels(sid).set(rep["epoch"])
            self._feed_counter(self.shard_fenced_writes, sid,
                               rep["fenced_rejections"])
        for sid, replica in self.shards.replicas.items():
            durations = replica.handoff_durations
            fed = self._handoff_fed.get(sid, 0)
            for d in durations[fed:]:
                self.shard_handoff_duration.observe(d)
            self._handoff_fed[sid] = len(durations)

    # -- fleet rollup (/debug/fleet) ------------------------------------------
    def fleet_snapshot(self) -> dict:
        """Per-namespace / per-shape health rollup from the cache's
        incremental fleet-census sums (list-scan fallback without a
        cache), plus the SLO engine's last verdicts when attached."""
        per_ns: dict[str, dict[str, int]] = {}
        per_shape: dict[str, dict[str, int]] = {}
        totals: dict[str, int] = {s: 0 for s in FLEET_STATES}
        cache = getattr(self.manager, "cache", None)
        if cache is not None and self._ensure_census(cache):
            sums = cache.aggregate("Notebook", "fleet-census").items()
        else:
            sums_d: dict[str, float] = {}
            for nb in self.api.list("Notebook"):
                for key, v in self._fleet_census(nb).items():
                    sums_d[key] = sums_d.get(key, 0.0) + v
            sums = sums_d.items()
        for key, v in sums:
            parts = key.split(self._SEP)
            n = int(v)
            if n <= 0:
                continue  # drained series linger at 0 in the aggregate
            if parts[0] == "ns":
                per_ns.setdefault(parts[1], {})[parts[2]] = n
                totals[parts[2]] = totals.get(parts[2], 0) + n
            elif parts[0] == "shape":
                per_shape.setdefault(parts[1], {})[parts[2]] = n
        out = {
            "states": list(FLEET_STATES),
            "notebooks": sum(totals.values()),
            "totals": totals,
            "namespaces": {ns: dict(sorted(states.items()))
                           for ns, states in sorted(per_ns.items())},
            "shapes": {sh: dict(sorted(states.items()))
                       for sh, states in sorted(per_shape.items())},
        }
        if self.slo is not None:
            snap = self.slo.snapshot()
            out["slo"] = {
                "objectives": snap["objectives"],
                "firing": snap["firing"],
            }
        if self.dataplane is not None:
            out["dataplane"] = self.dataplane.snapshot()
        if self.shards is not None:
            out["shards"] = self.shards.shard_snapshot()
        if self.lifecycle is not None:
            # the tenants view: ready-time and stage-latency by namespace
            # (the seed signal for fairness/starvation gates), plus the
            # fleet critical path so /debug/fleet alone answers "which
            # stage dominates and for whom"
            out["stage_latency"] = self.lifecycle.namespace_rollup()
            out["criticalpath"] = {
                "ranking": self.lifecycle.ranking(),
                "conservation": self.lifecycle.conservation(),
            }
        if self.metering is not None:
            # the tenant accounting view: per-tenant usage, top-K
            # consumers, fairness verdicts, and the chip-second
            # conservation gate — /debug/fleet alone reconstructs a
            # noisy-neighbor incident
            out["tenants"] = self.metering.snapshot()
        # the tenancy view (always present, zeros when the scheduler /
        # quota layer is off): per-tenant queue depth, placed chip usage,
        # configured quota/weights, and recent preemptions
        out["tenancy"] = self.tenancy_snapshot()
        if self.diagnosis is not None:
            # the causal view: change-point counts and the most recent
            # annotated findings (full detail at /debug/changepoints,
            # per-object verdicts at /debug/explain)
            out["diagnosis"] = self.diagnosis.fleet_summary()
        return out

    def tenancy_snapshot(self) -> dict:
        """Per-tenant tenancy view for /debug/fleet and /debug/tenants:
        queue depth + oldest queued-since per namespace (off the queued
        annotations the admission gate stamps), placed chip usage, the
        TenantQuota policy when one exists, and the write-ahead
        preemption bookkeeping (pending records + recent completions)."""
        reader = getattr(self.manager, "cache", None) or self.api
        queued: dict[str, dict] = {}
        usage: dict[str, float] = {}
        try:
            notebooks = reader.list("Notebook")
        except Exception:  # noqa: BLE001 — degraded backends must not
            notebooks = []  # break the debug surface
        for nb in notebooks:
            ann = nb.metadata.annotations or {}
            if C.ANNOTATION_PLACEMENT in ann:
                usage[nb.namespace] = \
                    usage.get(nb.namespace, 0.0) + placement_gpus(nb)
            raw = ann.get(C.ANNOTATION_QUEUED)
            if raw:
                try:
                    info = json.loads(raw)
                except ValueError:
                    info = {}
                ent = queued.setdefault(
                    nb.namespace, {"depth": 0, "oldest_since": None})
                ent["depth"] += 1
                since = info.get("since")
                if isinstance(since, (int, float)) and (
                        ent["oldest_since"] is None
                        or since < ent["oldest_since"]):
                    ent["oldest_since"] = since
        out: dict = {
            "queued": {ns: dict(v) for ns, v in sorted(queued.items())},
            "usage_chips": dict(sorted(usage.items())),
            "quota": {},
            "pending_preemptions": 0,
            "recent_preemptions": [],
        }
        try:
            qobj = self.api.try_get(C.TENANTQUOTA_KIND, "",
                                    C.TENANTQUOTA_NAME)
        except Exception:  # noqa: BLE001
            qobj = None
        if qobj is not None:
            out["quota"] = copy.deepcopy(qobj.spec.get("tenants") or {})
            st = qobj.body.get("status") or {}
            out["pending_preemptions"] = len(st.get("preemptions") or {})
            out["recent_preemptions"] = copy.deepcopy(
                list(st.get("recentPreemptions") or [])[-8:])
        return out

    def _scrape_census_from_cache(self, cache) -> None:
        """Census gauges off the cache's incremental aggregates."""
        running: dict[str, int] = {}
        for key, v in cache.aggregate("StatefulSet", "nb-census").items():
            parts = key.split(self._SEP)
            if parts[0] == "run":
                running[parts[1]] = running.get(parts[1], 0) + 1
            elif parts[0] == "gpus":
                self.gpus_requested.labels(parts[1]).set(v)
        for ns, n in running.items():
            self.running.labels(ns).set(n)
        seen_shapes: set[str] = set()
        per_state: dict[tuple[str, str], float] = {}
        for key, v in cache.aggregate(C.WARMPOOL_KIND,
                                      "warmpool-census").items():
            parts = key.split(self._SEP)
            if parts[0] == "shape":
                seen_shapes.add(parts[1])
            elif parts[0] == "state":
                per_state[(parts[1], parts[2])] = v
        # every shape x state combination is set each scrape (zeros
        # included) so a drained state reads 0, not stale
        for shape in seen_shapes:
            for state in C.WARMSLICE_STATES:
                self.warmpool_size.labels(shape, state).set(
                    per_state.get((shape, state), 0.0))
        # a GPUWarmPool deleted between scrapes would otherwise leave its
        # shape's series frozen at the last census — drive them to 0
        for shape in self._warmpool_shapes - seen_shapes:
            for state in C.WARMSLICE_STATES:
                self.warmpool_size.labels(shape, state).set(0)
        self._warmpool_shapes = seen_shapes

    def _scrape_census_from_lists(self) -> None:
        """Legacy list-based census (metrics.go:82-99): the no-cache
        fallback path; O(objects) per scrape."""
        running_notebooks: dict[str, set[str]] = {}  # ns -> notebook names
        per_ns_gpus: dict[str, float] = {}
        for sts in self.api.list("StatefulSet"):
            contrib = self._sts_census(sts)
            for key, v in contrib.items():
                parts = key.split(self._SEP)
                if parts[0] == "run":
                    running_notebooks.setdefault(parts[1], set()).add(
                        parts[2])
                elif parts[0] == "gpus":
                    per_ns_gpus[parts[1]] = \
                        per_ns_gpus.get(parts[1], 0.0) + v
        for ns, names in running_notebooks.items():
            self.running.labels(ns).set(len(names))
        for ns, n in per_ns_gpus.items():
            self.gpus_requested.labels(ns).set(n)
        try:
            pools = self.api.list(C.WARMPOOL_KIND)
        except Exception:  # noqa: BLE001 — a real-cluster backend without
            pools = []     # the CRD must not break the scrape
        seen_shapes: set[str] = set()
        for pool in pools:
            counts: dict[tuple[str, str], float] = {}
            shape = ""
            for key, v in self._warmpool_census(pool).items():
                parts = key.split(self._SEP)
                if parts[0] == "shape":
                    shape = parts[1]
                    seen_shapes.add(shape)
                elif parts[0] == "state":
                    counts[(parts[1], parts[2])] = v
            if shape:
                for state in C.WARMSLICE_STATES:
                    self.warmpool_size.labels(shape, state).set(
                        counts.get((shape, state), 0.0))
        for shape in self._warmpool_shapes - seen_shapes:
            for state in C.WARMSLICE_STATES:
                self.warmpool_size.labels(shape, state).set(0)
        self._warmpool_shapes = seen_shapes

    def render(self, openmetrics: bool = False) -> str:
        """Full exposition: this registry plus the attached manager's
        reconcile/workqueue registry (controller_runtime_reconcile_*,
        workqueue_*_duration_seconds) as one scrape body.  Families are
        disjoint between the two registries, so the combined text stays a
        valid single exposition.  The OpenMetrics variant carries bucket
        exemplars and ends with the spec-required `# EOF` terminator."""
        text = self.registry.render(openmetrics=openmetrics)
        mgr_registry = getattr(self.manager, "metrics_registry", None)
        if mgr_registry is not None:
            text += mgr_registry.render(openmetrics=openmetrics)
        if openmetrics:
            text += "# EOF\n"
        return text

    def families(self) -> list[tuple[str, str]]:
        """(name, kind) inventory across both registries."""
        fams = self.registry.families()
        mgr_registry = getattr(self.manager, "metrics_registry", None)
        if mgr_registry is not None:
            fams += mgr_registry.families()
        return fams


__all__ = ["FLEET_STATES", "NotebookMetrics", "fleet_state",
           "histogram_quantile", "metering_bucket", "placement_gpus"]
