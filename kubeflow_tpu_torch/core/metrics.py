"""Notebook controller metrics: the port of kubeflow_tpu/core/metrics.py's
`NotebookMetrics`, for the families the port's reconcilers write.

Counters for creations, failures, cullings and cull checkpoints, the
last-cull timestamp, the first-readiness histogram, the self-healing
engine's restarts, migrations, checkpoint ages and recovery latency
(core/selfheal.py), the replicated tier's promotions, promotion latency
and fenced writes, the gang scheduler's attempts, warm-pool claims
and pool census and the tenancy layer's preemptions and queue wait
(core/scheduler.py, core/preemption.py), and a scraper-style
gauge that counts running notebooks from the workload StatefulSets
carrying the notebook-name label, with the GPUs their running gangs
request beside it.  The families keep the reference's names and labels,
on the port's `utils/metrics.py` Registry; the GPU gauge is the twin of
the reference's `notebook_tpu_chips_requested`.

The reference's other registrations (diagnosis, lifecycle, metering,
profiler, SLO, data plane, shards) wait for the modules that
write them (`ROADMAP.md` queue 1 item 16).
"""

from __future__ import annotations

from typing import Optional

from ..api.types import GPUSpec, InvalidError
from ..kube import ApiServer, parse_quantity
from ..utils.metrics import Registry
from . import constants as C


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


class NotebookMetrics:
    # the census keys' separator (never in a namespace or notebook name)
    _SEP = "\x1f"

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
        # self-healing (core/selfheal.py): gang-atomic restarts performed
        # by the recovery engine, labeled by the disruption classification
        # (a bounded set, selfheal.REASON_*), and the disruption-detected
        # -> gang-Healthy-again latency distribution
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
        # session checkpoints the controllers recorded or confirmed
        # (trigger: final from the migrate verb, cull from the culler), the
        # checkpoint age at each migrate decision, and the migrate verb's
        # outcomes (trigger and result are the bounded selfheal.MIGRATE_*
        # sets)
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
        # replicated-kernel tier (spec.replication and the promote verb):
        # promotion outcomes (result is the bounded selfheal
        # PROMOTE_RESULT_* set), the primary-failure -> follower-promoted
        # latency, and session-store writes the epoch fence rejected (a
        # demoted primary tried to write after its demotion).  Names,
        # help strings, labels and buckets are the reference's.
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
        # gang scheduler and warm pool (core/scheduler.py): per-reconcile
        # scheduling outcomes (result is the bounded scheduler.SCHEDULE_*
        # set), per-claim warm-pool outcomes (hit | miss | bypass), and the
        # per-shape pool census recomputed at scrape time from the
        # GPUWarmPool objects (state: Provisioning | Ready | Claimed).
        # Names, help strings and buckets are the reference's.
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
        # tenancy layer (the scheduler's admission gate and
        # core/preemption.py): preemption outcomes (result is the bounded
        # preemption.PREEMPT_* set, priority the victim's class, or the
        # beneficiary's for result="no-victim"), and the quota/fair-share
        # queue wait from first queuing to placement intent written
        # (observed as 0 for gangs that never queued, so the distribution
        # covers every placement)
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
        # the pool shapes the last scrape saw, so that a deleted pool's
        # series read 0 rather than freeze at their last census
        self._warmpool_shapes: set[str] = set()

    def attach_manager(self, manager) -> None:
        self.manager = manager

    @classmethod
    def _sts_census(cls, sts) -> dict:
        """One StatefulSet's contribution: a running key per (namespace,
        notebook) while it has replicas, and the GPUs its pods request."""
        nb_name = (sts.spec.get("template", {}).get("metadata", {})
                   .get("labels", {}).get(C.NOTEBOOK_NAME_LABEL))
        if nb_name is None:
            return {}
        out: dict[str, float] = {}
        replicas = int(sts.spec.get("replicas", 0) or 0)
        if replicas > 0:
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
        """One GPUWarmPool's contribution: its shape ("h100-80gb-8"), so
        an empty pool still zero-fills its series, and its entries by
        state; bypass claims are not pool capacity."""
        shape = "%s-%s" % (pool.spec.get("accelerator", ""),
                           pool.spec.get("count", ""))
        out: dict[str, float] = {cls._SEP.join(("shape", shape)): 1.0}
        for e in (pool.body.get("status", {}).get("slices") or {}).values():
            if e.get("external"):
                continue
            state = e.get("state", "")
            if state in C.WARMSLICE_STATES:
                key = cls._SEP.join(("state", shape, state))
                out[key] = out.get(key, 0.0) + 1.0
        return out

    def _set_warmpool_census(self, census: dict) -> None:
        """Every shape x state series is set each scrape, zeros included,
        so a drained state reads 0; a pool deleted since the last scrape
        has its series driven to 0."""
        seen: set[str] = set()
        per_state: dict[tuple[str, str], float] = {}
        for key, v in census.items():
            parts = key.split(self._SEP)
            if parts[0] == "shape":
                seen.add(parts[1])
            elif parts[0] == "state":
                per_state[(parts[1], parts[2])] = v
        for shape in seen:
            for state in C.WARMSLICE_STATES:
                self.warmpool_size.labels(shape, state).set(
                    per_state.get((shape, state), 0.0))
        for shape in self._warmpool_shapes - seen:
            for state in C.WARMSLICE_STATES:
                self.warmpool_size.labels(shape, state).set(0)
        self._warmpool_shapes = seen

    def scrape(self, openmetrics: bool = False) -> str:
        """Recompute the census gauges (off the informer cache's
        incremental aggregates when a manager is attached, else by listing
        StatefulSets and GPUWarmPools) and render the exposition."""
        cache = getattr(self.manager, "cache", None)
        if cache is not None:
            # registered once (idempotent), then kept by the watch stream
            cache.add_aggregate("StatefulSet", "nb-census", self._sts_census)
            cache.add_aggregate(C.WARMPOOL_KIND, "warmpool-census",
                                self._warmpool_census)
            census = cache.aggregate("StatefulSet", "nb-census")
            self._set_warmpool_census(
                cache.aggregate(C.WARMPOOL_KIND, "warmpool-census"))
        else:
            census = {}
            for sts in self.api.list("StatefulSet"):
                for key, v in self._sts_census(sts).items():
                    census[key] = census.get(key, 0.0) + v
            pools: dict[str, float] = {}
            for pool in self.api.list(C.WARMPOOL_KIND):
                for key, v in self._warmpool_census(pool).items():
                    pools[key] = pools.get(key, 0.0) + v
            self._set_warmpool_census(pools)
        running: dict[str, int] = {}
        for key, v in census.items():
            parts = key.split(self._SEP)
            if parts[0] == "run":
                running[parts[1]] = running.get(parts[1], 0) + 1
            elif parts[0] == "gpus":
                self.gpus_requested.labels(parts[1]).set(v)
        for ns, n in running.items():
            self.running.labels(ns).set(n)
        return self.render(openmetrics=openmetrics)

    def render(self, openmetrics: bool = False) -> str:
        """This registry plus the attached manager's reconcile/workqueue
        registry as one exposition (OpenMetrics ends with `# EOF`)."""
        text = self.registry.render(openmetrics=openmetrics)
        mgr_registry = getattr(self.manager, "metrics_registry", None)
        if mgr_registry is not None:
            text += mgr_registry.render(openmetrics=openmetrics)
        if openmetrics:
            text += "# EOF\n"
        return text


__all__ = ["NotebookMetrics", "placement_gpus"]
