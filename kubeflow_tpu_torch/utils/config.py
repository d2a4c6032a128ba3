"""Env-var configuration surface: the port's copy of
kubeflow_tpu/utils/config.py's `CoreConfig` and `OdhConfig`.

The reference's de-facto config system is environment variables fed by
kustomize params ConfigMaps; the same variable names bind into an
injectable Config object so tests don't mutate process env.  The port
keeps the fields its controllers read, under the reference's env names,
defaults and parses: among them the slice scheduler's gang gate, warm
pool and tenancy layer (core/scheduler.py, core/preemption.py), the
Istio VirtualService's switch, gateway and host, and the observability
plane's: the SLO objectives and windows, the profiler, the data-plane
rollup, the lifecycle and metering ledgers and the TSDB, and the sharded
fleet's (kube/shard.py: SHARD_COUNT, its lease and handoff objective)
and the interleave checker's budget (testing/interleave.py).
`OdhConfig` is the ODH plane's (odh/), with GPU_DEFAULT_IMAGE and the
GPU image map as the twins of the reference's TPU ones.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Mapping, Optional


SA_NAMESPACE_FILE = "/var/run/secrets/kubernetes.io/serviceaccount/namespace"


def detect_namespace(default: str = "default",
                     env: Optional[Mapping[str, str]] = None) -> str:
    """Controller namespace: K8S_NAMESPACE env var, else the in-cluster
    ServiceAccount token mount, else `default` (odh main.go:127-139).
    The single source of truth — kube.client re-exports this.  Passing an
    explicit `env` mapping keeps the lookup hermetic (an empty mapping never
    falls through to os.environ or the SA mount — tests with from_env({})
    must not pick up ambient cluster state)."""
    hermetic = env is not None
    env = env if env is not None else os.environ
    ns = env.get("K8S_NAMESPACE", "")
    if ns:
        return ns
    if hermetic:
        return default
    try:
        with open(SA_NAMESPACE_FILE) as f:
            return f.read().strip() or default
    except OSError:
        return default


def _bool(env: Mapping[str, str], key: str, default: bool) -> bool:
    v = env.get(key)
    if v is None:
        return default
    return v.strip().lower() == "true"


def _int(env: Mapping[str, str], key: str, default: int) -> int:
    v = env.get(key)
    if v is None or not v.strip():
        return default
    try:
        return int(v)
    except ValueError:
        return default


def _float(env: Mapping[str, str], key: str, default: float) -> float:
    """Float knob parse.  Duration knobs MUST come through here, not
    `_int`: a sub-second value would fall back to the default under
    int()."""
    v = env.get(key)
    if v is None or not v.strip():
        return default
    try:
        return float(v)
    except ValueError:
        return default


@dataclass
class CoreConfig:
    """Core notebook-controller config (reference main.go:58-148 flags +
    controller env vars)."""

    # culling (culling_controller.go:32-42)
    enable_culling: bool = False
    cull_idle_time_min: int = 1440       # CULL_IDLE_TIME
    idleness_check_period_min: int = 1   # IDLENESS_CHECK_PERIOD
    cluster_domain: str = "cluster.local"
    dev: bool = False
    # workload rendering (notebook_controller.go:238,514): USE_ISTIO adds
    # the VirtualService through ISTIO_GATEWAY for ISTIO_HOST
    use_istio: bool = False
    istio_gateway: str = "kubeflow/kubeflow-gateway"
    istio_host: str = "*"
    add_fsgroup: bool = True
    # signal the gang's training loop before the culler stops it
    checkpoint_before_cull: bool = False
    # workqueue rate limiting (kube.controller.default_rate_limiter):
    # per-item exponential backoff base/cap + overall token bucket,
    # mirroring controller-runtime's DefaultControllerRateLimiter
    workqueue_base_delay_s: float = 0.005   # WORKQUEUE_BASE_DELAY_MS / 1000
    workqueue_max_delay_s: float = 1000.0   # WORKQUEUE_MAX_DELAY_S
    workqueue_qps: float = 10.0             # WORKQUEUE_QPS
    workqueue_burst: int = 100              # WORKQUEUE_BURST
    # parallel reconcile workers (controller-runtime MaxConcurrentReconciles
    # analog, shared across controllers): per-key serialization always holds
    workqueue_workers: int = 1              # WORKQUEUE_WORKERS
    # per-kind watch-history ring size on the in-memory ApiServer
    # (kube/store.py): each kind retains this many events for
    # subscribe(since_rv) resume; a resume older than a kind's retained
    # window gets 410 Gone and relists.  Sized per kind, so one chatty
    # kind cannot evict another's resume window.
    watch_history_size: int = 2048          # WATCH_HISTORY_SIZE
    # slice-atomic self-healing (core/selfheal.py): budgeted recovery of
    # disrupted GPU gangs.  Backoff between gang restarts is exponential
    # (base * 2^n, capped); at most recovery_max_attempts restarts within a
    # sliding recovery_window_s before the gang is declared
    # RecoveryExhausted; a worker Pending longer than
    # recovery_pending_deadline_s counts as disrupted.
    enable_self_healing: bool = True          # ENABLE_SELF_HEALING
    recovery_backoff_base_s: float = 10.0     # RECOVERY_BACKOFF_BASE_S
    recovery_backoff_max_s: float = 300.0     # RECOVERY_BACKOFF_MAX_S
    recovery_max_attempts: int = 5            # RECOVERY_MAX_ATTEMPTS
    recovery_window_s: float = 3600.0         # RECOVERY_WINDOW_S
    recovery_pending_deadline_s: float = 300.0  # RECOVERY_PENDING_DEADLINE_S
    # the checkpoint-sidecar contract: a non-empty store URI turns it on
    # in the rendered pod template and teaches the recovery engine the
    # `migrate` verb.  A checkpoint older than checkpoint_max_age_s is
    # stale: the engine falls back to a bare restart.
    # checkpoint_signal_root hosts the per-notebook cull-signal dirs the
    # CullSignalWatcher polls (empty = annotation handshake only).
    checkpoint_store_uri: str = ""            # CHECKPOINT_STORE_URI
    checkpoint_interval_s: float = 300.0      # CHECKPOINT_INTERVAL_S
    checkpoint_max_age_s: float = 600.0       # CHECKPOINT_MAX_AGE_S
    checkpoint_signal_root: str = ""          # CHECKPOINT_SIGNAL_ROOT
    # replicated-kernel tier (spec.replication, core/selfheal.py's promote
    # verb): a follower counts as caught up, and may be promoted, when it
    # has applied the latest base snapshot and trails the delta chain
    # head by at most replication_max_lag deltas.  slo_promotion_p99_s
    # bounds the promote verb's latency objective (<= 0 disables it).
    replication_max_lag: int = 2              # REPLICATION_MAX_LAG
    slo_promotion_p99_s: float = 1.0          # SLO_PROMOTION_P99_S
    # topology-aware gang scheduler (core/scheduler.py): with it on, a GPU
    # notebook renders no StatefulSet until an all-or-nothing placement
    # intent covers its gang, and a warm pool of pre-provisioned gangs per
    # shape (WARMPOOL_SHAPES, e.g. "h100-80gb:8,h100-80gb:16") turns a
    # notebook start into a claim instead of a cold provision
    # (warmpool_provision_s of fake or real time).  The autoscaler grows
    # the per-shape target on misses (bounded by warmpool_max_size) and
    # decays it back toward warmpool_size while the observed hit rate
    # holds above warmpool_target_hit_rate.
    enable_slice_scheduler: bool = False      # ENABLE_SLICE_SCHEDULER
    warmpool_size: int = 0                    # WARMPOOL_SIZE
    warmpool_shapes: str = ""                 # WARMPOOL_SHAPES
    warmpool_provision_s: float = 120.0       # WARMPOOL_PROVISION_S
    warmpool_max_size: int = 64               # WARMPOOL_MAX_SIZE
    warmpool_target_hit_rate: float = 0.9     # WARMPOOL_TARGET_HIT_RATE
    warmpool_decay_s: float = 600.0           # WARMPOOL_DECAY_S
    # tenancy layer (core/scheduler.py's admission gate and
    # core/preemption.py's checkpoint-then-preempt).  A gang over its
    # tenant's GPU quota or weighted fair share queues
    # (sliceHealth "Queued") and is re-examined every queue_requeue_s;
    # the dequeue order is the aged weighted fair-share score
    # priority_rank + weight * age / queue_aging_s, so no queued gang
    # starves.  enable_preemption gates checkpoint-then-preempt and is on
    # by default, as in the reference.  slo_placement_p99_s bounds the
    # queue-wait (time-to-placement) objective (<= 0 disables it).
    enable_preemption: bool = True            # ENABLE_PREEMPTION
    queue_requeue_s: float = 15.0             # QUEUE_REQUEUE_S
    queue_aging_s: float = 60.0               # QUEUE_AGING_S
    slo_placement_p99_s: float = 0.0          # SLO_PLACEMENT_P99_S
    # fleet SLO engine (utils/slo.py): declared objectives over the
    # metric streams, evaluated into multi-window burn rates at every
    # scrape.  Latency knobs are p99 ceilings; a knob <= 0 disables its
    # objective.  Alerts fire when every window burns the error budget
    # faster than slo_burn_alert_threshold, and resolve when the short
    # window recovers; served at /debug/alerts.
    slo_time_to_ready_p99_s: float = 600.0      # SLO_TIME_TO_READY_P99_S
    slo_event_to_reconcile_p99_s: float = 30.0  # SLO_EVENT_TO_RECONCILE_P99_S
    slo_reconcile_error_rate: float = 0.01      # SLO_RECONCILE_ERROR_RATE
    slo_recovery_p99_s: float = 300.0           # SLO_RECOVERY_DURATION_P99_S
    slo_warmpool_hit_rate: float = 0.6          # SLO_WARMPOOL_HIT_RATE
    slo_short_window_s: float = 300.0           # SLO_SHORT_WINDOW_S
    slo_long_window_s: float = 3600.0           # SLO_LONG_WINDOW_S
    slo_burn_alert_threshold: float = 2.0       # SLO_BURN_ALERT_THRESHOLD
    # continuous sampling profiler (utils/profiler.py): (controller,
    # phase) CPU attribution at /debug/profile, off by default (a
    # real-time sampler thread); its self-overhead is exported as
    # notebook_profiler_overhead_ratio when on.
    enable_continuous_profiler: bool = False    # ENABLE_CONTINUOUS_PROFILER
    profiler_interval_ms: float = 10.0          # PROFILER_INTERVAL_MS
    # data-plane telemetry (runtime/telemetry.py's TelemetryAgent
    # publishes rolling summaries into pod annotations; core/telemetry.py
    # rolls them up at every scrape).  A worker whose rolling step time
    # exceeds dataplane_straggler_ratio x the gang median (with at least
    # dataplane_straggler_min_workers reporting) fires the straggler gauge
    # and a Warning event, never a healing action.  dataplane_mfu_target
    # feeds the fleet-MFU objective's low/ok verdict counter;
    # slo_fleet_mfu / slo_straggler_rate <= 0 keep those objectives off.
    dataplane_straggler_ratio: float = 1.5      # DATAPLANE_STRAGGLER_RATIO
    dataplane_straggler_min_workers: int = 2    # DATAPLANE_STRAGGLER_MIN_WORKERS
    dataplane_mfu_target: float = 0.0           # DATAPLANE_MFU_TARGET
    slo_fleet_mfu: float = 0.0                  # SLO_FLEET_MFU
    slo_straggler_rate: float = 0.0             # SLO_STRAGGLER_RATE
    # sharded control plane (kube/shard.py, main.build_sharded_fleet):
    # shard_count replicas over a fenced ControlPlaneShardMap;
    # shard_lease_duration_s is each member's lease (a dead replica is
    # evicted once its lease ages past it).  slo_shard_handoff_p99_s
    # bounds the handoff duration (commit -> last ack); <= 0 keeps the
    # objective off.
    shard_count: int = 1                        # SHARD_COUNT
    shard_lease_duration_s: float = 15.0        # SHARD_LEASE_DURATION_S
    slo_shard_handoff_p99_s: float = 0.0        # SLO_SHARD_HANDOFF_P99_S
    # schedule-exploring model checker (testing/interleave.py): per-test
    # exploration budget, distinct-schedule cap and wall cap, whichever
    # bites first
    interleave_max_schedules: int = 1200        # INTERLEAVE_MAX_SCHEDULES
    interleave_budget_s: float = 60.0           # INTERLEAVE_BUDGET_S
    # lifecycle stage ledger (utils/lifecycle.py): event->ready
    # critical-path attribution behind /debug/criticalpath; the LRU of
    # ledgers, the per-stage p99 sample ring and the conservation gate.
    lifecycle_max_notebooks: int = 4096         # LIFECYCLE_MAX_NOTEBOOKS
    lifecycle_samples_per_stage: int = 2048     # LIFECYCLE_SAMPLES_PER_STAGE
    lifecycle_tolerance: float = 0.05           # LIFECYCLE_TOLERANCE
    # in-process time-series store (utils/tsdb.py): raw ring plus 10s and
    # 60s tiers per series, fed once per scrape, at /debug/timeline.
    tsdb_raw_capacity: int = 512                # TSDB_RAW_CAPACITY
    tsdb_tier10_capacity: int = 1024            # TSDB_TIER10_CAPACITY
    tsdb_tier60_capacity: int = 1024            # TSDB_TIER60_CAPACITY
    tsdb_max_series: int = 256                  # TSDB_MAX_SERIES
    # tenant metering ledger (utils/metering.py): per-namespace
    # chip-seconds (one GPU is one chip) and control-plane attribution
    # behind /debug/tenants.  A tenant whose rolling control-plane share
    # exceeds tenant_fairshare_factor x fair share while another
    # tenant's event->reconcile p99 is degraded is flagged noisy;
    # slo_tenant_fairness > 0 turns on the tenant_fairness objective.
    metering_max_tenants: int = 64              # METERING_MAX_TENANTS
    metering_max_notebooks: int = 4096          # METERING_MAX_NOTEBOOKS
    metering_tolerance: float = 0.05            # METERING_TOLERANCE
    tenant_fairshare_factor: float = 3.0        # TENANT_FAIRSHARE_FACTOR
    tenant_top_k: int = 8                       # TENANT_TOP_K
    slo_tenant_fairness: float = 0.01           # SLO_TENANT_FAIRNESS

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "CoreConfig":
        env = env if env is not None else os.environ
        return cls(
            enable_culling=_bool(env, "ENABLE_CULLING", False),
            cull_idle_time_min=_int(env, "CULL_IDLE_TIME", 1440),
            idleness_check_period_min=_int(env, "IDLENESS_CHECK_PERIOD", 1),
            cluster_domain=env.get("CLUSTER_DOMAIN", "cluster.local"),
            dev=_bool(env, "DEV", False),
            use_istio=_bool(env, "USE_ISTIO", False),
            istio_gateway=env.get("ISTIO_GATEWAY", "kubeflow/kubeflow-gateway"),
            istio_host=env.get("ISTIO_HOST", "*"),
            add_fsgroup=_bool(env, "ADD_FSGROUP", True),
            checkpoint_before_cull=_bool(env, "CHECKPOINT_BEFORE_CULL", False),
            workqueue_base_delay_s=_int(
                env, "WORKQUEUE_BASE_DELAY_MS", 5) / 1000.0,
            workqueue_max_delay_s=float(
                _int(env, "WORKQUEUE_MAX_DELAY_S", 1000)),
            workqueue_qps=float(_int(env, "WORKQUEUE_QPS", 10)),
            workqueue_burst=_int(env, "WORKQUEUE_BURST", 100),
            workqueue_workers=max(1, _int(env, "WORKQUEUE_WORKERS", 1)),
            watch_history_size=max(1, _int(env, "WATCH_HISTORY_SIZE", 2048)),
            enable_self_healing=_bool(env, "ENABLE_SELF_HEALING", True),
            recovery_backoff_base_s=_float(
                env, "RECOVERY_BACKOFF_BASE_S", 10.0),
            recovery_backoff_max_s=_float(
                env, "RECOVERY_BACKOFF_MAX_S", 300.0),
            recovery_max_attempts=_int(env, "RECOVERY_MAX_ATTEMPTS", 5),
            recovery_window_s=_float(env, "RECOVERY_WINDOW_S", 3600.0),
            recovery_pending_deadline_s=_float(
                env, "RECOVERY_PENDING_DEADLINE_S", 300.0),
            checkpoint_store_uri=env.get("CHECKPOINT_STORE_URI", ""),
            checkpoint_interval_s=_float(
                env, "CHECKPOINT_INTERVAL_S", 300.0),
            checkpoint_max_age_s=_float(
                env, "CHECKPOINT_MAX_AGE_S", 600.0),
            checkpoint_signal_root=env.get("CHECKPOINT_SIGNAL_ROOT", ""),
            replication_max_lag=max(0, _int(
                env, "REPLICATION_MAX_LAG", 2)),
            slo_promotion_p99_s=_float(env, "SLO_PROMOTION_P99_S", 1.0),
            enable_slice_scheduler=_bool(
                env, "ENABLE_SLICE_SCHEDULER", False),
            warmpool_size=max(0, _int(env, "WARMPOOL_SIZE", 0)),
            warmpool_shapes=env.get("WARMPOOL_SHAPES", ""),
            warmpool_provision_s=_float(env, "WARMPOOL_PROVISION_S", 120.0),
            warmpool_max_size=max(1, _int(env, "WARMPOOL_MAX_SIZE", 64)),
            warmpool_target_hit_rate=_float(
                env, "WARMPOOL_TARGET_HIT_RATE", 0.9),
            warmpool_decay_s=_float(env, "WARMPOOL_DECAY_S", 600.0),
            enable_preemption=_bool(env, "ENABLE_PREEMPTION", True),
            queue_requeue_s=_float(env, "QUEUE_REQUEUE_S", 15.0),
            queue_aging_s=_float(env, "QUEUE_AGING_S", 60.0),
            slo_placement_p99_s=_float(env, "SLO_PLACEMENT_P99_S", 0.0),
            slo_time_to_ready_p99_s=_float(
                env, "SLO_TIME_TO_READY_P99_S", 600.0),
            slo_event_to_reconcile_p99_s=_float(
                env, "SLO_EVENT_TO_RECONCILE_P99_S", 30.0),
            slo_reconcile_error_rate=_float(
                env, "SLO_RECONCILE_ERROR_RATE", 0.01),
            slo_recovery_p99_s=_float(
                env, "SLO_RECOVERY_DURATION_P99_S", 300.0),
            slo_warmpool_hit_rate=_float(
                env, "SLO_WARMPOOL_HIT_RATE", 0.6),
            slo_short_window_s=_float(env, "SLO_SHORT_WINDOW_S", 300.0),
            slo_long_window_s=_float(env, "SLO_LONG_WINDOW_S", 3600.0),
            slo_burn_alert_threshold=_float(
                env, "SLO_BURN_ALERT_THRESHOLD", 2.0),
            enable_continuous_profiler=_bool(
                env, "ENABLE_CONTINUOUS_PROFILER", False),
            profiler_interval_ms=_float(env, "PROFILER_INTERVAL_MS", 10.0),
            dataplane_straggler_ratio=_float(
                env, "DATAPLANE_STRAGGLER_RATIO", 1.5),
            dataplane_straggler_min_workers=max(2, _int(
                env, "DATAPLANE_STRAGGLER_MIN_WORKERS", 2)),
            dataplane_mfu_target=_float(env, "DATAPLANE_MFU_TARGET", 0.0),
            slo_fleet_mfu=_float(env, "SLO_FLEET_MFU", 0.0),
            slo_straggler_rate=_float(env, "SLO_STRAGGLER_RATE", 0.0),
            shard_count=max(1, _int(env, "SHARD_COUNT", 1)),
            shard_lease_duration_s=_float(
                env, "SHARD_LEASE_DURATION_S", 15.0),
            slo_shard_handoff_p99_s=_float(
                env, "SLO_SHARD_HANDOFF_P99_S", 0.0),
            interleave_max_schedules=max(1, _int(
                env, "INTERLEAVE_MAX_SCHEDULES", 1200)),
            interleave_budget_s=_float(env, "INTERLEAVE_BUDGET_S", 60.0),
            lifecycle_max_notebooks=max(1, _int(
                env, "LIFECYCLE_MAX_NOTEBOOKS", 4096)),
            lifecycle_samples_per_stage=max(1, _int(
                env, "LIFECYCLE_SAMPLES_PER_STAGE", 2048)),
            lifecycle_tolerance=_float(env, "LIFECYCLE_TOLERANCE", 0.05),
            tsdb_raw_capacity=max(1, _int(env, "TSDB_RAW_CAPACITY", 512)),
            tsdb_tier10_capacity=max(1, _int(
                env, "TSDB_TIER10_CAPACITY", 1024)),
            tsdb_tier60_capacity=max(1, _int(
                env, "TSDB_TIER60_CAPACITY", 1024)),
            tsdb_max_series=max(1, _int(env, "TSDB_MAX_SERIES", 256)),
            metering_max_tenants=max(1, _int(
                env, "METERING_MAX_TENANTS", 64)),
            metering_max_notebooks=max(1, _int(
                env, "METERING_MAX_NOTEBOOKS", 4096)),
            metering_tolerance=_float(env, "METERING_TOLERANCE", 0.05),
            tenant_fairshare_factor=_float(
                env, "TENANT_FAIRSHARE_FACTOR", 3.0),
            tenant_top_k=max(1, _int(env, "TENANT_TOP_K", 8)),
            slo_tenant_fairness=_float(env, "SLO_TENANT_FAIRNESS", 0.01),
        )


@dataclass
class OdhConfig:
    """ODH controller config (odh main.go:141-347 + per-file env reads)."""

    set_pipeline_rbac: bool = False          # SET_PIPELINE_RBAC
    set_pipeline_secret: bool = False        # SET_PIPELINE_SECRET
    inject_cluster_proxy_env: bool = False   # INJECT_CLUSTER_PROXY_ENV
    mlflow_enabled: bool = False             # MLFLOW_ENABLED
    gateway_url: str = ""                    # GATEWAY_URL
    gateway_name: str = "data-science-gateway"       # NOTEBOOK_GATEWAY_NAME
    gateway_namespace: str = "openshift-ingress"     # NOTEBOOK_GATEWAY_NAMESPACE
    controller_namespace: str = "opendatahub"        # K8S_NAMESPACE
    kube_rbac_proxy_image: str = "kube-rbac-proxy:latest"
    # the GPU image swap table (odh/webhook.py:swap_gpu_image): workbench
    # image -> CUDA + PyTorch image, and the default for an image not
    # aimed at the card
    gpu_image_map: dict[str, str] = field(default_factory=dict)
    gpu_default_image: str = "jupyter-cuda-pytorch:latest"  # GPU_DEFAULT_IMAGE

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "OdhConfig":
        explicit = env is not None
        env = env if env is not None else os.environ
        return cls(
            set_pipeline_rbac=_bool(env, "SET_PIPELINE_RBAC", False),
            set_pipeline_secret=_bool(env, "SET_PIPELINE_SECRET", False),
            inject_cluster_proxy_env=_bool(env, "INJECT_CLUSTER_PROXY_ENV",
                                           False),
            mlflow_enabled=_bool(env, "MLFLOW_ENABLED", False),
            gateway_url=env.get("GATEWAY_URL", ""),
            gateway_name=env.get("NOTEBOOK_GATEWAY_NAME",
                                 "data-science-gateway"),
            gateway_namespace=env.get("NOTEBOOK_GATEWAY_NAMESPACE",
                                      "openshift-ingress"),
            # namespace detection: K8S_NAMESPACE, else the in-cluster SA
            # mount, else the dev default (odh main.go:127-139); an explicit
            # mapping stays hermetic (no ambient os.environ / SA-mount reads)
            controller_namespace=detect_namespace(
                "opendatahub", env=env if explicit else None),
            kube_rbac_proxy_image=env.get("KUBE_RBAC_PROXY_IMAGE",
                                          "kube-rbac-proxy:latest"),
            gpu_default_image=env.get("GPU_DEFAULT_IMAGE",
                                      "jupyter-cuda-pytorch:latest"),
        )


__all__ = ["CoreConfig", "OdhConfig", "detect_namespace"]
