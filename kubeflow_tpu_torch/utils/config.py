"""Env-var configuration surface: the port's copy of
kubeflow_tpu/utils/config.py's `CoreConfig` and `OdhConfig`.

The reference's de-facto config system is environment variables fed by
kustomize params ConfigMaps; the same variable names bind into an
injectable Config object so tests don't mutate process env.  The port
keeps the fields its controllers read, under the reference's env names,
defaults and parses: among them the slice scheduler's gang gate, warm
pool and tenancy layer (core/scheduler.py, core/preemption.py), and the
Istio VirtualService's switch, gateway and host.  `from_env` refuses the
env switch of any tier that is not ported (`NOT_PORTED_SWITCHES`); a
tier's tuning knobs are not read, as the reference reads none while the
tier is off.  Each field comes back with the `ROADMAP.md` item that ports
its reader.  `OdhConfig` is the ODH plane's (odh/), with GPU_DEFAULT_IMAGE
and the GPU image map as the twins of the reference's TPU ones.
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


class NotPortedError(ValueError):
    """A part of the reference's control plane that this port does not
    run yet was turned on; the message names its `ROADMAP.md` item."""


def not_ported(what: str, item: int, module: str) -> str:
    return (f"{what} is not ported to the GPU controller yet: "
            f"ROADMAP.md queue 1 item {item} ({module})")


def _true(v: str) -> bool:
    return v.strip().lower() == "true"


def _above(floor: float):
    def on(v: str) -> bool:
        try:
            return float(v) > floor
        except ValueError:
            return False
    return on


# The env switches of the reference's tiers that this port does not run:
# (env name, whether a value turns the tier on, ROADMAP.md queue 1 item,
# the reference's module).  An SLO knob above 0 declares an objective.
NOT_PORTED_SWITCHES = (
    ("SLO_PROMOTION_P99_S", _above(0), 16, "kubeflow_tpu/utils/slo.py"),
    ("ENABLE_CONTINUOUS_PROFILER", _true, 16,
     "kubeflow_tpu/utils/profiler.py"),
    *((name, _above(0), 16, "kubeflow_tpu/utils/slo.py") for name in (
        "SLO_TIME_TO_READY_P99_S", "SLO_EVENT_TO_RECONCILE_P99_S",
        "SLO_RECONCILE_ERROR_RATE", "SLO_RECOVERY_DURATION_P99_S",
        "SLO_WARMPOOL_HIT_RATE", "SLO_PLACEMENT_P99_S", "SLO_FLEET_MFU",
        "SLO_STRAGGLER_RATE", "SLO_TENANT_FAIRNESS",
        "SLO_SHARD_HANDOFF_P99_S", "DATAPLANE_MFU_TARGET")),
    ("SHARD_COUNT", _above(1), 17, "kubeflow_tpu/kube/shard.py"),
)


def check_env(env: Mapping[str, str]) -> None:
    """Refuse an env that turns on a tier this port does not run."""
    for name, on, item, module in NOT_PORTED_SWITCHES:
        v = env.get(name)
        if v is not None and on(v):
            raise NotPortedError(not_ported(f"{name}={v}", item, module))


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
    # head by at most replication_max_lag deltas.  Its latency objective
    # (SLO_PROMOTION_P99_S) belongs to the SLO tier (ROADMAP.md queue 1
    # item 16) and is refused above 0.
    replication_max_lag: int = 2              # REPLICATION_MAX_LAG
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
    # by default, as in the reference.
    enable_preemption: bool = True            # ENABLE_PREEMPTION
    queue_requeue_s: float = 15.0             # QUEUE_REQUEUE_S
    queue_aging_s: float = 60.0               # QUEUE_AGING_S

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "CoreConfig":
        env = env if env is not None else os.environ
        check_env(env)
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


__all__ = ["CoreConfig", "NOT_PORTED_SWITCHES", "NotPortedError",
           "OdhConfig", "check_env", "detect_namespace", "not_ported"]
