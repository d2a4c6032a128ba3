"""Env-var configuration surface: the port's copy of
kubeflow_tpu/utils/config.py's `CoreConfig`.

The reference's de-facto config system is environment variables fed by
kustomize params ConfigMaps; the same variable names bind into an
injectable Config object so tests don't mutate process env.  The port
keeps the fields its controllers read, under the reference's env names,
and the switches of three tiers it does not run yet (self-healing, the
slice scheduler, the Istio VirtualService), which `setup_core_controllers`
refuses when on.  `from_env` refuses the env switch of any other tier that
is not ported (`NOT_PORTED_SWITCHES`); a tier's tuning knobs are not read,
as the reference reads none while the tier is off.  Each field comes back
with the `ROADMAP.md` item that ports its reader.  One default differs:
`enable_self_healing` is False here.  `OdhConfig` is not ported.
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
    ("ENABLE_PREEMPTION", _true, 13, "kubeflow_tpu/core/preemption.py"),
    ("WARMPOOL_SIZE", _above(0), 13, "kubeflow_tpu/core/scheduler.py"),
    ("WARMPOOL_SHAPES", lambda v: bool(v.strip()), 13,
     "kubeflow_tpu/core/scheduler.py"),
    ("SLO_PROMOTION_P99_S", _above(0), 14, "the replicated-kernel tier"),
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
    # workload rendering (notebook_controller.go:238,514); the Istio
    # VirtualService is refused (ROADMAP.md queue 1 item 15)
    use_istio: bool = False
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
    # slice-atomic self-healing: refused (ROADMAP.md queue 1 item 12)
    enable_self_healing: bool = False         # ENABLE_SELF_HEALING
    # the checkpoint-sidecar contract: a non-empty store URI turns it on
    # in the rendered pod template.  checkpoint_signal_root hosts the
    # per-notebook cull-signal dirs the CullSignalWatcher polls (empty =
    # annotation handshake only).
    checkpoint_store_uri: str = ""            # CHECKPOINT_STORE_URI
    checkpoint_interval_s: float = 300.0      # CHECKPOINT_INTERVAL_S
    checkpoint_signal_root: str = ""          # CHECKPOINT_SIGNAL_ROOT
    # topology-aware slice scheduler and warm pool: refused (ROADMAP.md
    # queue 1 item 13)
    enable_slice_scheduler: bool = False      # ENABLE_SLICE_SCHEDULER

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
            enable_self_healing=_bool(env, "ENABLE_SELF_HEALING", False),
            checkpoint_store_uri=env.get("CHECKPOINT_STORE_URI", ""),
            checkpoint_interval_s=_float(
                env, "CHECKPOINT_INTERVAL_S", 300.0),
            checkpoint_signal_root=env.get("CHECKPOINT_SIGNAL_ROOT", ""),
            enable_slice_scheduler=_bool(
                env, "ENABLE_SLICE_SCHEDULER", False),
        )


__all__ = ["CoreConfig", "NOT_PORTED_SWITCHES", "NotPortedError",
           "check_env", "detect_namespace", "not_ported"]
