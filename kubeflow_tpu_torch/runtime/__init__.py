"""In-notebook runtime: distributed bootstrap, the input pipeline,
checkpoint and cull hooks, performance metrics, the telemetry agent and
the roofline.  The port of kubeflow_tpu/runtime; everything the
controller arranges (env injection, cull signals, the telemetry
annotation) is consumed or produced here.

Exports are lazy (PEP 562), as in the reference: importing
`runtime.telemetry` or `runtime.checkpoint` does not run the sibling
imports, and `from kubeflow_tpu_torch.runtime import StepTimer` resolves
on first use."""

import importlib

_LAZY = {
    "CheckpointManager": ".checkpoint",
    "CullSignalWatcher": ".checkpoint",
    "checkpoint_on_cull": ".checkpoint",
    "WorkerIdentity": ".init",
    "parse_worker_env": ".init",
    "distributed_init": ".init",
    "StepTimer": ".metrics",
    "hbm_usage_bytes": ".metrics",
    "TelemetryAgent": ".telemetry",
}

__all__ = [
    "CheckpointManager",
    "CullSignalWatcher",
    "StepTimer",
    "TelemetryAgent",
    "WorkerIdentity",
    "checkpoint_on_cull",
    "distributed_init",
    "hbm_usage_bytes",
    "parse_worker_env",
]


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod = importlib.import_module(target, __name__)
    value = getattr(mod, name)
    globals()[name] = value  # cache: resolve each export once
    return value
