"""In-notebook performance metrics: MFU, throughput, device memory.

The port of kubeflow_tpu/runtime/metrics.py.  The worker's training
families are exported through the same `utils.metrics.Registry` as the
controller's, so both planes share one exposition format and the
ci/metrics_drift_check.sh family inventory: `register_step_metrics`
keeps the reference's four names, help strings and `STEP_TIME_BUCKETS`.

`StepTimer` is a shim over `runtime.telemetry.TelemetryAgent`:
`observe()` is the agent's step boundary and every derived stat reads
the agent's rolling window, so the step histogram and the agent's
samples are one stream.  MFU comes from `runtime.roofline` against the
card's own peak.

`torch` is imported lazily (`hbm_usage_bytes`), so the family inventory
and the timing logic import without it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Optional

from ..utils.metrics import Registry

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..models.configs import TransformerConfig
    from .telemetry import TelemetryAgent


def hbm_usage_bytes() -> dict[str, int]:
    """Device-memory bytes in use by PyTorch's caching allocator on each
    local card, keyed "cuda:<index>"; {} on a host without CUDA."""
    import torch

    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": int(torch.cuda.memory_stats(i).get(
        "allocated_bytes.all.current", 0))
        for i in range(torch.cuda.device_count())}


# train steps span ~ms (tiny models, microbatches) to minutes (large-model
# accumulation); DefaultBuckets tops out at 10s, too short for the tail
STEP_TIME_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def register_step_metrics(registry: Registry) -> dict:
    """Register the data-plane training families on `registry` and return
    them by short name.  Idempotent (the Registry returns the existing
    family on identical re-registration)."""
    return {
        "step_duration": registry.histogram(
            "notebook_training_step_duration_seconds",
            "Distribution of synced train-step wall time",
            buckets=STEP_TIME_BUCKETS),
        "tokens_per_second": registry.gauge(
            "notebook_training_tokens_per_second",
            "Rolling training throughput over the step window"),
        "mfu_ratio": registry.gauge(
            "notebook_training_mfu_ratio",
            "Rolling model FLOPs utilization (0-1) over the step window"),
        "hbm_bytes_in_use": registry.gauge(
            "notebook_training_hbm_bytes_in_use",
            "HBM bytes in use across local devices"),
    }


@dataclass
class StepTimer:
    """Rolling train-step telemetry; call `observe()` once per synced step.

    A shim over a TelemetryAgent, kept for the workbench image's API
    (`report()`/`prometheus_text()`); new loops construct the agent.
    `accelerator` is a key of `runtime.roofline.GPU_PEAKS` ("" = this
    host's card 0)."""

    config: "TransformerConfig"
    batch: int
    seq_len: int
    num_chips: int
    accelerator: str = ""
    window: int = 20
    registry: Optional[Registry] = None
    time_fn: Callable[[], float] = time.perf_counter

    def __post_init__(self) -> None:
        from .telemetry import TelemetryAgent

        if self.registry is None:
            self.registry = Registry()
        self.agent: "TelemetryAgent" = TelemetryAgent(
            config=self.config, batch=self.batch, seq_len=self.seq_len,
            num_chips=self.num_chips, accelerator=self.accelerator,
            window=self.window, registry=self.registry,
            time_fn=self.time_fn)

    def observe(self) -> None:
        self.agent.step_boundary()

    @property
    def step_time_s(self) -> float:
        return self.agent.step_time_s

    @property
    def tokens_per_s(self) -> float:
        return self.agent.tokens_per_s

    @property
    def mfu(self) -> float:
        return self.agent.mfu

    def report(self) -> dict:
        return {
            "step_time_s": self.step_time_s,
            "tokens_per_s": self.tokens_per_s,
            "mfu": self.mfu,
            "hbm_bytes_in_use": self.agent.hbm_bytes_in_use(),
        }

    def prometheus_text(self) -> str:
        """Prometheus exposition the workbench image can serve on
        /metrics, with full HELP/TYPE metadata from the shared Registry."""
        return self.registry.render()


__all__ = ["STEP_TIME_BUCKETS", "StepTimer", "hbm_usage_bytes",
           "register_step_metrics"]
