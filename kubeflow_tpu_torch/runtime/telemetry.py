"""Worker-side data-plane telemetry: the TelemetryAgent.

The port of kubeflow_tpu/runtime/telemetry.py.  The controller's
straggler detection (kubeflow_tpu/core/telemetry.py) reads each
worker's `notebooks.kubeflow.org/telemetry` annotation; this module
writes it from a GPU worker, in the reference's format:

  - **step samples**: the training loop calls `step_boundary()` once per
    synced step, after a host read of the loss (or `record_step(dt)`
    with an explicit duration).  Timing reads the injected `time_fn`,
    `time.perf_counter` by default; the agent reads no clock of its own;
  - **per-phase attribution**: `with agent.scope("fwd"): ...` adds a
    named sub-duration to the next recorded step;
  - **roofline attribution**: every sample carries MFU and the roofline
    fraction from `runtime.roofline`, against the peak of the card named
    by `accelerator`, a key of `GPU_PEAKS` (the card's
    `torch.cuda.get_device_name()`).  An unknown card raises KeyError,
    as the reference does for an unknown TPU: the aggregator leaves out
    any worker whose `mfu` is not a number, with no error, so a null
    would drop this worker from its notebook's rollup unseen;
  - **bounded JSONL ring**: samples spool to an in-memory ring and
    optionally to a JSONL file with the same bound (`spool_to`);
  - **publication**: `summary()` is the payload the controller reads;
    `maybe_publish()` rate-limits pushes of it through `publish_fn`.

The exported metric families are runtime/metrics.py's
`register_step_metrics`; `torch` is imported lazily.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..utils.metrics import Histogram, Registry
from . import roofline
from .metrics import hbm_usage_bytes, register_step_metrics

# the pod annotation the summaries publish under; the controller keeps a
# matching literal (kubeflow_tpu/core/telemetry.py)
TELEMETRY_ANNOTATION = "notebooks.kubeflow.org/telemetry"
SUMMARY_VERSION = 1


class JsonlRing:
    """Append-only JSONL spool bounded to the newest `max_records` lines.

    Appends are O(1); when `max_records` lines were appended since the
    last compaction the file is rewritten to its newest `max_records`
    (write temp, atomic rename), so the spool a crashed worker leaves
    behind is always parseable and never unbounded."""

    def __init__(self, path: str, max_records: int = 512) -> None:
        self.path = path
        self.max_records = max(1, int(max_records))
        self._since_compact = 0

    def append(self, record: dict) -> None:
        line = json.dumps(record, sort_keys=True)
        with open(self.path, "a") as f:
            f.write(line + "\n")
        self._since_compact += 1
        if self._since_compact >= self.max_records:
            self._compact()

    def _compact(self) -> None:
        lines = self.read_lines()
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.writelines(lines)
        os.replace(tmp, self.path)
        self._since_compact = 0

    def read_lines(self) -> list[str]:
        try:
            with open(self.path) as f:
                lines = f.readlines()
        except OSError:
            return []
        return lines[-self.max_records:]

    def read(self) -> list[dict]:
        return [json.loads(ln) for ln in self.read_lines() if ln.strip()]


def _device_name() -> str:
    import torch

    if not torch.cuda.is_available():
        raise KeyError("no CUDA card to name the accelerator after: pass "
                       "accelerator=<a key of runtime.roofline.GPU_PEAKS>")
    return torch.cuda.get_device_name(0)


@dataclass
class TelemetryAgent:
    """Rolling step telemetry for one worker; see module docstring.

    `config` is a models.configs.TransformerConfig (only
    `flops_per_token` and the fields the roofline reads are used); pass
    `flops_per_token` to go without one.  `accelerator` is a key of
    `runtime.roofline.GPU_PEAKS`; "" names this host's card 0."""

    config: Optional[object] = None
    batch: int = 1
    seq_len: int = 1
    num_chips: int = 1
    accelerator: str = ""
    mode: str = "train"                  # train | decode
    worker: str = ""                     # pod name (summary attribution)
    window: int = 20                     # rolling-stat sample count
    ring_size: int = 512                 # TELEMETRY_RING_SIZE
    flops_per_token: float = 0.0         # override: config-free callers
    registry: Optional[Registry] = None
    time_fn: Callable[[], float] = time.perf_counter
    hbm_fn: Optional[Callable[[], dict]] = None  # None = torch.cuda
    publish_fn: Optional[Callable[[dict], None]] = None
    publish_interval_s: float = 30.0     # TELEMETRY_PUBLISH_INTERVAL_S

    _durations: deque = field(default_factory=deque, repr=False)
    _ring: deque = field(default_factory=deque, repr=False)

    def __post_init__(self) -> None:
        if not self.accelerator:
            self.accelerator = _device_name()
        if self.accelerator not in roofline.GPU_PEAKS:
            raise KeyError(f"accelerator {self.accelerator!r} is not in "
                           f"runtime.roofline.GPU_PEAKS "
                           f"{sorted(roofline.GPU_PEAKS)}")
        if self.registry is None:
            self.registry = Registry()
        m = register_step_metrics(self.registry)
        self._step_hist: Histogram = m["step_duration"]
        # derived gauges recompute at collect()/render() time so a scrape
        # is always current without the loop pushing anything
        m["tokens_per_second"].set_function(lambda: self.tokens_per_s)
        m["mfu_ratio"].set_function(lambda: self.mfu)
        m["hbm_bytes_in_use"].set_function(
            lambda: float(self.hbm_bytes_in_use()))
        self._ring = deque(maxlen=max(1, int(self.ring_size)))
        self._last_boundary: Optional[float] = None
        self._pending_phases: dict[str, float] = {}
        self._last_publish: Optional[float] = None
        self._spool: Optional[JsonlRing] = None
        self.steps_recorded = 0

    # -- workload accounting --------------------------------------------------
    def _flops_per_token(self) -> float:
        if self.flops_per_token:
            return self.flops_per_token
        if self.config is not None:
            return float(self.config.flops_per_token(self.seq_len))
        return 0.0

    def _mfu(self, tokens_per_s: float) -> float:
        # never None: __post_init__ holds the accelerator to GPU_PEAKS
        return roofline.mfu_from_flops(tokens_per_s, self._flops_per_token(),
                                       self.num_chips, self.accelerator)

    def estimate(self) -> Optional[roofline.RooflineEstimate]:
        """The analytic floor for this agent's workload (None without a
        config: roofline floors need the traffic model, not just FLOPs)."""
        if self.config is None:
            return None
        if self.mode == "decode":
            return roofline.decode_estimate(
                self.config, self.batch, accelerator=self.accelerator,
                num_chips=self.num_chips)
        return roofline.train_estimate(
            self.config, self.batch, self.seq_len,
            accelerator=self.accelerator, num_chips=self.num_chips)

    def hbm_bytes_in_use(self) -> int:
        fn = self.hbm_fn if self.hbm_fn is not None else hbm_usage_bytes
        try:
            return int(sum(fn().values()))
        except Exception:  # noqa: BLE001 — no accelerator = no HBM stat
            return 0

    # -- recording ------------------------------------------------------------
    @contextlib.contextmanager
    def scope(self, name: str):
        """Accumulate a named phase duration (fwd/bwd/opt) attached to
        the next recorded step."""
        t0 = self.time_fn()
        try:
            yield
        finally:
            dt = self.time_fn() - t0
            self._pending_phases[name] = \
                self._pending_phases.get(name, 0.0) + dt

    def step_boundary(self) -> Optional[dict]:
        """Mark one synced-step boundary; the first call arms the timer,
        each later call records the elapsed interval as a step."""
        now = self.time_fn()
        sample = None
        if self._last_boundary is not None:
            sample = self.record_step(now - self._last_boundary, at=now)
        self._last_boundary = now
        return sample

    def record_step(self, duration_s: float,
                    at: Optional[float] = None) -> dict:
        """Record one step of `duration_s`; returns the sample dict that
        entered the ring (and the JSONL spool, when attached)."""
        at = self.time_fn() if at is None else at
        self._durations.append(duration_s)
        while len(self._durations) > self.window:
            self._durations.popleft()
        self._step_hist.observe(duration_s)
        self.steps_recorded += 1
        tok_s = self.tokens_per_step / duration_s if duration_s > 0 else 0.0
        est = self.estimate()
        sample = {
            "t": at,
            "step": self.steps_recorded,
            "step_time_s": duration_s,
            "tokens_per_s": tok_s,
            "mfu": self._mfu(tok_s),
            "hbm_bytes": self.hbm_bytes_in_use(),
        }
        if est is not None:
            sample["roofline_fraction"] = est.roofline_fraction(duration_s)
            sample["bound"] = est.bound
        if self._pending_phases:
            sample["phases"] = dict(self._pending_phases)
            self._pending_phases = {}
        self._ring.append(sample)
        if self._spool is not None:
            self._spool.append(sample)
        self.maybe_publish(now=at)
        return sample

    # -- rolling stats (shared with the StepTimer shim) -----------------------
    @property
    def tokens_per_step(self) -> int:
        return self.batch * (self.seq_len if self.mode == "train" else 1)

    @property
    def step_time_s(self) -> float:
        d = self._durations
        return sum(d) / len(d) if d else 0.0

    @property
    def tokens_per_s(self) -> float:
        st = self.step_time_s
        return self.tokens_per_step / st if st else 0.0

    @property
    def mfu(self) -> float:
        return self._mfu(self.tokens_per_s)

    # -- spool / publish ------------------------------------------------------
    def spool_to(self, path: str) -> JsonlRing:
        self._spool = JsonlRing(path, max_records=self.ring_size)
        return self._spool

    def samples(self) -> list[dict]:
        return list(self._ring)

    def summary(self) -> dict:
        """The rolling summary the control plane consumes — the pod
        annotation payload (`TELEMETRY_ANNOTATION`)."""
        est = self.estimate()
        out = {
            "v": SUMMARY_VERSION,
            "worker": self.worker,
            "mode": self.mode,
            "steps": self.steps_recorded,
            "step_time_s": self.step_time_s,
            "tokens_per_s": self.tokens_per_s,
            "mfu": self.mfu,
            "hbm_bytes": self.hbm_bytes_in_use(),
            "t": self.time_fn(),
        }
        if est is not None and self.step_time_s > 0:
            out["roofline_fraction"] = est.roofline_fraction(self.step_time_s)
            out["bound"] = est.bound
        phases: dict[str, float] = {}
        for s in self._ring:
            for k, v in (s.get("phases") or {}).items():
                phases[k] = phases.get(k, 0.0) + v
        if phases:
            out["phases"] = phases
        return out

    def maybe_publish(self, now: Optional[float] = None) -> bool:
        """Push the rolling summary through `publish_fn`, at most once
        per `publish_interval_s` (the first recorded step publishes
        immediately so a fresh worker shows up fast)."""
        if self.publish_fn is None:
            return False
        now = self.time_fn() if now is None else now
        if (self._last_publish is not None
                and now - self._last_publish < self.publish_interval_s):
            return False
        self._last_publish = now
        self.publish_fn(self.summary())
        return True

    def publish_now(self) -> bool:
        """Unconditional publish (loop teardown / final flush)."""
        if self.publish_fn is None:
            return False
        self._last_publish = self.time_fn()
        self.publish_fn(self.summary())
        return True


def annotation_payload(summary: dict) -> str:
    """Serialize a summary for the pod annotation (stable key order so
    repeated publishes with identical stats produce identical patches)."""
    return json.dumps(summary, sort_keys=True)


def parse_annotation(payload: str) -> Optional[dict]:
    """Parse a telemetry annotation; None for malformed/foreign payloads
    (the aggregator must never crash on a worker's bad write)."""
    try:
        out = json.loads(payload)
    except (ValueError, TypeError):
        return None
    if not isinstance(out, dict) or out.get("v") != SUMMARY_VERSION:
        return None
    return out


__all__ = [
    "JsonlRing", "SUMMARY_VERSION", "TELEMETRY_ANNOTATION",
    "TelemetryAgent", "annotation_payload", "parse_annotation",
]
