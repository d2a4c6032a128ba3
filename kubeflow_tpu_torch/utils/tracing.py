"""Minimal OpenTelemetry-style tracing with OTLP/HTTP export: the port's
copy of kubeflow_tpu/utils/tracing.py.

The reference traces its mutating webhook with OTel — a lazily-created tracer
(sync.OnceValue, notebook_mutating_webhook.go:74-76), a root span per
admission with notebook attributes (:366-373), child spans, and span events
that the test suite asserts on via an in-memory exporter
(opentelemetry_test.go:26-78).  We keep the same shape: a process-global
provider that defaults to noop, swappable for an InMemorySpanExporter in
tests — tracing as a test observability channel — plus an OtlpHttpExporter
(the OTLP/HTTP JSON protocol, POST {endpoint}/v1/traces) so spans leave the
process in production: set OTEL_EXPORTER_OTLP_ENDPOINT and the manager
wires it at startup (setup_exporter_from_env).

Spans are ALWAYS recorded in-process (they feed the reconcile flight
recorder, utils/flightrecorder.py, which must work in the standalone pod
with no trace backend at all); whether a finished span LEAVES the process
is a separate decision made by the installed exporter.  Production export
is tail-based (TailSampler): the full span tree of an attempt is buffered
until its root finishes, then exported when the attempt errored or was
slow, else kept with a small probability — errors and outliers always
reach the backend while the fast-success firehose stays in-process.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import random
import threading
import time
import urllib.request
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Iterator, Optional

logger = logging.getLogger("kubeflow_tpu_torch.tracing")

# injectable time source so span timelines are deterministic under a
# FakeClock (set_clock); None falls back to the wall clock
_clock = None


def set_clock(clock) -> None:
    """Route span/event timestamps through `clock.now()` (a FakeClock in
    tests makes trace timelines deterministic); None restores time.time."""
    global _clock
    _clock = clock


def _now() -> float:
    c = _clock
    return c.now() if c is not None else time.time()


@dataclass
class SpanEvent:
    name: str
    attributes: dict = field(default_factory=dict)
    timestamp: float = 0.0


@dataclass
class Span:
    name: str
    attributes: dict = field(default_factory=dict)
    events: list[SpanEvent] = field(default_factory=list)
    parent: Optional["Span"] = None
    start_time: float = 0.0
    end_time: float = 0.0
    recording: bool = True
    # W3C-style ids (hex): all spans of one trace share trace_id
    trace_id: str = ""
    span_id: str = ""
    # finished child spans, linked by the tracer when each child ends — the
    # span tree the flight recorder pulls per-phase durations from
    children: list["Span"] = field(default_factory=list)

    def add_event(self, name: str, attributes: Optional[dict] = None) -> None:
        if self.recording:
            self.events.append(SpanEvent(name, dict(attributes or {}), _now()))

    def set_attribute(self, key: str, value) -> None:
        if self.recording:
            self.attributes[key] = value


_NOOP_SPAN = Span(name="", recording=False)

# The active-span stack, shared by every Tracer in the process (OTel's
# context propagation): a child span started anywhere inside a reconcile —
# a controller phase, the admission webhook re-entered through an ApiServer
# write, a fault injection — parents onto the live reconcile span.  A
# contextvar is per-thread (and per-async-task), so threaded managers and
# webhook callouts cannot cross-contaminate each other's stacks.
_SPAN_STACK: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "kubeflow_tpu_torch_span_stack", default=())

# Cross-thread mirror of the live span stacks, keyed by thread ident.  A
# contextvar is only readable from its own thread, but the sampling
# profiler (utils/profiler.py) must attribute ANOTHER thread's stack
# frames to the (controller, phase) span that thread is currently inside.
# Updated on every span start/end with plain (GIL-atomic) dict ops — two
# dict assignments per span, no lock on the reconcile path.
_LIVE_STACKS: dict[int, tuple] = {}


def current_span() -> Span:
    """The innermost live span on this thread/context (noop when none) —
    the hook kube.faults uses to stamp injected faults onto whichever
    reconcile attempt the fault actually hit."""
    stack = _SPAN_STACK.get()
    return stack[-1] if stack else _NOOP_SPAN


def live_span_stacks() -> dict[int, tuple]:
    """Snapshot of every thread's live span stack (thread ident ->
    innermost-last Span tuple) — the profiler's attribution source."""
    return dict(_LIVE_STACKS)


class InMemorySpanExporter:
    """Collects finished spans for test assertions
    (opentelemetry_test.go InMemoryExporter analog)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._spans: list[Span] = []

    def export(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    @property
    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def find(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def events(self) -> list[str]:
        return [e.name for s in self.spans for e in s.events]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


class Tracer:
    def __init__(self, name: str) -> None:
        self.name = name

    def current_span(self) -> Span:
        return current_span()

    @contextlib.contextmanager
    def start_span(
        self, name: str, attributes: Optional[dict] = None,
        trace_id: str = "",
    ) -> Iterator[Span]:
        """Open a span as a child of the context's current span.  For a ROOT
        span (no parent on the stack) `trace_id` pins the trace identity —
        the manager passes the same id for every retry of one reconcile
        request so its attempts line up on one trace timeline.

        The span is always recorded (the flight recorder consumes the tree
        even with no exporter installed); it is exported only when an
        exporter is present, resolved at span END so a TailSampler sees the
        finished root and can decide for the whole attempt."""
        stack = _SPAN_STACK.get()
        parent = stack[-1] if stack else None
        span = Span(
            name=name,
            attributes=dict(attributes or {}),
            parent=parent,
            start_time=_now(),
            trace_id=parent.trace_id if parent
            else (trace_id or os.urandom(16).hex()),
            span_id=os.urandom(8).hex(),
        )
        token = _SPAN_STACK.set(stack + (span,))
        tid = threading.get_ident()
        _LIVE_STACKS[tid] = stack + (span,)
        try:
            yield span
        finally:
            _SPAN_STACK.reset(token)
            if stack:
                _LIVE_STACKS[tid] = stack
            else:
                _LIVE_STACKS.pop(tid, None)
            span.end_time = _now()
            if parent is not None:
                parent.children.append(span)
            exporter = _exporter
            if exporter is not None:
                exporter.export(span)


def _otlp_value(v) -> dict:
    """Encode one attribute value as an OTLP AnyValue."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _otlp_attrs(attrs: dict) -> list[dict]:
    return [{"key": k, "value": _otlp_value(v)} for k, v in attrs.items()]


def _nanos(t: float) -> str:
    return str(int(t * 1e9))


class OtlpHttpExporter:
    """OTLP/HTTP JSON span exporter: POST {endpoint}/v1/traces.

    The production counterpart of the test InMemorySpanExporter — the
    reference's webhook tracing is real OpenTelemetry with a pluggable
    provider (notebook_mutating_webhook.go:74-76); this speaks the OTLP
    wire format any collector accepts.  Spans are buffered and flushed by a
    background thread (batch span processor shape); export failures are
    logged and dropped — tracing must never take down the control plane."""

    def __init__(self, endpoint: str, service_name: str = "kubeflow-tpu",
                 headers: Optional[dict] = None,
                 flush_interval_s: float = 5.0, max_batch: int = 512,
                 timeout_s: float = 10.0) -> None:
        self.url = endpoint.rstrip("/") + "/v1/traces"
        self.service_name = service_name
        self.headers = dict(headers or {})
        self.flush_interval_s = flush_interval_s
        self.max_batch = max_batch
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._buffer: list[Span] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="otlp-exporter")
        self._thread.start()

    def export(self, span: Span) -> None:
        with self._lock:
            self._buffer.append(span)
            full = len(self._buffer) >= self.max_batch
        if full:
            self.flush()

    def encode(self, spans: list[Span]) -> dict:
        """ExportTraceServiceRequest JSON for a batch of finished spans."""
        return {"resourceSpans": [{
            "resource": {"attributes": _otlp_attrs(
                {"service.name": self.service_name})},
            "scopeSpans": [{
                "scope": {"name": "kubeflow_tpu_torch.utils.tracing"},
                "spans": [{
                    "traceId": s.trace_id,
                    "spanId": s.span_id,
                    **({"parentSpanId": s.parent.span_id}
                       if s.parent is not None else {}),
                    "name": s.name,
                    "kind": 1,  # SPAN_KIND_INTERNAL
                    "startTimeUnixNano": _nanos(s.start_time),
                    "endTimeUnixNano": _nanos(s.end_time),
                    "attributes": _otlp_attrs(s.attributes),
                    "events": [{
                        "timeUnixNano": _nanos(e.timestamp),
                        "name": e.name,
                        "attributes": _otlp_attrs(e.attributes),
                    } for e in s.events],
                } for s in spans],
            }],
        }]}

    def flush(self) -> None:
        with self._lock:
            batch, self._buffer = self._buffer, []
        if not batch:
            return
        body = json.dumps(self.encode(batch)).encode()
        req = urllib.request.Request(
            self.url, data=body, method="POST",
            headers={"Content-Type": "application/json", **self.headers})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
        except Exception as err:  # noqa: BLE001 — drop, never crash
            logger.warning("OTLP export of %d spans failed: %s",
                           len(batch), err)

    def _loop(self) -> None:
        while not self._stop.wait(self.flush_interval_s):
            self.flush()

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=self.timeout_s)
        self.flush()


class TailSampler:
    """Tail-based sampling: hold an attempt's spans until its ROOT ends,
    then export the whole tree or drop it, deciding on what actually
    happened — the opposite of head sampling, which must guess before the
    outcome exists.

    Policy (checked in order against the finished root span):
      - `error`: the root carries ``error=True`` or
        ``reconcile.result == "error"`` — ALWAYS exported;
      - `slow`: root duration >= ``slow_threshold_s`` — ALWAYS exported;
      - `probabilistic`: otherwise kept with ``sample_rate`` probability
        from a seeded RNG (deterministic for tests), else dropped.

    Child spans buffer per trace id until their root arrives; retries of
    one request share a trace but run sequentially, so at each root
    completion the buffer holds exactly that attempt's children.  The
    buffer is bounded (`max_buffered_traces`, oldest evicted as dropped)
    so a root that never closes cannot grow memory.  The decision is
    stamped on the root as the `sampling.decision` attribute."""

    def __init__(self, exporter, slow_threshold_s: float = 1.0,
                 sample_rate: float = 0.01, seed: int = 0,
                 max_buffered_traces: int = 4096) -> None:
        self.exporter = exporter
        self.slow_threshold_s = slow_threshold_s
        self.sample_rate = sample_rate
        self.max_buffered_traces = max_buffered_traces
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._buffer: "OrderedDict[str, list[Span]]" = OrderedDict()
        self.exported_total = 0
        self.dropped_total = 0
        self.decisions: dict[str, int] = {}

    def _decide(self, root: Span) -> str:
        """Export reason, or '' to drop the attempt's spans."""
        if root.attributes.get("error") or \
                root.attributes.get("reconcile.result") == "error":
            return "error"
        if root.end_time - root.start_time >= self.slow_threshold_s:
            return "slow"
        if self._rng.random() < self.sample_rate:
            return "probabilistic"
        return ""

    def export(self, span: Span) -> None:
        with self._lock:
            if span.parent is not None:
                bucket = self._buffer.setdefault(span.trace_id, [])
                bucket.append(span)
                self._buffer.move_to_end(span.trace_id)
                while len(self._buffer) > self.max_buffered_traces:
                    _, evicted = self._buffer.popitem(last=False)
                    self.dropped_total += len(evicted)
                return
            batch = self._buffer.pop(span.trace_id, [])
            batch.append(span)
            reason = self._decide(span)
            if reason:
                span.attributes["sampling.decision"] = reason
                self.decisions[reason] = self.decisions.get(reason, 0) + 1
                self.exported_total += len(batch)
            else:
                self.dropped_total += len(batch)
                return
        for s in batch:
            self.exporter.export(s)

    def stats(self) -> dict:
        with self._lock:
            return {
                "exported_total": self.exported_total,
                "dropped_total": self.dropped_total,
                "buffered_traces": len(self._buffer),
                "decisions": dict(self.decisions),
                "slow_threshold_s": self.slow_threshold_s,
                "sample_rate": self.sample_rate,
            }

    def flush(self) -> None:
        """Export anything still buffered (roots that never closed — e.g.
        sampler installed mid-trace), then flush the inner exporter."""
        with self._lock:
            leftovers = [s for batch in self._buffer.values() for s in batch]
            self._buffer.clear()
            self.exported_total += len(leftovers)
        for s in leftovers:
            self.exporter.export(s)
        inner_flush = getattr(self.exporter, "flush", None)
        if callable(inner_flush):
            inner_flush()

    def shutdown(self) -> None:
        self.flush()
        inner = getattr(self.exporter, "shutdown", None)
        if callable(inner):
            inner()


_provider_lock = threading.Lock()
_exporter = None  # anything with .export(Span)


def set_exporter(exporter) -> None:
    """Install the process-wide exporter (InMemorySpanExporter in tests,
    OtlpHttpExporter in production); None restores noop."""
    global _exporter
    with _provider_lock:
        _exporter = exporter


def setup_exporter_from_env(env=None):
    """Install an OtlpHttpExporter when OTEL_EXPORTER_OTLP_ENDPOINT is set
    (the standard OTel env contract; OTEL_SERVICE_NAME optional).  Returns
    the installed exporter (caller owns shutdown()) or None.

    Export is tail-sampled by default: errored and slow attempts always
    leave the process, fast successes with TRACE_TAIL_SAMPLE_RATE
    probability (default 0.01).  TRACE_TAIL_SLOW_THRESHOLD_S tunes the
    slow cut (default 1.0s); TRACE_TAIL_SAMPLING=false restores the old
    export-everything behavior."""
    env = env if env is not None else os.environ
    endpoint = env.get("OTEL_EXPORTER_OTLP_ENDPOINT", "")
    if not endpoint:
        return None
    exporter = OtlpHttpExporter(
        endpoint, service_name=env.get("OTEL_SERVICE_NAME", "kubeflow-tpu"))
    installed = exporter
    if env.get("TRACE_TAIL_SAMPLING", "true").lower() not in (
            "0", "false", "no", "off"):
        installed = TailSampler(
            exporter,
            slow_threshold_s=float(
                env.get("TRACE_TAIL_SLOW_THRESHOLD_S", "1.0")),
            sample_rate=float(env.get("TRACE_TAIL_SAMPLE_RATE", "0.01")),
        )
        logger.info(
            "OTLP trace export -> %s (tail-sampled: errors + >%.3fs "
            "always, else p=%.3f)", exporter.url,
            installed.slow_threshold_s, installed.sample_rate)
    else:
        logger.info("OTLP trace export -> %s (unsampled)", exporter.url)
    set_exporter(installed)
    return installed


def get_tracer(name: str) -> Tracer:
    """Tracer whose exporter is resolved at each span start, matching the
    reference's OnceValue'd tracer that resolves the provider lazily."""
    return Tracer(name)
