"""Bounded, queryable flight recorder for reconcile attempts: the port's
copy of kubeflow_tpu/utils/flightrecorder.py.

Every reconcile attempt is a traced span with fault events — but
fire-and-forget: once exported (or dropped by the noop exporter) nothing
in the pod remembers it, so "why was notebook X slow to become Ready an
hour ago" needs an external trace backend the standalone/demo mode does
not have.  Production notebook platforms answer exactly these questions
from recent per-session history (NotebookOS, arXiv:2503.20591;
ElasticNotebook, arXiv:2309.11083).  This module keeps that history
in-process, bounded, and queryable:

  - a ring buffer of the last `capacity` completed attempt summaries
    (object key, controller, result, total + per-phase durations pulled
    from the span tree, trace id, error text, injected-fault events);
  - a capped per-object history, so one hot object cannot evict every
    other object's recent past from the queryable view;
  - separate retained sets for the SLOWEST and ERRORED attempts — the
    attempts an operator actually asks about — which survive ring
    eviction;
  - a capped trace store (span trees by trace id) backing
    `/debug/traces/<trace_id>` and OpenMetrics exemplar resolution.

The Manager feeds `record()` with each finished reconcile ROOT span
(kube/controller.py); spans always record in-process (utils/tracing.py),
so the recorder works with no exporter installed and is deterministic
under a FakeClock.  All durations come from span timestamps, which follow
`tracing.set_clock`.  Everything is O(bounds) memory and lock-guarded —
the recorder must never be the thing that takes down the control plane.
"""

from __future__ import annotations

import heapq
import threading
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Optional


def span_to_dict(span) -> dict:
    """Serialize a finished Span (and its children, recursively) to plain
    JSON-able data for the /debug endpoints."""
    return {
        "name": span.name,
        "trace_id": span.trace_id,
        "span_id": span.span_id,
        "parent_span_id": span.parent.span_id if span.parent else "",
        "start_time": span.start_time,
        "end_time": span.end_time,
        "duration_s": max(span.end_time - span.start_time, 0.0),
        "attributes": dict(span.attributes),
        "events": [
            {"name": e.name, "timestamp": e.timestamp,
             "attributes": dict(e.attributes)}
            for e in span.events
        ],
        "children": [span_to_dict(c) for c in span.children],
    }


def _phase_durations(root) -> dict[str, float]:
    """Per-phase seconds from the attempt's span tree.  A span counts as a
    phase when it carries a `phase` attribute (the controllers stamp
    render/apply/status, cert_trust/routing/auth, culling) or is a direct
    child of the root; keyed by that attribute (else the span name), with
    repeated phases summing.  Nested phases (odh's `auth` runs inside
    `routing`) report their own wall time AND count inside the enclosing
    phase — phase durations are attributions, not a partition."""
    out: dict[str, float] = {}

    def visit(span, direct: bool) -> None:
        for child in span.children:
            if direct or "phase" in child.attributes:
                phase = str(child.attributes.get("phase", child.name))
                out[phase] = out.get(phase, 0.0) + \
                    max(child.end_time - child.start_time, 0.0)
            visit(child, False)

    visit(root, True)
    return out


@dataclass
class AttemptRecord:
    """One completed reconcile attempt, summarized from its span tree."""

    object_key: str           # "namespace/name"
    controller: str
    attempt: int
    result: str               # success / error / requeue / requeue_after
    start_time: float
    end_time: float
    duration_s: float
    phases: dict[str, float] = field(default_factory=dict)
    trace_id: str = ""
    span_id: str = ""
    error: str = ""           # "ExceptionType: message" for errored attempts
    faults: list[dict] = field(default_factory=list)  # fault.injected events
    # real (monotonic) execution window stamped by the Manager: span times
    # follow the injected clock, which stands still during a FakeClock run,
    # so per-key serialization can only be audited against wall time
    mono_start: float = 0.0
    mono_end: float = 0.0

    def to_dict(self) -> dict:
        return {
            "object": self.object_key,
            "controller": self.controller,
            "attempt": self.attempt,
            "result": self.result,
            "start_time": self.start_time,
            "end_time": self.end_time,
            "duration_s": self.duration_s,
            "phases": dict(self.phases),
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "error": self.error,
            "faults": [dict(f) for f in self.faults],
            # the real-time execution window rides into diagnostics
            # bundles so the cross-process overlap sweep (ops/diagnose
            # --merge over several managers' bundles) can run offline
            "mono_start": self.mono_start,
            "mono_end": self.mono_end,
        }


def record_from_dict(d: dict) -> AttemptRecord:
    """Rebuild an AttemptRecord from its to_dict() form — the read half
    of the diagnostics-bundle round trip (ops/diagnose --merge)."""
    return AttemptRecord(
        object_key=str(d.get("object", "")),
        controller=str(d.get("controller", "")),
        attempt=int(d.get("attempt", 0)),
        result=str(d.get("result", "unknown")),
        start_time=float(d.get("start_time", 0.0)),
        end_time=float(d.get("end_time", 0.0)),
        duration_s=float(d.get("duration_s", 0.0)),
        phases=dict(d.get("phases") or {}),
        trace_id=str(d.get("trace_id", "")),
        span_id=str(d.get("span_id", "")),
        error=str(d.get("error", "")),
        faults=[dict(f) for f in d.get("faults") or ()],
        mono_start=float(d.get("mono_start", 0.0) or 0.0),
        mono_end=float(d.get("mono_end", 0.0) or 0.0),
    )


def sweep_overlaps(records) -> list[tuple[AttemptRecord, AttemptRecord]]:
    """Pairs of attempts for the SAME (controller, object) whose real-time
    execution windows overlap — each pair is a serialization violation.
    Takes ANY iterable of AttemptRecords (one recorder's history, or
    several managers' histories merged), so the same sweep audits a
    single process and a sharded fleet: two replicas reconciling one key
    in the same wall-clock window is exactly a cross-process
    double-reconcile.  Attempts without monotonic stamps are skipped.

    Sort-by-start sweep with an active min-heap on window end:
    O(n log n + v) per key; touching endpoints are clean."""
    per_key: dict[tuple[str, str], list[AttemptRecord]] = {}
    for r in records:
        if r.mono_end > r.mono_start > 0.0:
            per_key.setdefault((r.object_key, r.controller), []).append(r)
    violations: list[tuple[AttemptRecord, AttemptRecord]] = []
    for runs in per_key.values():
        runs.sort(key=lambda r: r.mono_start)
        active: list[tuple[float, int, AttemptRecord]] = []
        for i, cur in enumerate(runs):
            while active and active[0][0] <= cur.mono_start:
                heapq.heappop(active)
            for _, _, prev in active:
                violations.append((prev, cur))
            heapq.heappush(active, (cur.mono_end, i, cur))
    return violations


class FlightRecorder:
    """Ring buffer + retained sets + trace store; see module docstring.

    Bounds: `capacity` attempts in the ring, `per_object` attempts per
    object key across at most `max_objects` keys (LRU-evicted),
    `keep_slowest` / `keep_errored` retained attempts, `keep_traces` span
    trees (LRU-evicted; a retained attempt whose trace aged out still has
    its summary — only the span detail is gone)."""

    def __init__(self, capacity: int = 512, per_object: int = 32,
                 keep_slowest: int = 16, keep_errored: int = 16,
                 keep_traces: int = 256, max_objects: int = 1024) -> None:
        self.capacity = capacity
        self.per_object = per_object
        self.keep_slowest = keep_slowest
        self.keep_errored = keep_errored
        self.keep_traces = keep_traces
        self.max_objects = max_objects
        self._lock = threading.Lock()
        self._ring: deque[AttemptRecord] = deque(maxlen=capacity)
        self._by_object: "OrderedDict[str, deque[AttemptRecord]]" = \
            OrderedDict()
        self._slowest: list[AttemptRecord] = []
        self._errored: deque[AttemptRecord] = deque(maxlen=keep_errored)
        # trace_id -> list of attempt root-span trees (one per attempt of
        # the retry chain), serialized at record time
        self._traces: "OrderedDict[str, list[dict]]" = OrderedDict()
        self.recorded_total = 0

    # -- write side (Manager, on root-span completion) ------------------------
    def record(self, root_span) -> Optional[AttemptRecord]:
        """Summarize a finished reconcile root span into the recorder.
        Returns the record (tests introspect it), or None for spans that
        are not attempt roots."""
        if root_span is None or not root_span.recording or \
                root_span.parent is not None:
            return None
        attrs = root_span.attributes
        object_key = "%s/%s" % (attrs.get("namespace", ""),
                                attrs.get("name", ""))
        error = ""
        faults = []
        for ev in root_span.events:
            if ev.name == "reconcile.error":
                error = "%s: %s" % (
                    ev.attributes.get("exception.type", ""),
                    ev.attributes.get("exception.message", ""))
            elif ev.name == "fault.injected":
                faults.append(dict(ev.attributes))
        rec = AttemptRecord(
            object_key=object_key,
            controller=str(attrs.get("controller", "")),
            attempt=int(attrs.get("attempt", 0)),
            result=str(attrs.get("reconcile.result", "unknown")),
            start_time=root_span.start_time,
            end_time=root_span.end_time,
            duration_s=max(root_span.end_time - root_span.start_time, 0.0),
            phases=_phase_durations(root_span),
            trace_id=root_span.trace_id,
            span_id=root_span.span_id,
            error=error,
            faults=faults,
            mono_start=float(attrs.get("mono_start", 0.0) or 0.0),
            mono_end=float(attrs.get("mono_end", 0.0) or 0.0),
        )
        tree = span_to_dict(root_span)
        with self._lock:
            self.recorded_total += 1
            self._ring.append(rec)
            history = self._by_object.get(object_key)
            if history is None:
                history = deque(maxlen=self.per_object)
                self._by_object[object_key] = history
            history.append(rec)
            self._by_object.move_to_end(object_key)
            while len(self._by_object) > self.max_objects:
                self._by_object.popitem(last=False)
            if rec.result == "error" or rec.error:
                self._errored.append(rec)
            self._slowest.append(rec)
            self._slowest.sort(key=lambda r: r.duration_s, reverse=True)
            del self._slowest[self.keep_slowest:]
            attempts = self._traces.setdefault(rec.trace_id, [])
            attempts.append(tree)
            self._traces.move_to_end(rec.trace_id)
            while len(self._traces) > self.keep_traces:
                self._traces.popitem(last=False)
        return rec

    # -- read side (the /debug endpoints, tests) ------------------------------
    def attempts(self, object_key: Optional[str] = None
                 ) -> list[AttemptRecord]:
        """Recorded attempts, oldest first: the ring, or one object's
        capped history when `object_key` ("ns/name") is given."""
        with self._lock:
            if object_key is None:
                return list(self._ring)
            return list(self._by_object.get(object_key, ()))

    def slowest(self) -> list[AttemptRecord]:
        with self._lock:
            return list(self._slowest)

    def errored(self) -> list[AttemptRecord]:
        with self._lock:
            return list(self._errored)

    def trace(self, trace_id: str) -> Optional[dict]:
        """The recorded span trees of one trace (one root per attempt of
        the retry chain), or None if unknown / evicted."""
        with self._lock:
            attempts = self._traces.get(trace_id)
            if attempts is None:
                return None
            return {"trace_id": trace_id, "attempts": len(attempts),
                    "spans": [dict(t) for t in attempts]}

    def objects(self) -> dict[str, int]:
        """Object keys with recorded history -> attempt count retained."""
        with self._lock:
            return {k: len(v) for k, v in self._by_object.items()}

    def overlapping_attempts(self) -> list[tuple[AttemptRecord,
                                                 AttemptRecord]]:
        """Pairs of recorded attempts for the SAME (controller, object)
        whose real-time execution windows overlap — each pair is a per-key
        serialization violation (two workers reconciled one key at once).
        Checked over per-object histories (bounded by per_object), using
        the monotonic stamps the Manager rides on every root span; attempts
        without stamps (records from before the Manager stamped them) are
        skipped.

        Delegates to the module-level `sweep_overlaps`, which also runs
        over several managers' MERGED histories (the sharded fleet's
        cross-process audit and ops/diagnose --merge); equivalence
        against the brute-force all-pairs result is pinned by
        tests/test_slo.py."""
        with self._lock:
            histories = {k: list(v) for k, v in self._by_object.items()}
        violations: list[tuple[AttemptRecord, AttemptRecord]] = []
        for records in histories.values():
            violations.extend(sweep_overlaps(records))
        return violations

    def snapshot(self, object_key: Optional[str] = None) -> dict:
        """The /debug/reconciles body: bounds, totals, and the requested
        view (global ring or one object's history) plus retained sets."""
        with self._lock:
            view = (list(self._by_object.get(object_key, ()))
                    if object_key is not None else list(self._ring))
            return {
                "recorded_total": self.recorded_total,
                "bounds": {
                    "capacity": self.capacity,
                    "per_object": self.per_object,
                    "keep_slowest": self.keep_slowest,
                    "keep_errored": self.keep_errored,
                    "keep_traces": self.keep_traces,
                },
                "object": object_key,
                "attempts": [r.to_dict() for r in view],
                "slowest": [r.to_dict() for r in self._slowest],
                "errored": [r.to_dict() for r in self._errored],
                "objects": {k: len(v) for k, v in self._by_object.items()},
            }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._by_object.clear()
            self._slowest.clear()
            self._errored.clear()
            self._traces.clear()


__all__ = ["AttemptRecord", "FlightRecorder", "record_from_dict",
           "span_to_dict", "sweep_overlaps"]
