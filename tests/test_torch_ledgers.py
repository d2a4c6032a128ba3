"""The port's lifecycle and metering ledgers, diagnosis engine and fleet
views against the reference's.

Each scenario of tests/test_{lifecycle,metering,diagnosis,slo}.py that
these modules answer is written once, as a function of one package's
modules, and run on both: the reference's (`kubeflow_tpu`) and the
port's (`kubeflow_tpu_torch`), each on its own FakeClock from the same
epoch, with its own tracing clock.  The engines are plain Python over
floats the scenarios inject, so the two outputs must be equal exactly,
once trace ids (random on each side) are read as one token.

The whole-stack scenarios run both `main.build_manager`s (the
reference's with its Manager on a FakeClock) with the slice scheduler on:
a `spec.tpu` slice against a `spec.gpu` gang of the same host count, 1
and 2 hosts (v5e 2x4 against 8 H100s; v4 2x2x2, 8 chips on 2 hosts,
against 16 H100s, so the reference's chip-seconds are scaled by 2), cold
provisioned, a worker failed and restarted, then stopped.  Then
/debug/criticalpath, /debug/tenants, /debug/alerts, /debug/timeline's
dump, the fleet rollup, the SLO verdicts and the explain chain must be
equal after the device keys: the shape tokens and the words "slice" and
"gang" in Event messages.  The apiserver verb counts are compared whole:
both lift the ODH lock with one merge patch.

Only the reference's control plane is imported, and no process is
launched."""

from __future__ import annotations

import functools
import json
import random
import re
from types import SimpleNamespace

import pytest

import kubeflow_tpu.core.metrics as ref_core_metrics
import kubeflow_tpu.main as ref_main
import kubeflow_tpu.utils.diagnosis as ref_diagnosis
import kubeflow_tpu.utils.flightrecorder as ref_flightrecorder
import kubeflow_tpu.utils.lifecycle as ref_lifecycle
import kubeflow_tpu.utils.metering as ref_metering
import kubeflow_tpu.utils.tracing as ref_tracing
import kubeflow_tpu.utils.tsdb as ref_tsdb
from kubeflow_tpu import kube as ref_kube
from kubeflow_tpu.api import types as ref_types
from kubeflow_tpu.core import constants as ref_constants
from kubeflow_tpu.core.notebook_controller import (
    setup_core_controllers as ref_setup,
)
from kubeflow_tpu.utils.clock import FakeClock as RefFakeClock
from kubeflow_tpu.utils.config import CoreConfig as RefConfig
from kubeflow_tpu.utils.config import OdhConfig as RefOdhConfig
from kubeflow_tpu.utils.metrics import Registry as RefRegistry
from kubeflow_tpu_torch import kube
from kubeflow_tpu_torch import main as port_main
from kubeflow_tpu_torch.api import types as port_types
from kubeflow_tpu_torch.core import constants as port_constants
from kubeflow_tpu_torch.core import metrics as port_core_metrics
from kubeflow_tpu_torch.core.notebook_controller import setup_core_controllers
from kubeflow_tpu_torch.utils import diagnosis as port_diagnosis
from kubeflow_tpu_torch.utils import flightrecorder as port_flightrecorder
from kubeflow_tpu_torch.utils import lifecycle as port_lifecycle
from kubeflow_tpu_torch.utils import metering as port_metering
from kubeflow_tpu_torch.utils import tracing as port_tracing
from kubeflow_tpu_torch.utils import tsdb as port_tsdb
from kubeflow_tpu_torch.utils.clock import FakeClock
from kubeflow_tpu_torch.utils.config import CoreConfig, OdhConfig
from kubeflow_tpu_torch.utils.metrics import Registry

T0 = 1_760_000_000.0

REF = SimpleNamespace(
    port=False, kube=ref_kube, tracing=ref_tracing, lifecycle=ref_lifecycle,
    metering=ref_metering, diagnosis=ref_diagnosis, tsdb=ref_tsdb,
    FlightRecorder=ref_flightrecorder.FlightRecorder, Clock=RefFakeClock,
    Registry=RefRegistry, metrics=ref_core_metrics, types=ref_types,
    C=ref_constants, setup=ref_setup, Config=RefConfig)
PORT = SimpleNamespace(
    port=True, kube=kube, tracing=port_tracing, lifecycle=port_lifecycle,
    metering=port_metering, diagnosis=port_diagnosis, tsdb=port_tsdb,
    FlightRecorder=port_flightrecorder.FlightRecorder, Clock=FakeClock,
    Registry=Registry, metrics=port_core_metrics, types=port_types,
    C=port_constants, setup=setup_core_controllers, Config=CoreConfig)

_TRACE = re.compile(r"\b[0-9a-f]{32}\b")


def canon(obj) -> str:
    """`obj` as canonical JSON with every trace id read as one token."""
    return _TRACE.sub("<trace>", json.dumps(obj, sort_keys=True,
                                            default=str))


def both(scenario, *args):
    """Run `scenario(side, *args)` on each package (each on its own
    FakeClock, with its tracing clock set to it) and require equal
    outputs; returns the port's."""
    out = []
    for side in (REF, PORT):
        clock = side.Clock(T0)
        side.tracing.set_clock(clock)
        try:
            out.append(scenario(side, clock, *args))
        finally:
            side.tracing.set_clock(None)
    ref, ours = out
    assert canon(ours) == canon(ref)
    return ours


# -- lifecycle ledger ----------------------------------------------------------


class Harness:
    """Feeds a ledger (and optionally a diagnosis engine) the way the
    Manager does: one finished root span and its AttemptRecord per
    reconcile attempt."""

    def __init__(self, side, clock, engine=False):
        self.side, self.clock = side, clock
        self.tracer = side.tracing.get_tracer("ledger-parity")
        self.recorder = side.FlightRecorder()
        self.ledger = side.lifecycle.LifecycleLedger()
        self.engine = side.diagnosis.DiagnosisEngine(
            clock, recorder=self.recorder, lifecycle=self.ledger) \
            if engine else None

    def attempt(self, *, controller="notebook", ns="u1", name="nb", gen=1,
                manager_id="", cause_ts=None, result="success", body=None):
        attrs = {"controller": controller, "namespace": ns, "name": name,
                 "generation": gen}
        if cause_ts is not None:
            attrs["cause_ts"] = cause_ts
        with self.tracer.start_span("reconcile", attrs) as root:
            if body is not None:
                body(root)
            root.set_attribute("reconcile.result", result)
        rec = self.recorder.record(root)
        self.ledger.observe_attempt(rec, root, manager_id)
        if self.engine is not None:
            self.engine.observe_attempt(rec)
        return rec

    def phase(self, phase, seconds, events=()):
        with self.tracer.start_span(phase, {"phase": phase}) as span:
            for ev_name, ev_attrs in events:
                span.add_event(ev_name, ev_attrs)
            self.clock.advance(seconds)

    def ready(self, *, name="nb", gen=1, cold_s=5.0):
        cause = self.clock.now()
        self.clock.advance(1.0)
        return self.attempt(
            name=name, gen=gen, cause_ts=cause,
            body=lambda root: (self.phase("schedule", cold_s),
                               root.add_event("notebook.ready", {})))

    def out(self, *keys):
        return {"entries": {f"{k[0]}@{k[1]}": self.ledger.entry(
                    "u1", k[0], k[1]) for k in keys},
                "snapshot": self.ledger.snapshot(),
                "conservation": self.ledger.conservation(),
                "ranking": self.ledger.ranking(),
                "rollup": self.ledger.namespace_rollup(),
                "p99s": self.ledger.stage_p99s(),
                "pending": self.ledger.pending_count(),
                "excursions": self.ledger.excursions_total}


def _partition(side, clock):
    h = Harness(side, clock)
    cause = clock.now()
    clock.advance(3.0)

    def body(root):
        h.phase("render", 0.5)
        h.phase("apply", 1.0)
        clock.advance(0.25)
        root.add_event("notebook.ready", {"seconds": 4.75})

    h.attempt(cause_ts=cause, body=body)
    return h.out(("nb", 1))


def _retry_backoff(side, clock):
    h = Harness(side, clock)
    cause = clock.now()
    for gap in (2.0, 4.0):
        h.attempt(cause_ts=cause, result="error",
                  body=lambda root: h.phase("render", 0.5))
        clock.advance(gap)

    def final(root):
        h.phase("render", 0.5)
        h.phase("apply", 1.0)
        root.add_event("notebook.ready", {})

    h.attempt(cause_ts=cause, body=final)
    return h.out(("nb", 1))


def _pod_waits(side, clock):
    h = Harness(side, clock)
    cause = clock.now()
    h.attempt(cause_ts=cause, body=lambda root: root.add_event(
        "notebook.waiting", {"on": "pod_schedule", "ready": 0}))
    clock.advance(5.0)
    h.attempt(cause_ts=cause, body=lambda root: root.add_event(
        "notebook.waiting", {"on": "pod_start", "ready": 1}))
    clock.advance(7.0)
    h.attempt(cause_ts=cause,
              body=lambda root: root.add_event("notebook.ready", {}))
    return h.out(("nb", 1))


def _warm_vs_cold(side, clock):
    h = Harness(side, clock)
    cause = clock.now()
    h.attempt(controller="slice-scheduler", cause_ts=cause,
              body=lambda root: h.phase(
                  "schedule", 0.0,
                  events=[("schedule.wait", {"reason": "provisioning"})]))
    clock.advance(120.0)
    h.attempt(cause_ts=cause,
              body=lambda root: root.add_event("notebook.ready", {}))
    cause2 = clock.now()
    h.attempt(name="nb2", controller="slice-scheduler", cause_ts=cause2,
              body=lambda root: h.phase("schedule", 0.5))
    clock.advance(1.0)
    h.attempt(name="nb2", cause_ts=cause2,
              body=lambda root: root.add_event("notebook.ready", {}))
    return h.out(("nb", 1), ("nb2", 1))


def _overlap_clipped(side, clock):
    ledger = side.lifecycle.LifecycleLedger()
    t0 = 1000.0

    def feed(controller, start, end, ready_ts=None):
        root = side.tracing.Span(name="reconcile", attributes={
            "controller": controller, "namespace": "u1", "name": "nb",
            "generation": 1, "cause_ts": t0,
        }, start_time=start, end_time=end, trace_id="ab" * 16)
        if ready_ts is not None:
            root.events.append(
                side.tracing.SpanEvent("notebook.ready", {}, ready_ts))
        rec = SimpleNamespace(start_time=start, end_time=end,
                              trace_id=root.trace_id, result="success")
        ledger.observe_attempt(rec, root, "")

    feed("notebook", t0 + 1.0, t0 + 5.0)
    feed("slice-scheduler", t0 + 2.0, t0 + 4.0)
    feed("notebook", t0 + 6.0, t0 + 8.0, ready_ts=t0 + 8.0)
    return ledger.entry("u1", "nb", 1)


def _generations(side, clock):
    h = Harness(side, clock)
    cause = clock.now()
    clock.advance(1.0)
    h.attempt(gen=1, cause_ts=cause,
              body=lambda root: root.add_event("notebook.ready", {}))
    cause2 = clock.now()
    clock.advance(2.0)
    h.attempt(gen=2, cause_ts=cause2,
              body=lambda root: root.add_event("notebook.ready", {}))
    # a stale-cache attempt without the generation joins the latest one
    h.attempt(name="nb3", gen=3, cause_ts=clock.now())
    clock.advance(1.0)
    h.attempt(name="nb3", gen=0, cause_ts=cause,
              body=lambda root: root.add_event("notebook.ready", {}))
    h.attempt(controller="event-reemit")
    h.attempt(controller="warm-pool")
    return h.out(("nb", 1), ("nb", 2), ("nb3", 3), ("nb3", 1))


def _lru(side, clock):
    h = Harness(side, clock)
    h.ledger.max_notebooks = 4
    for i in range(10):
        h.attempt(name=f"nb-{i}")
    return h.out(("nb-0", 1), ("nb-9", 1))


def _excursions(side, clock):
    """Post-ready recover, migrate and promote land in the stage
    histograms and the excursion ring, never in the conserved window."""
    h = Harness(side, clock)
    cause = clock.now()
    clock.advance(1.0)
    h.attempt(cause_ts=cause,
              body=lambda root: root.add_event("notebook.ready", {}))
    before = h.ledger.conservation()
    h.attempt(body=lambda root: h.phase("recover", 2.5))
    h.attempt(body=lambda root: h.phase("migrate", 1.5))
    h.attempt(body=lambda root: h.phase("promote", 0.25))
    h.attempt(body=lambda root: h.phase("status", 0.1))
    out = h.out(("nb", 1))
    out["before"] = before
    out["ring"] = h.ledger.excursions("u1", "nb")
    out["latest"] = h.ledger.latest_entry("u1", "nb")
    return out


def _handoff(side, clock):
    h = Harness(side, clock)
    cause = clock.now()
    h.attempt(cause_ts=cause, manager_id="m-0",
              body=lambda root: h.phase("render", 0.5))
    clock.advance(3.0)
    h.attempt(cause_ts=cause, manager_id="m-1",
              body=lambda root: root.add_event("notebook.ready", {}))
    return h.out(("nb", 1))


LIFECYCLE = {"partition": _partition, "retry_backoff": _retry_backoff,
             "pod_waits": _pod_waits, "warm_vs_cold": _warm_vs_cold,
             "overlap_clipped": _overlap_clipped,
             "generations": _generations, "lru": _lru,
             "excursions": _excursions, "handoff": _handoff}


@pytest.mark.parametrize("name", sorted(LIFECYCLE))
def test_lifecycle_ledger_matches_the_reference(name):
    out = both(LIFECYCLE[name])
    if name == "overlap_clipped":
        assert out["finalized"] and out["wall_s"] == 8.0
        return
    assert out["conservation"]["violations"] == 0
    if name == "warm_vs_cold":
        cold, warm = (out["entries"][k] for k in ("nb@1", "nb2@1"))
        assert cold["stages"]["schedule_cold"] == pytest.approx(120.0)
        assert warm["stages"]["schedule_warm"] == pytest.approx(0.5)
    elif name == "retry_backoff":
        stages = out["entries"]["nb@1"]["stages"]
        assert stages["retry_backoff"] == pytest.approx(6.0)
        assert stages["render"] == pytest.approx(1.5)
    elif name == "excursions":
        assert out["conservation"] == out["before"]
        assert out["excursions"] == 3
        assert [x["stage"] for x in out["ring"]] == [
            "recover", "migrate", "promote"]
    elif name == "lru":
        assert out["pending"] == 4 and out["entries"]["nb-0@1"] is None
    elif name == "handoff":
        assert out["entries"]["nb@1"]["stages"]["handoff_wait"] == 3.0


# -- metering ledger -----------------------------------------------------------


def _accrual(side, clock):
    m = side.metering
    led = m.TenantMeteringLedger(clock)
    key = ("team-a", "nb-0")
    for bucket, dt in ((m.BUCKET_SCHEDULING, 5), (m.BUCKET_READY, 10),
                       (m.BUCKET_READY, 3), (m.BUCKET_RECOVERING, 2),
                       (m.BUCKET_RECOVERING, 0)):
        led.sample({key: (bucket, 8.0)})
        clock.advance(dt)
    led.sample({})
    idle = ("team-b", "nb-idle")
    led.sample({idle: (m.BUCKET_READY, 4.0)})
    clock.advance(10)
    led.sample({idle: (m.BUCKET_IDLE, 4.0)})
    clock.advance(30)
    led.sample({idle: (m.BUCKET_IDLE, 4.0)})
    led.sample({})
    # a replaced interval: the gap between the two is not metered
    again = ("team-b", "nb-again")
    led.sample({again: (m.BUCKET_READY, 4.0)})
    clock.advance(7)
    led.sample({})
    clock.advance(100)
    led.sample({again: (m.BUCKET_SCHEDULING, 4.0)})
    clock.advance(3)
    led.sample({again: (m.BUCKET_SCHEDULING, 4.0)})
    led.sample({})
    cpu = ("team-c", "cpu-nb")
    led.sample({cpu: (m.BUCKET_READY, 0.0)})
    clock.advance(42)
    led.sample({})
    return {"table": led.tenant_table(), "conservation": led.conservation(),
            "violations": led.violations(), "series": led.tenant_chip_series(),
            "finalized": led.finalized_total, "snapshot": led.snapshot()}


def _tampered(side, clock):
    m = side.metering
    led = m.TenantMeteringLedger(clock, tolerance=0.05)
    key = ("team-a", "nb-0")
    led.sample({key: (m.BUCKET_READY, 4.0)})
    clock.advance(10)
    led.sample({key: (m.BUCKET_READY, 4.0)})
    meter = next(iter(led._meters.values()))
    meter.buckets[m.BUCKET_READY] += 5.0
    led.sample({})
    return {"conservation": led.conservation(),
            "violations": led.violations()}


def _lru_eviction(side, clock):
    m = side.metering
    led = m.TenantMeteringLedger(clock, max_notebooks=2)
    for i in range(4):
        led.sample({("team-a", f"nb-{j}"): (m.BUCKET_READY, 1.0)
                    for j in range(i + 1)})
        clock.advance(5)
    return {"conservation": led.conservation(), "table": led.tenant_table(),
            "snapshot": led.snapshot()}


def _attribution(side, clock):
    reg = side.Registry()
    fams = side.metering.register_metering_metrics(reg)
    led = side.metering.TenantMeteringLedger(clock, registry=reg,
                                             max_tenants=3)
    led.observe_dispatch("team-a", queue_s=0.5, e2r_s=1.5)
    led.observe_dispatch("team-a", queue_s=0.25, e2r_s=0.75)
    led.observe_dispatch("team-b", queue_s=0.1, e2r_s=0.1)
    snap = {("update", "Notebook", "team-a"): 5,
            ("get", "Notebook", "team-a"): 2, ("list", "Node", ""): 50}
    led.ingest_apiserver(snap)
    led.ingest_apiserver(snap)
    led.ingest_apiserver({("update", "Notebook", "team-a"): 8,
                          ("get", "Notebook", "team-a"): 2})
    for ns in ("team-c", "team-d", "", "team-e"):
        led.observe_dispatch(ns, 0.0, 0.0)
    led.observe_attempt(SimpleNamespace(trace_id="trace-xyz",
                                        object_key="team-a/nb-0"))
    led.observe_attempt(None)
    led.observe_attempt(SimpleNamespace(trace_id="t2",
                                        object_key="no-namespace"))
    return {"table": led.tenant_table(), "render": reg.render(),
            "queue": sorted(fams["queue"].collect().items())}


class _SLOStub:
    def __init__(self):
        self.latched = []

    def latch_exemplar(self, objective, exemplar):
        self.latched.append((objective, exemplar))


def _noisy_neighbour(side, clock):
    """Latch baselines, run benign rounds, flood one tenant while the
    other's event->reconcile p99 degrades (one flag, one Warning event,
    the SLO exemplar latched), clear, and flood again (the same Event,
    count 2)."""
    api = side.kube.ApiServer()
    led = side.metering.TenantMeteringLedger(
        clock, slo_engine=_SLOStub(), fairshare_factor=1.5, window_evals=4,
        recorder=side.kube.EventRecorder(api, "tenant-metering"))
    for ns in ("team-noisy", "team-quiet"):
        for _ in range(led.baseline_samples):
            led.observe_dispatch(ns, 0.0, 0.01)
    led.observe_attempt(SimpleNamespace(trace_id="noisy-trace",
                                        object_key="team-noisy/nb-0"))
    verdicts = []

    def benign(rounds):
        for _ in range(rounds):
            for ns in ("team-noisy", "team-quiet"):
                for _ in range(10):
                    led.observe_dispatch(ns, 0.0, 0.01)
            verdicts.append(led.evaluate())

    def flood(rounds=3):
        for _ in range(rounds):
            for _ in range(100):
                led.observe_dispatch("team-noisy", 0.0, 0.0)
            for _ in range(3):
                led.observe_dispatch("team-quiet", 0.0, 5.0)
            verdicts.append(led.evaluate())

    benign(3)
    flood()
    flagged = led.flagged()
    benign(led.window_evals + 1)
    cleared = led.flagged()
    flood()
    events = sorted(
        (e.body["involvedObject"]["name"], e.body["type"], e.body["count"],
         e.body["message"]) for e in api.list("Event")
        if e.body.get("reason") == side.metering.REASON_NOISY)
    return {"verdicts": verdicts, "flagged": flagged, "cleared": cleared,
            "events": events, "latched": led.slo_engine.latched,
            "checks": dict(led.checks), "table": led.tenant_table()}


METERING = {"accrual": _accrual, "tampered": _tampered,
            "lru_eviction": _lru_eviction, "attribution": _attribution,
            "noisy_neighbour": _noisy_neighbour}


@pytest.mark.parametrize("name", sorted(METERING))
def test_metering_ledger_matches_the_reference(name):
    out = both(METERING[name])
    if name == "accrual":
        assert out["conservation"]["violations"] == 0
        row = out["table"]["team-a"]
        assert row["chip_seconds_total"] == pytest.approx(8.0 * 20)
        assert out["table"]["team-b"]["chip_seconds"]["idle"] == 120.0
    elif name == "tampered":
        assert out["conservation"]["violations"] == 1
    elif name == "noisy_neighbour":
        assert out["flagged"] == ["team-noisy"] and out["cleared"] == []
        assert [e[2] for e in out["events"]] == [2]
        assert out["latched"][0] == (
            "tenant_fairness",
            {"trace_id": "noisy-trace", "tenant": "team-noisy"})
    elif name == "attribution":
        assert out["table"]["team-a"]["apiserver"] == {"get": 2,
                                                      "update": 8}
        assert "" not in out["table"]


def test_metering_census_classifiers():
    """placement_gpus and metering_bucket on a gang, against the
    reference's placement_chips and metering_bucket on a slice of the
    same count."""
    ref_nb = ref_types.Notebook.new(
        "nb", "ns", tpu=ref_types.TPUSpec("v5e", "2x4")).obj
    nb = kube.KubeObject.from_dict(port_types.Notebook.new(
        "nb", "ns", gpu=port_types.GPUSpec("h100-80gb", 8)).obj)
    assert port_core_metrics.placement_gpus(nb) \
        == ref_core_metrics.placement_chips(ref_nb) == 8.0
    cpu = kube.KubeObject.from_dict(port_types.Notebook.new("c", "ns").obj)
    assert port_core_metrics.placement_gpus(cpu) == 0.0
    for health in (None, "Healthy", "Unhealthy", "Degraded", "Stopping",
                   "Stopped", "Scheduling"):
        for stopped in (False, True):
            for obj, mod, C in ((ref_nb, ref_core_metrics, ref_constants),
                                (nb, port_core_metrics, port_constants)):
                obj.body["status"] = {"sliceHealth": health} if health \
                    else {}
                obj.metadata.annotations.pop(C.STOP_ANNOTATION, None)
                if stopped:
                    obj.metadata.annotations[C.STOP_ANNOTATION] = "stamp"
            assert port_core_metrics.metering_bucket(nb) \
                == ref_core_metrics.metering_bucket(ref_nb), (health,
                                                              stopped)
            assert port_core_metrics.fleet_state(nb) \
                == ref_core_metrics.fleet_state(ref_nb)


# -- diagnosis engine ----------------------------------------------------------


def _series(values, t0=0.0, dt=60.0):
    return [[t0 + i * dt, float(v)] for i, v in enumerate(values)]


SERIES = {"step": [1] * 8 + [9] * 12, "down": [9] * 8 + [1] * 12,
          "flat": [4] * 30,
          "noise": [10 + ((i * 7) % 5 - 2) * 0.3 for i in range(40)],
          "ramp": [i * 2.0 for i in range(30)],
          "up_down": [1] * 10 + [9] * 10 + [1] * 10,
          "small_rel": [100] * 10 + [110] * 10,
          "large_rel": [100] * 10 + [400] * 10, "short": [1, 9, 1, 9]}
FIRES = {"step": 1, "down": 1, "flat": 0, "noise": 0, "up_down": 2,
         "small_rel": 0, "large_rel": 1, "short": 0}


@pytest.mark.parametrize("name", sorted(SERIES))
def test_level_latch_matches_the_reference(name):
    """A step fires once, noise never, a ramp at least once."""
    pts = _series(SERIES[name])
    ours = port_diagnosis.detect_level_shifts(pts)
    assert ours == ref_diagnosis.detect_level_shifts(pts)
    if name == "ramp":
        assert len(ours) >= 1
    else:
        assert len(ours) == FIRES[name]


def test_event_correlation_and_vocabulary_match_the_reference():
    events = [
        {"t": 100.0, "kind": "recovery", "detail": "", "object": ""},
        {"t": 110.0, "kind": "fault", "detail": "", "object": ""},
        {"t": 500.0, "kind": "promotion", "detail": "", "object": ""},
    ]
    for mod in (port_diagnosis, ref_diagnosis):
        matched = mod.correlate_events(events, 120.0, 240.0,
                                       lookback_s=120.0)
        assert {e["kind"] for e in matched} == {"recovery", "fault"}
        assert mod.matched_kind(matched) == "fault"
        assert mod.matched_kind([]) == "none"
    for name in ("ready_p99_s", "stage_p99.schedule_cold", "tenant_cs.u",
                 "workqueue_depth", "promotions_delta"):
        assert port_diagnosis.watched_series(name) \
            == ref_diagnosis.watched_series(name)


def _engine_detection(side, clock, series_name, values, fault):
    tsdb = side.tsdb.TimeSeriesStore()
    reg = side.Registry()
    eng = side.diagnosis.DiagnosisEngine(clock, registry=reg, tsdb=tsdb)
    found = []
    for i, v in enumerate(values):
        if fault and i == 8:
            with side.tracing.get_tracer("diag").start_span("reconcile", {
                    "controller": "notebook", "namespace": "u1",
                    "name": "nb"}) as root:
                root.add_event("fault.injected",
                               {"fault.rule": "api-degrade"})
                root.set_attribute("reconcile.result", "error")
            eng.observe_attempt(side.FlightRecorder().record(root))
        clock.advance(60.0)
        tsdb.sample(clock.now(), {series_name: float(v)})
        found.extend(eng.evaluate())
    for _ in range(3):
        eng.evaluate()
    raw = tsdb.query(series_name, tier="raw")["points"]
    return {"found": found, "snapshot": eng.snapshot(),
            "counts": sorted(
                reg.get("notebook_changepoints_total").collect().items()),
            "offline": side.diagnosis.detect_level_shifts(raw),
            "summary": eng.fleet_summary(), "export": eng.export()}


@pytest.mark.parametrize("case", ["step", "fault", "unwatched", "batch"])
def test_change_point_engine_matches_the_reference(case):
    values = [2] * 8 + [20] * 8 + [2] * 8 if case == "batch" \
        else [0] * 8 + [12] * 10
    name = "tenant_cs.user1" if case == "unwatched" else "workqueue_depth"
    out = both(_engine_detection, name, values, case == "fault")
    if case == "unwatched":
        assert out["found"] == []
        return
    assert [(h["t_start"], h["direction"]) for h in out["offline"]] == \
        [(h["t_start"], h["direction"]) for h in out["found"]]
    if case != "batch":
        (f,) = out["found"]
        assert f["matched"] == ("fault" if case == "fault" else "none")


def _explain(side, clock, case):
    h = Harness(side, clock, engine=True)
    if case == "unknown":
        return h.engine.explain("ghost", "nb")
    if case == "nominal":
        h.attempt(cause_ts=clock.now(),
                  body=lambda root: (h.phase("apply", 5.0),
                                     root.add_event("notebook.ready", {})))
        return h.engine.explain("u1", "nb")
    h.ready(cold_s=30.0)
    if case == "promote":
        h.attempt(body=lambda root: h.phase("promote", 2.0))
        return h.engine.explain("u1", "nb")

    def faulted(root):
        # an attempt record carrying a fault, as kube/faults.py's plan
        # stamps one on the live span
        root.add_event("fault.injected", {"fault.rule": "api-window"})
        h.phase("apply", 0.5)

    rec = h.attempt(result="error", body=faulted)
    first = h.engine.explain("u1", "nb")
    assert h.engine.explain("u1", "nb") == first
    line = h.engine.one_line_cause(rec.trace_id)
    alerts = h.engine.annotate_alerts(
        {"firing": [{"objective": "reconcile_errors",
                     "trace_id": rec.trace_id}, {}]})
    return {"explain": first, "line": line, "alerts": alerts,
            "none": h.engine.one_line_cause("no-such-trace"),
            "faults": [f for r in h.recorder.attempts() for f in r.faults]}


@pytest.mark.parametrize("case", ["fault", "promote", "nominal", "unknown"])
def test_explain_matches_the_reference(case):
    """Direct evidence (a fault on the attempt record, a promote
    excursion) scores 10 + x and outranks every stage-share inference."""
    out = both(_explain, case)
    if case == "fault":
        ex = out["explain"]
        assert ex["cause"] == port_diagnosis.CAUSE_FAULT_INJECTION
        scores = [c["score"] for c in ex["candidates"]]
        assert scores[0] >= 10 and scores == sorted(scores, reverse=True)
        assert all(c["score"] <= 1 for c in ex["candidates"][1:])
        assert "fault plan" in out["line"] and out["none"] == ""
        assert out["alerts"]["firing"][0]["diagnosis"] == out["line"]
        assert out["alerts"]["firing"][1]["diagnosis"] == ""
    elif case == "promote":
        assert out["cause"] == port_diagnosis.CAUSE_PRIMARY_FAILOVER
        assert out["candidates"][0]["score"] >= 10
    elif case == "nominal":
        assert out["cause"] == port_diagnosis.CAUSE_NOMINAL
    else:
        assert out["verdict"] == "" and out["error"]


def test_offline_bundles_match_the_reference():
    def bundle(source, values, t0=0.0):
        return {"source": source,
                "timeline": {"series": {
                    "workqueue_depth": {"raw": _series(values, t0=t0)}}},
                "diagnosis": {"timeline": [
                    {"t": t0 + 7 * 60.0, "kind": "fault",
                     "detail": "api-window", "object": "u1/nb"}]}}

    one = json.loads(json.dumps(bundle("m-0", [0] * 8 + [12] * 10)))
    hits = port_diagnosis.changepoints_from_bundle(one)
    assert hits == ref_diagnosis.changepoints_from_bundle(one)
    assert [h["matched"] for h in hits] == ["fault"]
    parts = [bundle("m-0", [1, 2, 3]), bundle("m-1", [4, 5, 6], t0=30.0),
             {"source": "empty"}]
    merged = port_diagnosis.merge_timelines(parts)
    assert merged == ref_diagnosis.merge_timelines(parts)
    assert merged["points_total"] == 6


# -- fleet and tenancy views, the census ---------------------------------------


def _new_nb(side, name, ns, count=8):
    if side.port:
        spec = {"gpu": port_types.GPUSpec("h100-80gb", count)} if count \
            else {}
        return kube.KubeObject.from_dict(
            port_types.Notebook.new(name, ns, **spec).obj)
    spec = {"tpu": ref_types.TPUSpec("v5e", "2x4")} if count else {}
    return ref_types.Notebook.new(name, ns, **spec).obj


def _census_churn(side, clock):
    """The cache's incremental fleet and metering censuses against the
    list scans, through placements, health flips, stop and unstop,
    releases, deletes and creates (seeded)."""
    api = side.kube.ApiServer()
    side.kube.FakeCluster(api).add_node(
        "cpu-node", allocatable={"cpu": "64", "memory": "256Gi"})
    mgr = side.kube.Manager(api, clock=clock)
    metrics = side.metrics.NotebookMetrics(api, manager=mgr)
    side.setup(mgr, side.Config(), metrics)
    led = side.metering.TenantMeteringLedger(clock,
                                             registry=metrics.registry)
    mgr.metering = led
    metrics.attach_metering(led)
    lists = side.metrics.NotebookMetrics(api)
    metrics.scrape()
    C = side.C
    rng = random.Random(1337)
    names = []
    for i in range(8):
        api.create(_new_nb(side, f"nb-{i}", f"team-{i % 3}",
                           count=8 * (i % 2)))
        names.append((f"team-{i % 3}", f"nb-{i}"))
    mgr.run_until_idle()
    trail = []
    next_id = 8
    for _ in range(40):
        ns, name = rng.choice(names)
        nb = api.get("Notebook", ns, name)
        op = rng.randrange(6)
        if op == 5:
            api.delete("Notebook", ns, name)
            names.remove((ns, name))
            new = (f"team-{next_id % 3}", f"nb-{next_id}")
            next_id += 1
            api.create(_new_nb(side, new[1], new[0]))
            names.append(new)
        elif op == 0:
            nb.metadata.annotations[C.ANNOTATION_PLACEMENT] = \
                json.dumps({"pool": "p"})
            api.update(nb)
        elif op == 1:
            nb.metadata.annotations.pop(C.ANNOTATION_PLACEMENT, None)
            api.update(nb)
        elif op == 2:
            nb.body.setdefault("status", {})["sliceHealth"] = rng.choice(
                ["Healthy", "Unhealthy", "Degraded", "Scheduling",
                 "Stopping"])
            api.update(nb)
        elif op == 3:
            nb.metadata.annotations[C.STOP_ANNOTATION] = "stamp"
            api.update(nb)
        else:
            nb.metadata.annotations.pop(C.STOP_ANNOTATION, None)
            api.update(nb)
        mgr.run_until_idle()
        clock.advance(1)
        metrics.scrape()
        cached = metrics.fleet_snapshot()
        listed = lists.fleet_snapshot()
        for key in ("totals", "namespaces", "shapes", "notebooks"):
            assert cached[key] == listed[key], key
        agg = dict(mgr.cache.aggregate("Notebook", "tenant-metering"))
        brute = {}
        for live in api.list("Notebook"):
            brute.update(side.metrics.NotebookMetrics._metering_census(live))
        assert {k: v for k, v in agg.items() if v} == \
            {k: v for k, v in brute.items() if v}
        trail.append((cached["totals"], cached["namespaces"]))
    mgr.stop()
    return {"trail": trail, "conservation": led.conservation(),
            "table": led.tenant_table(), "tenancy": metrics.tenancy_snapshot()}


def test_census_from_the_cache_equals_the_census_from_lists():
    out = both(_census_churn)
    assert out["conservation"]["violations"] == 0
    assert out["table"]


def _tenancy(side, clock):
    api = side.kube.ApiServer()
    metrics = side.metrics.NotebookMetrics(api)
    C = side.C
    for i, ns in enumerate(("a", "a", "b")):
        nb = _new_nb(side, f"nb-{i}", ns)
        if i < 2:
            nb.metadata.annotations[C.ANNOTATION_PLACEMENT] = "{}"
        else:
            nb.metadata.annotations[C.ANNOTATION_QUEUED] = json.dumps(
                {"since": 12.5})
        api.create(nb)
    api.create(_new_nb(side, "cpu", "c", count=0))
    quota = side.kube.KubeObject.from_dict({
        "apiVersion": "kubeflow.org/v1alpha1", "kind": C.TENANTQUOTA_KIND,
        "metadata": {"name": C.TENANTQUOTA_NAME},
        "spec": {"tenants": {"a": {"weight": 2}}},
        "status": {"preemptions": {"x": {}},
                   "recentPreemptions": [{"victim": "b/nb-2"}]}})
    api.create(quota)
    fleet = metrics.fleet_snapshot()
    fleet["shapes"] = {"<shape>" if "-" in k else k: v
                       for k, v in fleet["shapes"].items()}
    return {"tenancy": metrics.tenancy_snapshot(), "fleet": fleet}


def test_tenancy_and_fleet_snapshots_match_the_reference():
    out = both(_tenancy)
    assert out["tenancy"]["usage_chips"] == {"a": 16.0}
    assert out["tenancy"]["queued"] == {
        "b": {"depth": 1, "oldest_since": 12.5}}
    assert out["fleet"]["totals"]["pending"] == 4


# -- whole stacks: both build_managers ------------------------------------------

HOSTS = {1: (("v5e", "2x4"), 8), 2: (("v4", "2x2x2"), 16)}
SURFACES = ("criticalpath", "tenants", "alerts", "timeline", "fleet",
            "verdicts", "explain")


def _stack(port: bool, hosts: int):
    clock = (FakeClock if port else RefFakeClock)(T0)
    (acc, topo), gpus = HOSTS[hosts]
    env = {"ENABLE_SLICE_SCHEDULER": "true"}
    (port_tracing if port else ref_tracing).set_clock(clock)
    try:
        if port:
            mgr, api, cluster, metrics = port_main.build_manager(
                CoreConfig.from_env(env), clock=clock, odh_cfg=OdhConfig())
            api.create(kube.KubeObject.from_dict(port_types.Notebook.new(
                "nb", "user1",
                gpu=port_types.GPUSpec("h100-80gb", gpus)).obj))
        else:
            manager = ref_main.Manager
            ref_main.Manager = lambda a: manager(a, clock=clock)
            try:
                mgr, api, cluster, metrics = ref_main.build_manager(
                    RefConfig.from_env(env), RefOdhConfig())
            finally:
                ref_main.Manager = manager
            api.create(ref_types.Notebook.new(
                "nb", "user1", tpu=ref_types.TPUSpec(acc, topo)).obj)

        def tick(n):
            for _ in range(n):
                mgr.run_until_idle()
                clock.advance(10)
                metrics.scrape()

        tick(20)
        cluster.fail_pod("user1", "nb-0")
        tick(10)
        live = api.get("Notebook", "user1", "nb")
        live.metadata.annotations[
            (port_constants if port else ref_constants).STOP_ANNOTATION] = \
            "2026-01-01T00:00:00Z"
        api.update(live)
        tick(5)
        out = {"criticalpath": mgr.lifecycle.snapshot(),
               "tenants": mgr.metering.snapshot(),
               "alerts": mgr.diagnosis.annotate_alerts(
                   mgr.slo_engine.snapshot()),
               "timeline": mgr.tsdb.dump(),
               "fleet": metrics.fleet_snapshot(),
               "verdicts": mgr.slo_engine.verdicts(),
               "explain": mgr.diagnosis.explain("user1", "nb")}
        mgr.stop()
        return out
    finally:
        (port_tracing if port else ref_tracing).set_clock(None)


def _scale(v, ratio):
    """Every number in `v` times `ratio` (strings and flags kept)."""
    if isinstance(v, dict):
        return {k: _scale(x, ratio) for k, x in v.items()}
    if isinstance(v, list):
        return [_scale(x, ratio) for x in v]
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return v * ratio
    return v


def _device_neutral(out: dict, port: bool, hosts: int) -> str:
    """`out` in the port's device words: the shape token read as one,
    and for the reference "slice" in Event messages read as "gang", and
    chip counts scaled to the gang's GPUs."""
    (acc, topo), gpus = HOSTS[hosts]
    if port:
        return canon(out).replace(f"h100-80gb-{gpus}", "<shape>")
    text = canon(out).replace(f"{acc}-{topo}", "<shape>")
    text = text.replace("restarting slice", "restarting gang")
    text = text.replace("Slice capacity returned", "Gang capacity returned")
    data = json.loads(text)
    ratio = gpus // 8
    for snap in (data.get("tenants"), (data.get("fleet") or {}).get(
            "tenants")):
        if snap:
            for row in snap["tenants"].values():
                for key in ("chip_seconds", "chip_seconds_total"):
                    row[key] = _scale(row[key], ratio)
            snap["top"]["chip_seconds"] = _scale(snap["top"]["chip_seconds"],
                                                 ratio)
    tenancy = (data.get("fleet") or {}).get("tenancy")
    if tenancy:
        tenancy["usage_chips"] = _scale(tenancy["usage_chips"], ratio)
    for name, series in ((data.get("timeline") or {}).get("series")
                         or {}).items():
        if name.startswith("tenant_chip_seconds."):
            series.update(_scale(series, ratio))
            for bucket in series["10s"] + series["60s"]:
                bucket["t"] /= ratio
                bucket["count"] //= ratio
            for point in series["raw"]:
                point[0] /= ratio
    return json.dumps(data, sort_keys=True)


@functools.lru_cache(maxsize=None)
def _stacks(hosts: int):
    return _stack(False, hosts), _stack(True, hosts)


@pytest.mark.parametrize("surface", SURFACES)
@pytest.mark.parametrize("hosts", sorted(HOSTS))
def test_whole_stack_surfaces_match_the_reference(hosts, surface):
    ref, ours = _stacks(hosts)
    assert _device_neutral({surface: ours[surface]}, True, hosts) == \
        _device_neutral({surface: ref[surface]}, False, hosts)
    if surface == "criticalpath":
        assert ours[surface]["conservation"]["violations"] == 0
        assert ours[surface]["conservation"]["finalized"] >= 1
    elif surface == "tenants":
        row = ours[surface]["tenants"]["user1"]
        assert row["chip_seconds"]["ready"] > 0
        assert ours[surface]["conservation"]["violations"] == 0
    elif surface == "verdicts":
        assert set(ours[surface]) == {
            o.name for o in port_main.default_objectives(
                CoreConfig(enable_slice_scheduler=True))}
