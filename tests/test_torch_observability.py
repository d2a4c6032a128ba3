"""The port's TSDB, JSON logging, profiler, data-plane rollup, SLO engine
and /debug HTTP surface against the reference's.

Each scenario of tests/test_{tsdb,slo,telemetry,observability}.py that
these modules answer is written once, as a function of one package's
modules, and run on both packages, each on its own FakeClock from the
same epoch.  The modules are plain Python over injected floats, so the
outputs must be equal exactly (trace ids, random on each side, read as
one token).  The data-plane rollup's MFU is the exception: each stack's
agent computes it against its own device's peak, so it is held to that
stack's own agent summary, while tokens/s and step times are equal.

The HTTP surface: the port's `main.build_manager` and `serve_http` on
a FakeClock, a `spec.gpu` gang through the slice scheduler, every
/debug path fetched on loopback and held to the same path of the
reference's stack on the `spec.tpu` slice of the same host count;
`/state` behind `expose_state`.  Only the reference's control plane is
imported, and no process is launched."""

from __future__ import annotations

import io
import json
import logging as pylog
import random
import sys
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest

import kubeflow_tpu.core.telemetry as ref_core_telemetry
import kubeflow_tpu.main as ref_main
import kubeflow_tpu.runtime.telemetry as ref_rt_telemetry
import kubeflow_tpu.utils.logging as ref_logging
import kubeflow_tpu.utils.profiler as ref_profiler
import kubeflow_tpu.utils.slo as ref_slo
import kubeflow_tpu.utils.tracing as ref_tracing
import kubeflow_tpu.utils.tsdb as ref_tsdb
from kubeflow_tpu import kube as ref_kube
from kubeflow_tpu.api import types as ref_types
from kubeflow_tpu.models.configs import TINY as REF_TINY
from kubeflow_tpu.utils.clock import FakeClock as RefFakeClock
from kubeflow_tpu.utils.config import CoreConfig as RefConfig
from kubeflow_tpu.utils.config import OdhConfig as RefOdhConfig
from kubeflow_tpu.utils.metrics import Registry as RefRegistry
from kubeflow_tpu_torch import kube
from kubeflow_tpu_torch import main as port_main
from kubeflow_tpu_torch.api import types as port_types
from kubeflow_tpu_torch.core import telemetry as port_core_telemetry
from kubeflow_tpu_torch.models.configs import TINY
from kubeflow_tpu_torch.runtime import telemetry as port_rt_telemetry
from kubeflow_tpu_torch.utils import logging as port_logging
from kubeflow_tpu_torch.utils import profiler as port_profiler
from kubeflow_tpu_torch.utils import slo as port_slo
from kubeflow_tpu_torch.utils import tracing as port_tracing
from kubeflow_tpu_torch.utils import tsdb as port_tsdb
from kubeflow_tpu_torch.utils.clock import FakeClock
from kubeflow_tpu_torch.utils.config import CoreConfig, OdhConfig
from kubeflow_tpu_torch.utils.metrics import Registry

from test_torch_ledgers import T0, canon

H100 = "NVIDIA H100 80GB HBM3"

REF = SimpleNamespace(
    port=False, kube=ref_kube, tracing=ref_tracing, tsdb=ref_tsdb,
    slo=ref_slo, profiler=ref_profiler, logging=ref_logging,
    telemetry=ref_core_telemetry, agent=ref_rt_telemetry,
    Clock=RefFakeClock, Registry=RefRegistry, Config=RefConfig)
PORT = SimpleNamespace(
    port=True, kube=kube, tracing=port_tracing, tsdb=port_tsdb,
    slo=port_slo, profiler=port_profiler, logging=port_logging,
    telemetry=port_core_telemetry, agent=port_rt_telemetry,
    Clock=FakeClock, Registry=Registry, Config=CoreConfig)


def both(scenario, *args):
    """`scenario(side, clock, *args)` on each package; equal outputs."""
    out = []
    for side in (REF, PORT):
        clock = side.Clock(T0)
        side.tracing.set_clock(clock)
        try:
            out.append(scenario(side, clock, *args))
        finally:
            side.tracing.set_clock(None)
    assert canon(out[1]) == canon(out[0])
    return out[1]


# -- TSDB ----------------------------------------------------------------------


def _tsdb_folding(side, clock):
    store = side.tsdb.TimeSeriesStore()
    for i in range(5):
        store.sample(float(i), {"q": float(i * 10)})
    store.sample(3.0, {"f": 1.0})
    store.sample(9.9, {"f": 2.0})
    store.sample(10.0, {"f": 3.0})
    for v in (4.0, 1.0, 7.0):
        store.sample(12.0, {"agg": v})
    store.sample(0.0, {"a": 1.0, "b": 100.0})
    store.sample(5.0, {"a": 3.0})
    return {"names": store.series_names(),
            "queries": {n: {t: store.query(n, tier=t)
                            for t in side.tsdb.TIERS}
                        for n in store.series_names()},
            "dump": store.dump(), "snapshot": store.snapshot()}


def _tsdb_bounds(side, clock):
    raw = side.tsdb.TimeSeriesStore(raw_capacity=4)
    for i in range(10):
        raw.sample(float(i), {"q": float(i)})
    tiers = side.tsdb.TimeSeriesStore(tier10_capacity=3)
    for i in range(6):
        tiers.sample(i * 10.0, {"q": 1.0})
    cap = side.tsdb.TimeSeriesStore(max_series=2)
    cap.sample(0.0, {"a": 1.0, "b": 2.0, "c": 3.0, "d": 4.0})
    cap.sample(1.0, {"a": 5.0, "c": 6.0})
    bad = side.tsdb.TimeSeriesStore()
    bad.sample(0.0, {"q": float("nan"), "r": float("inf"),
                     "s": float("-inf"), "t": "not-a-number", "u": None,
                     "ok": "2.5"})
    errors = [bad.query("nope"), bad.query("ok", tier="5s")]
    dumps = [s.dump() for s in (raw, tiers, cap, bad)]
    bad.clear()
    return {"dumps": dumps, "errors": errors, "cleared": bad.snapshot()}


@pytest.mark.parametrize("scenario", [_tsdb_folding, _tsdb_bounds],
                         ids=["folding", "bounds"])
def test_tsdb_matches_the_reference(scenario):
    out = both(scenario)
    if scenario is _tsdb_folding:
        assert [b["t"] for b in out["queries"]["f"]["10s"]["points"]] == [
            0.0, 10.0]
        (agg,) = out["queries"]["agg"]["10s"]["points"]
        assert (agg["count"], agg["min"], agg["max"], agg["mean"]) == (
            3, 1.0, 7.0, 4.0)
    else:
        raw, tiers, cap, bad = out["dumps"]
        assert raw["series"]["q"]["raw"] == [[6.0, 6.0], [7.0, 7.0],
                                             [8.0, 8.0], [9.0, 9.0]]
        assert [b["t"] for b in tiers["series"]["q"]["10s"]] == [
            30.0, 40.0, 50.0]
        assert cap["dropped_series_total"] == 3
        assert list(bad["series"]) == ["ok"]
        assert all(e["error"] for e in out["errors"])


# -- structured JSON logs ------------------------------------------------------


def _json_logs(side, clock):
    fmt = side.logging.JsonFormatter()
    rec = pylog.LogRecord("pkg.core", pylog.INFO, __file__, 1,
                          "culling notebook %s/%s", ("ns", "nb"), None)
    with side.tracing.get_tracer("t").start_span("reconcile") as span:
        inside = json.loads(fmt.format(rec))
    assert (inside.pop("trace_id"), inside.pop("span_id")) == (
        span.trace_id, span.span_id)
    outside = json.loads(fmt.format(pylog.LogRecord(
        "x", pylog.WARNING, __file__, 1, "m", (), None)))
    try:
        raise ValueError("nope")
    except ValueError:
        err = pylog.LogRecord("x", pylog.ERROR, __file__, 1, "failed", (),
                              sys.exc_info())
    err.namespace = "user1"
    extra = json.loads(fmt.format(err))
    extra["exc"] = extra["exc"].splitlines()[-1]
    stream = io.StringIO()
    root = pylog.getLogger()
    saved, level = list(root.handlers), root.level
    try:
        side.logging.setup_structured_logging(pylog.INFO, stream=stream)
        pylog.getLogger("pkg.test").info("hello %d", 7,
                                         extra={"controller": "nb"})
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
        for h in saved:
            root.addHandler(h)
        root.setLevel(level)
    lines = [json.loads(ln) for ln in stream.getvalue().splitlines()]
    for d in [inside, outside, extra] + lines:
        d.pop("ts")
    return {"inside": inside, "outside": outside, "extra": extra,
            "lines": lines}


def test_json_logs_match_the_reference():
    out = both(_json_logs)
    assert out["inside"]["msg"] == "culling notebook ns/nb"
    assert "trace_id" not in out["outside"]
    assert out["extra"]["exc"] == "ValueError: nope"
    assert out["lines"][0]["controller"] == "nb"


# -- continuous profiler -------------------------------------------------------


def _profiler_store(side, clock):
    prof = side.profiler.ContinuousProfiler(registry=side.Registry(),
                                            max_stacks=3)
    for i in range(5):
        prof._record("notebook", "apply", "a.py:f;b.py:g")
        prof._record("c", "p", f"stack-{i}")
    prof._record("-", "-", "main.py:loop")
    snap = prof.snapshot()
    snap.pop("overhead_ratio", None)
    root = SimpleNamespace(attributes={"controller": "notebook"})
    child = SimpleNamespace(attributes={"phase": "render"})
    inner = SimpleNamespace(attributes={"phase": "auth"})
    attrs = [side.profiler.attribute(s) for s in (
        (root, child), (root,), (), (root, child, inner))]
    return {"snapshot": snap, "collapsed": prof.collapsed(),
            "attribute": attrs}


def test_profiler_store_matches_the_reference():
    out = both(_profiler_store)
    assert out["snapshot"]["distinct_stacks"] == 3
    assert out["attribute"][0] == ("notebook", "render")


def test_profiler_samples_the_live_span_stack():
    """`sample_once` attributes a spanned thread to its (controller,
    phase), through the port's live span stacks, and the sampler thread
    measures its own overhead."""
    reg = Registry()
    prof = port_profiler.ContinuousProfiler(registry=reg)
    tracer = port_tracing.get_tracer("test")
    ready, done = threading.Event(), threading.Event()

    def worker():
        with tracer.start_span("reconcile", {"controller": "notebook"}):
            with tracer.start_span("render", {"phase": "render"}):
                ready.set()
                done.wait(5.0)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    assert ready.wait(5.0)
    try:
        assert prof.sample_once() >= 1
    finally:
        done.set()
        t.join(timeout=5.0)
    assert any(s["controller"] == "notebook" and s["phase"] == "render"
               and "test_torch_observability.py:worker" in s["stack"]
               for s in prof.snapshot()["stacks"])
    assert reg.get("notebook_profiler_samples_total").value() >= 1
    timed = port_profiler.ContinuousProfiler(registry=reg,
                                             interval_s=0.002)
    assert timed.overhead_ratio() == 0.0
    timed.start()
    pause = threading.Event()
    try:
        for _ in range(200):
            if timed.passes >= 5:
                break
            pause.wait(0.01)
    finally:
        timed.stop()
    assert timed.passes >= 5 and 0.0 < timed.overhead_ratio() < 0.5


# -- data-plane rollup ---------------------------------------------------------


def test_annotation_literal_stays_in_step():
    """core/telemetry.py keeps its own copy of the annotation name and
    the summary version; they must stay the runtime agent's."""
    assert port_core_telemetry.TELEMETRY_ANNOTATION == \
        port_rt_telemetry.TELEMETRY_ANNOTATION
    assert port_core_telemetry.SUMMARY_VERSION == \
        port_rt_telemetry.SUMMARY_VERSION
    assert port_core_telemetry.TELEMETRY_ANNOTATION == \
        ref_core_telemetry.TELEMETRY_ANNOTATION


def _summary(worker, step_time_s, mfu=0.3):
    return {"v": 1, "worker": worker, "mode": "train", "steps": 5,
            "step_time_s": step_time_s, "tokens_per_s": 1000.0 / step_time_s,
            "mfu": mfu, "hbm_bytes": 1 << 30, "t": 0.0}


def _pod(side, api, ns, nb, name, summary=None, raw=None):
    ann = {}
    if raw is not None or summary is not None:
        ann[side.telemetry.TELEMETRY_ANNOTATION] = raw if raw is not None \
            else json.dumps(summary, sort_keys=True)
    return api.create(side.kube.KubeObject.from_dict({
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": name, "namespace": ns,
                     "labels": {"notebook-name": nb}, "annotations": ann},
        "status": {"phase": "Running"}}))


def _set(side, api, ns, name, summary):
    live = api.get("Pod", ns, name)
    live.metadata.annotations[side.telemetry.TELEMETRY_ANNOTATION] = \
        json.dumps(summary, sort_keys=True)
    api.update(live)


def _rollup(side, clock):
    """Sum, mean and max over seeded workers, cache-fed against the pod
    list; malformed annotations left out; a watch-fed update replacing a
    worker's contribution."""
    api = side.kube.ApiServer()
    rng = random.Random(11)
    for i in range(5):
        for w in range(rng.randint(1, 6)):
            _pod(side, api, f"ns{i % 2}", f"nb-{i}", f"nb-{i}-{w}",
                 _summary(f"nb-{i}-{w}", rng.uniform(0.1, 2.0),
                          mfu=rng.uniform(0.1, 0.5)))
    _pod(side, api, "ns0", "nb-0", "nb-0-noann")
    _pod(side, api, "ns0", "nb-1", "nb-1-bad", raw="{not json")
    _pod(side, api, "ns0", "nb-1", "nb-1-oldv",
         raw=json.dumps({"v": 0, "step_time_s": 1.0}))
    agg = side.telemetry.WorkerTelemetryAggregator
    cached = agg(api, side.Registry(), clock,
                 cache=side.kube.InformerCache(api))
    brute = agg(api, side.Registry(), clock)
    a, b = cached.evaluate(), brute.evaluate()
    assert a == b
    _set(side, api, "ns0", "nb-0-0", _summary("nb-0-0", 0.25))
    return {"first": a, "updated": cached.evaluate(),
            "parsed": [side.telemetry.parse_pod_telemetry(p)
                       for p in api.list("Pod")]}


def _straggler(side, clock):
    """One worker 4x behind its gang's median fires the gauge, one
    Warning event and a `dataplane.straggler` span; continued breach
    dedups; rejoining clears with a Normal event; a single worker never
    straggles; vanished workers read 0; the verdict counters move."""
    api = side.kube.ApiServer()
    exporter = side.tracing.InMemorySpanExporter()
    side.tracing.set_exporter(exporter)
    api.create(side.kube.KubeObject.from_dict({
        "apiVersion": "kubeflow.org/v1", "kind": "Notebook",
        "metadata": {"name": "nb", "namespace": "u1"}, "spec": {}}))
    for w in range(4):
        _pod(side, api, "u1", "nb", f"nb-0-{w}", _summary(f"nb-0-{w}", 0.5))
    _pod(side, api, "u1", "solo", "solo-0", _summary("solo-0", 10.0))
    reg = side.Registry()
    agg = side.telemetry.WorkerTelemetryAggregator(
        api, reg, clock, cache=side.kube.InformerCache(api),
        recorder=side.kube.EventRecorder(api, "test-telemetry"),
        straggler_ratio=1.5, mfu_target=0.35)
    steps = [agg.evaluate()]
    _set(side, api, "u1", "nb-0-3", _summary("nb-0-3", 2.0))
    steps += [agg.evaluate(), agg.evaluate()]
    _set(side, api, "u1", "nb-0-3", _summary("nb-0-3", 0.5))
    steps.append(agg.evaluate())
    for w in range(4):
        api.delete("Pod", "u1", f"nb-0-{w}")
    steps.append(agg.evaluate())
    side.tracing.set_exporter(None)
    events = sorted((e.body["reason"], e.body["type"], e.body["count"],
                     e.body["message"]) for e in api.list("Event"))
    spans = [(s.name, s.attributes, [(e.name, e.attributes)
                                     for e in s.events])
             for s in exporter.spans if s.name == "dataplane.straggler"]
    samples = sorted(ln for ln in reg.render().splitlines()
                     if not ln.startswith("#"))
    return {"steps": steps, "events": events, "spans": spans,
            "samples": samples, "snapshot": agg.snapshot()}


@pytest.mark.parametrize("scenario", [_rollup, _straggler],
                         ids=["rollup", "straggler"])
def test_dataplane_rollup_matches_the_reference(scenario):
    out = both(scenario)
    if scenario is _straggler:
        fired = out["steps"][1]
        assert [s["worker"] for s in fired["stragglers"]] == ["nb-0-3"]
        assert [e[0] for e in out["events"]] == [
            "DataPlaneStraggler", "DataPlaneStragglerCleared"]
        assert len(out["spans"]) == 1
        assert out["steps"][-1]["notebooks"].keys() == {"u1/solo"}
        assert 'notebook_dataplane_tokens_per_second{namespace="u1",' \
            'name="nb"} 0' in out["samples"]
    else:
        assert sum(p is None for p in out["parsed"]) == 3


def test_stamped_telemetry_holds_each_stacks_mfu_to_its_agent():
    """The fake clusters' stamping runs each package's real agent per
    worker: tokens/s and step times equal, the slow worker flagged on
    both, and each side's MFU its own agent's on its own device."""
    out = {}
    for side in (REF, PORT):
        api = side.kube.ApiServer()
        cluster = side.kube.FakeCluster(api)
        for w in range(3):
            _pod(side, api, "u1", "nb", f"nb-0-{w}")
        kw = dict(step_time_s=0.5, batch=4, seq_len=128, num_chips=1,
                  slow_worker=1, slow_factor=4.0, now=42.0)
        if side.port:
            stamped = cluster.stamp_worker_telemetry(
                "u1", "nb", config=TINY, accelerator=H100, **kw)
            agent = port_rt_telemetry.TelemetryAgent(
                config=TINY, batch=4, seq_len=128, num_chips=1,
                accelerator=H100, time_fn=lambda: 42.0, hbm_fn=lambda: {})
        else:
            stamped = cluster.stamp_worker_telemetry(
                "u1", "nb", config=REF_TINY, accelerator="v5e", **kw)
            agent = ref_rt_telemetry.TelemetryAgent(
                config=REF_TINY, batch=4, seq_len=128, num_chips=1,
                accelerator="v5e", time_fn=lambda: 42.0, hbm_fn=lambda: {})
        agent.record_step(0.5)
        agg = side.telemetry.WorkerTelemetryAggregator(
            api, side.Registry(), side.Clock(T0))
        snap = agg.snapshot()
        assert snap["notebooks"]["u1/nb"]["straggler"] == "nb-0-1"
        assert stamped["nb-0-0"]["mfu"] == agent.summary()["mfu"] > 0
        entry = snap["notebooks"]["u1/nb"]
        assert entry["mfu"] == pytest.approx(
            sum(s["mfu"] for s in stamped.values()) / 3)
        cluster.clear_worker_telemetry("u1", "nb")
        assert agg.snapshot()["notebooks"] == {}
        out[side.port] = {k: (v["tokens_per_s"], v["step_time_s"])
                          for k, v in stamped.items()}, \
            (entry["tokens_per_s"], entry["step_time_s"])
    assert out[True] == out[False]
    # the port's agent knows only GPU_PEAKS' cards
    api = kube.ApiServer()
    _pod(PORT, api, "u1", "nb", "nb-0-0")
    with pytest.raises(KeyError):
        kube.FakeCluster(api).stamp_worker_telemetry(
            "u1", "nb", accelerator="v5e")


# -- SLO engine ----------------------------------------------------------------


def _objectives(side):
    s = side.slo
    return (s.Objective("errors", s.KIND_RATIO,
                        "controller_runtime_reconcile_total",
                        target_ratio=0.99, label="result",
                        bad_values=("error",)),
            s.Objective("lat", s.KIND_LATENCY, "lat_seconds",
                        threshold_s=0.5),
            s.Objective("hit_rate", s.KIND_RATIO,
                        "notebook_warmpool_hits_total", target_ratio=0.6,
                        label="result", bad_values=("miss",),
                        total_values=("hit", "miss")),
            s.Objective("ghost", s.KIND_LATENCY, "no_such_family_seconds",
                        threshold_s=1.0))


def _burn(side, clock):
    """Clean traffic, a burst, the window anchor forgetting it, the
    latency threshold snapped to a bucket, a hit rate whose bypasses are
    neutral, and a family that is not registered."""
    reg = side.Registry()
    total = reg.counter("controller_runtime_reconcile_total", "t",
                        labels=("controller", "result"))
    hist = reg.histogram("lat_seconds", "l", labels=("c",),
                         buckets=(0.1, 1.0, 10.0))
    hits = reg.counter("notebook_warmpool_hits_total", "h",
                       labels=("result",))
    eng = side.slo.SLOEngine(_objectives(side), [reg], clock)
    trail = []
    for _ in range(12):
        total.labels("notebook", "success").inc(100)
        clock.advance(300)
        trail.append(eng.evaluate())
    total.labels("notebook", "success").inc(50)
    total.labels("notebook", "error").inc(50)
    hist.labels("a").observe(0.9)
    hist.labels("a").observe(5.0)
    hist.labels("b").observe(0.05)
    hits.labels("hit").inc(3)
    hits.labels("miss").inc(1)
    hits.labels("bypass").inc(100)
    clock.advance(60)
    trail.append(eng.evaluate())
    for _ in range(24):
        total.labels("notebook", "success").inc(10)
        clock.advance(300)
        trail.append(eng.evaluate())
    return {"trail": trail, "render": reg.render(),
            "verdicts": eng.verdicts(),
            "labels": [side.slo.window_label(w)
                       for w in (300, 3600, 7200, 90)]}


def _alerts(side, clock):
    """Fire, persist (dedup), resolve and fire again; a short blip
    against a calm long window does not page; exemplars latch from the
    attempt stream and from a histogram bucket; bounded history."""
    reg = side.Registry()
    total = reg.counter("controller_runtime_reconcile_total", "t",
                        labels=("controller", "result"))
    hist = reg.histogram("lat_seconds", "l", labels=("c",),
                         buckets=(0.1, 1.0))
    eng = side.slo.SLOEngine(_objectives(side)[:2], [reg], clock,
                             max_alerts=4)
    eng.observe_attempt(SimpleNamespace(
        result="error", error="Boom: x", duration_s=0.1,
        trace_id="deadbeef" * 4))
    hist.labels("a").observe(30.0, exemplar={"trace_id": "feedface" * 4})
    snaps = []

    def burst(errors=50, good=50):
        total.labels("notebook", "success").inc(good)
        total.labels("notebook", "error").inc(errors)
        clock.advance(30)
        eng.evaluate()

    def recover(rounds=3):
        for _ in range(rounds):
            total.labels("notebook", "success").inc(200)
            clock.advance(150)
            eng.evaluate()

    for _ in range(6):
        burst(errors=100, good=0)
        snaps.append(eng.snapshot())
        burst()
        recover()
    blip = side.slo.SLOEngine(_objectives(side)[:1], [reg], clock,
                              burn_threshold=5.0)
    for _ in range(12):
        total.labels("notebook", "success").inc(10_000)
        clock.advance(300)
        blip.evaluate()
    clock.advance(300)
    blip.evaluate()
    total.labels("notebook", "success").inc(90)
    total.labels("notebook", "error").inc(10)
    clock.advance(30)
    return {"snaps": snaps, "final": eng.snapshot(),
            "history": [a.to_dict() for a in eng.alert_history()],
            "blip": blip.evaluate(), "blip_firing": blip.firing(),
            "render": reg.render()}


def _defaults(side, clock):
    out = {}
    for env in ({}, {"ENABLE_SLICE_SCHEDULER": "true"},
                {"SLO_RECONCILE_ERROR_RATE": "0", "SLO_PROMOTION_P99_S": "0",
                 "SLO_TENANT_FAIRNESS": "0"},
                {"SLO_FLEET_MFU": "0.99", "SLO_STRAGGLER_RATE": "0.05",
                 "SLO_PLACEMENT_P99_S": "30", "DATAPLANE_MFU_TARGET": "0.4"}):
        cfg = side.Config.from_env(env)
        out[json.dumps(env)] = [
            (o.name, o.kind, o.metric, o.target_ratio, o.threshold_s,
             o.label, o.bad_values, o.total_values)
            for o in side.slo.default_objectives(cfg)]
    return out


def test_an_engine_that_raises_is_counted_and_the_rest_still_fed():
    """An engine that raises on the attempt stream or the dispatch feed is
    logged and counted under its name in `Manager.observer_errors` (a
    caller that must not lose an observation fails on it), the reconcile
    goes on, and the engines after it are still fed every attempt."""
    class Broken:
        def observe_attempt(self, *args):
            raise RuntimeError("engine fault")

        def observe_dispatch(self, *args):
            raise RuntimeError("engine fault")

    class Fed:
        def __init__(self):
            self.attempts, self.dispatches = [], 0

        def observe_attempt(self, rec, *rest):
            self.attempts.append(rec.trace_id)

        def observe_dispatch(self, *args):
            self.dispatches += 1

    class Noop:
        def reconcile(self, req):
            return kube.Result()

    mgr = kube.Manager(kube.ApiServer(), clock=FakeClock(T0))
    mgr.register("noop", Noop(), for_kind="ConfigMap")
    mgr.slo_engine, mgr.metering = Broken(), Broken()
    mgr.lifecycle, mgr.diagnosis = Fed(), Fed()
    for name in ("a", "b"):
        mgr.api.create(kube.KubeObject(
            api_version="v1", kind="ConfigMap",
            metadata=kube.ObjectMeta(name=name, namespace="ns"),
            body={"data": {}}))
    assert mgr.run_until_idle() == 2
    assert mgr.observer_errors == {"slo": 2, "metering": 4}
    assert len(mgr.lifecycle.attempts) == 2
    assert mgr.diagnosis.attempts == mgr.lifecycle.attempts
    mgr.metering = Fed()
    mgr.api.create(kube.KubeObject(
        api_version="v1", kind="ConfigMap",
        metadata=kube.ObjectMeta(name="c", namespace="ns"),
        body={"data": {}}))
    mgr.run_until_idle()
    assert mgr.metering.dispatches == 1 and \
        len(mgr.metering.attempts) == 1
    assert mgr.observer_errors == {"slo": 3, "metering": 4}


@pytest.mark.parametrize("scenario", [_burn, _alerts, _defaults],
                         ids=["burn", "alerts", "defaults"])
def test_slo_engine_matches_the_reference(scenario):
    out = both(scenario)
    if scenario is _burn:
        burst = out["trail"][12]
        assert burst["errors"]["burn_rates"]["5m"] == pytest.approx(25.0)
        assert burst["lat"]["burn_rates"]["5m"] == pytest.approx(
            (1 / 3) / 0.01)
        assert burst["hit_rate"]["burn_rates"]["5m"] == pytest.approx(
            0.25 / 0.4)
        assert out["trail"][-1]["errors"]["burn_rates"] == {"5m": 0.0,
                                                            "1h": 0.0}
        assert out["labels"] == ["5m", "1h", "2h", "90s"]
    elif scenario is _alerts:
        first = out["snaps"][0]["firing"]
        assert {a["objective"]: a["trace_id"] for a in first} == {
            "errors": "deadbeef" * 4, "lat": "feedface" * 4}
        assert len(out["history"]) == 4
        seqs = [a["seq"] for a in out["history"]]
        assert seqs == sorted(seqs)
        assert out["blip"]["errors"]["burn_rates"]["5m"] >= 5.0
        assert out["blip_firing"] == []
    else:
        names = {k: [o[0] for o in v] for k, v in out.items()}
        assert names["{}"] == ["time_to_ready", "event_to_reconcile",
                               "reconcile_errors", "recovery_duration",
                               "promotion_duration", "tenant_fairness"]
        assert "warmpool_hit_rate" in names[
            '{"ENABLE_SLICE_SCHEDULER": "true"}']


# -- the /debug HTTP surface ---------------------------------------------------

DEBUG_PATHS = ("/debug/reconciles", "/debug/workqueue", "/debug/alerts",
               "/debug/explain?object=user1/nb", "/debug/explain?object=x",
               "/debug/changepoints", "/debug/profile",
               "/debug/profile?format=collapsed", "/debug/fleet",
               "/debug/criticalpath", "/debug/timeline",
               "/debug/timeline?series=ready_p99_s&tier=10s",
               "/debug/timeline?dump=1", "/debug/tenants")


def _serve(port: bool, expose_state: bool):
    """One stack, cold-provisioned gang (port) or slice (reference) on a
    FakeClock (its tracing clock too, until the caller resets it),
    scraped a few times, behind its `serve_http`."""
    clock = (FakeClock if port else RefFakeClock)(T0)
    (port_tracing if port else ref_tracing).set_clock(clock)
    env = {"ENABLE_SLICE_SCHEDULER": "true"}
    if port:
        mgr, api, cluster, metrics = port_main.build_manager(
            CoreConfig.from_env(env), clock=clock, odh_cfg=OdhConfig())
        api.create(kube.KubeObject.from_dict(port_types.Notebook.new(
            "nb", "user1", gpu=port_types.GPUSpec("h100-80gb", 8)).obj))
        server = port_main.serve_http(0, mgr, metrics,
                                      expose_state=expose_state)
    else:
        manager = ref_main.Manager
        ref_main.Manager = lambda a: manager(a, clock=clock)
        try:
            mgr, api, cluster, metrics = ref_main.build_manager(
                RefConfig.from_env(env), RefOdhConfig())
        finally:
            ref_main.Manager = manager
        api.create(ref_types.Notebook.new(
            "nb", "user1", tpu=ref_types.TPUSpec("v5e", "2x4")).obj)
        server = ref_main.serve_http(0, mgr, metrics,
                                     expose_state=expose_state)
    for _ in range(15):
        mgr.run_until_idle()
        clock.advance(10)
        metrics.scrape()
    return mgr, server


def _get(server, path):
    url = f"http://127.0.0.1:{server.server_address[1]}{path}"
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


_VOLATILE = ("duration_s", "start_time", "end_time", "longest_running_s",
             "now", "generated_at", "age_s", "ts", "started_at")


def _stable(body: str):
    """A /debug body with wall-clock fields (reconcile durations, the
    workqueue's timers) dropped and the gang's device words read as the
    slice's."""
    try:
        data = json.loads(body)
    except ValueError:
        return body
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()
                    if k not in _VOLATILE}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return canon(walk(data)).replace("h100-80gb-8", "v5e-2x4").replace(
        "restarting gang", "restarting slice")


def test_debug_surface_serves_the_references_bodies_on_loopback():
    sides = {}
    for port in (False, True):
        mgr, server = _serve(port, expose_state=port)
        try:
            sides[port] = {p: _get(server, p) for p in DEBUG_PATHS + (
                "/state", "/debug/traces/" + "0" * 32, "/debug/nope")}
            if port:
                trace = mgr.flight_recorder.snapshot()["attempts"][-1][
                    "trace_id"]
                code, body = _get(server, f"/debug/traces/{trace}")
                assert code == 200 and json.loads(body)["trace_id"] == trace
        finally:
            server.shutdown()
            server.server_close()
            mgr.stop()
            (port_tracing if port else ref_tracing).set_clock(None)
    ours, ref = sides[True], sides[False]
    for path in DEBUG_PATHS:
        assert ours[path][0] == 200, path
        if path in ("/debug/reconciles", "/debug/workqueue"):
            continue  # wall-clock attempt timings, each side its own
        assert _stable(ours[path][1]) == _stable(ref[path][1]), path
    assert json.loads(ours["/debug/criticalpath"][1])["conservation"][
        "violations"] == 0
    assert json.loads(ours["/debug/tenants"][1])["tenancy"]["usage_chips"] \
        == {"user1": 8.0}
    assert ours["/debug/nope"][0] == 404
    assert ours["/debug/traces/" + "0" * 32][0] == 404
    # /state only behind expose_state
    assert ours["/state"][0] == 200 and ref["/state"][0] == 404
    assert "Notebook" in json.loads(ours["/state"][1])


def test_debug_surface_answers_loopback_peers_only():
    handler = port_main.HealthAndMetricsHandler
    for host, ok in (("127.0.0.1", True), ("::1", True),
                     ("::ffff:127.0.0.1", True), ("10.0.0.7", False)):
        assert handler._loopback_only(
            SimpleNamespace(client_address=(host, 1))) is ok
