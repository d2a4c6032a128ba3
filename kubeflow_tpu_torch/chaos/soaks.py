"""The seeded chaos soaks and fault drills of the GPU workbench stack.

Each test method of the reference's tests/test_chaos.py is one function
here, `(stack, seed, rounds, workers) -> record`.  The function follows
the method's body round by round, with its seed offsets and its default
rounds, and raises `SoakFailure` where the method asserts, naming the
line of tests/test_chaos.py that holds the assertion.  It returns what
those assertions read, per round, plus a `counts` summary that
`python -m kubeflow_tpu_torch.chaos` prints.

`stack` is a namespace of one package's control plane: the `kube`
package, the configs, the setup functions, the metrics, the ledgers, the
engines, `FakeClock` (called for every clock a soak makes), the knowledge
model and the fleet budget, and the device hooks:

- `gang_notebook(name, ns, hosts, gangs=1, **spec)`: the CR of a
  notebook of `gangs` gangs of `hosts` hosts each (a CPU notebook for
  hosts 0), as a KubeObject to create;
- `add_gang_nodes(cluster, hosts, pool=None)`: `hosts` accelerator hosts
  in one node pool;
- `gang_demand(hosts, gangs)`: the (shape, units) a beneficiary of that
  size asks the preemption engine for;
- `view(obj)`: the typed Notebook view of a stored CR.

`port_stack()` builds the port's, with `spec.gpu` gangs of 8 GPUs a host.
Every clock is a FakeClock and every fault plan seeded, so with one
worker a soak's record depends on its seed and rounds alone.  With
several workers (WORKQUEUE_WORKERS, set here for the soak's duration)
the same assertions must hold, and per-key serialization is checked with
the flight recorder's overlap sweep."""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import random
import types
import urllib.error
import urllib.request
from pathlib import Path

SEED = 20260804
CENTRAL_NS = "opendatahub"
HOSTS = 4
# the kinds the workbench controllers traffic in: the fault plans draw
# their per-kind targeting from this pool
FAULT_KINDS = ("Notebook", "StatefulSet", "Pod", "Service", "HTTPRoute",
               "NetworkPolicy", "ConfigMap", "Secret", "ServiceAccount",
               "Event")
# control-plane verbs only: Pod-delete faults would make the byte-exact
# state assertions of the migration and failover soaks racy
CONTROL_KINDS = ("Notebook", "StatefulSet", "Service", "ConfigMap", "Event")
RECOVERY = dict(recovery_backoff_base_s=1.0, recovery_backoff_max_s=30.0,
                recovery_max_attempts=4, recovery_window_s=120.0,
                recovery_pending_deadline_s=60.0)
MIGRATION = dict(RECOVERY, checkpoint_store_uri="mem://session-state",
                 checkpoint_max_age_s=300.0)
# failover pacing: a resumed promotion retries on the base backoff
FAILOVER = dict(MIGRATION, recovery_backoff_base_s=0.25)
# modeled checkpoint reload: a restore-stamped pod stays in
# RestoringCheckpoint this long, under the pending deadline
RESTORE_S = 45.0
BUDGETS = Path(__file__).resolve().parent.parent / "loadtest" / "budgets"


class SoakFailure(AssertionError):
    """A soak's assertion failed; the message names its tests/test_chaos.py
    line and what it read."""


def _require(ok, line: int, *detail) -> None:
    if not ok:
        raise SoakFailure(f"tests/test_chaos.py:{line}: "
                          + " ".join(repr(d) for d in detail))


@contextlib.contextmanager
def environ(name: str, value: str):
    """`name`=`value` in the process's environment for the block, as the
    reference's ci/chaos_soak.sh sets its knobs for its test run."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def soak(fn):
    """Run `fn(stack, seed, rounds, workers)` with `workers` workers in
    every Manager it makes (WORKQUEUE_WORKERS); rounds None keeps the
    soak's own default."""
    @functools.wraps(fn)
    def run(stack, seed: int = SEED, rounds=None, workers: int = 1):
        kw = {} if rounds is None else {"rounds": rounds}
        with environ("WORKQUEUE_WORKERS", str(workers)):
            return fn(stack, seed, **kw)
    return run


# -- shared pieces -----------------------------------------------------------

def _recorder(stack):
    # roomy per-object history: the soaks audit per-key serialization over
    # every recorded attempt
    return stack.FlightRecorder(capacity=16384, per_object=4096)


def _env(stack):
    """The core and ODH controllers over a cluster with room for one
    gang of HOSTS hosts (tests/test_chaos.py:51, the `env` fixture)."""
    api = stack.kube.ApiServer()
    cluster = stack.kube.FakeCluster(api)
    cluster.add_node("cpu-node", allocatable={"cpu": "64", "memory": "256Gi"})
    stack.add_gang_nodes(cluster, HOSTS)
    mgr = stack.kube.Manager(api, clock=stack.FakeClock(),
                             flight_recorder=_recorder(stack))
    stack.setup_core_controllers(mgr, stack.CoreConfig())
    stack.setup_odh_controllers(
        mgr, stack.OdhConfig(controller_namespace=CENTRAL_NS))
    return api, cluster, mgr


def _auth(stack) -> dict:
    return {stack.OC.ANNOTATION_INJECT_AUTH: "true"}


def _no_overlaps(mgr, line: int) -> None:
    """No two recorded attempts of one (controller, object) key ran at
    once: the per-key serialization a worker pool must keep."""
    overlaps = mgr.flight_recorder.overlapping_attempts()
    _require(not overlaps, line, f"{len(overlaps)} overlapping attempt "
             "pairs", [(a.controller, a.object_key) for a, _ in overlaps[:1]])


def _steady_state(stack, api, ns: str, name: str, hosts: int,
                  line: int) -> dict:
    """Every steady-state predicate the knowledge model declares holds
    (tests/test_chaos.py:182); a declared predicate with no check here
    fails."""
    status = api.get("Notebook", ns, name).body.get("status", {})
    out = {}
    for pred in stack.knowledge()["steady_state"]:
        if pred["name"] == "notebook-ready":
            out["readyReplicas"] = status.get("readyReplicas")
            _require(out["readyReplicas"] == hosts, line, pred["name"],
                     status)
        elif pred["name"] == "slice-health":
            out["sliceHealth"] = status.get("sliceHealth")
            _require(out["sliceHealth"] in ("Healthy", "Stopped"), line,
                     pred["name"], status)
        elif pred["name"] == "route-exists":
            routes = api.list(
                "HTTPRoute", namespace=CENTRAL_NS,
                label_selector={stack.OC.NOTEBOOK_NAME_LABEL: name,
                                stack.OC.NOTEBOOK_NAMESPACE_LABEL: ns})
            out["routes"] = sorted(r.name for r in routes)
            _require(len(routes) == 1, line, pred["name"], out["routes"])
        else:
            raise SoakFailure(
                f"tests/test_chaos.py:202: steady-state predicate "
                f"{pred['name']!r} declared in workbenches.yaml but not "
                "checked by the soak")
    return out


def _faults(plan) -> list:
    return [[r.rule, r.action, r.verb, r.kind, r.namespace, r.name, r.seq]
            for r in plan.log]


def _settle_round(api, mgr) -> None:
    """Converge while the round's faults fire, clear them, and let one
    more level-triggered pass restore what the window left behind."""
    with api.fault_exempt():
        mgr.enqueue_all()
    mgr.settle(max_seconds=7200.0)
    api.clear_fault_plan()
    with api.fault_exempt():
        mgr.enqueue_all()
    mgr.settle(max_seconds=7200.0)


def _delete_groups(api, name: str, line: int) -> int:
    """Whole-gang restarts in the audit log: every worker-pod delete
    attempt of `name` belongs to a contiguous group of all HOSTS pods."""
    recs = [r for r in api.audit_log(verb="delete", kind="Pod")
            if r.name.startswith(name + "-")]
    expected = {f"{name}-{i}" for i in range(HOSTS)}
    for i in range(0, len(recs), HOSTS):
        chunk = {r.name for r in recs[i:i + HOSTS]}
        _require(chunk == expected, line, "partial-gang pod deletion "
                 "observed in the audit log", [(r.name, r.ok) for r in recs])
    return len(recs) // HOSTS


def _condition(api, ns: str, name: str, kind: str):
    status = api.get("Notebook", ns, name).body.get("status", {})
    return next((c for c in status.get("conditions", [])
                 if c.get("type") == kind), None)


def _cond_record(cond):
    return None if cond is None else {"status": cond.get("status"),
                                      "reason": cond.get("reason")}


def _restarts(metrics) -> int:
    return int(sum(metrics.slice_restarts.collect().values()))


def _conservation(ledger) -> dict:
    cons = ledger.conservation()
    return {k: cons[k] for k in ("finalized", "checked", "violations")}


def _meter(stack, metering, api, ns: str, name: str) -> None:
    live = api.get("Notebook", ns, name)
    metering.sample({(ns, name): (stack.metrics.metering_bucket(live),
                                  stack.placement_units(live))})


def _metering_gates(metering, first: int) -> dict:
    """Chip-second conservation of every live meter and the tenant's
    attribution (lines `first` .. first + 3 of tests/test_chaos.py)."""
    mcons = metering.conservation()
    _require(mcons["checked"] >= 1, first, mcons)
    _require(mcons["violations"] == 0, first + 1, metering.violations()[:3])
    row = metering.tenant_table()["user1"]
    _require(row["dispatches"] > 0 and row["chip_seconds_total"] > 0,
             first + 3, row)
    return {"checked": mcons["checked"], "violations": mcons["violations"],
            "dispatched": row["dispatches"] > 0,
            "metered": row["chip_seconds_total"] > 0}


def _lifecycle_gates(ledger, first: int) -> dict:
    cons = ledger.conservation()
    _require(cons["finalized"] >= 1, first, cons)
    _require(cons["violations"] == 0, first + 1, ledger.violations()[:3])
    return _conservation(ledger)


# -- TestKnowledgeModel (tests/test_chaos.py:86) -----------------------------

CONTROLLERS = {"notebook-controller", "culling-controller",
               "odh-notebook-controller"}


@soak
def knowledge_names(stack, seed):
    """The model parses and names the three controllers, each on
    Notebook."""
    model = stack.knowledge()
    names = sorted(c["name"] for c in model["controllers"])
    _require(set(names) == CONTROLLERS, 90, names)
    primaries = [c["primary"] for c in model["controllers"]]
    _require(all(p == "Notebook" for p in primaries), 93, primaries)
    return {"controllers": names, "primaries": primaries,
            "counts": {"controllers": len(names)}}


@soak
def knowledge_drift(stack, seed):
    """Drift check: every kind the stack creates for a gang notebook with
    auth is declared in the model."""
    api, _, mgr = _env(stack)
    api.create(stack.gang_notebook("drift", "user1", HOSTS,
                                   annotations=_auth(stack)))
    mgr.run_until_idle()
    created = sorted({
        kind for kind, objs in api.dump().items()
        if kind not in ("Notebook", "Node", "Pod", "Event")
        and any(o["metadata"].get("namespace") in ("user1", CENTRAL_NS, "")
                for o in objs)})
    model = stack.knowledge()
    manages = [m for c in model["controllers"] for m in c["manages"]]
    declared = sorted({m["kind"] for m in manages})
    undeclared = sorted(set(created) - set(declared))
    _require(not undeclared, 121, "created but not in chaos model",
             undeclared)
    return {"created": created, "declared": declared,
            "required": sorted({m["kind"] for m in manages
                                if not m.get("optional")}),
            "counts": {"kinds": len(created)}}


@soak
def knowledge_timeouts(stack, seed):
    """Every steady-state predicate declares a timeout of at most 60 s."""
    timeouts = [s["timeout_seconds"]
                for s in stack.knowledge()["steady_state"]]
    _require(all(t <= 60 for t in timeouts), 125, timeouts)
    return {"timeouts": timeouts, "counts": {"predicates": len(timeouts)}}


# -- TestFaultInjection (tests/test_chaos.py:128) ----------------------------

def _healthy_gang(stack, api, mgr, name: str = "chaos-nb") -> str:
    api.create(stack.gang_notebook(name, "user1", HOSTS))
    mgr.run_until_idle()
    status = api.get("Notebook", "user1", name).body["status"]
    _require(status["sliceHealth"] == "Healthy", 134, status)
    return name


def _health(api, name: str) -> dict:
    status = api.get("Notebook", "user1", name).body["status"]
    return {"sliceHealth": status.get("sliceHealth"),
            "readyReplicas": status.get("readyReplicas")}


@soak
def drill_kill_worker(stack, seed):
    """Delete one worker pod of a healthy gang: it comes back Healthy."""
    api, _, mgr = _env(stack)
    name = _healthy_gang(stack, api, mgr)
    api.delete("Pod", "user1", f"{name}-2")
    mgr.run_until_idle()
    after = _health(api, name)
    _require(after["sliceHealth"] == "Healthy", 143, after)
    _require(after["readyReplicas"] == HOSTS, 144, after)
    return {"after": after, "counts": {"kills": 1}}


@soak
def drill_fail_worker(stack, seed):
    """Self-healing off: a Failed worker degrades the gang, and the
    restart annotation restarts it whole and is consumed."""
    api = stack.kube.ApiServer()
    cluster = stack.kube.FakeCluster(api)
    stack.add_gang_nodes(cluster, HOSTS)
    mgr = stack.kube.Manager(api, clock=stack.FakeClock())
    stack.setup_core_controllers(
        mgr, stack.CoreConfig(enable_self_healing=False))
    name = _healthy_gang(stack, api, mgr)
    cluster.fail_pod("user1", f"{name}-1")
    mgr.run_until_idle()
    failed = _health(api, name)
    _require(failed["sliceHealth"] == "Degraded", 160, failed)
    restart = stack.C.ANNOTATION_NOTEBOOK_RESTART
    live = api.get("Notebook", "user1", name)
    live.metadata.annotations[restart] = "true"
    api.update(live)
    mgr.run_until_idle()
    after = _health(api, name)
    _require(after["sliceHealth"] == "Healthy", 167, after)
    left = restart in api.get("Notebook", "user1", name).metadata.annotations
    _require(not left, 169, "the restart annotation was not consumed")
    return {"failed": failed, "after": after, "annotation_left": left,
            "counts": {"restarts": 1}}


@soak
def drill_delete_route(stack, seed):
    """Delete the central-namespace HTTPRoute: it is recreated."""
    api, _, mgr = _env(stack)
    name = _healthy_gang(stack, api, mgr)
    route = f"nb-user1-{name}"
    api.delete("HTTPRoute", CENTRAL_NS, route)
    mgr.run_until_idle()
    back = api.try_get("HTTPRoute", CENTRAL_NS, route) is not None
    _require(back, 179, route)
    return {"recreated": back, "counts": {"routes": 1}}


# -- TestChaosSoak (tests/test_chaos.py:206) ---------------------------------

def _perturb(stack, rng, api, cluster, name: str) -> str:
    """One random cluster perturbation, exempt from the fault plan (the
    perturbation is the experiment, not the traffic under test)."""
    kind = rng.choice(["kill_pod", "fail_pod", "delete_route", "touch",
                       "none"])
    with api.fault_exempt():
        if kind == "kill_pod":
            api.delete("Pod", "user1", f"{name}-{rng.randrange(HOSTS)}")
        elif kind == "fail_pod":
            cluster.fail_pod("user1", f"{name}-{rng.randrange(HOSTS)}")
        elif kind == "delete_route":
            api.delete("HTTPRoute", CENTRAL_NS, f"nb-user1-{name}")
        elif kind == "touch":
            nb = api.get("Notebook", "user1", name)
            nb.metadata.annotations["chaos/touch"] = str(rng.random())
            api.update(nb)
    if kind == "fail_pod":
        # a Failed pod needs the whole-gang restart to recover
        with api.fault_exempt():
            nb = api.get("Notebook", "user1", name)
            nb.metadata.annotations[stack.C.ANNOTATION_NOTEBOOK_RESTART] = \
                "true"
            api.update(nb)
    return kind


@soak
def chaos_soak(stack, seed, rounds=20):
    """Seeded random fault plans against a gang notebook with auth: after
    each round the declared steady state holds with no retry budget
    exhausted, and the lifecycle and metering ledgers conserve."""
    api, cluster, mgr = _env(stack)
    ledger = stack.lifecycle.LifecycleLedger()
    mgr.lifecycle = ledger
    metering = stack.metering.TenantMeteringLedger(mgr.clock)
    mgr.metering = metering
    stack.tracing.set_clock(mgr.clock)
    try:
        api.create(stack.gang_notebook("soak", "user1", HOSTS,
                                       annotations=_auth(stack)))
        mgr.run_until_idle()
        initial = _steady_state(stack, api, "user1", "soak", HOSTS, 269)
        rng = random.Random(seed)
        total_faults = 0
        out = []
        for round_i in range(rounds):
            plan_seed = rng.randrange(2**31)
            plan = stack.kube.random_fault_plan(
                plan_seed, kinds=FAULT_KINDS, clock=mgr.clock)
            api.install_fault_plan(plan)
            perturbation = _perturb(stack, rng, api, cluster, "soak")
            _settle_round(api, mgr)
            total_faults += len(plan.log)
            _require(not mgr.dropped_errors, 294, round_i, plan_seed,
                     perturbation, "retry budget exhausted",
                     [str(e) for e in mgr.dropped_errors])
            steady = _steady_state(stack, api, "user1", "soak", HOSTS, 298)
            _meter(stack, metering, api, "user1", "soak")
            out.append({"plan_seed": plan_seed,
                        "perturbation": perturbation,
                        "faults": _faults(plan),
                        "dropped": sorted(map(str, mgr.dropped_errors)),
                        "steady": steady})
        _require(total_faults > rounds, 306, total_faults)
        _no_overlaps(mgr, 309)
        lifecycle = _lifecycle_gates(ledger, 314)
        meters = _metering_gates(metering, 320)
    finally:
        stack.tracing.set_clock(None)
    return {"initial": initial, "rounds": out,
            "verbs": sorted(api.verb_counts().items()),
            "lifecycle": lifecycle, "metering": meters,
            "counts": {"rounds": rounds, "faults": total_faults,
                       "kills": sum(r["perturbation"] in ("kill_pod",
                                                           "fail_pod")
                                    for r in out)}}


@soak
def trace_integrity_soak(stack, seed, rounds=12):
    """Soak rounds under a span exporter: every injected fault is a
    `fault.injected` event on exactly the reconcile root span it hit, no
    span is left unfinished and no span is orphaned."""
    api, cluster, mgr = _env(stack)
    exporter = stack.tracing.InMemorySpanExporter()
    stack.tracing.set_exporter(exporter)
    stack.tracing.set_clock(mgr.clock)
    try:
        api.create(stack.gang_notebook("soak", "user1", HOSTS,
                                       annotations=_auth(stack)))
        mgr.run_until_idle()
        rng = random.Random(seed + 1)
        injected = []
        out = []
        while len(injected) < 8 and len(out) < rounds:
            plan_seed = rng.randrange(2**31)
            plan = stack.kube.random_fault_plan(
                plan_seed, kinds=FAULT_KINDS, clock=mgr.clock)
            api.install_fault_plan(plan)
            perturbation = _perturb(stack, rng, api, cluster, "soak")
            _settle_round(api, mgr)
            injected.extend((plan.seed, rec) for rec in plan.log)
            out.append({"plan_seed": plan_seed,
                        "perturbation": perturbation,
                        "faults": _faults(plan)})
        _require(injected, 367, "soak injected no faults to trace")
        spans = exporter.spans
        by_id = {s.span_id: s for s in spans}
        for s in spans:
            _require(s.end_time >= s.start_time > 0, 373, "unfinished span",
                     s.name)
            if s.parent is not None:
                _require(s.parent.span_id in by_id, 376, "orphaned span",
                         s.name)
        fault_events = [(s, e) for s in spans for e in s.events
                        if e.name == "fault.injected"]
        _require(len(fault_events) == len(injected), 383,
                 "fault log and span events disagree", len(injected),
                 len(fault_events))
        owners_out = []
        for plan_seed, rec in injected:
            _require(rec.span_id, 387, "fault fired outside any span",
                     rec.seq)
            owners = [s for s, e in fault_events
                      if e.attributes["fault.plan_seed"] == plan_seed
                      and e.attributes["fault.seq"] == rec.seq]
            _require(len(owners) == 1, 393, rec.seq,
                     [s.name for s in owners])
            span = owners[0]
            _require(span.name == "reconcile", 395, span.name)
            _require(span.span_id == rec.span_id, 396, rec.seq)
            _require(span.trace_id == rec.trace_id, 397, rec.seq)
            _require(span.parent is None, 398, "a fault stamped a child "
                     "span", rec.seq)
            _require("controller" in span.attributes, 399, span.attributes)
            owners_out.append([plan_seed, rec.seq, span.name,
                               span.attributes["controller"]])
        names = {}
        for s in spans:
            names[s.name] = names.get(s.name, 0) + 1
    finally:
        api.clear_fault_plan()
        stack.tracing.set_exporter(None)
        stack.tracing.set_clock(None)
    return {"rounds": out, "owners": owners_out,
            "spans": sorted(names.items()),
            "counts": {"rounds": len(out), "faults": len(injected),
                       "spans": len(spans)}}


@soak
def reproducible_plan(stack, seed):
    """The same plan seed yields the same rules: a printed seed
    reproduces a failing round."""
    def rules(plan):
        return [[list(r.verbs), list(r.kinds), r.error, r.latency_s,
                 r.stale_read, r.drop_watch, r.reset_watch_history,
                 r.probability, r.max_matches, r.after] for r in plan.rules]

    a = rules(stack.kube.random_fault_plan(1234, kinds=FAULT_KINDS))
    b = rules(stack.kube.random_fault_plan(1234, kinds=FAULT_KINDS))
    _require(a == b, 410, a, b)
    return {"rules": a, "counts": {"rules": len(a)}}


# -- TestSliceRecoverySoak (tests/test_chaos.py:420) -------------------------

def _recovery_env(stack):
    api = stack.kube.ApiServer()
    cluster = stack.kube.FakeCluster(api)
    cluster.add_node("cpu-node", allocatable={"cpu": "64", "memory": "256Gi"})
    stack.add_gang_nodes(cluster, HOSTS)
    clock = stack.FakeClock()
    mgr = stack.kube.Manager(api, clock=clock,
                             flight_recorder=_recorder(stack))
    cfg = stack.CoreConfig(**RECOVERY)
    metrics = stack.metrics.NotebookMetrics(api)
    stack.setup_core_controllers(mgr, cfg, metrics)
    return api, cluster, mgr, clock, cfg, metrics


@soak
def recovery_soak(stack, seed, rounds=12):
    """Seeded worker kills and crash loops under API faults, no restart
    annotation anywhere: the recovery engine brings the gang back Healthy
    every round with whole-gang restarts only, across a leader failover
    mid-soak, and both ledgers conserve across the handover."""
    api, cluster, mgr, clock, cfg, metrics = _recovery_env(stack)
    # one ledger of each kind across the failover
    ledger = stack.lifecycle.LifecycleLedger()
    mgr.lifecycle = ledger
    metering = stack.metering.TenantMeteringLedger(clock)
    mgr.metering = metering
    stack.tracing.set_clock(clock)
    try:
        api.create(stack.gang_notebook("healsoak", "user1", HOSTS))
        mgr.run_until_idle()
        rng = random.Random(seed + 13)
        failover_round = rounds // 2
        out = []
        total_faults = 0
        for round_i in range(rounds):
            if round_i == failover_round:
                # a brand-new manager resumes from the CR's bookkeeping;
                # the deposed one is never driven again
                mgr = stack.kube.Manager(api, clock=clock)
                stack.setup_core_controllers(
                    mgr, stack.CoreConfig(**RECOVERY),
                    stack.metrics.NotebookMetrics(api))
                mgr.lifecycle = ledger
                mgr.metering = metering
                with api.fault_exempt():
                    mgr.enqueue_all()
            plan_seed = rng.randrange(2**31)
            plan = stack.kube.random_fault_plan(
                plan_seed, kinds=FAULT_KINDS, clock=mgr.clock)
            api.install_fault_plan(plan)
            kind = rng.choice(["fail_one", "fail_two", "crashloop", "kill",
                               "none"])
            with api.fault_exempt():
                if kind == "fail_one":
                    cluster.fail_pod("user1",
                                     f"healsoak-{rng.randrange(HOSTS)}")
                elif kind == "fail_two":
                    for i in rng.sample(range(HOSTS), 2):
                        cluster.fail_pod("user1", f"healsoak-{i}")
                elif kind == "crashloop":
                    cluster.crashloop_pod(
                        "user1", f"healsoak-{rng.randrange(HOSTS)}")
                elif kind == "kill":
                    api.delete("Pod", "user1",
                               f"healsoak-{rng.randrange(HOSTS)}")
                mgr.enqueue_all()
            mgr.settle(max_seconds=7200.0)
            api.clear_fault_plan()
            with api.fault_exempt():
                mgr.enqueue_all()
            mgr.settle(max_seconds=7200.0)
            total_faults += len(plan.log)
            _require(not mgr.dropped_errors, 558, round_i, plan_seed, kind,
                     [str(e) for e in mgr.dropped_errors])
            status = api.get("Notebook", "user1", "healsoak").body["status"]
            _require(status["sliceHealth"] == "Healthy", 563, round_i, kind)
            _require(status["readyReplicas"] == HOSTS, 564, round_i, status)
            exhausted = _condition(api, "user1", "healsoak",
                                   "RecoveryExhausted")
            _require(exhausted is None, 565, round_i, kind,
                     status.get("sliceRecovery"))
            groups = _delete_groups(api, "healsoak", 567)
            _meter(stack, metering, api, "user1", "healsoak")
            out.append({"plan_seed": plan_seed, "perturbation": kind,
                        "faults": _faults(plan),
                        "sliceHealth": status["sliceHealth"],
                        "readyReplicas": status["readyReplicas"],
                        "sliceRecovery": status.get("sliceRecovery"),
                        "restart_groups": groups})
            # age the sliding window out so each round has a fresh budget
            mgr.advance(RECOVERY["recovery_window_s"])
        groups = _delete_groups(api, "healsoak", 576)
        _require(groups > 0, 577, "soak never exercised a recovery restart")
        _no_overlaps(mgr, 578)
        lifecycle = _lifecycle_gates(ledger, 584)
        meters = _metering_gates(metering, 590)
    finally:
        stack.tracing.set_clock(None)
    return {"rounds": out, "restart_groups": groups, "lifecycle": lifecycle,
            "metering": meters, "verbs": sorted(api.verb_counts().items()),
            "counts": {"rounds": rounds, "faults": total_faults,
                       "kills": sum(r["perturbation"] != "none" for r in out),
                       "restarts": groups, "failovers": 1}}


@soak
def recovery_exhaustion(stack, seed):
    """A permanently failing gang lands on RecoveryExhausted after exactly
    the attempt cap, and a long quiet period adds no restart."""
    api, cluster, mgr, clock, cfg, metrics = _recovery_env(stack)
    api.create(stack.gang_notebook("doomed", "user1", HOSTS))
    mgr.run_until_idle()
    cluster.poison_statefulset("user1", "doomed")
    with api.fault_exempt():
        mgr.enqueue_all()
    mgr.settle(max_seconds=float(
        cfg.recovery_window_s + 10 * cfg.recovery_backoff_max_s))
    groups = _delete_groups(api, "doomed", 605)
    _require(groups == cfg.recovery_max_attempts, 606, groups)
    cond = _condition(api, "user1", "doomed", "RecoveryExhausted")
    _require(cond is not None and cond["status"] == "True", 608, cond)
    mgr.advance(3600)
    quiet = _delete_groups(api, "doomed", 611)
    _require(quiet == cfg.recovery_max_attempts, 611, quiet)
    _require(not mgr.dropped_errors, 613, [str(e) for e in
                                           mgr.dropped_errors])
    return {"restart_groups": groups, "condition": _cond_record(cond),
            "after_quiet": quiet,
            "counts": {"restarts": groups, "exhausted_at": groups}}


# -- TestMigrationRecoverySoak (tests/test_chaos.py:616) ---------------------

def _migration_env(stack):
    api = stack.kube.ApiServer()
    cluster = stack.kube.FakeCluster(api)
    stack.add_gang_nodes(cluster, 2 * HOSTS)
    clock = stack.FakeClock()
    mgr = stack.kube.Manager(api, clock=clock,
                             flight_recorder=_recorder(stack))
    store = stack.sessionstate.InMemorySessionStore(clock=clock)
    cluster.attach_session_store(store)
    cfg = stack.CoreConfig(**MIGRATION)
    metrics = stack.metrics.NotebookMetrics(api)
    stack.setup_core_controllers(mgr, cfg, metrics, session=store)
    return api, cluster, mgr, clock, cfg, metrics, store


def _restored_stamps(stack, api, ns: str = "user1") -> dict:
    C = stack.C
    return {p.name: [p.metadata.annotations.get(
                C.ANNOTATION_RESTORED_GENERATION),
             p.metadata.annotations.get(C.ANNOTATION_RESTORED_DIGEST)]
            for p in api.list("Pod", namespace=ns)}


def _session_entry(entry: dict) -> dict:
    return {k: entry.get(k) for k in ("phase", "restoreGeneration",
                                      "digest", "trigger")}


@soak
def migration_soak(stack, seed, rounds=10):
    """Seeded disruptions with a session checkpoint: fresh rounds migrate
    and restore the exact pre-disruption snapshot, stale rounds (every
    third) restart bare with no restore stamp, each verb accounted apart."""
    api, cluster, mgr, clock, cfg, metrics, store = _migration_env(stack)
    api.create(stack.gang_notebook("migsoak", "user1", HOSTS))
    mgr.run_until_idle()
    rng = random.Random(seed + 29)
    expect_migrated = expect_bare = 0
    out = []
    total_faults = 0
    for round_i in range(rounds):
        payload = b"kernel-%d-%d" % (round_i, rng.randrange(2**32))
        cluster.set_session_payload("user1", "migsoak", payload)
        (snap,) = cluster.snapshot_sessions("user1", "migsoak")
        # a fixed cadence, so any round count runs both verbs
        stale = round_i % 3 == 1
        if stale:
            # past CHECKPOINT_MAX_AGE_S and the shorter budget window
            mgr.advance(cfg.checkpoint_max_age_s + 60)
        plan_seed = rng.randrange(2**31)
        plan = stack.kube.random_fault_plan(plan_seed, kinds=CONTROL_KINDS,
                                            clock=mgr.clock)
        api.install_fault_plan(plan)
        kind = rng.choice(["fail_one", "fail_two", "crashloop"])
        with api.fault_exempt():
            if kind == "fail_one":
                cluster.fail_pod("user1", f"migsoak-{rng.randrange(HOSTS)}")
            elif kind == "fail_two":
                for i in rng.sample(range(HOSTS), 2):
                    cluster.fail_pod("user1", f"migsoak-{i}")
            else:
                cluster.crashloop_pod("user1",
                                      f"migsoak-{rng.randrange(HOSTS)}")
            mgr.enqueue_all()
        mgr.settle(max_seconds=7200.0)
        api.clear_fault_plan()
        with api.fault_exempt():
            mgr.enqueue_all()
        mgr.settle(max_seconds=7200.0)
        total_faults += len(plan.log)
        _require(not mgr.dropped_errors, 737, round_i, kind, plan_seed)
        status = api.get("Notebook", "user1", "migsoak").body["status"]
        _require(status["sliceHealth"] == "Healthy", 740, round_i, kind)
        stamps = _restored_stamps(stack, api)
        entry = None
        if stale:
            expect_bare += 1
            # bare restart: the recreated session started cold
            _require(all(g is None for g, _ in stamps.values()), 745,
                     round_i, stamps)
        else:
            expect_migrated += 1
            # the generation may pass the periodic snapshot when a fault
            # forced a re-flush of the same session, never regress
            entry = status["sessionState"]["0"]
            _require(entry["phase"] == "restored", 756, round_i, entry)
            _require(entry["restoreGeneration"] >= snap.generation, 757,
                     round_i, entry)
            _require(entry["digest"] == snap.digest, 758, round_i, entry)
            for pod_name, (gen, digest) in stamps.items():
                _require(gen == str(entry["restoreGeneration"]), 760,
                         round_i, pod_name, stamps)
                _require(digest == snap.digest, 762, round_i, pod_name)
            entry = _session_entry(entry)
        groups = _delete_groups(api, "migsoak", 763)
        out.append({"plan_seed": plan_seed, "perturbation": kind,
                    "stale": stale, "faults": _faults(plan),
                    "snapshot": [snap.generation, snap.digest],
                    "session": entry, "stamps": stamps,
                    "restart_groups": groups})
        mgr.advance(RECOVERY["recovery_window_s"])
    _require(expect_migrated > 0 and expect_bare > 0, 767,
             "soak must exercise both verbs", expect_migrated, expect_bare)
    migrate = metrics.slice_restarts.value("user1", "migrate")
    _require(migrate >= expect_migrated, 773, migrate, expect_migrated)
    bare_total = sum(metrics.slice_restarts.value("user1", reason)
                     for reason in ("pod-failed", "crash-loop"))
    _require(bare_total == expect_bare, 778, bare_total, expect_bare)
    migrations = {r: metrics.migrations.value("failure", r)
                  for r in ("migrated", "restored", "fallback-restart")}
    _require(migrations["migrated"] >= expect_migrated, 779, migrations)
    _require(migrations["restored"] == expect_migrated, 782, migrations)
    _require(migrations["fallback-restart"] == expect_bare, 784, migrations)
    _no_overlaps(mgr, 786)
    groups = _delete_groups(api, "migsoak", 763)
    return {"rounds": out, "migrate_restarts": migrate,
            "bare_restarts": bare_total, "migrations": migrations,
            "counts": {"rounds": rounds, "faults": total_faults,
                       "kills": rounds, "restarts": groups,
                       "migrations": expect_migrated,
                       "bare_restarts": expect_bare}}


@soak
def migration_failover(stack, seed):
    """The manager dies between the migrate restart and the gang turning
    Healthy: the successor finishes the same migration from
    status.sessionState, with no second restart and no second restore."""
    api, cluster, mgr_a, clock, cfg, metrics_a, store = _migration_env(stack)
    api.create(stack.gang_notebook("failover", "user1", HOSTS))
    mgr_a.run_until_idle()
    cluster.set_session_payload("user1", "failover", b"mid-migration")
    (snap,) = cluster.snapshot_sessions("user1", "failover")
    # freeze the data plane mid-recreate: the migrate verb fires but the
    # new pods never turn Ready under manager A
    cluster.auto_ready = False
    cluster.fail_pod("user1", "failover-1")
    mgr_a.run_until_idle()
    phase = api.get("Notebook", "user1", "failover").body["status"][
        "sessionState"]["0"]["phase"]
    _require(phase == "migrating", 807, phase)
    first = _delete_groups(api, "failover", 808)
    _require(first == 1, 808, first)
    # leader failover: a brand-new manager resumes from the CR alone
    mgr_b = stack.kube.Manager(api, clock=clock)
    metrics_b = stack.metrics.NotebookMetrics(api)
    stack.setup_core_controllers(mgr_b, stack.CoreConfig(**MIGRATION),
                                 metrics_b, session=store)
    with api.fault_exempt():
        mgr_b.enqueue_all()
    mgr_b.run_until_idle()
    resumed = _delete_groups(api, "failover", 821)
    _require(resumed == 1, 821, "the successor restarted the gang again")
    cluster.auto_ready = True
    for i in range(HOSTS):
        cluster.mark_running("user1", f"failover-{i}")
    mgr_b.run_until_idle()
    status = api.get("Notebook", "user1", "failover").body["status"]
    _require(status["sliceHealth"] == "Healthy", 829, status)
    entry = status["sessionState"]["0"]
    _require(entry["phase"] == "restored", 831, entry)
    _require(entry["restoreGeneration"] == snap.generation, 832, entry)
    final = _delete_groups(api, "failover", 833)
    _require(final == 1, 833, final)
    stamps = _restored_stamps(stack, api)
    for pod_name, (gen, digest) in stamps.items():
        _require(gen == str(snap.generation), 835, pod_name)
        _require(digest == snap.digest, 836, pod_name)
    restored = metrics_b.migrations.value("failure", "restored")
    _require(restored == 1, 838, restored)
    return {"phase_under_a": phase, "restart_groups": [first, resumed, final],
            "session": _session_entry(entry), "stamps": stamps,
            "snapshot": [snap.generation, snap.digest],
            "restored_on_successor": restored,
            "counts": {"restarts": final, "failovers": 1}}


@soak
def migration_exhaustion(stack, seed):
    """Migrate and bare-restart attempts draw from one budget: a poisoned
    gang migrates first, restarts bare once its checkpoint is stale, and
    lands on RecoveryExhausted at exactly the cap."""
    api, cluster, mgr, clock, cfg, metrics, store = _migration_env(stack)
    api.create(stack.gang_notebook("doomed", "user1", HOSTS))
    mgr.run_until_idle()
    cluster.snapshot_sessions("user1", "doomed")
    cluster.poison_statefulset("user1", "doomed")
    with api.fault_exempt():
        mgr.enqueue_all()
    mgr.settle(max_seconds=float(
        cfg.recovery_window_s + 10 * cfg.recovery_backoff_max_s))
    groups = _delete_groups(api, "doomed", 855)
    _require(groups == cfg.recovery_max_attempts, 855, groups)
    migrated = metrics.slice_restarts.value("user1", "migrate")
    bare = metrics.slice_restarts.value("user1", "pod-failed")
    _require(migrated >= 1, 859, "the fresh checkpoint must migrate first")
    _require(migrated + bare == cfg.recovery_max_attempts, 860, migrated,
             bare)
    cond = _condition(api, "user1", "doomed", "RecoveryExhausted")
    _require(cond is not None and cond["status"] == "True", 865, cond)
    mgr.advance(3600)
    quiet = _delete_groups(api, "doomed", 867)
    _require(quiet == cfg.recovery_max_attempts, 867, quiet)
    _require(not mgr.dropped_errors, 869, [str(e) for e in
                                           mgr.dropped_errors])
    return {"restart_groups": groups, "migrate": migrated, "bare": bare,
            "condition": _cond_record(cond), "after_quiet": quiet,
            "counts": {"restarts": groups, "exhausted_at": groups}}


# -- TestPreemptionSoak (tests/test_chaos.py:872) ----------------------------

class _Killed(RuntimeError):
    """Stands in for the manager process dying mid-protocol."""


class _Span:
    def add_event(self, *a, **k):
        pass

    def set_attribute(self, *a, **k):
        pass


def _preemption_env(stack):
    api = stack.kube.ApiServer()
    cluster = stack.kube.FakeCluster(api)
    # two gangs of capacity; cold provisioning effectively off, so the
    # beneficiary's only road to placement is eviction
    stack.add_gang_nodes(cluster, 2 * HOSTS)
    clock = stack.FakeClock()
    mgr = stack.kube.Manager(api, clock=clock)
    cfg = stack.CoreConfig.from_env({
        "ENABLE_SLICE_SCHEDULER": "true",
        "WARMPOOL_SIZE": "0",
        "WARMPOOL_PROVISION_S": "3600",
    })
    store = stack.sessionstate.InMemorySessionStore(clock=clock)
    cluster.attach_session_store(store)
    metrics = stack.metrics.NotebookMetrics(api)
    stack.setup_core_controllers(mgr, cfg, metrics, session=store,
                                 provisioner=cluster)
    return api, cluster, mgr, clock, cfg, store


@soak
def preemption_soak(stack, seed, rounds=6):
    """Checkpoint-then-preempt under seeded manager kills at every point
    of the write-ahead protocol: the successor resumes the eviction
    exactly once, whole-gang, with the victims' checkpoints intact and
    the beneficiary placed on the freed capacity."""
    C, P = stack.C, stack.preemption
    rng = random.Random(seed + 53)
    victims = [("t-low-a", "v-a"), ("t-low-b", "v-b")]
    out = []
    for round_i in range(rounds):
        api, cluster, mgr_a, clock, cfg, store = _preemption_env(stack)
        snaps = {}
        for ns, name in victims:
            api.create(stack.gang_notebook(name, ns, HOSTS, priority="low"))
            mgr_a.run_until_idle()
            payload = b"%s-%d-%d" % (name.encode(), round_i,
                                     rng.randrange(2**32))
            cluster.set_session_payload(ns, name, payload)
            (snaps[(ns, name)],) = cluster.snapshot_sessions(ns, name)
        shape, needed = stack.gang_demand(HOSTS, 2)
        api.create(stack.gang_notebook("ben", "t-hi", HOSTS, gangs=2,
                                       priority="high"))
        # kill after j completed teardowns (j == len(victims): between the
        # teardowns and the terminal fold), a fixed cadence over rounds
        kill_after = round_i % (len(victims) + 1)
        engine = mgr_a.preemption_engine
        orig_teardown = engine._teardown_victim
        done = {"n": 0}

        def kill_teardown(victim_rec, kill_after=kill_after,
                          orig_teardown=orig_teardown, done=done):
            if done["n"] >= kill_after:
                raise _Killed()
            result = orig_teardown(victim_rec)
            done["n"] += 1
            return result

        def kill_fold(plan, result):
            raise _Killed()

        engine._teardown_victim = kill_teardown
        if kill_after >= len(victims):
            engine._finish_records = kill_fold
        # manager A plans the eviction and dies mid-protocol; the engine
        # is driven directly so the kill cannot leak into A's workqueue
        try:
            engine.maybe_preempt(stack.view(api.get("Notebook", "t-hi",
                                                    "ben")),
                                 shape, needed, _Span())
        except _Killed:
            pass
        else:
            raise SoakFailure("tests/test_chaos.py:988: manager A was not "
                              f"killed (round {round_i})")
        pending = []
        for ns, name in victims:
            pending.append(bool(P.pending_preemption(api, ns, name)))
            _require(pending[-1], 994, round_i, kill_after, ns, name,
                     "the write-ahead record must be down before any kill "
                     "point")
        # the successor resumes from the record alone
        mgr_b = stack.kube.Manager(api, clock=clock)
        metrics_b = stack.metrics.NotebookMetrics(api)
        stack.setup_core_controllers(mgr_b, cfg, metrics_b, session=store,
                                     provisioner=cluster)
        mgr_b.enqueue_all()
        mgr_b.run_until_idle()
        for _ in range(3):
            mgr_b.advance(20.0)
        _require(not mgr_b.dropped_errors, 1008, round_i, kill_after)
        quota = api.get(C.TENANTQUOTA_KIND, "", C.TENANTQUOTA_NAME)
        st = quota.body.get("status") or {}
        _require(not (st.get("preemptions") or {}), 1012, round_i,
                 kill_after, st)
        recents = st.get("recentPreemptions") or []
        per_victim = {}
        for ns, name in victims:
            key = f"{ns}/{name}"
            mine = [r for r in recents if r.get("victim") == key]
            _require(len(mine) == 1 and mine[0]["phase"] ==
                     C.PREEMPTION_DONE, 1018, round_i, kill_after, recents)
            sts = len(_sts_deletes(api, name))
            _require(sts == 1, 1022, round_i, kill_after, name)
            pods = _pod_deletes(api, name)
            _require(pods == [], 1024, round_i, kill_after, name)
            left = api.list("Pod", namespace=ns)
            _require(left == [], 1026, round_i, kill_after, ns)
            vobj = api.get("Notebook", ns, name)
            placed = C.ANNOTATION_PLACEMENT in vobj.metadata.annotations
            _require(not placed, 1029, round_i, kill_after, name)
            # evicted as "preempted"; once the beneficiary places, the
            # ordinary re-admission may restamp the reason, never the
            # victim's own priority
            info = json.loads(vobj.metadata.annotations[C.ANNOTATION_QUEUED])
            _require(info.get("reason") in ("preempted", "quota",
                                            "fair-share", "ordered"),
                     1037, info)
            _require(info.get("priority") == "low", 1039, info)
            sess = ((vobj.body.get("status") or {}).get("sessionState")
                    or {}).get("0", {})
            snap = snaps[(ns, name)]
            _require(sess.get("digest") == snap.digest, 1043, round_i,
                     kill_after, name, sess)
            _require(sess.get("trigger") == "preempt", 1045, sess)
            per_victim[key] = {
                "record": [m["phase"] for m in mine],
                "statefulset_deletes": sts, "pod_deletes": len(pods),
                "pods_left": len(left), "placed": placed,
                "queued": [info.get("reason"), info.get("priority")],
                "session": [sess.get("digest"), sess.get("trigger")]}
        resumed = metrics_b.preemptions.value(P.PREEMPT_RESULT_RESUMED, "low")
        _require(resumed == len(victims), 1049, round_i, kill_after, resumed)
        evicted = metrics_b.preemptions.value(P.PREEMPT_RESULT_EVICTED, "low")
        _require(evicted == 0, 1052, round_i, kill_after, evicted)
        ben = api.get("Notebook", "t-hi", "ben")
        ben_placed = C.ANNOTATION_PLACEMENT in ben.metadata.annotations
        _require(ben_placed, 1055, round_i, kill_after)
        ben_health = ben.body["status"]["sliceHealth"]
        _require(ben_health == "Healthy", 1056, round_i, kill_after,
                 ben_health)
        # a second sweep is a no-op: the resume ran exactly once
        mgr_b.enqueue_all()
        mgr_b.run_until_idle()
        again = metrics_b.preemptions.value(P.PREEMPT_RESULT_RESUMED, "low")
        _require(again == len(victims), 1061, again)
        for _, name in victims:
            _require(len(_sts_deletes(api, name)) == 1, 1064, name)
        _require(not mgr_b.dropped_errors, 1065, round_i, kill_after)
        out.append({"kill_after": kill_after, "pending": pending,
                    "victims": per_victim, "resumed": resumed,
                    "evicted": evicted, "beneficiary": [ben_placed,
                                                        ben_health],
                    "resumed_after_sweep": again})
    return {"rounds": out,
            "counts": {"rounds": rounds, "kills": rounds,
                       "evictions": rounds * len(victims)}}


def _sts_deletes(api, name: str) -> list:
    return [r for r in api.audit_log(verb="delete", kind="StatefulSet")
            if r.name == name and r.ok]


def _pod_deletes(api, name: str) -> list:
    return [r for r in api.audit_log(verb="delete", kind="Pod")
            if r.name.startswith(name + "-")]


# -- TestFailoverSoak (tests/test_chaos.py:1068) -----------------------------

def _p99(hist, ns: str, line: int) -> float:
    """Upper-bound p99 from the exposed cumulative buckets, the arithmetic
    a recording rule runs on the scrape."""
    cum = hist.bucket_counts(ns)
    total = cum[float("inf")]
    _require(total > 0, line, "no observations to estimate p99 from")
    want = math.ceil(0.99 * total)
    return next(bound for bound, c in cum.items() if c >= want)


@soak
def failover_soak(stack, seed, rounds=50):
    """Seeded kills of the current primary gang under control-plane
    partitions, against a replicated notebook: every round promotes the
    warm follower with no state lost and one epoch bump, the demoted
    zombie's write is fenced, and the promotion p99 beats the
    snapshot-restore baseline by 5x and stays under the fleet budget's
    failover ceiling."""
    api = stack.kube.ApiServer()
    cluster = stack.kube.FakeCluster(api)
    # two gangs for the replicated notebook and one for the baseline
    stack.add_gang_nodes(cluster, 3 * HOSTS)
    clock = stack.FakeClock()
    mgr = stack.kube.Manager(api, clock=clock,
                             flight_recorder=_recorder(stack))
    store = stack.sessionstate.InMemorySessionStore(clock=clock)
    cluster.attach_session_store(store)
    # snapshot->restore pays a real reload: restore-stamped pods park in
    # RestoringCheckpoint until release_restores() after RESTORE_S
    cluster.restore_hold = True
    cfg = stack.CoreConfig(**FAILOVER)
    metrics = stack.metrics.NotebookMetrics(api)
    stack.setup_core_controllers(mgr, cfg, metrics, session=store)
    ss = stack.sessionstate

    def replication():
        status = api.get("Notebook", "user1", "fsoak").body.get(
            "status") or {}
        return status.get("replication") or {}

    api.create(stack.gang_notebook(
        "fsoak", "user1", HOSTS, replication=stack.ReplicationSpec(
            replicas=2)))
    # the baseline: same store, same faults, no standby
    api.create(stack.gang_notebook("fbase", "base", HOSTS))
    mgr.run_until_idle()
    rng = random.Random(seed + 41)
    epoch, primary = 1, 0
    kills = 0
    out = []
    for round_i in range(rounds):
        payload = b"kernel-%d-%d" % (round_i, rng.randrange(2**32))
        deltas = [b"+cell-%d-%d" % (round_i, j)
                  for j in range(rng.randrange(1, 4))]
        with api.fault_exempt():
            cluster.set_session_payload("user1", "fsoak", payload)
            cluster.snapshot_sessions("user1", "fsoak")
            for d in deltas:
                cluster.stream_session_delta("user1", "fsoak", d,
                                             writer_epoch=epoch)
            cluster.sync_followers("user1", "fsoak")
            cluster.set_session_payload("base", "fbase", payload)
            cluster.snapshot_sessions("base", "fbase")
            mgr.enqueue_all()
        mgr.settle(max_seconds=7200.0)
        expected_state = payload + b"".join(deltas)
        head = store.chain_head("user1", "fsoak", 0)
        _require(head[2] == ss.payload_digest(expected_state), 1191,
                 round_i, head)
        # the election's evidence: the standby is stamped at the head
        standby = 1 - primary
        fresh = replication()["followers"][str(standby)]["slices"]["0"]
        _require(fresh["digest"] == head[2], 1196, round_i, fresh)
        plan_seed = rng.randrange(2**31)
        plan = stack.kube.random_fault_plan(plan_seed, kinds=CONTROL_KINDS,
                                            clock=mgr.clock)
        api.install_fault_plan(plan)
        primary_sts = "fsoak" if primary == 0 else f"fsoak-r{primary}"
        with api.fault_exempt():
            cluster.fail_pod("user1",
                             f"{primary_sts}-{rng.randrange(HOSTS)}")
            cluster.fail_pod("base", f"fbase-{rng.randrange(HOSTS)}")
            mgr.enqueue_all()
        kills += 1
        # drive the promotion to its terminal record under the active
        # partition in short beats, so one deep backoff cannot park it
        # behind the reload windows below
        beats = 0
        for _ in range(10):
            with api.fault_exempt():
                rep = replication()
            if rep.get("epoch") == epoch + 1 and \
                    rep.get("promotion", {}).get("phase") == "promoted":
                break
            with api.fault_exempt():
                mgr.enqueue_all()
            mgr.advance(1.0)
            beats += 1
        # bounded drive, not settle: the recreated pods sit in
        # RestoringCheckpoint for the whole reload window
        mgr.advance(RESTORE_S)
        api.clear_fault_plan()
        released = 0
        for _ in range(3):
            with api.fault_exempt():
                released += cluster.release_restores()
                mgr.enqueue_all()
            mgr.advance(RESTORE_S)
        _require(released >= 1, 1240, round_i, released)
        mgr.settle(max_seconds=7200.0)
        with api.fault_exempt():
            if cluster.release_restores():
                mgr.enqueue_all()
                mgr.settle(max_seconds=7200.0)
        _require(not mgr.dropped_errors, 1247, round_i, plan_seed)
        rep = replication()
        _require(rep["epoch"] == epoch + 1, 1251, round_i, rep)
        _require(rep["primary"] == standby, 1252, round_i, rep)
        _require(rep["promotion"]["phase"] == "promoted", 1253, round_i, rep)
        fence = store.fence_epoch("user1", "fsoak")
        _require(fence == epoch + 1, 1254, round_i, fence)
        kept = store.materialize("user1", "fsoak", 0) == expected_state
        _require(kept, 1256, round_i)
        try:
            store.append_delta("user1", "fsoak", 0, b"+zombie",
                               writer_epoch=epoch)
        except ss.StaleWriterError:
            fenced = True
        else:
            raise SoakFailure(f"tests/test_chaos.py:1259: round {round_i}: "
                              "the demoted zombie's write landed")
        kept_after = store.materialize("user1", "fsoak", 0) == expected_state
        _require(kept_after, 1262, round_i)
        epoch += 1
        primary = standby
        health = {}
        for ns, name in (("user1", "fsoak"), ("base", "fbase")):
            status = api.get("Notebook", ns, name).body["status"]
            _require(status["sliceHealth"] == "Healthy", 1268, round_i, ns)
            _require(status["readyReplicas"] == HOSTS, 1269, round_i, ns)
            health[ns] = [status["sliceHealth"], status["readyReplicas"]]
        out.append({"plan_seed": plan_seed, "faults": _faults(plan),
                    "deltas": len(deltas), "head": head[2],
                    "beats": beats, "released": released,
                    "epoch": rep["epoch"], "primary": rep["primary"],
                    "promotion": rep["promotion"]["phase"], "fence": fence,
                    "state_kept": [kept, kept_after], "zombie_fenced": fenced,
                    "health": health})
        # a fresh budget each round: the subject is failover latency
        mgr.advance(FAILOVER["recovery_window_s"])
    _require(kills >= 50 or kills == rounds, 1274, kills)
    promoted = metrics.promotions.value("user1", "promoted")
    _require(promoted >= kills, 1275, promoted, kills)
    no_candidate = metrics.promotions.value("user1", "no-candidate")
    _require(no_candidate == 0, 1276, no_candidate)
    fenced_writes = store.fenced_rejections[("user1", "fsoak")]
    _require(fenced_writes >= kills, 1277, fenced_writes, kills)
    _no_overlaps(mgr, 1278)
    promo_p99 = _p99(metrics.promotion_duration_seconds, "user1", 1141)
    baseline_p99 = _p99(metrics.disruption_recovery_seconds, "base", 1141)
    _require(promo_p99 * 5 <= baseline_p99, 1290, promo_p99, baseline_p99)
    ceiling = stack.fleet_budget()["failover"]["max_promotion_p99_s"]
    _require(promo_p99 <= ceiling, 1294, promo_p99, ceiling)
    return {"rounds": out, "promoted": promoted,
            "no_candidate": no_candidate, "fenced_writes": fenced_writes,
            "promotion_p99_s": promo_p99, "baseline_p99_s": baseline_p99,
            "ceiling_s": ceiling,
            "counts": {"rounds": rounds, "kills": kills,
                       "promotions": int(promoted),
                       "fenced_writes": fenced_writes,
                       "restarts": _restarts(metrics)}}


# -- TestFlightRecorderDebugSoak (tests/test_chaos.py:1298) ------------------

@soak
def flight_recorder_soak(stack, seed):
    """A gang notebook through injected faults, its history recovered
    only through the /debug endpoints: every attempt's result and
    duration, each fault on the attempt it hit, the slowest attempt's
    phase spans, exemplars that resolve, and tail sampling that keeps
    every errored and slow attempt and drops the fast ones."""
    import re

    tracing = stack.tracing
    api = stack.kube.ApiServer()
    cluster = stack.kube.FakeCluster(api)
    cluster.add_node("cpu-node", allocatable={"cpu": "64", "memory": "256Gi"})
    stack.add_gang_nodes(cluster, HOSTS)
    clock = stack.FakeClock()
    mgr = stack.kube.Manager(api, clock=clock)
    metrics = stack.metrics.NotebookMetrics(api)
    stack.setup_core_controllers(mgr, stack.CoreConfig(), metrics)
    stack.setup_odh_controllers(
        mgr, stack.OdhConfig(controller_namespace=CENTRAL_NS))
    inner = tracing.InMemorySpanExporter()
    sampler = tracing.TailSampler(inner, slow_threshold_s=0.2,
                                  sample_rate=0.0, seed=3)
    tracing.set_exporter(sampler)
    tracing.set_clock(clock)
    server = stack.serve_http(0, mgr, metrics)
    port = server.server_address[1]

    def get(path, headers=None):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                _require(resp.status == 200, 1343, path, resp.status)
                return resp.read().decode()
        except urllib.error.HTTPError as err:
            raise SoakFailure(f"tests/test_chaos.py:1346: {path}: "
                              f"{err.code}") from None

    def fault_round(rule):
        plan = stack.kube.FaultPlan([stack.kube.FaultRule(**rule)],
                                    clock=clock)
        with api.fault_exempt():
            api.delete("Service", "user1", "fr")
        api.install_fault_plan(plan)
        with api.fault_exempt():
            mgr.enqueue_all()
        mgr.settle(max_seconds=7200.0)
        api.clear_fault_plan()
        return plan

    try:
        api.create(stack.gang_notebook("fr", "user1", HOSTS))
        mgr.run_until_idle()
        # phase A: two 503s on the Service create, then recovery
        plan_err = fault_round(dict(verbs=("create",), kinds=("Service",),
                                    error="unavailable", max_matches=2,
                                    name="err"))
        _require(plan_err.exhausted() and len(plan_err.log) == 2, 1371,
                 _faults(plan_err))
        # phase B: one 0.5 s latency, above the 0.2 s tail threshold
        plan_lag = fault_round(dict(verbs=("create",), kinds=("Service",),
                                    latency_s=0.5, max_matches=1,
                                    name="lag"))
        _require(len(plan_lag.log) == 1, 1385, _faults(plan_lag))
        _require(not mgr.dropped_errors, 1386,
                 [str(e) for e in mgr.dropped_errors])
        steady = _steady_state(stack, api, "user1", "fr", HOSTS, 1387)

        snap = json.loads(get("/debug/reconciles?object=user1/fr"))
        attempts = snap["attempts"]
        _require(attempts, 1392, "no recorded attempts for user1/fr")
        for a in attempts:
            _require(a["result"] in ("success", "error", "requeue",
                                     "requeue_after"), 1394, a["result"])
            _require(a["duration_s"] >= 0.0 and a["trace_id"], 1396, a)
        everything = json.loads(get("/debug/reconciles"))
        all_attempts = everything["attempts"]
        owners_out = []
        for plan in (plan_err, plan_lag):
            for rec in plan.log:
                owners = [a for a in all_attempts
                          if a["span_id"] == rec.span_id]
                _require(len(owners) == 1, 1406, rec.seq, len(owners))
                a = owners[0]
                _require(a["trace_id"] == rec.trace_id, 1408, rec.seq)
                _require(any(f.get("fault.seq") == rec.seq
                             for f in a["faults"]), 1409, rec.seq)
                if rec.action.startswith("error:"):
                    _require(a["result"] == "error" and a["error"], 1412, a)
                owners_out.append([rec.rule, rec.seq, a["result"],
                                   a["controller"]])
        errored = everything["errored"]
        _require(len(errored) == 2, 1416, len(errored))
        _require({a["span_id"] for a in errored}
                 == {rec.span_id for rec in plan_err.log}, 1417,
                 "the errored attempts are not the two 503s")
        slowest = everything["slowest"][0]
        _require(slowest["duration_s"] >= 0.5, 1423, slowest["duration_s"])
        _require(slowest["span_id"] == plan_lag.log[0].span_id, 1424,
                 "the slowest attempt is not the lagged one")
        _require(slowest["phases"], 1425, slowest)
        trace = json.loads(get(f"/debug/traces/{slowest['trace_id']}"))
        tree = next(s for s in trace["spans"]
                    if s["span_id"] == slowest["span_id"])
        child_names = sorted({c["name"] for c in tree["children"]})
        _require({"render", "apply", "status"} <= set(child_names), 1430,
                 child_names)
        om = get("/metrics",
                 headers={"Accept": "application/openmetrics-text"})
        _require(om.rstrip().endswith("# EOF"), 1436, om[-40:])
        tids = set(re.findall(r'# \{trace_id="([0-9a-f]+)"\}', om))
        _require(tids, 1438, "no exemplars in the OpenMetrics scrape")
        for tid in tids:
            resolved = json.loads(get(f"/debug/traces/{tid}"))
            _require(resolved["spans"], 1441, tid)
        exported_roots = inner.find("reconcile")
        decisions = sorted(s.attributes["sampling.decision"]
                           for s in exported_roots)
        _require(decisions == ["error", "error", "slow"], 1448, decisions)
        _require({s.span_id for s in exported_roots
                  if s.attributes["sampling.decision"] == "error"}
                 == {rec.span_id for rec in plan_err.log}, 1449,
                 "the exported errors are not the two 503s")
        slow_root = next(s for s in exported_roots
                         if s.attributes["sampling.decision"] == "slow")
        _require(slow_root.span_id == plan_lag.log[0].span_id, 1454,
                 "the exported slow attempt is not the lagged one")
        _require(inner.find("render") and inner.find("status"), 1456,
                 "exported attempts came without their phase spans")
        recorded = everything["recorded_total"]
        _require(recorded > len(exported_roots) * 3, 1459, recorded)
        _require(sampler.dropped_total > 0, 1460, sampler.dropped_total)
    finally:
        api.clear_fault_plan()
        tracing.set_exporter(None)
        tracing.set_clock(None)
        server.shutdown()
        server.server_close()
    return {"faults": [_faults(plan_err), _faults(plan_lag)],
            "steady": steady,
            "attempts": [[a["result"], a["duration_s"]] for a in attempts],
            "owners": owners_out, "errored": len(errored),
            "slowest": [slowest["duration_s"], sorted(slowest["phases"])],
            "children": child_names, "exemplars": len(tids),
            "decisions": decisions, "recorded": recorded,
            "dropped": sampler.dropped_total,
            "counts": {"faults": len(plan_err.log) + len(plan_lag.log),
                       "attempts": recorded, "exemplars": len(tids)}}


# -- TestFleetSLOSoak (tests/test_chaos.py:1468) -----------------------------

SLO_FLEET, SLO_WINDOWS = 4, 3


@soak
def fleet_slo_soak(stack, seed):
    """Injected degradation windows with the SLO engine and the profiler
    on: exactly one burn alert fired and resolved per window, each with a
    trace id the flight recorder resolves; none firing at the end;
    /debug/fleet equal to the apiserver's truth; the profiler under 5% of
    wall time; the slowest attempt rebuilt from a diagnose bundle."""
    tracing = stack.tracing
    api = stack.kube.ApiServer()
    cluster = stack.kube.FakeCluster(api)
    cluster.add_node("cpu-node", allocatable={"cpu": "64", "memory": "256Gi"})
    stack.add_gang_nodes(cluster, HOSTS * SLO_FLEET)
    clock = stack.FakeClock()
    mgr = stack.kube.Manager(api, clock=clock,
                             flight_recorder=_recorder(stack))
    metrics = stack.metrics.NotebookMetrics(api, manager=mgr)
    cfg = stack.CoreConfig()
    stack.setup_core_controllers(mgr, cfg, metrics)
    stack.setup_odh_controllers(
        mgr, stack.OdhConfig(controller_namespace=CENTRAL_NS))
    engine = stack.slo.SLOEngine(
        stack.slo.default_objectives(cfg),
        registries=[metrics.registry, mgr.metrics_registry],
        clock=clock, recorder=mgr.flight_recorder, burn_threshold=2.0)
    mgr.slo_engine = engine
    metrics.attach_slo(engine)
    profiler = stack.profiler.ContinuousProfiler(registry=metrics.registry,
                                                 interval_s=0.002)
    mgr.profiler = profiler
    tracing.set_clock(clock)
    profiler.start()

    def alerts_for(objective):
        return [a for a in engine.alert_history()
                if a.objective == objective]

    def window(rule, service):
        plan = stack.kube.FaultPlan([stack.kube.FaultRule(**rule)],
                                    clock=clock)
        with api.fault_exempt():
            api.delete("Service", "user1", service)
        api.install_fault_plan(plan)
        with api.fault_exempt():
            mgr.enqueue_all()
        mgr.settle(max_seconds=7200.0)
        api.clear_fault_plan()
        return plan

    try:
        for i in range(SLO_FLEET):
            api.create(stack.gang_notebook(f"slo-{i}", "user1", HOSTS))
        mgr.run_until_idle()
        metrics.scrape()
        _require(not engine.firing(), 1524, "an alert fired at baseline")
        # one latency fault early: the soak's slowest attempt
        plan_lag = window(dict(verbs=("create",), kinds=("Service",),
                               latency_s=0.75, max_matches=1, name="lag"),
                          "slo-0")
        _require(len(plan_lag.log) == 1, 1542, _faults(plan_lag))
        windows = []
        for w in range(SLO_WINDOWS):
            before = len(alerts_for("reconcile_errors"))
            plan = window(dict(verbs=("create",), kinds=("Service",),
                               error="unavailable", max_matches=4,
                               name=f"win-{w}"), f"slo-{w % SLO_FLEET}")
            _require(len(plan.log) == 4, 1560, w, _faults(plan))
            metrics.scrape()
            firing = [a.objective for a in engine.firing()]
            _require(firing == ["reconcile_errors"], 1564, w, firing)
            fired = len(alerts_for("reconcile_errors"))
            _require(fired == before + 1, 1566, w, fired, before)
            with api.fault_exempt():
                mgr.enqueue_all()
            mgr.settle(max_seconds=7200.0)
            for _ in range(3):
                clock.advance(150)
                metrics.scrape()
            still = [a.objective for a in engine.firing()]
            _require(not still, 1576, f"window {w} never resolved", still)
            steady = [_steady_state(stack, api, "user1", f"slo-{i}", HOSTS,
                                    1578) for i in range(SLO_FLEET)]
            windows.append({"faults": _faults(plan), "firing": firing,
                            "alerts": fired, "after": still,
                            "steady": steady})
        history = alerts_for("reconcile_errors")
        _require(len(history) == SLO_WINDOWS, 1583, len(history))
        _require(not engine.firing(), 1584, "alerts firing at soak end")
        alerts = []
        for alert in history:
            _require(alert.state == "resolved", 1586, alert.state)
            _require(alert.resolved_at > alert.fired_at, 1587,
                     alert.fired_at, alert.resolved_at)
            _require(alert.trace_id, 1588, "an alert without a trace id")
            trace = mgr.flight_recorder.trace(alert.trace_id)
            _require(trace is not None and trace["spans"], 1590,
                     alert.trace_id)
            alerts.append([alert.state, alert.fired_at, alert.resolved_at,
                           len(trace["spans"])])
        final = metrics.scrape()
        gauge_line = ('notebook_slo_alert_firing{objective='
                      '"reconcile_errors"} 0')
        _require(gauge_line in final, 1593, "the firing gauge is not 0")
        snap = metrics.fleet_snapshot()
        truth = {}
        for nb in api.list("Notebook"):
            s = stack.metrics.fleet_state(nb)
            truth[s] = truth.get(s, 0) + 1
        totals = {k: v for k, v in snap["totals"].items() if v}
        _require(totals == truth, 1602, totals, truth)
        _require(snap["notebooks"] == SLO_FLEET, 1603, snap["notebooks"])
        ready = snap["namespaces"]["user1"]["ready"]
        _require(ready == SLO_FLEET, 1604, ready)
        # wall-clock gates: held, never compared
        profiler.stop()
        _require(profiler.passes > 0 and profiler.samples_total > 0, 1608,
                 profiler.passes, profiler.samples_total)
        overhead = profiler.overhead_ratio()
        _require(overhead < 0.05, 1610, f"profiler overhead {overhead:.3f}")
        gauge = metrics.registry.get("notebook_profiler_overhead_ratio")
        _require(gauge.collect()[()] == profiler.overhead_ratio(), 1612,
                 "the overhead gauge disagrees with the profiler")
        bundle = stack.diagnose.collect_local(mgr, metrics)
        offline = json.loads(json.dumps(bundle, default=str))
        slowest = offline["reconciles"]["slowest"][0]
        _require(slowest["duration_s"] >= 0.75, 1620, slowest["duration_s"])
        tree = offline["traces"][slowest["trace_id"]]
        roots = [s for s in tree["spans"]
                 if s["span_id"] == slowest["span_id"]]
        _require(len(roots) == 1, 1624, len(roots))
        children = sorted({c["name"] for c in roots[0]["children"]})
        _require({"render", "apply", "status"} <= set(children), 1625,
                 children)
        _require(any(f.get("fault.rule") == "lag"
                     for f in slowest["faults"]), 1627, slowest["faults"])
        history_n = len(offline["alerts"]["history"])
        _require(history_n >= SLO_WINDOWS, 1630, history_n)
        bundle_ready = offline["fleet"]["totals"]["ready"]
        _require(bundle_ready == SLO_FLEET, 1631, bundle_ready)
        _require(offline["profile"]["samples_total"]
                 == profiler.samples_total, 1632,
                 "the bundle's profile is not the profiler's")
    finally:
        api.clear_fault_plan()
        profiler.stop()
        tracing.set_clock(None)
        mgr.stop()
    return {"lag": _faults(plan_lag), "windows": windows, "alerts": alerts,
            "totals": totals, "notebooks": snap["notebooks"],
            "ready": ready,
            "bundle": {"slowest": slowest["duration_s"],
                       "children": children, "alerts": history_n,
                       "ready": bundle_ready},
            "counts": {"faults": 1 + 4 * SLO_WINDOWS,
                       "alerts_fired": len(history),
                       "alerts_resolved": sum(a.state == "resolved"
                                              for a in history)},
            "wall": {"profiler_overhead": overhead,
                     "profiler_samples": profiler.samples_total}}


# -- TestStragglerSoak (tests/test_chaos.py:1641) ----------------------------

@soak
def straggler_soak(stack, seed):
    """One injected slow worker is attributed to its (notebook, worker)
    by the fleet rollup and the diagnose bundle, with one gauge and one
    Warning event, clears when healed, and the straggler objective never
    fires on healthy gangs."""
    T = stack.telemetry
    fleet, workers = 2, HOSTS
    api = stack.kube.ApiServer()
    cluster = stack.kube.FakeCluster(api)
    cluster.add_node("cpu-node", allocatable={"cpu": "64", "memory": "256Gi"})
    stack.add_gang_nodes(cluster, workers * fleet)
    clock = stack.FakeClock()
    mgr = stack.kube.Manager(api, clock=clock,
                             flight_recorder=stack.FlightRecorder())
    metrics = stack.metrics.NotebookMetrics(api, manager=mgr)
    # the straggler objective armed: the soak proves it stays silent on
    # healthy gangs
    cfg = stack.CoreConfig(slo_straggler_rate=0.30)
    stack.setup_core_controllers(mgr, cfg, metrics)
    aggregator = T.WorkerTelemetryAggregator(
        api, metrics.registry, clock, cache=mgr.cache,
        recorder=stack.kube.EventRecorder(api, "dataplane-telemetry"),
        straggler_ratio=cfg.dataplane_straggler_ratio,
        min_workers=cfg.dataplane_straggler_min_workers)
    metrics.attach_dataplane(aggregator)
    mgr.telemetry_aggregator = aggregator
    engine = stack.slo.SLOEngine(
        stack.slo.default_objectives(cfg),
        registries=[metrics.registry, mgr.metrics_registry],
        clock=clock, recorder=mgr.flight_recorder)
    metrics.attach_slo(engine)
    mgr.slo_engine = engine

    def stamp(slow=None):
        for i in range(fleet):
            cluster.stamp_worker_telemetry(
                "user1", f"tele-{i}", step_time_s=0.5,
                config=stack.LLAMA2_350M, batch=8, seq_len=2048,
                slow_worker=(slow if i == 0 else None), slow_factor=4.0,
                now=clock.now(), **stack.telemetry_kw)

    def events(nb, reason=T.EVENT_STRAGGLER):
        return [e for e in api.list("Event", namespace="user1")
                if e.body.get("reason") == reason
                and e.body["involvedObject"]["name"] == nb]

    def stragglers():
        snap = metrics.fleet_snapshot()["dataplane"]
        return snap, [[s["namespace"], s["name"], s["worker"]]
                      for s in snap["stragglers"]]

    try:
        for i in range(fleet):
            api.create(stack.gang_notebook(f"tele-{i}", "user1", HOSTS))
        mgr.run_until_idle()
        for i in range(fleet):
            health = api.get("Notebook", "user1", f"tele-{i}").body[
                "status"]["sliceHealth"]
            _require(health == "Healthy", 1698, i, health)
        gauge = metrics.registry.get("notebook_dataplane_straggler")
        # phase 1: a healthy fleet
        stamp()
        for _ in range(4):
            clock.advance(60)
            metrics.scrape()
        snap, found = stragglers()
        _require(snap["fleet"]["notebooks"] == fleet, 1724, snap["fleet"])
        _require(found == [], 1725, found)
        for i in range(fleet):
            _require(gauge.collect()[("user1", f"tele-{i}")] == 0.0, 1727, i)
            _require(events(f"tele-{i}") == [], 1728, i)
        _require(not engine.firing(), 1729, "an objective fired on a "
                 "healthy fleet")
        healthy = {"notebooks": snap["fleet"]["notebooks"],
                   "stragglers": found}
        # phase 2: one slow worker on tele-0 (ordinal 2, pod tele-0-2)
        stamp(slow=2)
        clock.advance(60)
        metrics.scrape()
        snap, found = stragglers()
        _require(found == [["user1", "tele-0", "tele-0-2"]], 1736, found)
        named = snap["notebooks"]["user1/tele-0"]["straggler"]
        _require(named == "tele-0-2", 1739, named)
        gauges = [gauge.collect()[("user1", f"tele-{i}")]
                  for i in range(fleet)]
        _require(gauges == [1.0, 0.0], 1741, gauges)
        for _ in range(3):
            clock.advance(60)
            metrics.scrape()
        warned = events("tele-0")
        _require(len(warned) == 1, 1749, len(warned))
        _require("tele-0-2" in warned[0].body["message"], 1750,
                 warned[0].body["message"])
        _require(events("tele-1") == [], 1751, "tele-1 was flagged")
        bundle = json.loads(json.dumps(
            stack.diagnose.collect_local(mgr, metrics), default=str))
        offline = [s["worker"] for s in bundle["telemetry"]["stragglers"]]
        _require(offline == ["tele-0-2"], 1756, offline)
        _require(bundle["fleet"]["dataplane"]["notebooks"]["user1/tele-0"][
            "straggler"] == "tele-0-2", 1758, "the bundle's rollup")
        line = 'notebook_dataplane_straggler{namespace="user1",' \
            'name="tele-0"} 1'
        _require(line in bundle["metrics"], 1760, "the bundle's gauge")
        slow = {"stragglers": found, "named": named, "gauges": gauges,
                "warnings": len(warned), "bundle": offline}
        # phase 3: healed
        stamp()
        clock.advance(60)
        metrics.scrape()
        snap, found = stragglers()
        _require(found == [], 1768, found)
        cleared_gauge = gauge.collect()[("user1", "tele-0")]
        _require(cleared_gauge == 0.0, 1769, cleared_gauge)
        _require(len(events("tele-0")) == 1, 1770, "the warning fired again")
        cleared = len(events("tele-0", T.EVENT_STRAGGLER_CLEARED))
        _require(cleared == 1, 1771, cleared)
        # phase 4: a healthy tail drains the objective
        for _ in range(6):
            clock.advance(120)
            metrics.scrape()
        _require(not engine.firing(), 1780, "an objective fired at the end")
        _require(events("tele-1") == [], 1781, "tele-1 was flagged")
        _require(events("tele-1", T.EVENT_STRAGGLER_CLEARED) == [], 1782,
                 "tele-1 was cleared")
        checks = metrics.registry.get(
            "notebook_dataplane_straggler_checks_total").collect()
        _require(checks[("straggler",)] >= 1, 1787, checks)
        _require(checks[("ok",)] > checks[("straggler",)], 1788, checks)
    finally:
        mgr.stop()
    return {"healthy": healthy, "slow": slow,
            "healed": {"stragglers": found, "gauge": cleared_gauge,
                       "cleared_events": cleared},
            "checks": sorted([list(k), v] for k, v in checks.items()),
            "counts": {"stragglers": 1, "warnings": len(warned),
                       "cleared": cleared}}


# -- TestShardKillRejoinSoak (tests/test_chaos.py:1793) ----------------------

@soak
def shard_soak(stack, seed, rounds=8):
    """A 3-replica sharded fleet through seeded kill, zombie-write, rejoin
    and churn rounds: every notebook converged after each round, no
    cross-process double reconcile over the merged histories, every
    zombie write fenced and counted, the map epoch strictly rising, and
    the replicas' diagnose bundles merged offline agreeing."""
    replicas, notebooks = 3, 12
    clock = stack.FakeClock()
    fleet, api, cluster, metrics = stack.build_sharded_fleet(
        core_cfg=stack.CoreConfig(), count=replicas, clock=clock)
    cluster.add_node("cpu-node", allocatable={"cpu": "64", "memory": "256Gi"})
    keys = [(f"user{i % 4}", f"soak-{i}") for i in range(notebooks)]
    for ns, name in keys:
        api.create(stack.gang_notebook(name, ns, 0))
    fleet.settle()

    def converged(round_i):
        for ns, name in keys:
            _require(api.try_get("StatefulSet", ns, name) is not None, 1842,
                     round_i, ns, name, "statefulset missing")
            nb = api.get("Notebook", ns, name)
            _require(nb.body.get("status", {}).get("conditions"), 1845,
                     round_i, ns, name, "status never stamped")

    def expire_dead(steps=3, step=8):
        # sub-lease steps: survivors renew every settle pass, so only the
        # dead member's lease ages past the 15 s duration
        for _ in range(steps):
            clock.advance(step)
            fleet.settle()

    converged(-1)
    rng = random.Random(seed ^ 0x5AAD)
    epochs = [fleet.shard_snapshot()["epoch"]]
    zombie_attempts = kills = rejoins = 0
    out = []
    for round_i in range(rounds):
        alive = sorted(r.shard_id for r in fleet.alive_replicas())
        dead = sorted(set(fleet.replicas) - set(alive))
        zombie = None
        if dead and (len(alive) <= 1 or rng.random() < 0.5):
            action = ["rejoin", rng.choice(dead)]
            fleet.rejoin(action[1])
            fleet.settle()
            rejoins += 1
        else:
            victim_id = rng.choice(alive)
            action = ["kill", victim_id]
            victim = fleet.replicas[victim_id]
            fleet.kill(victim_id)
            kills += 1
            expire_dead()
            # the zombie still holds its stale token: its write must fence
            ns, name = rng.choice(keys)
            with api.fault_exempt():
                nb = api.get("Notebook", ns, name)
            nb.metadata.annotations["chaos/zombie"] = str(round_i)
            try:
                victim.fenced.update(nb)
            except stack.kube.StaleEpochError:
                zombie_attempts += 1
                zombie = f"{ns}/{name}"
            else:
                raise SoakFailure(f"tests/test_chaos.py:1874: round "
                                  f"{round_i}: zombie {victim_id} write "
                                  "landed after eviction")
        touched = []
        for ns, name in rng.sample(keys, 3):
            with api.fault_exempt():
                nb = api.get("Notebook", ns, name)
                nb.metadata.annotations["chaos/touch"] = \
                    f"{round_i}.{rng.random()}"
                api.update(nb)
            touched.append(f"{ns}/{name}")
        for r in fleet.alive_replicas():
            r.manager.enqueue_all()
        fleet.settle()
        snap = fleet.shard_snapshot()
        members = sorted(r.shard_id for r in fleet.alive_replicas())
        _require(snap["members"] == members, 1891, round_i, snap["members"])
        _require(snap["handoff"] is None, 1893, round_i, snap["handoff"])
        _require(snap["epoch"] > epochs[-1], 1894, f"round {round_i}: "
                 "epoch must move on every membership change",
                 epochs[-1], snap["epoch"])
        epochs.append(snap["epoch"])
        converged(round_i)
        out.append({"action": action, "zombie": zombie, "touched": touched,
                    "members": snap["members"], "epoch": snap["epoch"]})
    merged_n = len(fleet.merged_records())
    _require(merged_n, 1901, "soak recorded no attempts")
    overlaps = fleet.cross_process_overlaps()
    _require(not overlaps, 1903, f"{len(overlaps)} cross-process double "
             "reconciles")
    _require(zombie_attempts > 0, 1907, "soak never exercised a zombie")
    rejected = sum(s["fenced_rejections"] for s in
                   fleet.shard_snapshot()["replicas"].values())
    _require(rejected >= zombie_attempts, 1910, rejected, zombie_attempts)
    bundles = [stack.diagnose.collect_local(r.manager, env={})
               for r in fleet.replicas.values()]
    merged = stack.diagnose.merge_records(bundles)
    _require(merged, 1915, "bundles carried no attempts")
    bundle_overlaps = stack.diagnose.merge_overlaps(bundles)
    _require(bundle_overlaps == [], 1916, len(bundle_overlaps))
    return {"rounds": out, "epochs": epochs, "zombies": zombie_attempts,
            "fenced": rejected, "merged_attempts": merged_n,
            "bundle_attempts": len(merged),
            "counts": {"rounds": rounds, "kills": kills, "rejoins": rejoins,
                       "fenced_writes": rejected}}


# -- TestNoisyNeighborSoak (tests/test_chaos.py:1919) ------------------------

@soak
def noisy_neighbor_soak(stack, seed):
    """One tenant floods the control plane while bounded API faults fire:
    metering flags exactly that tenant with one deduplicated Warning,
    keeps the victims' event->reconcile p99 honest and under the budget,
    conserves chip-seconds, clears the flag once traffic rebalances, and
    the verdict rebuilds from a diagnose bundle."""
    tenants, per_tenant, noisy = 4, 2, 1
    C, M = stack.C, stack.metering
    api = stack.kube.ApiServer()
    cluster = stack.kube.FakeCluster(api)
    cluster.add_node("cpu-node", allocatable={"cpu": "64", "memory": "256Gi"})
    clock = stack.FakeClock()
    mgr = stack.kube.Manager(api, clock=clock)
    metrics = stack.metrics.NotebookMetrics(api, manager=mgr)
    stack.setup_core_controllers(mgr, stack.CoreConfig(), metrics)
    stack.tracing.set_clock(clock)
    try:
        namespaces = [f"tenant-{i}" for i in range(tenants)]
        noisy_ns = namespaces[noisy]
        for ns in namespaces:
            for i in range(per_tenant):
                # placement-annotated from birth: every tenant's wall time
                # is metered for the whole soak
                api.create(stack.gang_notebook(
                    f"nb-{i}", ns, 0, annotations={
                        C.ANNOTATION_PLACEMENT: json.dumps({"pool": "p0"})}))
        mgr.run_until_idle()
        # metering attached after convergence, so the fairness baselines
        # latch from benign traffic
        metering = M.TenantMeteringLedger(
            clock, registry=metrics.registry,
            recorder=stack.kube.EventRecorder(api, "tenant-metering"))
        mgr.metering = metering
        metrics.attach_metering(metering)
        touch_seq = [0]

        def touch(ns):
            for i in range(per_tenant):
                # a strictly increasing stamp, so every update is a change
                touch_seq[0] += 1

                def bump(i=i, stamp=touch_seq[0]):
                    nb = api.get("Notebook", ns, f"nb-{i}")
                    nb.metadata.annotations["chaos/touch"] = str(stamp)
                    api.update(nb)

                stack.kube.retry_on_conflict(bump)

        for _ in range(20):
            for ns in namespaces:
                touch(ns)
            mgr.settle(max_seconds=60.0)
            clock.advance(10.0)
            metrics.scrape()
        benign = metering.flagged()
        _require(benign == [], 1999, benign)
        rng = random.Random(seed + 17)
        faults = []
        for _ in range(6):
            plan = stack.kube.random_fault_plan(
                rng.randrange(2**31), kinds=FAULT_KINDS, clock=clock)
            api.install_fault_plan(plan)
            with api.fault_exempt():
                for ns in namespaces:
                    if ns != noisy_ns:
                        touch(ns)
            clock.advance(2.5)
            mgr.settle(max_seconds=600.0)
            with api.fault_exempt():
                for _ in range(80):
                    touch(noisy_ns)
                    mgr.settle(max_seconds=600.0)
            api.clear_fault_plan()
            mgr.settle(max_seconds=600.0)
            metrics.scrape()
            faults.append(_faults(plan))
        flooded = metering.flagged()
        _require(flooded == [noisy_ns], 2022, flooded)
        warnings = [e for e in api.list("Event")
                    if e.body.get("reason") == M.REASON_NOISY]
        _require(len(warnings) == 1, 2028, [e.body for e in warnings])
        named = warnings[0].body["involvedObject"]["name"]
        _require(named == noisy_ns, 2029, named)
        table = metering.tenant_table()
        _require(table[noisy_ns]["fired_total"] == 1, 2030, table[noisy_ns])
        p99s = {}
        for ns in namespaces:
            if ns == noisy_ns:
                continue
            p99s[ns] = table[ns]["e2r_p99_recent_s"]
            _require(0.0 < p99s[ns] <= 4.0, 2038, ns, table[ns])
        for _ in range(metering.window_evals + 4):
            for ns in namespaces:
                touch(ns)
            mgr.settle(max_seconds=60.0)
            clock.advance(10.0)
            metrics.scrape()
        recovered = metering.flagged()
        _require(recovered == [], 2048, recovered)
        cons = metering.conservation()
        _require(cons["checked"] >= tenants * per_tenant, 2054, cons)
        _require(cons["violations"] == 0, 2055, metering.violations()[:3])
        bundle = stack.diagnose.collect_local(mgr, metrics, env={})
        tn = bundle["tenants"]
        _require(tn["tenants"][noisy_ns]["fired_total"] == 1, 2058, tn)
        _require(tn["fairness"]["flagged"] == [], 2059, tn["fairness"])
        _require(tn["conservation"]["violations"] == 0, 2060,
                 tn["conservation"])
        _require(json.dumps(tn), 2061, "the bundle section")
    finally:
        api.clear_fault_plan()
        stack.tracing.set_clock(None)
    return {"benign": benign, "faults": faults, "flooded": flooded,
            "warnings": len(warnings), "named": named, "p99s": p99s,
            "recovered": recovered,
            "conservation": {k: cons[k] for k in ("checked", "violations")},
            "bundle": {"fired": tn["tenants"][noisy_ns]["fired_total"],
                       "flagged": tn["fairness"]["flagged"]},
            "counts": {"faults": sum(len(f) for f in faults),
                       "flagged": len(flooded), "warnings": len(warnings)}}


# -- TestDiagnosisSoak (tests/test_chaos.py:2067) ----------------------------

DIAGNOSIS = dict(checkpoint_store_uri="mem://session-state",
                 recovery_backoff_base_s=0.25, recovery_backoff_max_s=30.0)


@soak
def diagnosis_soak(stack, seed):
    """Three disjoint injected windows (an API fault plan, a slow worker,
    killed replication primaries): the diagnosis engine names the true
    cause first for every affected notebook, its change-point detector
    fires inside each window and never between them, the burn alert
    carries a one-line diagnosis, and both verdicts rebuild from a
    diagnose bundle."""
    fault_a, slow_b, repl_c, scrape_s = 3, 2, 3, 60.0
    D, tracing = stack.diagnosis, stack.tracing
    api = stack.kube.ApiServer()
    cluster = stack.kube.FakeCluster(api)
    cluster.add_node("cpu-node", allocatable={"cpu": "64", "memory": "256Gi"})
    # the fault batch, the telemetry batch, two gangs a replicated
    # notebook and one spare
    gangs = fault_a + slow_b + 2 * repl_c + 1
    stack.add_gang_nodes(cluster, HOSTS * gangs)
    clock = stack.FakeClock()
    mgr = stack.kube.Manager(api, clock=clock,
                             flight_recorder=_recorder(stack))
    store = stack.sessionstate.InMemorySessionStore(clock=clock)
    cluster.attach_session_store(store)
    cfg = stack.CoreConfig(**DIAGNOSIS)
    metrics = stack.metrics.NotebookMetrics(api, manager=mgr)
    stack.setup_core_controllers(mgr, cfg, metrics, session=store)
    ledger = stack.lifecycle.LifecycleLedger(metrics.registry)
    mgr.lifecycle = ledger
    metrics.attach_lifecycle(ledger)
    tsdb = stack.tsdb.TimeSeriesStore()
    mgr.tsdb = tsdb
    metrics.attach_tsdb(tsdb, clock=clock)
    slo = stack.slo.SLOEngine(
        stack.slo.default_objectives(cfg),
        registries=[metrics.registry, mgr.metrics_registry],
        clock=clock, recorder=mgr.flight_recorder, burn_threshold=2.0)
    mgr.slo_engine = slo
    metrics.attach_slo(slo)
    aggregator = stack.telemetry.WorkerTelemetryAggregator(
        api, metrics.registry, clock, cache=mgr.cache,
        recorder=stack.kube.EventRecorder(api, "dataplane-telemetry"),
        straggler_ratio=cfg.dataplane_straggler_ratio,
        min_workers=cfg.dataplane_straggler_min_workers)
    metrics.attach_dataplane(aggregator)
    mgr.telemetry_aggregator = aggregator
    diag = D.DiagnosisEngine(
        clock, registry=metrics.registry, recorder=mgr.flight_recorder,
        lifecycle=ledger, slo_engine=slo, tsdb=tsdb, dataplane=aggregator,
        api=api)
    mgr.diagnosis = diag
    metrics.attach_diagnosis(diag)
    tracing.set_clock(clock)

    def stamp(slow=None):
        """Fresh telemetry for the slow batch every beat, so the
        straggler gauge is level rather than flapping on staleness."""
        for i in range(slow_b):
            cluster.stamp_worker_telemetry(
                "user1", f"slow-b-{i}", step_time_s=0.5,
                config=stack.LLAMA2_350M, batch=8, seq_len=2048,
                slow_worker=(slow if i == 0 else None), slow_factor=4.0,
                now=clock.now(), **stack.telemetry_kw)

    def beat(slow=None, n=1):
        for _ in range(n):
            clock.advance(scrape_s)
            stamp(slow=slow)
            metrics.scrape()

    def findings():
        return [[f["series"], f["matched"], f["direction"], f["t_start"],
                 f["t_end"]] for f in diag.findings()]

    try:
        for i in range(fault_a):
            api.create(stack.gang_notebook(f"fault-a-{i}", "user1", HOSTS))
        for i in range(slow_b):
            api.create(stack.gang_notebook(f"slow-b-{i}", "user1", HOSTS))
        for i in range(repl_c):
            api.create(stack.gang_notebook(
                f"repl-c-{i}", "user1", HOSTS,
                replication=stack.ReplicationSpec(replicas=2)))
        mgr.run_until_idle()
        beat(n=8)
        _require(diag.findings() == [], 2196, findings())
        # window A: API fault plans
        wa0 = clock.now()
        for r in range(6):
            plan = stack.kube.FaultPlan([stack.kube.FaultRule(
                verbs=("create",), kinds=("Service",), error="unavailable",
                max_matches=3, name=f"diag-api-{r}")], clock=clock)
            with api.fault_exempt():
                api.delete("Service", "user1", f"fault-a-{r % fault_a}")
            api.install_fault_plan(plan)
            with api.fault_exempt():
                mgr.enqueue_all()
            mgr.settle(max_seconds=7200.0)
            api.clear_fault_plan()
            _require(len(plan.log) == 3, 2213, r, _faults(plan))
            beat()
        firing = sorted(a.objective for a in slo.firing())
        _require("reconcile_errors" in firing, 2218, firing)
        ann = diag.annotate_alerts(slo.snapshot())
        lines = [a["diagnosis"] for a in ann["firing"]
                 if a["objective"] == "reconcile_errors"]
        _require(lines and all(line for line in lines), 2222, ann["firing"])
        _require(any("fault plan" in line for line in lines), 2223, lines)
        beat(n=4)
        wa1 = clock.now()
        # quiet segment 1
        n_quiet1 = len(diag.findings())
        beat(n=2)
        for _ in range(8):
            clock.advance(150.0)
            stamp()
            metrics.scrape()
        _require(not slo.firing(), 2236, "an alert outlived window A")
        quiet1_end = clock.now()
        _require(len(diag.findings()) == n_quiet1, 2238, findings())
        # window B: a slow data-plane worker
        wb0 = clock.now()
        beat(slow=1, n=8)
        cause_b0 = diag.explain("user1", "slow-b-0")["cause"]
        _require(cause_b0 == D.CAUSE_SLOW_WORKER, 2245, cause_b0)
        cause_b1 = diag.explain("user1", "slow-b-1")["cause"]
        _require(cause_b1 != D.CAUSE_SLOW_WORKER, 2247, cause_b1)
        wb1 = clock.now()
        # quiet segment 2: a held degradation is no new change point
        n_quiet2 = len(diag.findings())
        beat(slow=1, n=10)
        quiet2_end = clock.now()
        _require(len(diag.findings()) == n_quiet2, 2256, findings())
        # window C: kill every replication primary
        wc0 = clock.now()
        for i in range(repl_c):
            cluster.set_session_payload("user1", f"repl-c-{i}",
                                        b"kernel-%d" % i)
            cluster.snapshot_sessions("user1", f"repl-c-{i}")
            cluster.sync_followers("user1", f"repl-c-{i}")
        mgr.enqueue_all()
        mgr.settle(max_seconds=7200.0)
        for i in range(repl_c):
            cluster.fail_pod("user1", f"repl-c-{i}-0")
        mgr.enqueue_all()

        def promoted(i):
            st = api.get("Notebook", "user1",
                         f"repl-c-{i}").body.get("status") or {}
            rep = st.get("replication") or {}
            return rep.get("promotion", {}).get("phase") == "promoted"

        beats = 0
        for _ in range(12):
            if all(promoted(i) for i in range(repl_c)):
                break
            mgr.enqueue_all()
            mgr.advance(1.0)
            beats += 1
        _require(all(promoted(i) for i in range(repl_c)), 2282,
                 [promoted(i) for i in range(repl_c)])
        mgr.settle(max_seconds=7200.0)
        beat(slow=1, n=9)
        causes = {}
        for i in range(fault_a):
            out = diag.explain("user1", f"fault-a-{i}")
            _require(out["cause"] == D.CAUSE_FAULT_INJECTION, 2293, i,
                     out["cause"])
            _require(out["verdict"], 2294, out)
            causes[f"fault-a-{i}"] = out["cause"]
        causes["slow-b-0"] = diag.explain("user1", "slow-b-0")["cause"]
        _require(causes["slow-b-0"] == D.CAUSE_SLOW_WORKER, 2295,
                 causes["slow-b-0"])
        for i in range(repl_c):
            out = diag.explain("user1", f"repl-c-{i}")
            _require(out["cause"] == D.CAUSE_PRIMARY_FAILOVER, 2299, i,
                     out["cause"])
            causes[f"repl-c-{i}"] = out["cause"]
        found = diag.findings()
        windows = [(wa0, wa1), (wb0, wb1), (wc0, clock.now())]

        def in_window(f, w):
            return w[0] <= f["t_end"] <= w[1]

        for line, series, matched, w in (
                (2309, "reconcile_errors_delta", "fault", windows[0]),
                (2313, "dataplane_stragglers", "slow_worker", windows[1]),
                (2317, "promotions_delta", "promotion", windows[2])):
            _require(any(f["series"] == series and f["matched"] == matched
                         and in_window(f, w) for f in found), line, series,
                     findings())
        for f in found:
            _require(any(in_window(f, w) for w in windows), 2324,
                     "a change point outside every window", f["series"],
                     f["t_end"])
        _require(quiet1_end <= wb0 and quiet2_end <= wc0, 2325,
                 "the windows overlap")
        counts = metrics.registry.get("notebook_changepoints_total").collect()
        for line, key in ((2330, ("reconcile_errors_delta", "fault")),
                          (2331, ("dataplane_stragglers", "slow_worker")),
                          (2332, ("promotions_delta", "promotion"))):
            _require(counts.get(key), line, key, counts)
        clock.advance(scrape_s)
        stamp(slow=1)
        bundle = json.loads(json.dumps(
            stack.diagnose.collect_local(mgr, metrics), default=str))
        ex = bundle["diagnosis"]["explanations"]
        offline = {k: ex[f"user1/{k}"]["cause"] for k in causes}
        for i in range(fault_a):
            _require(offline[f"fault-a-{i}"] == D.CAUSE_FAULT_INJECTION,
                     2341, i, offline)
        _require(offline["slow-b-0"] == D.CAUSE_SLOW_WORKER, 2343, offline)
        for i in range(repl_c):
            _require(offline[f"repl-c-{i}"] == D.CAUSE_PRIMARY_FAILOVER,
                     2345, i, offline)
        rebuilt = D.changepoints_from_bundle(bundle)
        live = {(f["series"], f["t_start"], f["direction"])
                for f in bundle["diagnosis"]["changepoints"]}
        recon = {(f["series"], f["t_start"], f["direction"])
                 for f in rebuilt}
        _require(live == recon, 2352, sorted(live ^ recon))
        kinds = sorted({e["kind"] for e in bundle["diagnosis"]["timeline"]})
        _require({"fault", "slow_worker", "promotion"} <= set(kinds), 2354,
                 kinds)
        _require(not mgr.dropped_errors, 2356,
                 [str(e) for e in mgr.dropped_errors])
        _no_overlaps(mgr, 2357)
    finally:
        api.clear_fault_plan()
        tracing.set_clock(None)
        mgr.stop()
    return {"alert_lines": len(lines), "firing": firing, "causes": causes,
            "slow_b1": cause_b1, "beats": beats, "findings": findings(),
            "windows": [list(w) for w in windows],
            "changepoints": sorted([list(k), v] for k, v in counts.items()),
            "offline": offline, "rebuilt": sorted(recon), "kinds": kinds,
            "counts": {"findings": len(found), "promotions": repl_c,
                       "kills": repl_c, "faults": 18}}


# -- the port's stack --------------------------------------------------------

def port_stack(accelerator: str = "h100-80gb") -> types.SimpleNamespace:
    """The port's control plane as a soak stack, its gangs `accelerator`
    hosts of that accelerator's GPUs a host."""
    from .. import kube
    from ..api.types import GPUSpec, Notebook, ReplicationSpec
    from ..core import constants, metrics, preemption, sessionstate
    from ..core import telemetry
    from ..core.notebook_controller import setup_core_controllers
    from ..gpu import topology
    from ..main import build_sharded_fleet, serve_http
    from ..models.configs import LLAMA2_350M
    from ..odh import constants as odh_constants
    from ..odh.controller import setup_odh_controllers
    from ..ops import diagnose
    from ..utils import (diagnosis, lifecycle, metering, profiler, slo,
                         tracing, tsdb)
    from ..utils.clock import FakeClock
    from ..utils.config import CoreConfig, OdhConfig
    from ..utils.flightrecorder import FlightRecorder
    from . import knowledge

    acc = topology.ACCELERATORS[accelerator]
    per_host = acc.gpus_per_host

    def gang_notebook(name, ns, hosts, gangs=1, priority=None,
                      replication=None, annotations=None):
        gpu = GPUSpec(accelerator, per_host * hosts) if hosts else None
        if gangs > 1:
            # a spec.gpu notebook holds several gangs only as replicas
            replication = ReplicationSpec(replicas=gangs, anti_affine=False)
        return kube.KubeObject.from_dict(Notebook.new(
            name, ns, gpu=gpu, annotations=annotations,
            replication=replication, priority=priority).obj)

    def add_gang_nodes(cluster, hosts, pool=None):
        return cluster.add_gpu_nodes(accelerator, hosts, per_host, pool=pool)

    def gang_demand(hosts, gangs):
        shape = topology.resolve(accelerator, per_host * hosts)
        return shape, float(gangs * shape.gpus)

    return types.SimpleNamespace(
        kube=kube, C=constants, OC=odh_constants, CoreConfig=CoreConfig,
        OdhConfig=OdhConfig, setup_core_controllers=setup_core_controllers,
        setup_odh_controllers=setup_odh_controllers, metrics=metrics,
        placement_units=metrics.placement_gpus, FakeClock=FakeClock,
        FlightRecorder=FlightRecorder, tracing=tracing, lifecycle=lifecycle,
        metering=metering, sessionstate=sessionstate, preemption=preemption,
        slo=slo, profiler=profiler, diagnose=diagnose, diagnosis=diagnosis,
        tsdb=tsdb, telemetry=telemetry, serve_http=serve_http,
        build_sharded_fleet=build_sharded_fleet, LLAMA2_350M=LLAMA2_350M,
        ReplicationSpec=ReplicationSpec, knowledge=knowledge.load,
        fleet_budget=lambda: json.loads(
            (BUDGETS / "fleet_budget.json").read_text()),
        telemetry_kw={"num_chips": per_host,
                      "accelerator": acc.device_name},
        gang_notebook=gang_notebook, add_gang_nodes=add_gang_nodes,
        gang_demand=gang_demand,
        view=lambda obj: Notebook(obj.to_dict()))


# every soak in the order of tests/test_chaos.py's classes
SOAKS = {
    "TestKnowledgeModel::test_model_parses_and_names_controllers":
        knowledge_names,
    "TestKnowledgeModel::test_managed_kinds_match_reality": knowledge_drift,
    "TestKnowledgeModel::test_steady_state_timeout_declared":
        knowledge_timeouts,
    "TestFaultInjection::test_kill_worker_pod_recovers": drill_kill_worker,
    "TestFaultInjection::test_failed_worker_degrades_then_restart_recovers":
        drill_fail_worker,
    "TestFaultInjection::test_delete_route_recreated": drill_delete_route,
    "TestChaosSoak::test_seeded_random_fault_soak": chaos_soak,
    "TestChaosSoak::test_trace_integrity_under_faults":
        trace_integrity_soak,
    "TestChaosSoak::test_soak_is_reproducible_for_a_seed": reproducible_plan,
    "TestSliceRecoverySoak::test_recovery_soak_with_failover": recovery_soak,
    "TestSliceRecoverySoak::test_permanent_failure_exhausts_exactly_at_cap":
        recovery_exhaustion,
    "TestMigrationRecoverySoak::test_seeded_migration_drill_restores_state":
        migration_soak,
    "TestMigrationRecoverySoak::"
    "test_failover_mid_migration_resumes_without_double_restore":
        migration_failover,
    "TestMigrationRecoverySoak::"
    "test_migrate_budget_shared_with_restart_exhausts_at_cap":
        migration_exhaustion,
    "TestPreemptionSoak::test_seeded_kill_points_resume_exactly_once":
        preemption_soak,
    "TestFailoverSoak::test_failover_soak_sub_second_promotions":
        failover_soak,
    "TestFlightRecorderDebugSoak::test_post_hoc_diagnosis_via_debug_endpoints":
        flight_recorder_soak,
    "TestFleetSLOSoak::test_fleet_slo_soak_end_to_end": fleet_slo_soak,
    "TestStragglerSoak::test_straggler_soak_attribution_and_clear":
        straggler_soak,
    "TestShardKillRejoinSoak::test_kill_rejoin_soak": shard_soak,
    "TestNoisyNeighborSoak::test_noisy_neighbor_soak_attribution_and_clear":
        noisy_neighbor_soak,
    "TestDiagnosisSoak::test_three_window_soak_names_every_injected_cause":
        diagnosis_soak,
}

__all__ = ["CENTRAL_NS", "FAULT_KINDS", "HOSTS", "SEED", "SOAKS",
           "SoakFailure", "port_stack"] + [f.__name__ for f in SOAKS.values()]
