"""Convergence benchmark: N notebooks -> all Ready, deterministically.

The port of the reference's loadtest/convergence.py on the port's
control plane, with `spec.gpu` gangs in the place of `spec.tpu` slices.
`start_notebooks.py` measures wall-clock readiness latency — useful, but
noisy and machine-dependent, so CI cannot assert on it.  This benchmark
measures what IS deterministic on the FakeClock: how much work the control
plane does to converge a fleet, and whether it then goes quiet.

    python -m kubeflow_tpu_torch.loadtest.convergence --count 200 \
        --compare-workers 8 --check-budget \
        kubeflow_tpu_torch/loadtest/budgets/apiserver_call_budget.json

Per run it reports:
  - wall time and reconciles/sec (informational by default; a budget may
    pin a generous wall-clock ceiling as a regression backstop);
  - reconciles per notebook, per controller (Manager reconcile counters);
  - event->reconcile-start reaction latency: exact p50/p99 over every
    event-caused reconcile (Manager.event_latency_samples);
  - API verbs by (verb, kind) from the ApiServer's top-level verb counters
    (reads included; the fault-exempt FakeCluster data plane is excluded)
    — per-kind write totals come from these, not the bounded audit ring,
    so they stay exact at 10k+ notebooks;
  - steady-state probe: after convergence, a full resync (`enqueue_all`)
    must complete with ZERO write verbs and at most one reconcile per
    (controller, object);
  - per-key serialization: the flight recorder's attempt-overlap check
    must come back empty (no two concurrent reconciles of one key);
  - SLO verdicts (utils/slo.py): each standing objective's met/violated
    state and end-of-run burn rate, recorded into the `--out` trajectory
    JSON — the same engine the manager serves at /debug/alerts.

`--gpu ACCEL:COUNT` (a key of gpu/topology.py's ACCELERATORS and a GPU
count that `resolve` accepts, e.g. h100-80gb:16 for two hosts of eight)
makes every notebook a GPU gang on nodes from `FakeCluster.add_gpu_nodes`;
without it the fleet is CPU notebooks.

`--compare-workers W` runs the same fleet again with W parallel workers
and asserts the normalized final cluster state (resourceVersions, uids,
timestamps, pod IPs scrubbed; uids rewritten to stable object references)
is identical to the single-worker run.

`--check-budget FILE` compares writes-per-notebook and
reconciles-per-notebook against the committed budget (budgets/ beside
this file) and fails on > `tolerance` regression — the deterministic CI
perf gate.  Regenerate an intentionally-changed budget with
`--write-budget FILE`.

Bursty mode (`--bursty N`) drives the gang scheduler + GPU warm pool
(core/scheduler.py) with a bursty arrival trace instead of one flood:
`--bursts` waves of N GPU notebooks, each wave stopped (the cull analog)
before the next so culling->reclamation resells the same gangs, with a
manager failover injected mid-run (pool bookkeeping and placement intents
must survive it).  It runs the trace twice — warm pool on
(`--warm-size`) and off — and prints p50/p99 notebook-ready time and
gang utilization for both; `--check-warm-budget FILE` gates the
comparison (warm p50 strictly below cold, minimum hit rate).  Gang
atomicity (never a partially placed gang; every gang co-located on one
node pool) is asserted at every wave's convergence.

Sharded mode (`--shards N`) runs the fleet over an N-replica
active-active control plane (main.build_sharded_fleet) with a kill and a
rejoin; `--sweep N1,N2,...` runs it (or the flat fleet) at each point
and names the knee of the wall-time curve.

Tenants mode (`--tenants N --noisy T`) runs N namespaces of placed GPU
notebooks and floods spec churn from tenant T while the others tick over
fairly: the metering ledger (utils/metering.py) must attribute the flood
to the exact namespace, fire exactly one deduped NoisyNeighbor Warning,
clear the flag after the flood stops, and keep GPU-second conservation
at zero violations; `--check-budget` gates the victim tenants' p99
event->reconcile against the `tenants` section of the budget JSON.

Priorities mode (`--priorities N`) floods an oversubscribed fleet with
low-priority gangs, then lands an N-gang high-priority burst through
checkpoint-then-preempt; `--check-budget` reads the `tenancy` section.
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from pathlib import Path

from ..api.types import GPUSpec, Notebook
from ..core import constants as C
from ..core.metrics import NotebookMetrics
from ..core.notebook_controller import setup_core_controllers
from ..kube import ApiServer, FakeCluster, KubeObject, Manager
from ..utils import tracing
from ..utils.clock import FakeClock
from ..utils.config import CoreConfig
from ..utils.flightrecorder import FlightRecorder
from ..utils.lifecycle import LifecycleLedger
from ..utils.metering import REASON_NOISY, TenantMeteringLedger
from ..utils.slo import SLOEngine, default_objectives
from ..utils.tsdb import TimeSeriesStore

NAMESPACE = "loadtest"
# the gang shapes the modes run when --gpu is not given: the reference's
# v5e 2x2 (one host of four chips) for tenants and priorities, and for
# the bursty trace four hosts, as its v5e 4x4
DEFAULT_TENANT_GPU = "h100-80gb:4"
DEFAULT_BURSTY_GPU = "h100-80gb:32"

# non-deterministic or server-managed fields scrubbed before comparing the
# final cluster state of two runs (uids are MAPPED, not dropped — ownership
# topology must still match)
_SCRUB_KEYS = frozenset({
    "resourceVersion", "creationTimestamp", "managedFields",
    "lastTransitionTime", "lastProbeTime", "startedAt", "startTime",
    "time", "podIP",
})


def normalized_state(api: ApiServer, pools: bool = False) -> dict:
    """api.dump() with volatile fields scrubbed and every uid replaced by
    the stable identity of the object it names, so two runs of the same
    fleet compare equal iff they converged to the same semantic state.

    `pools` reads a pod's `nodeName` as its node's pool: a gang fleet's
    nodes are interchangeable, and the fake scheduler binds first-fit in
    the order the workers happen to create the StatefulSets, so only the
    pool a gang landed on (co-location) is the control plane's to
    decide.  CPU fleets compare node names as they are."""
    dump = api.dump()
    uid_names: dict[str, str] = {}
    for kind, objs in dump.items():
        for o in objs:
            meta = o.get("metadata", {})
            if meta.get("uid"):
                uid_names[meta["uid"]] = "%s/%s/%s" % (
                    kind, meta.get("namespace", ""), meta.get("name", ""))
    if pools:
        node_pool = {
            n["metadata"]["name"]:
                "pool:" + (n["metadata"].get("labels") or {}).get(
                    C.GKE_NODEPOOL_LABEL, "")
            for n in dump.get("Node", ())}
        dump["Pod"] = [
            {**o, "spec": {**o["spec"], "nodeName": node_pool.get(
                o["spec"]["nodeName"], o["spec"]["nodeName"])}}
            if (o.get("spec") or {}).get("nodeName") else o
            for o in dump.get("Pod", ())]

    def scrub(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k in _SCRUB_KEYS:
                    continue
                if k == "uid" and isinstance(v, str):
                    out[k] = uid_names.get(v, v)
                else:
                    out[k] = scrub(v)
            return out
        if isinstance(node, list):
            return [scrub(x) for x in node]
        return node

    out = {}
    for kind, objs in sorted(dump.items()):
        if kind == "Event":
            continue  # event names/counts are sequencing artifacts
        out[kind] = sorted(
            (scrub(o) for o in objs),
            key=lambda o: (o["metadata"].get("namespace", ""),
                           o["metadata"]["name"]))
    return out


def _reconciles_per_controller(mgr: Manager) -> dict[str, int]:
    out: dict[str, int] = {}
    for key, v in mgr.reconcile_total.collect().items():
        out[key[0]] = out.get(key[0], 0) + int(v)
    return out


_WRITE_VERBS = ("create", "update", "patch", "delete")


def parse_gpu(gpu: str) -> GPUSpec:
    """`ACCEL:COUNT` -> a GPUSpec that gpu/topology.py resolves; a shape
    it refuses raises (never a quiet CPU fleet)."""
    accel, sep, count = gpu.partition(":")
    if not sep or not count.isdigit():
        raise ValueError(f"--gpu wants ACCEL:COUNT, got {gpu!r}")
    spec = GPUSpec(accel, int(count))
    spec.validate()
    return spec


def _create(api: ApiServer, nb: Notebook) -> None:
    api.create(KubeObject.from_dict(nb.obj))


def run_fleet(count: int, workers: int, gpu: str = "",
              compute_state: bool = True) -> dict:
    clock = FakeClock()
    # span/recorder timestamps must share the manager's FakeClock, or the
    # lifecycle ledger would attribute the wall-vs-fake clock skew to
    # queue_wait (cause stamps come from the manager clock, span times
    # from the tracer clock)
    tracing.set_clock(clock)
    try:
        return _run_fleet(count, workers, gpu, compute_state, clock)
    finally:
        tracing.set_clock(None)


def _run_fleet(count: int, workers: int, gpu: str,
               compute_state: bool, clock: FakeClock) -> dict:
    api = ApiServer()
    cluster = FakeCluster(api)
    recorder = FlightRecorder(capacity=max(4096, count * 8),
                              max_objects=max(2048, count * 4))
    mgr = Manager(api, clock=clock, workers=workers,
                  flight_recorder=recorder)
    cfg = CoreConfig.from_env({})  # hermetic: culling off, defaults only
    metrics = NotebookMetrics(api, manager=mgr)
    setup_core_controllers(mgr, cfg, metrics)
    # standing SLO verdicts ride the trajectory record (--out): the same
    # engine production runs under /debug/alerts, evaluated at run end
    slo_engine = SLOEngine(
        default_objectives(cfg),
        registries=[metrics.registry, mgr.metrics_registry],
        clock=clock, recorder=recorder)
    mgr.slo_engine = slo_engine
    metrics.attach_slo(slo_engine)
    # lifecycle stage ledger (critical-path attribution, conservation-
    # gated below) + in-process TSDB (the p99-vs-time curve a diagnose
    # bundle reconstructs offline); sized so EVERY notebook of the run is
    # conservation-checked, not just an LRU window
    ledger = LifecycleLedger(registry=metrics.registry,
                             max_notebooks=max(4096, count),
                             keep_conservation=max(4096, count))
    mgr.lifecycle = ledger
    metrics.attach_lifecycle(ledger)
    tsdb = TimeSeriesStore()
    mgr.tsdb = tsdb
    metrics.attach_tsdb(tsdb, clock=clock)
    # tenant metering ledger: one-tenant fleet here, but the dispatch
    # attribution + conservation contract is gated at 10k scale exactly
    # like the lifecycle ledger's (the --tenants mode covers multi-tenant)
    metering = TenantMeteringLedger(clock, registry=metrics.registry,
                                    max_notebooks=max(4096, count),
                                    keep_conservation=max(4096, count))
    mgr.metering = metering
    metrics.attach_metering(metering)

    spec = None
    if gpu:
        spec = parse_gpu(gpu)
        shape = spec.validate()
        cluster.add_gpu_nodes(spec.accelerator, shape.num_hosts * count,
                              shape.gpus_per_host)
    cluster.add_node("cpu-node", allocatable={"cpu": str(count * 8),
                                              "memory": "8192Gi"})
    expected_ready = spec.validate().num_hosts if spec else 1

    api.clear_audit_log()
    api.clear_verb_counts()
    # the flood arrives in batches, each settled and scraped, so the TSDB
    # holds a p99-vs-time curve (ready p99 climbing batch over batch) a
    # diagnose bundle can reconstruct offline — one monolithic settle
    # would leave a single point and no history
    n_batches = min(8, count) or 1
    t0 = time.perf_counter()
    rollout_reconciles_total = 0
    created = 0
    for b in range(n_batches):
        batch = count // n_batches + (1 if b < count % n_batches else 0)
        for i in range(created, created + batch):
            _create(api, Notebook.new(f"nb-{i:04d}", NAMESPACE, gpu=spec))
        created += batch
        rollout_reconciles_total += mgr.settle(max_seconds=7200.0)
        metrics.scrape()  # feeds one TSDB sample at this FakeClock instant
        if b < n_batches - 1:
            clock.advance(10.0)  # distinct timestamps across batches
    wall_s = time.perf_counter() - t0

    not_ready = []
    for i in range(count):
        status = api.get("Notebook", NAMESPACE,
                         f"nb-{i:04d}").body.get("status") or {}
        if status.get("readyReplicas") != expected_ready:
            not_ready.append(f"nb-{i:04d}")
    if not_ready:
        raise AssertionError(
            f"{len(not_ready)} notebooks never converged "
            f"(first: {not_ready[:3]})")
    if mgr.dropped_errors:
        raise AssertionError(f"retry budget exhausted: {mgr.dropped_errors}")

    rollout_reconciles = _reconciles_per_controller(mgr)
    rollout_verb_counts = api.verb_counts()
    rollout_verbs = {f"{verb}:{kind}": n
                     for (verb, kind), n in sorted(rollout_verb_counts.items())}
    # per-kind writes off the verb counters: the audit ring is bounded
    # (detail for chaos forensics), the counters are exact at any scale
    rollout_writes: dict[str, int] = {}
    for (verb, kind), n in rollout_verb_counts.items():
        if verb in _WRITE_VERBS:
            rollout_writes[kind] = rollout_writes.get(kind, 0) + n

    # steady-state probe: a full resync of a converged fleet must be
    # all-reads — zero write verbs (the counters share the audit's
    # client-boundary gate, so this is the same proof without the ring
    # bound) — and at most one reconcile per (controller, object) since
    # nothing re-triggers
    api.clear_verb_counts()
    before = _reconciles_per_controller(mgr)
    mgr.enqueue_all()
    mgr.settle(max_seconds=7200.0)
    after = _reconciles_per_controller(mgr)
    steady_write_verbs = {
        f"{verb}:{kind}": n
        for (verb, kind), n in sorted(api.verb_counts().items())
        if verb in _WRITE_VERBS}
    if steady_write_verbs:
        raise AssertionError(
            f"write verbs issued by a converged fleet: {steady_write_verbs}")
    steady_reconciles = {c: after.get(c, 0) - before.get(c, 0) for c in after}
    for controller, n in steady_reconciles.items():
        if n > count:
            raise AssertionError(
                f"steady-state resync re-reconciled {controller} {n} times "
                f"for {count} objects — the fleet is not quiet")

    overlaps = recorder.overlapping_attempts()
    if overlaps:
        a, b = overlaps[0]
        raise AssertionError(
            f"per-key serialization violated: {len(overlaps)} overlapping "
            f"attempt pairs (first: {a.controller} {a.object_key})")

    # conservation gate: every notebook's attributed stage durations must
    # sum to its measured event->ready wall time within tolerance — the
    # falsifiable contract of the lifecycle ledger (a double-count, gap
    # misclassification, or leak across retries breaks the equality)
    metrics.scrape()
    cons = ledger.conservation()
    if cons["finalized"] != count:
        raise AssertionError(
            f"lifecycle ledger finalized {cons['finalized']}/{count} "
            "notebooks — some never saw a ready event or were evicted")
    if cons["violations"]:
        first = ledger.violations()[:3]
        raise AssertionError(
            f"stage attribution broke conservation for "
            f"{cons['violations']}/{cons['checked']} notebooks "
            f"(tolerance {cons['tolerance']:.0%}, first: {first})")

    # tenant metering gate: the bucketed chip-second partition must
    # conserve (zero violations), and the workqueue attribution must have
    # actually landed on the owning namespace — a silent attribution miss
    # would leave the tenant table empty while everything else passes
    mcons = metering.conservation()
    if mcons["violations"]:
        raise AssertionError(
            f"tenant metering broke conservation for "
            f"{mcons['violations']}/{mcons['checked']} placement intervals "
            f"(first: {metering.violations()[:3]})")
    mtable = metering.tenant_table()
    if mtable.get(NAMESPACE, {}).get("dispatches", 0) <= 0:
        raise AssertionError(
            "tenant metering attributed no workqueue dispatches to the "
            f"{NAMESPACE!r} namespace")

    # event->reconcile-start reaction latency (wall clock; the FakeClock
    # collapses the deterministic histogram to ~0 in this harness): exact
    # percentiles over every event-caused reconcile of the run
    latency = mgr.event_latency_samples()
    dispatch = {f"{kind}:{result}": n
                for (kind, result), n in
                sorted(api.watch_dispatch_counts().items())}

    result = {
        "count": count,
        "notebooks": count,
        "workers": workers,
        "gpu": gpu or "cpu",
        "wall_s": round(wall_s, 3),
        # process high-water RSS in MB, as the sharded fleet reports it
        "peak_rss_mb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0,
            1),
        "rollout_reconciles_total": rollout_reconciles_total,
        "reconciles_per_sec": round(rollout_reconciles_total / wall_s, 1)
        if wall_s > 0 else 0.0,
        "reconciles_per_notebook": {
            c: round(n / count, 3) for c, n in rollout_reconciles.items()},
        "writes_per_notebook": {
            k: round(n / count, 3) for k, n in sorted(rollout_writes.items())},
        "p50_event_to_reconcile_s": round(_percentile(latency, 0.50), 6),
        "p99_event_to_reconcile_s": round(_percentile(latency, 0.99), 6),
        "event_to_reconcile_samples": len(latency),
        "api_verbs": rollout_verbs,
        "watch_dispatch": dispatch,
        "steady_reconciles": steady_reconciles,
        "steady_write_verbs": 0,
        "cache": mgr.cache.stats() if mgr.cache is not None else {},
        # objective -> met/violated + burn rate at end of run (utils/slo):
        # the trajectory record carries a standing SLO verdict, not just
        # raw percentiles
        "slo": slo_engine.verdicts(),
        # per-stage critical-path attribution + the conservation verdict
        # (utils/lifecycle): where event->ready time actually went
        "criticalpath": {
            "ranking": ledger.ranking(),
            "conservation": cons,
        },
        # the diagnosis engine's sweep contract: each point names the
        # stage that dominates its event->ready attribution
        "binding_stage": (ledger.ranking()[0]["stage"]
                          if ledger.ranking() else ""),
        # tenant metering verdict (utils/metering): the chip-second
        # partition's conservation summary + attribution totals
        "tenants": {
            "conservation": mcons,
            "attributed_dispatches":
                mtable.get(NAMESPACE, {}).get("dispatches", 0),
            "attributed_apiserver":
                mtable.get(NAMESPACE, {}).get("apiserver_total", 0),
        },
        # TSDB inventory: the per-batch p99-vs-time history a diagnose
        # bundle captures in full (/debug/timeline?dump=1)
        "timeline_series": sorted(tsdb.series_names()),
    }
    _print_criticalpath(f"{count} notebooks ({gpu or 'cpu'})",
                        ledger.ranking())
    if compute_state:
        result["_state"] = normalized_state(api, pools=bool(gpu))
    mgr.stop()
    return result


def _print_criticalpath(tag: str, ranking: list) -> None:
    """The fleet-wide critical-path table (stderr; stdout carries the
    machine-readable result JSON): which lifecycle stage the fleet
    actually spent its event->ready time in, ranked."""
    print(f"critical path [{tag}]:", file=sys.stderr)
    if not ranking:
        print("  (no stage time attributed — instantaneous "
              "convergence on the fake clock)", file=sys.stderr)
        return
    print(f"  {'stage':<16} {'count':>7} {'total_s':>10} {'mean_s':>9} "
          f"{'p99_s':>9} {'share':>7}", file=sys.stderr)
    for r in ranking:
        print(f"  {r['stage']:<16} {r['count']:>7} {r['total_s']:>10.3f} "
              f"{r['mean_s']:>9.4f} {r['p99_s']:>9.4f} "
              f"{r['share']:>6.1%}", file=sys.stderr)


def _percentile(values: list[float], q: float) -> float:
    """Exact q-percentile (nearest-rank) of measured ready times."""
    if not values:
        return 0.0
    ordered = sorted(values)
    import math

    idx = min(len(ordered) - 1, max(0, math.ceil(q * len(ordered)) - 1))
    return ordered[idx]


def _audit_gang(api: ApiServer, shape) -> None:
    """Gang atomicity + co-location: every GPU gang (one a replica) has
    either all of its workers bound or none, and all bound workers of one
    gang sit on nodes of ONE node pool (the scheduler's placement intent,
    honored)."""
    by_gang: dict[tuple[str, str, str], list] = {}
    for pod in api.list("Pod"):
        nb = pod.metadata.labels.get(C.NOTEBOOK_NAME_LABEL)
        if nb is None:
            continue
        gang = pod.metadata.labels.get(C.REPLICA_LABEL, "0")
        by_gang.setdefault((pod.namespace, nb, gang), []).append(pod)
    for (ns, nb, gang), pods in sorted(by_gang.items()):
        bound = [p for p in pods if p.spec.get("nodeName")]
        if len(bound) not in (0, shape.num_hosts):
            raise AssertionError(
                f"gang atomicity violated: {ns}/{nb} gang {gang} has "
                f"{len(bound)}/{shape.num_hosts} workers bound")
        pools = set()
        for p in bound:
            node = api.try_get("Node", "", p.spec["nodeName"])
            pools.add(None if node is None
                      else node.metadata.labels.get(C.GKE_NODEPOOL_LABEL))
        if bound and len(pools) != 1:
            raise AssertionError(
                f"co-location violated: {ns}/{nb} gang {gang} spans "
                f"pools {sorted(str(p) for p in pools)}")


def _audit_pool_bookkeeping(api: ApiServer) -> None:
    """Claim consistency: no warm-pool entry claimed twice for one
    notebook gang, no claim pointing at a missing notebook, and every
    placed (annotated) notebook backed by exactly its claims."""
    from ..core.scheduler import placement_of

    claims: dict[tuple[str, int], str] = {}
    for pool in api.list(C.WARMPOOL_KIND):
        slices = pool.body.get("status", {}).get("slices") or {}
        for sid, e in slices.items():
            claimant = e.get("claimedBy")
            if not claimant:
                continue
            ckey = (claimant, e.get("claimedSlice"))
            if ckey in claims:
                raise AssertionError(
                    f"double claim: {ckey} held by {claims[ckey]} and {sid}")
            claims[ckey] = sid
            ns, _, name = claimant.partition("/")
            if api.try_get("Notebook", ns, name) is None:
                raise AssertionError(f"orphan claim {sid} -> {claimant}")
    for nb in api.list("Notebook"):
        if not nb.spec.get("gpu"):
            continue
        placed = placement_of(nb.metadata.annotations)
        if not placed:
            continue
        key = f"{nb.namespace}/{nb.name}"
        gangs = int((nb.spec.get("replication") or {}).get("replicas", 1))
        for i in range(gangs):
            if (key, i) not in claims:
                raise AssertionError(
                    f"placement intent of {key} gang {i} has no backing "
                    "claim")


def run_bursty(count: int, bursts: int, gap_s: float, gpu: str,
               warm_size: int, provision_s: float = 120.0,
               failover: bool = True) -> dict:
    """One bursty-arrival run of the gang scheduler: `bursts` waves of
    `count` GPU notebooks, each wave stopped (culled) before the next so
    reclamation resells its gangs, a manager failover between waves 1
    and 2, and exact per-notebook ready-time measurement off the
    FakeClock."""
    clock = FakeClock()
    tracing.set_clock(clock)  # span times share the harness clock
    try:
        return _run_bursty(count, bursts, gap_s, gpu, warm_size,
                           provision_s, failover, clock)
    finally:
        tracing.set_clock(None)


def _run_bursty(count: int, bursts: int, gap_s: float, gpu: str,
                warm_size: int, provision_s: float, failover: bool,
                clock: FakeClock) -> dict:
    from ..kube import retry_on_conflict

    spec = parse_gpu(gpu)
    shape = spec.validate()
    env = {
        "ENABLE_SLICE_SCHEDULER": "true",
        "WARMPOOL_SIZE": str(warm_size),
        "WARMPOOL_SHAPES": f"{spec.accelerator}:{spec.count}"
        if warm_size else "",
        "WARMPOOL_PROVISION_S": f"{provision_s:g}",
    }
    api = ApiServer()
    cluster = FakeCluster(api)
    # ONE ledger across the failover: the replacement manager adopts the
    # same stage history, so conservation must survive the handoff (a
    # leaked or double-counted stage across managers breaks the gate)
    ledger = LifecycleLedger(max_notebooks=max(4096, count * bursts),
                             keep_conservation=max(4096, count * bursts))

    def build() -> tuple[Manager, NotebookMetrics]:
        mgr = Manager(api, clock=clock,
                      flight_recorder=FlightRecorder(
                          capacity=max(4096, count * bursts * 8),
                          max_objects=max(2048, count * bursts * 4)))
        cfg = CoreConfig.from_env(env)
        metrics = NotebookMetrics(api, manager=mgr)
        mgr.lifecycle = ledger
        metrics.attach_lifecycle(ledger)
        setup_core_controllers(mgr, cfg, metrics, provisioner=cluster)
        return mgr, metrics

    mgr, metrics = build()
    mgr.settle(max_seconds=provision_s * 4 + 60)  # pre-warm the pool

    expected_ready = shape.num_hosts
    ready_s: dict[str, float] = {}
    utilization: list[float] = []

    def drain_until_ready(pending: dict[str, float],
                          deadline_s: float) -> None:
        deadline = clock.now() + deadline_s
        while True:
            mgr.run_until_idle()
            for name in list(pending):
                status = api.get("Notebook", NAMESPACE,
                                 name).body.get("status") or {}
                if status.get("readyReplicas") == expected_ready:
                    ready_s[name] = clock.now() - pending.pop(name)
            if not pending:
                return
            due = [d for (_, _, d) in mgr.pending_delayed()]
            if not due or min(due) > deadline:
                raise AssertionError(
                    f"{len(pending)} notebooks unready past the deadline "
                    f"(first: {sorted(pending)[:3]})")
            delta = min(due) - clock.now()
            if delta > 0:
                clock.advance(delta)

    def stop_and_release(names: list[str]) -> None:
        for name in names:
            def stop() -> None:
                live = api.get("Notebook", NAMESPACE, name)
                live.metadata.annotations[C.STOP_ANNOTATION] = "true"
                api.update(live)
            retry_on_conflict(stop)
        mgr.settle(max_seconds=gap_s)
        for name in names:
            live = api.get("Notebook", NAMESPACE, name)
            health = (live.body.get("status") or {}).get("sliceHealth")
            if health != "Stopped":
                raise AssertionError(f"{name} failed to stop: {health}")
            if C.ANNOTATION_PLACEMENT in live.metadata.annotations:
                raise AssertionError(
                    f"{name} stopped but its gang was never reclaimed")

    for b in range(bursts):
        if b == 1 and failover:
            # manager failover mid-run: a fresh manager over the same
            # store must resume claims/intents, never re-derive them
            mgr.stop()
            mgr, metrics = build()
            mgr.enqueue_all()
            mgr.settle(max_seconds=60)
        names = [f"nb-b{b}-{i:04d}" for i in range(count)]
        t0 = clock.now()
        for name in names:
            _create(api, Notebook.new(name, NAMESPACE, gpu=spec))
        drain_until_ready({n: t0 for n in names},
                          deadline_s=provision_s * 4 + 600)
        _audit_gang(api, shape)
        _audit_pool_bookkeeping(api)
        # gang utilization at wave convergence: claimed warm gangs over
        # warm gangs currently up (Ready or Claimed)
        claimed = up = 0
        for pool in api.list(C.WARMPOOL_KIND):
            for e in (pool.body.get("status", {}).get("slices")
                      or {}).values():
                if e.get("external"):
                    continue
                if e.get("state") == C.WARMSLICE_CLAIMED:
                    claimed += 1
                    up += 1
                elif e.get("state") == C.WARMSLICE_READY:
                    up += 1
        utilization.append(round(claimed / up, 3) if up else 1.0)
        stop_and_release(names)
        _audit_pool_bookkeeping(api)

    hits = misses = bypass = 0
    for pool in api.list(C.WARMPOOL_KIND):
        st = pool.body.get("status") or {}
        hits += int(st.get("hits", 0))
        misses += int(st.get("misses", 0))
        bypass += int(st.get("bypass", 0))
    served = hits + misses + bypass
    values = list(ready_s.values())
    cons = ledger.conservation()
    if cons["violations"]:
        raise AssertionError(
            f"bursty stage attribution broke conservation for "
            f"{cons['violations']}/{cons['checked']} notebooks "
            f"(first: {ledger.violations()[:3]})")
    _print_criticalpath(
        "%d notebooks %s (%s)" % (count * bursts, gpu,
                                  "warm" if warm_size else "cold"),
        ledger.ranking())
    mgr.stop()
    return {
        "mode": "warm" if warm_size else "cold",
        "notebooks": count * bursts,
        "bursts": bursts,
        "warm_size": warm_size,
        "failover": failover,
        "hits": hits,
        "misses": misses,
        "bypass": bypass,
        "hit_rate": round(hits / served, 3) if served else 0.0,
        "ready_p50_s": round(_percentile(values, 0.50), 3),
        "ready_p99_s": round(_percentile(values, 0.99), 3),
        "ready_max_s": round(max(values), 3) if values else 0.0,
        "slice_utilization": utilization,
        "ready_histogram_count":
            metrics.notebook_ready_seconds.count_value(NAMESPACE),
        "criticalpath": {
            "ranking": ledger.ranking(),
            "conservation": cons,
        },
    }


def run_sharded_fleet(count: int, shards: int = 3,
                      kill_shard: bool = True) -> dict:
    """Active-active convergence benchmark: `count` notebooks over a
    `shards`-replica sharded control plane (kube/shard.py via
    main.build_sharded_fleet), then a kill + rejoin cycle mid-run.
    Measures rollout wall time, merged p99 event->reconcile-start,
    merged reconciles/notebook, ring balance, and handoff durations —
    and PROVES the run: zero cross-process overlapping reconciles over
    the merged flight-recorder histories, zero data-plane writes from a
    converged fleet (shard-map lease renewals are the protocol's
    heartbeat and are accounted separately), every zombie write
    fenced."""
    clock = FakeClock()
    tracing.set_clock(clock)  # align span times with the fleet clock
    try:
        return _run_sharded_fleet(count, shards, kill_shard, clock)
    finally:
        tracing.set_clock(None)


def _shard_namespace_count(count: int, shards: int) -> int:
    """Tenant namespaces for the sharded benchmark.  Ring placement is
    namespace-affine (kube/shard.py), and the Kubeflow deployment model
    is a namespace per user profile — so the keyspace must arrive as
    many namespaces for the ring to spread it: enough that balance noise
    stays small (>= 8 per shard), capped so namespace bookkeeping never
    dominates a 100k run."""
    return max(8 * shards, min(1024, count // 8)) or 1


def _run_sharded_fleet(count: int, shards: int, kill_shard: bool,
                       clock: FakeClock) -> dict:
    from ..kube.shard import SHARD_MAP_KIND
    from ..main import build_sharded_fleet

    cfg = CoreConfig.from_env({})  # hermetic: culling off, defaults only
    # the shared lifecycle ledger must hold every pending notebook of the
    # flood, or conservation can't be checked fleet-wide
    cfg.lifecycle_max_notebooks = max(cfg.lifecycle_max_notebooks, count)
    fleet, api, cluster, metrics = build_sharded_fleet(
        core_cfg=cfg, count=shards, clock=clock)
    ledger = metrics.lifecycle  # ONE ledger shared across all replicas
    cluster.add_node("cpu-node", allocatable={"cpu": str(count * 8),
                                              "memory": "8192Gi"})

    n_ns = _shard_namespace_count(count, shards)
    nb_keys = [(f"u{i % n_ns:04d}", f"nb-{i:04d}") for i in range(count)]

    def assert_converged(tag: str) -> None:
        not_ready = [name for ns, name in nb_keys
                     if (api.get("Notebook", ns,
                                 name).body.get("status") or {}
                         ).get("readyReplicas") != 1]
        if not_ready:
            raise AssertionError(
                f"{tag}: {len(not_ready)} notebooks never converged "
                f"(first: {not_ready[:3]})")

    # the flood arrives in batches, and each batch sits in the queue for
    # a deterministic beat before the fleet drains it — the only
    # fake-clock duration a hermetic rollout accrues, so the lifecycle
    # ledger has stage time to attribute and the sweep's binding_stage
    # contract has a stage to name (queue_wait, by construction)
    n_batches = min(4, count) or 1
    t0 = time.perf_counter()
    rollout_reconciles_total = 0
    created = 0
    for b in range(n_batches):
        batch = count // n_batches + (1 if b < count % n_batches else 0)
        for i in range(created, created + batch):
            ns, name = nb_keys[i]
            _create(api, Notebook.new(name, ns))
        created += batch
        clock.advance(2.0)  # queue dwell (well under the shard lease)
        rollout_reconciles_total += fleet.settle()
        metrics.scrape()  # one TSDB sample per batch at this instant
    rollout_wall_s = time.perf_counter() - t0
    assert_converged("rollout")

    # conservation gate over the SHARED ledger: attempts from every
    # replica (and handoff waits between them) must still partition each
    # notebook's event->ready window exactly
    cons = ledger.conservation()
    if cons["finalized"] != count:
        raise AssertionError(
            f"sharded lifecycle ledger finalized {cons['finalized']}/"
            f"{count} notebooks")
    if cons["violations"]:
        raise AssertionError(
            f"sharded stage attribution broke conservation for "
            f"{cons['violations']}/{cons['checked']} notebooks "
            f"(first: {ledger.violations()[:3]})")

    snap = fleet.shard_snapshot()
    owned = {sid: r["keys_owned"]
             for sid, r in snap["replicas"].items() if r["alive"]}
    if sum(owned.values()) != count:
        raise AssertionError(
            f"ring does not partition the keyspace: {owned} "
            f"(want sum == {count})")

    # kill one replica, let survivors evict + adopt, then rejoin it —
    # the handoff path under the same measurement harness
    killed = ""
    handoff_wall_s = 0.0
    if kill_shard and shards > 1:
        killed = sorted(owned)[0]
        t1 = time.perf_counter()
        fleet.kill(killed)
        for _ in range(3):  # sub-lease steps: only the dead lease ages
            clock.advance(fleet.lease_duration_s * 0.55)
            fleet.settle()
        if killed in fleet.shard_snapshot()["members"]:
            raise AssertionError(f"dead shard {killed} never evicted")
        fleet.rejoin(killed)
        fleet.settle()
        handoff_wall_s = time.perf_counter() - t1
        assert_converged("kill/rejoin")

    # steady-state probe: a converged sharded fleet must issue ZERO
    # data-plane writes on a full resync — only the shard map moves
    # (member lease renewals), and that traffic is reported, not hidden
    api.clear_verb_counts()
    for r in fleet.alive_replicas():
        r.manager.enqueue_all()
    fleet.settle()
    steady_writes = {
        f"{verb}:{kind}": n
        for (verb, kind), n in sorted(api.verb_counts().items())
        if verb in _WRITE_VERBS or verb.endswith("_status")}
    heartbeat = {k: n for k, n in steady_writes.items()
                 if k.endswith(":" + SHARD_MAP_KIND)}
    data_plane = {k: n for k, n in steady_writes.items()
                  if not k.endswith(":" + SHARD_MAP_KIND)}
    if data_plane:
        raise AssertionError(
            f"write verbs issued by a converged sharded fleet: "
            f"{data_plane}")

    overlaps = fleet.cross_process_overlaps()
    if overlaps:
        a, b = overlaps[0]
        raise AssertionError(
            f"cross-process serialization violated: {len(overlaps)} "
            f"overlapping pairs (first: {a.controller} {a.object_key})")

    reconciles: dict[str, int] = {}
    latency: list[float] = []
    for r in fleet.replicas.values():
        for ctrl, n in _reconciles_per_controller(r.manager).items():
            reconciles[ctrl] = reconciles.get(ctrl, 0) + n
        latency.extend(r.manager.event_latency_samples())
    final = fleet.shard_snapshot()
    result = {
        "count": count,
        "notebooks": count,
        "namespaces": n_ns,
        "shards": shards,
        "wall_s": round(rollout_wall_s, 3),
        "handoff_wall_s": round(handoff_wall_s, 3),
        "killed_shard": killed,
        # process high-water RSS (ru_maxrss is KB on Linux).  Monotone
        # over the process lifetime: in a sweep, each point's figure
        # includes every smaller point before it — the trend to read is
        # the growth between points, not the absolute per point.
        "peak_rss_mb": round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0,
            1),
        # shard-map RMW optimistic-concurrency losses (409s retried with
        # backoff) — membership contention, the livelock trend
        "shard_map_rmw_conflicts": fleet.rmw_conflicts(),
        "epoch": final["epoch"],
        "rollout_reconciles_total": rollout_reconciles_total,
        "reconciles_per_notebook": {
            c: round(n / count, 3) for c, n in sorted(reconciles.items())},
        "keys_owned": owned,
        "p50_event_to_reconcile_s": round(_percentile(latency, 0.50), 6),
        "p99_event_to_reconcile_s": round(_percentile(latency, 0.99), 6),
        "event_to_reconcile_samples": len(latency),
        "handoff_durations_s": [
            round(d, 3) for r in fleet.replicas.values()
            for d in r.handoff_durations],
        "fenced_rejections": sum(
            r["fenced_rejections"]
            for r in final["replicas"].values()),
        "cross_process_overlaps": 0,
        "steady_data_plane_writes": 0,
        "steady_heartbeat_writes": sum(heartbeat.values()),
        "criticalpath": {
            "ranking": ledger.ranking(),
            "conservation": ledger.conservation(),
        },
        # the diagnosis engine's sweep contract: each point names the
        # stage that dominates its event->ready attribution
        "binding_stage": (ledger.ranking()[0]["stage"]
                          if ledger.ranking() else ""),
    }
    metrics.scrape()  # post-kill/rejoin TSDB sample (clock moved on)
    _print_criticalpath(f"{count} notebooks x {shards} shards",
                        ledger.ranking())
    for r in fleet.replicas.values():
        r.manager.stop()
    return result


_TOUCH_ANNOTATION = "loadtest.kubeflow.org/touch"


def run_tenants(tenants: int, per_tenant: int, noisy: int, gpu: str,
                baseline_rounds: int = 18, flood_rounds: int = 6,
                flood_factor: int = 50, victim_delay_s: float = 2.5,
                recovery_rounds: int = 18,
                provision_s: float = 60.0) -> dict:
    """Adversarial multi-tenant run: `tenants` namespaces of `per_tenant`
    placed GPU notebooks each, tenant index `noisy` floods the control
    plane with spec churn while every other tenant's events queue behind
    the backlog.  Asserts the metering ledger's verdict end to end: the
    flood is attributed to the EXACT flooding namespace, exactly one
    deduped Warning event fires naming it, the flag clears once the flood
    stops, and GPU-second conservation holds for every tenant
    throughout."""
    clock = FakeClock()
    tracing.set_clock(clock)  # span times share the harness clock
    try:
        return _run_tenants(tenants, per_tenant, noisy, gpu,
                            baseline_rounds, flood_rounds, flood_factor,
                            victim_delay_s, recovery_rounds, provision_s,
                            clock)
    finally:
        tracing.set_clock(None)


def _run_tenants(tenants: int, per_tenant: int, noisy: int, gpu: str,
                 baseline_rounds: int, flood_rounds: int, flood_factor: int,
                 victim_delay_s: float, recovery_rounds: int,
                 provision_s: float, clock: FakeClock) -> dict:
    from ..kube import EventRecorder, retry_on_conflict

    if tenants < 2:
        raise ValueError("--tenants needs at least 2 namespaces "
                         "(fair share is undefined for one tenant)")
    spec = parse_gpu(gpu)
    shape = spec.validate()
    total = tenants * per_tenant
    env = {
        "ENABLE_SLICE_SCHEDULER": "true",
        "WARMPOOL_SIZE": str(total),
        "WARMPOOL_SHAPES": f"{spec.accelerator}:{spec.count}",
        "WARMPOOL_PROVISION_S": f"{provision_s:g}",
    }
    api = ApiServer()
    cluster = FakeCluster(api)
    mgr = Manager(api, clock=clock,
                  flight_recorder=FlightRecorder(
                      capacity=max(4096, total * 8),
                      max_objects=max(2048, total * 4)))
    cfg = CoreConfig.from_env(env)
    metrics = NotebookMetrics(api, manager=mgr)
    setup_core_controllers(mgr, cfg, metrics, provisioner=cluster)
    slo_engine = SLOEngine(
        default_objectives(cfg),
        registries=[metrics.registry, mgr.metrics_registry],
        clock=clock)
    mgr.slo_engine = slo_engine
    metrics.attach_slo(slo_engine)
    mgr.settle(max_seconds=provision_s * 4 + 60)  # pre-warm the pool

    namespaces = [f"tenant-{i}" for i in range(tenants)]
    noisy_ns = namespaces[noisy % tenants]
    victims = [ns for ns in namespaces if ns != noisy_ns]
    names = [f"nb-{i:03d}" for i in range(per_tenant)]
    expected_ready = shape.num_hosts

    pending: dict[tuple[str, str], float] = {}
    t0 = clock.now()
    for ns in namespaces:
        for name in names:
            _create(api, Notebook.new(name, ns, gpu=spec))
            pending[(ns, name)] = t0
    deadline = clock.now() + provision_s * 4 + 600
    while pending:
        mgr.run_until_idle()
        for ns, name in list(pending):
            status = api.get("Notebook", ns, name).body.get("status") or {}
            if status.get("readyReplicas") == expected_ready:
                pending.pop((ns, name))
        if not pending:
            break
        due = [d for (_, _, d) in mgr.pending_delayed()]
        if not due or min(due) > deadline:
            raise AssertionError(
                f"{len(pending)} tenant notebooks unready past the "
                f"deadline (first: {sorted(pending)[:3]})")
        delta = min(due) - clock.now()
        if delta > 0:
            clock.advance(delta)

    # attach metering only NOW: the detector's baselines must latch from
    # post-convergence benign traffic, not the provisioning transient
    # (whose requeue waits would inflate every tenant's "normal" p99)
    metering = TenantMeteringLedger(
        clock, registry=metrics.registry,
        recorder=EventRecorder(api, "tenant-metering"),
        max_tenants=max(tenants + 8, 16),
        max_notebooks=max(4096, total),
        keep_conservation=max(4096, total),
        slo_engine=slo_engine)
    mgr.metering = metering
    metrics.attach_metering(metering)

    def touch(ns: str) -> None:
        """One spec-churn tick for every notebook of `ns` (annotation
        bump -> update -> event -> reconcile: the smallest unit of
        attributable control-plane work)."""
        for name in names:
            def bump() -> None:
                live = api.get("Notebook", ns, name)
                n = int(live.metadata.annotations.get(_TOUCH_ANNOTATION,
                                                      "0"))
                live.metadata.annotations[_TOUCH_ANNOTATION] = str(n + 1)
                api.update(live)
            retry_on_conflict(bump)

    # benign phase: every tenant ticks over at the same rate — baselines
    # latch low, the rolling control-plane windows fill with fair traffic
    for _ in range(baseline_rounds):
        for ns in namespaces:
            touch(ns)
        mgr.settle(max_seconds=60)
        clock.advance(10.0)  # chip-seconds accrue between samples
        metrics.scrape()     # sample + ingest + evaluate (fair verdict)
    if metering.flagged():
        raise AssertionError(
            f"fair traffic flagged tenants {metering.flagged()} — the "
            "detector fired with no noisy neighbor")

    # flood phase: victims' events are stamped, then the clock advances by
    # the backlog delay before the queue drains (their e2r degrades), and
    # the noisy tenant churns specs flood_factor times per round
    for _ in range(flood_rounds):
        for ns in victims:
            touch(ns)
        clock.advance(victim_delay_s)
        mgr.settle(max_seconds=60)
        for _ in range(flood_factor):
            touch(noisy_ns)
            mgr.settle(max_seconds=60)
        metrics.scrape()
    flagged_flood = metering.flagged()
    if flagged_flood != [noisy_ns]:
        raise AssertionError(
            f"flood attribution wrong: flagged {flagged_flood}, "
            f"want exactly [{noisy_ns!r}]")
    warnings = [e for e in api.list("Event")
                if e.body.get("reason") == REASON_NOISY]
    if len(warnings) != 1:
        raise AssertionError(
            f"{len(warnings)} {REASON_NOISY} Warning events exist, want "
            "exactly one (EventRecorder dedup must aggregate re-fires)")
    involved = (warnings[0].body.get("involvedObject") or {}).get("name")
    if involved != noisy_ns:
        raise AssertionError(
            f"{REASON_NOISY} warning names {involved!r}, want {noisy_ns!r}")

    # recovery phase: the flood stops; once its deltas roll out of the
    # control-plane window the tenant's share drops and the flag clears
    for _ in range(recovery_rounds):
        for ns in namespaces:
            touch(ns)
        mgr.settle(max_seconds=60)
        clock.advance(10.0)
        metrics.scrape()
    if metering.flagged():
        raise AssertionError(
            f"flag never cleared after the flood stopped: "
            f"{metering.flagged()}")

    table = metering.tenant_table()
    cons = metering.conservation()
    if cons["violations"]:
        raise AssertionError(
            f"tenant metering broke conservation for "
            f"{cons['violations']}/{cons['checked']} placement intervals "
            f"(first: {metering.violations()[:3]})")
    if cons["checked"] < total:
        raise AssertionError(
            f"metering conservation checked only {cons['checked']}/{total} "
            "placement intervals — some placed notebooks were never "
            "metered")
    if not table.get(noisy_ns, {}).get("last_trace"):
        raise AssertionError(
            f"no exemplar trace latched for {noisy_ns} — a fired fairness "
            "alert would not resolve at /debug/traces")
    _print_tenants(table, noisy_ns)
    mgr.stop()
    victim_p99s = {ns: table[ns]["e2r_p99_recent_s"] for ns in victims}
    return {
        "mode": "tenants",
        "tenants": tenants,
        "per_tenant": per_tenant,
        "notebooks": total,
        "gpu": gpu,
        "noisy_tenant": noisy_ns,
        "flagged_during_flood": flagged_flood,
        "flagged_final": metering.flagged(),
        "noisy_warning_events": len(warnings),
        "noisy_fired_total": table[noisy_ns]["fired_total"],
        "victim_p99_event_to_reconcile_s":
            round(max(victim_p99s.values()), 6),
        "per_tenant_p99_s": {
            ns: round(table[ns]["e2r_p99_recent_s"], 6)
            for ns in namespaces},
        "chip_seconds": {
            ns: round(table[ns]["chip_seconds_total"], 3)
            for ns in namespaces},
        "control_units": {
            ns: table[ns]["apiserver_total"] + table[ns]["dispatches"]
            for ns in namespaces},
        "conservation": cons,
        "slo": slo_engine.verdicts(),
    }


def _print_tenants(table: dict, noisy_ns: str) -> None:
    """The per-tenant usage table (stderr; stdout carries the result
    JSON): who used the GPUs and the control plane, and who got
    flagged."""
    print("tenant usage:", file=sys.stderr)
    print(f"  {'tenant':<12} {'chip_s':>10} {'dispatches':>10} "
          f"{'api_reqs':>9} {'p99_e2r_s':>10} {'baseline_s':>10} "
          f"{'flagged':>8}", file=sys.stderr)
    for ns, row in sorted(table.items()):
        mark = " <- noisy" if ns == noisy_ns else ""
        baseline = row["e2r_p99_baseline_s"]
        print(f"  {ns:<12} {row['chip_seconds_total']:>10.1f} "
              f"{row['dispatches']:>10} {row['apiserver_total']:>9} "
              f"{row['e2r_p99_recent_s']:>10.4f} "
              f"{(baseline if baseline is not None else -1.0):>10.4f} "
              f"{str(row['flagged']):>8}{mark}", file=sys.stderr)


def run_priorities(high_gangs: int, benign: int, per_tenant: int,
                   flood: int, gpu: str,
                   provision_s: float = 3600.0) -> dict:
    """Adversarial tenancy run: a low-priority batch tenant
    floods an oversubscribed fleet past its chip quota, then a
    high-priority burst arrives with zero free capacity.  The flood must
    queue (never place, never hold claims), the burst must land within
    the time-to-placement ceiling by evicting ONLY checkpointed
    low-priority victims — benign standard tenants untouched, zero
    checkpointless teardowns — and once the burst drains every victim
    must restore its session byte-for-byte (digest) from the secured
    checkpoint: preemption moves work, it never loses state."""
    clock = FakeClock()
    tracing.set_clock(clock)
    try:
        return _run_priorities(high_gangs, benign, per_tenant, flood,
                               gpu, provision_s, clock)
    finally:
        tracing.set_clock(None)


def _run_priorities(high_gangs: int, benign: int, per_tenant: int,
                    flood: int, gpu: str, provision_s: float,
                    clock: FakeClock) -> dict:
    from ..core.preemption import new_quota_object
    from ..core.sessionstate import InMemorySessionStore

    if high_gangs < 1 or benign < 1 or flood < 1:
        raise ValueError("--priorities needs >=1 high gang, >=1 benign "
                         "tenant and >=1 flood gang")
    spec = parse_gpu(gpu)
    shape = spec.validate()
    # capacity fits the benign tenants plus exactly high_gangs
    # low-priority victims-in-waiting: the burst can ONLY land by
    # evicting; cold provisioning (1h) never bails it out in-run
    capacity_slices = benign * per_tenant + high_gangs
    env = {
        "ENABLE_SLICE_SCHEDULER": "true",
        "WARMPOOL_SIZE": "0",
        "WARMPOOL_PROVISION_S": f"{provision_s:g}",
        "SLO_PLACEMENT_P99_S": "120",
    }
    api = ApiServer()
    cluster = FakeCluster(api)
    cluster.add_gpu_nodes(spec.accelerator,
                          capacity_slices * shape.num_hosts,
                          shape.gpus_per_host)
    mgr = Manager(api, clock=clock,
                  flight_recorder=FlightRecorder(capacity=8192,
                                                 max_objects=2048))
    cfg = CoreConfig.from_env(env)
    metrics = NotebookMetrics(api, manager=mgr)
    store = InMemorySessionStore(clock=clock)
    cluster.attach_session_store(store)
    setup_core_controllers(mgr, cfg, metrics, session=store,
                           provisioner=cluster)
    slo_engine = SLOEngine(
        default_objectives(cfg),
        registries=[metrics.registry, mgr.metrics_registry],
        clock=clock)
    mgr.slo_engine = slo_engine
    metrics.attach_slo(slo_engine)

    # hard chip quota pins the batch tenant to its placed share: the
    # flood queues on quota, not on a capacity accident
    quota = new_quota_object()
    quota.body["spec"] = {
        "tenants": {"batch": {
            "chipQuota": float(high_gangs * shape.gpus),
            "priority": "low"}},
        "defaults": {},
    }
    api.create(quota)

    def drive_until(cond, deadline_s: float, what: str) -> None:
        deadline = clock.now() + deadline_s
        while True:
            mgr.run_until_idle()
            if cond():
                return
            due = [d for (_, _, d) in mgr.pending_delayed()]
            if not due or min(due) > deadline:
                raise AssertionError(f"{what}: not reached within "
                                     f"{deadline_s:g}s modeled seconds")
            delta = min(due) - clock.now()
            if delta > 0:
                clock.advance(delta)

    def healthy(ns: str, name: str) -> bool:
        st = api.get("Notebook", ns, name).body.get("status") or {}
        return st.get("sliceHealth") == "Healthy"

    # phase 1 — fill: benign standard tenants + the batch tenant's
    # placed (victim-eligible) gangs converge on the whole capacity
    benign_nbs = [(f"team-{i}", f"team-{i}-nb-{j:02d}")
                  for i in range(benign) for j in range(per_tenant)]
    batch_placed = [f"bat-{i:03d}" for i in range(high_gangs)]
    for ns, name in benign_nbs:
        _create(api, Notebook.new(name, ns, gpu=spec))
    for name in batch_placed:
        _create(api, Notebook.new(name, "batch", gpu=spec, priority="low"))
    drive_until(
        lambda: all(healthy(ns, n) for ns, n in benign_nbs)
        and all(healthy("batch", n) for n in batch_placed),
        provision_s * 4 + 600, "fill phase")
    digests = {}
    for name in batch_placed:
        cluster.set_session_payload("batch", name,
                                    b"kernel-" + name.encode())
        (snap,) = cluster.snapshot_sessions("batch", name)
        digests[name] = snap.digest

    # phase 2 — oversubscribe: the flood must queue behind the quota
    # with sliceHealth Queued and zero claims
    flood_names = [f"flood-{i:03d}" for i in range(flood)]
    for name in flood_names:
        _create(api, Notebook.new(name, "batch", gpu=spec, priority="low"))
    for _ in range(3):
        mgr.run_until_idle()
        clock.advance(20.0)
    mgr.run_until_idle()
    for name in flood_names:
        obj = api.get("Notebook", "batch", name)
        st = obj.body.get("status") or {}
        if C.ANNOTATION_PLACEMENT in obj.metadata.annotations or \
                st.get("sliceHealth") != "Queued":
            raise AssertionError(
                f"flood gang batch/{name} broke containment: "
                f"placement={C.ANNOTATION_PLACEMENT in obj.metadata.annotations} "
                f"sliceHealth={st.get('sliceHealth')!r}")
    tenancy = metrics.tenancy_snapshot()
    queued_depth_peak = sum(
        e.get("depth", 0) for e in (tenancy.get("queued") or {}).values())

    # phase 3 — the high-priority burst: placement only via
    # checkpoint-then-preempt of the batch victims
    high_names = [f"hp-{i:02d}" for i in range(high_gangs)]
    t_burst = clock.now()
    for name in high_names:
        _create(api, Notebook.new(name, "urgent", gpu=spec,
                                  priority="high"))
    placed_at: dict[str, float] = {}

    def burst_done() -> bool:
        for name in high_names:
            if name not in placed_at and healthy("urgent", name):
                placed_at[name] = clock.now()
        return len(placed_at) == len(high_names)

    drive_until(burst_done, 600.0, "high-priority burst placement")
    waits = sorted(placed_at[n] - t_burst for n in high_names)
    high_p99 = _percentile(waits, 0.99)

    evicted = [
        n for n in batch_placed
        if C.ANNOTATION_PLACEMENT not in
        api.get("Notebook", "batch", n).metadata.annotations]
    benign_evictions = sum(
        1 for ns, n in benign_nbs if not healthy(ns, n))
    batch_sts_deletes = {
        n: len([r for r in api.audit_log(verb="delete",
                                         kind="StatefulSet")
                if r.ok and r.name == n])
        for n in batch_placed}
    checkpointless = 0
    for name, count in batch_sts_deletes.items():
        if count == 0:
            continue
        sess = (api.get("Notebook", "batch", name)
                .body.get("status") or {}).get("sessionState") or {}
        entry = sess.get("0") or {}
        if entry.get("trigger") != "preempt" or \
                entry.get("digest") != digests[name]:
            checkpointless += 1
    if any(count > 1 for count in batch_sts_deletes.values()):
        raise AssertionError(
            f"victim torn down more than once: {batch_sts_deletes}")

    # phase 4 — drain and restore: the flood withdraws, the burst
    # finishes; every evicted victim must restore its checkpoint
    for name in flood_names:
        api.delete("Notebook", "batch", name)
    for name in high_names:
        live = api.get("Notebook", "urgent", name)
        live.metadata.annotations[C.STOP_ANNOTATION] = "true"
        api.update(live)
    restored_at: dict[str, float] = {}

    def victims_back() -> bool:
        for name in evicted:
            if name in restored_at:
                continue
            sess = (api.get("Notebook", "batch", name)
                    .body.get("status") or {}).get("sessionState") or {}
            if healthy("batch", name) and \
                    (sess.get("0") or {}).get("phase") == "restored":
                restored_at[name] = clock.now()
        return len(restored_at) == len(evicted)

    drive_until(victims_back, provision_s * 2 + 1200,
                "preempted victims restored")
    state_loss = 0
    for name in evicted:
        sess = (api.get("Notebook", "batch", name)
                .body.get("status") or {}).get("sessionState") or {}
        if (sess.get("0") or {}).get("digest") != digests[name]:
            state_loss += 1

    mgr.stop()
    result = {
        "mode": "priorities",
        "gpu": gpu,
        "capacity_slices": capacity_slices,
        "benign_tenants": benign,
        "per_tenant": per_tenant,
        "flood_gangs": flood,
        "high_gangs": high_gangs,
        "queued_depth_peak": queued_depth_peak,
        "high_p99_placement_s": round(high_p99, 3),
        "high_max_placement_s": round(waits[-1], 3),
        "evicted_victims": len(evicted),
        "benign_evictions": benign_evictions,
        "checkpointless_teardowns": checkpointless,
        "preempted_state_loss": state_loss,
        "restored_victims": len(restored_at),
        "queue_wait_counts": {
            p: metrics.queue_wait_seconds.count_value(p)
            for p in ("low", "standard", "high")},
        "preemptions_evicted_low":
            metrics.preemptions.value("evicted", "low"),
        "slo": slo_engine.verdicts(),
    }
    _print_priorities(result)
    return result


def _print_priorities(result: dict) -> None:
    print("tenancy run:", file=sys.stderr)
    for k in ("capacity_slices", "queued_depth_peak",
              "high_p99_placement_s", "evicted_victims",
              "benign_evictions", "checkpointless_teardowns",
              "preempted_state_loss", "restored_victims"):
        print(f"  {k:<26} {result[k]}", file=sys.stderr)


def check_priorities_budget(result: dict, budget: dict) -> list[str]:
    """CI gate over the adversarial tenancy run (budgets/fleet_budget.json
    "tenancy" section): high-priority time-to-placement ceiling, zero
    state loss, zero benign evictions, zero checkpointless teardowns,
    and the lane must actually have exercised preemption."""
    failures = []
    max_p99 = budget.get("max_high_p99_placement_s")
    if max_p99 is not None and \
            result["high_p99_placement_s"] > max_p99:
        failures.append(
            f"high-priority p99 time-to-placement "
            f"{result['high_p99_placement_s']}s > ceiling {max_p99}s")
    if result["preempted_state_loss"] > \
            int(budget.get("max_preempted_state_loss", 0)):
        failures.append(
            f"{result['preempted_state_loss']} preempted victims lost "
            "session state")
    if result["benign_evictions"] > \
            int(budget.get("max_benign_evictions", 0)):
        failures.append(
            f"{result['benign_evictions']} benign-tenant gangs evicted")
    if result["checkpointless_teardowns"] > \
            int(budget.get("max_checkpointless_teardowns", 0)):
        failures.append(
            f"{result['checkpointless_teardowns']} teardowns without a "
            "secured checkpoint")
    min_evict = int(budget.get("min_evictions", 1))
    if result["evicted_victims"] < min_evict:
        failures.append(
            f"only {result['evicted_victims']} evictions — the lane "
            f"never exercised preemption (want >= {min_evict})")
    if result["restored_victims"] < result["evicted_victims"]:
        failures.append(
            f"{result['evicted_victims'] - result['restored_victims']} "
            "evicted victims never restored")
    return failures


def check_tenant_budget(result: dict, budget: dict) -> list[str]:
    """CI gate over the adversarial tenants run (budgets/fleet_budget.json
    "tenants" section): victim p99 ceiling under flood, exactly-one
    deduped warning, zero conservation violations."""
    failures = []
    max_p99 = budget.get("max_victim_p99_event_to_reconcile_s")
    if max_p99 is not None and \
            result["victim_p99_event_to_reconcile_s"] > max_p99:
        failures.append(
            f"victim p99 event->reconcile "
            f"{result['victim_p99_event_to_reconcile_s']}s > ceiling "
            f"{max_p99}s")
    if result["noisy_warning_events"] != 1:
        failures.append(
            f"{result['noisy_warning_events']} noisy-neighbor warnings, "
            "want exactly 1")
    max_viol = int(budget.get("max_conservation_violations", 0))
    if result["conservation"]["violations"] > max_viol:
        failures.append(
            f"metering conservation violations "
            f"{result['conservation']['violations']} > {max_viol}")
    return failures


def check_shard_budget(result: dict, budget: dict) -> list[str]:
    """CI gate over the sharded-fleet run (budgets/fleet_budget.json
    "sharded" section): wall-clock + p99 ceilings like the flat fleet,
    plus ring balance — no live shard may own more than
    `max_owned_fraction` of the keyspace."""
    failures = check_budget(result, budget)
    max_frac = budget.get("max_owned_fraction")
    if max_frac is not None and result["keys_owned"]:
        worst = max(result["keys_owned"].values())
        if worst > result["count"] * max_frac:
            failures.append(
                f"ring imbalance: one shard owns {worst}/{result['count']} "
                f"keys (> {max_frac:.0%})")
    return failures


def check_warm_budget(warm: dict, cold: dict, budget: dict) -> list[str]:
    """CI gate over the warm-vs-cold comparison: warm-pool-on p50 ready
    time strictly below the cold path, a minimum warm hit rate, and a
    minimum converged slice utilization."""
    failures = []
    if not warm["ready_p50_s"] < cold["ready_p50_s"]:
        failures.append(
            f"warm p50 {warm['ready_p50_s']}s not strictly below cold p50 "
            f"{cold['ready_p50_s']}s")
    max_frac = budget.get("max_warm_p50_fraction_of_cold")
    if max_frac is not None and cold["ready_p50_s"] > 0 and \
            warm["ready_p50_s"] > cold["ready_p50_s"] * max_frac:
        failures.append(
            f"warm p50 {warm['ready_p50_s']}s above "
            f"{max_frac:.0%} of cold p50 {cold['ready_p50_s']}s")
    min_hit = budget.get("min_hit_rate")
    if min_hit is not None and warm["hit_rate"] < min_hit:
        failures.append(
            f"warm hit rate {warm['hit_rate']} < {min_hit}")
    min_util = budget.get("min_slice_utilization")
    if min_util is not None:
        worst = min(warm["slice_utilization"] or [0.0])
        if worst < min_util:
            failures.append(
                f"converged slice utilization {worst} < {min_util}")
    return failures


def check_budget(result: dict, budget: dict) -> list[str]:
    """Failures (empty = within budget).  A measurement may regress at
    most `tolerance` (fraction) over the committed per-notebook budget."""
    tol = 1.0 + float(budget.get("tolerance", 0.10))
    failures = []
    for kind, allowed in budget.get("writes_per_notebook", {}).items():
        got = result["writes_per_notebook"].get(kind, 0.0)
        if got > allowed * tol:
            failures.append(
                f"writes/notebook[{kind}]: {got} > {allowed} (+{tol - 1:.0%})")
    for ctrl, allowed in budget.get("reconciles_per_notebook", {}).items():
        got = result["reconciles_per_notebook"].get(ctrl, 0.0)
        if got > allowed * tol:
            failures.append(
                f"reconciles/notebook[{ctrl}]: {got} > {allowed} "
                f"(+{tol - 1:.0%})")
    hard_cap = budget.get("max_reconciles_per_notebook")
    if hard_cap is not None:
        got = result["reconciles_per_notebook"].get("notebook", 0.0)
        if got > hard_cap:
            failures.append(
                f"reconciles/notebook[notebook]: {got} > hard cap {hard_cap}")
    # fleet-scale regression backstops (budgets/fleet_budget.json): generous
    # wall-clock ceiling and an event->reconcile-start p99 ceiling — wide
    # enough to absorb machine variance, tight enough that an O(N^2)
    # regression (the pre-shard apiserver) blows straight through them
    max_wall = budget.get("max_wall_s")
    if max_wall is not None and result["wall_s"] > max_wall:
        failures.append(
            f"wall time {result['wall_s']}s > ceiling {max_wall}s")
    max_p99 = budget.get("max_p99_event_to_reconcile_s")
    if max_p99 is not None and \
            result.get("p99_event_to_reconcile_s", 0.0) > max_p99:
        failures.append(
            f"p99 event->reconcile-start "
            f"{result['p99_event_to_reconcile_s']}s > ceiling {max_p99}s")
    return failures


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("-l", "--count", type=int, default=200)
    parser.add_argument("--workers", type=int, default=1)
    parser.add_argument("--compare-workers", type=int, default=0,
                        help="re-run with N workers and require an "
                        "identical normalized final state")
    parser.add_argument("--gpu", default="",
                        help="accelerator:count, e.g. h100-80gb:16 "
                        "(default CPU)")
    parser.add_argument("--check-budget", default="",
                        help="budget JSON; fail on >tolerance regression")
    parser.add_argument("--write-budget", default="",
                        help="write the measured result as the new budget")
    parser.add_argument("--out", default="",
                        help="also write the machine-readable result JSON "
                        "to this file (fleet-scale trajectory tracking)")
    parser.add_argument("--profile-on-fail", default="", metavar="FILE",
                        help="on budget failure, re-run the fleet under "
                        "cProfile and write the top-25 cumulative listing "
                        "to FILE (and stderr) so the regression is "
                        "diagnosable from CI output alone")
    parser.add_argument("--bursty", type=int, default=0, metavar="N",
                        help="bursty gang-scheduler mode: N GPU notebooks "
                        "per wave, warm-pool-on vs off comparison")
    parser.add_argument("--bursts", type=int, default=3)
    parser.add_argument("--burst-gap-s", type=float, default=300.0)
    parser.add_argument("--warm-size", type=int, default=8,
                        help="warm-pool base target for the warm run")
    parser.add_argument("--provision-s", type=float, default=120.0,
                        help="modeled cold gang-provision latency")
    parser.add_argument("--check-warm-budget", default="",
                        help="warm-vs-cold budget JSON (min hit rate, p50 "
                        "ratio); fail on regression")
    parser.add_argument("--shards", type=int, default=0, metavar="N",
                        help="sharded mode: run --count notebooks over an "
                        "N-replica active-active fleet with a kill+rejoin "
                        "cycle; --check-budget reads the 'sharded' section "
                        "of the budget JSON")
    parser.add_argument("--budget-section", default="", metavar="NAME",
                        help="budget JSON section for sharded runs "
                        "(default 'sharded').  A section carrying a "
                        "'points' map gates EVERY sweep point listed in "
                        "it — base ceilings overridden per point — "
                        "instead of only the largest")
    parser.add_argument("--tenants", type=int, default=0, metavar="N",
                        help="adversarial multi-tenant mode: N namespaces "
                        "of --per-tenant GPU notebooks, tenant --noisy "
                        "floods spec churn; asserts metering attribution, "
                        "exactly-one warning, and conservation; "
                        "--check-budget reads the 'tenants' section")
    parser.add_argument("--per-tenant", type=int, default=4,
                        help="notebooks per tenant in --tenants mode")
    parser.add_argument("--noisy", type=int, default=0, metavar="T",
                        help="index of the flooding tenant in --tenants "
                        "mode")
    parser.add_argument("--priorities", type=int, default=0, metavar="N",
                        help="adversarial tenancy mode: a low-priority "
                        "flood oversubscribes the fleet, then an "
                        "N-gang high-priority burst must land via "
                        "checkpoint-then-preempt with zero state loss; "
                        "--check-budget reads the 'tenancy' section")
    parser.add_argument("--flood", type=int, default=6,
                        help="queued low-priority gangs in --priorities "
                        "mode")
    parser.add_argument("--benign", type=int, default=2,
                        help="untouchable standard-priority tenants in "
                        "--priorities mode")
    parser.add_argument("--sweep", default="", metavar="N1,N2,...",
                        help="scale sweep: run the fleet (sharded when "
                        "--shards is set) at each point, print the "
                        "per-stage critical-path table per point, record "
                        "per-point stage attribution into --out, and "
                        "budget-check the largest point — the "
                        "where-does-it-bend curve")
    args = parser.parse_args(argv)

    if args.sweep:
        return _run_sweep(args)

    if args.priorities:
        result = run_priorities(args.priorities, args.benign,
                                args.per_tenant, args.flood,
                                args.gpu or DEFAULT_TENANT_GPU)
        rc = 0
        if args.check_budget:
            budget = json.loads(Path(args.check_budget).read_text())
            failures = check_priorities_budget(
                result, budget.get("tenancy", budget))
            result["budget_ok"] = not failures
            for f in failures:
                print(f"TENANCY BUDGET FAIL: {f}", file=sys.stderr)
                rc = 1
        print(json.dumps(result))
        if args.out:
            Path(args.out).write_text(json.dumps(result, indent=2,
                                                 sort_keys=True) + "\n")
        return rc

    if args.tenants:
        result = run_tenants(args.tenants, args.per_tenant, args.noisy,
                             args.gpu or DEFAULT_TENANT_GPU)
        rc = 0
        if args.check_budget:
            budget = json.loads(Path(args.check_budget).read_text())
            failures = check_tenant_budget(result,
                                           budget.get("tenants", budget))
            result["budget_ok"] = not failures
            for f in failures:
                print(f"TENANT BUDGET FAIL: {f}", file=sys.stderr)
                rc = 1
        print(json.dumps(result))
        if args.out:
            Path(args.out).write_text(json.dumps(result, indent=2,
                                                 sort_keys=True) + "\n")
        return rc

    if args.shards:
        result = run_sharded_fleet(args.count, args.shards)
        rc = 0
        if args.check_budget:
            budget = json.loads(Path(args.check_budget).read_text())
            section = budget.get(args.budget_section or "sharded", budget)
            failures = check_shard_budget(
                result, _point_budget(section, result["count"]))
            result["budget_ok"] = not failures
            for f in failures:
                print(f"SHARD BUDGET FAIL: {f}", file=sys.stderr)
                rc = 1
        print(json.dumps(result))
        if args.out:
            Path(args.out).write_text(json.dumps(result, indent=2,
                                                 sort_keys=True) + "\n")
        return rc

    if args.bursty:
        gpu = args.gpu or DEFAULT_BURSTY_GPU
        warm = run_bursty(args.bursty, args.bursts, args.burst_gap_s, gpu,
                          warm_size=args.warm_size,
                          provision_s=args.provision_s)
        cold = run_bursty(args.bursty, args.bursts, args.burst_gap_s, gpu,
                          warm_size=0, provision_s=args.provision_s)
        out = {"gpu": gpu, "warm": warm, "cold": cold}
        rc = 0
        budget = {}
        if args.check_warm_budget:
            budget = json.loads(Path(args.check_warm_budget).read_text())
        failures = check_warm_budget(warm, cold, budget)
        out["warm_budget_ok"] = not failures
        for f in failures:
            print(f"WARM BUDGET FAIL: {f}", file=sys.stderr)
            rc = 1
        print(json.dumps(out))
        return rc

    budget = (json.loads(Path(args.check_budget).read_text())
              if args.check_budget else None)
    result, failures = run_fleet_gated(
        args.count, args.workers, args.gpu, args.compare_workers, budget)
    rc = 0
    if not result.get("compare", {}).get("state_identical", True):
        print("FAIL: final cluster state differs between "
              f"{args.workers}-worker and {args.compare_workers}-worker "
              "runs", file=sys.stderr)
        rc = 1
    if failures:
        for f in failures:
            print(f"BUDGET FAIL: {f}", file=sys.stderr)
        rc = 1
        if args.profile_on_fail:
            _profile_fleet(args, args.profile_on_fail)

    if args.write_budget:
        Path(args.write_budget).write_text(json.dumps({
            "notebooks": args.count,
            "tolerance": 0.10,
            "max_reconciles_per_notebook": 3.0,
            "reconciles_per_notebook": result["reconciles_per_notebook"],
            "writes_per_notebook": result["writes_per_notebook"],
        }, indent=2, sort_keys=True) + "\n")

    print(json.dumps(result))
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2,
                                             sort_keys=True) + "\n")
    return rc


def run_fleet_gated(count: int, workers: int = 1, gpu: str = "",
                    compare_workers: int = 0,
                    budget: dict | None = None) -> tuple[dict, list[str]]:
    """The flat fleet as the CLI runs it: `run_fleet`, then with
    `compare_workers` the same fleet again on that many workers
    (`result["compare"]["state_identical"]`), then the `budget` gates
    (`result["budget_ok"]`; a `--gpu` fleet reads the budget's `gang`
    section).  Returns the result and the budget's failures."""
    # the normalized-state scrub is O(cluster) and only needed for the
    # 1-vs-N worker equivalence comparison — skip it on plain (10k-scale)
    # runs so the wall-clock ceiling measures the control plane, not the
    # harness
    result = run_fleet(count, workers, gpu=gpu,
                       compute_state=bool(compare_workers))
    state = result.pop("_state", None)
    if compare_workers:
        other = run_fleet(count, compare_workers, gpu=gpu)
        other_state = other.pop("_state")
        result["compare"] = {
            "workers": other["workers"],
            "wall_s": other["wall_s"],
            "reconciles_per_notebook": other["reconciles_per_notebook"],
            "state_identical": other_state == state,
        }
    failures: list[str] = []
    if budget is not None:
        failures = check_budget(result,
                                gang_budget(budget) if gpu else budget)
        result["budget_ok"] = not failures
    return result, failures


def gang_budget(budget: dict) -> dict:
    """The budget a `--gpu` fleet is held to: the file's base ceilings
    with its `gang` section folded in (a gang also writes its headless
    worker Service).  A file without that section gates gangs with its
    base numbers."""
    merged = {k: v for k, v in budget.items() if k != "gang"}
    merged.update(budget.get("gang") or {})
    return merged


def _point_budget(budget: dict, count: int) -> dict:
    """A budget section scaled to one sweep point: the section's base
    ceilings with the `points[str(count)]` overrides folded in.  A
    section without a `points` map (or without this count) gates with
    its base ceilings unchanged."""
    sub = (budget.get("points") or {}).get(str(count)) or {}
    merged = {k: v for k, v in budget.items() if k != "points"}
    merged.update(sub)
    return merged


def _run_sweep(args) -> int:
    """`--sweep N1,N2,...`: the same fleet at increasing scale, one
    critical-path table + attribution record per point.  The per-point
    records land in --out so CI archives where each stage's contribution
    starts to bend.  A budget section with a `points` map gates every
    point it lists against scaled sub-budgets; without one the budget
    gates only the LARGEST point (the smaller ones exist for the curve,
    not the ceiling)."""
    points = sorted({int(x) for x in args.sweep.split(",") if x.strip()})
    if not points:
        print("SWEEP: no scale points parsed", file=sys.stderr)
        return 1
    sweep = []
    for n in points:
        if args.shards:
            r = run_sharded_fleet(n, args.shards)
        else:
            r = run_fleet(n, args.workers, gpu=args.gpu,
                          compute_state=False)
            r.pop("_state", None)
        sweep.append(r)
    rc = 0
    if args.check_budget:
        budget = json.loads(Path(args.check_budget).read_text())
        if args.shards:
            section = budget.get(args.budget_section or "sharded", budget)
        else:
            section = gang_budget(budget) if args.gpu else budget
        point_budgets = section.get("points") or {}
        for rec in sweep:
            if point_budgets:
                if str(rec["count"]) not in point_budgets:
                    continue  # runs for the curve, not the ceiling
            elif rec is not sweep[-1]:
                continue
            merged = _point_budget(section, rec["count"])
            failures = (check_shard_budget(rec, merged) if args.shards
                        else check_budget(rec, merged))
            rec["budget_ok"] = not failures
            for f in failures:
                print(f"SWEEP BUDGET FAIL (count={rec['count']}): {f}",
                      file=sys.stderr)
                rc = 1
    out = {
        "mode": "sweep",
        "points": points,
        "shards": args.shards or 0,
        "gpu": args.gpu or "cpu",
        "sweep": sweep,
        # where the wall-time curve bends: the point with the largest
        # slope increase (per-notebook cost), plus what binds there
        "knee": _sweep_knee(points, sweep),
    }
    print(json.dumps(out))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=2,
                                             sort_keys=True) + "\n")
    return rc


def _sweep_knee(points: list[int], sweep: list[dict]) -> dict:
    """Name the knee of the wall-time curve: per segment the marginal
    cost (wall seconds per added notebook); the knee is the point whose
    segment's marginal cost grows the most over the previous segment's.
    With fewer than 3 points there is no curvature — the largest point
    stands in."""
    knee_idx = len(points) - 1
    if len(points) >= 3:
        slopes = []
        for i in range(1, len(points)):
            dn = points[i] - points[i - 1]
            slopes.append((sweep[i]["wall_s"] - sweep[i - 1]["wall_s"])
                          / dn if dn else 0.0)
        growth = [slopes[i] - slopes[i - 1] for i in range(1, len(slopes))]
        knee_idx = growth.index(max(growth)) + 2  # segment i ends at i+1
    at = sweep[knee_idx]
    return {
        "count": points[knee_idx],
        "wall_s": at["wall_s"],
        "binding_stage": at.get("binding_stage", ""),
    }


def _profile_fleet(args, out_path: str) -> None:
    """Budget-failure forensics: re-run the same fleet under cProfile and
    dump the top-25 cumulative functions, so a CI regression names its hot
    path without anyone having to reproduce locally."""
    import cProfile
    import io
    import pstats

    print(f"profiling {args.count}-notebook fleet for the failure "
          f"artifact...", file=sys.stderr)
    profile = cProfile.Profile()
    profile.enable()
    try:
        run_fleet(args.count, args.workers, gpu=args.gpu,
                  compute_state=False)
    finally:
        profile.disable()
        buf = io.StringIO()
        pstats.Stats(profile, stream=buf).sort_stats(
            "cumulative").print_stats(25)
        listing = buf.getvalue()
        Path(out_path).write_text(listing)
        print(listing, file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
