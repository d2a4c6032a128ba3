"""The port's replicated tier against the reference's.

`spec.replication` runs one primary gang and follower gangs that replay
the primary's checkpoint-delta stream; a failure of the primary promotes
a caught-up follower under epoch fencing.  Each part goes through the
reference's stack on a `spec.tpu` notebook and the port's on a
`spec.gpu` gang of the same host count (1 and 2 hosts), each on its own
FakeClock from the same epoch:

- the delta chain (tests/test_sessionstate.py::TestDeltaChain) on both
  stores, in memory and on disk: every DeltaInfo and SnapshotInfo, every
  materialized state, digest, chain head, fence and refusal equal, the
  on-disk files equal byte for byte, and each package's DirSessionStore
  reading the other's directory;
- the promote verb (tests/test_selfheal.py::TestPromoteVerb, with its
  `make_replicated_env` and `warm_follower`): after every step
  `status.replication`, `sliceHealth`, `sliceRecovery`, the fence, the
  chain head, the follower stamps, the Service's selector, the Events
  (the reference's "slice" read as "gang"), the pods, the samples of
  the promotion families and the engine's, and the fault plan's log
  equal.  The drills: a promotion, a lagging follower, the reference's
  brown-out (injected 503s on the Notebook commits delay the flip but
  never split it), and a flip that crashes between the record and the
  flip, once in place and once across a manager failover;
- the replica anti-affinity (tests/test_scheduler.py::
  TestReplicaAntiAffinity) and the two scenarios of several gangs that
  tests/test_torch_scheduler.py leaves out (two gangs by bypass that
  must not double-book nodes, and a beneficiary of two gangs that one
  victim cannot cover), on tests/test_torch_scheduler.py's harness,
  with the replicated notebook on both sides.

The clocks are fake and the state exact, so no tolerance applies.  Only
the reference's control plane is imported, and no process is
launched."""

from __future__ import annotations

import dataclasses
import json

import pytest

from kubeflow_tpu import kube as ref_kube
from kubeflow_tpu.api.types import Notebook as RefNotebook
from kubeflow_tpu.api.types import ReplicationSpec as RefReplication
from kubeflow_tpu.api.types import TPUSpec
from kubeflow_tpu.core import sessionstate as ref_ss
from kubeflow_tpu.core.metrics import NotebookMetrics as RefMetrics
from kubeflow_tpu.core.notebook_controller import (
    setup_core_controllers as ref_setup,
)
from kubeflow_tpu.utils.clock import FakeClock as RefFakeClock
from kubeflow_tpu.utils.config import CoreConfig as RefConfig
from kubeflow_tpu_torch import kube
from kubeflow_tpu_torch.api.types import GPUSpec, Notebook, ReplicationSpec
from kubeflow_tpu_torch.core import constants as C
from kubeflow_tpu_torch.core import sessionstate as ss
from kubeflow_tpu_torch.core.metrics import NotebookMetrics
from kubeflow_tpu_torch.core.notebook_controller import setup_core_controllers
from kubeflow_tpu_torch.utils.clock import FakeClock
from kubeflow_tpu_torch.utils.config import CoreConfig
from test_torch_scheduler import SHAPES as SCHED_SHAPES
from test_torch_scheduler import Side as SchedSide

NS, NAME = "u1", "rep"
# hosts -> (reference: GKE label, accelerator, topology, chips a host;
# port: GPUs in the gang), the shapes of tests/test_torch_selfheal.py
SHAPES = {1: (("tpu-v5-lite-podslice", "v5e", "2x4", 8), 8),
          2: (("tpu-v4-podslice", "v4", "2x2x2", 4), 16)}
FAMILIES = ("notebook_promotions_total",
            "notebook_promotion_duration_seconds",
            "notebook_replication_fenced_writes_total",
            "notebook_slice_restarts_total",
            "notebook_disruption_recovery_seconds",
            "notebook_migrations_total")
STAMPS = (C.ANNOTATION_REPLICA_GENERATION, C.ANNOTATION_REPLICA_SEQ,
          C.ANNOTATION_REPLICA_DIGEST)


# -- the delta chain -----------------------------------------------------------


def _store(port: bool, kind: str, root):
    mod = ss if port else ref_ss
    clock = FakeClock() if port else RefFakeClock()
    if kind == "mem":
        return mod.InMemorySessionStore(clock=clock)
    return mod.DirSessionStore(str(root), clock=clock)


def _info(x):
    return None if x is None else dataclasses.asdict(x)


def _refused(fn, errors) -> str:
    """fn() must raise one of `errors`: its type's name and message."""
    with pytest.raises(errors) as err:
        fn()
    return f"{type(err.value).__name__}: {err.value}"


def _order(store, mod):
    t = [_refused(lambda: store.append_delta("u1", "nb", 0, b"+orphan"),
                  mod.DeltaChainError)]
    t.append(_info(store.put("u1", "nb", 0, b"base")))
    t.append(_info(store.append_delta("u1", "nb", 0, b"+d1",
                                      expected_seq=1)))
    # a duplicate replay and a future slot are both out of order
    for seq in (1, 3):
        t.append(_refused(lambda: store.append_delta(
            "u1", "nb", 0, b"+x", expected_seq=seq), mod.DeltaChainError))
    t.append([d.seq for d in store.deltas("u1", "nb", 0)])
    t.append(store.materialize("u1", "nb", 0))
    assert t[-1] == b"base+d1"
    return t


def _head(store, mod):
    t = [store.chain_head("u1", "nb", 0)]
    base = store.put("u1", "nb", 0, b"base")
    t += [_info(base), store.chain_head("u1", "nb", 0)]
    for i in (1, 2):
        t.append(_info(store.append_delta("u1", "nb", 0, b"+d%d" % i)))
    t.append(store.chain_head("u1", "nb", 0))
    assert t[-1][2] == mod.payload_digest(b"base+d1+d2")
    return t


def _compact(store, mod):
    t = [_info(store.put("u1", "nb", 0, b"base"))]
    for i in range(3):
        t.append(_info(store.append_delta("u1", "nb", 0, b"+d%d" % i)))
    head = store.chain_head("u1", "nb", 0)
    folded = store.compact("u1", "nb", 0)
    assert folded.digest == head[2] and folded.generation == 2
    t += [_info(folded), store.payload("u1", "nb", 0),
          store.chain_head("u1", "nb", 0), store.deltas("u1", "nb", 0)]
    t.append(_info(store.append_delta("u1", "nb", 0, b"+d3",
                                      expected_seq=1)))
    t.append(store.materialize("u1", "nb", 0))
    return t


def _compact_noop(store, mod):
    t = [store.compact("u1", "nb", 0)]
    base = store.put("u1", "nb", 0, b"base")
    assert store.compact("u1", "nb", 0) == base
    return t + [_info(base)]


def _follower(store, mod):
    store.put("u1", "nb", 0, b"base")
    store.append_delta("u1", "nb", 0, b"+d1")
    f = mod.FollowerReplica(store, "u1", "nb", 0)
    t = [f.catch_up(), f.lag(), f.caught_up(), f.digest]
    store.append_delta("u1", "nb", 0, b"+d2")
    t += [f.lag(), f.caught_up()]
    store.compact("u1", "nb", 0)
    store.append_delta("u1", "nb", 0, b"+d3")
    t += [f.lag(), f.catch_up(), f.state, f.digest, f.applied_total,
          store.chain_head("u1", "nb", 0)]
    assert f.digest == store.chain_head("u1", "nb", 0)[2]
    late = mod.FollowerReplica(store, "u1", "nb", 0)
    t += [late.catch_up(), late.state, late.caught_up()]
    assert late.state == f.state == b"base+d1+d2+d3"
    return t


def _gap(store, mod):
    store.put("u1", "nb", 0, b"base")
    store.append_delta("u1", "nb", 0, b"+d1")
    store.append_delta("u1", "nb", 0, b"+d2")
    real = store.delta_payload
    lagging = mod.FollowerReplica(store, "u1", "nb", 0)
    store.delta_payload = lambda *a, **k: None
    try:
        t = [lagging.catch_up(), lagging.state, lagging.seq]
    finally:
        store.delta_payload = real
    t += [lagging.catch_up(), lagging.state, lagging.digest]
    corrupt = mod.FollowerReplica(store, "u1", "nb", 0)
    store.delta_payload = lambda *a, **k: b"garbage"
    try:
        t.append(_refused(corrupt.catch_up, mod.DeltaChainError))
    finally:
        store.delta_payload = real
    t += [corrupt.state, corrupt.seq, corrupt.digest]
    assert corrupt.state == b"base"
    return t


def _fence(store, mod):
    t = [_info(store.put("u1", "nb", 0, b"base", writer_epoch=1)),
         _info(store.append_delta("u1", "nb", 0, b"+d1", writer_epoch=1)),
         store.fence("u1", "nb", 2), store.fence("u1", "nb", 1),
         store.fence_epoch("u1", "nb")]
    seen = []
    store.on_fenced_write = lambda ns, name: seen.append((ns, name))
    for op in (lambda: store.put("u1", "nb", 0, b"x", writer_epoch=1),
               lambda: store.append_delta("u1", "nb", 0, b"+z",
                                          writer_epoch=1),
               lambda: store.compact("u1", "nb", 0, writer_epoch=1)):
        t.append(_refused(op, mod.StaleWriterError))
    t.append(_info(store.append_delta("u1", "nb", 0, b"+d2",
                                      writer_epoch=2)))
    t.append(_info(store.append_delta("u1", "nb", 0, b"+d3")))
    t += [store.materialize("u1", "nb", 0),
          sorted(store.fenced_rejections.items()), seen]
    assert store.fenced_rejections[("u1", "nb")] == 3
    return t


CHAIN = {"order": _order, "head": _head, "compact": _compact,
         "compact-noop": _compact_noop, "follower": _follower,
         "gap": _gap, "fence": _fence}


def _files(root) -> dict:
    """Every file under a store's root: name -> bytes, the metadata's
    store URI read as one."""
    out = {}
    for path in sorted(root.rglob("*")):
        if path.is_file():
            data = path.read_bytes()
            if path.suffix == ".json":
                meta = json.loads(data)
                meta["uri"] = meta["uri"].replace(f"file://{root}", "ROOT")
                data = meta
            out[str(path.relative_to(root))] = data
    return out


@pytest.mark.parametrize("kind", ["mem", "dir"])
@pytest.mark.parametrize("scenario", sorted(CHAIN))
def test_delta_chain_matches_the_reference(scenario, kind, tmp_path):
    """The same operations on the reference's store and the port's give
    equal infos, states, digests, heads, fences and refusals; on disk
    the same files with the same bytes."""
    roots = {port: tmp_path / ("port" if port else "ref")
             for port in (False, True)}
    traces = {}
    for port in (False, True):
        store = _store(port, kind, roots[port])
        trace = CHAIN[scenario](store, ss if port else ref_ss)
        traces[port] = json.loads(json.dumps(trace, default=repr).replace(
            store.uri, "STORE"))
    assert traces[True] == traces[False]
    if kind == "dir":
        assert _files(roots[True]) == _files(roots[False])


def test_dir_stores_read_each_others_chains(tmp_path):
    """A chain written by either package's DirSessionStore reads back
    through the other's: deltas, head, materialized state, a follower."""
    for writer, reader in ((ss, ref_ss), (ref_ss, ss)):
        root = tmp_path / writer.__name__
        w = writer.DirSessionStore(str(root))
        w.put("u1", "nb", 0, b"base")
        for i in range(3):
            w.append_delta("u1", "nb", 0, b"+d%d" % i, expected_seq=i + 1)
        r = reader.DirSessionStore(str(root))
        assert r.chain_head("u1", "nb", 0) == w.chain_head("u1", "nb", 0)
        assert [_info(d) for d in r.deltas("u1", "nb", 0)] == \
            [_info(d) for d in w.deltas("u1", "nb", 0)]
        assert r.materialize("u1", "nb", 0) == b"base+d0+d1+d2"
        follower = reader.FollowerReplica(r, "u1", "nb", 0)
        assert follower.catch_up() == 4
        assert follower.digest == w.chain_head("u1", "nb", 0)[2]
        # the reader extends the writer's chain from its files
        r.append_delta("u1", "nb", 0, b"+d3", expected_seq=4)
        assert w.materialize("u1", "nb", 0) == b"base+d0+d1+d2+d3"
        assert w.chain_head("u1", "nb", 0)[2] == \
            writer.payload_digest(b"base+d0+d1+d2+d3")


# -- the promote verb ----------------------------------------------------------


class RepSide:
    """One stack with a session store and a replicated notebook of two
    gangs: the reference's (`port=False`) on spec.tpu, the port's on
    spec.gpu, `hosts` hosts a gang, room for both gangs."""

    def __init__(self, port: bool, hosts: int):
        self.port, self.hosts = port, hosts
        self.kube = kube if port else ref_kube
        self.api = self.kube.ApiServer()
        self.cluster = self.kube.FakeCluster(self.api)
        self.cluster.add_node("cpu-node",
                              allocatable={"cpu": "64", "memory": "256Gi"})
        (gke, _, topo, chips), _ = SHAPES[hosts]
        if port:
            self.cluster.add_gpu_nodes("h100-80gb", 2 * hosts, 8)
        else:
            self.cluster.add_tpu_slice_nodes(gke, topo, 2 * hosts, chips)
        self.clock = FakeClock() if port else RefFakeClock()
        self.store = (ss.InMemorySessionStore if port
                      else ref_ss.InMemorySessionStore)(clock=self.clock)
        self.cluster.attach_session_store(self.store,
                                          default_payload=b"kernel")
        self.cfg = (CoreConfig if port else RefConfig)(
            checkpoint_store_uri="mem://session-state")
        self.deleted: list[str] = []
        self.plan = None
        self.api.watch(self._on_pod, kinds=["Pod"])
        self.manager()

    def manager(self) -> None:
        """A fresh manager and metrics over the same store and clock (the
        first one, or a failover)."""
        self.mgr = self.kube.Manager(self.api, clock=self.clock)
        self.metrics = (NotebookMetrics if self.port else RefMetrics)(
            self.api)
        self.rec = (setup_core_controllers if self.port else ref_setup)(
            self.mgr, self.cfg, self.metrics, session=self.store)

    def _on_pod(self, ev) -> None:
        if ev.type.value == "DELETED":
            self.deleted.append(ev.obj.name)

    def create(self) -> None:
        (_, acc, topo, _), gpus = SHAPES[self.hosts]
        if self.port:
            obj = Notebook.new(NAME, NS, gpu=GPUSpec("h100-80gb", gpus),
                               replication=ReplicationSpec(2)).obj
            self.api.create(kube.KubeObject.from_dict(obj))
        else:
            self.api.create(RefNotebook.new(
                NAME, NS, tpu=TPUSpec(acc, topo),
                replication=RefReplication(2)).obj)
        self.mgr.run_until_idle()

    def warm_follower(self, deltas: int = 2, lag: int = 0) -> int:
        """tests/test_selfheal.py's warm_follower: prime the chain and
        stamp the follower gang `lag` deltas behind the head."""
        self.cluster.set_session_payload(NS, NAME, b"kernel-A")
        self.cluster.snapshot_sessions(NS, NAME)
        for i in range(deltas):
            self.cluster.stream_session_delta(NS, NAME, b"+cell%d" % i,
                                              writer_epoch=1)
        return self.cluster.sync_followers(NS, NAME, lag=lag)

    def settle(self) -> None:
        self.mgr.enqueue_all()
        self.mgr.run_until_idle()

    def zombie_write(self, epoch: int) -> str:
        """A write from the primary at `epoch`: "ok" or the refusal."""
        try:
            self.store.append_delta(NS, NAME, 0, b"+write", writer_epoch=epoch)
        except (ss.StaleWriterError, ref_ss.StaleWriterError) as err:
            return f"{type(err).__name__}: {err}"
        return "ok"

    def snapshot(self) -> dict:
        nb = self.api.get("Notebook", NS, NAME)
        status = nb.body.get("status") or {}
        events = sorted(
            (e.body["type"], e.body["reason"], e.body.get("count", 1),
             e.body["message"].replace("slice", "gang"))
            for e in self.api.list("Event", namespace=NS))
        pods = {p.name: ((p.body.get("status") or {}).get("phase"),
                         {k: p.metadata.annotations.get(k) for k in STAMPS})
                for p in self.api.list("Pod", namespace=NS)}
        samples = sorted(
            line for line in self.metrics.registry.render().splitlines()
            if line.startswith(FAMILIES))
        return {"replication": status.get("replication"),
                "sliceHealth": status.get("sliceHealth"),
                "sliceRecovery": status.get("sliceRecovery"),
                "sessionState": status.get("sessionState"),
                "fence": self.store.fence_epoch(NS, NAME),
                "rejections": sorted(self.store.fenced_rejections.items()),
                "head": self.store.chain_head(NS, NAME, 0),
                "selector": self.api.get("Service", NS, NAME)
                .spec["selector"], "events": events, "pods": pods,
                "deleted": list(self.deleted), "samples": samples,
                "faults": [(r.rule, r.action, r.verb, r.kind, r.namespace,
                            r.name, r.seq) for r in self.plan.log]
                if self.plan is not None else None}


def _promotes(s: RepSide):
    """A primary failure promotes the caught-up follower, fences the
    zombie, and the demoted gang heals as a follower."""
    s.create()
    yield
    assert s.warm_follower() == 2 * s.hosts
    s.settle()
    yield
    s.cluster.fail_pod(NS, f"{NAME}-0")
    s.settle()
    rep = s.api.get("Notebook", NS, NAME).body["status"]["replication"]
    assert (rep["epoch"], rep["primary"]) == (2, 1)
    yield
    assert s.zombie_write(1).startswith("StaleWriterError")
    yield
    for _ in range(4):
        s.mgr.advance(30)
    yield
    assert s.zombie_write(2) == "ok"
    yield


def _lagging(s: RepSide):
    """A follower past REPLICATION_MAX_LAG is not electable: the primary
    restarts in place and keeps its epoch."""
    s.create()
    lag = s.cfg.replication_max_lag
    s.warm_follower(deltas=lag + 2, lag=lag + 1)
    s.settle()
    yield
    s.cluster.fail_pod(NS, f"{NAME}-0")
    s.settle()
    yield
    for _ in range(4):
        s.mgr.advance(30)
    yield
    assert s.zombie_write(1) == "ok"
    yield


def _brownout(s: RepSide):
    """tests/test_selfheal.py::test_promotion_commits_through_control_plane
    _partition: 503s injected on three Notebook updates delay the
    promotion's commits but cannot split it; the write-ahead record
    resumes it, the epoch bumps once and the zombie stays fenced."""
    s.create()
    s.warm_follower()
    s.settle()
    s.plan = s.kube.FaultPlan([s.kube.FaultRule(
        verbs=("update",), kinds=("Notebook",), error="unavailable",
        max_matches=3, name="status-brownout")], clock=s.clock)
    s.api.install_fault_plan(s.plan)
    with s.api.fault_exempt():
        s.cluster.fail_pod(NS, f"{NAME}-0")
    s.mgr.run_until_idle()
    yield
    for _ in range(6):
        s.mgr.advance(30)
    s.api.clear_fault_plan()
    assert s.plan.exhausted()
    yield
    for _ in range(4):
        s.mgr.advance(30)
    rep = s.api.get("Notebook", NS, NAME).body["status"]["replication"]
    assert (rep["epoch"], rep["primary"], rep["promotion"]["phase"]) == \
        (2, 1, "promoted")
    assert s.zombie_write(1).startswith("StaleWriterError")
    yield


def _crash_between_record_and_flip(s: RepSide, failover: bool):
    """The flip fails once after the record and the fence landed (a
    crash): the record reads "promoting", the zombie is already fenced,
    and the next pass (of a new manager, under `failover`) resumes the
    promotion with the epoch bumped once."""
    s.create()
    s.warm_follower()
    s.settle()
    engine = s.rec.recovery
    flip, crashed = engine._commit_promotion_flip, []

    def crash_once(nb, entry):
        if not crashed:
            crashed.append(entry["epoch"])
            raise RuntimeError("injected: controller crashed mid-promotion")
        return flip(nb, entry)

    engine._commit_promotion_flip = crash_once
    s.cluster.fail_pod(NS, f"{NAME}-0")
    # the failed reconcile's retry stays due: this is the state a crash
    # leaves behind
    s.mgr.enqueue_all()
    s.mgr.run_until_idle(advance_clock=False)
    assert crashed == [2]
    rep = s.api.get("Notebook", NS, NAME).body["status"]["replication"]
    assert rep["promotion"]["phase"] == "promoting"
    yield
    assert s.zombie_write(1).startswith("StaleWriterError")
    yield
    if failover:
        s.manager()       # all but the CR and the store is new
        s.settle()
    for _ in range(4):
        s.mgr.advance(30)
    rep = s.api.get("Notebook", NS, NAME).body["status"]["replication"]
    assert (rep["epoch"], rep["primary"], rep["promotion"]["phase"]) == \
        (2, 1, "promoted")
    yield


PROMOTE = {"promotes": _promotes, "lagging": _lagging, "brownout": _brownout,
           "crash-resume": lambda s: _crash_between_record_and_flip(
               s, failover=False),
           "crash-failover": lambda s: _crash_between_record_and_flip(
               s, failover=True)}


@pytest.mark.parametrize("hosts", [1, 2])
@pytest.mark.parametrize("drill", sorted(PROMOTE))
def test_promote_verb_matches_the_reference(drill, hosts):
    sides = [RepSide(port, hosts) for port in (False, True)]
    steps = [PROMOTE[drill](s) for s in sides]
    for n, _ in enumerate(zip(*steps)):
        ref, ours = (s.snapshot() for s in sides)
        assert ours == ref, f"{drill} step {n}"
    for s in sides:
        assert s.store.fence_epoch(NS, NAME) in (0, 2)


def test_promotion_families_help_and_buckets_as_the_reference():
    """The three families' HELP, TYPE and bucket lines, as rendered with
    one observation each, equal the reference's."""
    out = {}
    for port in (False, True):
        metrics = (NotebookMetrics if port else RefMetrics)(
            (kube if port else ref_kube).ApiServer())
        metrics.promotions.labels(NS, "promoted").inc()
        metrics.promotion_duration_seconds.labels(NS).observe(0.3)
        metrics.replication_fenced_writes.labels(NS).inc()
        out[port] = [line for line in metrics.registry.render().splitlines()
                     if FAMILIES[0] in line or FAMILIES[1] in line
                     or FAMILIES[2] in line]
    assert out[True] == out[False] and len(out[True]) > 10


# -- anti-affinity and the scenarios of several gangs ---------------------------


def _create_replicated(s: SchedSide, name: str = NAME, ns: str = "default",
                       anti_affine: bool = True, priority=None) -> None:
    """A notebook of two replica gangs on either side of the scheduler's
    harness."""
    (acc, topo, _, _), gpus = SCHED_SHAPES[s.hosts]
    if s.port:
        obj = Notebook.new(name, ns, gpu=GPUSpec("h100-80gb", gpus),
                           priority=priority, replication=ReplicationSpec(
                               2, anti_affine=anti_affine)).obj
        s.api.create(kube.KubeObject.from_dict(obj))
    else:
        nb = RefNotebook.new(name, ns, tpu=TPUSpec(acc, topo),
                             replication=RefReplication(
                                 2, anti_affine=anti_affine))
        if priority is not None:
            nb.obj.spec["priority"] = priority
        s.api.create(nb.obj)


def _pools(s: SchedSide, name: str = NAME, ns: str = "default") -> dict:
    placement = json.loads(s.api.get("Notebook", ns, name).metadata
                           .annotations.get(C.ANNOTATION_PLACEMENT, "{}")
                           or "{}")
    return {g: e.get("pool") for g, e in
            (placement.get("slices") or {}).items()}


def _disjoint_pools(s: SchedSide):
    s.gangs("pool-a", 1)
    s.gangs("pool-b", 1)
    _create_replicated(s)
    s.mgr.run_until_idle()
    assert set(_pools(s).values()) == {"pool-a", "pool-b"}
    yield


def _standby_refuses_the_primary_pool(s: SchedSide):
    s.gangs("pool-a", 2)
    _create_replicated(s)
    s.mgr.run_until_idle()
    yield
    s.mgr.advance(60.0)
    s.mgr.run_until_idle()
    pools = _pools(s)
    assert set(pools) == {"0", "1"} and pools["0"] != pools["1"]
    yield


def _anti_affinity_off_shares(s: SchedSide):
    s.gangs("pool-a", 2)
    _create_replicated(s, anti_affine=False)
    s.mgr.run_until_idle()
    pools = _pools(s)
    assert pools["0"] == pools["1"] == "pool-a"
    yield


def _bypass_never_double_books(s: SchedSide):
    """Two exact-fit pools and a notebook of two gangs: the second gang
    sees the first's nodes as taken in the same pass."""
    s.gangs("ext-a", 1)
    s.gangs("ext-b", 1)
    _create_replicated(s, anti_affine=False)
    s.mgr.run_until_idle()
    pools = _pools(s)
    assert pools["0"] != pools["1"]
    bound = [p.spec["nodeName"] for p in s.api.list("Pod", "default")
             if p.spec.get("nodeName")]
    assert len(bound) == len(set(bound)) == 2 * s.hosts
    yield


def _partial_coverage_evicts_nobody(s: SchedSide):
    """The victim frees one gang, the beneficiary needs two: nobody is
    evicted."""
    s.gangs("card", 1)
    s.create("victim", "t-low", priority="low")
    s.mgr.run_until_idle()
    s.cluster.set_session_payload("t-low", "victim", b"kernel-state-A")
    yield
    _create_replicated(s, "ben", "t-hi", priority="high")
    s.mgr.run_until_idle()
    assert _pools(s, "victim", "t-low") and not _pools(s, "ben", "t-hi")
    yield


SCHEDULE = {"disjoint-pools": (_disjoint_pools, {}),
            "standby-refuses-primary-pool": (
                _standby_refuses_the_primary_pool,
                {"WARMPOOL_PROVISION_S": "60"}),
            "anti-affinity-off": (_anti_affinity_off_shares, {}),
            "bypass-never-double-books": (_bypass_never_double_books, {}),
            "partial-coverage": (_partial_coverage_evicts_nobody,
                                 {"WARMPOOL_PROVISION_S": "3600"})}


@pytest.mark.parametrize("hosts", [1, 2])
@pytest.mark.parametrize("scenario", sorted(SCHEDULE))
def test_replicated_placement_matches_the_reference(scenario, hosts):
    """tests/test_torch_scheduler.py's state after every step (placement
    and queued annotations, pool and quota status, sliceHealth, Events,
    the five families' samples, the pods), equal on both sides."""
    fn, env = SCHEDULE[scenario]
    sides = [SchedSide(port, hosts, env=env,
                       session=scenario == "partial-coverage")
             for port in (False, True)]
    steps = [fn(s) for s in sides]
    for n, _ in enumerate(zip(*steps)):
        ref, ours = (s.snapshot() for s in sides)
        assert ours == ref, f"{scenario} step {n}"
