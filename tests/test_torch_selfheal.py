"""The port's self-healing engine against the reference's.

The same drills (tests/test_selfheal.py's; its replicated tier is held
by tests/test_torch_replication.py) go through the reference's stack on a `spec.tpu` notebook and the port's
on a `spec.gpu` gang of the same host count (1 and 2 hosts), each on its
own FakeClock from the same epoch.  After every step of a drill the two
sides must agree exactly:

- `status.sliceRecovery`, `status.sessionState` and `sliceHealth`, field
  for field, and the RecoveryExhausted condition;
- the Events (type, reason, count, and the message with the reference's
  device word "slice" read as the port's "gang");
- the samples of the engine's metric families;
- the pods: which were deleted, in order, and each live pod's restore
  env (CHECKPOINT_RESTORE_URI/_GENERATION) and restore stamps.

The clocks are fake and the state exact, so no tolerance applies.  Then
the pieces the drills rest on: `DirSessionStore.request_final_snapshot`
with a handler, without one and with an unreachable gang (read back by
the reference's store), the recovery knobs' parse and the metric
families' names against the reference's.  Only the reference's control
plane is imported."""

from __future__ import annotations

import dataclasses

import pytest

from kubeflow_tpu import kube as ref_kube
from kubeflow_tpu.api.types import Notebook as RefNotebook
from kubeflow_tpu.api.types import TPUSpec
from kubeflow_tpu.core import selfheal as ref_selfheal
from kubeflow_tpu.core.metrics import NotebookMetrics as RefMetrics
from kubeflow_tpu.core.notebook_controller import (
    setup_core_controllers as ref_setup,
)
from kubeflow_tpu.core.sessionstate import DirSessionStore as RefDirStore
from kubeflow_tpu.core.sessionstate import (
    InMemorySessionStore as RefMemStore,
)
from kubeflow_tpu.utils.clock import FakeClock as RefFakeClock
from kubeflow_tpu.utils.config import CoreConfig as RefConfig
from kubeflow_tpu_torch import kube
from kubeflow_tpu_torch.api.types import GPUSpec, Notebook
from kubeflow_tpu_torch.core import constants as C
from kubeflow_tpu_torch.core import selfheal
from kubeflow_tpu_torch.core.metrics import NotebookMetrics
from kubeflow_tpu_torch.core.notebook_controller import setup_core_controllers
from kubeflow_tpu_torch.core.sessionstate import (
    DirSessionStore,
    InMemorySessionStore,
)
from kubeflow_tpu_torch.utils.clock import FakeClock
from kubeflow_tpu_torch.utils.config import CoreConfig

NS, NAME = "u1", "heal"
# one host: v5e 2x4 (8 chips) and one 8-GPU host; two hosts: v4 2x2x2
# (4 chips a host) and two 8-GPU hosts
SHAPES = {1: (("tpu-v5-lite-podslice", "v5e", "2x4", 8), 8),
          2: (("tpu-v4-podslice", "v4", "2x2x2", 4), 16)}
FAMILIES = ("notebook_slice_restarts_total",
            "notebook_disruption_recovery_seconds",
            "notebook_migrations_total",
            "notebook_checkpoint_snapshots_total",
            "notebook_checkpoint_age_seconds")
# the replicated tier's families (the promote verb, the write fence),
# held to the reference by tests/test_torch_replication.py
REPLICATION_FAMILIES = ("notebook_promotions_total",
                        "notebook_promotion_duration_seconds",
                        "notebook_replication_fenced_writes_total")
RESTORE_ENV = (C.ENV_CHECKPOINT_RESTORE_URI,
               C.ENV_CHECKPOINT_RESTORE_GENERATION)


class Side:
    """One stack: the reference's (`port=False`) on a spec.tpu notebook or
    the port's on a spec.gpu gang, `hosts` hosts either way."""

    def __init__(self, port: bool, hosts: int, extra_nodes: int = 0,
                 no_nodes: bool = False, session: bool = False, **cfg):
        self.port, self.hosts = port, hosts
        self.kube = kube if port else ref_kube
        self.api = self.kube.ApiServer()
        self.cluster = self.kube.FakeCluster(self.api)
        self.cluster.add_node("cpu-node",
                              allocatable={"cpu": "64", "memory": "256Gi"})
        if not no_nodes:
            self.add_nodes(hosts + extra_nodes)
        self.clock = FakeClock() if port else RefFakeClock()
        self.store = None
        if session:
            self.store = (InMemorySessionStore if port else RefMemStore)(
                clock=self.clock)
            self.cluster.attach_session_store(self.store,
                                              default_payload=b"kernel")
            cfg.setdefault("checkpoint_store_uri", "mem://session-state")
        self.cfg = (CoreConfig if port else RefConfig)(**cfg)
        self.deleted: list[str] = []
        self.api.watch(self._on_pod, kinds=["Pod"])
        self.manager()

    def add_nodes(self, n: int) -> None:
        (gke, _, topo, chips), _ = SHAPES[self.hosts]
        if self.port:
            self.cluster.add_gpu_nodes("h100-80gb", n, 8)
        else:
            self.cluster.add_tpu_slice_nodes(gke, topo, n, chips)

    def manager(self) -> None:
        """A fresh manager and metrics over the same store and clock (the
        first one, or a failover)."""
        self.mgr = self.kube.Manager(self.api, clock=self.clock)
        self.metrics = (NotebookMetrics if self.port else RefMetrics)(
            self.api)
        kw = {"session": self.store} if self.store is not None else {}
        (setup_core_controllers if self.port else ref_setup)(
            self.mgr, self.cfg, self.metrics, **kw)

    def _on_pod(self, ev) -> None:
        if ev.type.value == "DELETED":
            self.deleted.append(ev.obj.name)

    def create(self) -> None:
        (_, acc, topo, _), count = SHAPES[self.hosts]
        if self.port:
            self.api.create(kube.KubeObject.from_dict(Notebook.new(
                NAME, NS, gpu=GPUSpec("h100-80gb", count)).obj))
        else:
            self.api.create(RefNotebook.new(
                NAME, NS, tpu=TPUSpec(acc, topo)).obj)
        self.mgr.run_until_idle()

    def annotate(self, key: str, value) -> None:
        nb = self.api.get("Notebook", NS, NAME)
        if value is None:
            nb.metadata.annotations.pop(key, None)
        else:
            nb.metadata.annotations[key] = value
        self.api.update(nb)

    def last(self) -> str:
        return f"{NAME}-{self.hosts - 1}"

    def node_of(self, pod: str) -> str:
        return self.api.get("Pod", NS, pod).spec["nodeName"]

    def snapshot(self) -> dict:
        status = self.api.get("Notebook", NS, NAME).body.get("status") or {}
        exhausted = [
            {k: _device_words(v) if k == "message" else v
             for k, v in c.items() if k != "lastTransitionTime"}
            for c in status.get("conditions") or []
            if c.get("type") == "RecoveryExhausted"]
        events = sorted(
            (e.body["type"], e.body["reason"], e.body.get("count", 1),
             _device_words(e.body["message"]))
            for e in self.api.list("Event", namespace=NS))
        pods = {}
        for p in self.api.list("Pod", namespace=NS):
            env = {e["name"]: e.get("value")
                   for e in p.spec["containers"][0].get("env", [])
                   if e["name"] in RESTORE_ENV}
            stamps = {k: v for k, v in p.metadata.annotations.items()
                      if k in (C.ANNOTATION_RESTORED_GENERATION,
                               C.ANNOTATION_RESTORED_DIGEST)}
            phase = (p.body.get("status") or {}).get("phase")
            pods[p.name] = (phase, env, stamps)
        samples = sorted(
            line for line in self.metrics.registry.render().splitlines()
            if line.startswith(FAMILIES))
        return {"sliceHealth": status.get("sliceHealth"),
                "sliceRecovery": status.get("sliceRecovery"),
                "sessionState": status.get("sessionState"),
                "exhausted": exhausted, "events": events, "pods": pods,
                "deleted": list(self.deleted), "samples": samples,
                "annotations": sorted(
                    k for k in self.api.get("Notebook", NS, NAME)
                    .metadata.annotations if k.startswith("notebooks."))}


def _device_words(text: str) -> str:
    """The reference's device word read as the port's."""
    return text.replace("slice", "gang")


# -- the drills: each takes a Side and yields after every step ------------------


def _failed_worker(s: Side):
    s.create()
    yield
    s.cluster.fail_pod(NS, s.last())
    s.mgr.run_until_idle()
    yield


def _crash_loop(s: Side):
    s.create()
    s.cluster.crashloop_pod(NS, f"{NAME}-0")
    s.mgr.run_until_idle()
    yield


def _node_deleted_spare_capacity(s: Side):
    s.create()
    victim = s.node_of(s.last())
    s.cluster.delete_node(victim)
    s.mgr.run_until_idle()
    yield
    assert all(p.spec["nodeName"] != victim
               for p in s.api.list("Pod", namespace=NS))


def _pending_within_deadline(s: Side):
    s.create()        # no accelerator nodes: every worker parks Pending
    yield
    s.mgr.advance(100)
    yield


def _pending_past_deadline_exhausts(s: Side):
    s.create()
    for _ in range(12):
        s.mgr.advance(120)
        yield
    s.mgr.advance(10000)
    yield


def _budget_survives_failover(s: Side):
    s.create()
    s.cluster.poison_statefulset(NS, NAME)
    s.mgr.enqueue_all()
    s.mgr.run_until_idle()
    yield
    s.mgr.advance(10)
    yield
    s.manager()       # leader failover: all but the CR is new
    s.mgr.enqueue_all()
    s.mgr.run_until_idle()
    yield
    for dt in (20, 40, 300, 10000):
        s.mgr.advance(dt)
        yield


def _operator_fix_resets_budget(s: Side):
    s.create()
    s.cluster.poison_statefulset(NS, NAME)
    s.mgr.enqueue_all()
    s.mgr.run_until_idle()
    for _ in range(4):
        s.mgr.advance(50)
    yield
    s.cluster.heal_statefulset(NS, NAME)
    s.annotate(C.ANNOTATION_NOTEBOOK_RESTART, "true")
    s.mgr.run_until_idle()
    yield
    s.cluster.fail_pod(NS, f"{NAME}-0")
    s.mgr.run_until_idle()
    yield


def _transient_not_ready(s: Side):
    s.create()
    pod = s.api.get("Pod", NS, s.last())
    for cond in pod.body["status"]["conditions"]:
        if cond["type"] == "Ready":
            cond["status"] = "False"
    s.api.update_status(pod)
    s.mgr.run_until_idle()
    yield


def _disabled(s: Side):
    s.create()
    s.cluster.fail_pod(NS, s.last())
    s.mgr.run_until_idle()
    yield


def _error_mid_gang(s: Side):
    s.create()
    delete, fired = s.api.delete, []

    def first_pod_delete_fails(kind, namespace, name, *args, **kw):
        if kind == "Pod" and not fired:
            fired.append(name)
            raise s.kube.ServerError("injected: pod delete unavailable")
        return delete(kind, namespace, name, *args, **kw)

    s.api.delete = first_pod_delete_fails
    s.annotate(C.ANNOTATION_NOTEBOOK_RESTART, "true")
    s.mgr.run_until_idle()
    s.api.delete = delete
    assert fired
    yield


def _fresh_checkpoint_migrates(s: Side):
    s.create()
    s.cluster.set_session_payload(NS, NAME, b"kernel-state-A")
    s.cluster.snapshot_sessions(NS, NAME)
    yield
    s.cluster.fail_pod(NS, s.last())
    s.mgr.run_until_idle()
    yield


def _stale_checkpoint_bare_restart(s: Side):
    s.create()
    s.cluster.snapshot_sessions(NS, NAME)
    s.clock.advance(3600)
    s.mgr.run_until_idle()
    s.cluster.fail_pod(NS, s.last())
    s.mgr.run_until_idle()
    yield


def _drain_annotation(s: Side):
    s.create()
    s.cluster.set_session_payload(NS, NAME, b"drained-state")
    s.annotate(C.ANNOTATION_MIGRATE, "drain")
    s.mgr.run_until_idle()
    yield


def _cordoned_node(s: Side):
    s.create()
    s.cluster.set_session_payload(NS, NAME, b"on-cordoned-node")
    victim = s.node_of(s.last())
    s.cluster.cordon_node(victim)
    s.mgr.run_until_idle()
    yield
    assert all(p.spec["nodeName"] != victim
               for p in s.api.list("Pod", namespace=NS))
    s.cluster.uncordon_node(victim)
    s.mgr.run_until_idle()
    yield


def _restore_hold(s: Side):
    """The recreated pods stay Pending while they reload the snapshot;
    the recovery latency is the held time."""
    s.create()
    s.cluster.restore_hold = True
    s.cluster.set_session_payload(NS, NAME, b"held-state")
    s.cluster.snapshot_sessions(NS, NAME)
    s.cluster.fail_pod(NS, s.last())
    s.mgr.run_until_idle()
    yield
    s.clock.advance(30)
    assert s.cluster.release_restores() == s.hosts
    s.mgr.run_until_idle()
    yield


def _voluntary_without_checkpoint(s: Side):
    s.store.set_final_snapshot_handler(None)   # the gang is unreachable
    s.create()
    s.annotate(C.ANNOTATION_MIGRATE, "defrag")
    s.mgr.run_until_idle()
    yield


def _migrate_and_restart_share_budget(s: Side):
    s.create()
    s.cluster.snapshot_sessions(NS, NAME)
    s.cluster.poison_statefulset(NS, NAME)
    s.mgr.enqueue_all()
    s.mgr.run_until_idle()
    yield
    for _ in range(8):
        s.mgr.advance(50)
        yield
    s.mgr.advance(10000)
    yield


_BUDGET = dict(recovery_backoff_base_s=10.0, recovery_backoff_max_s=300.0,
               recovery_window_s=100000.0)
# name -> (drill, Side arguments)
DRILLS = {
    "failed-worker": (_failed_worker, {}),
    "crash-loop": (_crash_loop, {}),
    "node-deleted": (_node_deleted_spare_capacity, {"extra_nodes": 1}),
    "pending-within-deadline": (_pending_within_deadline, {
        "no_nodes": True}),
    "pending-past-deadline": (_pending_past_deadline_exhausts, {
        "no_nodes": True, **_BUDGET, "recovery_max_attempts": 3,
        "recovery_pending_deadline_s": 60.0}),
    "budget-survives-failover": (_budget_survives_failover, {
        **_BUDGET, "recovery_max_attempts": 4}),
    "operator-fix-resets-budget": (_operator_fix_resets_budget, {
        "recovery_backoff_base_s": 5.0, "recovery_max_attempts": 2,
        "recovery_window_s": 100000.0}),
    "transient-not-ready": (_transient_not_ready, {}),
    "disabled": (_disabled, {"enable_self_healing": False}),
    "error-mid-gang": (_error_mid_gang, {}),
    "fresh-checkpoint": (_fresh_checkpoint_migrates, {"session": True}),
    "stale-checkpoint": (_stale_checkpoint_bare_restart, {
        "session": True, "checkpoint_max_age_s": 300.0}),
    "drain-annotation": (_drain_annotation, {"session": True}),
    "cordoned-node": (_cordoned_node, {"session": True, "extra_nodes": 4}),
    "voluntary-without-checkpoint": (_voluntary_without_checkpoint, {
        "session": True}),
    "restore-hold": (_restore_hold, {"session": True}),
    "shared-budget": (_migrate_and_restart_share_budget, {
        "session": True, "checkpoint_max_age_s": 25.0,
        "recovery_backoff_base_s": 10.0, "recovery_backoff_max_s": 40.0,
        "recovery_max_attempts": 3, "recovery_window_s": 100000.0}),
}

# what each drill must show on the port's side, beyond agreeing with the
# reference: (last sliceHealth, restarts by reason, migrations by
# (trigger, result), whole gangs deleted)
EXPECT = {
    "failed-worker": ("Healthy", {"pod-failed": 1}, {}, 1),
    "crash-loop": ("Healthy", {"crash-loop": 1}, {}, 1),
    "node-deleted": ("Healthy", {"node-gone": 1}, {}, 1),
    "pending-within-deadline": ("Unhealthy", {}, {}, 0),
    "pending-past-deadline": ("Unhealthy", {"pending-timeout": 3}, {}, 3),
    "budget-survives-failover": ("Unhealthy", {"pod-failed": 2}, {}, 4),
    "operator-fix-resets-budget": ("Healthy", {"pod-failed": 3}, {}, 4),
    "transient-not-ready": (None, {}, {}, 0),
    "disabled": (None, {}, {}, 0),
    "error-mid-gang": ("Healthy", {}, {}, 1),   # the annotation's sweep
    "fresh-checkpoint": ("Healthy", {"migrate": 1}, {
        ("failure", "migrated"): 1, ("failure", "restored"): 1}, 1),
    "stale-checkpoint": ("Healthy", {"pod-failed": 1}, {
        ("failure", "fallback-restart"): 1}, 1),
    "drain-annotation": ("Healthy", {"migrate": 1}, {
        ("drain", "migrated"): 1, ("drain", "restored"): 1}, 1),
    "cordoned-node": ("Healthy", {"migrate": 1}, {
        ("node-drain", "migrated"): 1, ("node-drain", "restored"): 1}, 1),
    "voluntary-without-checkpoint": ("Healthy", {}, {
        ("defrag", "skipped"): 1}, 0),
    "restore-hold": ("Healthy", {"migrate": 1}, {
        ("failure", "migrated"): 1, ("failure", "restored"): 1}, 1),
    "shared-budget": ("Unhealthy", {"migrate": 1, "pod-failed": 2}, {
        ("failure", "migrated"): 1, ("failure", "fallback-restart"): 2}, 3),
}


@pytest.mark.parametrize("hosts", sorted(SHAPES))
@pytest.mark.parametrize("drill", sorted(DRILLS))
def test_recovery_drill_matches_the_reference(drill, hosts):
    fn, kw = DRILLS[drill]
    ref, ours = Side(False, hosts, **kw), Side(True, hosts, **kw)
    ref_steps, our_steps = fn(ref), fn(ours)
    for i, _ in enumerate(zip(ref_steps, our_steps, strict=True)):
        want, got = ref.snapshot(), ours.snapshot()
        for key in want:
            assert got[key] == want[key], (drill, hosts, i, key)
    health, restarts, migrations, gangs = EXPECT[drill]
    if health is not None:
        assert got["sliceHealth"] == health
    assert {r: ours.metrics.slice_restarts.value(NS, r)
            for r in restarts} == restarts
    assert {m: ours.metrics.migrations.value(*m)
            for m in migrations} == migrations
    # the injected error loses one delete of the first sweep, which the
    # retry's whole sweep makes good
    lost = 1 if drill == "error-mid-gang" else 0
    assert len(got["deleted"]) == (gangs + lost) * hosts - lost
    if drill == "restore-hold":
        assert ours.metrics.disruption_recovery_seconds.sum_value(NS) == 30
    if drill in ("pending-past-deadline", "budget-survives-failover",
                 "shared-budget"):
        assert got["exhausted"] and got["exhausted"][0]["status"] == "True"
        assert got["sliceRecovery"]["0"]["exhausted"] is True
    if migrations.get(("failure", "restored")) or \
            migrations.get(("drain", "restored")):
        # every recreated worker restored the secured snapshot
        entry = got["sessionState"]["0"]
        assert entry["phase"] == "restored"
        for _, env, stamps in got["pods"].values():
            assert env[C.ENV_CHECKPOINT_RESTORE_GENERATION] == \
                stamps[C.ANNOTATION_RESTORED_GENERATION] == \
                str(entry["restoreGeneration"])
            assert stamps[C.ANNOTATION_RESTORED_DIGEST] == entry["digest"]


_TABLE = [
    ("pod-failed", dict(phase="Failed", ready=False), True),
    ("crash-loop", dict(ready=False, waiting="CrashLoopBackOff"), True),
    ("node-deleted", dict(node="ghost-node"), True),
    ("node-unready", dict(node="sick-node"), False),
    ("pending-unscheduled", dict(phase="Pending", ready=False), True),
    ("image-pull-backoff", dict(phase="Pending", ready=False,
                                waiting="ImagePullBackOff"), True),
    ("container-creating", dict(phase="Pending", ready=False,
                                waiting="ContainerCreating",
                                node="ok-node"), True),
    ("healthy", dict(node="ok-node"), True),
    ("running-not-ready", dict(ready=False, node="ok-node"), True),
    ("cordoned", dict(node="cordoned-node"), True),
]


@pytest.mark.parametrize("label,pod,node_ready", _TABLE,
                         ids=[row[0] for row in _TABLE])
def test_classification_matches_the_reference(label, pod, node_ready):
    """The classification table of the reference's tests, and
    `node_drained`, on each package's own objects."""
    got = []
    for k, mod in ((ref_kube, ref_selfheal), (kube, selfheal)):
        api = k.ApiServer()
        for name in ("ok-node", "sick-node", "cordoned-node"):
            ready = node_ready or name != "sick-node"
            api.create(k.KubeObject.from_dict({
                "apiVersion": "v1", "kind": "Node",
                "metadata": {"name": name},
                "spec": {"unschedulable": True}
                if name == "cordoned-node" else {},
                "status": {"conditions": [
                    {"type": "Ready",
                     "status": "True" if ready else "False"}]}}))
        ready = pod.get("ready", True)
        spec = {"containers": [{"name": "main"}]}
        if pod.get("node"):
            spec["nodeName"] = pod["node"]
        obj = k.KubeObject.from_dict({
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "w-0", "namespace": NS},
            "spec": spec,
            "status": {
                "phase": pod.get("phase", "Running"),
                "conditions": [{"type": "Ready",
                                "status": "True" if ready else "False"}],
                "containerStatuses": [{
                    "name": "main", "ready": ready,
                    "state": ({"waiting": {"reason": pod["waiting"]}}
                              if pod.get("waiting") else
                              {"running": {"startedAt":
                                           "2023-01-01T00:00:00Z"}})}]}})
        got.append((mod.classify_worker(obj, api),
                    mod.node_drained(obj, api)))
    assert got[1] == got[0], label
    assert got[1][0] == {
        "pod-failed": selfheal.REASON_POD_FAILED,
        "crash-loop": selfheal.REASON_CRASH_LOOP,
        "node-deleted": selfheal.REASON_NODE_GONE,
        "node-unready": selfheal.REASON_NODE_GONE,
        "pending-unscheduled": selfheal.PENDING,
        "image-pull-backoff": selfheal.PENDING,
        "container-creating": selfheal.PENDING,
    }.get(label), label
    assert got[1][1] == (label == "cordoned")


# -- the pieces the drills rest on ---------------------------------------------


@pytest.mark.parametrize("case", ["handler", "no-handler", "unreachable"])
def test_dir_store_final_snapshot(tmp_path, case):
    """`request_final_snapshot` on the directory store the pods' sidecars
    share: the fake cluster answers for a reachable gang with a `final`
    snapshot that the reference's store reads back; without a handler,
    or with a failed worker, it is None and nothing is written."""
    clock = FakeClock()
    store = DirSessionStore(str(tmp_path), clock=clock)
    api = kube.ApiServer()
    cluster = kube.FakeCluster(api)
    cluster.add_gpu_nodes("h100-80gb", 2, 8)
    mgr = kube.Manager(api, clock=clock)
    setup_core_controllers(mgr, CoreConfig(enable_self_healing=False),
                           NotebookMetrics(api))
    api.create(kube.KubeObject.from_dict(Notebook.new(
        NAME, NS, gpu=GPUSpec("h100-80gb", 16)).obj))
    mgr.run_until_idle()
    if case != "no-handler":
        cluster.attach_session_store(store)
    cluster.set_session_payload(NS, NAME, b"train-state")
    if case == "unreachable":
        cluster.fail_pod(NS, f"{NAME}-1")
    info = store.request_final_snapshot(NS, NAME, 0)
    if case != "handler":
        assert info is None
        assert store.latest(NS, NAME, 0) is None
        return
    assert (info.generation, info.trigger, info.size) == (1, "final", 11)
    assert store.request_final_snapshot(NS, NAME, 1) is None
    assert store.info(NS, NAME, 0, 1) == info
    ref = RefDirStore(str(tmp_path), clock=RefFakeClock())
    assert dataclasses.asdict(ref.info(NS, NAME, 0, 1)) == \
        dataclasses.asdict(info)
    assert ref.payload(NS, NAME, 0, 1) == b"train-state"


@pytest.mark.parametrize("env", [{
    "RECOVERY_BACKOFF_BASE_S": "0.5", "RECOVERY_BACKOFF_MAX_S": "2.5",
    "RECOVERY_WINDOW_S": "90.5", "RECOVERY_PENDING_DEADLINE_S": "1.25",
    "RECOVERY_MAX_ATTEMPTS": "7", "CHECKPOINT_INTERVAL_S": "0.75",
    "CHECKPOINT_MAX_AGE_S": "1.5"}, {
    "RECOVERY_BACKOFF_BASE_S": "soon", "RECOVERY_BACKOFF_MAX_S": "",
    "RECOVERY_MAX_ATTEMPTS": "many", "CHECKPOINT_MAX_AGE_S": "old",
    "ENABLE_SELF_HEALING": "no"}], ids=["sub-second", "garbage"])
def test_recovery_knobs_parse_as_the_reference(env):
    ours, ref = CoreConfig.from_env(env), RefConfig.from_env(env)
    for f in dataclasses.fields(CoreConfig):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name


def test_metric_families_registered_as_the_reference():
    ours = dict(NotebookMetrics(kube.ApiServer()).registry.families())
    ref = dict(RefMetrics(ref_kube.ApiServer()).registry.families())
    for name in FAMILIES + REPLICATION_FAMILIES:
        assert ours[name] == ref[name], name
