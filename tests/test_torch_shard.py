"""The port's sharded fleet against the reference's.

`kubeflow_tpu_torch/kube/shard.py` (HashRing, ShardMember, FencedApi,
ShardedReplica, ShardedFleet), `main.build_sharded_fleet`, the
`notebook_shard_*` families of `core/metrics.py` and the `shard_handoff`
objective of `utils/slo.py`:

- The cases of tests/test_shard.py run as twins (tests/test_torch_patch.py:
  `twin_modules`, `run_twins`): the reference's own assertions on both
  packages, then every ApiServer's objects (the shard map's epochs,
  members and handoff records among them), audit log and verb counts
  equal.  TestRingProperties (a 13 s seeded sweep) is left to the
  reference's suite; the ring is held here over a fixed set of members
  and keys.  TestCrossProcessAdoption makes `spec.tpu` slices, so its
  three cases are written again below on both stacks.
- One join, kill, rejoin and leave sequence on both packages, each on its
  own FakeClock: the shard snapshot (epochs, handoff records,
  `keys_owned`, fenced rejections) after every step equal.
- Each write verb through a fenced client without authority: refused
  alike, with the same error.
- `build_sharded_fleet` of three replicas at 1 and 2 hosts, a `spec.tpu`
  slice on the reference and a `spec.gpu` gang of the same host count on
  the port beside CPU notebooks in four namespaces, through a kill of
  the gang's owner and a rejoin: the owners, the shard snapshot, the
  notebooks' status and the gang's StatefulSet, Services and pods equal
  but for the device's keys (tests/test_torch_gpu_contract.py's
  `_strip`), and the four families' samples equal.
- The three cross-process adoption cases (recovery budget, warm-pool
  claim, migrate intent) at 1 and 2 hosts: after every step the
  recovery and session records, health, placement and claims, and the
  deleted pods equal, and each package's gang holds the reference's
  assertions.

The fleets run on FakeClocks, so the state is exact and no tolerance
applies."""

from __future__ import annotations

import json

import pytest
from test_torch_gpu_contract import GPU_KEYS, TPU_KEYS, _strip
from test_torch_patch import case_ids, run_twins, twin_modules

from kubeflow_tpu import kube as ref_kube
from kubeflow_tpu.api.types import Notebook as RefNotebook
from kubeflow_tpu.api.types import TPUSpec
from kubeflow_tpu.core import constants as RC
from kubeflow_tpu.core import scheduler as ref_sched
from kubeflow_tpu.core.metrics import NotebookMetrics as RefMetrics
from kubeflow_tpu.core.notebook_controller import (
    setup_core_controllers as ref_setup,
)
from kubeflow_tpu.core.sessionstate import InMemorySessionStore as RefMemStore
from kubeflow_tpu.kube import shard as ref_shard
from kubeflow_tpu.main import build_sharded_fleet as ref_build_fleet
from kubeflow_tpu.utils.clock import FakeClock as RefFakeClock
from kubeflow_tpu.utils.config import CoreConfig as RefConfig
from kubeflow_tpu.utils.slo import default_objectives as ref_objectives
from kubeflow_tpu_torch import kube
from kubeflow_tpu_torch.api.types import GPUSpec, Notebook
from kubeflow_tpu_torch.core import constants as C
from kubeflow_tpu_torch.core import scheduler as sched
from kubeflow_tpu_torch.core.metrics import NotebookMetrics
from kubeflow_tpu_torch.core.notebook_controller import setup_core_controllers
from kubeflow_tpu_torch.core.sessionstate import InMemorySessionStore
from kubeflow_tpu_torch.gpu.device_plugin import label_gpu_node
from kubeflow_tpu_torch.kube import shard
from kubeflow_tpu_torch.main import build_sharded_fleet
from kubeflow_tpu_torch.utils.clock import FakeClock
from kubeflow_tpu_torch.utils.config import CoreConfig
from kubeflow_tpu_torch.utils.slo import default_objectives

SHARD = twin_modules("test_shard.py")
# left out of the twins: the seeded property sweep (the ring is held over
# a fixed set below) and the adoption cases on spec.tpu (written again)
NOT_TWINNED = ("TestRingProperties::", "TestCrossProcessAdoption::")
SHARD_CASES = [c for c in case_ids(SHARD["reference"])
               if not c.startswith(NOT_TWINNED)]
# hosts -> (reference: accelerator, topology, GKE label, chips a host;
# port: GPUs in the gang), as tests/test_torch_scheduler.py
SHAPES = {1: (("v5e", "2x4", "tpu-v5-lite-podslice", 8), 8),
          2: (("v4", "2x2x2", "tpu-v4-podslice", 4), 16)}
FAMILIES = ("notebook_shard_keys_owned", "notebook_shard_epoch",
            "notebook_shard_fenced_writes_total",
            "notebook_shard_handoff_duration_seconds")
NS, NAME = "u1", "heal"
TEAMS = [f"team-{i}" for i in range(4)]


# -- the reference's cases -----------------------------------------------------


def _ports_kinds(state: dict) -> dict:
    """A recorded state with the reference's warm-pool kind read as the
    port's (the one kind the two stores name apart)."""
    for store in state["stores"]:
        objects = store["objects"]
        if RC.WARMPOOL_KIND in objects:
            objects[C.WARMPOOL_KIND] = objects.pop(RC.WARMPOOL_KIND)
    return state


@pytest.mark.parametrize("case", SHARD_CASES)
def test_shard_cases_match_the_reference(case, tmp_path):
    states = run_twins(SHARD, case, tmp_path, compare=False)
    assert states["port"] == _ports_kinds(states["reference"]), case


def test_case_counts():
    assert len(case_ids(SHARD["reference"])) == 41
    assert len(SHARD_CASES) == 41 - 4 - 3


# -- the ring, the map and the fence -------------------------------------------


def test_ring_owners_equal_over_fixed_members_and_keys():
    keys = [(f"ns-{i}", f"nb-{i % 7}") for i in range(300)]
    for members in (["s0"], ["s0", "s1"], ["shard-0", "shard-1", "shard-2"],
                    [f"cp-{i}" for i in range(8)], ["b", "a", "c", "d"]):
        ref = ref_shard.HashRing(members)
        ours = shard.HashRing(members)
        assert ours.members == ref.members
        assert ours._points == ref._points
        assert [ours.owner_of(*k) for k in keys] == \
            [ref.owner_of(*k) for k in keys]
    assert (shard.VNODES, shard.DEFAULT_LEASE_DURATION_S,
            shard.DEFAULT_SHARDED_KINDS, shard.SHARD_MAP_KIND,
            shard.WRITE_VERBS) == \
        (ref_shard.VNODES, ref_shard.DEFAULT_LEASE_DURATION_S,
         ref_shard.DEFAULT_SHARDED_KINDS, ref_shard.SHARD_MAP_KIND,
         ref_shard.WRITE_VERBS)


class _Seen:
    def __init__(self, kube_mod):
        self.result = kube_mod.Result
        self.seen: list = []

    def reconcile(self, req):
        self.seen.append((req.namespace, req.name))
        return self.result()


def _map_sequence(port: bool) -> list:
    """Join three replicas, kill one, age its lease out, rejoin it, then
    a graceful leave: the shard snapshot, the committed map and each
    replica's keys after every step."""
    k, mod = (kube, shard) if port else (ref_kube, ref_shard)
    clock = FakeClock() if port else RefFakeClock()
    api = k.ApiServer()
    for i in range(12):
        nb = (Notebook.new(f"nb-{i}", TEAMS[i % 4]).obj if port else
              RefNotebook.new(f"nb-{i}", TEAMS[i % 4]).obj.to_dict())
        api.create(k.KubeObject.from_dict(nb))

    def factory(replica):
        replica.manager.register("nb", _Seen(k), for_kind="Notebook")

    fleet = mod.ShardedFleet(api, count=3, clock=clock,
                             controller_factory=factory)
    steps = []

    def step(label):
        fleet.settle()
        snap = fleet.shard_snapshot()
        steps.append((label, snap, fleet.map_status(),
                      {sid: sorted(r.cache.keys("Notebook"))
                       for sid, r in fleet.replicas.items()}))

    step("join")
    fleet.kill("shard-1")
    for _ in range(3):
        clock.advance(8)
        step("expire")
    fleet.rejoin("shard-1")
    step("rejoin")
    fleet.replicas["shard-2"].leave_fleet()
    step("leave")
    return steps


def test_map_sequence_matches_the_reference():
    ref, ours = _map_sequence(False), _map_sequence(True)
    assert ours == ref
    epochs = [snap["epoch"] for _, snap, _, _ in ours]
    assert epochs == sorted(epochs) and epochs[-1] > epochs[0]
    _, last, status, _ = ours[-1]
    assert last["members"] == ["shard-0", "shard-1"]
    assert status["lastHandoff"]["epoch"] == last["epoch"]
    assert sum(r["keys_owned"] for r in last["replicas"].values()) == 12


@pytest.mark.parametrize("verb", shard.WRITE_VERBS)
def test_every_fenced_verb_is_refused_alike(verb):
    out = {}
    for port in (False, True):
        k, mod = (kube, shard) if port else (ref_kube, ref_shard)
        clock = FakeClock() if port else RefFakeClock()
        api = k.ApiServer()
        a = mod.ShardMember(api, "a", clock=clock)
        b = mod.ShardMember(api, "b", clock=clock)
        a.join()
        fenced = mod.FencedApi(api, a)
        b.join()
        a.ack_drain()
        b.ack_adopt()
        for _ in range(3):
            clock.advance(8)
            b.renew()   # a stops renewing and is evicted
        with pytest.raises(mod.StaleEpochError) as err:
            getattr(fenced, verb)(None)
        out[port] = (str(err.value), fenced.rejected_total,
                     a.token.valid, api.dump().get("Notebook", []))
    assert out[True] == out[False]
    assert out[True][1:3] == (1, False)


def test_shard_handoff_objective_and_families_match_the_reference():
    env = {"SLO_SHARD_HANDOFF_P99_S": "2.5", "SHARD_COUNT": "4",
           "SHARD_LEASE_DURATION_S": "7.5"}
    ours = {o.name: o for o in default_objectives(CoreConfig.from_env(env))}
    ref = {o.name: o for o in ref_objectives(RefConfig.from_env(env))}
    assert set(ours) == set(ref)
    o, r = ours["shard_handoff"], ref["shard_handoff"]
    assert (o.kind, o.metric, o.threshold_s, o.description) == \
        (r.kind, r.metric, r.threshold_s, r.description)
    assert "shard_handoff" not in {
        o.name for o in default_objectives(CoreConfig())}
    inventory = NotebookMetrics(kube.ApiServer()).families()
    ref_inventory = RefMetrics(ref_kube.ApiServer()).families()
    for family in FAMILIES:
        ours = [i for i in inventory if i[0] == family]
        assert len(ours) == 1
        assert ours == [i for i in ref_inventory if i[0] == family]


# -- build_sharded_fleet: a gang against a slice -------------------------------


class FleetSide:
    """`build_sharded_fleet` of three replicas: the reference's
    (`port=False`) with a spec.tpu slice, or the port's with a spec.gpu
    gang, `hosts` hosts either way, beside CPU notebooks."""

    def __init__(self, port: bool, hosts: int):
        self.port, self.hosts = port, hosts
        self.kube = kube if port else ref_kube
        self.clock = FakeClock() if port else RefFakeClock()
        build = build_sharded_fleet if port else ref_build_fleet
        cfg = (CoreConfig if port else RefConfig).from_env(
            {"SLO_SHARD_HANDOFF_P99_S": "30"})
        self.fleet, self.api, self.cluster, self.metrics = build(
            cfg, count=3, clock=self.clock)
        self.cluster.add_node("cpu-node",
                              allocatable={"cpu": "64", "memory": "256Gi"})
        for i in range(8):
            self.create_cpu(f"nb-{i}", TEAMS[i % 4])
        (acc, topo, _, _), gpus = SHAPES[hosts]
        if port:
            nb = Notebook.new("gang", NS, gpu=GPUSpec("h100-80gb", gpus)).obj
        else:
            nb = RefNotebook.new("gang", NS,
                                 tpu=TPUSpec(acc, topo)).obj.to_dict()
        self.api.create(self.kube.KubeObject.from_dict(nb))

    def create_cpu(self, name: str, ns: str) -> None:
        nb = (Notebook.new(name, ns).obj if self.port
              else RefNotebook.new(name, ns).obj.to_dict())
        self.api.create(self.kube.KubeObject.from_dict(nb))

    def add_hosts(self) -> None:
        add_accelerator_hosts(self, "pool-a", self.hosts)

    def owners(self) -> dict:
        out = {}
        for nb in self.api.list("Notebook"):
            claimants = [sid for sid, r in self.fleet.replicas.items()
                         if r.alive and r.owns_key(nb.namespace, nb.name)]
            assert claimants == [self.fleet.owner_of(nb.namespace, nb.name)]
            out[f"{nb.namespace}/{nb.name}"] = claimants[0]
        return out

    def state(self) -> dict:
        keys = TPU_KEYS if not self.port else GPU_KEYS
        notebooks = {}
        for nb in self.api.list("Notebook"):
            status = nb.body.get("status") or {}
            notebooks[f"{nb.namespace}/{nb.name}"] = {
                k: status.get(k) for k in ("sliceHealth", "workerStates",
                                           "readyReplicas")}
        rendered = {}
        for kind in ("StatefulSet", "Service"):
            for obj in self.api.list(kind):
                d = obj.to_dict()
                meta = {k: v for k, v in d["metadata"].items()
                        if k in ("name", "namespace", "labels",
                                 "annotations") and v}
                rendered[f"{kind} {obj.namespace}/{obj.name}"] = _strip(
                    {"apiVersion": d["apiVersion"], "kind": d["kind"],
                     "metadata": meta, "spec": d["spec"]}, keys)
        for m in rendered.values():
            labels = m["spec"].get("template", {}).get("metadata", {}).get(
                "labels", {})
            labels.pop(RC.TPU_SLICE_LABEL, None)
        pods = sorted((p.namespace, p.name, p.spec.get("nodeName"),
                       (p.body.get("status") or {}).get("phase"))
                      for p in self.api.list("Pod"))
        self.metrics.scrape()
        samples = sorted(line for line in
                         self.metrics.registry.render().splitlines()
                         if line.startswith(FAMILIES))
        return {"owners": self.owners(),
                "shards": self.fleet.shard_snapshot(),
                "notebooks": notebooks, "rendered": rendered, "pods": pods,
                "samples": samples}


def add_accelerator_hosts(side, pool: str, n: int) -> None:
    """`n` accelerator hosts named pool-0.. in node pool `pool`: the
    reference's TPU hosts of its shape, the port's 8-GPU hosts."""
    (acc, topo, gke, chips), _ = SHAPES[side.hosts]
    for i in range(n):
        name = f"{pool}-{i}"
        if side.port:
            side.cluster.add_node(name, labels={C.GKE_NODEPOOL_LABEL: pool},
                                  allocatable={"cpu": "96",
                                               "memory": "192Gi"})
            label_gpu_node(side.api, name, gpus=8, accelerator="h100-80gb")
        else:
            side.cluster.add_node(name, labels={
                RC.GKE_TPU_ACCELERATOR_LABEL: gke,
                RC.GKE_TPU_TOPOLOGY_LABEL: topo,
                RC.GKE_NODEPOOL_LABEL: pool}, allocatable={
                "cpu": "96", "memory": "192Gi",
                RC.TPU_RESOURCE: str(chips)})


def _fleet_life(s: FleetSide):
    """Settle with no accelerator host (the gang waits), kill the gang's
    owner and age its lease out, add the hosts, rejoin."""
    s.fleet.settle()
    yield s.state()
    owner = s.fleet.owner_of(NS, "gang")
    s.fleet.kill(owner)
    for _ in range(3):
        s.clock.advance(8)
        s.fleet.settle()
    yield s.state()
    s.add_hosts()
    s.fleet.settle()
    yield s.state()
    s.fleet.rejoin(owner)
    s.fleet.settle()
    yield s.state()


@pytest.mark.parametrize("hosts", [1, 2])
def test_fleet_renders_the_gang_as_the_slice(hosts):
    ref = list(_fleet_life(FleetSide(False, hosts)))
    ours_side = FleetSide(True, hosts)
    ours = list(_fleet_life(ours_side))
    assert ours == ref
    gang = f"{NS}/gang"
    assert [st["notebooks"][gang]["sliceHealth"] for st in ours] == \
        ["Unhealthy", "Unhealthy", "Healthy", "Healthy"]
    killed = ours[0]["owners"][gang]
    assert ours[1]["owners"][gang] != killed
    assert killed not in ours[1]["shards"]["members"]
    assert ours[3]["shards"]["members"] == ["shard-0", "shard-1", "shard-2"]
    assert len(ours[2]["pods"]) == 8 + hosts
    assert ours_side.fleet.cross_process_overlaps() == []
    # the ledger the replicas share saw the gang change hands before ready
    entry = ours_side.metrics.lifecycle.latest_entry(NS, "gang")
    assert entry["finalized"] and entry["stages"]["handoff_wait"] > 0


# -- cross-process adoption ----------------------------------------------------


class AdoptionSide:
    """The reference's make_adoption_fleet on either stack: two replicas
    running the core controllers over a fake cluster with `hosts`
    accelerator hosts in pool "pool-a"."""

    def __init__(self, port: bool, hosts: int, cfg: dict,
                 session: bool = False):
        self.port, self.hosts = port, hosts
        self.kube = kube if port else ref_kube
        self.api = self.kube.ApiServer()
        self.cluster = self.kube.FakeCluster(self.api)
        self.cluster.add_node("cpu-node",
                              allocatable={"cpu": "64", "memory": "256Gi"})
        add_accelerator_hosts(self, "pool-a", hosts)
        self.clock = FakeClock() if port else RefFakeClock()
        self.cfg = (CoreConfig if port else RefConfig).from_env(cfg)
        self.metrics = (NotebookMetrics if port else RefMetrics)(self.api)
        self.store = None
        if session:
            self.store = (InMemorySessionStore if port else RefMemStore)(
                clock=self.clock)
            self.cluster.attach_session_store(self.store)
        setup = setup_core_controllers if port else ref_setup

        def factory(replica):
            setup(replica.manager, self.cfg, self.metrics,
                  provisioner=self.cluster, session=self.store)

        self.fleet = (shard if port else ref_shard).ShardedFleet(
            self.api, count=2, clock=self.clock, controller_factory=factory)
        self.deleted: list = []
        self.api.watch(self._on_pod, kinds=["Pod"])
        (acc, topo, _, _), gpus = SHAPES[hosts]
        if port:
            nb = Notebook.new(NAME, NS, gpu=GPUSpec("h100-80gb", gpus)).obj
        else:
            nb = RefNotebook.new(NAME, NS,
                                 tpu=TPUSpec(acc, topo)).obj.to_dict()
        self.nb = nb

    def _on_pod(self, ev) -> None:
        if ev.type.value == "DELETED":
            self.deleted.append(ev.obj.name)

    def create(self) -> None:
        self.api.create(self.kube.KubeObject.from_dict(self.nb))
        self.fleet.settle()

    def owner_and_adopter(self):
        owner = self.fleet.owner_of(NS, NAME)
        adopter = next(s for s in self.fleet.replicas if s != owner)
        return self.fleet.replicas[owner], self.fleet.replicas[adopter]

    def kill_owner(self) -> None:
        owner, _ = self.owner_and_adopter()
        self.fleet.kill(owner.shard_id)
        for _ in range(3):
            self.clock.advance(8)
            self.fleet.settle()

    def pool_kind(self) -> str:
        return C.WARMPOOL_KIND if self.port else RC.WARMPOOL_KIND

    def status(self) -> dict:
        return self.api.get("Notebook", NS, NAME).body.get("status") or {}

    def delete_groups(self) -> int:
        """Audited worker-pod deletes in whole-gang groups (the
        reference's pod_delete_groups)."""
        recs = [r for r in self.api.audit_log(verb="delete", kind="Pod")
                if r.name.startswith(NAME + "-")]
        want = {f"{NAME}-{i}" for i in range(self.hosts)}
        groups = 0
        for i in range(0, len(recs), self.hosts):
            assert {r.name for r in recs[i:i + self.hosts]} == want
            groups += 1
        return groups

    def snapshot(self) -> dict:
        status = self.status()
        ann = self.api.get("Notebook", NS, NAME).metadata.annotations
        pools = {p.name: p.body.get("status")
                 for p in self.api.list(self.pool_kind())}
        pods = sorted((p.name, p.spec.get("nodeName"),
                       (p.body.get("status") or {}).get("phase"),
                       p.metadata.annotations.get(
                           C.ANNOTATION_RESTORED_GENERATION))
                      for p in self.api.list("Pod", namespace=NS))
        (acc, topo, _, _), gpus = SHAPES[self.hosts]
        token = f"h100-80gb-{gpus}" if self.port else f"{acc}-{topo}"
        state = {"sliceHealth": status.get("sliceHealth"),
                 "sliceRecovery": status.get("sliceRecovery"),
                 "sessionState": status.get("sessionState"),
                 "placement": ann.get(C.ANNOTATION_PLACEMENT),
                 "pools": pools, "pods": pods, "deleted": self.deleted,
                 "groups": self.delete_groups(),
                 "members": self.fleet.shard_snapshot()["members"]}
        return json.loads(json.dumps(state, sort_keys=True)
                          .replace(token, "SHAPE"))


def _recovery_budget(s: AdoptionSide):
    """The reference's test_recovery_budget_adopted_not_reset."""
    s.create()
    yield s.snapshot()
    victim, adopter = s.owner_and_adopter()
    s.cluster.poison_statefulset(NS, NAME)
    victim.manager.enqueue_all()
    victim.manager.run_until_idle(advance_clock=False)
    st = s.status()["sliceRecovery"]["0"]
    assert len(st["attempts"]) == 1 and s.delete_groups() == 1
    first = st["attempts"][0]
    yield s.snapshot()
    s.kill_owner()
    assert s.fleet.shard_snapshot()["members"] == [adopter.shard_id]
    assert s.status()["sliceRecovery"]["0"]["attempts"][0] == first
    yield s.snapshot()
    for _ in range(6):
        adopter.manager.advance(300)
    st = s.status()["sliceRecovery"]["0"]
    assert st["exhausted"] is True and st["attempts"][0] == first
    assert s.delete_groups() == s.cfg.recovery_max_attempts
    yield s.snapshot()
    adopter.manager.advance(10000)
    assert s.delete_groups() == s.cfg.recovery_max_attempts
    yield s.snapshot()


def _warmpool_claim(s: AdoptionSide):
    """The reference's test_warmpool_claim_adopted_not_reclaimed."""
    (acc, topo, _, _), gpus = SHAPES[s.hosts]
    pool = sched.new_pool_object("h100-80gb", gpus) if s.port \
        else ref_sched.new_pool_object(acc, topo)
    pool.body["status"] = {"slices": {
        "ws-0001": {"state": "Ready", "pool": "warm-a"},
        "ws-0002": {"state": "Ready", "pool": "warm-b"}}}
    s.api.create(pool)
    s.create()

    def claims():
        live = s.api.get(s.pool_kind(), "", pool.name)
        return {sid: e["claimedBy"] for sid, e in
                ((live.body.get("status") or {}).get("slices") or {}).items()
                if e.get("claimedBy")}

    before = claims()
    assert list(before.values()) == [f"{NS}/{NAME}"]
    intent = s.api.get("Notebook", NS, NAME).metadata.annotations.get(
        C.ANNOTATION_PLACEMENT)
    assert intent
    yield s.snapshot()
    s.kill_owner()
    assert claims() == before
    assert s.api.get("Notebook", NS, NAME).metadata.annotations.get(
        C.ANNOTATION_PLACEMENT) == intent
    yield s.snapshot()


def _migrate_intent(s: AdoptionSide):
    """The reference's test_migrate_intent_resumed_never_replayed."""
    s.create()
    s.cluster.set_session_payload(NS, NAME, b"kernel-state-A")
    (snap,) = s.cluster.snapshot_sessions(NS, NAME)
    victim, adopter = s.owner_and_adopter()
    yield s.snapshot()
    s.cluster.fail_pod(NS, f"{NAME}-{s.hosts - 1}")
    s.api.install_fault_plan(s.kube.FaultPlan([s.kube.FaultRule(
        verbs=("delete",), kinds=("Pod",), error="server",
        max_matches=100)]))
    victim.manager.enqueue_all()
    victim.manager.run_until_idle(advance_clock=False)
    s.api.clear_fault_plan()
    entry = s.status()["sessionState"]["0"]
    assert entry["phase"] == "migrating"
    assert entry["restoreGeneration"] == snap.generation
    assert len(s.status()["sliceRecovery"]["0"]["attempts"]) >= 1
    yield s.snapshot()
    s.kill_owner()
    for _ in range(10):
        adopter.manager.advance(10)
        st = s.status()
        if st.get("sliceHealth") == "Healthy" and \
                (st.get("sessionState") or {}).get("0", {}).get(
                    "phase") == "restored":
            break
    entry = s.status()["sessionState"]["0"]
    assert entry["phase"] == "restored"
    assert entry["restoreGeneration"] == snap.generation
    assert s.store.latest(NS, NAME, 0).generation == snap.generation
    for pod in s.api.list("Pod", namespace=NS):
        assert pod.metadata.annotations.get(
            C.ANNOTATION_RESTORED_GENERATION) == str(snap.generation)
    yield s.snapshot()


ADOPTIONS = {
    "recovery_budget": (_recovery_budget, {
        "RECOVERY_BACKOFF_BASE_S": "10", "RECOVERY_BACKOFF_MAX_S": "300",
        "RECOVERY_MAX_ATTEMPTS": "4", "RECOVERY_WINDOW_S": "100000"}, False),
    "warmpool_claim": (_warmpool_claim, {
        "ENABLE_SLICE_SCHEDULER": "true", "WARMPOOL_SIZE": "0",
        "WARMPOOL_PROVISION_S": "120", "ENABLE_SELF_HEALING": "false"},
        False),
    "migrate_intent": (_migrate_intent, {
        "CHECKPOINT_STORE_URI": "mem://session-state",
        "CHECKPOINT_MAX_AGE_S": "1000000", "RECOVERY_BACKOFF_BASE_S": "5",
        "RECOVERY_MAX_ATTEMPTS": "6", "RECOVERY_WINDOW_S": "100000"}, True),
}


@pytest.mark.parametrize("hosts", [1, 2])
@pytest.mark.parametrize("case", ADOPTIONS)
def test_adoption_matches_the_reference(case, hosts):
    drill, cfg, session = ADOPTIONS[case]
    ref = list(drill(AdoptionSide(False, hosts, cfg, session)))
    ours = list(drill(AdoptionSide(True, hosts, cfg, session)))
    assert ours == ref
    assert len(ours[-1]["members"]) == 1
