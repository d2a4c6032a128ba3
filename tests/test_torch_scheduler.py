"""The port's gang scheduler and tenancy layer against the reference's.

The scenarios of tests/test_scheduler.py and tests/test_preemption.py go
through the reference's stack on a `spec.tpu` notebook and the port's on
a `spec.gpu` gang of the same host count (1 and 2 hosts), each on its own
FakeClock from the same epoch.  One host is a v5e 2x4 slice (8 chips)
against an 8-GPU H100 host; two hosts are a v4 2x2x2 slice (2 x 4 chips)
against two 8-GPU hosts.  No TPU shape has two hosts of 8 chips, so at 2
hosts every GPU count is twice the chip count: the port's `chipQuota`
(GPUs) is the reference's scaled by that ratio, and the reference's chip
counts (preemption records, the PreemptionIssued message) are scaled by
it before they are compared.  After every step the two sides must agree
exactly on:

- the placement and queued annotations;
- the GPUWarmPool's and the TenantQuota's status (and TPUWarmPool's);
- `sliceHealth`;
- the Events, with the device words mapped ("Slice" -> "Gang", "chip"
  -> "GPU") and each side's shape token read as one;
- the samples of the five families (schedule attempts, warm-pool hits,
  pool census, preemptions, queue wait), and their HELP and TYPE lines;
- the pods: name, node and phase, and which were deleted, in order.

The replica anti-affinity and the two scenarios that need a notebook of
several gangs, which a `spec.gpu` notebook has only with replication (a
multi-slice bypass that must not double-book nodes; a beneficiary whose
two slices one victim cannot cover), run on this harness in
tests/test_torch_replication.py.  The fake cluster's cordon and
used-map satellites are the cluster's, not the scheduler's.

Two more scenarios hold the dequeue score at its boundary, where a
standard gang queued 6000 s before a high one ties it.  Then seeded
random inventories through both `CostFunctionPolicy.place`, and the pure
helpers on shared inputs.  The clocks are fake and the state
exact, so no tolerance applies.  Only the reference's control plane is
imported, and no process is launched."""

from __future__ import annotations

import json
import re

import numpy as np
import pytest

from kubeflow_tpu import kube as ref_kube
from kubeflow_tpu.api.types import Notebook as RefNotebook
from kubeflow_tpu.api.types import TPUSpec
from kubeflow_tpu.core import constants as RC
from kubeflow_tpu.core import scheduler as ref_sched
from kubeflow_tpu.core.culling_controller import (
    CullingReconciler as RefCullingReconciler,
)
from kubeflow_tpu.core.jupyter import FakeJupyterState as RefJupyter
from kubeflow_tpu.core.metrics import NotebookMetrics as RefMetrics
from kubeflow_tpu.core.notebook_controller import (
    setup_core_controllers as ref_setup,
)
from kubeflow_tpu.core.preemption import new_quota_object as ref_quota
from kubeflow_tpu.core.sessionstate import (
    InMemorySessionStore as RefMemStore,
)
from kubeflow_tpu.tpu.topology import resolve as ref_resolve
from kubeflow_tpu.utils.clock import FakeClock as RefFakeClock
from kubeflow_tpu.utils.config import CoreConfig as RefConfig
from kubeflow_tpu_torch import kube
from kubeflow_tpu_torch.api.types import (
    PRIORITY_CLASSES,
    PRIORITY_DEFAULT,
    PRIORITY_RANK,
    GPUSpec,
    Notebook,
)
from kubeflow_tpu_torch.core import constants as C
from kubeflow_tpu_torch.core import scheduler as sched
from kubeflow_tpu_torch.core.culling_controller import CullingReconciler
from kubeflow_tpu_torch.core.jupyter import FakeJupyterState
from kubeflow_tpu_torch.core.metrics import NotebookMetrics
from kubeflow_tpu_torch.core.notebook_controller import setup_core_controllers
from kubeflow_tpu_torch.core.preemption import new_quota_object
from kubeflow_tpu_torch.core.sessionstate import InMemorySessionStore
from kubeflow_tpu_torch.gpu.device_plugin import label_gpu_node
from kubeflow_tpu_torch.gpu.topology import resolve
from kubeflow_tpu_torch.utils.clock import FakeClock
from kubeflow_tpu_torch.utils.config import CoreConfig

# hosts -> (reference: accelerator, topology, GKE label, chips a host;
# port: GPUs in the gang)
SHAPES = {1: (("v5e", "2x4", "tpu-v5-lite-podslice", 8), 8),
          2: (("v4", "2x2x2", "tpu-v4-podslice", 4), 16)}
# a shape no node serves, for a beneficiary that can never place: the
# v5p slice's 8 chips against 8 A100s a chip (times the ratio)
OTHER = (("v5p", "2x2x2"), "a100-80gb")
FAMILIES = ("notebook_schedule_attempts_total",
            "notebook_warmpool_hits_total", "notebook_warmpool_size",
            "notebook_preemptions_total", "notebook_queue_wait_seconds")


class Side:
    """One stack: the reference's (`port=False`) on spec.tpu notebooks or
    the port's on spec.gpu gangs, `hosts` hosts a gang either way.  `env`
    takes the reference's env names; WARMPOOL_SHAPES is written "SHAPE"
    and read as each side's own shape."""

    def __init__(self, port: bool, hosts: int, env=None, session=False,
                 provisioner=True):
        self.port, self.hosts = port, hosts
        (acc, topo, gke, chips), gpus = SHAPES[hosts]
        self.ratio = 8 * hosts // (chips * hosts) if port else 1
        self.token = f"h100-80gb-{gpus}" if port else f"{acc}-{topo}"
        self.other_token = f"{OTHER[1]}-{8 * self.ratio}" if port \
            else "%s-%s" % OTHER[0]
        self.kube = kube if port else ref_kube
        self.api = self.kube.ApiServer()
        self.cluster = self.kube.FakeCluster(self.api)
        self.clock = FakeClock() if port else RefFakeClock()
        env = dict(env or {})
        env.setdefault("ENABLE_SLICE_SCHEDULER", "true")
        if env.get("WARMPOOL_SHAPES") == "SHAPE":
            env["WARMPOOL_SHAPES"] = f"h100-80gb:{gpus}" if port \
                else f"{acc}:{topo}"
        self.cfg = (CoreConfig if port else RefConfig).from_env(env)
        self.store = None
        if session:
            self.store = (InMemorySessionStore if port else RefMemStore)(
                clock=self.clock)
            self.cluster.attach_session_store(self.store)
        self.provisioner = provisioner
        self.deleted: list[str] = []
        self.api.watch(self._on_pod, kinds=["Pod"])
        self.manager()

    def manager(self) -> None:
        """A fresh manager and metrics over the same store and clock (the
        first one, or a failover)."""
        self.mgr = self.kube.Manager(self.api, clock=self.clock)
        self.metrics = (NotebookMetrics if self.port else RefMetrics)(
            self.api, manager=self.mgr)
        kw = {"provisioner": self.cluster if self.provisioner else None}
        if self.store is not None:
            kw["session"] = self.store
        (setup_core_controllers if self.port else ref_setup)(
            self.mgr, self.cfg, self.metrics, **kw)

    def _on_pod(self, ev) -> None:
        if ev.type.value == "DELETED":
            self.deleted.append(ev.obj.name)

    # -- inputs, the same names on both sides ---------------------------------
    def add_nodes(self, pool: str, n: int) -> None:
        """`n` accelerator hosts in node pool `pool`, named pool-0.."""
        (acc, topo, gke, chips), _ = SHAPES[self.hosts]
        for i in range(n):
            name = f"{pool}-{i}"
            if self.port:
                self.cluster.add_node(
                    name, labels={C.GKE_NODEPOOL_LABEL: pool},
                    allocatable={"cpu": "96", "memory": "192Gi"})
                label_gpu_node(self.api, name, gpus=8,
                               accelerator="h100-80gb")
            else:
                self.cluster.add_node(name, labels={
                    RC.GKE_TPU_ACCELERATOR_LABEL: gke,
                    RC.GKE_TPU_TOPOLOGY_LABEL: topo,
                    RC.GKE_NODEPOOL_LABEL: pool}, allocatable={
                    "cpu": "96", "memory": "192Gi",
                    RC.TPU_RESOURCE: str(chips)})

    def gangs(self, pool: str, n: int) -> None:
        """Unmanaged capacity for `n` gangs in node pool `pool`."""
        self.add_nodes(pool, n * self.hosts)

    def create(self, name: str, ns: str = "default", priority=None,
               annotations=None, other_shape: bool = False) -> None:
        (acc, topo, _, _), gpus = SHAPES[self.hosts]
        if self.port:
            gpu = GPUSpec(OTHER[1], 8 * self.ratio) if other_shape \
                else GPUSpec("h100-80gb", gpus)
            obj = Notebook.new(name, ns, gpu=gpu, annotations=annotations,
                               priority=priority).obj
            self.api.create(kube.KubeObject.from_dict(obj))
        else:
            tpu = TPUSpec(*OTHER[0]) if other_shape else TPUSpec(acc, topo)
            nb = RefNotebook.new(name, ns, tpu=tpu, annotations=annotations)
            if priority is not None:
                nb.obj.spec["priority"] = priority
            self.api.create(nb.obj)

    def annotate(self, name: str, key: str, value, ns: str = "default"):
        nb = self.api.get("Notebook", ns, name)
        if value is None:
            nb.metadata.annotations.pop(key, None)
        else:
            nb.metadata.annotations[key] = value
        self.api.update(nb)

    def stop(self, name: str, ns: str = "default") -> None:
        self.annotate(name, C.STOP_ANNOTATION, "true", ns)

    def set_quota(self, tenants=None, defaults=None) -> None:
        """TenantQuota spec in the reference's chips; the port's GPUs are
        the chips times the ratio."""
        def scaled(policy):
            return {k: (v * self.ratio if k == "chipQuota" else v)
                    for k, v in policy.items()}

        if self.api.try_get(C.TENANTQUOTA_KIND, "",
                            C.TENANTQUOTA_NAME) is None:
            self.api.create(new_quota_object() if self.port
                            else ref_quota())
        live = self.api.get(C.TENANTQUOTA_KIND, "", C.TENANTQUOTA_NAME)
        live.body["spec"] = {
            "tenants": {t: scaled(p) for t, p in (tenants or {}).items()},
            "defaults": scaled(defaults or {})}
        self.api.update(live)

    def pool_kind(self) -> str:
        return C.WARMPOOL_KIND if self.port else RC.WARMPOOL_KIND

    def pool_name(self) -> str:
        return f"warmpool-{self.token}"

    def new_pool(self, status: dict):
        (acc, topo, _, _), gpus = SHAPES[self.hosts]
        if self.port:
            obj = sched.new_pool_object("h100-80gb", gpus)
        else:
            obj = ref_sched.new_pool_object(acc, topo)
        obj.body["status"] = status
        return self.api.create(obj)

    def scheduler(self):
        """A scheduler constructed directly, off any manager."""
        cls = sched.SliceScheduler if self.port else ref_sched.SliceScheduler
        return cls(self.api, self.cfg, self.metrics, clock=self.clock)

    def request(self, ns: str, name: str):
        return self.kube.Request(ns, name)

    # -- the state the two sides must agree on ---------------------------------
    def _canon(self, text: str) -> str:
        text = text.replace(self.token, "SHAPE")
        text = text.replace(self.other_token, "OTHER")
        return text

    def _message(self, text: str) -> str:
        """An Event's message with the reference's device words read as
        the port's, and the port's GPU count as the reference's chips."""
        if self.port:
            return re.sub(r"to free (\d+) GPU\(s\)", lambda m: "to free "
                          "%d GPU(s)" % (int(m[1]) // self.ratio), text)
        return text.replace("Slice", "Gang").replace("slice", "gang") \
            .replace("chip(s)", "GPU(s)")

    def snapshot(self) -> dict:
        notebooks = {}
        for o in self.api.list("Notebook"):
            ann = o.metadata.annotations
            notebooks[f"{o.namespace}/{o.name}"] = {
                "placement": ann.get(C.ANNOTATION_PLACEMENT),
                "queued": ann.get(C.ANNOTATION_QUEUED),
                "sliceHealth": (o.body.get("status") or {})
                .get("sliceHealth"),
                "sessionState": (o.body.get("status") or {})
                .get("sessionState")}
        pools = {p.name: p.body.get("status")
                 for p in self.api.list(self.pool_kind())}
        quota = self.api.try_get(C.TENANTQUOTA_KIND, "", C.TENANTQUOTA_NAME)
        quota_status = None
        if quota is not None:
            quota_status = json.loads(json.dumps(
                quota.body.get("status") or {}))
            for rec in list((quota_status.get("preemptions") or {})
                            .values()) \
                    + list(quota_status.get("recentPreemptions") or []):
                if "chips" in rec:
                    rec["chips"] = rec["chips"] / self.ratio
        events = sorted(
            (e.namespace, e.body["type"], e.body["reason"],
             e.body.get("count", 1), self._message(e.body["message"]))
            for e in self.api.list("Event"))
        pods = sorted((p.namespace, p.name, p.spec.get("nodeName"),
                       (p.body.get("status") or {}).get("phase"))
                      for p in self.api.list("Pod"))
        self.metrics.scrape()
        samples = sorted(
            self._canon(line)
            for line in self.metrics.registry.render().splitlines()
            if any(f in line for f in FAMILIES))
        nodes = sorted(n.name for n in self.api.list("Node"))
        state = {"notebooks": notebooks, "pools": pools,
                 "quota": quota_status, "events": events, "pods": pods,
                 "deleted": list(self.deleted), "samples": samples,
                 "nodes": nodes}
        return json.loads(self._canon(json.dumps(state, sort_keys=True)))

    def preemption_chips(self, chips: float) -> float:
        return chips * self.ratio


# -- scenarios of tests/test_scheduler.py --------------------------------------


def _gang_gate(s: Side):
    """No StatefulSet until the intent covers the gang; Scheduling while
    the cold provision runs, then the whole gang binds on one pool."""
    s.create("nb")
    s.mgr.run_until_idle()
    assert s.api.list("StatefulSet", namespace="default") == []
    yield
    s.mgr.advance(60.0)
    s.mgr.run_until_idle()
    yield


def _bypass(s: Side):
    s.gangs("ext", 1)
    s.create("nb")
    s.mgr.run_until_idle()
    yield


def _prewarm(s: Side):
    s.mgr.settle(max_seconds=600.0)


def _warm_claim(s: Side):
    _prewarm(s)
    yield
    t0 = s.clock.now()
    s.create("nb")
    s.mgr.run_until_idle()   # a warm hit needs no FakeClock time
    assert s.clock.now() == t0
    yield


def _failover(s: Side):
    _prewarm(s)
    s.create("nb")
    s.mgr.settle(max_seconds=600.0)
    yield
    s.mgr.stop()
    s.manager()
    s.mgr.enqueue_all()
    s.mgr.settle(max_seconds=600.0)
    yield
    s.stop("nb")
    s.mgr.settle(max_seconds=600.0)
    yield


def _reclamation(s: Side):
    _prewarm(s)
    s.create("first")
    s.mgr.run_until_idle()
    yield
    s.stop("first")
    s.mgr.settle(max_seconds=600.0)
    yield
    s.create("second")
    s.mgr.run_until_idle()
    yield


def _release_waits(s: Side):
    """Direct construction: while the gang reads Stopping or Degraded the
    claim and the intent stay; Stopped releases."""
    s.create("nb", annotations={
        C.STOP_ANNOTATION: "true",
        C.ANNOTATION_PLACEMENT: json.dumps(
            {"v": 1, "slices": {"0": {"pool": "warm-x"}}})})
    s.new_pool({"slices": {"ws-0001": {
        "state": "Claimed", "pool": "warm-x",
        "claimedBy": "default/nb", "claimedSlice": 0}}})
    scheduler = s.scheduler()
    for health in ("Stopping", "Degraded", "Stopped"):
        live = s.api.get("Notebook", "default", "nb")
        live.status = {"sliceHealth": health}
        s.api.update_status(live)
        scheduler.reconcile(s.request("default", "nb"))
        yield


def _orphan_gc(s: Side):
    _prewarm(s)
    s.create("nb")
    s.mgr.run_until_idle()
    yield
    s.api.delete("Notebook", "default", "nb")
    s.mgr.settle(max_seconds=600.0)
    yield


def _autoscale(s: Side):
    _prewarm(s)
    for i in range(3):
        s.create(f"nb-{i}")
    s.mgr.run_until_idle()
    yield
    s.mgr.settle(max_seconds=1200.0)
    yield
    for i in range(3):
        s.stop(f"nb-{i}")
    s.mgr.settle(max_seconds=1200.0)
    yield


def _autoscale_max(s: Side):
    _prewarm(s)
    for i in range(6):
        s.create(f"nb-{i}")
    s.mgr.settle(max_seconds=1200.0)
    yield


def _unmanaged_shape(s: Side):
    s.create("nb")
    s.mgr.settle(max_seconds=600.0)
    yield
    s.stop("nb")
    s.mgr.settle(max_seconds=600.0)
    yield


def _gauge_zeroes(s: Side):
    _prewarm(s)
    yield
    s.api.delete(s.pool_kind(), "", s.pool_name())
    yield


def _deprovision_guard(s: Side):
    """A node of the doomed pool that still carries a bound pod stays."""
    s.add_nodes("shared", 2)
    resource = C.GPU_RESOURCE if s.port else RC.TPU_RESOURCE
    s.api.create(s.kube.KubeObject.from_dict({
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": "p", "namespace": "d"},
        "spec": {"nodeName": "shared-0", "containers": [{
            "name": "c", "resources": {"requests": {resource: "4"}}}]}}))
    s.cluster.deprovision_slice("shared")
    yield
    s.api.delete("Pod", "d", "p")
    s.cluster.deprovision_slice("shared")
    yield


# -- scenarios of tests/test_preemption.py -------------------------------------


def _over_quota(s: Side):
    s.gangs("ext", 2)
    s.set_quota(tenants={"ta": {"chipQuota": 8}})
    s.create("a1", "ta")
    s.mgr.run_until_idle()
    yield
    s.create("a2", "ta")
    s.mgr.run_until_idle()
    yield
    s.clock.advance(30.0)
    s.set_quota(tenants={"ta": {"chipQuota": 16}})
    s.mgr.run_until_idle()
    yield


def _stopped_while_queued(s: Side):
    s.gangs("ext", 1)
    s.set_quota(tenants={"ta": {"chipQuota": 8}})
    s.create("a1", "ta")
    s.create("a2", "ta")
    s.mgr.run_until_idle()
    yield
    queued = [o.name for o in s.api.list("Notebook", namespace="ta")
              if C.ANNOTATION_QUEUED in o.metadata.annotations]
    assert len(queued) == 1
    s.stop(queued[0], "ta")
    s.mgr.run_until_idle()
    yield


def _fair_share(s: Side):
    s.gangs("ext", 2)
    s.create("a1", "ta")
    s.mgr.run_until_idle()
    s.create("b1", "tb")
    s.mgr.run_until_idle()
    yield
    s.create("b2", "tb")
    s.mgr.run_until_idle()
    yield
    s.create("a2", "ta")
    s.mgr.run_until_idle()
    yield
    for ns, name in (("ta", "a1"), ("tb", "b2")):
        s.stop(name, ns)
    s.mgr.run_until_idle()
    for _ in range(3):
        s.mgr.advance(20.0)
    yield


def _inflight_quota(s: Side):
    s.set_quota(tenants={"ta": {"chipQuota": 8}})
    s.create("a1", "ta")
    s.mgr.run_until_idle()
    yield
    s.create("a2", "ta")
    s.mgr.run_until_idle()
    yield


def _stamp(since, priority="standard", reason="quota", **extra):
    return {C.ANNOTATION_QUEUED: json.dumps(
        {"since": since, "priority": priority, "reason": reason, **extra})}


def _race(s: Side):
    s.mgr.run_until_idle()
    yield
    for _ in range(4):
        s.mgr.advance(20.0)
        yield


def _older_first(s: Side):
    s.gangs("ext", 1)
    t0 = s.clock.now()
    s.clock.advance(100.0)
    s.create("old", "ta", annotations=_stamp(t0))
    s.create("young", "ta", annotations=_stamp(t0 + 90.0))
    yield from _race(s)


def _priority_beats_age_gap(s: Side):
    s.gangs("ext", 1)
    t0 = s.clock.now()
    s.clock.advance(100.0)
    s.create("lo", "ta", annotations=_stamp(t0))
    s.create("hi", "tb", priority="high",
             annotations=_stamp(t0 + 90.0, priority="high"))
    yield from _race(s)


def _aging_beats_priority(s: Side):
    s.gangs("ext", 1)
    t0 = s.clock.now()
    s.clock.advance(1000.0)
    s.create("lo", "ta", priority="low",
             annotations=_stamp(t0, priority="low"))
    s.create("hi", "tb", priority="high",
             annotations=_stamp(t0 + 990.0, priority="high"))
    yield from _race(s)


def _aging_boundary(gap: float):
    """The dequeue score rank + weight * age / QUEUE_AGING_S at its
    boundary: a standard gang queued `gap` seconds before a high one
    (rank 200 against 100, aging 60 s) outranks it once gap > 6000 s."""
    def scenario(s: Side):
        s.gangs("ext", 1)
        t0 = s.clock.now()
        s.clock.advance(gap + 100.0)
        # the high gang reconciles first: only its score against the
        # waiting standard one's decides whether it defers
        s.create("hi", "tb", priority="high",
                 annotations=_stamp(t0 + gap, priority="high"))
        s.create("std", "ta", annotations=_stamp(t0))
        yield from _race(s)
    return scenario


def _place_victim(s: Side, priority="low", ns="t-low"):
    s.gangs("ext", 1)
    s.create("victim", ns, priority=priority)
    s.mgr.run_until_idle()
    s.cluster.set_session_payload(ns, "victim", b"kernel-state-A")


def _preempt(s: Side):
    _place_victim(s)
    yield
    s.create("ben", "t-hi", priority="high")
    s.mgr.run_until_idle()
    yield


def _victim_restores(s: Side):
    _place_victim(s)
    s.create("ben", "t-hi", priority="high")
    s.mgr.run_until_idle()
    yield
    s.stop("ben", "t-hi")
    s.mgr.run_until_idle()
    yield
    for _ in range(4):
        s.mgr.advance(20.0)
    yield
    s.mgr.advance(3700.0)
    for _ in range(3):
        s.mgr.advance(20.0)
    yield


def _equal_priority_spared(s: Side):
    _place_victim(s, priority="standard", ns="t-std")
    s.create("ben", "t-hi", priority="standard")
    s.mgr.run_until_idle()
    yield


def _no_checkpoint_no_eviction(s: Side):
    _place_victim(s)
    s.store.set_final_snapshot_handler(None)
    s.create("ben", "t-hi", priority="high")
    s.mgr.run_until_idle()
    yield


def _fence(s: Side):
    s.gangs("ext", 1)
    s.create("ben", "t-hi", priority="high", other_shape=True)
    s.create("victim", "t-low", priority="low", annotations=_stamp(
        0.0, priority="low", reason="preempted", beneficiary="t-hi/ben"))
    s.mgr.run_until_idle()
    for _ in range(3):
        s.mgr.advance(20.0)
    yield
    s.stop("ben", "t-hi")
    for _ in range(3):
        s.mgr.advance(20.0)
    yield


def _resume_exactly_once(s: Side):
    _place_victim(s)
    (snap,) = s.cluster.snapshot_sessions("t-low", "victim")
    s.create("ben", "t-hi", priority="high", other_shape=True)
    s.api.create(new_quota_object() if s.port else ref_quota())
    live = s.api.get(C.TENANTQUOTA_KIND, "", C.TENANTQUOTA_NAME)
    live.status = {"preemptions": {"t-low/victim": {
        "victim": "t-low/victim", "victimPriority": "low",
        "beneficiary": "t-hi/ben", "beneficiaryPriority": "high",
        "chips": s.preemption_chips(8.0), "phase": C.PREEMPTION_PENDING,
        "createdAt": s.clock.now_iso(),
        "restore": {"0": {
            "restoreGeneration": snap.generation,
            "restoreUri": snap.uri, "digest": snap.digest,
            "savedAt": s.clock.now_iso()}}}}}
    s.api.update_status(live)
    yield
    s.mgr.run_until_idle()
    yield
    s.mgr.enqueue_all()
    s.mgr.run_until_idle()
    yield


def _mid_cull_victim(s: Side):
    s.gangs("ext", 1)
    s.create("victim", "t-low", priority="low")
    s.mgr.run_until_idle()
    s.cluster.set_session_payload("t-low", "victim", b"s")
    s.stop("victim", "t-low")
    s.create("ben", "t-hi", priority="high")
    s.mgr.run_until_idle()
    yield
    for _ in range(3):
        s.mgr.advance(20.0)
    yield


def _pending_blocks_culler(s: Side):
    s.gangs("ext", 1)
    s.create("victim", "t-low", priority="low")
    s.mgr.run_until_idle()
    s.api.create(new_quota_object() if s.port else ref_quota())
    live = s.api.get(C.TENANTQUOTA_KIND, "", C.TENANTQUOTA_NAME)
    live.status = {"preemptions": {"t-low/victim": {
        "victim": "t-low/victim", "phase": C.PREEMPTION_PENDING}}}
    s.api.update_status(live)
    cfg_cls = CoreConfig if s.port else RefConfig
    cull_cfg = cfg_cls(enable_culling=True, cull_idle_time_min=60,
                       idleness_check_period_min=1)
    culler = (CullingReconciler if s.port else RefCullingReconciler)(
        s.api, cull_cfg, (FakeJupyterState if s.port else RefJupyter)(),
        s.metrics, clock=s.clock)
    req = s.request("t-low", "victim")
    culler.reconcile(req)
    s.clock.advance(61 * 60)
    culler.reconcile(req)
    yield
    live = s.api.get(C.TENANTQUOTA_KIND, "", C.TENANTQUOTA_NAME)
    live.status = {"preemptions": {}}
    s.api.update_status(live)
    s.clock.advance(2 * 60)
    culler.reconcile(req)
    yield


_PROVISION_60 = {"WARMPOOL_PROVISION_S": "60"}
_PREWARM = {"WARMPOOL_SIZE": "2", "WARMPOOL_SHAPES": "SHAPE"}
_TENANCY = {"WARMPOOL_SIZE": "0", "WARMPOOL_PROVISION_S": "3600"}
# name -> (scenario, Side arguments)
SCENARIOS = {
    "gang-gate": (_gang_gate, {"env": _PROVISION_60}),
    "bypass": (_bypass, {}),
    "warm-claim": (_warm_claim, {"env": _PREWARM}),
    "failover": (_failover, {"env": _PREWARM}),
    "reclamation": (_reclamation, {"env": {**_PREWARM,
                                           "WARMPOOL_SIZE": "1"}}),
    "release-waits": (_release_waits, {}),
    "orphan-gc": (_orphan_gc, {"env": {**_PREWARM, "WARMPOOL_SIZE": "1"}}),
    "autoscale": (_autoscale, {"env": {
        **_PREWARM, "WARMPOOL_SIZE": "1", "WARMPOOL_DECAY_S": "60"}}),
    "autoscale-max": (_autoscale_max, {"env": {
        **_PREWARM, "WARMPOOL_SIZE": "1", "WARMPOOL_MAX_SIZE": "2"}}),
    "unmanaged-shape": (_unmanaged_shape, {}),
    "gauge-zeroes": (_gauge_zeroes, {"env": _PREWARM}),
    "deprovision-guard": (_deprovision_guard, {}),
    "over-quota": (_over_quota, {"env": _TENANCY, "session": True}),
    "stopped-while-queued": (_stopped_while_queued, {
        "env": _TENANCY, "session": True}),
    "fair-share": (_fair_share, {"env": _TENANCY, "session": True}),
    "inflight-quota": (_inflight_quota, {"env": _TENANCY, "session": True}),
    "older-first": (_older_first, {"env": _TENANCY, "session": True}),
    "priority-beats-age-gap": (_priority_beats_age_gap, {
        "env": _TENANCY, "session": True}),
    "aging-beats-priority": (_aging_beats_priority, {"env": {
        **_TENANCY, "QUEUE_AGING_S": "1", "ENABLE_PREEMPTION": "false"},
        "session": True}),
    "aging-overtakes": (_aging_boundary(6100.0), {"env": {
        **_TENANCY, "ENABLE_PREEMPTION": "false"}, "session": True}),
    "aging-short": (_aging_boundary(5900.0), {"env": {
        **_TENANCY, "ENABLE_PREEMPTION": "false"}, "session": True}),
    "preempt": (_preempt, {"env": _TENANCY, "session": True}),
    "victim-restores": (_victim_restores, {"env": _TENANCY,
                                           "session": True}),
    "equal-priority-spared": (_equal_priority_spared, {
        "env": _TENANCY, "session": True}),
    "no-checkpoint": (_no_checkpoint_no_eviction, {"env": _TENANCY,
                                                   "session": True}),
    "fence": (_fence, {"env": _TENANCY, "session": True}),
    "resume-exactly-once": (_resume_exactly_once, {"env": _TENANCY,
                                                   "session": True}),
    "mid-cull-victim": (_mid_cull_victim, {"env": _TENANCY,
                                           "session": True}),
    "pending-blocks-culler": (_pending_blocks_culler, {
        "env": _TENANCY, "session": True}),
}


def _placed(state, key):
    return state["notebooks"][key]["placement"] is not None


# what each scenario must show on the port's side, beyond agreeing with
# the reference's (the reference's own tests' assertions, in brief)
def _expect(name, got, s):
    nbs = got["notebooks"]
    pool = got["pools"].get("warmpool-SHAPE") or {}
    if name == "gang-gate":
        assert nbs["default/nb"]["sliceHealth"] == "Healthy"
        assert len([p for p in got["pods"] if p[2]]) == s.hosts
    elif name == "bypass":
        assert pool["bypass"] == 1 and nbs["default/nb"]["sliceHealth"] \
            == "Healthy"
    elif name == "warm-claim":
        assert pool["hits"] == 1
    elif name == "failover":
        assert not any(e.get("claimedBy") for e in pool["slices"].values())
        assert nbs["default/nb"]["placement"] is None
    elif name == "reclamation":
        assert nbs["default/second"]["sliceHealth"] == "Healthy"
        # the released gang was resold: both claims were warm hits
        assert pool["hits"] == 2 and "default/second" in [
            e.get("claimedBy") for e in pool["slices"].values()]
    elif name == "release-waits":
        assert nbs["default/nb"]["placement"] is None
    elif name == "orphan-gc":
        assert not any(e.get("claimedBy") for e in pool["slices"].values())
    elif name == "autoscale":
        assert pool["target"] == 1
    elif name == "autoscale-max":
        assert pool["target"] <= 2
    elif name == "unmanaged-shape":
        assert pool["slices"] == {} and got["nodes"] == []
    elif name == "gauge-zeroes":
        assert 'notebook_warmpool_size{shape="SHAPE",state="Ready"} 0' in \
            got["samples"]
    elif name == "deprovision-guard":
        assert got["nodes"] == []
    elif name == "over-quota":
        assert _placed(got, "ta/a2") and nbs["ta/a2"]["queued"] is None
        assert s.metrics.queue_wait_seconds.count_value("standard") == 2
    elif name == "stopped-while-queued":
        assert all(n["queued"] is None for n in nbs.values())
    elif name == "fair-share":
        assert _placed(got, "ta/a2")
    elif name == "inflight-quota":
        assert json.loads(nbs["ta/a2"]["queued"])["reason"] == "quota"
    elif name in ("older-first", "priority-beats-age-gap",
                  "aging-beats-priority", "aging-overtakes", "aging-short"):
        won = {"older-first": ("ta/old", "ta/young"),
               "priority-beats-age-gap": ("tb/hi", "ta/lo"),
               "aging-beats-priority": ("ta/lo", "tb/hi"),
               "aging-overtakes": ("ta/std", "tb/hi"),
               "aging-short": ("tb/hi", "ta/std")}[name]
        assert _placed(got, won[0]) and not _placed(got, won[1])
    elif name == "preempt":
        assert _placed(got, "t-hi/ben") and not _placed(got, "t-low/victim")
        info = json.loads(nbs["t-low/victim"]["queued"])
        assert (info["reason"], info["priority"], info["beneficiary"]) == \
            ("preempted", "low", "t-hi/ben")
        assert nbs["t-low/victim"]["sessionState"]["0"]["trigger"] == \
            "preempt"
        assert [r["phase"] for r in got["quota"]["recentPreemptions"]] == \
            [C.PREEMPTION_DONE]
        assert s.metrics.preemptions.value("evicted", "low") == 1
        assert not [p for p in got["pods"] if p[0] == "t-low"]
    elif name == "victim-restores":
        assert _placed(got, "t-low/victim")
        assert nbs["t-low/victim"]["sessionState"]["0"]["phase"] == \
            "restored"
        assert s.metrics.migrations.value("preempt", "restored") == 1
    elif name in ("equal-priority-spared", "no-checkpoint"):
        assert _placed(got, f"{'t-std' if 'equal' in name else 't-low'}"
                       "/victim") and not _placed(got, "t-hi/ben")
    elif name == "fence":
        assert _placed(got, "t-low/victim")
    elif name == "resume-exactly-once":
        assert s.metrics.preemptions.value("resumed", "low") == 1
        assert not _placed(got, "t-low/victim")
    elif name == "mid-cull-victim":
        assert _placed(got, "t-hi/ben")
        assert s.metrics.preemptions.value("evicted", "low") == 0
    elif name == "pending-blocks-culler":
        assert C.STOP_ANNOTATION in s.api.get(
            "Notebook", "t-low", "victim").metadata.annotations


@pytest.mark.parametrize("hosts", sorted(SHAPES))
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_matches_the_reference(scenario, hosts):
    fn, kw = SCENARIOS[scenario]
    ref, ours = Side(False, hosts, **kw), Side(True, hosts, **kw)
    for i, _ in enumerate(zip(fn(ref), fn(ours), strict=True)):
        want, got = ref.snapshot(), ours.snapshot()
        for key in want:
            assert got[key] == want[key], (scenario, hosts, i, key)
    _expect(scenario, got, ours)


# -- the placement policy on seeded random inventories --------------------------


@pytest.mark.parametrize("hosts,ref_shape,gpus", [
    (1, ("v5e", "2x4"), 8), (4, ("v5e", "4x4"), 32)])
def test_policy_matches_the_reference_on_random_inventories(hosts,
                                                           ref_shape, gpus):
    """One host (8 chips, 8 GPUs) and four (4 chips, 8 GPUs a host: the
    GPU inventory is the chip inventory times 2).  Every verdict is the
    same pool and node set, never a partial gang, one pool, and every node
    fits."""
    ref_shape, shape = ref_resolve(*ref_shape), resolve("h100-80gb", gpus)
    assert (ref_shape.num_hosts, shape.num_hosts) == (hosts, hosts)
    ratio = shape.gpus_per_host // ref_shape.chips_per_host
    rng = np.random.default_rng(15)
    placed = 0
    for _ in range(200):
        n = int(rng.integers(0, 16))
        pools = rng.integers(0, 3, size=n)
        # most nodes whole, the rest partly taken
        free = np.where(rng.random(n) < 0.7, ref_shape.chips_per_host,
                        rng.integers(0, ref_shape.chips_per_host + 1,
                                     size=n))
        ref_nodes = [ref_sched.NodeCapacity(
            f"n{i}", f"p{pools[i]}", float(free[i]),
            float(ref_shape.chips_per_host)) for i in range(n)]
        nodes = [sched.NodeCapacity(
            f"n{i}", f"p{pools[i]}", float(free[i] * ratio),
            float(shape.gpus_per_host)) for i in range(n)]
        want = ref_sched.CostFunctionPolicy().place(ref_shape, ref_nodes)
        got = sched.CostFunctionPolicy().place(shape, nodes)
        assert (got is None) == (want is None)
        if got is None:
            continue
        placed += 1
        assert (got.pool, got.nodes) == (want.pool, want.nodes)
        assert len(got.nodes) == hosts
        by_name = {nd.name: nd for nd in nodes}
        assert all(by_name[x].pool == got.pool
                   and by_name[x].free_chips >= shape.gpus_per_host
                   for x in got.nodes)
    assert placed > 20


# -- the pure helpers ------------------------------------------------------------


def test_shape_parsing_matches_the_reference():
    assert ref_sched.parse_warmpool_shapes(
        "v5e:4x4,nope,v9:1x1,v5e:4x4,:,x:,v4:2x2x2") == \
        [("v5e", "4x4"), ("v4", "2x2x2")]
    assert sched.parse_warmpool_shapes(
        "h100-80gb:8,nope,b200:8,h100-80gb:8,:,x:,h100-80gb:12,"
        "h100-80gb:many,h100-80gb:16") == [("h100-80gb", 8),
                                           ("h100-80gb", 16)]
    assert sched.pool_object_name("h100-80gb", 16) == \
        "warmpool-h100-80gb-16"
    for bad in ({}, {C.ANNOTATION_PLACEMENT: "not-json"},
                {C.ANNOTATION_PLACEMENT: "[1,2]"}):
        assert sched.placement_of(bad) == ref_sched.placement_of(bad) == {}
    nb = Notebook.new("nb", "default", gpu=GPUSpec("h100-80gb", 8),
                      annotations={C.ANNOTATION_PLACEMENT: json.dumps(
                          {"v": 1, "slices": {"0": {"pool": "p"}}})})
    assert sched.placement_covers(nb, 1)
    assert not sched.placement_covers(nb, 2)  # gang 1 missing


_QUOTAS = [
    None,
    {"defaults": {"chipQuota": 32, "weight": 2, "priority": "low"}},
    {"tenants": {"ta": {"chipQuota": "16", "weight": 0,
                        "priority": "high"}},
     "defaults": {"chipQuota": 32, "weight": 3}},
    {"tenants": {"ta": {"chipQuota": "lots", "weight": "heavy",
                        "priority": "urgent"}},
     "defaults": {"chipQuota": 8, "priority": "standard"}},
    {"tenants": {"ta": {"chipQuota": None}}},
]


@pytest.mark.parametrize("spec", _QUOTAS)
def test_tenant_policy_and_priority_match_the_reference(spec):
    def quota(k):
        if spec is None:
            return None
        return k.KubeObject.from_dict({
            "apiVersion": "kubeflow.org/v1", "kind": C.TENANTQUOTA_KIND,
            "metadata": {"name": C.TENANTQUOTA_NAME}, "spec": spec})

    for ns in ("ta", "tb"):
        assert sched.tenant_policy(quota(kube), ns) == \
            ref_sched.tenant_policy(quota(ref_kube), ns)
        for priority in (None, "low", "standard", "high", "urgent"):
            ref_nb = RefNotebook.new("nb", ns, tpu=TPUSpec("v5e", "2x4"))
            if priority is not None:
                ref_nb.obj.spec["priority"] = priority
            nb = Notebook.new("nb", ns, gpu=GPUSpec("h100-80gb", 8),
                              priority=priority)
            want = ref_sched.resolve_priority(ref_nb, quota(ref_kube))
            assert sched.resolve_priority(nb, quota(kube)) == want
            assert sched.rank_of(want) == ref_sched.rank_of(want)
    assert sched.rank_of(None) == ref_sched.rank_of(None) == 100
    assert (PRIORITY_RANK, PRIORITY_CLASSES, PRIORITY_DEFAULT) == (
        {"low": 0, "standard": 100, "high": 200},
        ("low", "standard", "high"), "standard")
    for raw in ({}, {C.ANNOTATION_QUEUED: "x"},
                {C.ANNOTATION_QUEUED: "[1]"},
                _stamp(4.5, priority="high", reason="ordered")):
        assert sched.queued_info(raw) == ref_sched.queued_info(raw)


def test_invalid_priority_is_refused_with_the_reference_message():
    mgr = kube.Manager(kube.ApiServer(), clock=FakeClock())
    setup_core_controllers(mgr, CoreConfig())
    with pytest.raises(kube.AdmissionDenied) as ours:
        mgr.api.create(kube.KubeObject.from_dict(Notebook.new(
            "nb", "default", gpu=GPUSpec("h100-80gb", 8),
            priority="urgent").obj))
    ref = RefNotebook.new("nb", "default", tpu=TPUSpec("v5e", "2x4"))
    ref.obj.spec["priority"] = "urgent"
    with pytest.raises(ref_kube.InvalidError) as theirs:
        ref.validate()
    assert str(theirs.value) in str(ours.value)
    for priority in PRIORITY_CLASSES:
        mgr.api.create(kube.KubeObject.from_dict(Notebook.new(
            f"nb-{priority}", "default", gpu=GPUSpec("h100-80gb", 8),
            priority=priority).obj))


def test_tier_config_parses_as_the_reference():
    env = {"ENABLE_SLICE_SCHEDULER": "true", "ENABLE_PREEMPTION": "true",
           "WARMPOOL_SIZE": "2", "WARMPOOL_SHAPES": "h100-80gb:8",
           "WARMPOOL_PROVISION_S": "0.5", "WARMPOOL_MAX_SIZE": "0",
           "WARMPOOL_TARGET_HIT_RATE": "0.75", "WARMPOOL_DECAY_S": "x",
           "QUEUE_REQUEUE_S": "2.5", "QUEUE_AGING_S": ""}
    ours, ref = CoreConfig.from_env(env), RefConfig.from_env(env)
    for field in ("enable_slice_scheduler", "enable_preemption",
                  "warmpool_size", "warmpool_shapes", "warmpool_provision_s",
                  "warmpool_max_size", "warmpool_target_hit_rate",
                  "warmpool_decay_s", "queue_requeue_s", "queue_aging_s"):
        assert getattr(ours, field) == getattr(ref, field), field
    assert CoreConfig().enable_preemption and RefConfig().enable_preemption


def test_metric_families_registered_as_the_reference():
    ours = NotebookMetrics(kube.ApiServer()).registry
    ref = RefMetrics(ref_kube.ApiServer()).registry

    def heads(registry):
        return sorted(line for line in registry.render().splitlines()
                      if line.startswith(("# HELP", "# TYPE"))
                      and line.split()[2] in FAMILIES)

    assert len(heads(ours)) == 2 * len(FAMILIES)
    assert heads(ours) == heads(ref)
