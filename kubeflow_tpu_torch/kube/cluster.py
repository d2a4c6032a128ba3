"""Fake cluster data plane: kubelet + scheduler + node inventory, for GPUs.

The port's copy of kubeflow_tpu/kube/cluster.py.  FakeCluster realizes
StatefulSets into Pods (honoring ordinals and the pod-index label that
torchrun's PET_NODE_RANK reads), schedules them onto fake nodes by
nodeSelector and allocatable resources, and marks them Running/Ready
(or, with auto_ready off, leaves that to `mark_running`).
`add_gpu_nodes` is the twin of the reference's
`add_tpu_slice_nodes`: a node pool, each node made a GPU node by the fake
GPU device plugin's `label_gpu_node` (gpu/device_plugin.py), which owns
what a GPU node looks like.  The scheduler counts every
requested resource, `nvidia.com/gpu` as the reference counts
`google.com/tpu`: a gang that does not fit stays Pending, and a stopped
gang's GPUs return to the pool.

Left out until the self-healing engine is ported (`ROADMAP.md` queue 1
item 12): the session-store, replication and restore-stamp hooks, and
the crash-loop, node-loss, cordon, poisoned-StatefulSet and restore-hold
drills; the warm-pool provisioner hooks wait for the slice scheduler
(item 13), the telemetry stamping for the data-plane rollup (item 16),
the ServiceAccount pull-secret controller for the ODH controller (item
15), and the fault-plan exemption for fault plans (item 17).
"""

from __future__ import annotations

import copy
import threading
from typing import Optional

from ..core import constants as C
from ..gpu.device_plugin import label_gpu_node
from ..utils import invariants
from .errors import NotFoundError
from .meta import KubeObject, ObjectMeta, set_controller_reference
from .store import ApiServer, EventType, WatchEvent



def parse_quantity(q) -> float:
    """Minimal k8s resource.Quantity parser (enough for cpu/memory/gpu)."""
    if isinstance(q, (int, float)):
        return float(q)
    s = str(q)
    suffixes = {
        "m": 1e-3, "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12,
        "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40,
    }
    for suf in sorted(suffixes, key=len, reverse=True):
        if s.endswith(suf):
            return float(s[: -len(suf)]) * suffixes[suf]
    return float(s)


class FakeCluster:
    """Subscribes to the ApiServer and plays kubelet and scheduler."""

    def __init__(self, api: ApiServer, auto_ready: bool = True) -> None:
        self.api = api
        self.auto_ready = auto_ready
        self._pod_ip_counter = 0
        # incremental scheduler accounting: per-node used resources kept in
        # lockstep with pod bind/delete events, so one placement decision
        # costs O(nodes) instead of O(pods x nodes).  _bound remembers each
        # accounted pod's (node, requests) so re-deliveries stay idempotent.
        self._node_used: dict[str, dict[str, float]] = {}
        self._bound: dict[tuple[str, str], tuple[str, dict[str, float]]] = {}
        # incremental kubelet indexes, maintained from the same event
        # stream: pods per owning StatefulSet (so STS reconcile/status is
        # O(its pods), never a namespace scan) and the unschedulable
        # Pending set (so a capacity change retries exactly the starved
        # pods instead of sweeping the fleet)
        self._sts_pods: dict[tuple[str, str], set[str]] = {}
        self._pending: set[tuple[str, str]] = set()
        # one lock serializes the whole data-plane handler: watch fan-out
        # delivers from whichever worker thread committed the write, and
        # the kubelet's maps must see those deliveries one at a time
        # (reentrant: handlers issue writes whose events nest on the same
        # thread)
        self._mutex = invariants.tracked(
            threading.RLock(), "FakeCluster._mutex")
        # the data plane only reacts to these kinds — register filtered so
        # Notebook/Service/Event churn never reaches it
        api.watch(self._on_event,
                  kinds=["StatefulSet", "Pod", "Node"])
        # prime the accounting for pods that predate this cluster (a data
        # plane attached to an already-populated store)
        for pod in api.list("Pod"):
            self._account_pod(pod)
            self._index_pod(pod)

    # -- node inventory --------------------------------------------------------
    def add_node(
        self,
        name: str,
        labels: Optional[dict[str, str]] = None,
        allocatable: Optional[dict[str, str]] = None,
    ) -> KubeObject:
        node = KubeObject(
            api_version="v1",
            kind="Node",
            metadata=ObjectMeta(name=name, labels=dict(labels or {})),
            body={
                "status": {
                    "allocatable": dict(allocatable or {"cpu": "8", "memory": "32Gi"}),
                    "conditions": [{"type": "Ready", "status": "True"}],
                }
            },
        )
        return self.api.create(node)

    def add_gpu_nodes(
        self,
        accelerator: str,
        num_hosts: int,
        gpus_per_host: int,
        name_prefix: str = "gpu-node",
        pool: Optional[str] = None,
    ) -> list[KubeObject]:
        """Fake GKE GPU node pool: one node per gang host, each made a GPU
        node by gpu/device_plugin.py's `label_gpu_node` (`accelerator` is
        a key of gpu/topology.py's table, e.g. "h100-80gb"; each node
        exposes `gpus_per_host` `nvidia.com/gpu`), so nodeSelector
        scheduling is exercised.  Every node
        carries a `cloud.google.com/gke-nodepool` label (one call = one
        pool unless overridden)."""
        pool = pool or f"{name_prefix}-{accelerator}"
        nodes = []
        for i in range(num_hosts):
            name = f"{name_prefix}-{accelerator}-{i}"
            self.add_node(name, labels={C.GKE_NODEPOOL_LABEL: pool},
                          allocatable={"cpu": "208", "memory": "1872Gi"})
            nodes.append(label_gpu_node(self.api, name, gpus=gpus_per_host,
                                        accelerator=accelerator))
        return nodes

    # -- failure injection -----------------------------------------------------
    def fail_pod(self, namespace: str, name: str,
                 reason: str = "GPUUnhealthy") -> None:
        """Mark a pod failed, as its kubelet does when a GPU or the
        container dies."""
        with self._mutex:
            pod = self.api.get("Pod", namespace, name)
            pod.status = {
                "phase": "Failed",
                "reason": reason,
                "conditions": [{"type": "Ready", "status": "False",
                                "reason": reason}],
                "containerStatuses": [
                    {
                        "name": c.get("name", "main"),
                        "ready": False,
                        "state": {"terminated": {"exitCode": 137,
                                                 "reason": reason}},
                    }
                    for c in pod.spec.get("containers", [])
                ],
            }
            self.api.update_status(pod)
            self._sync_sts_status_for_pod(pod)

    def mark_running(self, namespace: str, name: str) -> None:
        """Drive a created-but-not-yet-Ready pod to Running/Ready by hand —
        the auto_ready=False escape hatch failover drills use to freeze the
        cluster mid-recreate and resume it under a different manager."""
        with self._mutex:
            pod = self.api.try_get("Pod", namespace, name)
            if pod is None or not pod.spec.get("nodeName"):
                return
            self._mark_running(pod)
            self._sync_sts_status_for_pod(pod)

    # -- event loop ------------------------------------------------------------
    def _on_event(self, ev: WatchEvent) -> None:
        with self._mutex:
            self._handle_event(ev)

    def _index_pod(self, pod: KubeObject) -> None:
        """Fold one live pod into the kubelet indexes (idempotent)."""
        key = (pod.namespace, pod.name)
        owner = pod.metadata.controller_owner()
        if owner is not None and owner.kind == "StatefulSet":
            self._sts_pods.setdefault(
                (pod.namespace, owner.name), set()).add(pod.name)
        phase = pod.body.get("status", {}).get("phase")
        if phase == "Pending" and not pod.spec.get("nodeName"):
            self._pending.add(key)
        else:
            self._pending.discard(key)

    def _unindex_pod(self, pod: KubeObject) -> None:
        key = (pod.namespace, pod.name)
        self._pending.discard(key)
        owner = pod.metadata.controller_owner()
        if owner is not None and owner.kind == "StatefulSet":
            skey = (pod.namespace, owner.name)
            pods = self._sts_pods.get(skey)
            if pods is not None:
                pods.discard(pod.name)
                if not pods:
                    del self._sts_pods[skey]

    def _handle_event(self, ev: WatchEvent) -> None:
        kind = ev.obj.kind
        if kind == "StatefulSet":
            if ev.type in (EventType.ADDED, EventType.MODIFIED):
                self._reconcile_sts(ev.obj.namespace, ev.obj.name)
            elif ev.type == EventType.DELETED:
                pass  # pods cascade via owner-ref GC
        elif kind == "Pod":
            if ev.type == EventType.DELETED:
                self._unaccount_pod(ev.obj)
                self._unindex_pod(ev.obj)
                owner = ev.obj.metadata.controller_owner()
                if owner is not None and owner.kind == "StatefulSet":
                    self._reconcile_sts(ev.obj.namespace, owner.name)
                self._retry_pending_pods()  # freed capacity may unblock others
            else:
                # bind accounting: the synchronous watch stream means the
                # used-resources map is current before the write that bound
                # the pod even returns to its caller
                self._account_pod(ev.obj)
                self._index_pod(ev.obj)
        elif kind == "Node" and ev.type in (EventType.ADDED, EventType.MODIFIED):
            self._retry_pending_pods()

    # -- kubelet/scheduler -----------------------------------------------------
    def _reconcile_sts(self, namespace: str, name: str) -> None:
        sts = self.api.try_get("StatefulSet", namespace, name)
        if sts is None:
            return
        want = int(sts.spec.get("replicas", 1))
        for ordinal in range(want):
            pod_name = f"{name}-{ordinal}"
            if self.api.try_get("Pod", namespace, pod_name) is None:
                self._create_pod(sts, ordinal)
        # scale-down: delete pods beyond want (highest ordinal first) —
        # off the incremental owner index, O(this STS's pods)
        owned = self._sts_pods.get((namespace, name), set())
        extra = [
            pod_name for pod_name in owned
            if _ordinal_of(pod_name, name) is not None
            and _ordinal_of(pod_name, name) >= want
        ]
        for pod_name in sorted(
                extra, key=lambda n: -(_ordinal_of(n, name) or 0)):
            try:
                self.api.delete("Pod", namespace, pod_name)
            except NotFoundError:
                pass
        self._sync_sts_status(namespace, name)

    def _create_pod(self, sts: KubeObject, ordinal: int) -> None:
        namespace, name = sts.namespace, f"{sts.name}-{ordinal}"
        template = sts.spec.get("template", {})
        tmeta = template.get("metadata", {})
        pod = KubeObject(
            api_version="v1",
            kind="Pod",
            metadata=ObjectMeta(
                name=name,
                namespace=namespace,
                labels=dict(tmeta.get("labels") or {}),
                annotations=dict(tmeta.get("annotations") or {}),
            ),
            body={"spec": copy.deepcopy(template.get("spec", {}))},
        )
        # indexed-statefulset identity: hostname + subdomain give each worker
        # a stable DNS name through the headless service — the property
        # GPU_WORKER_HOSTNAMES and PET_MASTER_ADDR depend on — and the
        # pod-index label PET_NODE_RANK reads through the downward API
        pod.spec["hostname"] = name
        if sts.spec.get("serviceName"):
            pod.spec["subdomain"] = sts.spec["serviceName"]
        pod.metadata.labels[C.POD_INDEX_LABEL] = str(ordinal)
        pod.metadata.labels.setdefault(
            "statefulset.kubernetes.io/pod-name", name
        )
        sts_live = self.api.get("StatefulSet", namespace, sts.name)
        set_controller_reference(sts_live, pod)

        node = self._schedule(pod)
        pod = self.api.create(pod)
        if node is None:
            pod.status = {
                "phase": "Pending",
                "conditions": [
                    {
                        "type": "PodScheduled",
                        "status": "False",
                        "reason": "Unschedulable",
                        "message": "no node satisfies nodeSelector/resources",
                    }
                ],
            }
            self.api.update_status(pod)
            return
        pod.spec["nodeName"] = node.name
        pod = self.api.update(pod)
        if self.auto_ready:
            self._mark_running(pod)

    def _mark_running(self, pod: KubeObject) -> None:
        self._pod_ip_counter += 1
        pod.status = {
            "phase": "Running",
            "podIP": f"10.0.{self._pod_ip_counter // 256}.{self._pod_ip_counter % 256}",
            "conditions": [
                {"type": "PodScheduled", "status": "True"},
                {"type": "Initialized", "status": "True"},
                {"type": "ContainersReady", "status": "True"},
                {"type": "Ready", "status": "True"},
            ],
            "containerStatuses": [
                {
                    "name": c.get("name", "main"),
                    "ready": True,
                    "restartCount": 0,
                    "image": c.get("image", ""),
                    "state": {"running": {"startedAt": pod.metadata.creation_timestamp}},
                }
                for c in pod.spec.get("containers", [])
            ],
        }
        self.api.update_status(pod)

    @staticmethod
    def _pod_requests(pod_spec: dict) -> dict[str, float]:
        requests: dict[str, float] = {}
        for c in pod_spec.get("containers", []):
            for res, q in (c.get("resources", {}).get("requests") or {}).items():
                requests[res] = requests.get(res, 0.0) + parse_quantity(q)
        return requests

    def _account_pod(self, pod: KubeObject) -> None:
        """Fold a bound pod into the per-node used map (idempotent: a
        re-delivered event with unchanged node+requests is a no-op)."""
        key = (pod.namespace, pod.name)
        node = pod.spec.get("nodeName") or ""
        requests = self._pod_requests(pod.spec) if node else {}
        prev = self._bound.get(key)
        if prev is not None and prev == (node, requests):
            return
        if prev is not None:
            self._subtract_used(*prev)
            del self._bound[key]
        if not node:
            return
        self._bound[key] = (node, requests)
        used = self._node_used.setdefault(node, {})
        for res, v in requests.items():
            used[res] = used.get(res, 0.0) + v

    def _unaccount_pod(self, pod: KubeObject) -> None:
        prev = self._bound.pop((pod.namespace, pod.name), None)
        if prev is not None:
            self._subtract_used(*prev)

    def _subtract_used(self, node: str, requests: dict[str, float]) -> None:
        used = self._node_used.get(node)
        if used is None:
            return
        for res, v in requests.items():
            left = used.get(res, 0.0) - v
            if left > 1e-9:
                used[res] = left
            else:
                used.pop(res, None)
        if not used:
            del self._node_used[node]

    def node_used(self, name: str) -> dict[str, float]:
        """Incrementally-maintained used resources of one node (the sum of
        requests of pods bound there) — the equivalence tests compare this
        against the brute-force recount."""
        with self._mutex:
            return dict(self._node_used.get(name, {}))

    def _schedule(self, pod: KubeObject) -> Optional[KubeObject]:
        selector = pod.spec.get("nodeSelector") or {}
        requests = self._pod_requests(pod.spec)
        for node in self.api.list("Node"):
            if node.spec.get("unschedulable"):
                continue  # cordoned: kube-scheduler never places here
            node_labels = node.metadata.labels
            if not all(node_labels.get(k) == v for k, v in selector.items()):
                continue
            alloc = node.body.get("status", {}).get("allocatable", {})
            # used resources come from the incrementally-maintained map —
            # O(1) per node instead of a full pod-list resum per candidate
            used = self._node_used.get(node.name, {})
            if all(
                parse_quantity(alloc.get(res, 0)) - used.get(res, 0.0) >= need
                for res, need in requests.items()
            ):
                return node
        return None

    def _retry_pending_pods(self) -> None:
        """Re-run scheduling for pods that previously found no fitting node
        (real kube-scheduler retries on Node add / capacity change).  Walks
        the incrementally-maintained Pending set, never the whole fleet;
        each candidate is re-fetched so the mutation happens on a private
        copy (listed objects are read-only shared snapshots)."""
        for ns, pod_name in sorted(self._pending):
            pod = self.api.try_get("Pod", ns, pod_name)
            if pod is None:
                self._pending.discard((ns, pod_name))
                continue
            status = pod.body.get("status", {})
            if status.get("phase") != "Pending" or pod.spec.get("nodeName"):
                continue
            node = self._schedule(pod)
            if node is None:
                continue
            pod.spec["nodeName"] = node.name
            pod = self.api.update(pod)
            if self.auto_ready:
                self._mark_running(pod)
            self._sync_sts_status_for_pod(pod)

    def _sync_sts_status_for_pod(self, pod: KubeObject) -> None:
        ref = pod.metadata.controller_owner()
        if ref is not None and ref.kind == "StatefulSet":
            self._sync_sts_status(pod.namespace, ref.name)

    def _sync_sts_status(self, namespace: str, name: str) -> None:
        sts = self.api.try_get("StatefulSet", namespace, name)
        if sts is None:
            return
        pods = []
        for pod_name in sorted(self._sts_pods.get((namespace, name), ())):
            pod = self.api.try_get("Pod", namespace, pod_name)
            if pod is not None:
                pods.append(pod)
        ready = sum(
            1
            for p in pods
            if any(
                c.get("type") == "Ready" and c.get("status") == "True"
                for c in p.body.get("status", {}).get("conditions", [])
            )
        )
        sts.status = {
            "replicas": len(pods),
            "readyReplicas": ready,
            "currentReplicas": len(pods),
            "observedGeneration": sts.metadata.generation,
        }
        self.api.update_status(sts)

def _ordinal_of(pod_name: str, sts_name: str) -> Optional[int]:
    prefix = sts_name + "-"
    if not pod_name.startswith(prefix):
        return None
    suffix = pod_name[len(prefix):]
    return int(suffix) if suffix.isdigit() else None


__all__ = ["FakeCluster", "parse_quantity"]
