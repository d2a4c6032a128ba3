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

For the self-healing engine (core/selfheal.py) it also plays the data
plane of the session-state contract: `attach_session_store` makes it
answer the controller's final-snapshot requests for a reachable gang and
stamp the restored generation and digest onto a pod created with
CHECKPOINT_RESTORE_* env, and `restore_hold` parks such a pod Pending
until `release_restores`.  A gang is slice 0.  Its drills are the
reference's: a failed pod, a crash loop, a node deleted or cordoned, and
a poisoned StatefulSet whose pods always come up Failed.

It is also the gang scheduler's cloud provider (core/scheduler.py's
WarmPoolController): `provision_slice` turns up one warm gang's GPU
nodes under a nodepool label, and `deprovision_slice` tears an idle one
back down, under the reference's method names.

For the replicated tier (`spec.replication`) it plays the primary's and
the followers' runtimes: `stream_session_delta` appends one increment of
the primary's session state to the delta chain under its writer epoch,
and `sync_followers` replays the chain for every replica-labelled pod
and stamps the freshness the promote verb elects by
(ANNOTATION_REPLICA_GENERATION/SEQ/DIGEST).  A gang is slice 0 here
too, so every replica's pods read the one chain.

It plays OpenShift's ServiceAccount controller for the ODH plane
(odh/controller.py): every new ServiceAccount gets a `-dockercfg` pull
secret listed in its `imagePullSecrets`, which the reconciliation lock's
removal waits on.

For the data-plane rollup (core/telemetry.py) it plays the workers'
training loops: `stamp_worker_telemetry` runs a real
runtime/telemetry.py `TelemetryAgent` per worker pod and stamps its
summary into the pod's telemetry annotation, and
`clear_worker_telemetry` drops them.

Every public method that calls the API runs under `api.fault_exempt()`:
the data plane is on the cluster side of the client-apiserver boundary,
so its calls are neither client traffic in the apiserver's verb counts
nor faulted by an installed fault plan.
"""

from __future__ import annotations

import copy
import functools
import threading
from typing import Optional

from ..core import constants as C
from ..gpu.device_plugin import label_gpu_node
from ..utils import invariants
from .errors import AlreadyExistsError, NotFoundError
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


def _exempt(fn):
    """Run a data-plane method under `api.fault_exempt()`."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self.api.fault_exempt():
            return fn(self, *args, **kwargs)
    return wrapper


class FakeCluster:
    """Subscribes to the ApiServer and plays kubelet and scheduler."""

    def __init__(self, api: ApiServer, auto_ready: bool = True) -> None:
        self.api = api
        self.auto_ready = auto_ready
        self._pod_ip_counter = 0
        self._failed_pods: set[tuple[str, str]] = set()
        # checkpoint-restore latency model: with restore_hold on, a pod
        # recreated with CHECKPOINT_RESTORE_* env stays Pending
        # ("RestoringCheckpoint") until release_restores()
        self.restore_hold = False
        self._held_restores: set[tuple[str, str]] = set()
        # (namespace, sts_name) -> failure reason: pods (re)created for a
        # poisoned StatefulSet come up Failed (see poison_statefulset)
        self._poisoned: dict[tuple[str, str], str] = {}
        # session-state plumbing (attach_session_store): the data plane
        # plays the checkpoint sidecar, answering final-snapshot requests
        # and stamping what a restored pod restored
        self._session_store = None
        self._session_default_payload = b"torch-session"
        self._session_payload: dict[tuple[str, str], bytes] = {}
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
                  kinds=["StatefulSet", "Pod", "Node", "ServiceAccount"])
        # prime the accounting for pods that predate this cluster (a data
        # plane attached to an already-populated store)
        with api.fault_exempt():
            for pod in api.list("Pod"):
                self._account_pod(pod)
                self._index_pod(pod)

    # -- node inventory --------------------------------------------------------
    @_exempt
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

    @_exempt
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

    # -- cloud provider (warm-pool provisioner hook) ---------------------------
    @_exempt
    def provision_slice(self, shape, pool: str) -> list[str]:
        """Turn up one gang's node set for the warm pool: `shape.num_hosts`
        nodes (a gpu/topology.py `GpuShape`) labelled with the nodepool
        `pool`, each made a GPU node of `shape.gpus_per_host`
        `nvidia.com/gpu` by `label_gpu_node`.  Idempotent: a
        conflict-retried or crash-resumed provisioning pass skips nodes
        that already exist."""
        names = []
        for i in range(shape.num_hosts):
            name = f"{pool}-{i}"
            names.append(name)
            if self.api.try_get("Node", "", name) is not None:
                continue
            self.add_node(name, labels={C.GKE_NODEPOOL_LABEL: pool},
                          allocatable={"cpu": "208", "memory": "1872Gi"})
            label_gpu_node(self.api, name, gpus=shape.gpus_per_host,
                           accelerator=shape.accelerator.name)
        return names

    @_exempt
    def deprovision_slice(self, pool: str) -> None:
        """Tear a warm gang's node set back down (the autoscaler's
        shrink).  A node that still carries bound pods is left standing:
        a shared or user-made pool label must never pull a node out from
        under running pods (and their GPU accounting)."""
        with self._mutex:
            doomed = [
                n.name for n in self.api.list("Node")
                if n.metadata.labels.get(C.GKE_NODEPOOL_LABEL) == pool
                and not self._node_used.get(n.name)
            ]
            for name in doomed:
                try:
                    self.api.delete("Node", "", name)
                except NotFoundError:
                    pass

    # -- failure injection -----------------------------------------------------
    @_exempt
    def fail_pod(self, namespace: str, name: str,
                 reason: str = "GPUUnhealthy") -> None:
        """Mark a pod failed, as its kubelet does when a GPU falls off
        the bus (an XID error) or the container dies."""
        with self._mutex:
            self._fail_pod(namespace, name, reason)

    def _fail_pod(self, namespace: str, name: str, reason: str) -> None:
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
        self._failed_pods.add((namespace, name))
        self.api.update_status(pod)
        self._sync_sts_status_for_pod(pod)

    @_exempt
    def crashloop_pod(self, namespace: str, name: str) -> None:
        """The pod's container is stuck in the kubelet's CrashLoopBackOff:
        the pod stays Running but never turns Ready (the state
        core/selfheal.py classifies as crash-loop)."""
        with self._mutex:
            pod = self.api.get("Pod", namespace, name)
            pod.status = {
                "phase": "Running",
                "conditions": [
                    {"type": "PodScheduled", "status": "True"},
                    {"type": "Ready", "status": "False",
                     "reason": "ContainersNotReady"},
                ],
                "containerStatuses": [
                    {
                        "name": c.get("name", "main"),
                        "ready": False,
                        "restartCount": 7,
                        "state": {"waiting": {
                            "reason": "CrashLoopBackOff",
                            "message": "back-off 5m0s restarting failed "
                                       "container",
                        }},
                    }
                    for c in pod.spec.get("containers", [])
                ],
            }
            self.api.update_status(pod)
            self._sync_sts_status_for_pod(pod)

    @_exempt
    def delete_node(self, name: str) -> None:
        """Node-driven disruption (preemption, pool scale-down): the Node
        object vanishes while its pods linger with a dangling nodeName."""
        try:
            self.api.delete("Node", "", name)
        except NotFoundError:
            pass

    @_exempt
    def cordon_node(self, name: str) -> None:
        """Mark a node unschedulable (kubectl cordon), the voluntary
        migration trigger: its pods keep running, and the scheduler places
        no new ones there."""
        node = self.api.try_get("Node", "", name)
        if node is None:
            return
        node.spec["unschedulable"] = True
        self.api.update(node)

    @_exempt
    def uncordon_node(self, name: str) -> None:
        node = self.api.try_get("Node", "", name)
        if node is None:
            return
        node.spec.pop("unschedulable", None)
        self.api.update(node)
        # pods the cordon left Pending retry now: a no-op update notifies
        # no watcher, so the Node-MODIFIED path alone cannot be relied on
        with self._mutex:
            self._retry_pending_pods()

    @_exempt
    def poison_statefulset(self, namespace: str, name: str,
                           reason: str = "GPUUnhealthy") -> None:
        """Every pod (re)created for this StatefulSet comes up Failed: a
        permanently broken gang (a bad host, a dead NVLink).  Self-healing
        must exhaust its restart budget on it, not churn forever.
        Existing pods fail at once."""
        with self._mutex:
            self._poisoned[(namespace, name)] = reason
            for pod_name in sorted(self._sts_pods.get((namespace, name), ())):
                self._fail_pod(namespace, pod_name, reason)

    def heal_statefulset(self, namespace: str, name: str) -> None:
        """Undo poison_statefulset: the next gang restart comes up clean
        (the operator replaced the hardware)."""
        with self._mutex:
            self._poisoned.pop((namespace, name), None)

    @_exempt
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

    # -- data-plane telemetry --------------------------------------------------
    @_exempt
    def stamp_worker_telemetry(
        self,
        namespace: str,
        notebook: str,
        step_time_s: float = 1.0,
        *,
        flops_per_token: float = 0.0,
        config=None,
        batch: int = 1,
        seq_len: int = 1,
        num_chips: int = 8,
        accelerator: str = "NVIDIA H100 80GB HBM3",
        steps: int = 3,
        slow_worker: Optional[object] = None,
        slow_factor: float = 4.0,
        now: float = 0.0,
    ) -> dict[str, dict]:
        """Play the workers' training loops: run a real
        runtime/telemetry.py TelemetryAgent per worker pod of `notebook`
        (the code a worker runs, so the same roofline MFU) and stamp each
        rolling summary into the pod's telemetry annotation for the
        WorkerTelemetryAggregator to read watch-fed.  `accelerator` is a
        key of runtime/roofline.py's GPU_PEAKS (the agent raises KeyError
        for any other); `num_chips` is the GPUs a worker's step spans.

        `slow_worker` (a pod name or an ordinal into the sorted pod list)
        records `slow_factor` x the step time: the slow worker a straggler
        drill injects.  Returns pod name -> published summary."""
        from ..runtime.telemetry import (TELEMETRY_ANNOTATION,
                                         TelemetryAgent, annotation_payload)

        pods = sorted(
            (p for p in self.api.list("Pod", namespace=namespace)
             if p.metadata.labels.get(C.NOTEBOOK_NAME_LABEL) == notebook
             and p.metadata.deletion_timestamp is None),
            key=lambda p: p.name)
        out: dict[str, dict] = {}
        for i, pod in enumerate(pods):
            dt = step_time_s
            if slow_worker is not None and slow_worker in (i, pod.name):
                dt = step_time_s * slow_factor
            agent = TelemetryAgent(
                config=config, flops_per_token=flops_per_token,
                batch=batch, seq_len=seq_len, num_chips=num_chips,
                accelerator=accelerator, worker=pod.name,
                time_fn=lambda t=now: t, hbm_fn=lambda: {})
            for _ in range(max(1, steps)):
                agent.record_step(dt)
            summary = agent.summary()
            live = self.api.get("Pod", namespace, pod.name)
            live.metadata.annotations[TELEMETRY_ANNOTATION] = \
                annotation_payload(summary)
            self.api.update(live)
            out[pod.name] = summary
        return out

    @_exempt
    def clear_worker_telemetry(self, namespace: str, notebook: str) -> None:
        """Drop the telemetry annotations (workers that stopped reporting:
        the aggregator must zero their series)."""
        from ..runtime.telemetry import TELEMETRY_ANNOTATION

        for p in self.api.list("Pod", namespace=namespace):
            if p.metadata.labels.get(C.NOTEBOOK_NAME_LABEL) != notebook:
                continue
            if TELEMETRY_ANNOTATION not in p.metadata.annotations:
                continue
            live = p.deepcopy()
            del live.metadata.annotations[TELEMETRY_ANNOTATION]
            self.api.update(live)

    # -- session-state data plane ----------------------------------------------
    def attach_session_store(self, store,
                             default_payload: bytes = b"torch-session"
                             ) -> None:
        """Wire a core/sessionstate.py store: this cluster now answers
        `request_final_snapshot` (a reachable gang flushes its current
        session payload as a `final` snapshot; an unreachable one returns
        None) and stamps restore annotations onto pods that boot with
        CHECKPOINT_RESTORE_* env."""
        self._session_store = store
        self._session_default_payload = default_payload
        store.set_final_snapshot_handler(self._final_snapshot)

    @property
    def session_store(self):
        """The store this data plane answers final-snapshot requests for
        (None until attach_session_store)."""
        return self._session_store

    def set_session_payload(self, namespace: str, notebook: str,
                            payload: bytes) -> None:
        """The in-memory state of one notebook's gang (a serialized train
        state): what snapshots capture and restores must reproduce."""
        self._session_payload[(namespace, notebook)] = bytes(payload)

    def session_payload(self, namespace: str, notebook: str) -> bytes:
        return self._session_payload.get((namespace, notebook),
                                         self._session_default_payload)


    @_exempt
    def snapshot_sessions(self, namespace: str, notebook: str,
                          trigger: str = "periodic") -> list:
        """The in-pod sidecar's periodic snapshot tick: one snapshot of the
        current session payload per live gang."""
        assert self._session_store is not None, "attach_session_store first"
        return [self._session_store.put(
                    namespace, notebook, slice_id,
                    self.session_payload(namespace, notebook),
                    trigger=trigger)
                for slice_id in sorted(self._slice_ids(namespace, notebook))]

    @_exempt
    def stream_session_delta(self, namespace: str, notebook: str,
                             delta: bytes,
                             writer_epoch: Optional[int] = None) -> list:
        """The primary's runtime appends one increment of its session
        state: the gang's delta chain grows by `delta` (a base snapshot of
        the current payload is written first when the chain has no
        anchor), and the in-memory payload advances.  `writer_epoch` is
        the primary's fencing token: once a promotion raised the fence, a
        demoted primary gets StaleWriterError from the store and its
        payload does not advance."""
        assert self._session_store is not None, "attach_session_store first"
        store = self._session_store
        payload = self.session_payload(namespace, notebook)
        infos = []
        for slice_id in sorted(self._slice_ids(namespace, notebook)):
            if store.latest(namespace, notebook, slice_id) is None:
                store.put(namespace, notebook, slice_id, payload,
                          writer_epoch=writer_epoch)
            infos.append(store.append_delta(
                namespace, notebook, slice_id, bytes(delta),
                writer_epoch=writer_epoch))
        self._session_payload[(namespace, notebook)] = \
            payload + bytes(delta)
        return infos

    @_exempt
    def sync_followers(self, namespace: str, notebook: str,
                       lag: int = 0) -> int:
        """The follower runtimes' catch-up: every replica-labelled worker
        pod of `notebook` replays its gang's delta chain (through the head
        less `lag` steps) and is stamped with the replica-freshness
        annotations that the election in core/selfheal.py reads as
        positive evidence.  Returns the number of pods stamped."""
        assert self._session_store is not None, "attach_session_store first"
        from ..core.sessionstate import payload_digest

        store = self._session_store
        stamped = 0
        for pod in self.api.list("Pod", namespace=namespace):
            labels = pod.metadata.labels
            if labels.get(C.NOTEBOOK_NAME_LABEL) != notebook or \
                    C.REPLICA_LABEL not in labels:
                continue
            head = store.chain_head(namespace, notebook, 0)
            if head is None:
                continue
            gen, head_seq, head_digest = head
            seq = max(head_seq - max(lag, 0), 0)
            if seq == head_seq:
                digest = head_digest
            else:
                state = store.materialize(namespace, notebook, 0,
                                          upto_seq=seq)
                digest = payload_digest(state or b"")
            live = self.api.get("Pod", namespace, pod.name).deepcopy()
            ann = live.metadata.annotations
            if ann.get(C.ANNOTATION_REPLICA_GENERATION) == str(gen) \
                    and ann.get(C.ANNOTATION_REPLICA_SEQ) == str(seq) \
                    and ann.get(C.ANNOTATION_REPLICA_DIGEST) == digest:
                continue
            ann[C.ANNOTATION_REPLICA_GENERATION] = str(gen)
            ann[C.ANNOTATION_REPLICA_SEQ] = str(seq)
            ann[C.ANNOTATION_REPLICA_DIGEST] = digest
            self.api.update(live)
            stamped += 1
        return stamped

    def _gang_pods(self, namespace: str, notebook: str) -> list[KubeObject]:
        return [p for p in self.api.list("Pod", namespace=namespace)
                if p.metadata.labels.get(C.NOTEBOOK_NAME_LABEL) == notebook]

    def _slice_ids(self, namespace: str, notebook: str) -> set[int]:
        return {0} if self._gang_pods(namespace, notebook) else set()

    @_exempt
    def _final_snapshot(self, namespace: str, notebook: str, slice_id: int):
        """The control plane asked the gang to flush now.  Reachable =
        every worker pod exists, is Running with live containers, and
        still has its Ready node; then the current session payload lands
        as a `final` snapshot.  Anything less returns None and the engine
        falls back to stored checkpoints."""
        with self._mutex:
            pods = self._gang_pods(namespace, notebook) \
                if slice_id == 0 else []
            if not pods:
                return None
            for pod in pods:
                if (namespace, pod.name) in self._failed_pods:
                    return None
                status = pod.body.get("status", {}) or {}
                if status.get("phase") != "Running":
                    return None
                for cs in status.get("containerStatuses", []) or []:
                    waiting = (cs.get("state") or {}).get("waiting") or {}
                    if waiting.get("reason") == "CrashLoopBackOff":
                        return None
                node_name = pod.spec.get("nodeName", "")
                node = self.api.try_get("Node", "", node_name) \
                    if node_name else None
                if node_name and (node is None or not any(
                        c.get("type") == "Ready"
                        and c.get("status") == "True"
                        for c in node.body.get("status", {}).get(
                            "conditions", []))):
                    return None
            return self._session_store.put(
                namespace, notebook, slice_id,
                self.session_payload(namespace, notebook), trigger="final")

    def _apply_restore_stamp(self, pod: KubeObject) -> None:
        """A pod whose template carries CHECKPOINT_RESTORE_* env boots by
        restoring that snapshot: the fake kubelet records what the runtime
        restores as annotations on the pod."""
        if self._session_store is None:
            return
        env = {}
        for c in pod.spec.get("containers", []):
            for e in c.get("env", []) or []:
                if "value" in e:
                    env.setdefault(e.get("name"), e["value"])
        gen_raw = env.get(C.ENV_CHECKPOINT_RESTORE_GENERATION)
        if gen_raw is None:
            return
        try:
            generation = int(gen_raw)
        except ValueError:
            return
        notebook = pod.metadata.labels.get(C.NOTEBOOK_NAME_LABEL, "")
        info = self._session_store.info(pod.namespace, notebook, 0,
                                        generation)
        if info is None:
            return
        pod.metadata.annotations[C.ANNOTATION_RESTORED_GENERATION] = \
            str(generation)
        pod.metadata.annotations[C.ANNOTATION_RESTORED_DIGEST] = info.digest

    def _hold_restore(self, pod: KubeObject) -> None:
        """Park a restore-stamped pod in Pending while the modelled
        checkpoint reload runs; release_restores() flips it Ready."""
        self._held_restores.add((pod.namespace, pod.name))
        pod.status = {
            "phase": "Pending",
            "conditions": [
                {"type": "PodScheduled", "status": "True"},
                {
                    "type": "Ready",
                    "status": "False",
                    "reason": "RestoringCheckpoint",
                    "message": "reloading session snapshot into the runtime",
                },
            ],
        }
        self.api.update_status(pod)

    @_exempt
    def release_restores(self) -> int:
        """Complete every checkpoint reload in flight: flip the held pods
        to Running/Ready.  Call after advancing the fake clock by the
        restore time the drill wants a migration to pay."""
        with self._mutex:
            held = sorted(self._held_restores)
            self._held_restores.clear()
        for ns, name in held:
            self.mark_running(ns, name)
        return len(held)

    def _start_bound(self, pod: KubeObject) -> None:
        """What the kubelet does with a pod just bound to a node: fail it
        (a poisoned StatefulSet), hold it while it restores, or (with
        auto_ready) run it."""
        ref = pod.metadata.controller_owner()
        poison = self._poisoned.get((pod.namespace, ref.name)) \
            if ref is not None and ref.kind == "StatefulSet" else None
        if poison is not None:
            self._fail_pod(pod.namespace, pod.name, poison)
        elif self.auto_ready:
            if self.restore_hold and C.ANNOTATION_RESTORED_GENERATION \
                    in pod.metadata.annotations:
                self._hold_restore(pod)
            else:
                self._mark_running(pod)

    # -- event loop ------------------------------------------------------------
    @_exempt
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
                self._failed_pods.discard((ev.obj.namespace, ev.obj.name))
                self._held_restores.discard((ev.obj.namespace, ev.obj.name))
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
        elif kind == "ServiceAccount" and ev.type == EventType.ADDED:
            self._mint_pull_secret(ev.obj)

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
        self._apply_restore_stamp(pod)
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
        self._start_bound(pod)

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
            self._start_bound(pod)
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

    # -- openshift service-account controller ---------------------------------
    def _mint_pull_secret(self, sa: KubeObject) -> None:
        """A new ServiceAccount's registry pull secret, listed in its
        imagePullSecrets (the reference's `_mint_pull_secret`)."""
        secret = KubeObject(
            api_version="v1",
            kind="Secret",
            metadata=ObjectMeta(
                name=f"{sa.name}-dockercfg",
                namespace=sa.namespace,
                annotations={"kubernetes.io/service-account.name": sa.name},
            ),
            body={"type": "kubernetes.io/dockercfg",
                  "data": {".dockercfg": "e30="}},
        )
        try:
            self.api.create(secret)
        except AlreadyExistsError:
            pass
        live = self.api.get("ServiceAccount", sa.namespace, sa.name)
        secrets = live.body.setdefault("imagePullSecrets", [])
        if {"name": secret.name} not in secrets:
            secrets.append({"name": secret.name})
            self.api.update(live)


def _ordinal_of(pod_name: str, sts_name: str) -> Optional[int]:
    prefix = sts_name + "-"
    if not pod_name.startswith(prefix):
        return None
    suffix = pod_name[len(prefix):]
    return int(suffix) if suffix.isdigit() else None


__all__ = ["FakeCluster", "parse_quantity"]
