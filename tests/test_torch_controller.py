"""The port's notebook controller against the reference's.

The same events go through the reference's stack (kubeflow_tpu's
ApiServer, FakeCluster, Manager and notebook controller) and the port's
(kubeflow_tpu_torch's), each on its own FakeClock from the same epoch,
under `CoreConfig(enable_self_healing=False)`:

- CPU notebooks: the StatefulSets, Services, Notebooks (status included)
  and Events are equal once the fields each store mints on its own
  (STRIPPED: uids, resourceVersions, wall-clock timestamps,
  generateName suffixes) are removed;
- a `spec.gpu` gang and a `spec.tpu` slice of the same host count go
  through the same life and give the same pod counts, `workerStates` and
  `sliceHealth` sequence: the device is all that differs;
- the fake cluster places a gang only where its `nvidia.com/gpu` fit,
  and frees them when it stops;
- `python -m kubeflow_tpu_torch.main --demo` runs in-process and serves
  /healthz and /metrics; the switches of every tier parse into their
  fields as the reference's (the sharded fleet's and the interleave
  checker's among them), a replicated CR is admitted, USE_ISTIO renders
  the reference's VirtualService, and the env names the port reads parse
  as the reference's.  The self-healing engine is held to the reference's in
  tests/test_torch_selfheal.py, the replicated tier in
  tests/test_torch_replication.py.

Only the reference's control plane is imported."""

from __future__ import annotations

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import pytest

from kubeflow_tpu import kube as ref_kube
from kubeflow_tpu.api.types import Notebook as RefNotebook
from kubeflow_tpu.api.types import TPUSpec
from kubeflow_tpu.core.metrics import NotebookMetrics as RefMetrics
from kubeflow_tpu.core.notebook_controller import (
    setup_core_controllers as ref_setup,
)
from kubeflow_tpu.utils.clock import FakeClock as RefFakeClock
from kubeflow_tpu.utils.config import CoreConfig as RefConfig
from kubeflow_tpu_torch import kube
from kubeflow_tpu_torch import main as port_main
from kubeflow_tpu_torch.api.types import GPUSpec, Notebook, ReplicationSpec
from kubeflow_tpu_torch.core import constants as C
from kubeflow_tpu_torch.core.metrics import NotebookMetrics
from kubeflow_tpu_torch.core.notebook_controller import setup_core_controllers
from kubeflow_tpu_torch.gpu import topology
from kubeflow_tpu_torch.utils.clock import FakeClock
from kubeflow_tpu_torch.utils.config import CoreConfig

NS = "user1"
STOPPED_AT = "2023-11-14T22:30:00Z"
# minted by each store on its own: stripped before the comparison
STRIPPED = ("uid", "resourceVersion", "creationTimestamp",
            "deletionTimestamp", "ownerReferences[].uid",
            "generateName suffix", "containerState.running.startedAt",
            "involvedObject.uid")


class Stack:
    """One controller stack: the reference's (`port=False`) or the port's."""

    def __init__(self, port: bool, auto_ready: bool = True, **cfg):
        k = kube if port else ref_kube
        self.port, self.kube = port, k
        self.api = k.ApiServer()
        self.cluster = k.FakeCluster(self.api, auto_ready=auto_ready)
        self.clock = FakeClock() if port else RefFakeClock()
        self.mgr = k.Manager(self.api, clock=self.clock)
        self.metrics = (NotebookMetrics if port else RefMetrics)(self.api)
        config = (CoreConfig if port else RefConfig)(
            enable_self_healing=False, **cfg)
        (setup_core_controllers if port else ref_setup)(
            self.mgr, config, self.metrics)
        self.snapshots: list = []

    def create(self, name: str, finalizers=(), **kw):
        if self.port:
            obj = kube.KubeObject.from_dict(Notebook.new(name, NS, **kw).obj)
        else:
            obj = RefNotebook.new(name, NS, **kw).obj
        obj.metadata.finalizers = list(finalizers)
        self.api.create(obj)

    def annotate(self, name: str, key: str, value) -> None:
        nb = self.api.get("Notebook", NS, name)
        if value is None:
            nb.metadata.annotations.pop(key, None)
        else:
            nb.metadata.annotations[key] = value
        self.api.update(nb)

    def run(self) -> None:
        self.mgr.run_until_idle()
        self.snapshots.append(self.snapshot())

    def snapshot(self) -> dict:
        return {kind: sorted((_stripped(o.to_dict())
                              for o in self.api.list(kind, namespace=NS)),
                             key=lambda d: d["metadata"]["name"])
                for kind in ("Notebook", "StatefulSet", "Service", "Event")}


def _stripped(d: dict) -> dict:
    """`d` without the STRIPPED fields."""
    meta = d["metadata"]
    for key in ("uid", "resourceVersion", "creationTimestamp",
                "deletionTimestamp"):
        meta.pop(key, None)
    for ref in meta.get("ownerReferences", []):
        ref.pop("uid")
    if meta.get("generateName"):
        meta["name"] = meta["generateName"] + "*"
    running = (d.get("status") or {}).get("containerState", {}).get(
        "running")
    if running:
        running.pop("startedAt", None)
    d.get("involvedObject", {}).pop("uid", None)
    return d


# -- (a) CPU notebooks, event for event ----------------------------------------


def _drift(s: Stack, name: str = "nb") -> None:
    sts = s.api.get("StatefulSet", NS, name)
    sts.spec["replicas"] = 3
    sts.metadata.labels["drift"] = "yes"
    sts.spec["template"]["spec"]["containers"][0]["image"] = "other:1"
    s.api.update(sts)


def _create(s: Stack) -> None:
    s.create("nb", labels={"app": "nb"}, annotations={"team": "ml"})
    s.run()


def _stop_start(s: Stack) -> None:
    _create(s)
    s.annotate("nb", C.STOP_ANNOTATION, STOPPED_AT)
    s.run()
    s.annotate("nb", C.STOP_ANNOTATION, None)
    s.run()


def _restart(s: Stack) -> None:
    _create(s)
    s.annotate("nb", C.ANNOTATION_NOTEBOOK_RESTART, "true")
    s.run()


def _drift_reverted(s: Stack) -> None:
    _create(s)
    _drift(s)
    s.run()


def _sts_recreated(s: Stack) -> None:
    _create(s)
    s.api.delete("StatefulSet", NS, "nb")
    s.run()


def _long_name(s: Stack) -> None:
    s.create("n" * 60)
    s.run()
    s.annotate("n" * 60, C.STOP_ANNOTATION, STOPPED_AT)
    s.run()


def _terminating(s: Stack) -> None:
    s.create("nb", finalizers=["example.com/hold"])
    s.run()
    s.api.delete("Notebook", NS, "nb")
    _drift(s)
    s.run()


def _user_values(s: Stack) -> None:
    s.create("nb", pod_spec={
        "containers": [{
            "name": "nb", "workingDir": "/custom",
            "ports": [{"containerPort": 9999, "name": "p"}],
            "env": [{"name": "NB_PREFIX", "value": "/mine"}]}],
        "securityContext": {"runAsUser": 1000}})
    s.run()


def _events_reemitted(s: Stack) -> None:
    _create(s)
    kubelet = s.kube.EventRecorder(s.api, "kubelet")
    kubelet.event(s.api.get("Pod", NS, "nb-0"), "Warning", "FailedMount",
                  "volume not found")
    s.run()
    kubelet.event(s.api.get("StatefulSet", NS, "nb"), "Warning",
                  "FailedCreate", "quota exceeded")
    s.run()
    # a second pass over every Event re-emits none of them again
    s.mgr.enqueue_all("event-reemit")
    s.run()


SCENARIOS = {"create": _create, "stop_start": _stop_start,
             "restart": _restart, "drift_reverted": _drift_reverted,
             "sts_recreated": _sts_recreated, "long_name": _long_name,
             "terminating": _terminating, "user_values": _user_values,
             "events_reemitted": _events_reemitted}


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_cpu_notebooks_match_the_reference(scenario):
    stacks = []
    for port in (False, True):
        s = Stack(port)
        s.cluster.add_node("cpu-node",
                           allocatable={"cpu": "64", "memory": "256Gi"})
        SCENARIOS[scenario](s)
        stacks.append(s)
    ref, ours = stacks
    assert ours.snapshots == ref.snapshots
    last = ours.snapshot()
    assert last["StatefulSet"] and last["Service"]
    (nb,) = last["Notebook"]
    sts = last["StatefulSet"][0]
    if scenario == "stop_start":
        replicas = [snap["StatefulSet"][0]["spec"]["replicas"]
                    for snap in ours.snapshots]
        assert replicas == [1, 0, 1]
    elif scenario == "restart":
        assert C.ANNOTATION_NOTEBOOK_RESTART not in \
            nb["metadata"]["annotations"]
    elif scenario in ("drift_reverted", "terminating"):
        # reverted, except while the CR is terminating
        assert (sts["spec"]["replicas"] == 3) == (scenario == "terminating")
    elif scenario == "long_name":
        assert sts["metadata"]["name"] == "nb-*"
        assert sts["spec"]["replicas"] == 0
    elif scenario == "events_reemitted":
        reissued = [e for e in last["Event"]
                    if e["involvedObject"]["kind"] == "Notebook"]
        assert sorted(e["reason"] for e in reissued) == \
            ["FailedCreate", "FailedMount"]
    if scenario != "terminating":
        assert nb["status"]["readyReplicas"] == \
            (0 if sts["spec"]["replicas"] == 0 else 1)


# -- (b) a GPU gang against a TPU slice of the same host count -----------------


def _gang_life(s: Stack, hosts: int, spec: dict) -> list:
    """Create the notebook with no accelerator nodes, add them, bring the
    workers up (each pod holding a finalizer, as a pod in its graceful
    shutdown does), fail one, stop the notebook, and let the terminating
    pods go; returns (sliceHealth, workerStates, pods) after each step."""
    s.create("nb", **spec)
    steps = []

    def step():
        s.mgr.run_until_idle()
        st = s.api.get("Notebook", NS, "nb").status
        steps.append((st.get("sliceHealth"), st.get("workerStates"),
                      len(s.api.list("Pod", namespace=NS))))

    step()
    if s.port:
        s.cluster.add_gpu_nodes("h100-80gb", hosts, 8)
    else:
        s.cluster.add_tpu_slice_nodes(
            "tpu-v5-lite-podslice", spec["tpu"].topology, hosts,
            spec["tpu"].validate().chips_per_host)
    step()
    for i in range(hosts):
        s.cluster.mark_running(NS, f"nb-{i}")
        pod = s.api.get("Pod", NS, f"nb-{i}")
        pod.metadata.finalizers = ["example.com/graceful-shutdown"]
        s.api.update(pod)
    step()
    s.cluster.fail_pod(NS, f"nb-{hosts - 1}")
    step()
    # the StatefulSet scales to 0; its pods terminate but remain
    s.annotate("nb", C.STOP_ANNOTATION, STOPPED_AT)
    step()
    for i in range(hosts):
        s.api.force_remove_finalizers("Pod", NS, f"nb-{i}")
    step()
    return steps


@pytest.mark.parametrize("topo,count,hosts", [
    ("2x4", 8, 1), ("4x4", 32, 4), ("4x8", 64, 8)])
def test_gpu_gang_lives_as_the_tpu_slice(topo, count, hosts):
    ref = _gang_life(Stack(False, auto_ready=False), hosts,
                     {"tpu": TPUSpec("v5e", topo)})
    ours = _gang_life(Stack(True, auto_ready=False), hosts,
                      {"gpu": GPUSpec("h100-80gb", count)})
    assert ours == ref
    pending = [{"pod": f"nb-{i}", "phase": "Pending", "ready": False}
               for i in range(hosts)]
    running = [{"pod": f"nb-{i}", "phase": "Running", "ready": True}
               for i in range(hosts)]
    failed = running[:-1] + [{"pod": f"nb-{hosts - 1}", "phase": "Failed",
                              "ready": False}]
    degraded = "Degraded" if hosts > 1 else "Unhealthy"
    stopping = "Stopping" if hosts > 1 else "Stopped"
    assert ours == [("Unhealthy", pending, hosts),
                    ("Unhealthy", pending, hosts),
                    ("Healthy", running, hosts),
                    (degraded, failed, hosts),
                    (stopping, failed, hosts),
                    ("Stopped", [], 0)]


# -- (c) GPU accounting --------------------------------------------------------


def test_gangs_are_placed_where_their_gpus_fit():
    s = Stack(True)
    (node,) = s.cluster.add_gpu_nodes("h100-80gb", 1, 8)
    s.create("first", gpu=GPUSpec("h100-80gb", 8))
    s.mgr.run_until_idle()
    s.create("second", gpu=GPUSpec("h100-80gb", 8))
    s.mgr.run_until_idle()

    def health(name):
        return s.api.get("Notebook", NS, name).status["sliceHealth"]

    def bound(name):
        return s.api.get("Pod", NS, f"{name}-0").spec.get("nodeName")

    assert (health("first"), bound("first")) == ("Healthy", node.name)
    assert (health("second"), bound("second")) == ("Unhealthy", None)
    assert s.cluster.node_used(node.name)[C.GPU_RESOURCE] == 8
    s.metrics.scrape()
    assert s.metrics.running.value(NS) == 2
    assert s.metrics.gpus_requested.value(NS) == 16

    s.annotate("first", C.STOP_ANNOTATION, STOPPED_AT)
    s.mgr.run_until_idle()
    assert s.api.try_get("Pod", NS, "first-0") is None
    assert (health("first"), health("second")) == ("Stopped", "Healthy")
    assert bound("second") == node.name
    assert s.cluster.node_used(node.name)[C.GPU_RESOURCE] == 8
    s.metrics.scrape()
    assert s.metrics.gpus_requested.value(NS) == 8


# -- (d) the entry point and the refusals --------------------------------------


@pytest.mark.parametrize("accelerator", [None, "h200-141gb", "a100-80gb"])
def test_main_demo_serves_health_and_metrics(monkeypatch, capsys,
                                             accelerator):
    """`main --demo` in-process: its manager, server and demo gang come up
    on nodes of `--demo-accelerator` (h100-80gb when not given);
    /healthz, /readyz and /metrics answer while it runs, and stopping its
    manager ends it with 0."""
    built, healthy = {}, threading.Event()
    build = port_main.build_manager

    def recording_build_manager(*args, **kwargs):
        mgr, api, cluster, metrics = build(*args, **kwargs)
        built["mgr"], built["api"] = mgr, api

        def on_event(ev):
            if ev.obj.body.get("status", {}).get("sliceHealth") == "Healthy":
                healthy.set()
        api.watch(on_event, kinds=["Notebook"])
        return mgr, api, cluster, metrics

    serve = port_main.serve_http

    def recording_serve_http(port, manager, metrics, **kwargs):
        built["server"] = serve(0, manager, metrics, **kwargs)
        return built["server"]

    monkeypatch.setattr(port_main, "build_manager", recording_build_manager)
    monkeypatch.setattr(port_main, "serve_http", recording_serve_http)
    rc = []
    argv = ["--demo", "--demo-count", "16", "--run-seconds", "300"]
    if accelerator is not None:
        argv += ["--demo-accelerator", accelerator]
    thread = threading.Thread(target=lambda: rc.append(port_main.main(argv)))
    thread.start()
    try:
        assert healthy.wait(60)
        port = built["server"].server_address[1]

        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=10) as resp:
                return resp.status, resp.read().decode()

        assert get("/healthz") == (200, "ok")
        assert get("/readyz") == (200, "ok")
        status, body = get("/metrics")
        assert status == 200
        assert 'notebook_running{namespace="default"} 1' in body
        assert 'notebook_gpus_requested{namespace="default"} 16' in body
        assert "controller_runtime_reconcile_total" in body
        with pytest.raises(urllib.error.HTTPError) as missing:
            get("/nope")
        assert missing.value.code == 404
        api = built["api"]
        gke_label = topology.ACCELERATORS[
            accelerator or "h100-80gb"].gke_label
        nodes = {api.get("Node", "", p.body["spec"]["nodeName"])
                 .metadata.labels[C.GKE_GPU_ACCELERATOR_LABEL]
                 for p in api.list("Pod", "default")}
        assert nodes == {gke_label}
    finally:
        if "mgr" in built:
            built["mgr"].stop()
        thread.join(60)
    assert rc == [0]
    printed = json.loads(capsys.readouterr().out)
    assert printed["sliceHealth"] == "Healthy"
    assert [w["pod"] for w in printed["workerStates"]] == ["demo-0", "demo-1"]


@pytest.mark.parametrize("knob,item", [
    ("enable_self_healing", 12), ("enable_slice_scheduler", 13),
    ("use_istio", 15), ("spec.replication", 14)])
def test_parts_not_ported_are_refused(knob, item):
    """The parts the port once refused until their tier was ported
    (queue 1 items 12-15): each is now taken, as the reference takes
    it."""
    mgr = kube.Manager(kube.ApiServer(), clock=FakeClock())
    if knob == "enable_self_healing":
        # item 12 is ported: the switch is taken, and the reconciler runs
        # the recovery engine
        rec = setup_core_controllers(mgr, CoreConfig(**{knob: True}))
        assert rec.recovery.cfg.enable_self_healing
        assert CoreConfig().enable_self_healing
        return
    if knob == "enable_slice_scheduler":
        # item 13 is ported: the switch is taken, and the gang scheduler,
        # the warm pool and the preemption engine are registered, off by
        # default as in the reference
        rec = setup_core_controllers(mgr, CoreConfig(**{knob: True}))
        assert rec.cfg.enable_slice_scheduler
        assert {r.name for r in mgr._registrations} >= {
            "notebook", "slice-scheduler", "warm-pool", "preemption"}
        assert mgr.preemption_engine.cfg.enable_preemption
        assert not CoreConfig().enable_slice_scheduler
        return
    if knob == "use_istio":
        # item 15 is ported: the switch is taken, and the reconciler owns
        # the notebook's VirtualService, the reference's render
        from kubeflow_tpu.core.workload import generate_virtual_service

        cfg = CoreConfig(use_istio=True, istio_host="nb.example.com")
        setup_core_controllers(mgr, cfg, NotebookMetrics(mgr.api))
        nb = Notebook.new("nb", NS, annotations={
            C.ANNOTATION_REWRITE_URI: "/"})
        mgr.api.create(kube.KubeObject.from_dict(nb.obj))
        mgr.run_until_idle()
        vs = mgr.api.get("VirtualService", NS, "notebook-user1-nb")
        ref = generate_virtual_service(
            RefNotebook.new("nb", NS, annotations={
                C.ANNOTATION_REWRITE_URI: "/"}),
            RefConfig(use_istio=True, istio_host="nb.example.com"))
        assert vs.spec == ref.spec
        assert vs.metadata.controller_owner().name == "nb"
        return
    if knob.startswith("spec."):
        # item 14 is ported: the admission hook admits a replicated CR and
        # the reconciler seeds status.replication; an invalid replica
        # count is refused with the reference's message
        setup_core_controllers(mgr, CoreConfig(), NotebookMetrics(mgr.api))
        bad = Notebook.new("bad", NS, gpu=GPUSpec("h100-80gb", 8),
                           replication=ReplicationSpec(1))
        with pytest.raises(kube.AdmissionDenied,
                           match="spec.replication.replicas must be >= 2"):
            mgr.api.create(kube.KubeObject.from_dict(bad.obj))
        nb = Notebook.new("nb", NS, gpu=GPUSpec("h100-80gb", 8),
                          replication=ReplicationSpec(2))
        mgr.api.create(kube.KubeObject.from_dict(nb.obj))
        mgr.run_until_idle()
        live = mgr.api.get("Notebook", NS, "nb")
        assert live.body["spec"]["replication"] == {
            "replicas": 2, "antiAffine": True}
        rep = live.body["status"]["replication"]
        assert (rep["epoch"], rep["primary"]) == (1, 0)
        assert [n.name for n in mgr.api.list("Notebook")] == ["nb"]


_SWITCH_ON = {"ENABLE_PREEMPTION": "true", "ENABLE_CONTINUOUS_PROFILER": "true",
              "WARMPOOL_SHAPES": "h100-80gb:8", "SHARD_COUNT": "4"}
# the env switches of the slice scheduler's tier (queue 1 item 13), of
# the observability plane (item 16) and of the sharded fleet and the
# interleave checker (items 17 and 21), taken since they were ported:
# each parses into its field
_TIER_SWITCHES = {"ENABLE_PREEMPTION": ("enable_preemption", True),
                  "WARMPOOL_SIZE": ("warmpool_size", 1),
                  "WARMPOOL_SHAPES": ("warmpool_shapes", "h100-80gb:8"),
                  "REPLICATION_MAX_LAG": ("replication_max_lag", 1),
                  "ENABLE_CONTINUOUS_PROFILER": (
                      "enable_continuous_profiler", True),
                  "SHARD_COUNT": ("shard_count", 4),
                  "INTERLEAVE_MAX_SCHEDULES": ("interleave_max_schedules", 1),
                  **{name: (field, 1.0) for name, field in (
                      ("SLO_PROMOTION_P99_S", "slo_promotion_p99_s"),
                      ("SLO_TIME_TO_READY_P99_S", "slo_time_to_ready_p99_s"),
                      ("SLO_EVENT_TO_RECONCILE_P99_S",
                       "slo_event_to_reconcile_p99_s"),
                      ("SLO_RECONCILE_ERROR_RATE", "slo_reconcile_error_rate"),
                      ("SLO_RECOVERY_DURATION_P99_S", "slo_recovery_p99_s"),
                      ("SLO_WARMPOOL_HIT_RATE", "slo_warmpool_hit_rate"),
                      ("SLO_PLACEMENT_P99_S", "slo_placement_p99_s"),
                      ("SLO_FLEET_MFU", "slo_fleet_mfu"),
                      ("SLO_STRAGGLER_RATE", "slo_straggler_rate"),
                      ("SLO_TENANT_FAIRNESS", "slo_tenant_fairness"),
                      ("DATAPLANE_MFU_TARGET", "dataplane_mfu_target"),
                      ("SLO_SHARD_HANDOFF_P99_S", "slo_shard_handoff_p99_s"),
                      ("SHARD_LEASE_DURATION_S", "shard_lease_duration_s"),
                      ("INTERLEAVE_BUDGET_S", "interleave_budget_s"))}}
_SWITCH_OFF = {"ENABLE_PREEMPTION": "false",
               "ENABLE_CONTINUOUS_PROFILER": "false", "WARMPOOL_SHAPES": "",
               "SHARD_COUNT": "1"}


@pytest.mark.parametrize("name", sorted(_TIER_SWITCHES))
def test_env_switches_of_the_tier_are_taken(name):
    """The tier's env switches, with the on values that were refused
    before it was ported and their off values, parse into their fields as
    the reference's do, and move no other field."""
    field, want = _TIER_SWITCHES[name]
    for value in (_SWITCH_ON.get(name, "1"), _SWITCH_OFF.get(name, "0")):
        ours = CoreConfig.from_env({name: value})
        assert getattr(ours, field) == \
            getattr(RefConfig.from_env({name: value}), field)
        # nothing but the switch's own field moves
        assert dataclasses.replace(
            ours, **{field: getattr(CoreConfig(), field)}) == CoreConfig()
    assert getattr(CoreConfig.from_env(
        {name: _SWITCH_ON.get(name, "1")}), field) == want


@pytest.mark.parametrize("env", [{}, {
    "ENABLE_CULLING": "true", "CULL_IDLE_TIME": "5",
    "IDLENESS_CHECK_PERIOD": "2", "CLUSTER_DOMAIN": "corp.local",
    "DEV": "true", "ADD_FSGROUP": "false", "CHECKPOINT_BEFORE_CULL": "true",
    "WORKQUEUE_BASE_DELAY_MS": "10", "WORKQUEUE_MAX_DELAY_S": "60",
    "WORKQUEUE_QPS": "50", "WORKQUEUE_BURST": "7", "WORKQUEUE_WORKERS": "0",
    "WATCH_HISTORY_SIZE": "64", "CHECKPOINT_STORE_URI": "file:///ckpt",
    "CHECKPOINT_INTERVAL_S": "0.5", "CHECKPOINT_SIGNAL_ROOT": "/signals",
    "ENABLE_SELF_HEALING": "false"}])
def test_env_names_match_the_reference(env):
    """Every field the port keeps reads the reference's env name, with the
    reference's parse and default."""
    ours, ref = CoreConfig.from_env(env), RefConfig.from_env(env)
    for f in dataclasses.fields(CoreConfig):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name


def test_invalid_gpu_spec_and_tpu_spec_are_refused():
    mgr = kube.Manager(kube.ApiServer(), clock=FakeClock())
    setup_core_controllers(mgr, CoreConfig())
    bad = Notebook.new("nb", NS, gpu=GPUSpec("h100-80gb", 12)).obj
    with pytest.raises(kube.AdmissionDenied, match="multiple of 8"):
        mgr.api.create(kube.KubeObject.from_dict(bad))
    tpu = Notebook.new("nb", NS).obj
    tpu["spec"]["tpu"] = {"accelerator": "v5e", "topology": "4x4"}
    with pytest.raises(kube.AdmissionDenied, match="spec.tpu"):
        mgr.api.create(kube.KubeObject.from_dict(tpu))
    assert sorted(topology.ACCELERATORS) == ["a100-80gb", "h100-80gb",
                                             "h200-141gb"]
