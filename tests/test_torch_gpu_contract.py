"""The GPU side of the controller contract against the reference's TPU side.

The port renders a `spec.gpu` notebook (kubeflow_tpu_torch/core/workload.py)
as the reference renders a `spec.tpu` one: the two renders of one CR
differ only in the device's keys (resources, the accelerator
nodeSelector, the rendezvous env, the headless Service's port, the
pre-stop command, its signal directory and the grace period it waits
within).  Then what the pod's process
reads back: the accelerator table, the rendered torchrun env, two
`torchrun` "pods" forming one gloo world of 4 from that env alone, the
pre-stop hook that the reference renders without a `__main__` behind it
(kubeflow_tpu.runtime.checkpoint), and the gang's NetworkPolicy.  Only
the reference's control plane is imported."""

from __future__ import annotations

import copy
import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from kubeflow_tpu.api.types import Notebook as RefNotebook
from kubeflow_tpu.api.types import ReplicationSpec as RefReplicationSpec
from kubeflow_tpu.api.types import TPUSpec
from kubeflow_tpu.core import constants as RC
from kubeflow_tpu.core import workload as ref_workload
from kubeflow_tpu.odh.network import new_tpu_worker_network_policy
from kubeflow_tpu.tpu import env as tpuenv
from kubeflow_tpu.tpu import topology as tpu_topology
from kubeflow_tpu_torch.api.types import InvalidError, Notebook
from kubeflow_tpu_torch.core import constants as C
from kubeflow_tpu_torch.core import workload
from kubeflow_tpu_torch.gpu import env as gpuenv
from kubeflow_tpu_torch.gpu import topology
from kubeflow_tpu_torch.kube import KubeObject
from kubeflow_tpu_torch.odh.network import new_gpu_worker_network_policy
from kubeflow_tpu_torch.runtime import checkpoint
from kubeflow_tpu_torch.runtime.roofline import GPU_PEAKS

ROOT = Path(__file__).resolve().parent.parent
H100 = "NVIDIA H100 80GB HBM3"

# -- (a) the accelerator table ------------------------------------------------


@pytest.mark.parametrize("count,hosts,per_host", [
    (1, 1, 1), (2, 1, 2), (4, 1, 4), (8, 1, 8), (16, 2, 8), (32, 4, 8)])
def test_count_resolves_to_hosts(count, hosts, per_host):
    shape = topology.resolve("h100-80gb", count)
    assert (shape.gpus, shape.num_hosts, shape.gpus_per_host) == \
        (count, hosts, per_host)
    assert shape.bf16_peak_tflops == count * 989.0


def test_count_beyond_one_host_must_fill_hosts():
    with pytest.raises(topology.TopologyError,
                       match="count 12: .* multiple of 8 GPUs/host"):
        topology.resolve("h100-80gb", 12)
    with pytest.raises(InvalidError, match="spec.gpu: .*count 0"):
        Notebook({"kind": "Notebook", "spec": {"gpu": {
            "accelerator": "h100-80gb", "count": 0}}}).gpu.validate()


def test_unknown_accelerator_lists_the_supported():
    with pytest.raises(topology.TopologyError,
                       match=r"unknown accelerator 'v5e'; supported: "
                             r"\['a100-80gb', 'h100-80gb', 'h200-141gb'\]"):
        topology.resolve("v5e", 8)


def test_device_name_maps_to_its_row_and_the_roofline_reads_it():
    assert topology.accelerator_from_device_name(H100) == "h100-80gb"
    with pytest.raises(topology.TopologyError, match="unknown GPU"):
        topology.accelerator_from_device_name("NVIDIA GeForce RTX 4090")
    row = topology.ACCELERATORS["h100-80gb"]
    assert GPU_PEAKS[H100].bf16_tflops == row.bf16_peak_tflops == 989.0
    assert GPU_PEAKS[H100].hbm_gbps == row.hbm_gbps
    assert set(GPU_PEAKS) == {a.device_name for a in
                              topology.ACCELERATORS.values()}


# -- (b) render parity with the reference -------------------------------------

STORE = "file:///ckpt/store"
TPU_KEYS = {"env": {e["name"] for e in tpuenv.tpu_env_vars(
                "nb", tpu_topology.resolve("v5e", "4x4"), 0, 1)},
            "selector": {RC.GKE_TPU_ACCELERATOR_LABEL,
                         RC.GKE_TPU_TOPOLOGY_LABEL},
            "resource": RC.TPU_RESOURCE, "labels": {RC.TPU_SLICE_LABEL},
            "volumes": set(), "pod": set()}
GPU_KEYS = {"env": {e["name"] for e in gpuenv.gpu_env_vars(
                "nb", topology.resolve("h100-80gb", 32))}
            | {C.ENV_CHECKPOINT_SIGNAL_DIR},
            "selector": {C.GKE_GPU_ACCELERATOR_LABEL},
            "resource": C.GPU_RESOURCE, "labels": set(),
            "volumes": {C.CHECKPOINT_SIGNAL_VOLUME},
            "pod": {"terminationGracePeriodSeconds"}}


def _manifest(obj) -> dict:
    """A reference KubeObject as a manifest: the store's bookkeeping
    (uid, resourceVersion, ...) and empty fields dropped."""
    d = obj.to_dict()
    meta = {k: v for k, v in d["metadata"].items()
            if k in ("name", "generateName", "namespace", "labels",
                     "annotations") and v}
    return {"apiVersion": d["apiVersion"], "kind": d["kind"],
            "metadata": meta, "spec": d["spec"]}


def _port_manifest(obj: dict) -> dict:
    meta = {k: v for k, v in obj["metadata"].items() if v}
    return {**obj, "metadata": meta}


def _strip(manifest: dict, keys: dict) -> dict:
    """`manifest` without the device's keys."""
    m = copy.deepcopy(manifest)
    spec = m["spec"]
    if m["kind"] == "Service":
        if spec.get("clusterIP") == "None":
            spec.pop("ports")
        return m
    template = spec["template"]
    for label in keys["labels"]:
        template["metadata"]["labels"].pop(label, None)
    pod = template["spec"]
    for key in keys["pod"]:
        pod.pop(key, None)
    for label in keys["selector"]:
        pod.get("nodeSelector", {}).pop(label, None)
    pod["volumes"] = [v for v in pod.get("volumes", [])
                      if v["name"] not in keys["volumes"]]
    main = pod["containers"][0]
    for kind in ("requests", "limits"):
        main.get("resources", {}).get(kind, {}).pop(keys["resource"], None)
    main["env"] = [e for e in main["env"] if e["name"] not in keys["env"]]
    main["volumeMounts"] = [v for v in main.get("volumeMounts", [])
                            if v["name"] not in keys["volumes"]]
    if "lifecycle" in main:
        main["lifecycle"]["preStop"]["exec"].pop("command")
    return m


def _crs(stopped: bool, replicated: bool, restore: bool):
    """One CR rendered both ways: the reference's with spec.tpu {v5e, 4x4}
    (4 hosts x 4), the port's with spec.gpu {h100-80gb, 32} (4 x 8)."""
    annotations = {
        "kubectl.kubernetes.io/last-applied-configuration": "{}",
        "team.example.com/owner": "ml",
        RC.ANNOTATION_PLACEMENT: json.dumps({"v": 1, "slices": {
            "0": {"pool": "pool-a"}, "1": {"pool": "pool-b"}}}),
    }
    if stopped:
        annotations[RC.STOP_ANNOTATION] = "2026-01-01T00:00:00Z"
    ref = RefNotebook.new(
        "nb", "u1", tpu=TPUSpec("v5e", "4x4"),
        pod_spec={"containers": [{"name": "nb", "image": "jupyter:1",
                                  "env": [{"name": "USER_VAR",
                                           "value": "x"}]}]},
        labels={"app": "nb"}, annotations=annotations,
        replication=RefReplicationSpec(replicas=2) if replicated else None)
    status = {}
    if replicated:
        status["replication"] = {"primary": 1, "epoch": 3}
    if restore:
        status["sessionState"] = {
            "0": {"restoreGeneration": 4, "restoreUri": "file:///ckpt/mig"},
            "1": {"restoreGeneration": 2}}
    ref.obj.body["status"] = status
    port = ref.obj.to_dict()
    port["spec"].pop("tpu")
    port["spec"]["gpu"] = {"accelerator": "h100-80gb", "count": 32}
    return ref, Notebook(port)


def _renders(module, nb, cfg) -> list:
    return (module.generate_statefulsets(nb, cfg)
            + [module.generate_service(nb),
               module.generate_headless_service(nb)])


@pytest.mark.parametrize("restore", [False, True], ids=["cold", "restore"])
@pytest.mark.parametrize("store", [False, True], ids=["nostore", "store"])
@pytest.mark.parametrize("replicated", [False, True], ids=["one", "repl"])
@pytest.mark.parametrize("stopped", [False, True], ids=["run", "stop"])
def test_render_matches_the_reference_but_for_the_device(stopped, replicated,
                                                         store, restore):
    ref_nb, nb = _crs(stopped, replicated, restore)
    cfg = workload.WorkloadConfig(checkpoint_store_uri=STORE if store
                                  else "", checkpoint_interval_s=120.0)
    ref = [_manifest(o) for o in _renders(ref_workload, ref_nb, cfg)]
    ours = [_port_manifest(o) for o in _renders(workload, nb, cfg)]
    assert len(ours) == len(ref) == (4 if replicated else 3)
    assert [_strip(o, GPU_KEYS) for o in ours] == \
        [_strip(r, TPU_KEYS) for r in ref]

    # and the device's keys themselves
    for replica, sts in enumerate(ours[:-2]):
        assert sts["spec"]["replicas"] == (0 if stopped else 4)
        pod = sts["spec"]["template"]["spec"]
        main = pod["containers"][0]
        assert main["resources"] == {"requests": {"nvidia.com/gpu": "8"},
                                     "limits": {"nvidia.com/gpu": "8"}}
        assert pod["nodeSelector"][C.GKE_GPU_ACCELERATOR_LABEL] == \
            "nvidia-h100-80gb"
        env = {e["name"]: e.get("value") for e in main["env"]}
        assert env["PET_NNODES"] == "4" and env["PET_NPROC_PER_NODE"] == "8"
        assert env["PET_MASTER_ADDR"] == gpuenv.worker_hostname(
            "nb", 0, 1, 0, replica)
        assert (C.ENV_CHECKPOINT_SIGNAL_DIR in env) == store
        assert ("lifecycle" in main) == store
        assert ("terminationGracePeriodSeconds" in pod) == store
        if store:
            assert main["lifecycle"]["preStop"]["exec"]["command"] == [
                "python", "-m", "kubeflow_tpu_torch.runtime.checkpoint",
                "--pre-stop", "--timeout", "25"]
            assert pod["terminationGracePeriodSeconds"] == 30
            assert {"name": C.CHECKPOINT_SIGNAL_VOLUME, "emptyDir": {}} in \
                pod["volumes"]
            assert env[C.ENV_CHECKPOINT_SIGNAL_DIR] == \
                C.CHECKPOINT_SIGNAL_MOUNT
    assert ours[-1]["spec"]["ports"] == [{
        "name": "torch-rendezvous", "port": 29500, "targetPort": 29500,
        "protocol": "TCP"}]


@pytest.mark.parametrize("template_s,config_s,timeout", [
    (None, 30, "25"), (None, 300, "295"), (600, 30, "595"), (5, 30, None)],
    ids=["default", "controller", "template", "too-short"])
def test_hook_waits_within_the_grace_period(template_s, config_s, timeout):
    """The hook's --timeout is the pod's grace period less the margin left
    for SIGTERM: the template's own period, else the controller's, which
    is then rendered; a period that leaves the hook no time is refused."""
    pod_spec = {"containers": [{"name": "nb"}]}
    if template_s is not None:
        pod_spec["terminationGracePeriodSeconds"] = template_s
    nb = Notebook({"kind": "Notebook", "metadata": {"name": "nb"},
                   "spec": {"gpu": {"accelerator": "h100-80gb", "count": 8},
                            "template": {"spec": pod_spec}}})
    cfg = workload.WorkloadConfig(checkpoint_store_uri=STORE,
                                  termination_grace_period_s=config_s)
    if timeout is None:
        with pytest.raises(ValueError, match="grace period of 5 s"):
            workload.generate_statefulsets(nb, cfg)
        return
    (sts,) = workload.generate_statefulsets(nb, cfg)
    pod = sts["spec"]["template"]["spec"]
    assert pod["terminationGracePeriodSeconds"] == (template_s or config_s)
    assert pod["containers"][0]["lifecycle"]["preStop"]["exec"][
        "command"] == workload.PRE_STOP_COMMAND + ["--timeout", timeout]


@pytest.mark.parametrize("name", ["nb", "n" * 60])
def test_cpu_path_matches_the_reference(name):
    cfg = workload.WorkloadConfig()
    ref_nb = RefNotebook.new(name, "u1", labels={"app": "nb"},
                             annotations={RC.STOP_ANNOTATION: "now"})
    nb = Notebook(ref_nb.obj.to_dict())
    assert [_port_manifest(o) for o in _renders(workload, nb, cfg)][:-1] \
        == [_manifest(o) for o in _renders(ref_workload, ref_nb, cfg)][:-1]


# -- (c) the rendered env -----------------------------------------------------

TWO_BY_TWO = topology.GpuShape(topology.ACCELERATORS["h100-80gb"], gpus=4,
                               num_hosts=2, gpus_per_host=2)


def test_env_of_a_two_by_two_gang():
    env = gpuenv.gpu_env_vars("nb", TWO_BY_TWO, replica=1)
    assert [e["name"] for e in env] == [
        "PET_NODE_RANK", "GPU_WORKER_HOSTNAMES", "GPU_ACCELERATOR_TYPE",
        "PET_NNODES", "PET_NPROC_PER_NODE", "PET_MASTER_ADDR",
        "PET_MASTER_PORT"]
    assert env[0]["valueFrom"]["fieldRef"]["fieldPath"] == \
        "metadata.labels['apps.kubernetes.io/pod-index']"
    values = {e["name"]: e.get("value") for e in env}
    assert values == {
        "PET_NODE_RANK": None,
        "GPU_WORKER_HOSTNAMES": "nb-r1-0.nb-workers,nb-r1-1.nb-workers",
        "GPU_ACCELERATOR_TYPE": "h100-80gb", "PET_NNODES": "2",
        "PET_NPROC_PER_NODE": "2", "PET_MASTER_ADDR": "nb-r1-0.nb-workers",
        "PET_MASTER_PORT": "29500"}
    resolved = gpuenv.resolve_env(env, {"labels": {
        gpuenv.POD_INDEX_LABEL: "1"}})
    assert resolved["PET_NODE_RANK"] == "1"


# -- (d) two torchrun "pods" --------------------------------------------------

WORKER = """
import json
import sys
import torch
import torch.distributed as dist
from kubeflow_tpu_torch.runtime.init import distributed_init

identity = distributed_init(device="cpu")
total = torch.tensor([float(dist.get_rank())])
dist.all_reduce(total)
# one write of the whole line: a pod's two ranks share its stdout pipe,
# and print's separate write of the newline can land after the other
# rank's line
sys.stdout.write(json.dumps({"rank": dist.get_rank(),
                             "world": dist.get_world_size(),
                             "process_id": identity.process_id,
                             "node_rank": identity.node_rank,
                             "local_rank": identity.local_rank,
                             "sum": total.item()}) + "\\n")
sys.stdout.flush()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_two_torchrun_pods_form_one_world(tmp_path):
    """Each "pod" runs a bare `python -m torch.distributed.run worker.py`
    with the gang's env resolved as the kubelet would (its pod index; the
    master's DNS name as 127.0.0.1; the rendezvous port a free one, since
    tests share this host): no torchrun flag."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = str(_free_port())
    rendered = gpuenv.gpu_env_vars("nb", TWO_BY_TWO)
    pods = []
    for index in range(2):
        env = gpuenv.resolve_env(rendered, {"labels": {
            gpuenv.POD_INDEX_LABEL: str(index)}})
        assert env["PET_MASTER_ADDR"] == "nb-0.nb-workers"
        env.update(PET_MASTER_ADDR="127.0.0.1", PET_MASTER_PORT=port)
        env = {**os.environ, **env, "PYTHONPATH": os.pathsep.join(
            [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
        pods.append(subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", str(script)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    done = []
    for pod in pods:
        try:
            done.append(pod.communicate(timeout=300))
        except subprocess.TimeoutExpired:
            for other in pods:
                other.kill()
            done.append(pod.communicate())
    # both pods' stderr: a pod that fails leaves the other waiting
    assert [pod.returncode for pod in pods] == [0, 0], "\n".join(
        f"pod {i}: {err[-3000:]}" for i, (_, err) in enumerate(done))
    outs = [json.loads(line) for out, _ in done for line in out.splitlines()
            if line.startswith("{")]
    by_rank = sorted(outs, key=lambda o: o["rank"])
    assert [o["rank"] for o in by_rank] == [0, 1, 2, 3]
    for o in by_rank:
        assert o["world"] == 4 and o["sum"] == 6.0
        assert o["process_id"] == o["rank"] == \
            o["node_rank"] * 2 + o["local_rank"]


# -- (e) the pre-stop hook ----------------------------------------------------


def _acknowledger(watcher, stop: threading.Event) -> threading.Thread:
    def run():
        while not stop.is_set():
            if watcher.check():
                watcher.acknowledge()
                return
            stop.wait(0.01)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread


def test_rendered_hook_exits_0_on_the_ack(tmp_path):
    signals = tmp_path / "signal"
    watcher = checkpoint.CullSignalWatcher(str(tmp_path / "podinfo"),
                                           hook_dir=str(signals))
    stop = threading.Event()
    thread = _acknowledger(watcher, stop)
    command = [sys.executable] + workload.pre_stop_command(30)[1:]
    try:
        proc = subprocess.run(
            command, cwd=ROOT, capture_output=True, text=True, timeout=60,
            env={**os.environ, C.ENV_CHECKPOINT_SIGNAL_DIR: str(signals)})
    finally:
        stop.set()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["pre_stop"] == "acknowledged"
    assert (signals / checkpoint.ACK_FILE).exists()
    assert not (signals / checkpoint.REQUEST_FILE).exists()
    assert not (tmp_path / "podinfo" / checkpoint.ACK_FILE).exists()


def test_hook_exits_nonzero_without_an_ack(tmp_path, capsys):
    rc = checkpoint.main(["--pre-stop", "--signal-dir", str(tmp_path),
                          "--timeout", "0.2"])
    assert rc == 1
    assert "no checkpoint ack" in capsys.readouterr().err
    assert not (tmp_path / checkpoint.REQUEST_FILE).exists()
    assert checkpoint.PRE_STOP_TIMEOUT_S < 30


def test_no_ack_after_the_hook_gave_up(tmp_path):
    """A hook that timed out removed its request: the loop's ack then
    writes nothing, neither into the hook's directory nor into the
    read-only podinfo mount, where a write would raise in the loop."""
    podinfo, signals = tmp_path / "podinfo", tmp_path / "signal"
    watcher = checkpoint.CullSignalWatcher(str(podinfo),
                                           hook_dir=str(signals))
    assert checkpoint.pre_stop(str(signals), 0.05) is None
    assert not watcher.check()
    watcher.acknowledge()
    assert not (signals / checkpoint.ACK_FILE).exists()
    assert not podinfo.exists()


def test_checkpoint_on_cull_answers_the_hook(tmp_path):
    """The hook's request, in its own signal directory, fires the
    training loop's per-step hook: it saves the step and acks, and the
    pre-stop wait returns."""
    signals = tmp_path / "signal"
    manager = checkpoint.CheckpointManager(str(tmp_path / "ckpt"),
                                           backend="local")
    hook = checkpoint.checkpoint_on_cull(manager, checkpoint.CullSignalWatcher(
        str(tmp_path / "podinfo"), hook_dir=str(signals)))
    waited = []
    requester = threading.Thread(
        target=lambda: waited.append(checkpoint.pre_stop(str(signals), 30)),
        daemon=True)
    state = {"w": torch.arange(6.0).reshape(2, 3)}
    assert not hook(1, state)
    requester.start()
    fired_at, tick = None, threading.Event()
    for step in range(2, 3000):
        if hook(step, state):
            fired_at = step
            break
        tick.wait(0.01)
    requester.join(timeout=30)
    assert not requester.is_alive()
    assert fired_at is not None and waited[0] is not None
    assert manager.latest_step() == fired_at
    restored = manager.restore({"w": torch.zeros(2, 3)})
    assert torch.equal(restored["w"], state["w"])


# -- (f) the gang's NetworkPolicy ---------------------------------------------


def test_network_policy_matches_the_tpu_policy_without_ports():
    ref_nb, nb = _crs(False, False, False)
    ref = _manifest(new_tpu_worker_network_policy(ref_nb))
    ours = new_gpu_worker_network_policy(
        KubeObject.from_dict(nb.obj)).to_dict()
    (owner,) = ours["metadata"].pop("ownerReferences")
    assert (owner["kind"], owner["name"], owner["controller"]) == \
        ("Notebook", "nb", True)
    assert _manifest(KubeObject.from_dict(ours))["metadata"] == {
        "name": "nb-gpu-workers-np", "namespace": "u1"}
    assert ours["spec"]["podSelector"] == ref["spec"]["podSelector"]
    assert ours["spec"]["policyTypes"] == ref["spec"]["policyTypes"]
    (rule,), (ref_rule,) = ours["spec"]["ingress"], ref["spec"]["ingress"]
    assert rule["from"] == ref_rule["from"]
    assert {p["port"] for p in ref_rule["ports"]} == {8471, 8080}
    assert rule["ports"] == [{"protocol": "TCP"}]
