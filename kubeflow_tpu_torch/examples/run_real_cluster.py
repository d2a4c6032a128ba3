"""Demo: the manager CLI reconciling a cluster over real sockets.

The port's twin of examples/run_real_cluster.py.  It stands up a
wire-protocol apiserver (kube/wire.py) and the fake data plane in this
process, the "cluster", with one full H100 host labelled by the fake
device plugin, then launches `python -m kubeflow_tpu_torch.main
--kubeconfig ...` as a SEPARATE process, which connects over HTTP,
acquires the leader Lease, starts informers, and reconciles a `spec.gpu`
notebook to Healthy.  The same CLI pointed at a real cluster's kubeconfig
does the same against real Kubernetes.  No GPU is needed: the control
plane imports no torch.

    python -m kubeflow_tpu_torch.examples.run_real_cluster

Prints RESULT: OK when the notebook reads Healthy and the manager exits
within 2 s of SIGINT, and exits non-zero otherwise.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

from ..api.types import GPUSpec, Notebook
from ..gpu import topology
from ..kube import FakeCluster, KubeObject
from ..kube.store import ApiServer
from ..kube.wire import KubeApiWireServer
from ..utils.clock import Clock

REPO = Path(__file__).resolve().parents[2]
LEASE = "kubeflow-tpu-notebook-controller"
ACCELERATOR = "h100-80gb"


def write_kubeconfig(path: str, server: str, token: str = "",
                     ca_file: str = "") -> None:
    """A one-context kubeconfig for `server`, written as JSON (which
    `RestConfig.from_kubeconfig` reads with or without PyYAML)."""
    cluster = {"server": server}
    if ca_file:
        cluster["certificate-authority"] = ca_file
    with open(path, "w") as f:
        json.dump({
            "apiVersion": "v1", "kind": "Config", "current-context": "demo",
            "contexts": [{"name": "demo",
                          "context": {"cluster": "demo", "user": "demo"}}],
            "clusters": [{"name": "demo", "cluster": cluster}],
            "users": [{"name": "demo", "user": {"token": token}}],
        }, f)


def wait_for(predicate, timeout_s: float, clock: Clock, step_s: float = 0.05):
    """predicate()'s first truthy value within `timeout_s`, else None."""
    deadline = clock.now() + timeout_s
    while clock.now() < deadline:
        value = predicate()
        if value:
            return value
        clock.sleep(step_s)
    return None


def stop_manager(proc: subprocess.Popen, clock: Clock) -> float:
    """SIGINT the manager; its exit's seconds (killed after 10 s)."""
    t0 = clock.monotonic()
    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    return clock.monotonic() - t0


def main() -> int:
    clock = Clock()
    api = ApiServer()
    cluster = FakeCluster(api)
    cluster.add_node("cpu-node", allocatable={"cpu": "64", "memory": "256Gi"})
    acc = topology.ACCELERATORS[ACCELERATOR]
    gpu = GPUSpec(ACCELERATOR, acc.gpus_per_host)
    shape = gpu.validate()
    cluster.add_gpu_nodes(ACCELERATOR, shape.num_hosts, shape.gpus_per_host)
    srv = KubeApiWireServer(api, token="demo-token").start()
    print(f"wire apiserver: {srv.url}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        kubeconfig = os.path.join(tmp, "kubeconfig")
        write_kubeconfig(kubeconfig, srv.url, token="demo-token")
        env = dict(os.environ, PYTHONPATH=str(REPO))
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.main",
             "--kubeconfig", kubeconfig, "--enable-leader-election",
             "--leader-election-namespace", "default",
             "--webhook-port", "-1", "--metrics-addr", "0",
             "--run-seconds", "120"],
            env=env, cwd=str(REPO))
        exit_s = None
        try:
            lease = wait_for(lambda: api.try_get("Lease", "default", LEASE),
                             20, clock)
            print("leader:", lease.body["spec"]["holderIdentity"]
                  if lease else None)
            api.create(KubeObject.from_dict(
                Notebook.new("demo-gpu", "default", gpu=gpu).obj))

            def healthy():
                nb = api.try_get("Notebook", "default", "demo-gpu")
                status = nb.body.get("status", {}) if nb else {}
                return status if status.get("sliceHealth") == "Healthy" \
                    else None

            status = wait_for(healthy, 30, clock, 0.2) or {}
            print(json.dumps({k: status.get(k) for k in
                              ("sliceHealth", "readyReplicas")}, indent=2))
        finally:
            exit_s = stop_manager(proc, clock)
            srv.stop()
    ok = status.get("sliceHealth") == "Healthy" and exit_s < 2.0
    print(f"manager exit after SIGINT: {exit_s:.2f} s")
    print("RESULT:", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
