"""Black-box behavioral conformance: drive ANY implementation over the wire.

The port of the reference's conformance/behavior.py, with the GPU gang's
contract in the place of the TPU slice's.  It speaks ONLY the
Kubernetes REST protocol to a server URL — stdlib `urllib`, no import
from either package — and certifies the externally observable Notebook
contract:

  1. CRD lifecycle: a created Notebook yields a StatefulSet named after it
     (labels `notebook-name`), a ClusterIP Service on port 80 -> 8888, and
     a status with readyReplicas + conditions.
  2. The annotation protocol: setting `kubeflow-resource-stopped` scales the
     workload to 0 replicas (gang-atomically for GPU notebooks); removing
     it restores scale; `notebooks.opendatahub.io/notebook-restart: "true"`
     is cleared by the controller after acting.
  3. GPU gang contract: `spec.gpu` renders one StatefulSet per gang with
     `replicas` = the gang's hosts, the headless worker Service,
     `nvidia.com/gpu` in the worker container's requests and limits, and
     torchrun's rendezvous env (`PET_NODE_RANK` from the pod-index label,
     `PET_NNODES`, `PET_NPROC_PER_NODE`, `PET_MASTER_ADDR`,
     `PET_MASTER_PORT`) with the ordinal-ordered `GPU_WORKER_HOSTNAMES`.
  4. Deletion: removing the Notebook removes the rendered objects.

Usage:  python -m kubeflow_tpu_torch.conformance.behavior \
            --server http://HOST:PORT [--namespace ns] [--expect-scheduled]
`python -m kubeflow_tpu_torch.conformance` boots the port's manager with
--serve-api and points this runner at it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request

STOP = "kubeflow-resource-stopped"
RESTART = "notebooks.opendatahub.io/notebook-restart"
GPU_RESOURCE = "nvidia.com/gpu"
POD_INDEX_LABEL = "apps.kubernetes.io/pod-index"
# the canonical gang: two hosts of eight H100s
GPU_ACCELERATOR, GPU_COUNT = "h100-80gb", 16
# torchrun's flags as env (PET_<FLAG>) and the gang's hostname list, as
# core/workload.py renders them into the worker container
RENDEZVOUS_ENV = ("PET_NODE_RANK", "PET_NNODES", "PET_NPROC_PER_NODE",
                  "PET_MASTER_ADDR", "PET_MASTER_PORT",
                  "GPU_WORKER_HOSTNAMES")


class Client:
    def __init__(self, server: str, namespace: str):
        self.server = server.rstrip("/")
        self.ns = namespace

    def req(self, method, path, body=None, ctype="application/json"):
        req = urllib.request.Request(
            self.server + path,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": ctype}, method=method)
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                raw = resp.read()
                return resp.status, json.loads(raw) if raw else {}
        except urllib.error.HTTPError as err:
            raw = err.read()
            return err.code, json.loads(raw) if raw else {}

    def nb_path(self, name=""):
        base = f"/apis/kubeflow.org/v1/namespaces/{self.ns}/notebooks"
        return f"{base}/{name}" if name else base

    def sts(self, name):
        return self.req("GET",
                        f"/apis/apps/v1/namespaces/{self.ns}/statefulsets/{name}")

    def svc(self, name):
        return self.req("GET",
                        f"/api/v1/namespaces/{self.ns}/services/{name}")

    def pods(self, notebook):
        status, pods = self.req(
            "GET", f"/api/v1/namespaces/{self.ns}/pods"
                   f"?labelSelector=notebook-name%3D{notebook}")
        return pods.get("items", []) if status == 200 else None


def expect(condition, detail="") -> None:
    """A conformance check that `python -O` does not strip: raises
    AssertionError with `detail` when `condition` is false."""
    if not condition:
        raise AssertionError(detail)


def wait(predicate, timeout=30.0, what="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        result = predicate()
        if result:
            return result
        time.sleep(0.25)
    raise AssertionError(f"CONFORMANCE FAIL: timed out waiting for {what}")


def _set_stop(c: Client, name: str, stopped: bool) -> None:
    code, live = c.req(
        "PATCH", c.nb_path(name),
        {"metadata": {"annotations":
                      {STOP: "2026-01-01T00:00:00Z" if stopped else None}}},
        ctype="application/merge-patch+json")
    expect(code == 200, (code, live))


def check_cpu_lifecycle(c: Client) -> None:
    name = "conf-cpu"
    status, _ = c.req("POST", c.nb_path(), {
        "apiVersion": "kubeflow.org/v1", "kind": "Notebook",
        "metadata": {"name": name},
        "spec": {"template": {"spec": {"containers": [
            {"name": name, "image": "workbench:latest"}]}}},
    })
    expect(status == 201, f"create returned {status}")
    # 1. workload rendering
    sts = wait(lambda: c.sts(name)[1] if c.sts(name)[0] == 200 else None,
               what="StatefulSet")
    labels = sts["spec"]["template"]["metadata"]["labels"]
    expect(labels.get("notebook-name") == name, labels)
    expect(sts["spec"]["replicas"] == 1, sts["spec"].get("replicas"))
    svc = wait(lambda: c.svc(name)[1] if c.svc(name)[0] == 200 else None,
               what="Service")
    port = svc["spec"]["ports"][0]
    expect((port["port"], port["targetPort"]) == (80, 8888), port)
    # status contract
    wait(lambda: "readyReplicas" in (c.req("GET", c.nb_path(name))[1]
                                     .get("status") or {}),
         what="status.readyReplicas")
    # 2. stop/resume annotation protocol
    _set_stop(c, name, True)
    wait(lambda: c.sts(name)[1].get("spec", {}).get("replicas") == 0,
         what="scale to zero on stop annotation")
    _set_stop(c, name, False)
    wait(lambda: c.sts(name)[1].get("spec", {}).get("replicas") == 1,
         what="scale up on stop-annotation removal")
    # restart annotation is acted on + cleared
    c.req("PATCH", c.nb_path(name),
          {"metadata": {"annotations": {RESTART: "true"}}},
          ctype="application/merge-patch+json")
    wait(lambda: RESTART not in (c.req("GET", c.nb_path(name))[1]
                                 .get("metadata", {}).get("annotations") or {}),
         what="restart annotation cleared by controller")
    # 4. deletion
    c.req("DELETE", c.nb_path(name))
    wait(lambda: c.req("GET", c.nb_path(name))[0] == 404,
         what="notebook finalized")
    wait(lambda: c.sts(name)[0] == 404, what="StatefulSet cleanup")
    print("PASS cpu lifecycle + annotation protocol")


def check_gang_statefulset(sts: dict, name: str) -> int:
    """The gang's StatefulSet as rendered: bound to the headless worker
    Service, `nvidia.com/gpu` in requests and limits of the worker
    container, and torchrun's rendezvous env whose counts agree with the
    StatefulSet and the resources.  Returns the gang's host count (the
    StatefulSet's replicas, read off the object so the check stays
    black-box)."""
    spec = sts["spec"]
    expect(spec["serviceName"] == f"{name}-workers", spec.get("serviceName"))
    hosts = spec["replicas"]
    expect(hosts >= 1, hosts)
    containers = spec["template"]["spec"]["containers"]
    wb = next(ct for ct in containers if ct["name"] == name)
    resources = wb.get("resources", {})
    per_host = {}
    for kind in ("requests", "limits"):
        have = resources.get(kind, {})
        expect(GPU_RESOURCE in have,
               f"{GPU_RESOURCE} missing from the worker's {kind}: {have}")
        per_host[kind] = int(have[GPU_RESOURCE])
    expect(per_host["requests"] == per_host["limits"] >= 1, per_host)
    env = {e["name"]: e for e in wb.get("env", [])}
    missing = [n for n in RENDEZVOUS_ENV if n not in env]
    expect(not missing, f"rendezvous env {missing} missing from the "
           f"worker: {sorted(env)}")
    rank = env["PET_NODE_RANK"].get("valueFrom", {}).get("fieldRef", {})
    expect(rank.get("fieldPath") == f"metadata.labels['{POD_INDEX_LABEL}']",
           rank)
    expect(env["PET_NNODES"]["value"] == str(hosts), env["PET_NNODES"])
    expect(env["PET_NPROC_PER_NODE"]["value"] == str(per_host["limits"]),
           env["PET_NPROC_PER_NODE"])
    hostnames = env["GPU_WORKER_HOSTNAMES"]["value"].split(",")
    expect(len(hostnames) == hosts, hostnames)
    expect(env["PET_MASTER_ADDR"]["value"] == hostnames[0],
           (env["PET_MASTER_ADDR"], hostnames))
    expect(int(env["PET_MASTER_PORT"]["value"]) > 0, env["PET_MASTER_PORT"])
    return hosts


def check_gpu_pods_scheduled(c: Client, name: str, hosts: int) -> None:
    """Real-substrate gang check: every pod of the gang must actually
    BIND to a node — which only happens when the nodes advertise
    `nvidia.com/gpu` allocatable (the fake device plugin, or real GPU
    nodes) — and each pod's rank resolves from its ordinal: the
    pod-index label PET_NODE_RANK reads equals the ordinal in the pod's
    name, and entry i of the hostname list is the pod of ordinal i."""
    def gang():
        pods = c.pods(name)
        if pods is None:
            return None
        bound = [p for p in pods if p["spec"].get("nodeName")]
        return bound if len(bound) == hosts else None

    pods = wait(gang, what=f"gang of {hosts} pods scheduled", timeout=120)
    ranks = set()
    for pod in pods:
        ordinal = pod["metadata"]["name"].rsplit("-", 1)[1]
        rank = pod["metadata"].get("labels", {}).get(POD_INDEX_LABEL)
        expect(rank == ordinal, (pod["metadata"]["name"], rank))
        ranks.add(int(rank))
        wb = pod["spec"]["containers"][0]
        env = {e["name"]: e for e in wb.get("env", [])}
        hostnames = env["GPU_WORKER_HOSTNAMES"]["value"].split(",")
        expect(len(hostnames) == hosts, hostnames)
        # ordinal order: entry i is the pod with STS ordinal i (its DNS
        # name starts "<sts>-<ordinal>."), so index == PET_NODE_RANK
        for i, h in enumerate(hostnames):
            expect(h.split(".", 1)[0].endswith(f"-{i}"), (i, hostnames))
        limits = wb.get("resources", {}).get("limits", {})
        expect(GPU_RESOURCE in limits,
               f"{GPU_RESOURCE} missing from the pod's limits: {limits}")
    expect(ranks == set(range(hosts)), sorted(ranks))
    print("PASS gpu gang scheduling on real nodes")


def check_gpu_topology(c: Client, expect_scheduled: bool = False) -> None:
    name = "conf-gpu"
    status, _ = c.req("POST", c.nb_path(), {
        "apiVersion": "kubeflow.org/v1", "kind": "Notebook",
        "metadata": {"name": name},
        "spec": {
            "gpu": {"accelerator": GPU_ACCELERATOR, "count": GPU_COUNT},
            "template": {"spec": {"containers": [
                {"name": name, "image": "workbench:latest"}]}},
        },
    })
    expect(status == 201, f"create returned {status}")
    sts = wait(lambda: c.sts(name)[1] if c.sts(name)[0] == 200 else None,
               what="gang StatefulSet")
    hosts = check_gang_statefulset(sts, name)
    headless = wait(
        lambda: c.svc(f"{name}-workers")[1]
        if c.svc(f"{name}-workers")[0] == 200 else None,
        what="headless worker Service")
    expect(headless["spec"].get("clusterIP") == "None", headless["spec"])
    if expect_scheduled:
        check_gpu_pods_scheduled(c, name, hosts)
    # gang-atomic stop: the StatefulSet goes to 0 and every pod goes
    _set_stop(c, name, True)
    wait(lambda: c.sts(name)[1].get("spec", {}).get("replicas") == 0,
         what="gang-atomic stop")
    if expect_scheduled:
        wait(lambda: c.pods(name) == [], what="every gang pod gone on stop")
    # gang-atomic resume: the whole gang comes back, never a part of it
    _set_stop(c, name, False)
    wait(lambda: c.sts(name)[1].get("spec", {}).get("replicas") == hosts,
         what="gang-atomic resume")
    if expect_scheduled:
        check_gpu_pods_scheduled(c, name, hosts)
    c.req("DELETE", c.nb_path(name))
    wait(lambda: c.req("GET", c.nb_path(name))[0] == 404,
         what="gpu notebook finalized")
    wait(lambda: c.sts(name)[0] == 404, what="gang StatefulSet cleanup")
    print("PASS gpu topology + gang-atomic semantics")


def check_served_versions(c: Client) -> None:
    """The CRD serves v1alpha1/v1beta1/v1 with webhook conversion: a
    non-storage-version client must round-trip (each side sees its own
    apiVersion; metadata/uid shared)."""
    name = "conf-conv"
    beta = f"/apis/kubeflow.org/v1beta1/namespaces/{c.ns}/notebooks"
    status, created = c.req("POST", beta, {
        "apiVersion": "kubeflow.org/v1beta1", "kind": "Notebook",
        "metadata": {"name": name},
        "spec": {"template": {"spec": {"containers": [
            {"name": name, "image": "workbench:latest"}]}}},
    })
    expect(status == 201, f"v1beta1 create returned {status}: {created}")
    expect(created["apiVersion"] == "kubeflow.org/v1beta1",
           created["apiVersion"])
    status, v1 = c.req("GET", c.nb_path(name))
    expect(status == 200 and v1["apiVersion"] == "kubeflow.org/v1",
           (status, v1.get("apiVersion")))
    expect(v1["metadata"]["uid"] == created["metadata"]["uid"])
    status, lst = c.req("GET", beta)
    expect(status == 200)
    mine = [i for i in lst["items"] if i["metadata"]["name"] == name]
    expect(mine and mine[0]["apiVersion"] == "kubeflow.org/v1beta1", lst)
    c.req("DELETE", c.nb_path(name))
    wait(lambda: c.req("GET", c.nb_path(name))[0] == 404,
         what="converted notebook cleanup")
    print("PASS served-versions conversion round-trip")


def check_istio_routing(c: Client) -> None:
    """USE_ISTIO contract: a Notebook yields a VirtualService
    `notebook-{ns}-{name}` whose single http route prefix-matches
    /notebook/{ns}/{name}/, rewrites to the same prefix by default,
    targets the Service on port 80 through the configured gateway, and is
    removed with the Notebook."""
    name = "conf-istio"
    vs_path = (f"/apis/networking.istio.io/v1alpha3/namespaces/{c.ns}"
               f"/virtualservices/notebook-{c.ns}-{name}")
    status, _ = c.req("POST", c.nb_path(), {
        "apiVersion": "kubeflow.org/v1", "kind": "Notebook",
        "metadata": {"name": name},
        "spec": {"template": {"spec": {"containers": [
            {"name": name, "image": "workbench:latest"}]}}},
    })
    expect(status == 201, f"create returned {status}")
    vs = wait(lambda: c.req("GET", vs_path)[1]
              if c.req("GET", vs_path)[0] == 200 else None,
              what="VirtualService rendered")
    spec = vs["spec"]
    expect(spec.get("gateways"), spec)
    (route,) = spec["http"]
    prefix = f"/notebook/{c.ns}/{name}/"
    expect(route["match"] == [{"uri": {"prefix": prefix}}], route["match"])
    expect(route["rewrite"] == {"uri": prefix}, route["rewrite"])
    (dest,) = route["route"]
    expect(dest["destination"]["host"].startswith(f"{name}.{c.ns}.svc."), dest)
    expect(dest["destination"]["port"] == {"number": 80}, dest)
    c.req("DELETE", c.nb_path(name))
    wait(lambda: c.req("GET", vs_path)[0] == 404,
         what="VirtualService cleanup")
    print("PASS istio VirtualService routing contract")


def run(server: str, namespace: str = "default", skip_gpu: bool = False,
        skip_conversion: bool = False, expect_scheduled: bool = False,
        istio: bool = False) -> list[str]:
    """Every check in order; the names of those that passed.  The first
    failing check raises AssertionError."""
    c = Client(server, namespace)
    passed = []
    check_cpu_lifecycle(c)
    passed.append("cpu_lifecycle")
    if not skip_conversion:
        check_served_versions(c)
        passed.append("served_versions")
    if not skip_gpu:
        check_gpu_topology(c, expect_scheduled=expect_scheduled)
        passed.append("gpu_topology")
    if istio:
        check_istio_routing(c)
        passed.append("istio_routing")
    return passed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--server", required=True)
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--skip-gpu", action="store_true",
                        help="cluster has no GPU nodes")
    parser.add_argument("--skip-conversion", action="store_true",
                        help="CRD deployed without the conversion webhook")
    parser.add_argument("--expect-scheduled", action="store_true",
                        help="cluster has a real scheduler + GPU-capacity "
                             "nodes (fake device plugin): assert the gang "
                             "actually binds and each rank resolves from "
                             "its ordinal")
    parser.add_argument("--istio", action="store_true",
                        help="controller runs with USE_ISTIO: assert the "
                             "VirtualService routing contract")
    args = parser.parse_args(argv)
    try:
        run(args.server, args.namespace, skip_gpu=args.skip_gpu,
            skip_conversion=args.skip_conversion,
            expect_scheduled=args.expect_scheduled, istio=args.istio)
    except AssertionError as err:
        print(f"CONFORMANCE FAIL: {err}" if "CONFORMANCE FAIL" not in
              str(err) else err)
        return 1
    print("behavioral conformance: PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
