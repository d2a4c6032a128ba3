"""The canonical end-to-end run: the whole stack in one script.

The port's twin of examples/run_stack.py.  It boots the standalone
manager (threaded event loop), creates a `spec.gpu` gang of 4 hosts x 8
H100s with auth on the fake GPU device plugin, waits for it to become
Healthy, prints the interesting objects (the workers' env carries
torchrun's PET_* rendezvous keys), then stops, resumes and deletes it.
This is the script to run after any change to the port's control plane:

    python -m kubeflow_tpu_torch.examples.run_stack

It runs on the CPU (the control plane imports no torch), waits in wall
time as the reference's does, and prints ALL OK at the end.
"""

from __future__ import annotations

import json
import time

from ..api.types import GPUSpec, Notebook
from ..core import constants as CC
from ..kube import KubeObject
from ..main import build_manager
from ..odh import constants as OC

HOSTS, GPUS_PER_HOST = 4, 8


def wait(cond, what, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            print(f"  ok: {what}")
            return
        time.sleep(0.05)
    raise SystemExit(f"TIMEOUT: {what}")


def main() -> None:
    mgr, api, cluster, metrics = build_manager()
    cluster.add_gpu_nodes("h100-80gb", HOSTS, GPUS_PER_HOST)
    mgr.start()
    print(f"== create: h100-80gb {HOSTS}x{GPUS_PER_HOST} gang with auth")
    nb = Notebook.new(
        "demo", "team-a", gpu=GPUSpec("h100-80gb", HOSTS * GPUS_PER_HOST),
        annotations={OC.ANNOTATION_INJECT_AUTH: "true"},
    )
    api.create(KubeObject.from_dict(nb.obj))
    wait(
        lambda: api.get("Notebook", "team-a", "demo")
        .body.get("status", {}).get("sliceHealth") == "Healthy",
        f"gang Healthy ({HOSTS} workers)",
    )
    status = api.get("Notebook", "team-a", "demo").body["status"]
    print(json.dumps(status, indent=2)[:400])
    pod = api.get("Pod", "team-a", "demo-0")
    env = {e["name"]: e.get("value") for e in pod.spec["containers"][0]["env"]}
    print("  worker env:", {k: v for k, v in env.items() if k and v})
    route = api.list("HTTPRoute", namespace="opendatahub",
                     label_selector={"notebook-name": "demo"})[0]
    print("  route:", route.name, "->",
          route.spec["rules"][0]["backendRefs"][0])

    print("== stop (gang-atomic)")
    live = api.get("Notebook", "team-a", "demo")
    live.metadata.annotations[CC.STOP_ANNOTATION] = "manual"
    api.update(live)
    wait(lambda: all(api.try_get("Pod", "team-a", f"demo-{i}") is None
                     for i in range(HOSTS)), "workers gone")

    print("== resume")
    live = api.get("Notebook", "team-a", "demo")
    del live.metadata.annotations[CC.STOP_ANNOTATION]
    api.update(live)
    wait(
        lambda: api.get("Notebook", "team-a", "demo")
        .body.get("status", {}).get("sliceHealth") == "Healthy",
        "gang Healthy again",
    )

    print("== delete")
    api.delete("Notebook", "team-a", "demo")
    wait(lambda: api.try_get("Notebook", "team-a", "demo") is None,
         "finalized")
    mgr.stop()
    print("ALL OK")


if __name__ == "__main__":
    main()
