"""Rendered-object goldens: the conformance contract for what a conformant
controller must create.

The port of the reference's conformance/check_goldens.py.  For two
canonical Notebook inputs — a CPU workbench with auth (the reference's
input unchanged) and a two-host GPU workbench (`spec.gpu {h100-80gb,
16}`, two hosts of eight on `FakeCluster.add_gpu_nodes`) — the COMMITTED
goldens (goldens/workbench_objects.json beside this file) record the
full normalized object set the port's controllers render: names,
labels, ports, env injection, the gang's torchrun wiring, network policy
shape.

    python -m kubeflow_tpu_torch.conformance.goldens [--update]

re-renders through the port's `main.build_manager` and diffs; any drift
fails.  `--update` regenerates the port's goldens (a contract change, to
be reviewed like one).  The deployment manifests are not rendered here:
`kubeflow_tpu_torch.deploy` holds its profiles against the reference's.
"""

from __future__ import annotations

import argparse
import difflib
import json
from pathlib import Path

GOLDEN_DIR = Path(__file__).resolve().parent / "goldens"
GOLDEN_FILE = "workbench_objects.json"

# dynamic/server-assigned fields stripped before comparison
VOLATILE_META = ("uid", "resourceVersion", "creationTimestamp", "generation",
                 "deletionTimestamp")


def normalize(obj: dict) -> dict:
    obj = json.loads(json.dumps(obj))  # deep copy
    meta = obj.get("metadata", {})
    for k in VOLATILE_META:
        meta.pop(k, None)
    for ref in meta.get("ownerReferences", []) or []:
        ref.pop("uid", None)
    obj.pop("status", None)
    # annotations stamped with wall-clock times
    ann = meta.get("annotations") or {}
    for k in list(ann):
        if "last-activity" in k or "last_activity" in k:
            ann[k] = "<timestamp>"
    return obj


def sort_key(obj: dict) -> tuple:
    return (obj.get("kind", ""), obj.get("metadata", {}).get("namespace", ""),
            obj.get("metadata", {}).get("name", ""))


# label -> (notebook name, spec.gpu as (accelerator, count) or None,
# annotations)
SCENARIOS = {
    "cpu-auth-workbench": (
        "wb-cpu", None, {"notebooks.opendatahub.io/inject-auth": "true"}),
    "gpu-multihost-workbench": ("wb-gpu", ("h100-80gb", 16), {}),
}


def render_workbench_objects() -> dict[str, list[dict]]:
    """Drive the full manager over the two canonical inputs and collect
    every object the controllers render."""
    from ..api.types import GPUSpec, Notebook
    from ..kube import KubeObject
    from ..main import build_manager
    from ..utils.config import CoreConfig, OdhConfig

    out: dict[str, list[dict]] = {}
    for label, (name, gpu, annotations) in SCENARIOS.items():
        mgr, api, cluster, _ = build_manager(
            core_cfg=CoreConfig.from_env({}), odh_cfg=OdhConfig.from_env({}))
        spec = None
        if gpu is not None:
            spec = GPUSpec(*gpu)
            shape = spec.validate()
            cluster.add_gpu_nodes(spec.accelerator, shape.num_hosts,
                                  shape.gpus_per_host)
        else:
            cluster.add_node("n1", allocatable={"cpu": "8", "memory": "32Gi"})
        nb = Notebook.new(name, "user-ns", gpu=spec, annotations=annotations)
        api.create(KubeObject.from_dict(nb.obj))
        mgr.run_until_idle()
        objects = []
        for kind, items in api.dump().items():
            if kind in ("Node", "Namespace", "Event", "Lease"):
                continue  # infrastructure, not rendered contract
            if kind == "Pod":
                continue  # kubelet's output, not the controller's
            objects.extend(normalize(item) for item in items)
        out[label] = sorted(objects, key=sort_key)
        mgr.stop()
        if mgr.profiler is not None:
            mgr.profiler.stop()
    return out


def rendered_text() -> str:
    return json.dumps(render_workbench_objects(), indent=1,
                      sort_keys=True) + "\n"


def check(update: bool = False) -> int:
    """0 when the render equals the committed goldens (or `update`
    wrote them), 1 on drift, printing PASS/FAIL and the diff's head."""
    rendered = rendered_text()
    path = GOLDEN_DIR / GOLDEN_FILE
    if update:
        GOLDEN_DIR.mkdir(exist_ok=True)
        path.write_text(rendered)
        print(f"UPDATED {GOLDEN_FILE}")
        return 0
    if not path.exists():
        print(f"FAIL {GOLDEN_FILE}: golden missing (run with --update)")
        return 1
    golden = path.read_text()
    if golden != rendered:
        diff = difflib.unified_diff(
            golden.splitlines(), rendered.splitlines(),
            fromfile=f"goldens/{GOLDEN_FILE}", tofile="rendered",
            lineterm="", n=2)
        print(f"FAIL {GOLDEN_FILE}: rendered objects drifted from the "
              "contract:")
        for line in list(diff)[:60]:
            print("  " + line)
        return 1
    print(f"PASS {GOLDEN_FILE}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--update", action="store_true",
                        help="regenerate the goldens (contract change)")
    return check(parser.parse_args(argv).update)


if __name__ == "__main__":
    raise SystemExit(main())
