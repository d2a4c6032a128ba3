"""Distributed-runtime environment wiring for GPU notebook workers.

The port of kubeflow_tpu/tpu/env.py.  Every worker pod of a GPU gang
gets the env that `torchrun` reads for its flags (`PET_<FLAG>`,
torch/distributed/argparse_util.py), derived from the indexed
StatefulSet + headless Service identity, so `torchrun script.py` forms
the gang's world in the pod with no flags:

- PET_NODE_RANK          — pod ordinal, via downward API from the pod-index
  label (the TPU's TPU_WORKER_ID)
- GPU_WORKER_HOSTNAMES   — comma list of stable per-worker DNS names
- GPU_ACCELERATOR_TYPE   — the accelerator key (gpu/topology.py)
- PET_NNODES, PET_NPROC_PER_NODE — hosts, and one process per GPU
- PET_MASTER_ADDR / PET_MASTER_PORT — worker 0 of the replica's gang,
  where torchrun's agent store listens

These are the names Kubeflow's training-operator renders for a
PyTorchJob.  A gang has no multi-slice form: torch.distributed spans
all hosts of a gang in one world over NCCL, with no DCN tier between
slices to coordinate, so MEGASCALE_* has no counterpart.  The name
helpers keep the reference's `slice_id` and `num_slices` parameters only
so that their names and signatures match it; a gang always passes 0 and
1.  The hostnames list is ordered by ordinal: its index equals
PET_NODE_RANK.
"""

from __future__ import annotations

from typing import Mapping

from ..core.constants import POD_INDEX_LABEL, TORCH_RENDEZVOUS_PORT
from .topology import GpuShape


def headless_service_name(notebook_name: str) -> str:
    return f"{notebook_name}-workers"


def worker_hostname(
    notebook_name: str, slice_id: int, num_slices: int, ordinal: int,
    replica: int = 0,
) -> str:
    """Short DNS name of one worker through the headless Service.

    Resolvable cluster-wide as {pod}.{svc}.{ns}.svc via the pod's
    subdomain; we emit the svc-qualified short form GKE uses.  All
    replica gangs share the notebook's one headless Service — follower
    pods carry the same notebook-name label, so their names resolve
    through the same subdomain.
    """
    sts = statefulset_name(notebook_name, slice_id, num_slices, replica)
    return f"{sts}-{ordinal}.{headless_service_name(notebook_name)}"


def statefulset_name(notebook_name: str, slice_id: int, num_slices: int,
                     replica: int = 0) -> str:
    """Slice 0 of a single-slice notebook keeps the bare CR name so the
    CPU-path naming contract (STS == notebook name, reference
    notebook_controller.go:433-447) holds; multi-slice appends -slice-N.
    Replica 0 (the boot-time primary) keeps the unreplicated names —
    turning replication on never renames a running workload; follower
    gangs append -rN."""
    base = notebook_name if num_slices <= 1 \
        else f"{notebook_name}-slice-{slice_id}"
    return base if replica <= 0 else f"{base}-r{replica}"


def worker_hostnames(notebook_name: str, shape: GpuShape, slice_id: int,
                     num_slices: int, replica: int = 0) -> list[str]:
    return [
        worker_hostname(notebook_name, slice_id, num_slices, i, replica)
        for i in range(shape.num_hosts)
    ]


def gpu_env_vars(notebook_name: str, shape: GpuShape,
                 replica: int = 0) -> list[dict]:
    """corev1.EnvVar list (dict form) for every worker container of one
    replica's gang.

    PET_NODE_RANK comes from the downward API so one pod template serves
    all ordinals.  Each replica gang is its own world: the master is
    worker 0 of the replica's own gang."""
    hostnames = ",".join(worker_hostnames(notebook_name, shape, 0, 1,
                                          replica))
    return [
        {
            "name": "PET_NODE_RANK",
            "valueFrom": {
                "fieldRef": {
                    "fieldPath": f"metadata.labels['{POD_INDEX_LABEL}']"
                }
            },
        },
        {"name": "GPU_WORKER_HOSTNAMES", "value": hostnames},
        {"name": "GPU_ACCELERATOR_TYPE", "value": shape.accelerator.name},
        {"name": "PET_NNODES", "value": str(shape.num_hosts)},
        {"name": "PET_NPROC_PER_NODE", "value": str(shape.gpus_per_host)},
        {"name": "PET_MASTER_ADDR",
         "value": worker_hostname(notebook_name, 0, 1, 0, replica)},
        {"name": "PET_MASTER_PORT", "value": str(TORCH_RENDEZVOUS_PORT)},
    ]


def resolve_env(env: list[dict], pod_metadata: Mapping) -> dict[str, str]:
    """The values a container sees for `env`, as the kubelet resolves
    them for a pod with `pod_metadata` (its name, namespace, labels and
    annotations): plain values as they are, downward-API `fieldRef`s
    read from the metadata.  Later entries win, as in a container."""
    out: dict[str, str] = {}
    for item in env:
        if "value" in item:
            out[item["name"]] = str(item["value"])
            continue
        path = item["valueFrom"]["fieldRef"]["fieldPath"]
        if path in ("metadata.name", "metadata.namespace"):
            out[item["name"]] = str(pod_metadata[path.split(".")[1]])
            continue
        field, _, key = path.partition("['")
        kind = field.split(".")[1]   # labels | annotations
        out[item["name"]] = str(pod_metadata[kind][key[:-2]])
    return out


def upsert_by_name(items: list[dict], item: dict) -> None:
    """Replace the entry with the same `name`, or append.  The idempotent
    mutation primitive every webhook injection (volumes, volumeMounts,
    containers) is built on — mirrors the reference's replace-or-append loops
    (e.g. notebook_mutating_webhook.go:283-307)."""
    for i, existing in enumerate(items):
        if existing.get("name") == item.get("name"):
            items[i] = item
            return
    items.append(item)


def merge_env(existing: list[dict], injected: list[dict]) -> list[dict]:
    """Inject env vars, keeping user-provided values for colliding names
    (same precedence rule as the reference's setPrefixEnvVar, which leaves a
    user NB_PREFIX in place — notebook_controller.go:417-431)."""
    have = {e.get("name") for e in existing}
    return list(existing) + [e for e in injected if e["name"] not in have]


__all__ = ["POD_INDEX_LABEL", "gpu_env_vars",
           "headless_service_name", "merge_env", "resolve_env",
           "statefulset_name", "upsert_by_name", "worker_hostname",
           "worker_hostnames"]
