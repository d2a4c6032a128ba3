"""Workload rendering: Notebook CR -> StatefulSet(s) + Service(s), for GPUs.

The port of kubeflow_tpu/core/workload.py.  Objects are rendered as
plain manifest dicts (`apiVersion`, `kind`, `metadata`, `spec`).

CPU path (no spec.gpu): the reference's, copied: one StatefulSet with
replicas 0/1 from the stop annotation, label/annotation propagation with
kubectl/notebook filtering, default workdir/port/NB_PREFIX, optional
fsGroup, a ClusterIP Service 80 -> 8888, and under USE_ISTIO the Istio
VirtualService routing /notebook/{ns}/{name}/ to it.

GPU path (spec.gpu): per replica gang an *indexed* StatefulSet with
replicas = hosts (0 when stopped — gang-atomic, never partial), parallel
pod management, `nvidia.com/gpu` requests and limits of the GPUs per
host, the GKE GPU accelerator nodeSelector, and torchrun's rendezvous env
(gpu/env.py); plus one shared headless Service giving every worker a
stable DNS identity and the rendezvous port.  It matches the reference's
TPU branch in everything that does not depend on the device.  A gang has
no slices: one gang per replica, so the gang index is the replica index
and the pods carry no tpu-slice label.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass

from ..api.types import Notebook
from ..gpu import env as gpuenv
from ..utils.config import CoreConfig
from . import constants as C

PRE_STOP_COMMAND = ["python", "-m", "kubeflow_tpu_torch.runtime.checkpoint",
                    "--pre-stop"]


@dataclass
class WorkloadConfig:
    """The controller settings the renderer reads, under the names of the
    reference's CoreConfig fields (utils/config.py), and the pod's
    termination grace period, which the reference does not render."""

    add_fsgroup: bool = True
    checkpoint_store_uri: str = ""            # CHECKPOINT_STORE_URI
    checkpoint_interval_s: float = 300.0      # CHECKPOINT_INTERVAL_S
    termination_grace_period_s: int = C.DEFAULT_TERMINATION_GRACE_PERIOD_S


def pre_stop_command(grace_period_s: int) -> list[str]:
    """The pre-stop hook's command for a pod whose termination grace
    period is `grace_period_s`: the hook waits for the ack until
    PRE_STOP_MARGIN_S before the period ends, which leaves the SIGTERM
    that follows it those seconds.  The period bounds the last save, so
    a larger train state needs a longer period."""
    timeout_s = grace_period_s - C.PRE_STOP_MARGIN_S
    if timeout_s <= 0:
        raise ValueError(f"a termination grace period of {grace_period_s} s "
                         f"leaves the pre-stop hook no time: it needs more "
                         f"than {C.PRE_STOP_MARGIN_S} s")
    return PRE_STOP_COMMAND + ["--timeout", str(timeout_s)]


def placement_of(annotations: dict) -> dict:
    """The placement intent's gang map ({"<id>": {"pool": ..,
    "nodes": [..]}}) from CR annotations; {} when absent/malformed (the
    reference's core/scheduler.py parse)."""
    raw = annotations.get(C.ANNOTATION_PLACEMENT)
    if not raw:
        return {}
    try:
        doc = json.loads(raw)
    except ValueError:
        return {}
    slices = doc.get("slices") if isinstance(doc, dict) else None
    return slices if isinstance(slices, dict) else {}


def _propagated_annotations(nb: Notebook) -> dict[str, str]:
    """Copy CR annotations to the pod, excluding kubectl/notebook ones
    (reference filter, notebook_controller.go:484-489)."""
    return {
        k: v
        for k, v in nb.annotations.items()
        if "kubectl" not in k and "notebook" not in k
    }


def _base_pod_template(nb: Notebook, cfg: WorkloadConfig,
                       sts_name: str) -> dict:
    pod_spec = copy.deepcopy(nb.pod_spec)
    containers = pod_spec.get("containers") or [{"name": nb.name}]
    main = containers[0]
    if not main.get("workingDir"):
        main["workingDir"] = "/home/jovyan"
    if not main.get("ports"):
        main["ports"] = [
            {
                "containerPort": C.DEFAULT_CONTAINER_PORT,
                "name": "notebook-port",
                "protocol": "TCP",
            }
        ]
    prefix = f"/notebook/{nb.namespace}/{nb.name}"
    main["env"] = gpuenv.merge_env(
        main.get("env") or [], [{"name": C.PREFIX_ENV_VAR, "value": prefix}]
    )
    if cfg.add_fsgroup and pod_spec.get("securityContext") is None:
        pod_spec["securityContext"] = {"fsGroup": C.DEFAULT_FSGROUP}
    pod_spec["containers"] = containers

    labels = {
        C.STATEFULSET_LABEL: sts_name,
        C.NOTEBOOK_NAME_LABEL: nb.name,
        C.WORKBENCH_LABEL: "true",
    }
    labels.update(nb.labels)
    return {
        "metadata": {
            "labels": labels,
            "annotations": _propagated_annotations(nb),
        },
        "spec": pod_spec,
    }


def _render_checkpoint_contract(
    nb: Notebook, cfg: WorkloadConfig, template: dict, gang: int
) -> None:
    """Checkpoint-sidecar contract on a GPU worker template (rendered only
    when CHECKPOINT_STORE_URI is configured):

    - env the in-pod runtime reads (runtime/checkpoint.py): the store URI
      and the periodic snapshot interval;
    - restore stamping: when `status.sessionState` carries a restore
      intent for this gang, the recreated pods get
      CHECKPOINT_RESTORE_URI/_GENERATION;
    - a pre-stop exec hook that requests one last checkpoint and waits
      for the training loop's acknowledgement (`python -m
      kubeflow_tpu_torch.runtime.checkpoint --pre-stop --timeout N`),
      N from the pod's termination grace period (the template's own, else
      the controller's, rendered), the downward-API podinfo projection of
      the checkpoint-requested annotation, and — because that projection
      is read-only — a writable emptyDir named by CHECKPOINT_SIGNAL_DIR,
      where the hook's request and the ack meet."""
    pod_spec = template["spec"]
    main = pod_spec["containers"][0]
    grace_s = pod_spec.setdefault("terminationGracePeriodSeconds",
                                  cfg.termination_grace_period_s)
    injected = [
        {"name": C.ENV_CHECKPOINT_STORE_URI,
         "value": cfg.checkpoint_store_uri},
        {"name": C.ENV_CHECKPOINT_INTERVAL_S,
         "value": f"{cfg.checkpoint_interval_s:g}"},
    ]
    session = (nb.status.get("sessionState") or {}).get(str(gang)) or {}
    if session.get("restoreGeneration") is not None:
        injected += [
            {"name": C.ENV_CHECKPOINT_RESTORE_URI,
             "value": session.get("restoreUri")
             or cfg.checkpoint_store_uri},
            {"name": C.ENV_CHECKPOINT_RESTORE_GENERATION,
             "value": str(session["restoreGeneration"])},
        ]
    injected.append({"name": C.ENV_CHECKPOINT_SIGNAL_DIR,
                     "value": C.CHECKPOINT_SIGNAL_MOUNT})
    main["env"] = gpuenv.merge_env(main["env"], injected)
    lifecycle = main.setdefault("lifecycle", {})
    if "preStop" not in lifecycle:
        lifecycle["preStop"] = {"exec": {"command": pre_stop_command(grace_s)}}
    volumes = pod_spec.setdefault("volumes", [])
    gpuenv.upsert_by_name(volumes, {
        "name": "podinfo",
        "downwardAPI": {"items": [{
            "path": "checkpoint-requested",
            "fieldRef": {"fieldPath": "metadata.annotations['%s']"
                         % C.ANNOTATION_CHECKPOINT_REQUESTED},
        }]},
    })
    gpuenv.upsert_by_name(volumes, {
        "name": C.CHECKPOINT_SIGNAL_VOLUME, "emptyDir": {},
    })
    mounts = main.setdefault("volumeMounts", [])
    gpuenv.upsert_by_name(mounts, {
        "name": "podinfo", "mountPath": C.PODINFO_MOUNT,
    })
    gpuenv.upsert_by_name(mounts, {
        "name": C.CHECKPOINT_SIGNAL_VOLUME,
        "mountPath": C.CHECKPOINT_SIGNAL_MOUNT,
    })


def _sts_meta(nb: Notebook, name: str, use_generate_name: bool) -> dict:
    if use_generate_name:
        # name-length guard (notebook_controller.go:142-149): controller
        # appends an 11-char hash label, total must fit 63
        meta = {"generateName": "nb-", "namespace": nb.namespace}
    else:
        meta = {"name": name, "namespace": nb.namespace}
    meta["labels"] = nb.labels
    return meta


def _statefulset(meta: dict, spec: dict) -> dict:
    return {"apiVersion": "apps/v1", "kind": "StatefulSet",
            "metadata": meta, "spec": spec}


def generate_statefulsets(nb: Notebook, cfg: WorkloadConfig) -> list[dict]:
    """Render the workload STS set: one for CPU notebooks, one per replica
    gang for GPU notebooks."""
    stopped = C.STOP_ANNOTATION in nb.annotations
    gpu = nb.gpu

    if gpu is None:
        name = nb.name
        use_generate_name = len(name) > C.MAX_STATEFULSET_NAME_LENGTH
        return [_statefulset(_sts_meta(nb, name, use_generate_name), {
            "replicas": 0 if stopped else 1,
            "serviceName": nb.name,
            "selector": {"matchLabels": {C.STATEFULSET_LABEL: name}},
            "template": _base_pod_template(nb, cfg, name),
        })]

    shape = gpu.validate()
    # scheduler placement intent: gang index -> node-pool assignment,
    # rendered as a nodeSelector so the whole gang co-locates on the pool
    placement = placement_of(nb.annotations)
    rep = nb.replication
    replicas = rep.replicas if rep is not None else 1
    live_rep = nb.status.get("replication") or {}
    primary = int(live_rep.get("primary", 0))
    epoch = int(live_rep.get("epoch", 1))
    out = []
    # one gang per replica: gang index = replica index, the key of the
    # placement and sessionState maps
    for replica in range(replicas):
        gang = replica
        name = gpuenv.statefulset_name(nb.name, 0, 1, replica)
        # the replica suffix counts against the 52-char guard too
        use_generate_name = len(name) > C.MAX_STATEFULSET_NAME_LENGTH
        template = _base_pod_template(nb, cfg, name)
        if rep is not None:
            template["metadata"]["labels"][C.REPLICA_LABEL] = str(replica)
        pod_spec = template["spec"]
        selector = pod_spec.setdefault("nodeSelector", {})
        selector[C.GKE_GPU_ACCELERATOR_LABEL] = shape.accelerator.gke_label
        assigned_pool = (placement.get(str(gang)) or {}).get("pool")
        if assigned_pool:
            selector[C.GKE_NODEPOOL_LABEL] = assigned_pool
        main = pod_spec["containers"][0]
        resources = main.setdefault("resources", {})
        for kind in ("requests", "limits"):
            resources.setdefault(kind, {})[C.GPU_RESOURCE] = \
                str(shape.gpus_per_host)
        main["env"] = gpuenv.merge_env(
            main["env"], gpuenv.gpu_env_vars(nb.name, shape, replica))
        if rep is not None:
            # boot-time hints only: the authoritative role is the
            # status.replication pointer + the store's write fence
            main["env"] = gpuenv.merge_env(main["env"], [
                {"name": C.ENV_REPLICA_INDEX, "value": str(replica)},
                {"name": C.ENV_REPLICATION_ROLE,
                 "value": C.ROLE_PRIMARY if replica == primary
                 else C.ROLE_FOLLOWER},
                {"name": C.ENV_REPLICATION_EPOCH, "value": str(epoch)},
            ])
        if cfg.checkpoint_store_uri:
            _render_checkpoint_contract(nb, cfg, template, gang)
        meta = _sts_meta(nb, name, use_generate_name)
        meta["labels"][C.NOTEBOOK_NAME_LABEL] = nb.name
        if rep is not None:
            meta["labels"][C.REPLICA_LABEL] = str(replica)
        out.append(_statefulset(meta, {
            # gang-atomic: all hosts or none — a partial gang can never
            # run a collective, so 0 is the only other state
            "replicas": 0 if stopped else shape.num_hosts,
            "serviceName": gpuenv.headless_service_name(nb.name),
            "podManagementPolicy": "Parallel",
            "selector": {"matchLabels": {C.STATEFULSET_LABEL: name}},
            "template": template,
        }))
    return out


def primary_replica(nb: Notebook) -> int:
    """The replica whose gang serves the notebook: status.replication's
    primary for a replicated notebook (it moves on a promotion), else 0."""
    if nb.replication is None:
        return 0
    return int((nb.status.get("replication") or {}).get("primary", 0))


def generate_service(nb: Notebook) -> dict:
    """ClusterIP Service 80 -> notebook port, name http-notebook (Istio-
    compatible port naming), selecting the (first) statefulset's pods
    (notebook_controller.go:525-552).  For GPU notebooks this fronts
    worker 0, where the JupyterLab server runs; replicated notebooks
    front the CURRENT primary's worker 0."""
    containers = nb.pod_spec.get("containers") or []
    port = C.DEFAULT_CONTAINER_PORT
    if containers and containers[0].get("ports"):
        port = int(containers[0]["ports"][0].get("containerPort", port))
    sts0 = gpuenv.statefulset_name(nb.name, 0, 1, primary_replica(nb))
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": nb.name, "namespace": nb.namespace},
        "spec": {
            "type": "ClusterIP",
            "selector": {C.STATEFULSET_LABEL: sts0},
            "ports": [
                {
                    "name": "http-notebook",
                    "port": C.DEFAULT_SERVING_PORT,
                    "targetPort": port,
                    "protocol": "TCP",
                }
            ],
        },
    }


def generate_headless_service(nb: Notebook) -> dict:
    """Headless Service over ALL workers of ALL replica gangs: gives each
    pod the stable {pod}.{svc}.{ns} DNS name that GPU_WORKER_HOSTNAMES and
    PET_MASTER_ADDR rely on, and names torchrun's rendezvous port."""
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": gpuenv.headless_service_name(nb.name),
                     "namespace": nb.namespace},
        "spec": {
            "clusterIP": "None",
            "selector": {C.NOTEBOOK_NAME_LABEL: nb.name},
            # workers must resolve worker 0 before any pod can become
            # Ready — without this, gang startup deadlocks on DNS
            "publishNotReadyAddresses": True,
            "ports": [
                {
                    "name": "torch-rendezvous",
                    "port": C.TORCH_RENDEZVOUS_PORT,
                    "targetPort": C.TORCH_RENDEZVOUS_PORT,
                    "protocol": "TCP",
                }
            ],
        },
    }


def generate_virtual_service(nb: Notebook, cfg: CoreConfig) -> dict:
    """Istio VirtualService under USE_ISTIO
    (notebook_controller.go:558-699): route
    /notebook/{ns}/{name}/ through the configured gateway to the Service,
    honoring the rewrite/headers annotations."""
    prefix = f"/notebook/{nb.namespace}/{nb.name}/"
    rewrite = nb.annotations.get(C.ANNOTATION_REWRITE_URI, "")
    rewrite_uri = rewrite if rewrite.strip() else prefix
    http_route: dict = {
        "match": [{"uri": {"prefix": prefix}}],
        "rewrite": {"uri": rewrite_uri},
        "route": [
            {
                "destination": {
                    "host": f"{nb.name}.{nb.namespace}.svc."
                            f"{cfg.cluster_domain}",
                    "port": {"number": C.DEFAULT_SERVING_PORT},
                }
            }
        ],
        "timeout": "300s",
    }
    headers = nb.annotations.get(C.ANNOTATION_HEADERS_REQUEST_SET, "")
    if headers.strip():
        try:
            http_route["headers"] = {"request": {"set": json.loads(headers)}}
        except ValueError:
            pass  # malformed annotation ignored, as in the reference
    return {
        "apiVersion": "networking.istio.io/v1alpha3",
        "kind": "VirtualService",
        "metadata": {"name": f"notebook-{nb.namespace}-{nb.name}",
                     "namespace": nb.namespace},
        "spec": {
            "hosts": [cfg.istio_host],
            "gateways": [cfg.istio_gateway],
            "http": [http_route],
        },
    }


__all__ = ["PRE_STOP_COMMAND", "WorkloadConfig", "generate_headless_service",
           "generate_service", "generate_statefulsets",
           "generate_virtual_service", "placement_of", "pre_stop_command",
           "primary_replica"]
