"""Notebook API types the GPU workload renderer reads.

The port's copy of the part of kubeflow_tpu/api/types.py that
core/workload.py uses, with `spec.gpu` in the place of `spec.tpu`:

    spec:
      gpu:
        accelerator: h100-80gb      # a key of gpu/topology.py ACCELERATORS
        count: 16                   # GPUs in the gang: 2 hosts x 8
      template:
        spec: {containers: [...]}   # PodSpec passthrough, as in the reference

`Notebook` here is a thin read-only view over a Notebook CR in its dict
form (`apiVersion`, `kind`, `metadata`, `spec`, `status`), with the
accessors of the reference's `Notebook` that the renderer uses, and
`Notebook.new`, the twin of the reference's constructor.
`notebook_status` builds the status the notebook controller writes, under
the reference's field names.  The rest of the API (versions, conversion,
priority, validation) is not ported.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Mapping, Optional

from ..gpu.topology import GpuShape, TopologyError, resolve

GROUP = "kubeflow.org"
KIND = "Notebook"
STORAGE_VERSION = "v1"

# terminal verdict of the reference's self-healing engine: a slice that
# spent its restart budget.  The port writes it never, but carries it
# forward through every status rewrite as the reference does.
CONDITION_RECOVERY_EXHAUSTED = "RecoveryExhausted"


class InvalidError(ValueError):
    """A spec the API refuses (the reference's kube.InvalidError)."""


@dataclass(frozen=True)
class GPUSpec:
    accelerator: str
    count: int = 1

    @classmethod
    def from_dict(cls, d: dict) -> "GPUSpec":
        return cls(
            accelerator=str(d.get("accelerator", "")),
            count=int(d.get("count", 1)),
        )

    def to_dict(self) -> dict:
        return {"accelerator": self.accelerator, "count": self.count}

    def validate(self) -> GpuShape:
        try:
            return resolve(self.accelerator, self.count)
        except TopologyError as e:
            raise InvalidError(f"spec.gpu: {e}") from None


@dataclass(frozen=True)
class ReplicationSpec:
    """Optional `spec.replication` block: run `replicas` copies of the
    kernel gang — one primary plus replicas-1 followers continuously
    restored from the primary's checkpoint-delta stream — so a gang
    failure promotes a caught-up follower instead of paying a snapshot
    -> reschedule -> restore cycle.  The reference's `antiAffine` is
    not read: the renderer does not use it."""

    replicas: int = 2

    @classmethod
    def from_dict(cls, d: dict) -> "ReplicationSpec":
        return cls(replicas=int(d.get("replicas", 2)))


class Notebook:
    """Read-only view over a Notebook CR dict (any API version)."""

    def __init__(self, obj: Mapping):
        if obj.get("kind") != KIND:
            raise ValueError(f"not a Notebook: {obj.get('kind')}")
        self.obj = obj

    @classmethod
    def new(
        cls,
        name: str,
        namespace: str,
        pod_spec: Optional[dict] = None,
        gpu: Optional[GPUSpec] = None,
        labels: Optional[dict] = None,
        annotations: Optional[dict] = None,
        replication: Optional[ReplicationSpec] = None,
    ) -> "Notebook":
        """A new CR, the twin of the reference's `Notebook.new` with
        `gpu` in the place of `tpu`."""
        spec: dict = {"template": {"spec": pod_spec
                                   or {"containers": [{"name": name}]}}}
        if gpu is not None:
            spec["gpu"] = gpu.to_dict()
        if replication is not None:
            spec["replication"] = {"replicas": replication.replicas}
        return cls({
            "apiVersion": f"{GROUP}/{STORAGE_VERSION}",
            "kind": KIND,
            "metadata": {"name": name, "namespace": namespace,
                         "labels": dict(labels or {}),
                         "annotations": dict(annotations or {})},
            "spec": spec,
        })

    @property
    def _meta(self) -> Mapping:
        return self.obj.get("metadata") or {}

    @property
    def _spec(self) -> Mapping:
        return self.obj.get("spec") or {}

    @property
    def name(self) -> str:
        return self._meta.get("name", "")

    @property
    def namespace(self) -> str:
        return self._meta.get("namespace", "")

    @property
    def labels(self) -> dict[str, str]:
        return dict(self._meta.get("labels") or {})

    @property
    def annotations(self) -> dict[str, str]:
        return dict(self._meta.get("annotations") or {})

    @property
    def pod_spec(self) -> dict:
        """The PodSpec passthrough; callers copy before they change it."""
        return (self._spec.get("template") or {}).get("spec") or {}

    @property
    def gpu(self) -> Optional[GPUSpec]:
        d = self._spec.get("gpu")
        return GPUSpec.from_dict(d) if d else None

    @property
    def replication(self) -> Optional[ReplicationSpec]:
        d = self._spec.get("replication")
        return ReplicationSpec.from_dict(d) if d else None

    @property
    def status(self) -> dict:
        return self.obj.get("status") or {}


def notebook_status(
    ready_replicas: int,
    conditions: list[dict],
    container_state: dict,
    worker_states: Optional[list[dict]] = None,
    slice_health: Optional[str] = None,
    slice_recovery: Optional[dict] = None,
    session_state: Optional[dict] = None,
    replication: Optional[dict] = None,
) -> dict:
    """NotebookStatus, the reference's shape and field names: conditions,
    readyReplicas and containerState, plus for a GPU gang `workerStates`
    (one entry per worker pod) and `sliceHealth` (the gang's health, under
    the reference's name so the same clients read it).  The self-healing
    and replication records are carried as given."""
    status = {
        "conditions": conditions,
        "readyReplicas": ready_replicas,
        "containerState": copy.deepcopy(container_state),
    }
    if worker_states is not None:
        status["workerStates"] = worker_states
    if slice_health is not None:
        status["sliceHealth"] = slice_health
    if slice_recovery:
        status["sliceRecovery"] = copy.deepcopy(slice_recovery)
    if session_state:
        status["sessionState"] = copy.deepcopy(session_state)
    if replication:
        status["replication"] = copy.deepcopy(replication)
    return status


__all__ = ["CONDITION_RECOVERY_EXHAUSTED", "GPUSpec", "GROUP",
           "InvalidError", "KIND", "Notebook", "ReplicationSpec",
           "STORAGE_VERSION", "notebook_status"]
