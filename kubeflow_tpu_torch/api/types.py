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
`Notebook.new`, the twin of the reference's constructor.  As in the
reference there are three field-identical versions (v1alpha1, v1beta1,
v1): v1 is the storage version and v1beta1 the conversion hub, and
`Notebook.convert_to` and `convert_notebook_dict` (the conversion
webhook's and the wire apiserver's converter) relabel through the hub
with the metadata kept.
`notebook_status` builds the status the notebook controller writes, under
the reference's field names.  The priority classes of the tenancy layer
(`spec.priority`, core/scheduler.py and core/preemption.py) are the
reference's.  `Notebook.validate` holds the structural checks that
api/validation.py's schema hook runs at admission, the reference's with
`spec.gpu` in the place of `spec.tpu`.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Mapping, Optional

from ..gpu.topology import GpuShape, TopologyError, resolve
from ..kube.errors import InvalidError
from ..kube.meta import KubeObject

GROUP = "kubeflow.org"
KIND = "Notebook"
STORAGE_VERSION = "v1"
HUB_VERSION = "v1beta1"
VERSIONS = ("v1alpha1", "v1beta1", "v1")

# Priority classes (spec.priority): the tenancy layer's admission and
# preemption ordering (core/scheduler.py, core/preemption.py), the
# reference's ranks.  A notebook without spec.priority inherits its
# tenant's default from the TenantQuota object (or PRIORITY_DEFAULT when
# no quota is configured).
PRIORITY_RANK = {"low": 0, "standard": 100, "high": 200}
PRIORITY_CLASSES = tuple(sorted(PRIORITY_RANK, key=PRIORITY_RANK.get))
PRIORITY_DEFAULT = "standard"

# terminal verdict of the self-healing engine (core/selfheal.py): a gang
# that spent its restart budget.  The status writer carries it forward
# through every status rewrite, as the reference's does.
CONDITION_RECOVERY_EXHAUSTED = "RecoveryExhausted"


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
    restored from the primary's checkpoint-delta stream
    (core/sessionstate.py) — so a gang failure promotes a caught-up
    follower (core/selfheal.py) instead of paying a snapshot ->
    reschedule -> restore cycle.  `anti_affine` keeps replica gangs on
    disjoint node pools so one pool failure cannot take both copies
    (core/scheduler.py enforces it at placement time)."""

    replicas: int = 2
    anti_affine: bool = True

    @classmethod
    def from_dict(cls, d: dict) -> "ReplicationSpec":
        return cls(
            replicas=int(d.get("replicas", 2)),
            anti_affine=bool(d.get("antiAffine", True)),
        )

    def to_dict(self) -> dict:
        return {"replicas": self.replicas, "antiAffine": self.anti_affine}

    def validate(self) -> None:
        if self.replicas < 2:
            raise InvalidError("spec.replication.replicas must be >= 2")
        if self.replicas > 8:
            raise InvalidError("spec.replication.replicas must be <= 8")


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
        priority: Optional[str] = None,
    ) -> "Notebook":
        """A new CR, the twin of the reference's `Notebook.new` with
        `gpu` in the place of `tpu`; `priority` sets `spec.priority`."""
        spec: dict = {"template": {"spec": pod_spec
                                   or {"containers": [{"name": name}]}}}
        if gpu is not None:
            spec["gpu"] = gpu.to_dict()
        if replication is not None:
            spec["replication"] = replication.to_dict()
        if priority is not None:
            spec["priority"] = priority
        return cls({
            "apiVersion": f"{GROUP}/{STORAGE_VERSION}",
            "kind": KIND,
            "metadata": {"name": name, "namespace": namespace,
                         "labels": dict(labels or {}),
                         "annotations": dict(annotations or {})},
            "spec": spec,
        })

    @property
    def version(self) -> str:
        return self.obj.get("apiVersion", "").split("/", 1)[1]

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

    @property
    def priority(self) -> Optional[str]:
        """Explicit priority class, or None to defer to the tenant default."""
        p = self._spec.get("priority")
        return str(p) if p is not None else None

    def validate(self) -> None:
        """Non-empty containers, a known priority class, a valid
        `spec.gpu`, and a replication block only on a GPU gang, within
        its bounds: the reference's checks, with its messages."""
        if not self.pod_spec.get("containers"):
            raise InvalidError(
                "spec.template.spec.containers must be non-empty")
        if self.priority is not None and self.priority not in PRIORITY_RANK:
            raise InvalidError(
                f"spec.priority must be one of {sorted(PRIORITY_RANK)}, "
                f"got {self.priority!r}")
        if self.gpu is not None:
            self.gpu.validate()
        if self.replication is not None:
            # a spec.tpu block carries replication in the reference; the
            # port refuses that block in its own hook, with its own message
            if self.gpu is None and not self._spec.get("tpu"):
                raise InvalidError(
                    "spec.replication requires spec.gpu (replicated CPU "
                    "notebooks are not supported)")
            self.replication.validate()

    def convert_to(self, version: str) -> "Notebook":
        """Spoke -> hub -> spoke conversion, as the reference routes it:
        the versions are field-identical, so it is a relabel through the
        hub, on a copy."""
        if version not in VERSIONS:
            raise InvalidError(f"unknown Notebook version {version!r}")
        return self._relabel(HUB_VERSION)._relabel(version)

    def _relabel(self, version: str) -> "Notebook":
        out = copy.deepcopy(dict(self.obj))
        out["apiVersion"] = f"{GROUP}/{version}"
        return Notebook(out)


def convert_notebook_dict(obj: dict, desired_api_version: str) -> dict:
    """Dict-level conversion for the webhook server's /convert endpoint and
    the wire apiserver's converter hook.  Metadata is kept: uid and
    resourceVersion must survive conversion or optimistic concurrency
    breaks on version-crossing clients."""
    group, _, version = desired_api_version.partition("/")
    if group != GROUP or not version:
        raise InvalidError(
            f"cannot convert {obj.get('apiVersion')!r} to "
            f"{desired_api_version!r}: not a {GROUP} version")
    out = Notebook(obj).convert_to(version).obj
    return KubeObject.from_dict(out).to_dict()


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


__all__ = ["CONDITION_RECOVERY_EXHAUSTED", "GPUSpec", "GROUP", "HUB_VERSION",
           "InvalidError", "KIND", "Notebook", "PRIORITY_CLASSES",
           "PRIORITY_DEFAULT", "PRIORITY_RANK", "ReplicationSpec",
           "STORAGE_VERSION", "VERSIONS", "convert_notebook_dict",
           "notebook_status"]
