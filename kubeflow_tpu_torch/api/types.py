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
accessors of the reference's `Notebook` that the renderer uses.  The
rest of the API (versions, conversion, priority, the status helpers) is not
ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

from ..gpu.topology import GpuShape, TopologyError, resolve

KIND = "Notebook"


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


__all__ = ["GPUSpec", "InvalidError", "KIND", "Notebook", "ReplicationSpec"]
