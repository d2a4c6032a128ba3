"""Object metadata and generic object model for the in-memory control plane.

The port's copy of kubeflow_tpu/kube/meta.py.

The reference builds on k8s apimachinery (metav1.ObjectMeta and friends).  We
model the subset the notebook stack actually uses: names/namespaces, labels,
annotations, ownerReferences, finalizers, resourceVersion-based optimistic
concurrency, and deletionTimestamp-driven finalization.  Objects are typed
wrappers over plain dicts ("unstructured" style) because the Notebook CRD's
pod template is a raw PodSpec passthrough in the reference
(components/notebook-controller/api/v1/notebook_types.go:26-40) and dicts keep
that passthrough lossless.
"""

from __future__ import annotations

import copy
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional


def now_iso() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _empty_view() -> dict:
    """Empty spec/status view of a frozen object: plain dict normally, a
    mutation-trapping FrozenDict under INVARIANTS_STRICT."""
    from ..utils import invariants

    if invariants.strict_enabled():
        return invariants.EMPTY_FROZEN_DICT
    return {}


def copy_tree(x):
    """Deep copy of a JSON-shaped tree (dicts/lists/scalars).

    API object bodies are unstructured JSON by construction (the CRD pod
    template is a raw passthrough), so the generic copy.deepcopy machinery
    — memo dict, reconstruct dispatch, keep-alive bookkeeping — is pure
    overhead on the store's hottest operation.  This specialized walk is
    ~10x faster and is what every KubeObject copy path uses.  Non-JSON
    leaves (never produced by the store itself) are shared, not copied."""
    if isinstance(x, dict):
        return {k: copy_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [copy_tree(v) for v in x]
    return x


@dataclass
class OwnerReference:
    api_version: str
    kind: str
    name: str
    uid: str
    controller: bool = False
    block_owner_deletion: bool = False

    def to_dict(self) -> dict:
        return {
            "apiVersion": self.api_version,
            "kind": self.kind,
            "name": self.name,
            "uid": self.uid,
            "controller": self.controller,
            "blockOwnerDeletion": self.block_owner_deletion,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "OwnerReference":
        return cls(
            api_version=d.get("apiVersion", ""),
            kind=d.get("kind", ""),
            name=d.get("name", ""),
            uid=d.get("uid", ""),
            controller=bool(d.get("controller", False)),
            block_owner_deletion=bool(d.get("blockOwnerDeletion", False)),
        )


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    generate_name: str = ""
    uid: str = ""
    resource_version: int = 0
    generation: int = 0
    creation_timestamp: str = ""
    deletion_timestamp: Optional[str] = None
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    owner_references: list[OwnerReference] = field(default_factory=list)
    finalizers: list[str] = field(default_factory=list)
    # server-side-apply bookkeeping: raw managedFields entries
    # ({manager, operation, apiVersion, fieldsType, fieldsV1}) — kept
    # unstructured like the body (kube/apply.py owns the semantics)
    managed_fields: list[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        d: dict[str, Any] = {
            "name": self.name,
            "namespace": self.namespace,
            "uid": self.uid,
            "resourceVersion": str(self.resource_version),
            "generation": self.generation,
            "creationTimestamp": self.creation_timestamp,
            "labels": dict(self.labels),
            "annotations": dict(self.annotations),
        }
        if self.generate_name:
            d["generateName"] = self.generate_name
        if self.deletion_timestamp:
            d["deletionTimestamp"] = self.deletion_timestamp
        if self.owner_references:
            d["ownerReferences"] = [o.to_dict() for o in self.owner_references]
        if self.finalizers:
            d["finalizers"] = list(self.finalizers)
        if self.managed_fields:
            d["managedFields"] = copy_tree(self.managed_fields)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ObjectMeta":
        return cls(
            name=d.get("name", ""),
            namespace=d.get("namespace", ""),
            generate_name=d.get("generateName", ""),
            uid=d.get("uid", ""),
            resource_version=int(d.get("resourceVersion", 0) or 0),
            generation=int(d.get("generation", 0) or 0),
            creation_timestamp=d.get("creationTimestamp", ""),
            deletion_timestamp=d.get("deletionTimestamp"),
            labels=dict(d.get("labels") or {}),
            annotations=dict(d.get("annotations") or {}),
            owner_references=[
                OwnerReference.from_dict(o) for o in d.get("ownerReferences") or []
            ],
            finalizers=list(d.get("finalizers") or []),
            managed_fields=copy_tree(d.get("managedFields") or []),
        )

    def controller_owner(self) -> Optional[OwnerReference]:
        for ref in self.owner_references:
            if ref.controller:
                return ref
        return None

    def copy(self) -> "ObjectMeta":
        return ObjectMeta(
            name=self.name,
            namespace=self.namespace,
            generate_name=self.generate_name,
            uid=self.uid,
            resource_version=self.resource_version,
            generation=self.generation,
            creation_timestamp=self.creation_timestamp,
            deletion_timestamp=self.deletion_timestamp,
            labels=dict(self.labels),
            annotations=dict(self.annotations),
            owner_references=[copy.copy(r) for r in self.owner_references],
            finalizers=list(self.finalizers),
            managed_fields=copy_tree(self.managed_fields),
        )


@dataclass
class KubeObject:
    """Generic API object: typed metadata + unstructured body.

    `body` holds everything outside metadata (spec/status/data/subsets/...).

    `frozen` marks a committed store snapshot (set by the ApiServer at
    commit): frozen objects are SHARED — the store map, the watch history,
    every watcher and cache read the same instance — and must never be
    mutated.  `deepcopy()` always returns a mutable private copy.
    """

    api_version: str
    kind: str
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    body: dict[str, Any] = field(default_factory=dict)
    frozen: bool = field(default=False, compare=False, repr=False)

    # -- convenience accessors ------------------------------------------------
    @property
    def spec(self) -> dict:
        # a frozen (shared) object must not grow a skeleton key from a
        # mere read — return an empty view instead of mutating the body
        # (under INVARIANTS_STRICT a trapping view, so a write to the
        # empty view raises instead of silently vanishing)
        s = self.body.get("spec")
        if s is None:
            if self.frozen:
                return _empty_view()
            s = self.body.setdefault("spec", {})
        return s

    @spec.setter
    def spec(self, value: dict) -> None:
        self.body["spec"] = value

    @property
    def status(self) -> dict:
        s = self.body.get("status")
        if s is None:
            if self.frozen:
                return _empty_view()
            s = self.body.setdefault("status", {})
        return s

    @status.setter
    def status(self, value: dict) -> None:
        self.body["status"] = value

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def labels(self) -> dict[str, str]:
        return self.metadata.labels

    @property
    def annotations(self) -> dict[str, str]:
        return self.metadata.annotations

    def gvk(self) -> tuple[str, str]:
        return (self.api_version, self.kind)

    def key(self) -> tuple[str, str, str]:
        return (self.kind, self.metadata.namespace, self.metadata.name)

    def deepcopy(self) -> "KubeObject":
        return KubeObject(
            api_version=self.api_version,
            kind=self.kind,
            metadata=self.metadata.copy(),
            body=copy_tree(self.body),
        )

    def same_as(self, other: "KubeObject") -> bool:
        """Semantic equality — what `to_dict() == to_dict()` used to
        decide on the write path, without materializing two dict copies.
        Dataclass equality on metadata plus structural dict equality on
        the body (the `frozen` marker never participates)."""
        return (
            self.api_version == other.api_version
            and self.kind == other.kind
            and self.metadata == other.metadata
            and self.body == other.body
        )

    def to_dict(self) -> dict:
        d = {
            "apiVersion": self.api_version,
            "kind": self.kind,
            "metadata": self.metadata.to_dict(),
        }
        d.update(copy_tree(self.body))
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "KubeObject":
        body = {k: v for k, v in d.items() if k not in ("apiVersion", "kind", "metadata")}
        return cls(
            api_version=d.get("apiVersion", ""),
            kind=d.get("kind", ""),
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            body=copy_tree(body),
        )

    def owner_reference(self, controller: bool = True) -> OwnerReference:
        return OwnerReference(
            api_version=self.api_version,
            kind=self.kind,
            name=self.metadata.name,
            uid=self.metadata.uid,
            controller=controller,
            block_owner_deletion=controller,
        )


def new_uid() -> str:
    return str(uuid.uuid4())


def set_controller_reference(owner: KubeObject, controlled: KubeObject) -> None:
    """Equivalent of controllerutil.SetControllerReference: exactly one
    controller ref, same namespace enforced (cross-namespace ownership is
    illegal in k8s — the reference works around it with finalizers for
    HTTPRoutes, odh notebook_controller.go:206-333)."""
    if owner.metadata.namespace != controlled.metadata.namespace:
        raise ValueError(
            "cross-namespace owner references are not allowed "
            f"({owner.metadata.namespace} -> {controlled.metadata.namespace})"
        )
    existing = controlled.metadata.controller_owner()
    if existing is not None and existing.uid != owner.metadata.uid:
        raise ValueError(f"object already controlled by {existing.name}")
    ref = owner.owner_reference(controller=True)
    controlled.metadata.owner_references = [
        r for r in controlled.metadata.owner_references if not r.controller
    ]
    controlled.metadata.owner_references.append(ref)
