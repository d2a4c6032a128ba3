"""Structural (CRD-schema-level) validation for Notebook objects: the
port's copy of kubeflow_tpu/api/validation.py.

A real apiserver enforces this contract from the CRD's OpenAPI schema
(deploy/manifests.py:notebook_crd); the in-memory apiserver enforces it
through a validating admission hook registered at scheme setup, served
over HTTPS with the manager's other hooks on a real cluster.  Semantic
ODH rules stay in the ODH validating webhook, as in the reference.
"""

from __future__ import annotations

from typing import Optional

from ..kube import AdmissionDenied, AdmissionHook, ApiServer, KubeObject
from .types import GROUP, KIND, VERSIONS, Notebook


def _validate(op: str, old: Optional[KubeObject], obj: KubeObject) -> None:
    group, _, version = obj.api_version.partition("/")
    if group != GROUP or version not in VERSIONS:
        raise AdmissionDenied(
            f"Notebook apiVersion {obj.api_version!r} not served; "
            f"expected {GROUP}/{{{ '|'.join(VERSIONS) }}}"
        )
    nb = Notebook(obj.to_dict())
    try:
        nb.validate()
    except Exception as e:
        raise AdmissionDenied(f"invalid Notebook: {e}") from None


def install_notebook_schema(api: ApiServer) -> None:
    """Register the Notebook 'CRD': structural validation on create/update."""
    api.register_admission(
        AdmissionHook(
            kinds=(KIND,),
            handler=_validate,
            operations=("CREATE", "UPDATE"),
            mutating=False,
            name="notebook-crd-schema",
        )
    )


__all__ = ["install_notebook_schema"]
