"""Pipeline RBAC: Elyra RoleBindings.

The port's copy of kubeflow_tpu/odh/rbac.py, the port of
notebook_rbac.go: under SET_PIPELINE_RBAC, bind the notebook's SA to
the `ds-pipeline-user-access-dspa` Role via RoleBinding
`elyra-pipelines-{name}`, skipping quietly when the Role doesn't exist
(notebook_rbac.go:36-154).
"""

from __future__ import annotations

from ..kube import ApiServer, KubeObject, ObjectMeta, set_controller_reference
from . import constants as C


def new_role_binding(
    nb: KubeObject, binding_name: str, role_ref_kind: str, role_ref_name: str
) -> KubeObject:
    """NewRoleBinding (notebook_rbac.go:36-58)."""
    return KubeObject(
        api_version="rbac.authorization.k8s.io/v1",
        kind="RoleBinding",
        metadata=ObjectMeta(
            name=binding_name,
            namespace=nb.namespace,
            labels={C.NOTEBOOK_NAME_LABEL: nb.name},
        ),
        body={
            "roleRef": {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": role_ref_kind,
                "name": role_ref_name,
            },
            "subjects": [
                {
                    "kind": "ServiceAccount",
                    "name": nb.name,
                    "namespace": nb.namespace,
                }
            ],
        },
    )


def check_role_exists(
    api: ApiServer, role_ref_kind: str, role_ref_name: str, namespace: str
) -> bool:
    """checkRoleExists (notebook_rbac.go:61-86)."""
    if role_ref_kind == "ClusterRole":
        return api.try_get("ClusterRole", "", role_ref_name) is not None
    return api.try_get("Role", namespace, role_ref_name) is not None


def reconcile_role_bindings(api: ApiServer, nb: KubeObject) -> None:
    """ReconcileRoleBindings (notebook_rbac.go:144-154): the Elyra pipelines
    binding, created only when the target Role exists."""
    if not check_role_exists(api, "Role", C.PIPELINE_ROLE_NAME, nb.namespace):
        return
    desired = new_role_binding(
        nb, C.PIPELINE_ROLEBINDING_PREFIX + nb.name, "Role", C.PIPELINE_ROLE_NAME
    )
    set_controller_reference(nb, desired)
    found = api.try_get("RoleBinding", nb.namespace, desired.name)
    if found is None:
        api.create(desired)
        return
    # RoleRef is immutable; only subjects/labels drift is corrected
    # (notebook_rbac.go:174-185)
    if found.body.get("subjects") != desired.body.get("subjects") or (
        found.metadata.labels != desired.metadata.labels
    ):
        found.body["subjects"] = desired.body.get("subjects")
        found.metadata.labels = dict(desired.metadata.labels)
        api.update(found)
