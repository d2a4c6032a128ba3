"""kube-rbac-proxy auth-mode resources.

The port's copy of kubeflow_tpu/odh/auth.py, the port of odh
notebook_kube_rbac_auth.go: a per-notebook ServiceAccount, a
Service on :8443 carrying the OpenShift serving-cert annotation, a ConfigMap
with the SubjectAccessReview the proxy performs (`get` on this specific
notebook), and a per-notebook ClusterRoleBinding to system:auth-delegator —
cluster-scoped, so cleaned up manually via finalizer
(notebook_kube_rbac_auth.go:48-368).  The sidecar container itself is
injected by the mutating webhook (webhook.py).

The proxy's Service selects the CURRENT primary replica's gang 0, as the
plain notebook Service does (core/workload.py:generate_service).  The
reference selects replica 0's gang whatever the primary, so after a
promotion its authenticated route kept sending traffic to the demoted
gang (`ROADMAP.md` §3); the port does what the reference meant, and its
ODH reconciler sees the promotion (controller.py).
"""

from __future__ import annotations

from ..api.types import GROUP, Notebook
from ..common import reconcilehelper as rh
from ..core.constants import STATEFULSET_LABEL
from ..core.workload import primary_replica
from ..gpu import env as gpuenv
from ..kube import (
    ApiServer,
    KubeObject,
    NotFoundError,
    ObjectMeta,
    set_controller_reference,
)
from . import constants as C


def cluster_role_binding_name(nb: KubeObject) -> str:
    # includes the namespace: CRB names are cluster-scoped
    # (notebook_kube_rbac_auth.go:290)
    return f"{nb.name}-rbac-{nb.namespace}-auth-delegator"


def new_notebook_service_account(nb: KubeObject) -> KubeObject:
    """Dedicated SA the proxy runs as (notebook_kube_rbac_auth.go:48-92)."""
    return KubeObject(
        api_version="v1",
        kind="ServiceAccount",
        metadata=ObjectMeta(name=nb.name, namespace=nb.namespace),
        body={},
    )


def new_kube_rbac_proxy_service(nb: KubeObject) -> KubeObject:
    """Service :8443 -> sidecar port; the serving-cert annotation makes
    OpenShift mint the TLS secret the sidecar mounts
    (notebook_kube_rbac_auth.go:95-159)."""
    return KubeObject(
        api_version="v1",
        kind="Service",
        metadata=ObjectMeta(
            name=nb.name + C.KUBE_RBAC_PROXY_SERVICE_SUFFIX,
            namespace=nb.namespace,
            annotations={
                C.SERVING_CERT_ANNOTATION: nb.name + C.KUBE_RBAC_PROXY_TLS_SECRET_SUFFIX
            },
        ),
        body={
            "spec": {
                "type": "ClusterIP",
                # select only the primary replica's gang 0 pods — the
                # worker where JupyterLab runs — matching the plain
                # notebook Service; the notebook-name label would catch
                # every worker of every replica's gang and round-robin
                # auth traffic across them
                "selector": {
                    STATEFULSET_LABEL: gpuenv.statefulset_name(
                        nb.name, 0, 1, primary_replica(Notebook(nb.to_dict())))
                },
                "ports": [
                    {
                        "name": C.KUBE_RBAC_PROXY_PORT_NAME,
                        "port": C.KUBE_RBAC_PROXY_PORT,
                        "targetPort": C.KUBE_RBAC_PROXY_PORT_NAME,
                        "protocol": "TCP",
                    }
                ],
            }
        },
    )


def new_kube_rbac_proxy_configmap(nb: KubeObject) -> KubeObject:
    """Proxy config: authorize by SubjectAccessReview `get
    notebooks.kubeflow.org/{name}` in the notebook namespace
    (notebook_kube_rbac_auth.go:180-282)."""
    config = (
        "authorization:\n"
        "  resourceAttributes:\n"
        "    apiGroup: " + GROUP + "\n"
        "    apiVersion: v1\n"
        "    resource: notebooks\n"
        "    verb: get\n"
        f"    namespace: {nb.namespace}\n"
        f"    name: {nb.name}\n"
    )
    return KubeObject(
        api_version="v1",
        kind="ConfigMap",
        metadata=ObjectMeta(
            name=nb.name + C.KUBE_RBAC_PROXY_CONFIG_SUFFIX, namespace=nb.namespace
        ),
        body={"data": {C.KUBE_RBAC_PROXY_CONFIG_FILE: config}},
    )


def new_cluster_role_binding(nb: KubeObject) -> KubeObject:
    """Grants the notebook SA the TokenReview/SubjectAccessReview powers the
    proxy needs (system:auth-delegator).  Cluster-scoped: modeled with an
    empty namespace; no owner ref possible
    (notebook_kube_rbac_auth.go:287-311)."""
    return KubeObject(
        api_version="rbac.authorization.k8s.io/v1",
        kind="ClusterRoleBinding",
        metadata=ObjectMeta(
            name=cluster_role_binding_name(nb),
            labels={
                C.NOTEBOOK_NAME_LABEL: nb.name,
                C.NOTEBOOK_NAMESPACE_LABEL: nb.namespace,
            },
        ),
        body={
            "roleRef": {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "ClusterRole",
                "name": "system:auth-delegator",
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


def reconcile_auth_resources(api: ApiServer, nb: KubeObject) -> None:
    """Auth-mode object set, ordered as the reference's auth branch
    (odh notebook_controller.go:443-497): SA -> CRB -> ConfigMap -> Service.
    The HTTPRoute variant is reconciled by the caller via routing.py."""
    sa = new_notebook_service_account(nb)
    set_controller_reference(nb, sa)
    found = api.try_get("ServiceAccount", nb.namespace, sa.name)
    if found is None:
        api.create(sa)

    crb = new_cluster_role_binding(nb)
    if api.try_get("ClusterRoleBinding", "", crb.name) is None:
        api.create(crb)

    cm = new_kube_rbac_proxy_configmap(nb)
    set_controller_reference(nb, cm)
    rh.reconcile_object(api, cm, rh.copy_data)

    svc = new_kube_rbac_proxy_service(nb)
    set_controller_reference(nb, svc)
    rh.reconcile_object(api, svc, rh.copy_service_fields)


def cleanup_cluster_role_binding(api: ApiServer, nb: KubeObject) -> None:
    """Manual CRB deletion — no GC for cluster-scoped dependents of a
    namespaced owner (notebook_kube_rbac_auth.go:346-368)."""
    try:
        api.delete("ClusterRoleBinding", "", cluster_role_binding_name(nb))
    except NotFoundError:
        pass
