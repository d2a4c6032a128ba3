"""Gateway API routing plane: HTTPRoutes + ReferenceGrants.

The port's copy of kubeflow_tpu/odh/routing.py, the port of odh
notebook_route.go and notebook_referencegrant.go semantics:
HTTPRoutes live in the *central* (controller) namespace — cross-namespace, so
no owner references; cleanup rides finalizers on the Notebook — and a single
shared ReferenceGrant per user namespace authorizes the central-ns routes to
reference local Services (notebook_route.go:51-132, 144-325;
notebook_referencegrant.go:39-184).
"""

from __future__ import annotations

from typing import Callable, Optional

from ..kube import (
    ApiServer,
    KubeObject,
    NotFoundError,
    ObjectMeta,
    retry_on_conflict,
)
from . import constants as C


def _route_labels(nb: KubeObject) -> dict[str, str]:
    return {
        C.NOTEBOOK_NAME_LABEL: nb.name,
        C.NOTEBOOK_NAMESPACE_LABEL: nb.namespace,
    }


def new_notebook_httproute(
    nb: KubeObject,
    central_namespace: str,
    gateway_name: str,
    gateway_namespace: str,
) -> KubeObject:
    """Desired HTTPRoute `nb-{ns}-{name}` in the central namespace: parentRef
    the platform Gateway, path /notebook/{ns}/{name}, cross-namespace
    backendRef to the notebook Service :8888 (notebook_route.go:51-132)."""
    name = f"nb-{nb.namespace}-{nb.name}"
    if len(name) > C.HTTPROUTE_NAME_MAX_LEN:
        # >63-char names fall back to generateName with truncated components
        # (notebook_route.go:68-79)
        prefix = f"nb-{nb.namespace[:10]}-{nb.name[:10]}-"
        meta = ObjectMeta(
            generate_name=prefix, namespace=central_namespace, labels=_route_labels(nb)
        )
    else:
        meta = ObjectMeta(
            name=name, namespace=central_namespace, labels=_route_labels(nb)
        )
    return KubeObject(
        api_version="gateway.networking.k8s.io/v1",
        kind="HTTPRoute",
        metadata=meta,
        body={
            "spec": {
                "parentRefs": [
                    {"name": gateway_name, "namespace": gateway_namespace}
                ],
                "rules": [
                    {
                        "matches": [
                            {
                                "path": {
                                    "type": "PathPrefix",
                                    "value": f"/notebook/{nb.namespace}/{nb.name}",
                                }
                            }
                        ],
                        "backendRefs": [
                            {
                                "name": nb.name,
                                "namespace": nb.namespace,
                                "port": C.NOTEBOOK_PORT,
                            }
                        ],
                    }
                ],
            }
        },
    )


def new_kube_rbac_proxy_httproute(
    nb: KubeObject,
    central_namespace: str,
    gateway_name: str,
    gateway_namespace: str,
) -> KubeObject:
    """Auth-mode variant: same route shape but the backend is the per-notebook
    kube-rbac-proxy Service :8443 (notebook_kube_rbac_auth.go:162-177)."""
    route = new_notebook_httproute(nb, central_namespace, gateway_name, gateway_namespace)
    backend = route.spec["rules"][0]["backendRefs"][0]
    backend["name"] = nb.name + C.KUBE_RBAC_PROXY_SERVICE_SUFFIX
    backend["port"] = C.KUBE_RBAC_PROXY_PORT
    return route


def list_notebook_httproutes(
    api: ApiServer, nb: KubeObject, central_namespace: str
) -> list[KubeObject]:
    """Central-namespace routes of this notebook, matched by labels — cross-ns
    objects cannot carry owner references (notebook_route.go:157-165)."""
    return api.list(
        "HTTPRoute", namespace=central_namespace, label_selector=_route_labels(nb)
    )


def reconcile_httproute(
    api: ApiServer,
    nb: KubeObject,
    central_namespace: str,
    gateway_name: str,
    gateway_namespace: str,
    new_route: Optional[Callable[..., KubeObject]] = None,
) -> KubeObject:
    """Create-or-update by label match (notebook_route.go:144-219)."""
    new_route = new_route or new_notebook_httproute
    desired = new_route(nb, central_namespace, gateway_name, gateway_namespace)
    existing = list_notebook_httproutes(api, nb, central_namespace)
    if len(existing) > 1:
        raise RuntimeError(
            f"multiple HTTPRoutes found for notebook {nb.namespace}/{nb.name}"
        )
    if not existing:
        return api.create(desired)
    found = existing[0]
    if (
        found.metadata.labels == desired.metadata.labels
        and found.body.get("spec") == desired.body.get("spec")
    ):
        return found

    def update() -> None:
        live = api.get("HTTPRoute", central_namespace, found.name)
        live.metadata.labels = dict(desired.metadata.labels)
        live.body["spec"] = desired.body.get("spec")
        api.update(live)

    retry_on_conflict(update)
    return api.get("HTTPRoute", central_namespace, found.name)


def delete_httproutes_for_notebook(
    api: ApiServer, nb: KubeObject, central_namespace: str
) -> None:
    """Finalizer cleanup: delete every labeled route
    (notebook_route.go:230-266)."""
    for route in list_notebook_httproutes(api, nb, central_namespace):
        try:
            api.delete("HTTPRoute", central_namespace, route.name)
        except NotFoundError:
            pass


def ensure_conflicting_httproute_absent(
    api: ApiServer, nb: KubeObject, central_namespace: str, is_auth_mode: bool
) -> None:
    """When auth mode flips, the other mode's route must go first — both
    claim the same path prefix (notebook_route.go:268-325)."""
    for route in list_notebook_httproutes(api, nb, central_namespace):
        rules = route.spec.get("rules") or []
        if not rules or not rules[0].get("backendRefs"):
            continue
        backend = rules[0]["backendRefs"][0]
        name, port = backend.get("name"), backend.get("port")
        is_proxy_route = (
            name == nb.name + C.KUBE_RBAC_PROXY_SERVICE_SUFFIX
            or port == C.KUBE_RBAC_PROXY_PORT
        )
        is_regular_route = name == nb.name or port == C.NOTEBOOK_PORT
        if (is_auth_mode and is_regular_route and not is_proxy_route) or (
            not is_auth_mode and is_proxy_route
        ):
            try:
                api.delete("HTTPRoute", central_namespace, route.name)
            except NotFoundError:
                pass


# -- ReferenceGrant ------------------------------------------------------------


def new_reference_grant(namespace: str, central_namespace: str) -> KubeObject:
    """One shared grant per user namespace: central-ns HTTPRoutes -> local
    Services (notebook_referencegrant.go:39-69)."""
    return KubeObject(
        api_version="gateway.networking.k8s.io/v1beta1",
        kind="ReferenceGrant",
        metadata=ObjectMeta(
            name=C.REFERENCEGRANT_NAME,
            namespace=namespace,
            labels={"app.kubernetes.io/managed-by": "odh-notebook-controller"},
        ),
        body={
            "spec": {
                "from": [
                    {
                        "group": "gateway.networking.k8s.io",
                        "kind": "HTTPRoute",
                        "namespace": central_namespace,
                    }
                ],
                "to": [{"group": "", "kind": "Service"}],
            }
        },
    )


def reconcile_reference_grant(
    api: ApiServer, nb: KubeObject, central_namespace: str
) -> KubeObject:
    """Create-if-missing, fix-if-drifted (notebook_referencegrant.go:81-126)."""
    desired = new_reference_grant(nb.namespace, central_namespace)
    found = api.try_get("ReferenceGrant", nb.namespace, C.REFERENCEGRANT_NAME)
    if found is None:
        return api.create(desired)
    if (
        found.metadata.labels == desired.metadata.labels
        and found.body.get("spec") == desired.body.get("spec")
    ):
        return found

    def update() -> None:
        live = api.get("ReferenceGrant", nb.namespace, C.REFERENCEGRANT_NAME)
        live.metadata.labels = dict(desired.metadata.labels)
        live.body["spec"] = desired.body.get("spec")
        api.update(live)

    retry_on_conflict(update)
    return api.get("ReferenceGrant", nb.namespace, C.REFERENCEGRANT_NAME)


def is_last_notebook_in_namespace(api: ApiServer, nb: KubeObject) -> bool:
    """True when no *other* live notebook remains in the namespace
    (notebook_referencegrant.go:166-184)."""
    for other in api.list("Notebook", namespace=nb.namespace):
        if other.name == nb.name:
            continue
        if other.metadata.deletion_timestamp is None:
            return False
    return True


def delete_reference_grant_if_last_notebook(api: ApiServer, nb: KubeObject) -> None:
    """The grant is shared; deleted only with the namespace's last notebook
    (notebook_referencegrant.go:130-162)."""
    if not is_last_notebook_in_namespace(api, nb):
        return
    try:
        api.delete("ReferenceGrant", nb.namespace, C.REFERENCEGRANT_NAME)
    except NotFoundError:
        pass
