"""Gateway hostname discovery shared by the DSPA/Elyra and MLflow integrations.

The port's copy of kubeflow_tpu/odh/gateway.py, the port of
getGatewayInstance / getHostnameForPublicEndpoint /
getHostnameFromRoute (notebook_dspa_secret.go:49-186): prefer the configured
Gateway's first listener hostname; fall back to an OpenShift Route labeled for
the gateway.
"""

from __future__ import annotations

from typing import Optional

from ..kube import ApiServer, KubeObject
from ..utils.config import OdhConfig


def get_gateway_instance(api: ApiServer, cfg: OdhConfig) -> Optional[KubeObject]:
    return api.try_get("Gateway", cfg.gateway_namespace, cfg.gateway_name)


def get_hostname_from_route(
    api: ApiServer, cfg: OdhConfig, gateway: KubeObject
) -> str:
    """Route fallback: only a Route owned by (or labeled for) the gateway
    counts — an arbitrary Route in openshift-ingress must not leak into
    public endpoints (notebook_dspa_secret.go:152-186)."""
    for route in api.list("Route", namespace=cfg.gateway_namespace):
        owned = any(
            ref.uid == gateway.metadata.uid
            for ref in route.metadata.owner_references
        )
        labeled = (
            route.metadata.labels.get("gateway.networking.k8s.io/gateway-name")
            == gateway.name
        )
        if not (owned or labeled):
            continue
        host = route.spec.get("host", "")
        if host:
            return host
    return ""


def get_hostname_for_public_endpoint(api: ApiServer, cfg: OdhConfig) -> str:
    """First Gateway listener hostname, else a gateway-owned Route host,
    else "" — and "" when the Gateway itself is absent
    (notebook_dspa_secret.go:106-148)."""
    gw = get_gateway_instance(api, cfg)
    if gw is None:
        return ""
    listeners = gw.spec.get("listeners") or []
    if listeners:
        hostname = listeners[0].get("hostname") or ""
        if hostname:
            return str(hostname)
    return get_hostname_from_route(api, cfg, gw)
