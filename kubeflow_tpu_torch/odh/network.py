"""Per-notebook NetworkPolicies.

The port of kubeflow_tpu/odh/network.py (odh notebook_network.go): lock
the Jupyter port down to the controller namespace (the gateway data path
enters through the central-ns HTTPRoute) and open the kube-rbac-proxy
port to everyone, since it authenticates for itself
(notebook_network.go:44-211).  A GPU notebook gets a third policy, the
counterpart of the reference's TPU worker policy, between the workers of
its own gangs.

The TPU policy opens two fixed ports (the JAX coordinator's and
MEGASCALE's).  A GPU gang's traffic has no fixed ports: torchrun's
rendezvous store listens on PET_MASTER_PORT, but NCCL's bootstrap and its
socket transport, and gloo's pairs, listen on ports the OS assigns, and
neither library takes a port range from its env.  A policy with a port
list would let the rendezvous through and hang the world at NCCL's init,
so this one opens every TCP port between the pods that carry the
notebook-name label, and nothing to any other pod: the gang stays
isolated from other tenants.
"""

from __future__ import annotations

from ..common import reconcilehelper as rh
from ..core.constants import GPU_WORKER_NETWORK_POLICY_SUFFIX
from ..kube import ApiServer, KubeObject, ObjectMeta, set_controller_reference
from . import constants as C


def _policy(nb: KubeObject, name: str, spec: dict) -> KubeObject:
    """A NetworkPolicy of the notebook, owned by the CR."""
    policy = KubeObject(
        api_version="networking.k8s.io/v1",
        kind="NetworkPolicy",
        metadata=ObjectMeta(name=name, namespace=nb.namespace),
        body={"spec": spec},
    )
    set_controller_reference(nb, policy)
    return policy


def new_notebook_network_policy(nb: KubeObject,
                                controller_namespace: str) -> KubeObject:
    """Allow :8888 only from the controller namespace
    (notebook_network.go:132-174)."""
    return _policy(
        nb,
        nb.name + "-ctrl-np",
        {
            "podSelector": {"matchLabels": {C.NOTEBOOK_NAME_LABEL: nb.name}},
            "ingress": [
                {
                    "ports": [{"protocol": "TCP", "port": C.NOTEBOOK_PORT}],
                    "from": [
                        {
                            "namespaceSelector": {
                                "matchLabels": {
                                    "kubernetes.io/metadata.name":
                                        controller_namespace
                                }
                            }
                        }
                    ],
                }
            ],
            "policyTypes": ["Ingress"],
        },
    )


def new_kube_rbac_proxy_network_policy(nb: KubeObject) -> KubeObject:
    """Allow :8443 from anywhere — the proxy is the auth boundary
    (notebook_network.go:177-211)."""
    return _policy(
        nb,
        nb.name + C.KUBE_RBAC_PROXY_NETWORK_POLICY_SUFFIX,
        {
            "podSelector": {"matchLabels": {C.NOTEBOOK_NAME_LABEL: nb.name}},
            "ingress": [
                {"ports": [{"protocol": "TCP", "port": C.KUBE_RBAC_PROXY_PORT}]}
            ],
            "policyTypes": ["Ingress"],
        },
    )


def new_gpu_worker_network_policy(nb: KubeObject) -> KubeObject:
    """Workers of one notebook may reach each other on any TCP port.
    Selector on both sides is the notebook-name label, so the policy
    covers every replica gang of the notebook."""
    peer = {
        "podSelector": {"matchLabels": {C.NOTEBOOK_NAME_LABEL: nb.name}},
    }
    return _policy(
        nb,
        nb.name + GPU_WORKER_NETWORK_POLICY_SUFFIX,
        {
            "podSelector": {"matchLabels": {C.NOTEBOOK_NAME_LABEL: nb.name}},
            "ingress": [
                {
                    "ports": [{"protocol": "TCP"}],
                    "from": [peer],
                }
            ],
            "policyTypes": ["Ingress"],
        },
    )


def reconcile_all_network_policies(
    api: ApiServer, nb: KubeObject, controller_namespace: str
) -> None:
    """ReconcileAllNetworkPolicies (notebook_network.go:44-66) and the
    gang's policy when spec.gpu is set."""
    policies = [
        new_notebook_network_policy(nb, controller_namespace),
        new_kube_rbac_proxy_network_policy(nb),
    ]
    if nb.spec.get("gpu"):
        policies.append(new_gpu_worker_network_policy(nb))
    for desired in policies:
        rh.reconcile_object(api, desired, rh.copy_spec)


__all__ = ["new_gpu_worker_network_policy",
           "new_kube_rbac_proxy_network_policy",
           "new_notebook_network_policy", "reconcile_all_network_policies"]
