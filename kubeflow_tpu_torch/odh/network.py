"""The NetworkPolicy between the workers of one GPU notebook.

The counterpart of kubeflow_tpu/odh/network.py:new_tpu_worker_network_policy,
rendered as a manifest dict.  The TPU policy opens two fixed ports (the
JAX coordinator's and MEGASCALE's).  A GPU gang's traffic has no fixed
ports: torchrun's rendezvous store listens on PET_MASTER_PORT, but
NCCL's bootstrap and its socket transport, and gloo's pairs, listen on
ports the OS assigns, and neither library takes a port range from its
env.  A policy with a port list would let the rendezvous through and
hang the world at NCCL's init, so this one opens every TCP port between
the pods that carry the notebook-name label, and nothing to any other
pod: the gang stays isolated from other tenants.
"""

from __future__ import annotations

from ..api.types import Notebook
from ..core import constants as C


def new_gpu_worker_network_policy(nb: Notebook) -> dict:
    """Workers of one notebook may reach each other on any TCP port.
    Selector on both sides is the notebook-name label, so the policy
    covers every replica gang of the notebook."""
    peer = {
        "podSelector": {"matchLabels": {C.NOTEBOOK_NAME_LABEL: nb.name}},
    }
    return {
        "apiVersion": "networking.k8s.io/v1",
        "kind": "NetworkPolicy",
        "metadata": {"name": nb.name + C.GPU_WORKER_NETWORK_POLICY_SUFFIX,
                     "namespace": nb.namespace},
        "spec": {
            "podSelector": {"matchLabels": {C.NOTEBOOK_NAME_LABEL: nb.name}},
            "ingress": [
                {
                    "ports": [{"protocol": "TCP"}],
                    "from": [peer],
                }
            ],
            "policyTypes": ["Ingress"],
        },
    }


__all__ = ["new_gpu_worker_network_policy"]
