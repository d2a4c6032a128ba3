"""Deployment-manifest rendering: the kustomize plane as code, the port's
copy of kubeflow_tpu/deploy/manifests.py.

The upstream controllers ship a tree of kustomize YAML (CRD bases and
conversion patches, RBAC, the manager Deployment, webhook service and
cert plumbing, params ConfigMaps, overlays kubeflow/openshift/standalone).
The same objects are rendered here from one module, parameterized by
profile, and `python -m kubeflow_tpu_torch.deploy` emits them as
multi-document YAML.  The Notebook CRD carries the `spec.gpu` block (its
accelerator enum from gpu/topology.py), `spec.priority` and
`spec.replication` as api/types.py defines them; the warm-pool CRD is the
GPUWarmPool; the manager runs `python -m kubeflow_tpu_torch.main`, with
GPU_DEFAULT_IMAGE in its params.
"""

from __future__ import annotations

from typing import Iterable

import yaml

from ..api.types import GROUP, PRIORITY_CLASSES, VERSIONS
from ..core import constants as C
from ..gpu.topology import ACCELERATORS

PROFILES = ("kubeflow", "openshift", "standalone")


DEFAULT_IMAGE = "kubeflow-gpu-controller:latest"


def _gpu_schema() -> dict:
    return {
        "type": "object",
        "required": ["accelerator"],
        "properties": {
            "accelerator": {
                "type": "string",
                "enum": sorted(ACCELERATORS),
                "description": "GPU type",
            },
            "count": {
                "type": "integer",
                "minimum": 1,
                "default": 1,
                "description": "GPUs in the gang: up to one host's, or "
                               "whole hosts",
            },
        },
    }


def _replication_schema() -> dict:
    return {
        "type": "object",
        "properties": {
            "replicas": {
                "type": "integer",
                "minimum": 2,
                "maximum": 8,
                "default": 2,
                "description": "copies of the gang: a primary and its "
                               "followers",
            },
            "antiAffine": {
                "type": "boolean",
                "default": True,
                "description": "replica gangs on disjoint node pools",
            },
        },
    }


def notebook_crd(conversion_webhook: bool = True) -> dict:
    """The Notebook CRD: three field-identical versions, v1 storage, webhook
    conversion through the hub (reference config/crd/bases + patches)."""
    pod_spec = {
        "type": "object",
        "x-kubernetes-preserve-unknown-fields": True,
        "description": "raw corev1.PodSpec passthrough",
    }
    version_schema = {
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "properties": {
                    "template": {
                        "type": "object",
                        "properties": {"spec": pod_spec},
                    },
                    "gpu": _gpu_schema(),
                    "priority": {
                        "type": "string",
                        "enum": list(PRIORITY_CLASSES),
                        "description": "priority class; unset defers to "
                                       "the tenant's default",
                    },
                    "replication": _replication_schema(),
                },
            },
            "status": {
                "type": "object",
                "x-kubernetes-preserve-unknown-fields": True,
            },
        },
    }
    versions = []
    for v in VERSIONS:
        versions.append(
            {
                "name": v,
                "served": True,
                "storage": v == "v1",
                "schema": {"openAPIV3Schema": version_schema},
                "subresources": {"status": {}},
            }
        )
    crd = {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"notebooks.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {
                "kind": "Notebook",
                "listKind": "NotebookList",
                "plural": "notebooks",
                "singular": "notebook",
            },
            "scope": "Namespaced",
            "versions": versions,
        },
    }
    if conversion_webhook:
        crd["spec"]["conversion"] = {
            "strategy": "Webhook",
            "webhook": {
                "conversionReviewVersions": ["v1"],
                "clientConfig": {
                    "service": {
                        "name": "notebook-controller-webhook",
                        "namespace": "$(NAMESPACE)",
                        "path": "/convert",
                    }
                },
            },
        }
    return crd


def warmpool_crd() -> dict:
    """The GPUWarmPool CRD (core/scheduler.py): one cluster-scoped object
    per accelerator/count shape; claim/release bookkeeping lives in its
    status subresource so it survives manager failover."""
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"gpuwarmpools.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {
                "kind": C.WARMPOOL_KIND,
                "listKind": f"{C.WARMPOOL_KIND}List",
                "plural": "gpuwarmpools",
                "singular": "gpuwarmpool",
            },
            "scope": "Cluster",
            "versions": [
                {
                    "name": "v1",
                    "served": True,
                    "storage": True,
                    "schema": {
                        "openAPIV3Schema": {
                            "type": "object",
                            "properties": {
                                "spec": {
                                    "type": "object",
                                    "properties": {
                                        "accelerator": {"type": "string"},
                                        "count": {"type": "integer"},
                                    },
                                },
                                "status": {
                                    "type": "object",
                                    "x-kubernetes-preserve-unknown-fields":
                                        True,
                                },
                            },
                        }
                    },
                    "subresources": {"status": {}},
                }
            ],
        },
    }


def rbac_role() -> dict:
    """ClusterRole covering both controllers (the upstream
    config/rbac/role.yaml union of core + odh markers), and the kinds the
    port's controllers read beyond it: Nodes (the gang's placement and
    health), TenantQuota (the tenancy layer), ControlPlaneShardMap (the
    sharded fleet) and Istio's VirtualService (USE_ISTIO)."""
    rules = [
        {"apiGroups": [GROUP], "resources": ["notebooks"],
         "verbs": ["get", "list", "watch", "create", "update", "patch", "delete"]},
        {"apiGroups": [GROUP],
         "resources": ["notebooks/status", "notebooks/finalizers"],
         "verbs": ["get", "update", "patch"]},
        # gang scheduler + warm pool (core/scheduler.py): claim/release
        # bookkeeping lives on GPUWarmPool status
        {"apiGroups": [GROUP], "resources": ["gpuwarmpools"],
         "verbs": ["get", "list", "watch", "create", "update", "patch",
                   "delete"]},
        {"apiGroups": [GROUP], "resources": ["gpuwarmpools/status"],
         "verbs": ["get", "update", "patch"]},
        {"apiGroups": ["apps"], "resources": ["statefulsets"],
         "verbs": ["get", "list", "watch", "create", "update", "patch", "delete"]},
        {"apiGroups": [""],
         "resources": ["services", "serviceaccounts", "secrets", "configmaps",
                        "events"],
         "verbs": ["get", "list", "watch", "create", "update", "patch", "delete"]},
        {"apiGroups": [""], "resources": ["pods"],
         "verbs": ["get", "list", "watch", "delete"]},
        {"apiGroups": ["networking.k8s.io"], "resources": ["networkpolicies"],
         "verbs": ["get", "list", "watch", "create", "update", "patch", "delete"]},
        {"apiGroups": ["gateway.networking.k8s.io"],
         "resources": ["httproutes", "referencegrants"],
         "verbs": ["get", "list", "watch", "create", "update", "patch", "delete"]},
        {"apiGroups": ["gateway.networking.k8s.io"], "resources": ["gateways"],
         "verbs": ["get", "list", "watch"]},
        {"apiGroups": ["rbac.authorization.k8s.io"],
         "resources": ["rolebindings", "clusterrolebindings"],
         "verbs": ["get", "list", "watch", "create", "update", "patch", "delete"]},
        {"apiGroups": ["rbac.authorization.k8s.io"], "resources": ["roles",
                                                                    "clusterroles"],
         "verbs": ["get", "list", "watch"]},
        {"apiGroups": ["image.openshift.io"], "resources": ["imagestreams"],
         "verbs": ["get", "list", "watch"]},
        {"apiGroups": ["route.openshift.io"], "resources": ["routes"],
         "verbs": ["get", "list", "watch"]},
        {"apiGroups": ["oauth.openshift.io"], "resources": ["oauthclients"],
         "verbs": ["get", "delete"]},
        {"apiGroups": ["config.openshift.io"], "resources": ["proxies",
                                                              "apiservers"],
         "verbs": ["get", "list", "watch"]},
        {"apiGroups": ["datasciencepipelinesapplications.opendatahub.io"],
         "resources": ["datasciencepipelinesapplications"],
         "verbs": ["get", "list", "watch"]},
        # leader election (main.py --enable-leader-election; reference
        # leader-election RBAC in config/rbac/leader_election_role.yaml)
        {"apiGroups": ["coordination.k8s.io"], "resources": ["leases"],
         "verbs": ["get", "list", "watch", "create", "update", "patch"]},
        # the kinds the port's controllers read beyond the upstream role
        {"apiGroups": [""], "resources": ["nodes"],
         "verbs": ["get", "list", "watch"]},
        {"apiGroups": [GROUP],
         "resources": ["tenantquotas", "controlplaneshardmaps"],
         "verbs": ["get", "list", "watch", "create", "update", "patch"]},
        {"apiGroups": [GROUP],
         "resources": ["tenantquotas/status",
                       "controlplaneshardmaps/status"],
         "verbs": ["get", "update", "patch"]},
        {"apiGroups": ["networking.istio.io"],
         "resources": ["virtualservices"],
         "verbs": ["get", "list", "watch", "create", "update", "patch",
                   "delete"]},
    ]
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "ClusterRole",
        "metadata": {"name": "notebook-controller-role"},
        "rules": rules,
    }


def manager_deployment(profile: str, image: str = DEFAULT_IMAGE) -> dict:
    """Manager Deployment (the upstream config/manager/manager.yaml), env
    fed by the params ConfigMap."""
    env = [
        {"name": "ENABLE_CULLING", "valueFrom": {"configMapKeyRef": {
            "name": "notebook-controller-params", "key": "ENABLE_CULLING",
            "optional": True}}},
        {"name": "CULL_IDLE_TIME", "valueFrom": {"configMapKeyRef": {
            "name": "notebook-controller-params", "key": "CULL_IDLE_TIME",
            "optional": True}}},
        {"name": "IDLENESS_CHECK_PERIOD", "valueFrom": {"configMapKeyRef": {
            "name": "notebook-controller-params", "key": "IDLENESS_CHECK_PERIOD",
            "optional": True}}},
        {"name": "CHECKPOINT_BEFORE_CULL", "valueFrom": {"configMapKeyRef": {
            "name": "notebook-controller-params", "key": "CHECKPOINT_BEFORE_CULL",
            "optional": True}}},
        {"name": "GPU_DEFAULT_IMAGE", "valueFrom": {"configMapKeyRef": {
            "name": "notebook-controller-params", "key": "GPU_DEFAULT_IMAGE",
            "optional": True}}},
        {"name": "K8S_NAMESPACE", "valueFrom": {
            "fieldRef": {"fieldPath": "metadata.namespace"}}},
    ]
    if profile == "openshift":
        env.append({"name": "SET_PIPELINE_RBAC", "value": "true"})
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "name": "notebook-controller-deployment",
            "labels": {"app": "notebook-controller"},
        },
        "spec": {
            # two replicas double-reconcile without election; the manager
            # runs --enable-leader-election so the standby is a hot spare
            # (notebook-controller/main.go:91-93)
            "replicas": 2,
            "selector": {"matchLabels": {"app": "notebook-controller"}},
            "template": {
                "metadata": {"labels": {"app": "notebook-controller"}},
                "spec": {
                    "serviceAccountName": "notebook-controller-sa",
                    "containers": [
                        {
                            "name": "manager",
                            "image": image,
                            "command": [
                                "python", "-m", "kubeflow_tpu_torch.main",
                                "--in-cluster",
                                "--enable-leader-election",
                                "--cert-dir",
                                "/tmp/k8s-webhook-server/serving-certs",
                            ],
                            "ports": [
                                {"name": "metrics", "containerPort": 8080},
                                {"name": "webhook", "containerPort": 9443},
                            ],
                            "livenessProbe": {
                                "httpGet": {"path": "/healthz", "port": 8080}
                            },
                            "readinessProbe": {
                                "httpGet": {"path": "/readyz", "port": 8080}
                            },
                            "volumeMounts": [{
                                "name": "serving-certs",
                                "mountPath":
                                    "/tmp/k8s-webhook-server/serving-certs",
                                "readOnly": True,
                            }],
                            "resources": {
                                "requests": {"cpu": "100m", "memory": "128Mi"},
                                "limits": {"cpu": "500m", "memory": "512Mi"},
                            },
                        }
                    ],
                    "volumes": [{
                        "name": "serving-certs",
                        "secret": {
                            "secretName": "notebook-controller-webhook-certs",
                            "optional": True,
                        },
                    }],
                },
            },
        },
    }


def params_configmap(profile: str) -> dict:
    data = {
        "ENABLE_CULLING": "false",
        "CULL_IDLE_TIME": "1440",
        "IDLENESS_CHECK_PERIOD": "1",
        "CHECKPOINT_BEFORE_CULL": "true",
        "GPU_DEFAULT_IMAGE": "jupyter-cuda-pytorch:latest",
    }
    return {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {"name": "notebook-controller-params"},
        "data": data,
    }


def webhook_manifests() -> list[dict]:
    """Mutating + validating webhook configs and the serving Service
    (the upstream config/webhook/)."""
    client_config = {
        "service": {
            "name": "notebook-controller-webhook",
            "namespace": "$(NAMESPACE)",
        }
    }
    return [
        {
            "apiVersion": "admissionregistration.k8s.io/v1",
            "kind": "MutatingWebhookConfiguration",
            "metadata": {"name": "notebook-controller-mutating"},
            "webhooks": [
                {
                    "name": "mutate-notebook-v1.kubeflow.org",
                    "admissionReviewVersions": ["v1"],
                    "sideEffects": "NoneOnDryRun",
                    "clientConfig": {
                        **client_config,
                        "service": {
                            **client_config["service"],
                            "path": "/mutate-notebook-v1",
                        },
                    },
                    "rules": [
                        {
                            "apiGroups": [GROUP],
                            "apiVersions": ["v1"],
                            "operations": ["CREATE", "UPDATE"],
                            "resources": ["notebooks"],
                        }
                    ],
                }
            ],
        },
        {
            "apiVersion": "admissionregistration.k8s.io/v1",
            "kind": "ValidatingWebhookConfiguration",
            "metadata": {"name": "notebook-controller-validating"},
            "webhooks": [
                {
                    "name": "validate-notebook-v1.kubeflow.org",
                    "admissionReviewVersions": ["v1"],
                    "sideEffects": "None",
                    "clientConfig": {
                        **client_config,
                        "service": {
                            **client_config["service"],
                            "path": "/validate-notebook-v1",
                        },
                    },
                    "rules": [
                        {
                            "apiGroups": [GROUP],
                            "apiVersions": ["v1"],
                            "operations": ["UPDATE"],
                            "resources": ["notebooks"],
                        }
                    ],
                }
            ],
        },
        {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": "notebook-controller-webhook"},
            "spec": {
                "selector": {"app": "notebook-controller"},
                "ports": [{"port": 443, "targetPort": 9443}],
            },
        },
    ]


def render_profile(profile: str = "standalone",
                   image: str = DEFAULT_IMAGE) -> list[dict]:
    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r}; choose from {PROFILES}")
    docs: list[dict] = [
        notebook_crd(conversion_webhook=profile != "standalone"),
        warmpool_crd(),
        rbac_role(),
        {
            "apiVersion": "v1",
            "kind": "ServiceAccount",
            "metadata": {"name": "notebook-controller-sa"},
        },
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRoleBinding",
            "metadata": {"name": "notebook-controller-binding"},
            "roleRef": {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "ClusterRole",
                "name": "notebook-controller-role",
            },
            "subjects": [
                {
                    "kind": "ServiceAccount",
                    "name": "notebook-controller-sa",
                    "namespace": "$(NAMESPACE)",
                }
            ],
        },
        params_configmap(profile),
        manager_deployment(profile, image=image),
    ]
    if profile != "standalone":
        docs.extend(webhook_manifests())
    return docs


def render_yaml(profile: str = "standalone",
                image: str = DEFAULT_IMAGE) -> str:
    return yaml.safe_dump_all(render_profile(profile, image=image),
                              sort_keys=False)


def validate_docs(docs: Iterable[dict]) -> None:
    """Sanity over rendered docs (a `kustomize build` check's analog):
    every doc has apiVersion/kind/metadata.name, no duplicate
    identities."""
    seen = set()
    for doc in docs:
        for key in ("apiVersion", "kind"):
            if not doc.get(key):
                raise ValueError(f"manifest missing {key}: {doc}")
        name = doc.get("metadata", {}).get("name")
        if not name:
            raise ValueError(f"manifest missing metadata.name: {doc.get('kind')}")
        identity = (doc["kind"], name)
        if identity in seen:
            raise ValueError(f"duplicate manifest {identity}")
        seen.add(identity)


__all__ = ["DEFAULT_IMAGE", "PROFILES", "manager_deployment", "notebook_crd",
           "params_configmap", "rbac_role", "render_profile", "render_yaml",
           "validate_docs", "warmpool_crd", "webhook_manifests"]
