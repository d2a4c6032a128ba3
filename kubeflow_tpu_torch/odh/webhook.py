"""Admission webhooks for the Notebook CR.

The port of kubeflow_tpu/odh/webhook.py (notebook_mutating_webhook.go /
notebook_validating_webhook.go) with the GPU image path:

Mutating (NotebookWebhook.Handle :360-516):
  CREATE      -> inject the reconciliation lock (stop-annotation = lock value)
  always      -> resolve the container image — ImageStream `last-image-selection`
                 resolution (:865-972), and for `spec.gpu` notebooks the
                 image-swap table, the twin of the reference's TPU one:
                 an image not aimed at the card becomes a CUDA + PyTorch
                 workbench image
              -> mount the trusted CA bundle + cert env (:700-859)
              -> sync + mount pipeline runtime images (:405-418)
              -> [SET_PIPELINE_SECRET] sync + mount the Elyra DSPA secret
              -> Feast mount/unmount by label (:439-452)
              -> [MLFLOW_ENABLED] MLflow env vars (:454-462)
              -> [inject-auth] kube-rbac-proxy sidecar (:183-334)
              -> [INJECT_CLUSTER_PROXY_ENV] proxy env (:473-490)
  UPDATE      -> restart-blocking: revert webhook-only pod-template changes on
                 a running notebook and stamp `update-pending` with the first
                 difference (:518-581) — with the gang carve-out: a
                 spec.gpu edit is always a gang-atomic restart, never
                 blocked.

Validating (notebook_validating_webhook.go:31-100):
  UPDATE      -> deny removing the mlflow-instance annotation while running
                 (mlflow.py).

The handlers take the CR's KubeObject (odh/notebook.py says why).
"""

from __future__ import annotations

import copy
import logging
from typing import Optional

from ..gpu.env import merge_env, upsert_by_name
from ..kube import (
    AdmissionDenied,
    AdmissionHook,
    ApiServer,
    KubeObject,
    parse_quantity,
)
from ..utils.config import OdhConfig
from ..utils.tracing import get_tracer
from . import constants as C
from .dspa import mount_elyra_runtime_config_secret, sync_elyra_runtime_config_secret
from .feast import apply_feast_config
from .diff import first_difference
from .mlflow import handle_mlflow_env_vars, validate_mlflow_annotation_removal
from .notebook import main_container, pod_spec
from .runtime_images import mount_pipeline_runtime_images, sync_runtime_images_configmap

logger = logging.getLogger("kubeflow_tpu_torch.odh.webhook")

IMAGE_STREAM_NOT_FOUND_EVENT = "ImageStreamNotFound"
IMAGE_STREAM_TAG_NOT_FOUND_EVENT = "ImageStreamTagNotFound"
INTERNAL_REGISTRY_HOST = "image-registry.openshift-image-registry.svc:5000"
# substrings of an image the user already aimed at the card
GPU_IMAGE_MARKERS = ("cuda", "torch", "pytorch")


# -- reconciliation lock -------------------------------------------------------


def inject_reconciliation_lock(nb: KubeObject) -> None:
    """On CREATE the workload starts at 0 replicas until the ODH controller
    has its objects ready (notebook_mutating_webhook.go:106-122)."""
    nb.metadata.annotations.setdefault(
        C.STOP_ANNOTATION, C.RECONCILIATION_LOCK_VALUE
    )


# -- image resolution ----------------------------------------------------------


def set_container_image_from_registry(
    api: ApiServer, nb: KubeObject, controller_namespace: str, span
) -> None:
    """ImageStream tag -> dockerImageReference
    (SetContainerImageFromRegistry, notebook_mutating_webhook.go:865-972)."""
    selection = nb.metadata.annotations.get(C.ANNOTATION_LAST_IMAGE_SELECTION)
    if not selection:
        return
    container = main_container(nb)
    if container is None:
        raise ValueError(f"no container found matching the notebook name {nb.name}")
    if INTERNAL_REGISTRY_HOST in (container.get("image") or ""):
        return  # dashboard already resolved through the internal registry
    if selection.count(":") != 1:
        raise ValueError("invalid image selection format")
    stream_name, tag_name = selection.split(":")
    image_namespace = (
        nb.metadata.annotations.get(C.ANNOTATION_WORKBENCH_IMAGE_NAMESPACE, "").strip()
        or controller_namespace
    )
    stream = api.try_get("ImageStream", image_namespace, stream_name)
    if stream is None:
        span.add_event(IMAGE_STREAM_NOT_FOUND_EVENT)
        return
    tags = stream.status.get("tags") or []
    if not tags:
        span.add_event(IMAGE_STREAM_TAG_NOT_FOUND_EVENT)
        raise ValueError("ImageStream has no status or tags")
    for tag in tags:
        if tag.get("tag") != tag_name:
            continue
        items = tag.get("items") or []
        if not items:
            continue
        newest = max(items, key=lambda it: it.get("created", ""))
        container["image"] = newest.get("dockerImageReference", "")
        for env in container.get("env") or []:
            if env.get("name") == "JUPYTER_IMAGE":
                env["value"] = selection
                break
        return
    span.add_event(IMAGE_STREAM_TAG_NOT_FOUND_EVENT)


def swap_gpu_image(nb: KubeObject, cfg: OdhConfig) -> None:
    """GPU path, the twin of the reference's `swap_tpu_image`: keyed off
    spec.gpu, replace a workbench image not aimed at the card with a CUDA
    + PyTorch one.  Explicit map entries win; an image with no mapping and
    no GPU marker falls back to the default GPU workbench image; a CPU
    notebook is untouched."""
    if not nb.spec.get("gpu"):
        return
    container = main_container(nb) or (
        pod_spec(nb).get("containers") or [{}])[0]
    image = container.get("image") or ""
    if image in cfg.gpu_image_map:
        container["image"] = cfg.gpu_image_map[image]
        return
    # keep images the user already aimed at the card
    if any(marker in image for marker in GPU_IMAGE_MARKERS):
        return
    container["image"] = cfg.gpu_default_image


# -- CA bundle mount -----------------------------------------------------------


def inject_cert_config(nb: KubeObject, configmap_name: str) -> None:
    """Mount the bundle at /etc/pki/tls/custom-certs and point the usual
    TLS-consuming env vars at it (InjectCertConfig,
    notebook_mutating_webhook.go:747-859)."""
    spec = pod_spec(nb)
    cert_path = f"{C.TRUSTED_CA_MOUNT_PATH}/{C.TRUSTED_CA_BUNDLE_FILE}"
    volume = {
        "name": C.TRUSTED_CA_BUNDLE_VOLUME,
        "configMap": {
            "name": configmap_name,
            "optional": True,
            "items": [
                {"key": C.TRUSTED_CA_BUNDLE_FILE, "path": C.TRUSTED_CA_BUNDLE_FILE}
            ],
        },
    }
    upsert_by_name(spec.setdefault("volumes", []), volume)
    mount = {
        "name": C.TRUSTED_CA_BUNDLE_VOLUME,
        "mountPath": C.TRUSTED_CA_MOUNT_PATH,
        "readOnly": True,
    }
    for container in spec.get("containers") or []:
        upsert_by_name(container.setdefault("volumeMounts", []), mount)
        container["env"] = merge_env(
            container.get("env") or [],
            [{"name": name, "value": cert_path} for name in C.CA_BUNDLE_ENV_VARS],
        )


def check_and_mount_ca_cert_bundle(api: ApiServer, nb: KubeObject) -> None:
    """Mount workbench-trusted-ca-bundle when it exists with a non-empty
    bundle (CheckAndMountCACertBundle,
    notebook_mutating_webhook.go:700-745)."""
    cm = api.try_get(
        "ConfigMap", nb.namespace, C.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP
    )
    if cm is None:
        return
    bundle = (cm.body.get("data") or {}).get(C.TRUSTED_CA_BUNDLE_FILE, "").strip()
    if not bundle:
        return
    inject_cert_config(nb, C.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP)


# -- kube-rbac-proxy sidecar ---------------------------------------------------


def parse_auth_sidecar_resources(nb: KubeObject) -> dict:
    """Resources from annotations with validation; defaults 100m/64Mi,
    requests == limits (parseAndValidateAuthSidecarResources,
    notebook_mutating_webhook.go:134-181)."""

    def quantity(annotation: str, default: str) -> str:
        value = nb.metadata.annotations.get(annotation, "").strip()
        if not value:
            return default
        try:
            parsed = parse_quantity(value)
        except ValueError:
            raise AdmissionDenied(
                f"invalid resource quantity {value!r} in annotation {annotation}"
            ) from None
        if parsed <= 0:
            raise AdmissionDenied(
                f"non-positive resource quantity {value!r} in annotation {annotation}"
            )
        return value

    cpu_request = quantity(
        C.ANNOTATION_AUTH_SIDECAR_CPU_REQUEST, C.KUBE_RBAC_PROXY_DEFAULT_CPU
    )
    memory_request = quantity(
        C.ANNOTATION_AUTH_SIDECAR_MEMORY_REQUEST, C.KUBE_RBAC_PROXY_DEFAULT_MEMORY
    )
    cpu_limit = quantity(C.ANNOTATION_AUTH_SIDECAR_CPU_LIMIT, cpu_request)
    memory_limit = quantity(C.ANNOTATION_AUTH_SIDECAR_MEMORY_LIMIT, memory_request)
    return {
        "requests": {"cpu": cpu_request, "memory": memory_request},
        "limits": {"cpu": cpu_limit, "memory": memory_limit},
    }


def inject_kube_rbac_proxy(nb: KubeObject, cfg: OdhConfig) -> None:
    """Sidecar + config/TLS volumes + dedicated SA (InjectKubeRbacProxy,
    notebook_mutating_webhook.go:183-334)."""
    resources = parse_auth_sidecar_resources(nb)
    sidecar = {
        "name": C.KUBE_RBAC_PROXY_CONTAINER_NAME,
        "image": cfg.kube_rbac_proxy_image,
        "args": [
            f"--secure-listen-address=0.0.0.0:{C.KUBE_RBAC_PROXY_PORT}",
            f"--upstream=http://127.0.0.1:{C.NOTEBOOK_PORT}/",
            "--auth-header-fields-enabled=true",
            f"--proxy-endpoints-port={C.KUBE_RBAC_PROXY_HEALTH_PORT}",
            f"--config-file={C.KUBE_RBAC_PROXY_CONFIG_MOUNT_PATH}/{C.KUBE_RBAC_PROXY_CONFIG_FILE}",
            f"--tls-cert-file={C.KUBE_RBAC_PROXY_TLS_MOUNT_PATH}/tls.crt",
            f"--tls-private-key-file={C.KUBE_RBAC_PROXY_TLS_MOUNT_PATH}/tls.key",
        ],
        "ports": [
            {
                "name": C.KUBE_RBAC_PROXY_PORT_NAME,
                "containerPort": C.KUBE_RBAC_PROXY_PORT,
                "protocol": "TCP",
            }
        ],
        "livenessProbe": {
            "httpGet": {
                "path": "/healthz",
                "port": C.KUBE_RBAC_PROXY_HEALTH_PORT,
                "scheme": "HTTPS",
            }
        },
        "readinessProbe": {
            "httpGet": {
                "path": "/healthz",
                "port": C.KUBE_RBAC_PROXY_HEALTH_PORT,
                "scheme": "HTTPS",
            }
        },
        "resources": resources,
        "volumeMounts": [
            {
                "name": C.KUBE_RBAC_PROXY_CONFIG_VOLUME,
                "mountPath": C.KUBE_RBAC_PROXY_CONFIG_MOUNT_PATH,
            },
            {
                "name": C.KUBE_RBAC_PROXY_TLS_VOLUME,
                "mountPath": C.KUBE_RBAC_PROXY_TLS_MOUNT_PATH,
            },
        ],
    }
    spec = pod_spec(nb)
    upsert_by_name(spec.setdefault("containers", []), sidecar)
    volumes = spec.setdefault("volumes", [])
    for volume in (
        {
            "name": C.KUBE_RBAC_PROXY_CONFIG_VOLUME,
            "configMap": {"name": nb.name + C.KUBE_RBAC_PROXY_CONFIG_SUFFIX},
        },
        {
            "name": C.KUBE_RBAC_PROXY_TLS_VOLUME,
            "secret": {"secretName": nb.name + C.KUBE_RBAC_PROXY_TLS_SECRET_SUFFIX},
        },
    ):
        upsert_by_name(volumes, volume)
    # the proxy authenticates with its own (per-notebook) ServiceAccount
    spec["serviceAccountName"] = nb.name


def auth_injection_requested(nb: KubeObject) -> bool:
    return nb.metadata.annotations.get(C.ANNOTATION_INJECT_AUTH) == "true"


# -- cluster proxy env ---------------------------------------------------------


def inject_proxy_config_env_vars(api: ApiServer, nb: KubeObject) -> None:
    """HTTP(S)_PROXY/NO_PROXY from the cluster Proxy CR into the notebook's
    main container (InjectProxyConfigEnvVars,
    notebook_mutating_webhook.go:648-698)."""
    proxy = api.try_get("Proxy", "", "cluster")
    if proxy is None:
        return
    status = proxy.body.get("status") or {}
    values = {
        "HTTP_PROXY": status.get("httpProxy", ""),
        "HTTPS_PROXY": status.get("httpsProxy", ""),
        "NO_PROXY": status.get("noProxy", ""),
    }
    container = main_container(nb)
    if container is None:
        return
    env = list(container.get("env") or [])
    for name in C.PROXY_ENV_VARS:
        value = values.get(name, "")
        if not value:
            continue
        for entry in env:
            if entry.get("name") == name:
                entry["value"] = value
                break
        else:
            env.append({"name": name, "value": value})
    container["env"] = env


# -- restart blocking ----------------------------------------------------------


def maybe_restart_running_notebook(
    op: str,
    old: Optional[KubeObject],
    submitted: KubeObject,
    mutated: KubeObject,
    tracer,
) -> Optional[str]:
    """Returns a pending-update reason when webhook-caused pod-template
    changes on a running notebook were reverted, else None
    (maybeRestartRunningNotebook, notebook_mutating_webhook.go:518-581).

    Gang carve-out: when spec.gpu itself changed, the workload restarts
    gang-atomically no matter what — blocking the webhook's consequent
    image/env updates would strand the new gang on the old image, so
    everything passes through.
    """
    with tracer.start_span("maybeRestartRunningNotebook"):
        if op == "CREATE" or old is None:
            return None
        annotations = mutated.metadata.annotations
        if C.STOP_ANNOTATION in annotations:
            return None
        if annotations.get("notebooks.opendatahub.io/notebook-restart"):
            return None
        old_spec = old.spec.get("template", {}).get("spec", {})
        submitted_spec = submitted.spec.get("template", {}).get("spec", {})
        if old.spec.get("gpu") != submitted.spec.get("gpu"):
            return None  # gang edit: always a restart
        if old_spec != submitted_spec:
            return None  # user's own edit restarts the pod anyway
        mutated_spec = pod_spec(mutated)
        if mutated_spec == old_spec:
            return None  # webhook changed nothing
        reason = first_difference(mutated_spec, submitted_spec)
        mutated.spec.setdefault("template", {})["spec"] = copy.deepcopy(
            submitted_spec
        )
        return reason or "failed to compute the reason for why there is a pending restart"


# -- the webhooks --------------------------------------------------------------


class NotebookMutatingWebhook:
    """Callable registered as a mutating AdmissionHook on the ApiServer."""

    def __init__(self, api: ApiServer, cfg: OdhConfig):
        self.api = api
        self.cfg = cfg
        self.tracer = get_tracer("odh-notebook-controller/webhook")

    def handle(
        self, op: str, old: Optional[KubeObject], obj: KubeObject
    ) -> KubeObject:
        nb = obj
        submitted = obj.deepcopy()
        with self.tracer.start_span(
            "NotebookWebhook.Handle",
            {"notebook": nb.name, "namespace": nb.namespace, "operation": op},
        ) as span:
            if op == "CREATE":
                inject_reconciliation_lock(nb)
            set_container_image_from_registry(
                self.api, nb, self.cfg.controller_namespace, span
            )
            swap_gpu_image(nb, self.cfg)
            check_and_mount_ca_cert_bundle(self.api, nb)
            sync_runtime_images_configmap(
                self.api, nb.namespace, self.cfg.controller_namespace
            )
            mount_pipeline_runtime_images(nb)
            if self.cfg.set_pipeline_secret:
                try:
                    sync_elyra_runtime_config_secret(self.api, nb, self.cfg)
                except Exception as err:
                    # a broken DSPA must not block notebook admission
                    logger.warning("elyra secret sync failed: %s", err)
                mount_elyra_runtime_config_secret(nb)
            apply_feast_config(nb)
            if self.cfg.mlflow_enabled:
                handle_mlflow_env_vars(self.api, nb, self.cfg)
            if auth_injection_requested(nb):
                inject_kube_rbac_proxy(nb, self.cfg)
            if self.cfg.inject_cluster_proxy_env:
                inject_proxy_config_env_vars(self.api, nb)

            reason = maybe_restart_running_notebook(
                op, old, submitted, nb, self.tracer
            )
            if reason is not None:
                nb.metadata.annotations[C.ANNOTATION_UPDATE_PENDING] = reason
            else:
                nb.metadata.annotations.pop(C.ANNOTATION_UPDATE_PENDING, None)
        return nb

    def hook(self) -> AdmissionHook:
        return AdmissionHook(
            kinds=("Notebook",),
            handler=self.handle,
            operations=("CREATE", "UPDATE"),
            mutating=True,
            name="mutate-notebook-v1",
        )


class NotebookValidatingWebhook:
    """UPDATE-only validation (notebook_validating_webhook.go:31-100)."""

    def __init__(self, api: ApiServer, cfg: OdhConfig):
        self.api = api
        self.cfg = cfg

    def handle(self, op: str, old: Optional[KubeObject], obj: KubeObject) -> None:
        if op != "UPDATE" or old is None:
            return
        validate_mlflow_annotation_removal(old, obj)

    def hook(self) -> AdmissionHook:
        return AdmissionHook(
            kinds=("Notebook",),
            handler=self.handle,
            operations=("UPDATE",),
            mutating=False,
            name="validate-notebook-v1",
        )
