"""Feast feature-store integration.

The port's copy of kubeflow_tpu/odh/feast.py, the port of
notebook_feast_config.go: the `opendatahub.io/feast-integration`
label mounts the `{name}-feast-config` ConfigMap at
/opt/app-root/src/feast-config; removing the label unmounts it
(notebook_feast_config.go:34-146).
"""

from __future__ import annotations

from ..gpu.env import upsert_by_name
from ..kube import KubeObject
from . import constants as C
from .notebook import pod_spec


def is_feast_enabled(nb: KubeObject) -> bool:
    return nb.metadata.labels.get(C.LABEL_FEAST_INTEGRATION) == "true"


def feast_configmap_name(nb: KubeObject) -> str:
    return nb.name + C.FEAST_CONFIGMAP_SUFFIX


def mount_feast_config(nb: KubeObject) -> None:
    """Idempotent volume + first-container mount
    (mountFeastConfig, notebook_feast_config.go:53-117)."""
    spec = pod_spec(nb)
    upsert_by_name(
        spec.setdefault("volumes", []),
        {
            "name": C.FEAST_VOLUME_NAME,
            "configMap": {"name": feast_configmap_name(nb), "optional": True},
        },
    )
    containers = spec.get("containers") or []
    if not containers:
        return
    upsert_by_name(
        containers[0].setdefault("volumeMounts", []),
        {"name": C.FEAST_VOLUME_NAME, "mountPath": C.FEAST_MOUNT_PATH},
    )


def unmount_feast_config(nb: KubeObject) -> None:
    """Remove the volume and every container's mount
    (unmountFeastConfig, notebook_feast_config.go:120-146)."""
    spec = pod_spec(nb)
    volumes = [
        v for v in spec.get("volumes") or [] if v.get("name") != C.FEAST_VOLUME_NAME
    ]
    if volumes:
        spec["volumes"] = volumes
    else:
        spec.pop("volumes", None)
    for container in spec.get("containers") or []:
        mounts = [
            m
            for m in container.get("volumeMounts") or []
            if m.get("name") != C.FEAST_VOLUME_NAME
        ]
        if mounts:
            container["volumeMounts"] = mounts
        else:
            container.pop("volumeMounts", None)


def apply_feast_config(nb: KubeObject) -> None:
    """Webhook entry point: mount when labeled, unmount when not
    (notebook_mutating_webhook.go:439-452)."""
    if is_feast_enabled(nb):
        mount_feast_config(nb)
    else:
        unmount_feast_config(nb)
