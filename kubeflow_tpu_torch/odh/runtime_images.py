"""Elyra pipeline runtime-images ConfigMap.

The port's copy of kubeflow_tpu/odh/runtime_images.py, the port of
notebook_runtime.go: scan controller-namespace ImageStreams labeled
`opendatahub.io/runtime-image`, build a per-user-namespace ConfigMap
`pipeline-runtime-images` (key = sanitized display_name + ".json", value =
tag metadata JSON with the image reference injected as `image_name`), and
mount it at /opt/app-root/pipeline-runtimes into every container
(notebook_runtime.go:43-285).
"""

from __future__ import annotations

import json
import re
from typing import Optional

from ..gpu.env import upsert_by_name
from ..kube import ApiServer, KubeObject, ObjectMeta
from . import constants as C
from .notebook import pod_spec

_INVALID_CHARS = re.compile(r"[^a-z0-9-]")
_MULTI_DASH = re.compile(r"-+")


def format_key_name(display_name: str) -> str:
    """Sanitize a display name into a ConfigMap key
    (formatKeyName, notebook_runtime.go:174-183)."""
    s = _INVALID_CHARS.sub("-", display_name.lower())
    s = _MULTI_DASH.sub("-", s).strip("-")
    return f"{s}.json" if s else ""


def parse_runtime_image_metadata(raw_json: str, image_url: str) -> str:
    """First object of the metadata array with image_name injected; "{}" on
    any parse failure (parseRuntimeImageMetadata,
    notebook_runtime.go:185-208)."""
    try:
        array = json.loads(raw_json)
    except ValueError:
        return "{}"
    if not isinstance(array, list) or not array or not isinstance(array[0], dict):
        return "{}"
    entry = array[0]
    if isinstance(entry.get("metadata"), dict):
        entry["metadata"]["image_name"] = image_url
    try:
        return json.dumps(entry, sort_keys=True)
    except (TypeError, ValueError):
        return "{}"


def _extract_display_name(metadata_json: str) -> str:
    try:
        parsed = json.loads(metadata_json)
    except ValueError:
        return ""
    name = parsed.get("display_name")
    return name if isinstance(name, str) else ""


def build_runtime_images_data(api: ApiServer, controller_namespace: str) -> dict:
    """ImageStreams -> ConfigMap data (notebook_runtime.go:47-95)."""
    data: dict[str, str] = {}
    for stream in api.list("ImageStream", namespace=controller_namespace):
        if stream.metadata.labels.get(C.LABEL_RUNTIME_IMAGE) != "true":
            continue
        for tag in stream.spec.get("tags") or []:
            raw = (tag.get("annotations") or {}).get(
                C.ANNOTATION_RUNTIME_IMAGE_METADATA, ""
            ) or "[]"
            image_url = (tag.get("from") or {}).get("name", "")
            if not image_url:
                continue
            parsed = parse_runtime_image_metadata(raw, image_url)
            display_name = _extract_display_name(parsed)
            if not display_name:
                continue
            key = format_key_name(display_name)
            if key:
                data[key] = parsed
    return data


def sync_runtime_images_configmap(
    api: ApiServer, notebook_namespace: str, controller_namespace: str
) -> Optional[KubeObject]:
    """Create/update `pipeline-runtime-images` in the user namespace; empty
    scan results never create (and never clobber) the ConfigMap
    (SyncRuntimeImagesConfigMap, notebook_runtime.go:43-152)."""
    data = build_runtime_images_data(api, controller_namespace)
    found = api.try_get("ConfigMap", notebook_namespace, C.RUNTIME_IMAGES_CONFIGMAP)
    if not data:
        return found
    if found is None:
        return api.create(
            KubeObject(
                api_version="v1",
                kind="ConfigMap",
                metadata=ObjectMeta(
                    name=C.RUNTIME_IMAGES_CONFIGMAP,
                    namespace=notebook_namespace,
                    labels={"opendatahub.io/managed-by": "workbenches"},
                ),
                body={"data": data},
            )
        )
    if found.body.get("data") != data:
        found.body["data"] = data
        return api.update(found)
    return found


def mount_pipeline_runtime_images(nb: KubeObject) -> None:
    """Webhook-side mutation: optional ConfigMap volume mounted into ALL
    containers (MountPipelineRuntimeImages, notebook_runtime.go:216-285)."""
    spec = pod_spec(nb)
    upsert_by_name(
        spec.setdefault("volumes", []),
        {
            "name": C.RUNTIME_IMAGES_VOLUME,
            "configMap": {"name": C.RUNTIME_IMAGES_CONFIGMAP, "optional": True},
        },
    )
    mount = {
        "name": C.RUNTIME_IMAGES_VOLUME,
        "mountPath": C.RUNTIME_IMAGES_MOUNT_PATH,
    }
    for container in spec.get("containers") or []:
        upsert_by_name(container.setdefault("volumeMounts", []), mount)
