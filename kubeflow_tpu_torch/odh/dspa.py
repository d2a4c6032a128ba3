"""DSPA (Data Science Pipelines Application) / Elyra integration.

The port's copy of kubeflow_tpu/odh/dspa.py, the port of
notebook_dspa_secret.go: build the `ds-pipeline-config` Secret with
an Elyra runtime config (odh_dsp.json) from the namespace's DSPA CR — API
endpoint from DSPA status, S3 object-store coordinates + credentials from the
referenced Secret, public endpoint from the Gateway hostname — and mount it
at /opt/app-root/runtimes (notebook_dspa_secret.go:189-477).
"""

from __future__ import annotations

import base64
import json
from typing import Optional

from ..gpu.env import upsert_by_name
from ..kube import ApiServer, KubeObject, ObjectMeta, set_controller_reference
from ..utils.config import OdhConfig
from . import constants as C
from .gateway import get_hostname_for_public_endpoint
from .notebook import pod_spec


class DSPAConfigError(ValueError):
    """A DSPA CR exists but is unusable (missing objectStorage, creds, ...)."""


def get_dspa_instance(api: ApiServer, namespace: str) -> Optional[KubeObject]:
    """The namespace's DSPA CR, or None — absence is normal and means "no
    pipelines here", never an error (the nil-on-absent pattern,
    notebook_dspa_secret.go:49-66)."""
    instances = api.list("DataSciencePipelinesApplication", namespace=namespace)
    return instances[0] if instances else None


def _secret_value(secret: KubeObject, key: str, name: str) -> str:
    data = secret.body.get("data") or {}
    if key in data:
        try:
            return base64.b64decode(data[key]).decode()
        except Exception:
            return str(data[key])
    string_data = secret.body.get("stringData") or {}
    if key in string_data:
        return string_data[key]
    raise DSPAConfigError(f"missing key '{key}' in secret '{name}'")


def extract_elyra_runtime_config(
    api: ApiServer, nb: KubeObject, dspa: KubeObject, cfg: OdhConfig
) -> dict:
    """Elyra-compatible runtime config dict
    (extractElyraRuntimeConfigInfo, notebook_dspa_secret.go:189-298)."""
    api_endpoint = (
        dspa.status.get("components", {}).get("apiServer", {}).get("externalUrl", "")
    )
    object_storage = dspa.spec.get("objectStorage")
    if not object_storage:
        raise DSPAConfigError("invalid DSPA CR: 'objectStorage' is not configured")
    external = object_storage.get("externalStorage")
    if not external:
        raise DSPAConfigError(
            "invalid DSPA CR: 'objectStorage.externalStorage' is not configured"
        )
    host = external.get("host", "")
    if not host:
        raise DSPAConfigError("invalid DSPA CR: missing or invalid 'host'")
    scheme = external.get("scheme") or "https"
    bucket = external.get("bucket", "")
    if not bucket:
        raise DSPAConfigError("invalid DSPA CR: missing or invalid 'bucket'")
    cred = external.get("s3CredentialSecret")
    if not cred:
        raise DSPAConfigError(
            "invalid DSPA CR: 'objectStorage.externalStorage.s3CredentialSecret'"
            " is not configured"
        )
    secret_name = cred.get("secretName", "")
    access_key = cred.get("accessKey", "")
    secret_key = cred.get("secretKey", "")
    if not secret_name or not access_key or not secret_key:
        raise DSPAConfigError(
            "invalid DSPA CR: incomplete s3CredentialSecret configuration"
        )
    secret = api.try_get("Secret", nb.namespace, secret_name)
    if secret is None:
        raise DSPAConfigError(f"failed to get secret '{secret_name}'")

    metadata: dict = {
        "tags": [],
        "display_name": "Pipeline",
        "engine": "Argo",
        "runtime_type": "KUBEFLOW_PIPELINES",
        "auth_type": "KUBERNETES_SERVICE_ACCOUNT_TOKEN",
        "cos_auth_type": "KUBERNETES_SECRET",
        "api_endpoint": api_endpoint,
        "cos_endpoint": f"{scheme}://{host}",
        "cos_bucket": bucket,
        "cos_username": _secret_value(secret, access_key, secret_name),
        "cos_password": _secret_value(secret, secret_key, secret_name),
        "cos_secret": secret_name,
    }
    hostname = get_hostname_for_public_endpoint(api, cfg)
    if hostname:
        metadata["public_api_endpoint"] = (
            f"https://{hostname}/external/elyra/{nb.namespace}"
        )
    return {"display_name": "Pipeline", "schema_name": "kfp", "metadata": metadata}


def sync_elyra_runtime_config_secret(
    api: ApiServer, nb: KubeObject, cfg: OdhConfig
) -> Optional[KubeObject]:
    """Create/update `ds-pipeline-config` owned by the DSPA CR (so it dies
    with the DSPA, not the notebook) — SyncElyraRuntimeConfigSecret,
    notebook_dspa_secret.go:305-399.  No DSPA -> no-op."""
    dspa = get_dspa_instance(api, nb.namespace)
    if dspa is None:
        return None
    config = extract_elyra_runtime_config(api, nb, dspa, cfg)
    payload = json.dumps(config, sort_keys=True)
    desired = KubeObject(
        api_version="v1",
        kind="Secret",
        metadata=ObjectMeta(
            name=C.ELYRA_SECRET_NAME,
            namespace=nb.namespace,
            labels={"opendatahub.io/managed-by": "workbenches"},
        ),
        body={
            "type": "Opaque",
            "data": {
                C.ELYRA_SECRET_KEY: base64.b64encode(payload.encode()).decode()
            },
        },
    )
    set_controller_reference(dspa, desired)
    found = api.try_get("Secret", nb.namespace, C.ELYRA_SECRET_NAME)
    if found is None:
        return api.create(desired)
    if found.body.get("data") != desired.body.get("data"):
        found.body["data"] = desired.body["data"]
        return api.update(found)
    return found


def mount_elyra_runtime_config_secret(nb: KubeObject) -> None:
    """Webhook-side mutation: mount the secret at /opt/app-root/runtimes in
    the first container (MountElyraRuntimeConfigSecret,
    notebook_dspa_secret.go:403-477)."""
    spec = pod_spec(nb)
    upsert_by_name(
        spec.setdefault("volumes", []),
        {
            "name": C.ELYRA_VOLUME_NAME,
            "secret": {"secretName": C.ELYRA_SECRET_NAME, "optional": True},
        },
    )
    containers = spec.get("containers") or []
    if not containers:
        return
    upsert_by_name(
        containers[0].setdefault("volumeMounts", []),
        {"name": C.ELYRA_VOLUME_NAME, "mountPath": C.ELYRA_MOUNT_PATH},
    )
