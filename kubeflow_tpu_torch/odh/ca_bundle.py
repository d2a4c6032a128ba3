"""Trusted-CA-bundle plumbing.

The port's copy of kubeflow_tpu/odh/ca_bundle.py, the port of
CreateNotebookCertConfigMap / IsConfigMapDeleted /
UnsetNotebookCertConfig (odh notebook_controller.go:528-733): merge the
platform CA ConfigMaps into a per-namespace `workbench-trusted-ca-bundle`
with PEM validation; when that ConfigMap disappears, strip the cert
volume/mounts/env the webhook injected.
"""

from __future__ import annotations

import base64
import binascii
import re

from ..kube import (
    ApiServer,
    KubeObject,
    NotFoundError,
    ObjectMeta,
    retry_on_conflict,
)
from . import constants as C
from .notebook import pod_spec

_PEM_RE = re.compile(
    r"-----BEGIN ([A-Z ]+)-----\s*(.*?)\s*-----END \1-----", re.DOTALL
)

# ConfigMap name -> cert keys inspected (notebook_controller.go:541-546)
_SOURCE_KEYS = {
    C.ODH_TRUSTED_CA_BUNDLE_CONFIGMAP: (C.TRUSTED_CA_BUNDLE_FILE, "odh-ca-bundle.crt"),
    C.KUBE_ROOT_CA_CONFIGMAP: ("ca.crt",),
    C.OPENSHIFT_SERVICE_CA_CONFIGMAP: ("service-ca.crt",),
}


def valid_pem_certificate(cert_data: str) -> bool:
    """True when the blob contains at least one well-formed CERTIFICATE block
    (the reference pem.Decode + x509.ParseCertificate check,
    notebook_controller.go:578-593).  We validate PEM framing, base64 body,
    and the DER SEQUENCE tag without a full X.509 parse."""
    m = _PEM_RE.search(cert_data)
    if m is None or m.group(1) != "CERTIFICATE":
        return False
    try:
        der = base64.b64decode(re.sub(r"\s+", "", m.group(2)), validate=True)
    except (binascii.Error, ValueError):
        return False
    return len(der) > 2 and der[0] == 0x30  # X.509 certs are a DER SEQUENCE


def create_notebook_cert_configmap(api: ApiServer, nb: KubeObject) -> None:
    """Merge odh-trusted-ca-bundle + kube-root-ca.crt +
    openshift-service-ca.crt (all read from the *notebook* namespace) into
    workbench-trusted-ca-bundle.  Absent odh bundle, or an empty
    ca-bundle.crt key, means cert injection is handled elsewhere — create
    nothing (notebook_controller.go:549-575)."""
    pool: list[str] = []
    for cm_name, keys in _SOURCE_KEYS.items():
        cm = api.try_get("ConfigMap", nb.namespace, cm_name)
        if cm is None:
            if cm_name == C.ODH_TRUSTED_CA_BUNDLE_CONFIGMAP:
                return
            continue
        data = cm.body.get("data") or {}
        for key in keys:
            cert = (data.get(key) or "").strip()
            if key == C.TRUSTED_CA_BUNDLE_FILE and cm_name == C.ODH_TRUSTED_CA_BUNDLE_CONFIGMAP:
                if not cert:
                    # inject-ca-bundle handles it; ours would be empty
                    return
            if not cert:
                continue
            if valid_pem_certificate(cert):
                pool.append(cert)

    if not pool:
        return
    desired = KubeObject(
        api_version="v1",
        kind="ConfigMap",
        metadata=ObjectMeta(
            name=C.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP,
            namespace=nb.namespace,
            labels={"opendatahub.io/managed-by": "workbenches"},
        ),
        body={"data": {C.TRUSTED_CA_BUNDLE_FILE: "\n".join(pool)}},
    )
    found = api.try_get(
        "ConfigMap", nb.namespace, C.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP
    )
    if found is None:
        api.create(desired)
    elif found.body.get("data") != desired.body.get("data"):
        found.body["data"] = desired.body["data"]
        api.update(found)


def notebook_mounts_ca_bundle(nb: KubeObject) -> bool:
    """The notebook references workbench-trusted-ca-bundle as a volume
    (notebook_controller.go:653-663)."""
    for vol in pod_spec(nb).get("volumes") or []:
        cm = vol.get("configMap") or {}
        if cm.get("name") == C.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP:
            return True
    return False


def is_configmap_deleted(api: ApiServer, nb: KubeObject) -> bool:
    """workbench-trusted-ca-bundle is gone but the notebook still mounts it
    (notebook_controller.go:637-666)."""
    if not notebook_mounts_ca_bundle(nb):
        return False
    return (
        api.try_get("ConfigMap", nb.namespace, C.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP)
        is None
    )


def unset_notebook_cert_config(api: ApiServer, nb: KubeObject) -> None:
    """Strip the injected cert volume, volumeMounts, and env vars from the
    live Notebook (notebook_controller.go:668-733)."""

    def strip() -> None:
        live = api.get("Notebook", nb.namespace, nb.name)
        spec = pod_spec(live)
        spec["volumes"] = [
            v
            for v in spec.get("volumes") or []
            if (v.get("configMap") or {}).get("name")
            != C.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP
        ]
        if not spec["volumes"]:
            del spec["volumes"]
        for container in spec.get("containers") or []:
            mounts = [
                m
                for m in container.get("volumeMounts") or []
                if m.get("name") != C.TRUSTED_CA_BUNDLE_VOLUME
            ]
            if mounts:
                container["volumeMounts"] = mounts
            else:
                container.pop("volumeMounts", None)
            env = [
                e
                for e in container.get("env") or []
                if e.get("name") not in C.CA_BUNDLE_ENV_VARS
            ]
            if env:
                container["env"] = env
            else:
                container.pop("env", None)
        api.update(live)

    try:
        retry_on_conflict(strip)
    except NotFoundError:
        pass
