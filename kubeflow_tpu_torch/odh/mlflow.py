"""MLflow integration.

The port's copy of kubeflow_tpu/odh/mlflow.py, the port of
notebook_mlflow.go: the `opendatahub.io/mlflow-instance` annotation
creates a RoleBinding `{name}-mlflow` for the notebook SA to the
`mlflow-operator-mlflow-integration` ClusterRole (requeueing until the
ClusterRole exists), and the webhook injects MLFLOW_* env vars with a
Gateway-derived tracking URI (notebook_mlflow.go:107-322).  The
validating webhook's rule is here too: the annotation may not be removed
from a running notebook (notebook_validating_webhook.go:79-100).
"""

from __future__ import annotations

from typing import Optional

from ..gpu.env import merge_env
from ..kube import (
    AdmissionDenied,
    ApiServer,
    EventRecorder,
    KubeObject,
    NotFoundError,
    ObjectMeta,
    set_controller_reference,
)
from ..utils.config import OdhConfig
from . import constants as C
from .gateway import get_hostname_for_public_endpoint
from .notebook import pod_spec

MLFLOW_IDENTIFIER = "mlflow"
MLFLOW_REQUEUE_SECONDS = 30.0


def mlflow_instance(nb: KubeObject) -> str:
    return nb.metadata.annotations.get(C.ANNOTATION_MLFLOW_INSTANCE, "")


def get_mlflow_tracking_uri(api: ApiServer, cfg: OdhConfig, instance_name: str) -> str:
    """https://{gateway-host}/mlflow[-{instance}] (getMLflowTrackingURI,
    notebook_mlflow.go:107-142).  GATEWAY_URL overrides discovery."""
    hostname = cfg.gateway_url or get_hostname_for_public_endpoint(api, cfg)
    if not hostname:
        raise LookupError("unable to determine hostname for MLflow tracking URI")
    path = MLFLOW_IDENTIFIER
    if instance_name and instance_name != MLFLOW_IDENTIFIER:
        path = f"{MLFLOW_IDENTIFIER}-{instance_name}"
    if hostname.startswith(("http://", "https://")):
        return f"{hostname}/{path}"
    return f"https://{hostname}/{path}"


def new_mlflow_role_binding(nb: KubeObject) -> KubeObject:
    return KubeObject(
        api_version="rbac.authorization.k8s.io/v1",
        kind="RoleBinding",
        metadata=ObjectMeta(
            name=nb.name + C.MLFLOW_ROLEBINDING_SUFFIX,
            namespace=nb.namespace,
            labels={C.NOTEBOOK_NAME_LABEL: nb.name},
        ),
        body={
            "roleRef": {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "ClusterRole",
                "name": C.MLFLOW_CLUSTER_ROLE,
            },
            "subjects": [
                {
                    "kind": "ServiceAccount",
                    "name": nb.name,
                    "namespace": nb.namespace,
                }
            ],
        },
    )


def reconcile_mlflow_integration(
    api: ApiServer,
    nb: KubeObject,
    recorder: Optional[EventRecorder] = None,
) -> Optional[float]:
    """Returns a requeue-after delay while the ClusterRole is absent, else
    None (ReconcileMLflowIntegration, notebook_mlflow.go:236-270)."""
    instance = mlflow_instance(nb)
    if not instance:
        # annotation removed -> drop the binding
        try:
            api.delete("RoleBinding", nb.namespace, nb.name + C.MLFLOW_ROLEBINDING_SUFFIX)
        except NotFoundError:
            pass
        return None
    if api.try_get("ClusterRole", "", C.MLFLOW_CLUSTER_ROLE) is None:
        if recorder is not None:
            recorder.event(
                nb,
                "Warning",
                "MLflowClusterRoleMissing",
                f"ClusterRole {C.MLFLOW_CLUSTER_ROLE} not found; retrying",
            )
        return MLFLOW_REQUEUE_SECONDS
    desired = new_mlflow_role_binding(nb)
    set_controller_reference(nb, desired)
    if api.try_get("RoleBinding", nb.namespace, desired.name) is None:
        api.create(desired)
    return None


def handle_mlflow_env_vars(api: ApiServer, nb: KubeObject, cfg: OdhConfig) -> None:
    """Webhook-side: inject/update MLFLOW_* env vars in the first container;
    strip them when the annotation is absent (HandleMLflowEnvVars,
    notebook_mlflow.go:287-322)."""
    containers = pod_spec(nb).get("containers") or []
    if not containers:
        return
    main = containers[0]
    instance = mlflow_instance(nb)
    managed = (
        C.MLFLOW_TRACKING_URI_ENV,
        C.MLFLOW_K8S_INTEGRATION_ENV,
        C.MLFLOW_TRACKING_AUTH_ENV,
    )
    env = [e for e in main.get("env") or [] if e.get("name") not in managed]
    if instance:
        tracking_uri = get_mlflow_tracking_uri(api, cfg, instance)
        env = merge_env(
            env,
            [
                {"name": C.MLFLOW_TRACKING_URI_ENV, "value": tracking_uri},
                {"name": C.MLFLOW_K8S_INTEGRATION_ENV, "value": "true"},
                {
                    "name": C.MLFLOW_TRACKING_AUTH_ENV,
                    "value": C.MLFLOW_TRACKING_AUTH_VALUE,
                },
            ],
        )
    if env:
        main["env"] = env
    else:
        main.pop("env", None)


def validate_mlflow_annotation_removal(old: KubeObject,
                                       obj: KubeObject) -> None:
    """Removing mlflow-instance while running would leave MLFLOW_* env
    vars outliving the RoleBinding
    (validateMLflowAnnotationRemoval :79-100)."""
    had = old.metadata.annotations.get(C.ANNOTATION_MLFLOW_INSTANCE, "")
    has = obj.metadata.annotations.get(C.ANNOTATION_MLFLOW_INSTANCE, "")
    if not had or has:
        return
    stopped = C.STOP_ANNOTATION in obj.metadata.annotations
    if not stopped:
        raise AdmissionDenied(
            "cannot remove the mlflow-instance annotation while the "
            "notebook is running; stop the notebook first"
        )
