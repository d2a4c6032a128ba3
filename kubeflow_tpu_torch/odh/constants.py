"""ODH extension-plane constants: the annotation/label/finalizer API surface.

The port's copy of kubeflow_tpu/odh/constants.py, which mirrors the
constants scattered across
components/odh-notebook-controller/controllers/notebook_controller.go:56-74,
notebook_mutating_webhook.go:79-102, notebook_kube_rbac_auth.go:36-40 and
notebook_network.go:36-39.  The GPU gang's NetworkPolicy suffix, the
twin of the TPU worker policy's, stays in core/constants.py
(GPU_WORKER_NETWORK_POLICY_SUFFIX), beside the renderer's names.
"""

# -- reconciliation lock (webhook <-> ODH controller protocol) ----------------
# notebook_mutating_webhook.go:106-122 / odh notebook_controller.go:155-186
STOP_ANNOTATION = "kubeflow-resource-stopped"
RECONCILIATION_LOCK_VALUE = "odh-notebook-controller-lock"

# -- user-facing annotations (odh notebook_controller.go:56-67) ---------------
ANNOTATION_INJECT_AUTH = "notebooks.opendatahub.io/inject-auth"
ANNOTATION_AUTH_SIDECAR_CPU_REQUEST = "notebooks.opendatahub.io/auth-sidecar-cpu-request"
ANNOTATION_AUTH_SIDECAR_MEMORY_REQUEST = "notebooks.opendatahub.io/auth-sidecar-memory-request"
ANNOTATION_AUTH_SIDECAR_CPU_LIMIT = "notebooks.opendatahub.io/auth-sidecar-cpu-limit"
ANNOTATION_AUTH_SIDECAR_MEMORY_LIMIT = "notebooks.opendatahub.io/auth-sidecar-memory-limit"
ANNOTATION_LAST_IMAGE_SELECTION = "notebooks.opendatahub.io/last-image-selection"
ANNOTATION_UPDATE_PENDING = "notebooks.opendatahub.io/update-pending"
ANNOTATION_MLFLOW_INSTANCE = "opendatahub.io/mlflow-instance"
ANNOTATION_WORKBENCH_IMAGE_NAMESPACE = "opendatahub.io/workbench-image-namespace"
LABEL_FEAST_INTEGRATION = "opendatahub.io/feast-integration"
LABEL_RUNTIME_IMAGE = "opendatahub.io/runtime-image"
ANNOTATION_RUNTIME_IMAGE_METADATA = "opendatahub.io/runtime-image-metadata"

# -- finalizers (odh notebook_controller.go:69-74) ----------------------------
HTTPROUTE_FINALIZER = "notebook.opendatahub.io/httproute-cleanup"
REFERENCEGRANT_FINALIZER = "notebook.opendatahub.io/referencegrant-cleanup"
KUBE_RBAC_PROXY_FINALIZER = "notebook.opendatahub.io/kube-rbac-proxy-cleanup"
OAUTH_CLIENT_FINALIZER = "notebook.opendatahub.io/oauth-client-cleanup"

# -- routing (notebook_route.go:36-44) ----------------------------------------
HTTPROUTE_NAME_MAX_LEN = 63
NOTEBOOK_NAME_LABEL = "notebook-name"
NOTEBOOK_NAMESPACE_LABEL = "notebook-namespace"
REFERENCEGRANT_NAME = "notebook-httproute-access"
NOTEBOOK_PORT = 8888

# -- kube-rbac-proxy (notebook_kube_rbac_auth.go:36-40,
#    notebook_mutating_webhook.go:79-102, notebook_network.go:36-39) ----------
KUBE_RBAC_PROXY_PORT = 8443
KUBE_RBAC_PROXY_HEALTH_PORT = 8444
KUBE_RBAC_PROXY_PORT_NAME = "kube-rbac-proxy"
KUBE_RBAC_PROXY_CONTAINER_NAME = "kube-rbac-proxy"
KUBE_RBAC_PROXY_SERVICE_SUFFIX = "-kube-rbac-proxy"
KUBE_RBAC_PROXY_CONFIG_SUFFIX = "-kube-rbac-proxy-config"
KUBE_RBAC_PROXY_TLS_SECRET_SUFFIX = "-kube-rbac-proxy-tls"
KUBE_RBAC_PROXY_CONFIG_VOLUME = "kube-rbac-proxy-config"
KUBE_RBAC_PROXY_CONFIG_MOUNT_PATH = "/etc/kube-rbac-proxy"
KUBE_RBAC_PROXY_CONFIG_FILE = "config-file.yaml"
KUBE_RBAC_PROXY_TLS_VOLUME = "kube-rbac-proxy-tls-certificates"
KUBE_RBAC_PROXY_TLS_MOUNT_PATH = "/etc/tls/private"
KUBE_RBAC_PROXY_NETWORK_POLICY_SUFFIX = "-kube-rbac-proxy-np"
KUBE_RBAC_PROXY_DEFAULT_CPU = "100m"
KUBE_RBAC_PROXY_DEFAULT_MEMORY = "64Mi"
SERVING_CERT_ANNOTATION = "service.beta.openshift.io/serving-cert-secret-name"

# -- CA bundle (odh notebook_controller.go:528-635,
#    notebook_mutating_webhook.go:100-102) ------------------------------------
ODH_TRUSTED_CA_BUNDLE_CONFIGMAP = "odh-trusted-ca-bundle"
WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP = "workbench-trusted-ca-bundle"
KUBE_ROOT_CA_CONFIGMAP = "kube-root-ca.crt"
OPENSHIFT_SERVICE_CA_CONFIGMAP = "openshift-service-ca.crt"
TRUSTED_CA_BUNDLE_VOLUME = "trusted-ca"
TRUSTED_CA_MOUNT_PATH = "/etc/pki/tls/custom-certs"
TRUSTED_CA_BUNDLE_FILE = "ca-bundle.crt"
CA_BUNDLE_ENV_VARS = (
    "PIP_CERT",
    "REQUESTS_CA_BUNDLE",
    "SSL_CERT_FILE",
    "PIPELINES_SSL_SA_CERTS",
    "GIT_SSL_CAINFO",
)

# -- pipelines / Elyra (notebook_dspa_secret.go, notebook_rbac.go) ------------
ELYRA_SECRET_NAME = "ds-pipeline-config"
ELYRA_SECRET_KEY = "odh_dsp.json"
ELYRA_MOUNT_PATH = "/opt/app-root/runtimes"
ELYRA_VOLUME_NAME = "elyra-dsp-config"
PIPELINE_ROLEBINDING_PREFIX = "elyra-pipelines-"
PIPELINE_ROLE_NAME = "ds-pipeline-user-access-dspa"
RUNTIME_IMAGES_CONFIGMAP = "pipeline-runtime-images"
RUNTIME_IMAGES_VOLUME = "runtime-images"
RUNTIME_IMAGES_MOUNT_PATH = "/opt/app-root/pipeline-runtimes"

# -- Feast (notebook_feast_config.go:26-29) -----------------------------------
FEAST_CONFIGMAP_SUFFIX = "-feast-config"
FEAST_VOLUME_NAME = "feast-config"
FEAST_MOUNT_PATH = "/opt/app-root/src/feast-config"

# -- MLflow (notebook_mlflow.go) ----------------------------------------------
MLFLOW_ROLEBINDING_SUFFIX = "-mlflow"
MLFLOW_CLUSTER_ROLE = "mlflow-operator-mlflow-integration"
MLFLOW_TRACKING_URI_ENV = "MLFLOW_TRACKING_URI"
MLFLOW_K8S_INTEGRATION_ENV = "MLFLOW_K8S_INTEGRATION"
MLFLOW_TRACKING_AUTH_ENV = "MLFLOW_TRACKING_AUTH"
MLFLOW_TRACKING_AUTH_VALUE = "kubernetes-namespaced"

# -- cluster proxy env (notebook_mutating_webhook.go:473-490) -----------------
PROXY_ENV_VARS = ("HTTP_PROXY", "HTTPS_PROXY", "NO_PROXY")
