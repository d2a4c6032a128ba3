"""Constants the GPU workload renderer and the controllers need.

The port's copy of the part of kubeflow_tpu/core/constants.py that
core/{workload,notebook_controller,culling_controller,culler}.py,
kube/cluster.py and odh/network.py read, plus the GPU's resource, the GPU
node's labels, the pod-index label and the checkpoint hook's writable
signal directory.
"""

DEFAULT_CONTAINER_PORT = 8888
DEFAULT_SERVING_PORT = 80
DEFAULT_FSGROUP = 100
MAX_STATEFULSET_NAME_LENGTH = 52  # name + controller hash must fit 63 chars

# annotations (user-facing API surface)
STOP_ANNOTATION = "kubeflow-resource-stopped"
ANNOTATION_NOTEBOOK_RESTART = "notebooks.opendatahub.io/notebook-restart"
LAST_ACTIVITY_ANNOTATION = "notebooks.kubeflow.org/last-activity"
LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION = (
    "notebooks.kubeflow.org/last_activity_check_timestamp"
)
# set while a pre-cull checkpoint has been requested; the in-notebook
# runtime acknowledges with checkpoint-complete
ANNOTATION_CHECKPOINT_REQUESTED = "notebooks.kubeflow.org/checkpoint-requested"
ANNOTATION_CHECKPOINT_COMPLETE = "notebooks.kubeflow.org/checkpoint-complete"
# the scheduler's all-or-nothing placement intent: JSON {"v": 1,
# "slices": {"<gang>": {"pool": ..., "nodes": [...]}}}; the renderer turns
# each gang's pool assignment into a nodeSelector
ANNOTATION_PLACEMENT = "notebooks.kubeflow.org/placement"

# checkpoint-sidecar contract: env rendered into every worker when
# CHECKPOINT_STORE_URI is configured (consumed by runtime/checkpoint.py)
ENV_CHECKPOINT_STORE_URI = "CHECKPOINT_STORE_URI"
ENV_CHECKPOINT_INTERVAL_S = "CHECKPOINT_INTERVAL_S"
# restore stamping: written into the recreated pods of a migrated gang
ENV_CHECKPOINT_RESTORE_URI = "CHECKPOINT_RESTORE_URI"
ENV_CHECKPOINT_RESTORE_GENERATION = "CHECKPOINT_RESTORE_GENERATION"
# the writable directory the pre-stop hook writes its checkpoint request
# into and reads the acknowledgement from: the downward-API mount
# (/etc/podinfo) is read-only, so the hook gets an emptyDir of its own
ENV_CHECKPOINT_SIGNAL_DIR = "CHECKPOINT_SIGNAL_DIR"
CHECKPOINT_SIGNAL_VOLUME = "checkpoint-signal"
CHECKPOINT_SIGNAL_MOUNT = "/var/run/checkpoint-signal"
PODINFO_MOUNT = "/etc/podinfo"

# replication contract: role/epoch env rendered into every worker of a
# replicated notebook
ENV_REPLICATION_ROLE = "REPLICATION_ROLE"
ENV_REPLICATION_EPOCH = "REPLICATION_EPOCH"
ENV_REPLICA_INDEX = "REPLICA_INDEX"
ROLE_PRIMARY = "primary"
ROLE_FOLLOWER = "follower"

# labels
WORKBENCH_LABEL = "opendatahub.io/workbenches"
NOTEBOOK_NAME_LABEL = "notebook-name"
STATEFULSET_LABEL = "statefulset"
REPLICA_LABEL = "notebooks.kubeflow.org/replica"
# the StatefulSet controller's ordinal label on each pod, which torchrun's
# PET_NODE_RANK reads through the downward API
POD_INDEX_LABEL = "apps.kubernetes.io/pod-index"

# env var injected into the notebook container
PREFIX_ENV_VAR = "NB_PREFIX"

# GKE node labels and the device plugin's resource
GKE_GPU_ACCELERATOR_LABEL = "cloud.google.com/gke-accelerator"
GKE_NODEPOOL_LABEL = "cloud.google.com/gke-nodepool"
GPU_RESOURCE = "nvidia.com/gpu"

# torchrun's rendezvous port (PET_MASTER_PORT), where its agent store
# listens on worker 0; the headless Service names it torch-rendezvous
TORCH_RENDEZVOUS_PORT = 29500

# the pod's termination grace period when neither the CR's pod template
# nor the controller sets one (Kubernetes' default), and the seconds of it
# the pre-stop hook leaves for the SIGTERM that follows it
DEFAULT_TERMINATION_GRACE_PERIOD_S = 30
PRE_STOP_MARGIN_S = 5

# the gang's NetworkPolicy name (odh/network.py)
GPU_WORKER_NETWORK_POLICY_SUFFIX = "-gpu-workers-np"
