"""Constants the GPU workload renderer and the controllers need.

The port's copy of the part of kubeflow_tpu/core/constants.py that
core/{workload,notebook_controller,culling_controller,culler,selfheal,
scheduler,preemption}.py, kube/cluster.py and odh/ read, plus the GPU's resource, the GPU
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
ANNOTATION_REWRITE_URI = "notebooks.kubeflow.org/http-rewrite-uri"
ANNOTATION_HEADERS_REQUEST_SET = "notebooks.kubeflow.org/http-headers-request-set"
LAST_ACTIVITY_ANNOTATION = "notebooks.kubeflow.org/last-activity"
LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION = (
    "notebooks.kubeflow.org/last_activity_check_timestamp"
)
# set while a pre-cull checkpoint has been requested; the in-notebook
# runtime acknowledges with checkpoint-complete
ANNOTATION_CHECKPOINT_REQUESTED = "notebooks.kubeflow.org/checkpoint-requested"
ANNOTATION_CHECKPOINT_COMPLETE = "notebooks.kubeflow.org/checkpoint-complete"
# voluntary migration request (drain/defrag): the recovery engine runs
# the snapshot -> gang restart -> restore verb it uses for disruption, no
# failure required, and clears the annotation once handled.  The value is
# the trigger ("drain" or "defrag"; anything else reads as "drain").
ANNOTATION_MIGRATE = "notebooks.kubeflow.org/migrate"
# stamped onto a worker pod by the kubelet-side runtime after it restored
# the session checkpoint its CHECKPOINT_RESTORE_* env names
ANNOTATION_RESTORED_GENERATION = "notebooks.kubeflow.org/restored-generation"
ANNOTATION_RESTORED_DIGEST = "notebooks.kubeflow.org/restored-digest"
# replicated-kernel tier (spec.replication, core/selfheal.py's promote
# verb): each follower pod's runtime stamps how far it has replayed the
# checkpoint-delta stream, and the promote verb elects the freshest
# caught-up follower off these stamps
ANNOTATION_REPLICA_GENERATION = "notebooks.kubeflow.org/replica-generation"
ANNOTATION_REPLICA_SEQ = "notebooks.kubeflow.org/replica-seq"
ANNOTATION_REPLICA_DIGEST = "notebooks.kubeflow.org/replica-digest"
# the scheduler's all-or-nothing placement intent: JSON {"v": 1,
# "slices": {"<gang>": {"pool": ..., "nodes": [...]}}}; the renderer turns
# each gang's pool assignment into a nodeSelector
ANNOTATION_PLACEMENT = "notebooks.kubeflow.org/placement"
# admission-queue membership (core/scheduler.py's tenancy gate), set while
# a gang is held back by quota or fair share.  Value is JSON
# {"since": <clock>, "priority": <class>, "reason": "quota"|"fair-share"|
# "ordered"|"preempted"}: `since` feeds the aged fair-share dequeue score.
# It contains "notebooks.kubeflow.org", so the renderer never copies it
# onto pods.
ANNOTATION_QUEUED = "notebooks.kubeflow.org/queued"

# cluster-scoped tenancy policy and write-ahead preemption bookkeeping
# object: spec holds the per-namespace GPU quota (`chipQuota`, in
# accelerator devices), fair-share weight and default priority;
# status.preemptions holds in-flight preemption records, written before
# any teardown so that a manager crash resumes, never repeats, an
# eviction.  Singleton named TENANTQUOTA_NAME.
TENANTQUOTA_KIND = "TenantQuota"
TENANTQUOTA_NAME = "default"
PREEMPTION_PENDING = "Pending"
PREEMPTION_DONE = "Done"

# warm-pool bookkeeping object (core/scheduler.py): one cluster-scoped
# GPUWarmPool per accelerator and GPU count; claim and release state lives
# in its status, so it survives a manager crash and a leader failover
WARMPOOL_KIND = "GPUWarmPool"
WARMSLICE_PROVISIONING = "Provisioning"
WARMSLICE_READY = "Ready"
WARMSLICE_CLAIMED = "Claimed"
WARMSLICE_STATES = (WARMSLICE_PROVISIONING, WARMSLICE_READY,
                    WARMSLICE_CLAIMED)

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
