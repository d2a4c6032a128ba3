"""In-memory Kubernetes control-plane substrate (apiserver + controller
runtime + fake data plane) that the GPU notebook controllers run against:
the port's copy of kubeflow_tpu/kube, with the real-cluster backend:
the patch verbs, fault plans, the wire apiserver (`wire.py`), the REST
client (`client.py`), certs and leader election, and the sharded fleet
(`shard.py`: the fenced shard map, its handoff and N manager replicas)."""

from .cache import InformerCache
from .cluster import FakeCluster, parse_quantity
from .controller import (
    BucketRateLimiter,
    ItemExponentialBackoff,
    Manager,
    MaxOfRateLimiter,
    Reconciler,
    Request,
    Result,
    WatchSpec,
    default_rate_limiter,
    is_status_only_update,
    suppress_status_only,
)
from .errors import (
    AlreadyExistsError,
    ApiError,
    ConflictError,
    ForbiddenError,
    GoneError,
    InvalidError,
    NotFoundError,
    ServerError,
    is_already_exists,
    is_conflict,
    is_not_found,
    retry_on_conflict,
)
from .events import EventRecorder
from .faults import FaultPlan, FaultRecord, FaultRule, random_fault_plan
from .leader import FencingToken, LeaderElector, StaleEpochError
from .meta import (
    KubeObject,
    ObjectMeta,
    OwnerReference,
    new_uid,
    set_controller_reference,
)
from .shard import (
    FencedApi,
    HashRing,
    ShardedFleet,
    ShardedReplica,
    ShardMember,
)
from .store import (
    AdmissionDenied,
    AdmissionHook,
    ApiServer,
    AuditRecord,
    EventType,
    WatchEvent,
)

__all__ = [
    "AdmissionDenied",
    "AdmissionHook",
    "AlreadyExistsError",
    "ApiError",
    "ApiServer",
    "AuditRecord",
    "BucketRateLimiter",
    "ConflictError",
    "EventRecorder",
    "EventType",
    "FakeCluster",
    "FaultPlan",
    "FaultRecord",
    "FaultRule",
    "FencedApi",
    "FencingToken",
    "ForbiddenError",
    "GoneError",
    "HashRing",
    "InformerCache",
    "InvalidError",
    "ItemExponentialBackoff",
    "KubeObject",
    "LeaderElector",
    "Manager",
    "MaxOfRateLimiter",
    "NotFoundError",
    "ObjectMeta",
    "OwnerReference",
    "Reconciler",
    "Request",
    "Result",
    "ServerError",
    "ShardMember",
    "ShardedFleet",
    "ShardedReplica",
    "StaleEpochError",
    "WatchEvent",
    "WatchSpec",
    "default_rate_limiter",
    "is_already_exists",
    "is_conflict",
    "is_not_found",
    "is_status_only_update",
    "new_uid",
    "parse_quantity",
    "random_fault_plan",
    "retry_on_conflict",
    "set_controller_reference",
    "suppress_status_only",
]
