"""In-memory Kubernetes control-plane substrate (apiserver + controller
runtime + fake data plane) that the GPU notebook controllers run against:
the port's copy of kubeflow_tpu/kube.  Leader election, the sharded
fleet, the wire protocol, the real-cluster client, server-side apply and
fault plans are not ported yet (`ROADMAP.md` queue 1 item 17)."""

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
from .meta import (
    KubeObject,
    ObjectMeta,
    OwnerReference,
    new_uid,
    set_controller_reference,
)
from .store import (
    AdmissionDenied,
    AdmissionHook,
    ApiServer,
    EventType,
    WatchEvent,
)

__all__ = [
    "AdmissionDenied",
    "AdmissionHook",
    "AlreadyExistsError",
    "ApiError",
    "ApiServer",
    "BucketRateLimiter",
    "ConflictError",
    "EventRecorder",
    "EventType",
    "FakeCluster",
    "ForbiddenError",
    "GoneError",
    "InformerCache",
    "InvalidError",
    "ItemExponentialBackoff",
    "KubeObject",
    "Manager",
    "MaxOfRateLimiter",
    "NotFoundError",
    "ObjectMeta",
    "OwnerReference",
    "Reconciler",
    "Request",
    "Result",
    "ServerError",
    "WatchEvent",
    "WatchSpec",
    "default_rate_limiter",
    "is_already_exists",
    "is_conflict",
    "is_not_found",
    "is_status_only_update",
    "new_uid",
    "parse_quantity",
    "retry_on_conflict",
    "set_controller_reference",
    "suppress_status_only",
]
