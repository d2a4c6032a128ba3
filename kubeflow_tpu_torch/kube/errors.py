"""API error model mirroring apimachinery's StatusError reasons.

The port's copy of kubeflow_tpu/kube/errors.py.

The reference leans on k8s error predicates (apierrs.IsNotFound,
retry.RetryOnConflict) throughout, e.g.
components/notebook-controller/controllers/culling_controller.go:107,125,144.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, TypeVar


class ApiError(Exception):
    reason = "Unknown"

    def __init__(self, message: str = ""):
        super().__init__(message or self.reason)
        self.message = message or self.reason


class NotFoundError(ApiError):
    reason = "NotFound"


class AlreadyExistsError(ApiError):
    reason = "AlreadyExists"


class ConflictError(ApiError):
    reason = "Conflict"


class InvalidError(ApiError):
    reason = "Invalid"


class ForbiddenError(ApiError):
    reason = "Forbidden"


class GoneError(ApiError):
    """HTTP 410: requested watch resourceVersion fell out of the history
    window — the client must relist (client-go reflector does the same)."""

    reason = "Expired"


class ServerError(ApiError):
    """Transport/5xx failure talking to a real apiserver."""

    reason = "InternalError"


def is_not_found(err: Exception) -> bool:
    return isinstance(err, NotFoundError)


def is_conflict(err: Exception) -> bool:
    return isinstance(err, ConflictError)


def is_already_exists(err: Exception) -> bool:
    return isinstance(err, AlreadyExistsError)


T = TypeVar("T")


def retry_on_conflict(
    fn: Callable[[], T],
    steps: int = 5,
    initial_backoff_s: float = 0.01,
    factor: float = 2.0,
    max_backoff_s: float = 0.25,
    jitter: float = 0.1,
    sleep_fn: Optional[Callable[[float], None]] = None,
) -> T:
    """Equivalent of retry.RetryOnConflict(retry.DefaultRetry, fn), with
    client-go's wait.Backoff semantics: capped exponential backoff plus
    jitter between attempts, so a conflict storm (optimistic-concurrency
    herd, injected 409s from a chaos plan) spreads out instead of
    hot-looping.  Steps mirror DefaultRetry (5 attempts); the cap keeps the
    worst case bounded (~0.6s total at the defaults).  `sleep_fn` is
    injectable for deterministic tests (defaults to time.sleep)."""
    backoff = initial_backoff_s
    sleep = sleep_fn if sleep_fn is not None else time.sleep
    last: Exception | None = None
    for attempt in range(steps):
        try:
            return fn()
        except ConflictError as err:
            last = err
            if backoff > 0 and attempt < steps - 1:
                delay = min(backoff, max_backoff_s)
                if jitter > 0:
                    delay *= 1.0 + jitter * random.random()
                sleep(delay)
                backoff *= factor
    assert last is not None
    raise last
