"""Culler function library: stop/activity annotation manipulation.

The port's copy of kubeflow_tpu/core/culler.py.

Port of pkg/culler/culler.go — still the home of the shared stop-annotation
helpers, which the ODH controller imports
(odh-notebook-controller/controllers/notebook_controller.go:35,146), plus the
idleness math (NotebookNeedsCulling, culler.go:409)."""

from __future__ import annotations

from typing import Optional

from ..kube import ObjectMeta
from ..utils.clock import Clock, parse_iso
from . import constants as C

KERNEL_EXECUTION_STATE_IDLE = "idle"
KERNEL_EXECUTION_STATE_BUSY = "busy"
KERNEL_EXECUTION_STATE_STARTING = "starting"


def stop_annotation_is_set(meta: ObjectMeta) -> bool:
    return C.STOP_ANNOTATION in meta.annotations


def set_stop_annotation(meta: ObjectMeta, clock: Clock) -> None:
    """Value is the cull timestamp (culler.go:119-137)."""
    meta.annotations[C.STOP_ANNOTATION] = clock.now_iso()


def remove_stop_annotation(meta: ObjectMeta) -> None:
    meta.annotations.pop(C.STOP_ANNOTATION, None)


def annotations_exist(meta: ObjectMeta) -> bool:
    return (
        C.LAST_ACTIVITY_ANNOTATION in meta.annotations
        and C.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION in meta.annotations
    )


def initialize_annotations(meta: ObjectMeta, clock: Clock) -> None:
    now = clock.now_iso()
    meta.annotations[C.LAST_ACTIVITY_ANNOTATION] = now
    meta.annotations[C.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION] = now


def remove_activity_annotations(meta: ObjectMeta) -> None:
    meta.annotations.pop(C.LAST_ACTIVITY_ANNOTATION, None)
    meta.annotations.pop(C.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION, None)
    remove_checkpoint_annotations(meta)


def remove_checkpoint_annotations(meta: ObjectMeta) -> None:
    """Both sides of the checkpoint handshake: a stale checkpoint-complete
    from a previous cull cycle must not bypass the next grace window."""
    meta.annotations.pop(C.ANNOTATION_CHECKPOINT_REQUESTED, None)
    meta.annotations.pop(C.ANNOTATION_CHECKPOINT_COMPLETE, None)


def _parse(ts: Optional[str]) -> Optional[float]:
    if not ts:
        return None
    try:
        return parse_iso(ts)
    except ValueError:
        return None


def all_kernels_idle(kernels: list[dict]) -> bool:
    """allKernelsAreIdle (culling_controller.go:324-336)."""
    return all(
        k.get("execution_state") == KERNEL_EXECUTION_STATE_IDLE for k in kernels
    )


def most_recent_time(timestamps: list[str]) -> Optional[str]:
    """getNotebookRecentTime (:341-361): None on any unparsable entry."""
    parsed = []
    for t in timestamps:
        p = _parse(t)
        if p is None:
            return None
        parsed.append((p, t))
    if not parsed:
        return None
    return max(parsed)[1]


def update_last_activity_from_kernels(
    meta: ObjectMeta, kernels: Optional[list[dict]], clock: Clock
) -> None:
    """updateTimestampFromKernelsActivity (:380-411): a busy kernel bumps
    last-activity to now; otherwise take the most recent kernel
    last_activity, never moving backwards in time."""
    if not kernels:
        return
    if not all_kernels_idle(kernels):
        meta.annotations[C.LAST_ACTIVITY_ANNOTATION] = clock.now_iso()
        return
    recent = most_recent_time([k.get("last_activity", "") for k in kernels])
    _advance_last_activity(meta, recent)


def update_last_activity_from_terminals(
    meta: ObjectMeta, terminals: Optional[list[dict]], clock: Clock
) -> None:
    """updateTimestampFromTerminalsActivity (:413-448)."""
    if not terminals:
        return
    recent = most_recent_time([t.get("last_activity", "") for t in terminals])
    _advance_last_activity(meta, recent)


def _advance_last_activity(meta: ObjectMeta, recent: Optional[str]) -> None:
    if recent is None:
        return
    current = _parse(meta.annotations.get(C.LAST_ACTIVITY_ANNOTATION))
    candidate = _parse(recent)
    if candidate is None:
        return
    if current is not None and current > candidate:
        return  # never move backwards (compareAnnotationTimeToResource :363)
    meta.annotations[C.LAST_ACTIVITY_ANNOTATION] = recent


def update_last_culling_check_timestamp(meta: ObjectMeta, clock: Clock) -> None:
    meta.annotations[C.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION] = clock.now_iso()


def culling_check_period_has_passed(
    meta: ObjectMeta, clock: Clock, period_min: int
) -> bool:
    """cullingCheckPeriodHasPassed (:206-218)."""
    stored = _parse(meta.annotations.get(C.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION))
    if stored is None:
        return False
    return stored + period_min * 60 < clock.now()


def notebook_is_idle(meta: ObjectMeta, clock: Clock, cull_idle_min: int) -> bool:
    """notebookIsIdle (:221-242)."""
    if stop_annotation_is_set(meta):
        return False
    last = _parse(meta.annotations.get(C.LAST_ACTIVITY_ANNOTATION))
    if last is None:
        return False
    return clock.now() > last + cull_idle_min * 60
