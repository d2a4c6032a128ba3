"""Culling controller: idle detection -> scale-to-zero, for GPU gangs.

The port of kubeflow_tpu/core/culling_controller.py (the reference's
CullingReconciler, culling_controller.go:73-588).  Culling is
gang-atomic by construction: the stop annotation scales the gang's
StatefulSet to zero, so a partial stop cannot exist.  Worker 0 of gang 0
runs the Jupyter server (`gpu/env.py:statefulset_name`).  The optional
checkpoint-before-cull handshake applies to `spec.gpu` notebooks: on the
first idle verdict the culler writes the port's cull-signal request
(runtime/checkpoint.py `REQUEST_FILE`) under
`checkpoint_signal_root/<namespace>/<name>`, and holds the cull until the
training loop's `CullSignalWatcher` acknowledges there (`ACK_FILE`), the
checkpoint-complete annotation lands, or one idleness period passes.
The reference's hold while a preemption of the notebook is pending comes
with the preemption engine (`ROADMAP.md` queue 1 item 13).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

from ..api.types import Notebook
from ..gpu import env as gpuenv
from ..kube import ApiServer, Manager, Request, Result, retry_on_conflict
from ..runtime.checkpoint import ACK_FILE, REQUEST_FILE
from ..utils import tracing
from ..utils.clock import Clock, parse_iso
from ..utils.config import CoreConfig
from . import constants as C
from . import culler
from .jupyter import JupyterAPI
from .metrics import NotebookMetrics

logger = logging.getLogger("kubeflow_tpu_torch.culling")

_TRACER = tracing.get_tracer("kubeflow_tpu_torch.core.culling")

# annotation the in-notebook runtime sets once its pre-cull checkpoint is done
CHECKPOINT_COMPLETE_ANNOTATION = C.ANNOTATION_CHECKPOINT_COMPLETE


class CullingReconciler:
    def __init__(
        self,
        api: ApiServer,
        cfg: CoreConfig,
        jupyter: JupyterAPI,
        metrics: NotebookMetrics,
        clock: Optional[Clock] = None,
        cache=None,
    ):
        self.api = api
        self.cfg = cfg
        self.jupyter = jupyter
        self.metrics = metrics
        self.clock = clock or Clock()
        # informer cache for probe-path reads (pod-0 existence, period
        # gate); annotation writes still read-modify-write the live object
        self.cache = cache

    def _requeue(self) -> Result:
        return Result(requeue_after=self.cfg.idleness_check_period_min * 60)

    def reconcile(self, req: Request) -> Result:
        obj = self.api.try_get("Notebook", req.namespace, req.name)
        if obj is None:
            return Result()
        nb = Notebook(obj.to_dict())

        # already stopping: drop activity annotations, no requeue (:105-118)
        if culler.stop_annotation_is_set(obj.metadata):
            self._mutate(req, culler.remove_activity_annotations)
            return Result()

        # worker-0 pod of gang 0 runs the Jupyter server; without it there
        # is nothing to probe (:121-136)
        sts0 = gpuenv.statefulset_name(nb.name, 0, 1)
        reader = self.cache if self.cache is not None else self.api
        pod0 = reader.try_get("Pod", req.namespace, f"{sts0}-0")
        if pod0 is None:
            self._mutate(req, culler.remove_activity_annotations)
            return Result()

        # initialize annotations (:142-154)
        if not culler.annotations_exist(obj.metadata):
            self._mutate(
                req, lambda meta: culler.initialize_annotations(meta, self.clock)
            )

        # period gate (:157-160) — cache read: the common case is "period
        # not passed yet", which must not cost an API round trip
        live = reader.try_get("Notebook", req.namespace, req.name)
        if live is None:
            return Result()
        if not culler.culling_check_period_has_passed(
            live.metadata, self.clock, self.cfg.idleness_check_period_min
        ):
            return self._requeue()

        # idle probe + cull decision under a 'culling' phase span, so a
        # trace shows whether an idle notebook was culled, held for a
        # checkpoint, or found active again
        with _TRACER.start_span(
            "culling", {"phase": "culling", "namespace": req.namespace,
                        "notebook": req.name}
        ) as span:
            # probe Jupyter outside the retry loop (:163-169)
            kernels = self.jupyter.get_kernels(req.name, req.namespace)
            terminals = self.jupyter.get_terminals(req.name, req.namespace)

            def apply(meta) -> None:
                culler.update_last_activity_from_kernels(meta, kernels, self.clock)
                culler.update_last_activity_from_terminals(meta, terminals, self.clock)
                culler.update_last_culling_check_timestamp(meta, self.clock)
                if not culler.notebook_is_idle(
                    meta, self.clock, self.cfg.cull_idle_time_min
                ):
                    # activity resumed: reset the checkpoint handshake so the
                    # next idle period gets a fresh request + grace window
                    culler.remove_checkpoint_annotations(meta)
                    self._clear_cull_signal(nb)
                else:
                    if self._should_wait_for_checkpoint(nb, meta):
                        span.add_event("culling.checkpoint_wait")
                        return
                    logger.info("culling notebook %s/%s", req.namespace, req.name)
                    span.add_event("notebook.culled")
                    self._clear_cull_signal(nb)
                    culler.set_stop_annotation(meta, self.clock)
                    self.metrics.culling.labels(req.namespace, req.name).inc()
                    self.metrics.last_culling_timestamp.labels(
                        req.namespace, req.name
                    ).set(self.clock.now())

            self._mutate(req, apply)
        return self._requeue()

    def _should_wait_for_checkpoint(self, nb: Notebook, meta) -> bool:
        """Checkpoint-before-cull handshake (GPU gangs, off by default):
        on the first idle verdict, stamp checkpoint-requested — and, when a
        signal root is configured (CHECKPOINT_SIGNAL_ROOT), write the
        actual cull-signal request file the in-pod CullSignalWatcher
        polls, so checkpoint-on-cull genuinely fires.  The cull then holds
        until the runtime acknowledges (ack file or checkpoint-complete
        annotation) or the grace window (one idleness period) expires —
        only after that does the stop annotation land and the gang
        transition toward Stopping."""
        if not (self.cfg.checkpoint_before_cull and nb.gpu is not None):
            return False
        requested = meta.annotations.get(C.ANNOTATION_CHECKPOINT_REQUESTED)
        if requested is None:
            meta.annotations[C.ANNOTATION_CHECKPOINT_REQUESTED] = (
                self.clock.now_iso()
            )
            self._write_cull_signal(nb)
            return True
        if self._checkpoint_acknowledged(nb, meta):
            return False
        try:
            grace_end = parse_iso(requested) + self.cfg.idleness_check_period_min * 60
        except ValueError:
            return False
        return self.clock.now() < grace_end

    # -- cull-signal file transport (runtime/checkpoint.py contract) -----------
    def _signal_dir(self, nb: Notebook):
        if not self.cfg.checkpoint_signal_root:
            return None
        return Path(self.cfg.checkpoint_signal_root) / nb.namespace / nb.name

    def _write_cull_signal(self, nb: Notebook) -> None:
        d = self._signal_dir(nb)
        if d is None:
            return
        try:
            d.mkdir(parents=True, exist_ok=True)
            (d / REQUEST_FILE).write_text("true")
        except OSError:
            logger.warning("could not write cull signal under %s", d)

    def _checkpoint_acknowledged(self, nb: Notebook, meta) -> bool:
        """Either side of the transport counts: the checkpoint-complete
        annotation (downward-API-less runtimes PATCH it directly) or the
        ack file next to the signal request."""
        if C.ANNOTATION_CHECKPOINT_COMPLETE in meta.annotations:
            return True
        d = self._signal_dir(nb)
        if d is None:
            return False
        if not (d / ACK_FILE).exists():
            return False
        # mirror the ack into the annotation so the decision is visible on
        # the CR (and survives signal-dir cleanup), and account the
        # snapshot exactly once
        meta.annotations[C.ANNOTATION_CHECKPOINT_COMPLETE] = \
            self.clock.now_iso()
        self.metrics.checkpoint_snapshots.labels(
            nb.namespace, "cull").inc()
        return True

    def _clear_cull_signal(self, nb: Notebook) -> None:
        """Activity resumed (or the cull completed): retire both signal
        files so a stale request/ack never leaks into the next idle
        cycle — the file-transport twin of remove_checkpoint_annotations."""
        d = self._signal_dir(nb)
        if d is None:
            return
        for name in (REQUEST_FILE, ACK_FILE):
            try:
                (d / name).unlink()
            except OSError:
                pass

    def _mutate(self, req: Request, fn) -> None:
        """Read-modify-write on the CR metadata with conflict retry — the
        reference wraps every annotation write the same way
        (culling_controller.go:107,125,144,172)."""

        def attempt() -> None:
            live = self.api.get("Notebook", req.namespace, req.name)
            before = dict(live.metadata.annotations)
            fn(live.metadata)
            if live.metadata.annotations != before:
                self.api.update(live)

        retry_on_conflict(attempt)


def setup_culling(
    mgr: Manager,
    cfg: Optional[CoreConfig] = None,
    jupyter: Optional[JupyterAPI] = None,
    metrics: Optional[NotebookMetrics] = None,
) -> Optional[CullingReconciler]:
    """Register the culler, gated on ENABLE_CULLING (main.go:111-123)."""
    cfg = cfg or CoreConfig.from_env()
    if not cfg.enable_culling:
        return None
    if jupyter is None:
        from .jupyter import HttpJupyterClient

        jupyter = HttpJupyterClient(cfg.cluster_domain, cfg.dev)
    metrics = metrics or NotebookMetrics(mgr.api)
    rec = CullingReconciler(mgr.api, cfg, jupyter, metrics, clock=mgr.clock,
                            cache=mgr.cache)
    from ..kube import suppress_status_only

    # the culler keys off annotations + pod liveness, never Notebook
    # status: the notebook controller's status writes must not wake it
    mgr.register("culling", rec, for_kind="Notebook",
                 for_predicate=suppress_status_only)
    return rec


__all__ = ["CHECKPOINT_COMPLETE_ANNOTATION", "CullingReconciler",
           "setup_culling"]
