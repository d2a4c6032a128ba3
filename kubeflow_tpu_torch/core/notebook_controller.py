"""Core Notebook reconciler: CR -> StatefulSet/Service(s)/status, for GPUs.

The port of kubeflow_tpu/core/notebook_controller.py (the reference's
NotebookReconciler, notebook_controller.go:79-826).  A CPU notebook gets
the reference's one StatefulSet and Service; a `spec.gpu` notebook gets
its gang's indexed StatefulSet and the headless Service, rendered by
core/workload.py.  The reconciler works on the store's `KubeObject`s;
the renderer takes the CR as a dict and returns dicts, and `_render` is
the one place that converts between the two.  `workerStates` and
`sliceHealth` are computed over the gang's pods under the reference's
status names, so the same clients read them.  Stop, cull and the restart
annotation act on the whole gang.  After the status pass and the restart
annotation, the self-healing engine (core/selfheal.py) runs its recovery
pass over the gang, with the session-state store opened from
`CHECKPOINT_STORE_URI` for its migrate verb.  Event re-emission lives in
its own controller, as in the reference.  Admission is the schema hook
of api/validation.py (the reference's structural checks on `spec.gpu`),
then a refusal of `spec.tpu`, which this port does not serve.

With ENABLE_SLICE_SCHEDULER on, the gang scheduler and the tenancy layer
(core/scheduler.py, core/preemption.py) own placement: a GPU notebook
renders no StatefulSet until the scheduler's all-or-nothing placement
intent covers its gang (the gang gate), and until then reads
`sliceHealth` "Scheduling", or "Queued" while the admission gate parks
it.

A replicated notebook (`spec.replication`) renders one gang per replica;
readiness and `sliceHealth` speak for the primary replica's gang only
(a follower is redundancy, not capacity), `status.replication` is seeded
`{"epoch": 1, "primary": 0}` and survives every status rewrite, and the
session store's fenced writes are counted into
`notebook_replication_fenced_writes_total`.

With USE_ISTIO on, the notebook also gets its Istio VirtualService
(core/workload.py:generate_virtual_service), owned like its Services.
"""

from __future__ import annotations

import copy
import logging
from collections import OrderedDict
from typing import Optional

from ..api.types import (
    CONDITION_RECOVERY_EXHAUSTED,
    Notebook,
    notebook_status,
)
from ..api.validation import install_notebook_schema
from ..common import reconcilehelper as rh
from ..kube import (
    AdmissionDenied,
    AdmissionHook,
    ApiServer,
    EventRecorder,
    KubeObject,
    Manager,
    NotFoundError,
    Request,
    Result,
    WatchSpec,
    default_rate_limiter,
    retry_on_conflict,
    set_controller_reference,
    suppress_status_only,
)
from ..utils import tracing
from ..utils.clock import Clock
from ..utils.config import CoreConfig
from . import constants as C
from .metrics import NotebookMetrics
from .scheduler import placement_covers, setup_scheduler
from .selfheal import RecoveryEngine, SliceRestartError
from .sessionstate import SessionStateStore, open_store
from .workload import (
    WorkloadConfig,
    generate_headless_service,
    generate_service,
    generate_statefulsets,
    generate_virtual_service,
)

logger = logging.getLogger("kubeflow_tpu_torch.core")

# phase child spans (render/apply/status) parent onto the manager's
# per-attempt reconcile root span via the shared context stack
_TRACER = tracing.get_tracer("kubeflow_tpu_torch.core.notebook")

def _refuse_tpu(op: str, old: Optional[KubeObject],
                obj: KubeObject) -> None:
    """What this port does not serve, after the schema hook
    (api/validation.py) has admitted the CR: a TPU slice (`spec.tpu`)."""
    if (obj.body.get("spec") or {}).get("tpu"):
        raise AdmissionDenied(
            "spec.tpu: this controller runs GPU gangs (spec.gpu); TPU "
            "slices are served by kubeflow_tpu")


def workload_config(cfg: CoreConfig) -> WorkloadConfig:
    """The renderer's settings from the controller's config."""
    return WorkloadConfig(add_fsgroup=cfg.add_fsgroup,
                          checkpoint_store_uri=cfg.checkpoint_store_uri,
                          checkpoint_interval_s=cfg.checkpoint_interval_s)


class NotebookReconciler:
    def __init__(
        self,
        api: ApiServer,
        cfg: CoreConfig,
        metrics: NotebookMetrics,
        recorder: Optional[EventRecorder] = None,
        clock: Optional[Clock] = None,
        cache=None,
        session: Optional[SessionStateStore] = None,
    ):
        self.api = api
        self.cfg = cfg
        self.workload_cfg = workload_config(cfg)
        self.metrics = metrics
        self.recorder = recorder or EventRecorder(api, "notebook-controller")
        self.clock = clock or Clock()
        # indexed informer cache (kube.InformerCache): owned StatefulSets by
        # owner uid, worker pods by label index.  None falls back to live
        # reads (direct-construction unit tests).
        self.cache = cache
        # session-state store: when wired (an explicit store, or
        # CHECKPOINT_STORE_URI in config, the same store the pods'
        # checkpoint sidecars write), the recovery engine prefers the
        # migrate verb over bare gang restarts
        if session is None and cfg.checkpoint_store_uri:
            session = open_store(cfg.checkpoint_store_uri, clock=self.clock)
        self.session = session
        # every fence rejection (a demoted primary still trying to write)
        # is counted: the zombie was stopped, not merely absent
        if session is not None:
            session.on_fenced_write = (
                lambda ns, _name: metrics.replication_fenced_writes
                .labels(ns).inc())
        # gang-atomic self-healing, its bookkeeping persisted on the CR
        self.recovery = RecoveryEngine(api, cfg, metrics, self.recorder,
                                       clock=self.clock, cache=cache,
                                       session=session)
        # first-readiness tracking for the notebook_to_ready_seconds
        # histogram: first-seen clock time per live notebook (keyed by uid
        # so a delete+recreate measures afresh), dropped once observed
        self._first_seen: dict[tuple, float] = {}
        self._ready_observed: set[tuple] = set()  # per (uid-key, generation)
        self._ready_measured: set[tuple[str, str, str]] = set()  # per uid

    def _render(self, nb: Notebook,
                obj: KubeObject) -> tuple[list[KubeObject], list[KubeObject]]:
        """The renderer's dicts as owned KubeObjects: the workload
        StatefulSets, then the Services (the headless one for a gang) and,
        under USE_ISTIO, the VirtualService."""
        sets = [KubeObject.from_dict(d)
                for d in generate_statefulsets(nb, self.workload_cfg)]
        services = [KubeObject.from_dict(generate_service(nb))]
        if nb.gpu is not None:
            services.append(KubeObject.from_dict(generate_headless_service(nb)))
        if self.cfg.use_istio:
            services.append(KubeObject.from_dict(
                generate_virtual_service(nb, self.cfg)))
        for owned in sets + services:
            set_controller_reference(obj, owned)
        return sets, services

    # -- main loop (reference Reconcile, notebook_controller.go:94-294) -------
    def reconcile(self, req: Request) -> Result:
        # primary read off the informer cache (controller-runtime's cached
        # client): the event that enqueued this request already updated it
        if self.cache is not None:
            obj = self.cache.get("Notebook", req.namespace, req.name)
        else:
            obj = self.api.try_get("Notebook", req.namespace, req.name)
        if obj is None:
            return Result()
        nb = Notebook(obj.to_dict())
        _TRACER.current_span().set_attribute(
            "generation", int(obj.metadata.generation or 1))
        # jupyter-web-app deletes with foreground policy: while terminating,
        # recreating owned objects would fight the API server (:138)
        if obj.metadata.deletion_timestamp is not None:
            return Result()

        # gang gate (core/scheduler.py): with the scheduler on, a GPU
        # notebook renders no workload until the all-or-nothing placement
        # intent covers every gang, so a half-placed gang never exists.
        # The scheduler's annotation write re-triggers this reconciler.
        if self.cfg.enable_slice_scheduler and nb.gpu is not None \
                and C.STOP_ANNOTATION not in nb.annotations:
            rep = nb.replication
            if not placement_covers(nb, rep.replicas if rep else 1):
                self._update_status(nb, obj, [], scheduling=True)
                return Result()

        with _TRACER.start_span("render",
                                {"phase": "render"}) as render_span:
            desired_sets, services = self._render(nb, obj)
            render_span.set_attribute("statefulsets", len(desired_sets))
        if self.cache is not None:
            existing = self.cache.by_index(
                "StatefulSet", "owner-uid", obj.metadata.uid)
        else:
            existing = [
                s
                for s in self.api.list("StatefulSet", namespace=req.namespace)
                if (ref := s.metadata.controller_owner()) is not None
                and ref.kind == "Notebook"
                and ref.uid == obj.metadata.uid
            ]
        live_names: list[str] = []
        errors: list[Exception] = []
        with _TRACER.start_span("apply", {"phase": "apply"}) as apply_span:
            self._apply_workload(req, desired_sets, existing, live_names,
                                 errors)
            if errors:
                apply_span.set_attribute("error", True)
                apply_span.add_event("apply.errors", {
                    "count": len(errors),
                    "first": str(errors[0]),
                })
                # best-effort truthful status over every existing STS,
                # then fail the reconcile so the manager's backoff retries
                names = live_names + [
                    s.name for s in existing if s.name not in live_names]
                try:
                    self._update_status(nb, obj, names)
                except Exception:  # noqa: BLE001 — the gang error wins
                    pass
                raise errors[0]

            # Services and the VirtualService (no-op detection against
            # the informer cache: a converged notebook costs zero API
            # calls per pass)
            for svc in services:
                rh.reconcile_object(
                    self.api, svc, rh.copy_spec
                    if svc.kind == "VirtualService"
                    else rh.copy_service_fields, cache=self.cache)

        self._update_status(nb, obj, live_names)

        # restart annotation (notebook_controller.go:259-294): for a gang,
        # delete every worker pod
        if self.cache is not None:
            fresh = self.cache.get("Notebook", req.namespace, req.name)
        else:
            fresh = self.api.try_get("Notebook", req.namespace, req.name)
        annotations = fresh.metadata.annotations if fresh is not None else {}
        if annotations.get(C.ANNOTATION_NOTEBOOK_RESTART) == "true":
            # raises after attempting the whole gang if any delete failed:
            # the annotation then survives for the retry
            self._restart_pods(nb, live_names)

            def clear() -> None:
                live = self.api.get("Notebook", req.namespace, req.name)
                live.metadata.annotations.pop(C.ANNOTATION_NOTEBOOK_RESTART,
                                              None)
                self.api.update(live)
            retry_on_conflict(clear)

        # self-healing pass, after the status pass (it keys off the slice
        # health just written) and after the restart annotation (an
        # operator's restart is not charged against the budget)
        requeue_s = self.recovery.maybe_recover(
            nb, live_names,
            pods_of=lambda name: self._pods_of(nb, name),
            restart_slice=lambda name: self._restart_pods(nb, [name]),
            stamp_restore=lambda name, idx: self._stamp_restore(
                nb, name, idx),
        )
        if requeue_s > 0:
            return Result(requeue_after=requeue_s)
        return Result()

    def _apply_workload(self, req, desired_sets, existing, live_names,
                        errors) -> None:
        """The workload half of the 'apply' phase: StatefulSet
        create/update, then pruning of owned sets no longer rendered;
        errors aggregate into `errors`."""
        existing_by_name = {s.name: s for s in existing}
        for desired in desired_sets:
            if desired.name:
                found = existing_by_name.get(desired.name)
            else:
                # generate-name (long CR name): one workload StatefulSet
                found = existing[0] if existing else None
            try:
                if found is None:
                    self.metrics.creation.labels(req.namespace).inc()
                    try:
                        live = self.api.create(desired)
                    except Exception:
                        self.metrics.fail_creation.labels(req.namespace).inc()
                        raise
                else:
                    # cache reads are shared frozen snapshots: drift
                    # correction mutates a private copy, never the cache
                    candidate = found.deepcopy()
                    if rh.copy_statefulset_fields(desired, candidate):
                        candidate = self.api.update(candidate)
                    live = candidate
            except Exception as err:  # noqa: BLE001 — aggregated below
                errors.append(err)
                continue
            live_names.append(live.name)

        # prune owned sets that are no longer rendered; skipped when a
        # create/update failed, since "failed to match" is not "extra"
        if not errors:
            for s in existing:
                if s.name not in live_names:
                    try:
                        self.api.delete("StatefulSet", req.namespace, s.name)
                    except NotFoundError:
                        pass
                    except Exception as err:  # noqa: BLE001
                        errors.append(err)

    # -- helpers ---------------------------------------------------------------
    def _pods_of(self, nb: Notebook, live_sts_name: str) -> list[KubeObject]:
        """Pods of a live StatefulSet, selected via its own selector (the
        pod labels carry the rendered statefulset name, which differs from
        the live name when generateName kicked in)."""
        if self.cache is not None:
            sts = self.cache.get("StatefulSet", nb.namespace, live_sts_name)
        else:
            sts = self.api.try_get("StatefulSet", nb.namespace, live_sts_name)
        if sts is None:
            return []
        selector = sts.spec.get("selector", {}).get("matchLabels", {})
        if not selector:
            return []
        if self.cache is not None:
            return self.cache.select("Pod", nb.namespace, selector)
        return self.api.list("Pod", namespace=nb.namespace,
                             label_selector=selector)

    def _restart_pods(self, nb: Notebook, live_names: list[str]) -> None:
        """Gang-atomic worker restart: delete every pod of every named
        StatefulSet, aggregating errors, and raise after the full sweep."""
        errors: list[Exception] = []
        attempted = 0
        for live_name in live_names:
            for pod in self._pods_of(nb, live_name):
                attempted += 1
                try:
                    self.api.delete("Pod", nb.namespace, pod.name)
                except NotFoundError:
                    pass
                except Exception as err:  # noqa: BLE001 — aggregated below
                    errors.append(err)
        if errors:
            raise SliceRestartError(errors, attempted)

    def _stamp_restore(self, nb: Notebook, live_name: str,
                       gang: int) -> None:
        """Sync the gang's live StatefulSet with the restore intent the
        recovery engine just wrote into status.sessionState: re-render the
        template (the renderer injects CHECKPOINT_RESTORE_URI/_GENERATION
        from the live status) and copy the owned fields onto the live
        object, so the pods the restart recreates boot with the restore
        env.  Reads the apiserver, not the cache: the write-ahead status
        update may be younger than the informer stream."""
        fresh = self.api.try_get("Notebook", nb.namespace, nb.name)
        if fresh is None:
            return
        desired_sets = generate_statefulsets(Notebook(fresh.to_dict()),
                                             self.workload_cfg)
        if gang >= len(desired_sets):
            return
        desired = KubeObject.from_dict(desired_sets[gang])
        set_controller_reference(fresh, desired)
        live = self.api.try_get("StatefulSet", nb.namespace, live_name)
        if live is None:
            return
        if rh.copy_statefulset_fields(desired, live):
            self.api.update(live)

    def _update_status(self, nb: Notebook, obj: KubeObject,
                       live_names: list[str],
                       scheduling: bool = False) -> None:
        with _TRACER.start_span("status", {"phase": "status"}) as span:
            self._compute_and_write_status(nb, obj, live_names, span,
                                           scheduling=scheduling)

    def _compute_and_write_status(self, nb: Notebook, obj: KubeObject,
                                  live_names: list[str], span,
                                  scheduling: bool = False) -> None:
        """Mirror pod conditions + container state into the CR
        (createNotebookStatus, notebook_controller.go:299-374); a GPU gang
        additionally gets per-worker states and its health.  Transitions
        land as events on the 'status' span, and the first time a notebook
        reaches full readiness notebook_to_ready_seconds observes the
        latency."""
        ready = 0
        worker_states: list[dict] = []
        conditions: list[dict] = []
        container_state: dict = {}
        gpu = nb.gpu
        expected_hosts = gpu.validate().num_hosts if gpu else 1
        annotations = obj.metadata.annotations

        # replication: readiness and health speak for the primary replica
        # only (a degraded follower must never flip a healthy primary's
        # notebook to Degraded); every replica's pods still land in
        # workerStates.  live_names is replica-major, one gang a replica.
        rep_spec = nb.replication
        primary = int((nb.status.get("replication") or {}).get(
            "primary", 0)) if rep_spec is not None else 0
        first_sts_name = live_names[primary] \
            if primary < len(live_names) else (
                live_names[0] if live_names else nb.name)
        for idx, live_name in enumerate(live_names):
            if self.cache is not None:
                sts = self.cache.get("StatefulSet", nb.namespace, live_name)
            else:
                sts = self.api.try_get("StatefulSet", nb.namespace, live_name)
            if sts is not None and (rep_spec is None or idx == primary):
                ready += int(sts.status.get("readyReplicas", 0) or 0)
            if gpu is not None:
                for pod in sorted(self._pods_of(nb, live_name),
                                  key=lambda p: p.name):
                    phase = pod.body.get("status", {}).get("phase", "Unknown")
                    pod_ready = any(
                        c.get("type") == "Ready" and c.get("status") == "True"
                        for c in pod.body.get("status", {}).get(
                            "conditions", [])
                    )
                    worker_states.append(
                        {"pod": pod.name, "phase": phase, "ready": pod_ready}
                    )

        # conditions + containerState mirror worker 0 (the Jupyter server)
        if self.cache is not None:
            pod0 = self.cache.get("Pod", nb.namespace, f"{first_sts_name}-0")
        else:
            pod0 = self.api.try_get("Pod", nb.namespace,
                                    f"{first_sts_name}-0")
        if pod0 is not None and pod0.body.get("status"):
            pstatus = pod0.body["status"]
            now = self.clock.now_iso()
            # reuse previous timestamps for unchanged conditions so the
            # computed status is idempotent (else every reconcile would
            # rewrite the defaulted times and requeue itself forever)
            prev = {
                c.get("type"): c
                for c in (nb.status.get("conditions") or [])
            }
            for podc in pstatus.get("conditions", []):
                cond = {
                    "type": podc.get("type", ""),
                    "status": podc.get("status", ""),
                }
                if podc.get("reason"):
                    cond["reason"] = podc["reason"]
                if podc.get("message"):
                    cond["message"] = podc["message"]
                old = prev.get(cond["type"])
                unchanged = old is not None and all(
                    old.get(k) == cond.get(k)
                    for k in ("status", "reason", "message")
                )
                cond["lastProbeTime"] = podc.get("lastProbeTime") or (
                    old["lastProbeTime"] if unchanged else now
                )
                cond["lastTransitionTime"] = podc.get(
                    "lastTransitionTime") or (
                    old["lastTransitionTime"] if unchanged else now
                )
                conditions.append(cond)
            # container with the same name as the CR (:336-356)
            for cs in pstatus.get("containerStatuses", []):
                if cs.get("name") == nb.name:
                    container_state = cs.get("state", {})
                    break

        # the self-healing engine's records ride the same status object;
        # this writer rebuilds status from pod state, so it carries them
        # forward untouched (the renderer reads sessionState)
        for cond in (nb.status.get("conditions") or []):
            if cond.get("type") == CONDITION_RECOVERY_EXHAUSTED:
                conditions.append(copy.deepcopy(cond))

        # the replication authority record (epoch, primary, the
        # write-ahead promotion record) survives every status rewrite:
        # dropping it would reset the epoch and unfence a demoted primary.
        # It is seeded here, so it exists before a promotion compares on it
        replication = copy.deepcopy(nb.status.get("replication"))
        if rep_spec is not None and replication is None:
            replication = {"epoch": 1, "primary": 0}

        slice_health = None
        if gpu is not None:
            if C.STOP_ANNOTATION in annotations:
                # "Stopped" only once every worker is actually gone — a
                # partially failed cull reads "Stopping"
                slice_health = "Stopped" if ready == 0 else "Stopping"
            elif scheduling and ready == 0:
                # gang-gated: waiting on the scheduler's placement intent,
                # which is not a failure; a gang the admission gate parked
                # behind quota or fair share reads "Queued"
                slice_health = "Queued" \
                    if C.ANNOTATION_QUEUED in annotations else "Scheduling"
            elif ready == expected_hosts:
                slice_health = "Healthy"
            elif ready == 0:
                slice_health = "Unhealthy"
            else:
                # partial readiness is a degraded gang: collectives hang
                slice_health = "Degraded"

        status = notebook_status(
            ready_replicas=ready,
            conditions=conditions,
            container_state=container_state,
            worker_states=worker_states if gpu is not None else None,
            slice_health=slice_health,
            slice_recovery=nb.status.get("sliceRecovery"),
            session_state=nb.status.get("sessionState"),
            replication=replication,
        )

        prev_status = nb.status or {}
        prev_health = prev_status.get("sliceHealth")
        if gpu is not None and slice_health != prev_health:
            span.add_event("phase.transition", {
                "field": "sliceHealth",
                "from": prev_health or "",
                "to": slice_health or "",
            })
        prev_conds = {
            c.get("type"): c.get("status")
            for c in (prev_status.get("conditions") or [])
        }
        for cond in conditions:
            before = prev_conds.get(cond["type"])
            if before != cond["status"]:
                span.add_event("condition.transition", {
                    "type": cond["type"],
                    "from": before or "",
                    "to": cond["status"],
                })
        span.set_attribute("readyReplicas", ready)

        # first-readiness latency on the injected clock, from the first
        # reconcile that saw this notebook (uid-keyed); the ready span
        # event fires once per generation, the histogram once per uid
        key = (nb.namespace, nb.name, obj.metadata.uid)
        genkey = (key, int(obj.metadata.generation or 1))
        first_seen = self._first_seen.setdefault(genkey, self.clock.now())
        if ready >= expected_hosts and genkey not in self._ready_observed:
            tid = span.trace_id
            if key not in self._ready_measured:
                self.metrics.notebook_ready_seconds.labels(
                    nb.namespace).observe(
                        self.clock.now() - first_seen,
                        exemplar={"trace_id": tid} if tid else None)
                self._ready_measured.add(key)
            self._ready_observed.add(genkey)
            self._first_seen.pop(genkey, None)
            span.add_event("notebook.ready", {"seconds":
                                              self.clock.now() - first_seen})
        elif ready < expected_hosts and \
                C.STOP_ANNOTATION not in annotations:
            if scheduling:
                waiting_on = "quota_wait" \
                    if C.ANNOTATION_QUEUED in annotations else "scheduling"
            else:
                pods_found = len(worker_states) if gpu is not None else \
                    (1 if pod0 is not None else 0)
                waiting_on = "pod_start" if pods_found >= expected_hosts \
                    else "pod_schedule"
            span.add_event("notebook.waiting", {
                "on": waiting_on, "ready": ready,
                "expected": expected_hosts})
        for seen in (self._ready_observed, self._ready_measured,
                     self._first_seen):
            if len(seen) > 8192:
                seen.clear()

        # status dedup, cache-first: when the cached live object already
        # carries exactly this status, skip the read-modify-write
        if self.cache is not None:
            cached = self.cache.get("Notebook", nb.namespace, nb.name)
            if cached is not None and cached.body.get("status") == status:
                return

        def write() -> None:
            live = self.api.get("Notebook", nb.namespace, nb.name)
            new_status = status
            # the epoch-regression guard: a promotion may have advanced
            # status.replication since this pass read it, and writing the
            # stale copy would roll the epoch back and unfence a demoted
            # primary; the newest record by epoch wins (ties to the live
            # object, which is at least as new)
            live_rep = (live.body.get("status") or {}).get("replication")
            if replication is not None and live_rep is not None and \
                    live_rep.get("epoch", 0) >= replication.get("epoch", 0):
                new_status = dict(status)
                new_status["replication"] = copy.deepcopy(live_rep)
            if live.body.get("status") == new_status:
                return
            live.status = new_status
            self.api.update_status(live)

        retry_on_conflict(write)


class EventReemitReconciler:
    """Re-emits Events from owned StatefulSets/Pods onto the Notebook CR so
    users see workload failures with `kubectl describe notebook`
    (notebook_controller.go:99-122, nbNameFromInvolvedObject :705)."""

    # dedup window: Events past it have long aged out (the apiserver TTLs
    # them at 1h), so re-seeing one is a full relist — and re-emitting
    # after a relist is level-triggered-correct, merely chatty
    MAX_EMITTED = 8192

    def __init__(self, api: ApiServer, recorder: EventRecorder):
        self.api = api
        self.recorder = recorder
        self._emitted: "OrderedDict[str, None]" = OrderedDict()

    def reconcile(self, req: Request) -> Result:
        ev = self.api.try_get("Event", req.namespace, req.name)
        if ev is None:
            return Result()
        if ev.metadata.uid in self._emitted:
            self._emitted.move_to_end(ev.metadata.uid)
            return Result()
        involved = ev.body.get("involvedObject", {})
        nb_name = self._notebook_for(req.namespace, involved)
        if nb_name is None:
            return Result()
        nb = self.api.try_get("Notebook", req.namespace, nb_name)
        if nb is None:
            return Result()
        self._emitted[ev.metadata.uid] = None
        while len(self._emitted) > self.MAX_EMITTED:
            self._emitted.popitem(last=False)
        self.recorder.event(
            nb,
            ev.body.get("type", "Normal"),
            ev.body.get("reason", ""),
            "Reissued from %s/%s: %s"
            % (involved.get("kind", "").lower(), involved.get("name", ""),
               ev.body.get("message", "")),
        )
        return Result()

    def _notebook_for(self, namespace: str, involved: dict) -> Optional[str]:
        kind, name = involved.get("kind"), involved.get("name")
        if not kind or not name:
            return None
        obj = self.api.try_get(kind, namespace, name)
        if obj is None:
            return None
        if kind == "Pod":
            return obj.metadata.labels.get(C.NOTEBOOK_NAME_LABEL)
        if kind == "StatefulSet":
            ref = obj.metadata.controller_owner()
            if ref is not None and ref.kind == "Notebook":
                return ref.name
            return obj.metadata.labels.get(C.NOTEBOOK_NAME_LABEL)
        return None


def setup_core_controllers(
    mgr: Manager,
    cfg: Optional[CoreConfig] = None,
    metrics: Optional[NotebookMetrics] = None,
    session: Optional[SessionStateStore] = None,
    provisioner=None,
) -> NotebookReconciler:
    """Wire the core controllers into a manager (main.go:58-148 analog;
    culling registration is separate, gated on ENABLE_CULLING — see
    core.culling_controller.setup_culling).  `session` overrides the
    store opened from CHECKPOINT_STORE_URI; `provisioner` (the
    FakeCluster standalone) turns warm-pool capacity up and down for the
    gang scheduler."""
    cfg = cfg or CoreConfig.from_env()
    api = mgr.api
    install_notebook_schema(api)
    api.register_admission(AdmissionHook(
        kinds=("Notebook",), handler=_refuse_tpu,
        operations=("CREATE", "UPDATE"), mutating=False,
        name="notebook-gpu-admission"))
    # workqueue rate limiting from config (WORKQUEUE_* env vars)
    mgr.set_rate_limiter(default_rate_limiter(
        mgr.clock,
        base_s=cfg.workqueue_base_delay_s,
        cap_s=cfg.workqueue_max_delay_s,
        qps=cfg.workqueue_qps,
        burst=cfg.workqueue_burst,
    ))
    # parallel reconcile workers (WORKQUEUE_WORKERS): only widen
    if cfg.workqueue_workers > mgr.workers:
        mgr.workers = cfg.workqueue_workers
    # hot-path read indexes: owned StatefulSets by controller-owner uid,
    # worker Pods by the STS selector label, Notebook sweeps by namespace
    cache = mgr.cache
    if cache is not None:
        cache.add_owner_uid_index("StatefulSet")
        cache.add_label_index("Pod", C.STATEFULSET_LABEL)
        cache.add_namespace_index("Notebook")
    metrics = metrics or NotebookMetrics(api, manager=mgr)
    if metrics.manager is None:
        metrics.attach_manager(mgr)
    recorder = EventRecorder(api, "notebook-controller")
    rec = NotebookReconciler(api, cfg, metrics, recorder, clock=mgr.clock,
                             cache=cache, session=session)

    def pod_to_request(pod: KubeObject) -> list[Request]:
        name = pod.metadata.labels.get(C.NOTEBOOK_NAME_LABEL)
        return [Request(pod.namespace, name)] if name else []

    def node_to_requests(node: KubeObject) -> list[Request]:
        # a node vanishing or flipping unready can strand a multi-host
        # gang whose workers it carried: re-evaluate every GPU notebook
        notebooks = cache.list("Notebook") if cache is not None \
            else api.list("Notebook")
        return [
            Request(o.namespace, o.name)
            for o in notebooks
            if o.spec.get("gpu")
        ]

    mgr.register(
        "notebook",
        rec,
        for_kind="Notebook",
        owns=["StatefulSet", "Service", "VirtualService"],
        watches=[WatchSpec(kind="Pod", mapper=pod_to_request),
                 WatchSpec(kind="Node", mapper=node_to_requests)],
        # the notebook controller is the sole writer of Notebook status;
        # its own status writes must not re-trigger it
        for_predicate=suppress_status_only,
    )
    mgr.register(
        "event-reemit",
        EventReemitReconciler(api, recorder),
        for_kind="Event",
        watches=[],
    )
    # gang scheduler, warm pool and tenancy layer (ENABLE_SLICE_SCHEDULER),
    # sharing the reconciler's session store, so that the preemption
    # engine secures a victim's checkpoint through the chain the restore
    # path reads
    if cfg.enable_slice_scheduler:
        setup_scheduler(mgr, cfg, metrics, provisioner=provisioner,
                        session=rec.session)
    return rec


__all__ = ["EventReemitReconciler", "NotebookReconciler",
           "setup_core_controllers", "workload_config"]
