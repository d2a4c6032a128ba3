"""Checkpoint-then-preempt: priority-based eviction under a write-ahead
record, for GPU gangs.

The port of kubeflow_tpu/core/preemption.py.  The admission gate
(core/scheduler.py `_admission`) decides who may wait for capacity; this
module decides who must give it up.  When a higher-priority gang is stuck
on the cold-provision path, the scheduler asks the PreemptionEngine
whether evicting lower-priority tenants would free the shortfall now:

1. **Select** the cheapest set of victims: strictly lower priority rank
   than the beneficiary, the same shape (accelerator and GPU count:
   evicting another shape frees the wrong capacity), not mid-cull, not
   already under a pending record, and **checkpointed**: a final
   snapshot is requested while the gang can still flush, else the
   freshest stored snapshot within CHECKPOINT_MAX_AGE_S.  A victim whose
   state cannot be secured is skipped; no session is torn down without
   its state in hand.

2. **Commit the write-ahead preemption record** into the cluster-scoped
   TenantQuota's status (`status.preemptions[victim]`, phase Pending,
   with the per-gang restore manifest) before anything is torn down.  A
   manager crash anywhere after this point resumes the eviction (the
   "preemption" reconciler re-drives pending records) and never repeats
   it: every step below is idempotent.

3. **Evict** each victim: persist its restore intent into
   `status.sessionState` (the migrate verb's record, which the restore
   machinery of core/selfheal.py and the renderer carry back when the
   victim re-places) and a queued annotation at the victim's own priority
   (reason "preempted", naming the beneficiary), then tear the gang down:
   StatefulSets, every pod (errors aggregated), pool claims released, the
   placement intent last.

4. **Finish** the record (phase Done, folded into the bounded
   `status.recentPreemptions`), and let the pool watch wake the
   beneficiary, whose cold reservation takes the freed capacity.

Verb precedence across the controllers: cull > preempt > migrate >
restart.  Status keys, metric names and event reasons are the
reference's; counts are GPUs where the reference counts chips.
"""

from __future__ import annotations

import copy
import json
import logging
import time
from typing import Optional

from ..api.types import PRIORITY_DEFAULT, Notebook
from ..gpu.topology import GpuShape
from ..kube import (
    AlreadyExistsError,
    ApiServer,
    EventRecorder,
    KubeObject,
    NotFoundError,
    ObjectMeta,
    Request,
    Result,
    retry_on_conflict,
)
from ..utils import tracing
from ..utils.clock import Clock
from ..utils.config import CoreConfig
from . import constants as C
from .metrics import NotebookMetrics
from .scheduler import (
    SliceScheduler,
    gang_chips,
    queued_info,
    rank_of,
    resolve_priority,
)
from .selfheal import SliceRestartError

logger = logging.getLogger("kubeflow_tpu_torch.preemption")

_TRACER = tracing.get_tracer("kubeflow_tpu_torch.core.preemption")

# preemption outcomes, a bounded set: they label
# notebook_preemptions_total{result,priority}
PREEMPT_RESULT_EVICTED = "evicted"      # victim torn down by the live plan
PREEMPT_RESULT_RESUMED = "resumed"      # eviction re-driven after a crash
PREEMPT_RESULT_NO_VICTIM = "no-victim"  # eligible victims could not cover

# sessionState trigger of a preemption's restore: it rides the migrate
# verb's restore machinery and labels notebook_migrations_total
MIGRATE_TRIGGER_PREEMPT = "preempt"

# event reasons (kubectl describe notebook), the reference's
EVENT_PREEMPTED = "NotebookPreempted"
EVENT_PREEMPTION_ISSUED = "PreemptionIssued"

# bounded audit trail of completed evictions on TenantQuota status
RECENT_PREEMPTIONS_MAX = 16


def new_quota_object() -> KubeObject:
    """The cluster-scoped TenantQuota singleton, created empty on first
    use: operators fill spec.tenants and spec.defaults; the engine needs
    only the status side for its write-ahead records."""
    return KubeObject(
        api_version="kubeflow.org/v1",
        kind=C.TENANTQUOTA_KIND,
        metadata=ObjectMeta(name=C.TENANTQUOTA_NAME),
        body={"spec": {}},
    )


def pending_preemption(api: ApiServer, namespace: str, name: str) -> bool:
    """True while a write-ahead preemption record names this notebook as
    its victim.  The culler checks this before it stops a notebook: a
    preemption in flight owns the victim's teardown and claim release."""
    quota = api.try_get(C.TENANTQUOTA_KIND, "", C.TENANTQUOTA_NAME)
    if quota is None:
        return False
    recs = (quota.body.get("status", {}) or {}).get("preemptions") or {}
    rec = recs.get(f"{namespace}/{name}")
    return bool(rec and rec.get("phase") == C.PREEMPTION_PENDING)


class PreemptionEngine:
    """Owns checkpoint-then-preempt end to end: victim selection,
    checkpoint securing, the write-ahead record, gang-atomic teardown and
    crash resume.  Registered as the "preemption" reconciler of
    TenantQuota, so pending records re-drive on every manager start and
    every record transition."""

    def __init__(
        self,
        api: ApiServer,
        cfg: CoreConfig,
        metrics: NotebookMetrics,
        recorder: Optional[EventRecorder] = None,
        clock: Optional[Clock] = None,
        cache=None,
        session=None,
    ) -> None:
        self.api = api
        self.cfg = cfg
        self.metrics = metrics
        self.recorder = recorder or EventRecorder(api, "preemption")
        self.clock = clock or Clock()
        self.cache = cache
        if session is None and cfg.checkpoint_store_uri:
            from .sessionstate import open_store

            session = open_store(cfg.checkpoint_store_uri, clock=self.clock)
        self.session = session

    # -- entry point (called from the scheduler's wait path) ------------------
    def maybe_preempt(self, nb: Notebook, shape: GpuShape,
                      chips_needed: float, span) -> bool:
        """Plan and execute an eviction freeing `chips_needed` GPUs of
        `shape` capacity for `nb`, or do nothing.  Returns True when a
        covering plan committed.  Without a session store there is
        nothing to preempt with: eviction without a secured checkpoint is
        forbidden."""
        if not self.cfg.enable_preemption or self.session is None \
                or chips_needed <= 0:
            return False
        key = f"{nb.namespace}/{nb.name}"
        quota = self.api.try_get(
            C.TENANTQUOTA_KIND, "", C.TENANTQUOTA_NAME)
        recs = {} if quota is None else (
            (quota.body.get("status", {}) or {}).get("preemptions") or {})
        if any(r.get("phase") == C.PREEMPTION_PENDING
               and r.get("beneficiary") == key for r in recs.values()):
            return False  # an earlier plan is in flight; resume owns it
        bpriority = resolve_priority(nb, quota)
        brank = rank_of(bpriority)
        reader = self.cache if self.cache is not None else self.api
        candidates: list[tuple] = []
        for obj in reader.list("Notebook"):
            vkey = f"{obj.namespace}/{obj.name}"
            if vkey == key or obj.metadata.deletion_timestamp is not None:
                continue
            ann = obj.metadata.annotations or {}
            if C.ANNOTATION_PLACEMENT not in ann:
                continue  # only placed gangs hold GPUs worth freeing
            # cull > preempt: a victim mid-cull is already being parked
            if C.STOP_ANNOTATION in ann:
                continue
            st = obj.body.get("status", {}) or {}
            if st.get("sliceHealth") in ("Stopping", "Stopped"):
                continue
            if (recs.get(vkey) or {}).get("phase") == C.PREEMPTION_PENDING:
                continue  # already someone's victim
            vgpu = obj.spec.get("gpu") or {}
            if str(vgpu.get("accelerator", "")) != shape.accelerator.name \
                    or str(vgpu.get("count", "")) != str(shape.gpus):
                continue  # evicting another shape frees the wrong pool
            vp = resolve_priority(Notebook(obj.to_dict()), quota)
            if rank_of(vp) >= brank:
                continue  # never an equal-or-higher-priority victim
            chips = gang_chips(obj)
            if chips <= 0:
                continue
            candidates.append(
                (rank_of(vp), chips, obj.namespace, obj.name, vp, obj))
        if not candidates:
            return False  # nothing rank-eligible: the common, quiet case
        # cheapest set: lowest rank first, then fewest GPUs; names break
        # ties for determinism
        candidates.sort(key=lambda c: c[:4])
        plan: list[dict] = []
        freed = 0.0
        for _vrank, chips, vns, vname, vp, obj in candidates:
            if freed >= chips_needed:
                break
            gangs = self._secure_victim(obj, span)
            if gangs is None:
                continue  # no secured checkpoint: never a victim
            plan.append({
                "key": f"{vns}/{vname}", "namespace": vns, "name": vname,
                "priority": vp, "chips": chips, "gangs": gangs,
                "beneficiary": key, "beneficiaryPriority": bpriority,
            })
            freed += chips
        if freed < chips_needed:
            # eligible victims cannot cover the shortfall: evict nobody,
            # since a partial eviction destroys sessions and unblocks none
            self.metrics.preemptions.labels(
                PREEMPT_RESULT_NO_VICTIM, bpriority).inc()
            span.add_event("preempt.no_victim", {
                "needed": chips_needed, "securable": freed})
            return False
        self.preempt(nb, plan, span)
        return True

    # -- the write-ahead protocol ---------------------------------------------
    def preempt(self, nb: Notebook, plan: list[dict], span) -> None:
        """Execute a committed plan.  The protocol order is the guarantee:
        the write-ahead record lands before any teardown, so a crash
        anywhere below resumes the eviction from the record, exactly
        once."""
        self._commit_record(nb, plan)
        for victim in plan:
            span.add_event("preempt.victim", {
                "victim": victim["key"], "priority": victim["priority"],
                "chips": victim["chips"]})
            self._persist_victim_intent(victim)
            self._teardown_victim(victim)
        self._finish_records(plan, PREEMPT_RESULT_EVICTED)
        for victim in plan:
            vobj = self.api.try_get(
                "Notebook", victim["namespace"], victim["name"])
            if vobj is not None:
                self.recorder.event(
                    vobj, "Warning", EVENT_PREEMPTED,
                    "preempted (%s) for higher-priority %s (%s); session "
                    "checkpointed, will restore on re-placement" % (
                        victim["priority"], victim["beneficiary"],
                        victim["beneficiaryPriority"]))
        self.recorder.event(
            KubeObject.from_dict(nb.obj), "Normal", EVENT_PREEMPTION_ISSUED,
            "preempted %d lower-priority notebook(s) (%s) to free %.0f "
            "GPU(s)" % (
                len(plan), ", ".join(v["key"] for v in plan),
                sum(v["chips"] for v in plan)))

    # -- crash resume ---------------------------------------------------------
    def reconcile(self, req: Request) -> Result:
        """Re-drive every pending preemption record.  Runs on manager
        start and on every TenantQuota transition, so an eviction cut
        between the record commit and the teardown completes under the
        next manager, idempotently."""
        obj = self.api.try_get(C.TENANTQUOTA_KIND, "", req.name)
        if obj is None:
            return Result()
        recs = (obj.body.get("status", {}) or {}).get("preemptions") or {}
        pending = sorted(
            k for k, r in recs.items()
            if r.get("phase") == C.PREEMPTION_PENDING)
        if not pending:
            return Result()
        with _TRACER.start_span(
            "preempt.resume", {"phase": "preempt", "records": len(pending)},
        ) as span:
            plan: list[dict] = []
            for k in pending:
                rec = recs[k]
                ns, _, name = k.partition("/")
                plan.append({
                    "key": k, "namespace": ns, "name": name,
                    "priority": rec.get("victimPriority", PRIORITY_DEFAULT),
                    "chips": float(rec.get("chips", 0.0) or 0.0),
                    "gangs": copy.deepcopy(rec.get("restore") or {}),
                    "beneficiary": rec.get("beneficiary", ""),
                    "beneficiaryPriority": rec.get(
                        "beneficiaryPriority", PRIORITY_DEFAULT),
                })
            for victim in plan:
                span.add_event("preempt.resume", {"victim": victim["key"]})
                self._persist_victim_intent(victim)
                self._teardown_victim(victim)
            self._finish_records(plan, PREEMPT_RESULT_RESUMED)
        return Result()

    # -- steps ----------------------------------------------------------------
    def _secure_victim(self, obj: KubeObject, span) -> Optional[dict]:
        """A restore manifest covering every gang of the victim: a final
        snapshot while the gang can still flush, else the freshest stored
        snapshot within CHECKPOINT_MAX_AGE_S.  One uncoverable gang
        disqualifies the whole victim."""
        nb = Notebook(obj.to_dict())
        if nb.gpu is None:
            return None
        rep = nb.replication
        total = rep.replicas if rep else 1
        now = self.clock.now()
        gangs: dict = {}
        for idx in range(total):
            snap = self.session.request_final_snapshot(
                nb.namespace, nb.name, idx)
            if snap is None:
                latest = self.session.latest(nb.namespace, nb.name, idx)
                if latest is None or \
                        now - latest.saved_at > self.cfg.checkpoint_max_age_s:
                    span.add_event("preempt.checkpoint_missing", {
                        "victim": f"{nb.namespace}/{nb.name}", "gang": idx})
                    return None
                snap = latest
            gangs[str(idx)] = {
                "restoreGeneration": snap.generation,
                "restoreUri": snap.uri,
                "digest": snap.digest,
                "savedAt": _iso_at(snap.saved_at),
            }
        return gangs

    def _commit_record(self, nb: Notebook, plan: list[dict]) -> None:
        """The write-ahead half: one Pending record per victim, carrying
        the restore manifest, committed to TenantQuota status before any
        teardown.  A record already in (a resume) is left untouched."""
        bkey = f"{nb.namespace}/{nb.name}"

        def write() -> None:
            live = self._ensure_quota()
            st = copy.deepcopy(live.body.get("status") or {})
            recs = st.setdefault("preemptions", {})
            changed = False
            for victim in plan:
                cur = recs.get(victim["key"])
                if cur is not None and \
                        cur.get("phase") == C.PREEMPTION_PENDING:
                    continue
                recs[victim["key"]] = {
                    "victim": victim["key"],
                    "victimPriority": victim["priority"],
                    "beneficiary": bkey,
                    "beneficiaryPriority": victim["beneficiaryPriority"],
                    "chips": victim["chips"],
                    "phase": C.PREEMPTION_PENDING,
                    "createdAt": self.clock.now_iso(),
                    "restore": copy.deepcopy(victim["gangs"]),
                }
                changed = True
            if changed:
                live.status = st
                self.api.update_status(live)

        retry_on_conflict(write)

    def _persist_victim_intent(self, victim: dict) -> None:
        """Victim-side write-ahead, idempotent: the restore intent into
        status.sessionState (the record the migrate verb writes, so the
        restore machinery carries the victim back) and the queued
        annotation at the victim's own priority, naming the beneficiary so
        that the admission fence holds."""
        ns, name = victim["namespace"], victim["name"]

        def write_status() -> None:
            try:
                live = self.api.get("Notebook", ns, name)
            except NotFoundError:
                return
            st = live.body.setdefault("status", {})
            before = copy.deepcopy(st.get("sessionState") or {})
            session = copy.deepcopy(before)
            for idx, rec in victim["gangs"].items():
                entry = dict(session.get(idx) or {})
                entry.update({
                    "restoreGeneration": rec["restoreGeneration"],
                    "restoreUri": rec["restoreUri"],
                    "digest": rec["digest"],
                    "savedAt": rec["savedAt"],
                    "trigger": MIGRATE_TRIGGER_PREEMPT,
                    "phase": "migrating",
                })
                entry.pop("restoredAt", None)
                session[idx] = entry
            if session != before:
                st["sessionState"] = session
                self.api.update_status(live)

        retry_on_conflict(write_status)

        def stamp_queued() -> None:
            try:
                live = self.api.get("Notebook", ns, name)
            except NotFoundError:
                return
            info = queued_info(live.metadata.annotations)
            changed = "since" not in info
            info.setdefault("since", self.clock.now())
            for field, value in (("priority", victim["priority"]),
                                 ("reason", "preempted"),
                                 ("beneficiary", victim["beneficiary"])):
                if info.get(field) != value:
                    info[field] = value
                    changed = True
            if changed:
                live.metadata.annotations[C.ANNOTATION_QUEUED] = json.dumps(
                    info, sort_keys=True, separators=(",", ":"))
                self.api.update(live)

        retry_on_conflict(stamp_queued)

    def _teardown_victim(self, victim: dict) -> None:
        """Gang-atomic teardown of one victim, strictly after the record
        and the restore intent persisted: StatefulSets first (nothing
        recreates the pods), then every pod (errors aggregated, so a
        transient failure retries the whole victim), then the pool claims
        drain back (which wakes the beneficiary), and the placement intent
        retires last."""
        ns, name = victim["namespace"], victim["name"]
        key = victim["key"]
        # duplicate-resume guard: a record already folded to its terminal
        # phase was finished by another manager; a second teardown could
        # evict a gang that legitimately re-placed since
        if not pending_preemption(self.api, ns, name):
            return
        errors: list[Exception] = []
        attempted = 0
        for sts in list(self.api.list("StatefulSet", namespace=ns)):
            if not _owned_by(sts, name):
                continue
            try:
                self.api.delete("StatefulSet", ns, sts.name)
            except NotFoundError:
                pass
            except Exception as err:  # noqa: BLE001 — aggregated below
                errors.append(err)
        for pod in list(self.api.list(
                "Pod", namespace=ns,
                label_selector={C.NOTEBOOK_NAME_LABEL: name})):
            attempted += 1
            try:
                self.api.delete("Pod", ns, pod.name)
            except NotFoundError:
                pass
            except Exception as err:  # noqa: BLE001 — aggregated below
                errors.append(err)
        if errors:
            raise SliceRestartError(errors, attempted)

        for pool_obj in list(self.api.list(C.WARMPOOL_KIND)):
            held = (pool_obj.body.get("status", {}) or {}) \
                .get("slices") or {}
            if not any(e.get("claimedBy") == key for e in held.values()):
                continue

            def release(pool_name: str = pool_obj.name) -> None:
                live = self.api.get(C.WARMPOOL_KIND, "", pool_name)
                st = copy.deepcopy(live.body.get("status") or {})
                slices = st.setdefault("slices", {})
                changed = False
                for sid in list(slices):
                    if slices[sid].get("claimedBy") == key:
                        SliceScheduler._release_entry(slices, sid)
                        changed = True
                if changed:
                    live.status = st
                    self.api.update_status(live)

            retry_on_conflict(release)

        def drop_intent() -> None:
            try:
                live = self.api.get("Notebook", ns, name)
            except NotFoundError:
                return
            if C.ANNOTATION_PLACEMENT in live.metadata.annotations:
                del live.metadata.annotations[C.ANNOTATION_PLACEMENT]
                self.api.update(live)

        retry_on_conflict(drop_intent)

    def _finish_records(self, plan: list[dict], result: str) -> None:
        """Flip each victim's record to its terminal phase exactly once:
        out of status.preemptions, into the bounded recentPreemptions
        trail.  Metrics count only the records this pass finished."""
        finished: list[dict] = []

        def write() -> None:
            finished.clear()
            live = self.api.try_get(
                C.TENANTQUOTA_KIND, "", C.TENANTQUOTA_NAME)
            if live is None:
                return
            st = copy.deepcopy(live.body.get("status") or {})
            recs = st.get("preemptions") or {}
            recent = list(st.get("recentPreemptions") or [])
            changed = False
            for victim in plan:
                rec = recs.pop(victim["key"], None)
                if rec is None:
                    continue
                rec["phase"] = C.PREEMPTION_DONE
                rec["completedAt"] = self.clock.now_iso()
                recent.append(rec)
                finished.append(victim)
                changed = True
            if changed:
                if recs:
                    st["preemptions"] = recs
                else:
                    st.pop("preemptions", None)
                st["recentPreemptions"] = recent[-RECENT_PREEMPTIONS_MAX:]
                live.status = st
                self.api.update_status(live)

        retry_on_conflict(write)
        for victim in finished:
            self.metrics.preemptions.labels(
                result, victim["priority"]).inc()
            logger.info(
                "preemption %s: victim %s (%s) for %s", result,
                victim["key"], victim["priority"], victim["beneficiary"])

    # -- plumbing -------------------------------------------------------------
    def _ensure_quota(self) -> KubeObject:
        obj = self.api.try_get(C.TENANTQUOTA_KIND, "", C.TENANTQUOTA_NAME)
        if obj is not None:
            return obj
        try:
            return self.api.create(new_quota_object())
        except AlreadyExistsError:
            return self.api.get(C.TENANTQUOTA_KIND, "", C.TENANTQUOTA_NAME)


def _owned_by(sts: KubeObject, notebook: str) -> bool:
    ref = sts.metadata.controller_owner()
    if ref is not None and ref.kind == "Notebook":
        return ref.name == notebook
    return sts.metadata.labels.get(C.NOTEBOOK_NAME_LABEL) == notebook


def _iso_at(t: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t))


__all__ = [
    "EVENT_PREEMPTED",
    "EVENT_PREEMPTION_ISSUED",
    "MIGRATE_TRIGGER_PREEMPT",
    "PREEMPT_RESULT_EVICTED",
    "PREEMPT_RESULT_NO_VICTIM",
    "PREEMPT_RESULT_RESUMED",
    "PreemptionEngine",
    "new_quota_object",
    "pending_preemption",
]
