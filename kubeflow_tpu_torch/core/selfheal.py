"""Gang-atomic self-healing: disruption detection and budgeted recovery.

The port of kubeflow_tpu/core/selfheal.py for `spec.gpu` gangs.  A GPU
gang needs the whole-gang restart as much as a TPU slice does: NCCL
communicators cannot survive partial membership, and torchrun's
rendezvous re-forms only when every rank restarts.  So:

- `classify_worker` turns the pod state the reconciler already lists into
  a disruption verdict: pod `Failed` (a card that fell off the bus, an
  XID error), CrashLoopBackOff (container `waiting.reason`), a lost node
  (dangling or unready `spec.nodeName`), or Pending beyond a schedule
  deadline.  Healthy and transient states (Running but not yet Ready, a
  pod mid-recreate, Pending within the deadline) never trigger recovery.

- `RecoveryEngine` restarts the whole gang under a restart budget:
  exponential backoff between attempts (`RECOVERY_BACKOFF_*`), a capped
  attempt count within a sliding window, and a terminal
  `RecoveryExhausted=True` condition and Warning event once the budget is
  spent, after which the gang is left alone until an operator heals it.

- With a session-state store wired (core/sessionstate.py,
  `CHECKPOINT_*`), the engine prefers the `migrate` verb over the bare
  restart: it asks the gang for a final snapshot while it is still
  reachable, else takes the freshest stored checkpoint within
  `CHECKPOINT_MAX_AGE_S`; it writes the restore intent into
  `status.sessionState` (write-ahead), re-stamps the gang's StatefulSet
  so the recreated pods carry CHECKPOINT_RESTORE_URI/_GENERATION, and
  only then deletes the pods.  A stale or absent checkpoint degrades to
  the bare restart; migrate and restart share one attempt budget.  The
  same verb serves voluntary migration, a drain/defrag annotation
  (constants.ANNOTATION_MIGRATE) or a worker on a cordoned node, and a
  healthy session is never torn down without a secured checkpoint.  Verb
  precedence: cull > preempt > migrate > restart: a gang the tenancy
  layer queued (core/scheduler.py, core/preemption.py) is left alone.

- For a replicated notebook (`spec.replication`: one primary gang and
  follower gangs replaying the checkpoint-delta stream of
  core/sessionstate.py) the engine prefers the `promote` verb over both:
  a failure of the primary's gang elects the freshest caught-up follower
  (follower pods stamp how far they have replayed,
  ANNOTATION_REPLICA_GENERATION/SEQ) and flips the primary pointer in
  `status.replication` under epoch fencing.  The order is the
  guarantee: the write-ahead promotion record (phase "promoting") lands
  with the bumped epoch in one status commit, then the session store's
  write fence rises to the new epoch, and only then is the new primary
  named (phase "promoted").  The fence raise is the linearization
  point: a demoted primary's write either landed before it, and the
  promoted follower replayed it, or raises StaleWriterError and was
  never acked.  A crash between any two steps resumes from the record
  (the fence is a monotonic max).  The demoted gang heals as a follower
  through the ordinary restart budget; migrate is never used for a
  replicated notebook (the delta stream is the migration).

All bookkeeping (attempt stamps, last restart, backoff deadline,
disruption stamp, exhaustion, the restore intent, the promotion record)
lives in `status.sliceRecovery` / `status.sessionState` /
`status.replication` on the CR, under the reference's names, so a
manager failover resumes the budget and any migration or promotion in
flight.  It is written before any pod delete.  A GPU notebook has one
gang per replica (gang r is replica r's; its session state is slice 0)
where the reference has `spec.tpu.slices` slices per replica; the status
keys, metric names and event reasons are the reference's, and messages
read "gang".
"""

from __future__ import annotations

import copy
import logging
import time
from typing import Callable, Optional

from ..api.types import CONDITION_RECOVERY_EXHAUSTED, Notebook
from ..kube import (
    ApiServer,
    EventRecorder,
    KubeObject,
    NotFoundError,
    retry_on_conflict,
)
from ..utils import tracing
from ..utils.clock import Clock, parse_iso
from ..utils.config import CoreConfig
from . import constants as C
from .metrics import NotebookMetrics
from .sessionstate import SessionStateStore, SnapshotInfo, TRIGGER_FINAL

logger = logging.getLogger("kubeflow_tpu_torch.selfheal")

# recovery attempts open a `recover` phase span on the shared context
# stack, parenting onto the manager's per-attempt reconcile root
_TRACER = tracing.get_tracer("kubeflow_tpu_torch.core.selfheal")

# disruption classifications, a bounded set: they label
# notebook_slice_restarts_total{reason}
REASON_POD_FAILED = "pod-failed"
REASON_CRASH_LOOP = "crash-loop"
REASON_NODE_GONE = "node-gone"
REASON_PENDING_TIMEOUT = "pending-timeout"
# a gang restart performed by the migrate verb (checkpoint secured)
REASON_MIGRATE = "migrate"
# not yet a disruption: a Pending worker becomes REASON_PENDING_TIMEOUT
# only once the schedule deadline passes
PENDING = "pending"

# migrate triggers and results, bounded sets: they label
# notebook_migrations_total{trigger,result}
MIGRATE_TRIGGER_FAILURE = "failure"
MIGRATE_TRIGGER_DRAIN = "drain"
MIGRATE_TRIGGER_DEFRAG = "defrag"
MIGRATE_TRIGGER_NODE_DRAIN = "node-drain"
MIGRATE_RESULT_MIGRATED = "migrated"          # verb issued with a checkpoint
MIGRATE_RESULT_RESTORED = "restored"          # gang Healthy after restore
MIGRATE_RESULT_FALLBACK = "fallback-restart"  # stale/absent ckpt -> bare
MIGRATE_RESULT_SKIPPED = "skipped"            # voluntary without a ckpt

# the promote verb (replicated notebooks): the internal verb tag and the
# bounded result set labelling notebook_promotions_total{result}
VERB_PROMOTE = "promote"
PROMOTE_RESULT_PROMOTED = "promoted"        # follower elected and flipped
PROMOTE_RESULT_LOST_RACE = "lost-race"      # another promoter committed first
PROMOTE_RESULT_NO_CANDIDATE = "no-candidate"  # no caught-up follower

# event reasons (kubectl describe notebook), the reference's
EVENT_SLICE_RECOVERY = "SliceRecovery"
EVENT_RECOVERY_EXHAUSTED = "RecoveryExhausted"
EVENT_RECOVERY_RESTORED = "RecoveryRestored"
EVENT_SLICE_MIGRATION = "SliceMigration"
EVENT_MIGRATION_COMPLETE = "MigrationComplete"
EVENT_MIGRATION_SKIPPED = "MigrationSkipped"
EVENT_PRIMARY_PROMOTED = "PrimaryPromoted"


class SliceRestartError(Exception):
    """Aggregate of per-pod delete failures from a gang-atomic restart,
    raised only after every pod of the gang was attempted, so that the
    manager's backoff retries the whole gang and a half-restarted gang is
    never reported as recovered."""

    def __init__(self, errors: list[Exception], attempted: int) -> None:
        self.errors = errors
        self.attempted = attempted
        super().__init__(
            f"gang restart: {len(errors)}/{attempted} pod deletes failed; "
            f"first: {errors[0]}")


def _ready(obj: KubeObject) -> bool:
    return any(
        c.get("type") == "Ready" and c.get("status") == "True"
        for c in obj.body.get("status", {}).get("conditions", [])
    )


def classify_worker(pod: KubeObject, api: ApiServer,
                    node_cache: Optional[dict] = None) -> Optional[str]:
    """Classify one worker pod: a REASON_* constant for a disrupted
    worker, PENDING for a pod waiting to schedule or start (only the
    deadline makes that a disruption), or None for healthy and transient
    states.  `node_cache` memoizes Node lookups across one pass."""
    status = pod.body.get("status", {}) or {}
    if status.get("phase") == "Failed":
        return REASON_POD_FAILED
    for cs in status.get("containerStatuses", []) or []:
        waiting = (cs.get("state") or {}).get("waiting") or {}
        if waiting.get("reason") == "CrashLoopBackOff":
            return REASON_CRASH_LOOP
    if pod.spec.get("nodeName", ""):
        node = _node_of(pod, api, node_cache)
        # a vanished node (preemption, scale-down) or an unready one
        if node is None or not _ready(node):
            return REASON_NODE_GONE
    if status.get("phase") == "Pending":
        return PENDING
    return None


def _node_of(pod: KubeObject, api: ApiServer,
             node_cache: Optional[dict]) -> Optional[KubeObject]:
    node_name = pod.spec.get("nodeName", "")
    if not node_name:
        return None
    if node_cache is not None and node_name in node_cache:
        return node_cache[node_name]
    node = api.try_get("Node", "", node_name)
    if node_cache is not None:
        node_cache[node_name] = node
    return node


def node_drained(pod: KubeObject, api: ApiServer,
                 node_cache: Optional[dict] = None) -> bool:
    """A worker on a cordoned Node (`spec.unschedulable`) is a voluntary
    migration candidate: the node is being drained, not failed."""
    node = _node_of(pod, api, node_cache)
    return bool(node is not None and node.spec.get("unschedulable"))


def _replica_freshness(pods: list[KubeObject]) -> Optional[tuple[int, int,
                                                                 str]]:
    """How far one replica gang has replayed the checkpoint-delta stream,
    from the ANNOTATION_REPLICA_* stamps its runtime writes: its slowest
    worker's (generation, seq), since a gang is only as caught up as its
    laggard; one unstamped worker makes the gang unknown (None), because
    an election needs positive evidence."""
    worst: Optional[tuple[int, int, str]] = None
    for pod in pods:
        ann = pod.metadata.annotations
        gen_raw = ann.get(C.ANNOTATION_REPLICA_GENERATION)
        seq_raw = ann.get(C.ANNOTATION_REPLICA_SEQ)
        if gen_raw is None or seq_raw is None:
            return None
        try:
            cur = (int(gen_raw), int(seq_raw),
                   ann.get(C.ANNOTATION_REPLICA_DIGEST, ""))
        except ValueError:
            return None
        if worst is None or cur[:2] < worst[:2]:
            worst = cur
    return worst


class RecoveryEngine:
    """Budgeted gang-atomic recovery, driven from the notebook reconcile.

    `maybe_recover` runs after the status pass: it classifies every
    worker of the gang, and for a disrupted gang either waits out the
    backoff (returning a requeue-after hint), migrates or restarts the
    whole gang (write-ahead bookkeeping, then every pod deleted), or,
    once the attempt budget is spent, sets the terminal RecoveryExhausted
    condition and leaves the gang alone until an operator heals it."""

    def __init__(
        self,
        api: ApiServer,
        cfg: CoreConfig,
        metrics: NotebookMetrics,
        recorder: EventRecorder,
        clock: Optional[Clock] = None,
        cache=None,
        session: Optional[SessionStateStore] = None,
    ) -> None:
        self.api = api
        self.cfg = cfg
        self.metrics = metrics
        self.recorder = recorder
        self.clock = clock or Clock()
        # informer cache for the detection reads; writes always go live
        self.cache = cache
        # with a session-state store the migrate verb is preferred
        self.session = session

    def _event(self, nb: Notebook, etype: str, reason: str,
               message: str) -> None:
        self.recorder.event(KubeObject.from_dict(nb.obj), etype, reason,
                            message)

    # -- entry point ----------------------------------------------------------
    def maybe_recover(
        self,
        nb: Notebook,
        live_names: list[str],
        pods_of: Callable[[str], list[KubeObject]],
        restart_slice: Callable[[str], None],
        stamp_restore: Optional[Callable[[str, int], None]] = None,
    ) -> float:
        """One recovery pass; returns the requeue-after hint in seconds
        (0.0 = nothing scheduled).  `live_names` holds the gang's live
        StatefulSet, or for a replicated notebook every replica's, in
        replica order; `restart_slice` deletes every pod of the named
        StatefulSet, aggregating errors; `stamp_restore(live_name, idx)`
        syncs the live StatefulSet template with the restore intent just
        written, so the recreated pods boot with the CHECKPOINT_RESTORE_*
        env."""
        gpu = nb.gpu
        if gpu is None or not self.cfg.enable_self_healing:
            return 0.0
        rep_spec = nb.replication
        # one gang per replica: the reference's slices per replica
        num_slices = 1
        reader = self.cache if self.cache is not None else self.api
        live = reader.try_get("Notebook", nb.namespace, nb.name)
        if live is None or live.metadata.deletion_timestamp is not None:
            return 0.0
        status = live.body.get("status", {}) or {}
        recovery = copy.deepcopy(status.get("sliceRecovery") or {})
        prev_recovery = copy.deepcopy(recovery)
        session_state = copy.deepcopy(status.get("sessionState") or {})
        prev_session = copy.deepcopy(session_state)

        # cull > migrate > restart: a stop-annotated notebook is parked on
        # purpose, and "recovering" it would fight the cull.  Once Stopped,
        # the recovery bookkeeping is dropped so an unstopped notebook
        # starts with a fresh budget; status.sessionState survives the
        # stop, as the checkpoint an unstopped notebook restores from.
        if C.STOP_ANNOTATION in live.metadata.annotations or \
                status.get("sliceHealth") in ("Stopping", "Stopped"):
            if recovery and status.get("sliceHealth") == "Stopped":
                self._write_bookkeeping(nb, {})
            return 0.0

        # cull > preempt > migrate > restart: a queued gang, a preemption
        # victim mid-teardown or re-queued among them, holds no placed
        # capacity, and "recovering" it would fight the preemption engine.
        # Its sessionState (the restore intent) survives untouched and
        # rides the restore path once the gang re-places.
        if C.ANNOTATION_QUEUED in live.metadata.annotations:
            return 0.0

        # voluntary migration request: the drain/defrag annotation
        ann_raw = live.metadata.annotations.get(
            C.ANNOTATION_MIGRATE, "").strip().lower()
        ann_trigger = None
        if ann_raw:
            ann_trigger = ann_raw if ann_raw in (
                MIGRATE_TRIGGER_DRAIN, MIGRATE_TRIGGER_DEFRAG,
            ) else MIGRATE_TRIGGER_DRAIN

        # -- pass 1: detection only (no span unless there is work) ------------
        num_hosts = gpu.validate().num_hosts
        node_cache: dict[str, Optional[KubeObject]] = {}
        detections: list[tuple] = []
        gang_fresh: dict[int, Optional[tuple[int, int, str]]] = {}
        for idx, live_name in enumerate(live_names):
            pods = sorted(pods_of(live_name), key=lambda p: p.name)
            if rep_spec is not None:
                gang_fresh[idx] = _replica_freshness(pods)
            reasons: list[tuple[str, str]] = []
            pending = False
            ready = 0
            drained = False
            for pod in pods:
                verdict = classify_worker(pod, reader, node_cache)
                if verdict == PENDING:
                    pending = True
                elif verdict is not None:
                    reasons.append((pod.name, verdict))
                elif node_drained(pod, reader, node_cache):
                    drained = True
                if _ready(pod):
                    ready += 1
            healthy = not reasons and not pending and ready >= num_hosts
            # a disruption wins over a voluntary request (the failure path
            # migrates too, under the "failure" trigger)
            trigger = None
            if not reasons and not pending:
                trigger = ann_trigger or (
                    MIGRATE_TRIGGER_NODE_DRAIN if drained else None)
            # a worker stamped with another restored generation than the
            # intent in flight survived the restart and still runs the old
            # session: the migration must not finish over it (an absent
            # stamp stays neutral)
            stale_session = False
            target = session_state.get(str(idx)) or {}
            if target.get("phase") == "migrating" and \
                    target.get("restoreGeneration") is not None:
                want = str(target["restoreGeneration"])
                stale_session = any(
                    pod.metadata.annotations.get(
                        C.ANNOTATION_RESTORED_GENERATION, want) != want
                    for pod in pods)
            detections.append((idx, live_name, reasons, pending, healthy,
                               trigger, stale_session))

        # -- replicated tier: the followers' record and the promotion ---------
        replication = None
        prev_replication = None
        promote_entry = None
        no_candidate = False
        skip_gangs: set[int] = set()
        primary_replica = 0
        if rep_spec is not None:
            replication = copy.deepcopy(status.get("replication") or {})
            prev_replication = copy.deepcopy(replication)
            replication.setdefault("epoch", 1)
            replication.setdefault("primary", 0)
            primary_replica = replication["primary"]
            self._record_followers(rep_spec, num_slices, detections,
                                   gang_fresh, replication)
            promote_entry, skip_gangs, no_candidate = \
                self._promotion_decision(nb, rep_spec, num_slices,
                                         detections, gang_fresh,
                                         replication, recovery)

        migrating_inflight = any(
            s.get("phase") == "migrating" for s in session_state.values())
        if not recovery and not migrating_inflight and not any(
                reasons or pending or trigger
                for _, _, reasons, pending, _, trigger, _ in detections):
            if promote_entry is None and \
                    (replication is None or replication == prev_replication):
                return 0.0

        # -- pass 2: decisions, under the `recover` phase span ----------------
        now = self.clock.now()
        requeue = 0.0
        restarts: list[dict] = []
        events: list[tuple[str, str, str]] = []
        notes = {"deferred": False}
        with _TRACER.start_span(
            "recover", {"phase": "recover", "namespace": nb.namespace,
                        "notebook": nb.name}
        ) as span:
            if promote_entry is not None:
                # first in the verb queue: the promotion record must land,
                # and the fence rise, before any gang of this pass dies
                restarts.append(promote_entry)
                requeue = _merge_requeue(
                    requeue, self.cfg.recovery_backoff_base_s)
            if no_candidate:
                # the primary is disrupted but no caught-up follower can
                # be elected: the ordinary restart verbs below take over
                self.metrics.promotions.labels(
                    nb.namespace, PROMOTE_RESULT_NO_CANDIDATE).inc()
                span.add_event("promote.no_candidate", {
                    "primary": primary_replica})
            for idx, live_name, reasons, pending, healthy, trigger, \
                    stale_session in detections:
                if idx in skip_gangs:
                    # the gang demoted this pass: the promotion replaces
                    # its restart; it heals as a follower from the next
                    continue
                requeue = _merge_requeue(requeue, self._slice_pass(
                    nb, idx, live_name, reasons, pending, healthy, trigger,
                    stale_session, recovery, session_state, restarts,
                    events, notes, span, now,
                    allow_migrate=rep_spec is None,
                    observe_recovery=rep_spec is None or
                    idx // num_slices == primary_replica))

            # drop entries that emptied out, so the persisted bookkeeping
            # stays minimal and the no-op check stays meaningful
            for key in [k for k, s in recovery.items() if not s]:
                recovery.pop(key)
            for key in [k for k, s in session_state.items() if not s]:
                session_state.pop(key)
            exhausted = sorted(
                k for k, s in recovery.items() if s.get("exhausted"))
            # write-ahead: the budget charge and the restore intent survive
            # a crash between here and the pod deletes below.  The call is
            # unconditional (the unchanged check lives inside), so it
            # comes before every restart.
            self._write_bookkeeping(nb, recovery, exhausted, session_state,
                                    replication=replication,
                                    skip_if_unchanged=(prev_recovery,
                                                       prev_session,
                                                       prev_replication))
            for etype, reason, message in events:
                self._event(nb, etype, reason, message)

            for entry in restarts:
                if entry["verb"] == VERB_PROMOTE:
                    self._execute_promote(nb, entry)
                elif entry["verb"] == REASON_MIGRATE:
                    self._execute_migrate(nb, entry, stamp_restore,
                                          restart_slice)
                else:
                    self._execute_restart(nb, entry, span, stamp_restore,
                                          restart_slice)

            # the drain/defrag annotation is consumed once the gang got its
            # decision; a deferred gang (backoff armed, pods mid-recreate)
            # keeps it for the requeued retry
            if ann_trigger and not notes["deferred"]:
                self._clear_migrate_annotation(nb)
        return requeue

    # -- replicated tier ------------------------------------------------------
    def _record_followers(self, rep_spec, num_slices, detections,
                          gang_fresh, replication) -> None:
        """Mirror each follower's readiness and catch-up freshness into
        status.replication.followers: the operator's view of how hot each
        standby is."""
        p = replication["primary"]
        followers: dict = {}
        for r in range(rep_spec.replicas):
            if r == p:
                continue
            rec: dict = {"ready": True, "slices": {}}
            for s in range(num_slices):
                g = r * num_slices + s
                if g >= len(detections) or not detections[g][4]:
                    rec["ready"] = False
                if g < len(detections):
                    fresh = gang_fresh.get(g)
                    if fresh is not None:
                        rec["slices"][str(s)] = {
                            "generation": fresh[0], "seq": fresh[1],
                            "digest": fresh[2]}
            followers[str(r)] = rec
        replication["followers"] = followers

    def _promotion_decision(self, nb, rep_spec, num_slices, detections,
                            gang_fresh, replication,
                            recovery) -> tuple[Optional[dict], set[int],
                                               bool]:
        """The promote verb's decision for this pass: (promote entry or
        None, the gangs whose restart the promotion replaces this pass,
        the no-candidate flag).  A promotion record in flight (phase
        "promoting": a crash between the record and the flip) resumes
        ahead of any new election."""
        p = replication["primary"]
        promo = replication.get("promotion") or {}
        if promo.get("phase") == "promoting":
            started = promo.get("startedAt")
            entry = {
                "verb": VERB_PROMOTE, "resume": True,
                "epoch": promo["epoch"], "from": promo["from"],
                "to": promo["to"], "reason": promo.get("reason", ""),
                "disrupted_at": parse_iso(started) if started else None,
            }
            skip = set(range(promo["from"] * num_slices,
                             (promo["from"] + 1) * num_slices))
            return entry, skip, False
        primary_gangs = range(p * num_slices, (p + 1) * num_slices)
        primary_reasons = [
            det[2] for det in detections
            if det[0] in primary_gangs and det[2]]
        if not primary_reasons:
            return None, set(), False
        if self.session is None:
            # no delta stream to check the catch-up against: a promotion
            # would be a guess, so the ordinary verbs take over
            return None, set(), True
        best: Optional[tuple[tuple, int]] = None
        for r in range(rep_spec.replicas):
            if r == p:
                continue
            score = self._candidate_score(nb, r, num_slices, detections,
                                          gang_fresh)
            if score is None:
                continue
            if best is None or score > best[0]:
                best = (score, r)
        if best is None:
            return None, set(), True
        # the duration's anchor: the earliest disruption stamp among the
        # primary's gangs (a pass delayed by backoff keeps charging the
        # same incident), else this detection
        disrupted_at = None
        for g in primary_gangs:
            st = recovery.get(str(g)) or {}
            if st.get("disruptedAt"):
                t = parse_iso(st["disruptedAt"])
                disrupted_at = t if disrupted_at is None \
                    else min(disrupted_at, t)
        entry = {
            "verb": VERB_PROMOTE, "resume": False,
            "epoch": replication["epoch"] + 1,
            "from": p, "to": best[1],
            "reason": primary_reasons[0][0][1],
            "disrupted_at": disrupted_at if disrupted_at is not None
            else self.clock.now(),
        }
        return entry, set(primary_gangs), False

    def _candidate_score(self, nb, r, num_slices, detections,
                         gang_fresh) -> Optional[tuple]:
        """Follower replica r's election score, its per-gang (generation,
        seq) freshness, or None when a gang is unhealthy, unstamped, or
        trails the chain head by more than REPLICATION_MAX_LAG (a missing
        stamp never reads as caught up)."""
        score = []
        for s in range(num_slices):
            g = r * num_slices + s
            if g >= len(detections) or not detections[g][4]:
                return None
            fresh = gang_fresh.get(g)
            if fresh is None:
                return None
            head = self.session.chain_head(nb.namespace, nb.name, s)
            if head is None:
                return None
            gen, seq, _digest = fresh
            head_gen, head_seq, _head_digest = head
            lag = (1 + head_seq) if gen != head_gen \
                else max(head_seq - seq, 0)
            if lag > self.cfg.replication_max_lag:
                return None
            score.append((gen, seq))
        return tuple(score)

    def _execute_promote(self, nb, entry) -> None:
        """The promote verb, under its own `replication.promote` phase
        span.  The order is the guarantee:

        1. commit the write-ahead promotion record, with the epoch bumped
           in the same status write (a compare on the old epoch: a
           racing promoter loses cleanly);
        2. raise the session store's write fence to the new epoch, after
           which the demoted primary cannot ack a write;
        3. commit the flip: the new primary named, phase "promoted".

        A crash between any two steps resumes from the record
        (entry["resume"]): step 2 is a monotonic max and step 3 checks
        the record before it flips."""
        with _TRACER.start_span("replication.promote", {
            "phase": "promote", "namespace": nb.namespace,
            "notebook": nb.name, "epoch": entry["epoch"],
            "from": entry["from"], "to": entry["to"],
        }) as span:
            if not entry.get("resume"):
                if not self._commit_promotion_record(nb, entry):
                    span.add_event("promote.lost_race", {
                        "epoch": entry["epoch"]})
                    self.metrics.promotions.labels(
                        nb.namespace, PROMOTE_RESULT_LOST_RACE).inc()
                    return
            if self.session is not None:
                self.session.fence(nb.namespace, nb.name, entry["epoch"])
                span.add_event("promote.fenced", {
                    "epoch": entry["epoch"]})
            if not self._commit_promotion_flip(nb, entry):
                self.metrics.promotions.labels(
                    nb.namespace, PROMOTE_RESULT_LOST_RACE).inc()
                return
            duration = 0.0
            if entry.get("disrupted_at") is not None:
                duration = max(
                    self.clock.now() - entry["disrupted_at"], 0.0)
            tid = span.trace_id
            exemplar = {"trace_id": tid} if tid else None
            self.metrics.disruption_recovery_seconds.labels(
                nb.namespace).observe(duration, exemplar=exemplar)
            self.metrics.promotion_duration_seconds.labels(
                nb.namespace).observe(duration, exemplar=exemplar)
            self.metrics.promotions.labels(
                nb.namespace, PROMOTE_RESULT_PROMOTED).inc()
            span.add_event("promote.complete", {
                "epoch": entry["epoch"], "to": entry["to"],
                "seconds": duration})
            self._event(
                nb, "Normal", EVENT_PRIMARY_PROMOTED,
                "promoted replica %d to primary (epoch %d) after %s on "
                "replica %d; demoted gang rejoins as follower" % (
                    entry["to"], entry["epoch"],
                    entry["reason"] or "disruption", entry["from"]))

    def _commit_promotion_record(self, nb, entry) -> bool:
        """The write-ahead half: the epoch bump and the promotion record
        in one status commit, guarded on the epoch and primary the
        election read, so one promoter per epoch wins."""
        committed = {"ok": False}

        def write() -> None:
            committed["ok"] = False
            try:
                live = self.api.get("Notebook", nb.namespace, nb.name)
            except NotFoundError:
                return
            st = live.body.setdefault("status", {})
            rep = copy.deepcopy(st.get("replication") or {})
            if rep.get("epoch", 1) != entry["epoch"] - 1 or \
                    rep.get("primary", 0) != entry["from"]:
                return  # another promoter moved the authority first
            rep["epoch"] = entry["epoch"]
            rep["promotion"] = {
                "epoch": entry["epoch"],
                "from": entry["from"],
                "to": entry["to"],
                "phase": "promoting",
                "reason": entry["reason"],
                "startedAt": self.clock.now_iso(),
            }
            st["replication"] = rep
            self.api.update_status(live)
            committed["ok"] = True

        retry_on_conflict(write)
        return committed["ok"]

    def _commit_promotion_flip(self, nb, entry) -> bool:
        """The completion half: name the new primary and close the record,
        after checking that the committed record is still this one (epoch
        and target)."""
        done = {"ok": False}

        def write() -> None:
            done["ok"] = False
            try:
                live = self.api.get("Notebook", nb.namespace, nb.name)
            except NotFoundError:
                return
            st = live.body.setdefault("status", {})
            rep = copy.deepcopy(st.get("replication") or {})
            promo = rep.get("promotion") or {}
            if rep.get("epoch") != entry["epoch"] or \
                    promo.get("to") != entry["to"]:
                return  # superseded by a later promotion
            if promo.get("phase") == "promoted" and \
                    rep.get("primary") == entry["to"]:
                done["ok"] = True  # the resume found it complete
                return
            rep["primary"] = entry["to"]
            promo["phase"] = "promoted"
            promo["completedAt"] = self.clock.now_iso()
            rep["promotion"] = promo
            st["replication"] = rep
            self.api.update_status(live)
            done["ok"] = True

        retry_on_conflict(write)
        return done["ok"]

    # -- verb execution -------------------------------------------------------
    def _execute_restart(self, nb, entry, span, stamp_restore,
                         restart_slice) -> None:
        if entry.get("restamp") and stamp_restore is not None:
            # a dropped restore intent must leave the template too, or the
            # recreated pods would restore the retired generation
            stamp_restore(entry["live_name"], entry["idx"])
        span.add_event("slice.restart", {
            "slice": entry["idx"], "sts": entry["live_name"],
            "reason": entry["reason"], "pod": entry["pod"],
            "attempt": entry["attempt"], "backoff_s": entry["delay"],
        })
        self.metrics.slice_restarts.labels(
            nb.namespace, entry["reason"]).inc()
        if entry.get("fallback"):
            # a store is wired but could not supply a usable checkpoint
            self.metrics.migrations.labels(
                entry.get("trigger") or MIGRATE_TRIGGER_FAILURE,
                MIGRATE_RESULT_FALLBACK).inc()
        self._event(
            nb, "Normal", EVENT_SLICE_RECOVERY,
            "restarting gang %d (%s): %s is %s (attempt %d/%d, "
            "next backoff %.0fs)" % (
                entry["idx"], entry["live_name"],
                entry["pod"] or "workers", entry["reason"],
                entry["attempt"], self.cfg.recovery_max_attempts,
                entry["delay"]))
        restart_slice(entry["live_name"])

    def _execute_migrate(self, nb, entry, stamp_restore,
                         restart_slice) -> None:
        """The migrate verb, under its own `migrate` phase span: the
        restore stamp first (the recreated pods must boot with the restore
        env), then the gang-atomic restart.  The write-ahead
        status.sessionState record already landed."""
        snap: SnapshotInfo = entry["snap"]
        trigger = entry.get("trigger") or MIGRATE_TRIGGER_FAILURE
        with _TRACER.start_span("migrate", {
            "phase": "migrate", "namespace": nb.namespace,
            "notebook": nb.name, "slice": entry["idx"], "trigger": trigger,
        }) as span:
            span.add_event("migrate.snapshot", {
                "slice": entry["idx"], "generation": snap.generation,
                "digest": snap.digest, "age_s": entry["ckpt_age_s"],
            })
            self.metrics.slice_restarts.labels(
                nb.namespace, REASON_MIGRATE).inc()
            self.metrics.migrations.labels(
                trigger, MIGRATE_RESULT_MIGRATED).inc()
            self._event(
                nb, "Normal", EVENT_SLICE_MIGRATION,
                "migrating gang %d (%s): %s; restoring checkpoint "
                "generation %d (age %.0fs, attempt %d/%d)" % (
                    entry["idx"], entry["live_name"],
                    entry["reason_detail"], snap.generation,
                    entry["ckpt_age_s"], entry["attempt"],
                    self.cfg.recovery_max_attempts))
            if stamp_restore is not None:
                stamp_restore(entry["live_name"], entry["idx"])
                span.add_event("migrate.restore_stamped", {
                    "sts": entry["live_name"],
                    "generation": snap.generation,
                })
            restart_slice(entry["live_name"])
            span.add_event("slice.restart", {
                "slice": entry["idx"], "sts": entry["live_name"],
                "reason": REASON_MIGRATE, "attempt": entry["attempt"],
                "backoff_s": entry["delay"],
            })

    # -- per-gang decision ----------------------------------------------------
    def _slice_pass(self, nb, idx, live_name, reasons, pending, healthy,
                    trigger, stale_session, recovery, session_state,
                    restarts, events, notes, span, now, *,
                    allow_migrate: bool = True,
                    observe_recovery: bool = True) -> float:
        # `allow_migrate=False` (replicated notebooks) forces the bare
        # restart: the delta stream is the migration, and a failed or
        # demoted follower gang restarts and catches up.
        # `observe_recovery=False` keeps a follower gang's repair out of
        # notebook_disruption_recovery_seconds: for a replicated notebook
        # only the primary's recoveries (and promotions) are disruptions
        # a user sees.
        key = str(idx)
        state = recovery.get(key, {})
        session = session_state.get(key, {})

        # an incomplete migration (a worker provably still on the old
        # session survived the restart) re-enters the migrate flow through
        # the same budget, so a gang that can never finish still exhausts
        if stale_session and trigger is None and not reasons and \
                not pending:
            trigger = session.get("trigger") or MIGRATE_TRIGGER_FAILURE
            span.add_event("migrate.incomplete", {
                "slice": idx,
                "generation": session.get("restoreGeneration")})

        # Pending becomes a disruption only past the schedule deadline
        reason = reasons[0][1] if reasons else None
        pod_name = reasons[0][0] if reasons else ""
        if reason is None and pending:
            since = state.get("pendingSince")
            if not since:
                state["pendingSince"] = self.clock.now_iso()
                recovery[key] = state
                return self.cfg.recovery_pending_deadline_s
            waited = now - parse_iso(since)
            if waited < self.cfg.recovery_pending_deadline_s:
                return self.cfg.recovery_pending_deadline_s - waited
            reason = REASON_PENDING_TIMEOUT
        elif not pending:
            state.pop("pendingSince", None)

        if reason is None and trigger is None:
            if healthy and session.get("phase") == "migrating":
                # the migrated gang came back Ready: the restore is done
                self._migration_restored(idx, session, events, span)
                session_state[key] = session
            if healthy and state:
                self._slice_recovered(nb, idx, state, events, span, now,
                                      observe_recovery=observe_recovery)
                if state:
                    recovery[key] = state
                else:
                    recovery.pop(key, None)
            elif state:
                recovery[key] = state  # the pendingSince cleanup above
            return 0.0

        voluntary = reason is None
        if voluntary and not healthy:
            # mid-recreate or not yet Ready: neither disrupted nor safe to
            # snapshot; let the gang settle and keep the request
            notes["deferred"] = True
            if state:
                recovery[key] = state
            return self.cfg.recovery_backoff_base_s

        # -- disrupted or migrating of its own accord -------------------------
        if voluntary:
            span.add_event("migrate.requested", {
                "slice": idx, "sts": live_name, "trigger": trigger})
        else:
            span.add_event("slice.disrupted", {
                "slice": idx, "sts": live_name, "reason": reason,
                "pod": pod_name,
            })
        if state.get("exhausted"):
            # terminal until an operator action turns the gang Healthy
            # again (_slice_recovered then resets the budget)
            recovery[key] = state
            return 0.0
        if not voluntary:
            state.setdefault("disruptedAt", self.clock.now_iso())
        state["reason"] = reason if reason is not None else trigger
        attempts = [t for t in state.get("attempts", [])
                    if now - parse_iso(t) < self.cfg.recovery_window_s]
        state["attempts"] = attempts

        until = state.get("backoffUntil")
        if until and now < parse_iso(until):
            remaining = parse_iso(until) - now
            span.add_event("recovery.backoff_wait", {
                "slice": idx, "remaining_s": remaining})
            recovery[key] = state
            if voluntary:
                notes["deferred"] = True
            return remaining

        if len(attempts) >= self.cfg.recovery_max_attempts:
            state["exhausted"] = True
            recovery[key] = state
            span.add_event("recovery.exhausted", {
                "slice": idx, "attempts": len(attempts),
                "reason": state["reason"]})
            events.append((
                "Warning", EVENT_RECOVERY_EXHAUSTED,
                "gang %d (%s) spent its restart budget (%d restarts in "
                "%.0fs) on %s; manual intervention required" % (
                    idx, live_name, len(attempts),
                    self.cfg.recovery_window_s, state["reason"])))
            logger.error(
                "recovery exhausted for %s/%s gang %d after %d attempts "
                "(%s)", nb.namespace, nb.name, idx, len(attempts),
                state["reason"])
            return 0.0

        # verb decision: migrate when a usable checkpoint can be secured
        use_session = self.session is not None and allow_migrate
        snap = None
        ckpt_age = 0.0
        if use_session:
            snap, ckpt_age = self._secure_checkpoint(nb, idx, span, now)
        if snap is None and voluntary:
            # a healthy session is never torn down without its state in
            # hand: skip, tell the operator, consume the request
            events.append((
                "Warning", EVENT_MIGRATION_SKIPPED,
                "gang %d (%s): voluntary migration (%s) skipped — no "
                "session checkpoint within %.0fs" % (
                    idx, live_name, trigger,
                    self.cfg.checkpoint_max_age_s)))
            self.metrics.migrations.labels(
                trigger, MIGRATE_RESULT_SKIPPED).inc()
            if state:
                recovery[key] = state
            return 0.0

        delay = min(
            self.cfg.recovery_backoff_base_s * (2 ** len(attempts)),
            self.cfg.recovery_backoff_max_s)
        stamp = self.clock.now_iso()
        attempts.append(stamp)
        state["lastRestartTime"] = stamp
        state["backoffUntil"] = _iso_at(now + delay)
        recovery[key] = state
        restamp = False
        if snap is None and session.get("restoreGeneration") is not None:
            # the bare fallback restarts cold: retire the old restore
            # intent (write-ahead) so the recreated pods do not restore an
            # old generation
            session_state.pop(key, None)
            session = {}
            restamp = True
        entry = {
            "idx": idx, "live_name": live_name,
            "reason": state["reason"], "pod": pod_name,
            "attempt": len(attempts), "delay": delay,
            "verb": REASON_MIGRATE if snap is not None else "restart",
            "trigger": (trigger if voluntary else MIGRATE_TRIGGER_FAILURE)
            if use_session else None,
            "snap": snap, "ckpt_age_s": ckpt_age,
            "restamp": restamp,
            "fallback": snap is None and use_session,
            "reason_detail": ("voluntary %s" % trigger) if voluntary
            else "%s is %s" % (pod_name or "workers", state["reason"]),
        }
        if snap is not None:
            # write-ahead restore intent, in status.sessionState before
            # any pod dies, so a failover resumes the restore
            session.update({
                "restoreGeneration": snap.generation,
                "restoreUri": snap.uri,
                "digest": snap.digest,
                "savedAt": _iso_at(snap.saved_at),
                "trigger": entry["trigger"],
                "phase": "migrating",
                "migratedAt": self.clock.now_iso(),
            })
            session.pop("restoredAt", None)
            session_state[key] = session
        restarts.append(entry)
        return delay

    def _secure_checkpoint(self, nb: Notebook, idx: int, span,
                           now: float) -> tuple[Optional[SnapshotInfo],
                                                float]:
        """The checkpoint for a migrate decision: a final snapshot when the
        gang can still flush, else the freshest stored one within
        CHECKPOINT_MAX_AGE_S.  (None, age) leaves the bare restart."""
        final = self.session.request_final_snapshot(
            nb.namespace, nb.name, idx)
        if final is not None:
            self.metrics.checkpoint_snapshots.labels(
                nb.namespace, TRIGGER_FINAL).inc()
            self.metrics.checkpoint_age_seconds.labels(
                nb.namespace).observe(0.0)
            span.add_event("checkpoint.final", {
                "slice": idx, "generation": final.generation})
            return final, 0.0
        latest = self.session.latest(nb.namespace, nb.name, idx)
        if latest is None:
            span.add_event("checkpoint.missing", {"slice": idx})
            return None, 0.0
        age = max(now - latest.saved_at, 0.0)
        self.metrics.checkpoint_age_seconds.labels(
            nb.namespace).observe(age)
        if age <= self.cfg.checkpoint_max_age_s:
            span.add_event("checkpoint.fresh", {
                "slice": idx, "generation": latest.generation,
                "age_s": age})
            return latest, age
        span.add_event("checkpoint.stale", {
            "slice": idx, "generation": latest.generation, "age_s": age})
        return None, age

    def _migration_restored(self, idx, session, events, span) -> None:
        """The migrated gang reads Healthy: the write-ahead record reaches
        its terminal phase, once (a second manager seeing "restored"
        does nothing)."""
        session["phase"] = "restored"
        session["restoredAt"] = self.clock.now_iso()
        span.add_event("migrate.restored", {
            "slice": idx, "generation": session.get("restoreGeneration")})
        self.metrics.migrations.labels(
            session.get("trigger") or MIGRATE_TRIGGER_FAILURE,
            MIGRATE_RESULT_RESTORED).inc()
        events.append((
            "Normal", EVENT_MIGRATION_COMPLETE,
            "gang %d restored session checkpoint generation %s after "
            "migration" % (idx, session.get("restoreGeneration"))))

    def _slice_recovered(self, nb, idx, state, events, span, now, *,
                         observe_recovery: bool = True) -> None:
        """The disruption is over: observe the detection -> Healthy latency
        once and drop the transient fields.  Attempt stamps stay and age
        out of the window (the flap guard), except after exhaustion,
        where a Healthy gang means an operator fixed it and earns a fresh
        budget.  `observe_recovery=False` (a replicated notebook's
        follower gang) heals the bookkeeping without charging the
        disruption histogram."""
        if observe_recovery and state.get("disruptedAt"):
            duration = max(now - parse_iso(state["disruptedAt"]), 0.0)
            tid = span.trace_id
            self.metrics.disruption_recovery_seconds.labels(
                nb.namespace).observe(
                    duration, exemplar={"trace_id": tid} if tid else None)
            span.add_event("recovery.healthy", {
                "slice": idx, "seconds": duration})
        if state.pop("exhausted", False):
            state.pop("attempts", None)
            state.pop("backoffUntil", None)
            events.append((
                "Normal", EVENT_RECOVERY_RESTORED,
                "gang %d is Healthy again after exhaustion; restart "
                "budget reset" % idx))
        # backoffUntil survives healing on purpose: a gang that flaps
        # (fail -> restart -> Healthy -> fail) still waits out the armed
        # backoff; it expires on its own
        for field in ("disruptedAt", "reason", "pendingSince"):
            state.pop(field, None)
        if not state.get("attempts"):
            state.pop("attempts", None)
            state.pop("lastRestartTime", None)
            state.pop("backoffUntil", None)

    # -- persistence ----------------------------------------------------------
    def _write_bookkeeping(self, nb: Notebook, recovery: dict,
                           exhausted: Optional[list[str]] = None,
                           session_state: Optional[dict] = None,
                           replication: Optional[dict] = None,
                           skip_if_unchanged: Optional[tuple] = None) -> None:
        """Persist status.sliceRecovery and status.sessionState (the
        followers' half of status.replication too, and the
        RecoveryExhausted condition) with conflict retry, before any pod
        delete of the same pass.  `session_state` None leaves
        status.sessionState as it is (the Stopped cleanup drops only the
        budget: the pre-cull checkpoint record survives); `replication`
        None likewise.  `skip_if_unchanged=(prev_recovery, prev_session[,
        prev_replication])` makes an unchanged write a no-op."""
        if skip_if_unchanged is not None and \
                recovery == skip_if_unchanged[0] and \
                session_state == skip_if_unchanged[1] and \
                (len(skip_if_unchanged) < 3 or
                 replication == skip_if_unchanged[2]):
            return
        exhausted = exhausted or []

        def write() -> None:
            try:
                live = self.api.get("Notebook", nb.namespace, nb.name)
            except NotFoundError:
                return
            st = live.body.setdefault("status", {})
            if recovery:
                st["sliceRecovery"] = copy.deepcopy(recovery)
            else:
                st.pop("sliceRecovery", None)
            if session_state is not None:
                if session_state:
                    st["sessionState"] = copy.deepcopy(session_state)
                else:
                    st.pop("sessionState", None)
            if replication is not None:
                # the epoch-regression guard: a promoter may have bumped
                # the authority between this pass's read and this write,
                # and the followers' record must never roll back the
                # epoch, the primary or the promotion record
                live_rep = st.get("replication") or {}
                if live_rep.get("epoch", 0) <= replication.get("epoch", 1):
                    merged = copy.deepcopy(live_rep)
                    merged.update(copy.deepcopy(replication))
                    st["replication"] = merged
            conds = list(st.get("conditions") or [])
            existing = next(
                (c for c in conds
                 if c.get("type") == CONDITION_RECOVERY_EXHAUSTED), None)
            if exhausted:
                if existing is None or existing.get("status") != "True":
                    conds = [c for c in conds
                             if c.get("type") != CONDITION_RECOVERY_EXHAUSTED]
                    conds.append({
                        "type": CONDITION_RECOVERY_EXHAUSTED,
                        "status": "True",
                        "reason": "RestartBudgetSpent",
                        "message": "gang(s) %s spent the restart budget "
                                   "(%d attempts within %.0fs)" % (
                                       ",".join(exhausted),
                                       self.cfg.recovery_max_attempts,
                                       self.cfg.recovery_window_s),
                        "lastTransitionTime": self.clock.now_iso(),
                    })
            elif existing is not None:
                conds = [c for c in conds
                         if c.get("type") != CONDITION_RECOVERY_EXHAUSTED]
            st["conditions"] = conds
            self.api.update_status(live)

        retry_on_conflict(write)

    def _clear_migrate_annotation(self, nb: Notebook) -> None:
        def clear() -> None:
            try:
                live = self.api.get("Notebook", nb.namespace, nb.name)
            except NotFoundError:
                return
            if C.ANNOTATION_MIGRATE in live.metadata.annotations:
                live.metadata.annotations.pop(C.ANNOTATION_MIGRATE, None)
                self.api.update(live)

        retry_on_conflict(clear)


def _merge_requeue(current: float, hint: float) -> float:
    """Combine requeue-after hints: 0 means none; otherwise the soonest
    wins."""
    if hint <= 0:
        return current
    if current <= 0:
        return hint
    return min(current, hint)


def _iso_at(t: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t))


__all__ = [
    "EVENT_MIGRATION_COMPLETE",
    "EVENT_MIGRATION_SKIPPED",
    "EVENT_PRIMARY_PROMOTED",
    "EVENT_RECOVERY_EXHAUSTED",
    "EVENT_RECOVERY_RESTORED",
    "EVENT_SLICE_MIGRATION",
    "EVENT_SLICE_RECOVERY",
    "MIGRATE_RESULT_FALLBACK",
    "MIGRATE_RESULT_MIGRATED",
    "MIGRATE_RESULT_RESTORED",
    "MIGRATE_RESULT_SKIPPED",
    "MIGRATE_TRIGGER_DEFRAG",
    "MIGRATE_TRIGGER_DRAIN",
    "MIGRATE_TRIGGER_FAILURE",
    "MIGRATE_TRIGGER_NODE_DRAIN",
    "PENDING",
    "PROMOTE_RESULT_LOST_RACE",
    "PROMOTE_RESULT_NO_CANDIDATE",
    "PROMOTE_RESULT_PROMOTED",
    "REASON_CRASH_LOOP",
    "REASON_MIGRATE",
    "REASON_NODE_GONE",
    "REASON_PENDING_TIMEOUT",
    "REASON_POD_FAILED",
    "RecoveryEngine",
    "SliceRestartError",
    "VERB_PROMOTE",
    "classify_worker",
    "node_drained",
]
