"""Topology-aware gang scheduler and warm-pool autoscaler, for GPU gangs.

The port of kubeflow_tpu/core/scheduler.py for `spec.gpu` gangs.  A
multi-host GPU gang needs placement as much as a TPU slice does: NCCL
forms its world only when every rank starts, and a half-placed gang holds
cards that nothing can use.  So placement and capacity are owned here:

- **Gang placement intent.**  `SliceScheduler` reconciles Notebooks and
  writes an all-or-nothing placement intent
  (`notebooks.kubeflow.org/placement`, JSON: gang index -> node-pool
  assignment) before any workload StatefulSet exists.  The notebook
  controller gang-gates rendering on it, and the renderer turns each
  assignment into a `cloud.google.com/gke-nodepool` nodeSelector, which
  co-locates the whole gang on one pool.

- **PlacementPolicy.**  `CostFunctionPolicy` is the deterministic
  default: best-fit for multi-host gangs (the feasible pool with the
  least leftover GPUs), spreading for single-host ones (the node with the
  most free GPUs).

- **Warm pool.**  One cluster-scoped `GPUWarmPool` object per shape (an
  accelerator and a GPU count, `WARMPOOL_SHAPES="h100-80gb:8,
  h100-80gb:16"`, resolved by gpu/topology.py) tracks pre-provisioned
  gangs through Provisioning -> Ready -> Claimed.  A new Notebook claims
  a Ready gang; a miss reserves a dedicated cold provision (written
  ahead, so a crash resumes it instead of provisioning twice).  All claim
  and release state lives in the pool object's status.

- **Culling -> reclamation.**  A stopped notebook's claims drain back
  into the pool as Ready once its `sliceHealth` reads Stopped, which
  postdates the checkpoint-on-cull handshake.

- **Autoscaler.**  `WarmPoolController` grows each managed pool's target
  by the misses since its last pass (bounded by WARMPOOL_MAX_SIZE) and
  decays it one step toward WARMPOOL_SIZE while the hit rate holds.

- **Tenancy.**  `_admission` gates every placement on the tenant's GPU
  quota and weighted fair share, in the aged dequeue order, and an
  admitted gang that still waits on a cold provision asks the
  PreemptionEngine (core/preemption.py) to free lower-priority capacity.

Where the reference counts TPU chips, this module counts GPUs
(`nvidia.com/gpu`); the TenantQuota keeps the reference's schema, so its
`chipQuota` counts accelerator devices, GPUs here.  A GPU notebook has
one gang (index 0) per replica where the reference has `spec.tpu.slices`
slices; the status keys, metric names, event reasons and the
slice-named constants are the reference's, and messages read "gang".
A replicated notebook (`spec.replication`) places one gang per replica;
under `antiAffine` replica R's gang lands on a node pool that no other
replica's gang uses, so one pool failure cannot take the primary and its
follower together, and the verdict is rebuilt from the claims already
held, so it survives crash recovery.  Everything is timed off the
injected Clock, so the subsystem is FakeClock-exact.
"""

from __future__ import annotations

import copy
import json
import logging
from dataclasses import dataclass
from typing import Optional, Protocol

from ..api.types import (
    PRIORITY_DEFAULT,
    PRIORITY_RANK,
    InvalidError as SpecError,
    Notebook,
)
from ..gpu.topology import GpuShape, TopologyError, resolve
from ..kube import (
    AlreadyExistsError,
    ApiServer,
    EventRecorder,
    EventType,
    KubeObject,
    Manager,
    ObjectMeta,
    Request,
    Result,
    WatchSpec,
    parse_quantity,
    retry_on_conflict,
)
from ..utils import tracing
from ..utils.clock import Clock
from ..utils.config import CoreConfig
from . import constants as C
from .metrics import NotebookMetrics, placement_gpus
from .workload import placement_of

logger = logging.getLogger("kubeflow_tpu_torch.scheduler")

# the `schedule` phase span parents onto the manager's per-attempt
# reconcile root via the shared context stack
_TRACER = tracing.get_tracer("kubeflow_tpu_torch.core.scheduler")

# schedule-attempt outcomes, a bounded set: they label
# notebook_schedule_attempts_total{result}
SCHEDULE_PLACED = "placed"
SCHEDULE_NOOP = "noop"
SCHEDULE_WAIT = "wait-provisioning"
SCHEDULE_RELEASED = "released"
SCHEDULE_QUEUED = "queued"

# warm-pool claim outcomes, a bounded set: they label
# notebook_warmpool_hits_total{result}
CLAIM_HIT = "hit"            # claimed a pre-provisioned Ready gang
CLAIM_MISS = "miss"          # cold path: dedicated provision reserved
CLAIM_BYPASS = "bypass"      # placed on pre-existing unmanaged capacity

# event reasons (kubectl describe notebook), the reference's
EVENT_SCHEDULED = "SliceScheduled"
EVENT_RELEASED = "SliceReleased"


def pool_object_name(accelerator: str, count) -> str:
    return f"warmpool-{accelerator}-{count}"


def _shape_key(shape: GpuShape) -> tuple[str, int]:
    return shape.accelerator.name, shape.gpus


def parse_warmpool_shapes(shapes: str) -> list[tuple[str, int]]:
    """WARMPOOL_SHAPES="h100-80gb:8,h100-80gb:16" -> [(accelerator,
    count)].  Malformed entries are skipped (config must never take the
    manager down), duplicates collapse."""
    out: list[tuple[str, int]] = []
    for part in shapes.split(","):
        part = part.strip()
        if not part:
            continue
        accel, _, count = part.partition(":")
        if not accel or not count:
            continue
        try:
            shape = resolve(accel, int(count))
        except (TopologyError, ValueError):
            logger.warning("WARMPOOL_SHAPES: skipping malformed %r", part)
            continue
        if _shape_key(shape) not in out:
            out.append(_shape_key(shape))
    return out


def placement_covers(nb: Notebook, num_gangs: int) -> bool:
    """True when the intent assigns a pool to every gang: the gang gate
    the notebook controller holds StatefulSet rendering on."""
    gangs = placement_of(nb.annotations)
    return all((gangs.get(str(i)) or {}).get("pool")
               for i in range(num_gangs))


# -- tenancy policy ------------------------------------------------------------
def tenant_policy(quota_obj: Optional[KubeObject], namespace: str) -> dict:
    """Effective tenancy policy for one namespace: the TenantQuota spec's
    per-tenant entry over its spec.defaults over the module defaults.
    `chip_quota` (the schema's `chipQuota`) counts GPUs; <= 0 means
    unlimited.  The weight is clamped positive so the fair-share division
    is always defined."""
    out = {"chip_quota": 0.0, "weight": 1.0, "priority": PRIORITY_DEFAULT}
    if quota_obj is None:
        return out
    spec = quota_obj.spec
    defaults = spec.get("defaults") or {}
    tenant = (spec.get("tenants") or {}).get(namespace) or {}

    def _num(key: str, fallback: float) -> float:
        # layered: a malformed per-tenant value falls back to the cluster
        # default, never to "unlimited"
        for src in (tenant, defaults):
            if key in src:
                try:
                    return float(src[key] or 0.0)
                except (TypeError, ValueError):
                    continue
        return fallback

    out["chip_quota"] = _num("chipQuota", 0.0)
    out["weight"] = max(_num("weight", 1.0), 1e-9)
    merged = dict(defaults)
    merged.update(tenant)
    if merged.get("priority") in PRIORITY_RANK:
        out["priority"] = merged["priority"]
    return out


def resolve_priority(nb: Notebook,
                     quota_obj: Optional[KubeObject]) -> str:
    """A notebook's effective priority class: explicit spec.priority
    wins, else the tenant default from TenantQuota, else "standard"."""
    p = nb.priority
    if p in PRIORITY_RANK:
        return p
    return tenant_policy(quota_obj, nb.namespace)["priority"]


def rank_of(priority: Optional[str]) -> int:
    return PRIORITY_RANK.get(priority or "",
                             PRIORITY_RANK[PRIORITY_DEFAULT])


def gang_chips(obj: KubeObject) -> float:
    """GPUs one notebook's gangs occupy when placed: the gang's GPUs
    times replicas (0.0 for CPU notebooks and unresolvable shapes)."""
    rep = (obj.spec.get("replication") or {}).get("replicas")
    try:
        replicas = max(int(rep), 1) if rep else 1
    except (TypeError, ValueError):
        replicas = 1
    return placement_gpus(obj) * replicas


def queued_info(annotations: dict) -> dict:
    """The queued annotation's JSON body ({since, priority, reason});
    {} when absent or malformed."""
    raw = (annotations or {}).get(C.ANNOTATION_QUEUED)
    if not raw:
        return {}
    try:
        doc = json.loads(raw)
    except ValueError:
        return {}
    return doc if isinstance(doc, dict) else {}


def _mutate_queue_stamp(api, namespace: str, name: str, fn) -> bool:
    """Annotation-only read-modify-write of the admission-queue stamp;
    True when the write changed something.  The stamp is not an intent:
    a gang the admission gate parks holds no claims, so there is no
    crash-recovery record to order it against, and it stays out of the
    placement and release methods."""
    changed = [False]

    def stamp_rmw() -> None:
        live = api.get("Notebook", namespace, name)
        before = dict(live.metadata.annotations)
        fn(live.metadata.annotations)
        if live.metadata.annotations != before:
            api.update(live)
            changed[0] = True

    retry_on_conflict(stamp_rmw)
    return changed[0]


# -- placement policy ----------------------------------------------------------
@dataclass(frozen=True)
class NodeCapacity:
    """One schedulable node as the policy sees it: its pool and the GPUs
    still free after bound pods and standing reservations."""

    name: str
    pool: str
    free_chips: float
    total_chips: float


@dataclass(frozen=True)
class GangPlacement:
    """All-or-nothing verdict: the pool the gang lands on and the exact
    node set, or nothing at all."""

    pool: str
    nodes: tuple[str, ...]


class PlacementPolicy(Protocol):
    """The pluggable placement decision.  Must be deterministic for a
    given inventory: the scheduler replays it on retries and across
    failovers and expects the same answer."""

    def place(self, shape: GpuShape,
              nodes: list[NodeCapacity]) -> Optional[GangPlacement]: ...


class CostFunctionPolicy:
    """Deterministic cost-function placement.

    Multi-host gangs: feasible pools are those with >= num_hosts nodes
    each fitting gpus_per_host; the chosen pool minimizes the GPUs left
    free after placement (best fit: it keeps big pools free for big
    gangs), ties broken by pool name; within the pool the fullest fitting
    nodes are taken first.  Never returns a partial gang.

    Single-host gangs: spread, the node with the most free GPUs wins (ties
    by name), so interactive notebooks distribute instead of stacking."""

    def place(self, shape: GpuShape,
              nodes: list[NodeCapacity]) -> Optional[GangPlacement]:
        need = float(shape.gpus_per_host)
        fitting = [n for n in nodes if n.free_chips >= need]
        if shape.num_hosts == 1:
            if not fitting:
                return None
            best = sorted(fitting, key=lambda n: (-n.free_chips, n.name))[0]
            return GangPlacement(best.pool, (best.name,))
        by_pool: dict[str, list[NodeCapacity]] = {}
        for n in fitting:
            by_pool.setdefault(n.pool, []).append(n)
        candidates: list[tuple[float, str, tuple[str, ...]]] = []
        for pool, members in sorted(by_pool.items()):
            if len(members) < shape.num_hosts:
                continue
            chosen = sorted(members, key=lambda n: (n.free_chips, n.name))
            chosen = chosen[: shape.num_hosts]
            leftover = sum(n.free_chips for n in members) \
                - shape.num_hosts * need
            candidates.append(
                (leftover, pool, tuple(n.name for n in chosen)))
        if not candidates:
            return None
        _, pool, names = min(candidates)
        return GangPlacement(pool, names)


# -- gang scheduler controller -------------------------------------------------
class SliceScheduler:
    """Owns the Notebook -> capacity binding: warm claims, cold
    provisioning reservations, bypass placement on unmanaged capacity,
    and culling->reclamation release.  All bookkeeping rides the shape's
    GPUWarmPool status (one object per shape; optimistic concurrency
    serializes racing claims), and the final intent is the placement
    annotation, written only once every gang has an assignment."""

    def __init__(
        self,
        api: ApiServer,
        cfg: CoreConfig,
        metrics: NotebookMetrics,
        recorder: Optional[EventRecorder] = None,
        clock: Optional[Clock] = None,
        cache=None,
        policy: Optional[PlacementPolicy] = None,
    ):
        self.api = api
        self.cfg = cfg
        self.metrics = metrics
        self.recorder = recorder or EventRecorder(api, "slice-scheduler")
        self.clock = clock or Clock()
        self.cache = cache
        self.policy = policy or CostFunctionPolicy()
        # the PreemptionEngine attached by setup_scheduler: consulted when
        # an admitted gang still cannot place (a cold-provision wait)
        self.preemption = None

    def reconcile(self, req: Request) -> Result:
        if self.cache is not None:
            obj = self.cache.get("Notebook", req.namespace, req.name)
        else:
            obj = self.api.try_get("Notebook", req.namespace, req.name)
        if obj is None:
            return Result()  # deletion: the pool controller GCs claims
        nb = Notebook(obj.to_dict())
        _TRACER.current_span().set_attribute(
            "generation", int(obj.metadata.generation or 1))
        gpu = nb.gpu
        if gpu is None or obj.metadata.deletion_timestamp is not None:
            return Result()
        try:
            shape = gpu.validate()
        except SpecError:
            return Result()  # the admission hook's problem, not ours
        with _TRACER.start_span(
            "schedule",
            {"phase": "schedule", "namespace": req.namespace,
             "notebook": req.name},
        ) as span:
            if C.STOP_ANNOTATION in nb.annotations:
                return self._release(nb, shape, span)
            rep = nb.replication
            return self._place(nb, shape, span,
                               replicas=rep.replicas if rep else 1,
                               anti_affine=bool(rep and rep.anti_affine))

    def _event(self, nb: Notebook, etype: str, reason: str,
               message: str) -> None:
        self.recorder.event(KubeObject.from_dict(nb.obj), etype, reason,
                            message)

    # -- placement -------------------------------------------------------------
    def _place(self, nb: Notebook, shape: GpuShape, span,
               replicas: int = 1, anti_affine: bool = False) -> Result:
        """Place every gang of the notebook, one per replica (flat gang
        index = replica index, the renderer's).  With `anti_affine`
        (replicated notebooks) each replica's gang lands on a node pool
        that no other replica's gang occupies."""
        key = f"{nb.namespace}/{nb.name}"
        total_gangs = max(replicas, 1)
        # tenancy admission gate: before any claim is written, a gang over
        # its tenant's quota or weighted fair share, or behind a
        # higher-scoring queued gang, parks as Queued
        gate = self._admission(nb, shape, total_gangs, span)
        if gate is not None:
            return gate
        out: dict = {}

        def attempt() -> None:
            # the eviction fence, re-checked on every conflict retry: an
            # eviction that committed after admission passed must not let
            # this stale pass re-claim the slices it just freed
            live_nb = self.api.try_get("Notebook", nb.namespace, nb.name)
            if live_nb is None or self._pending_eviction(key) or \
                    self._preempt_fence_holds(
                        live_nb.metadata.annotations or {}):
                out.clear()
                out["fenced"] = True
                return
            out.pop("fenced", None)
            live = self._ensure_pool(shape)
            before = copy.deepcopy(live.body.get("status") or {})
            st = copy.deepcopy(before)
            st.setdefault("target", self.cfg.warmpool_size)
            st.setdefault("seq", 0)
            for k in ("hits", "misses", "bypass"):
                st.setdefault(k, 0)
            slices = st.setdefault("slices", {})
            claims = {CLAIM_HIT: 0, CLAIM_MISS: 0, CLAIM_BYPASS: 0}
            assignments: dict[int, str] = {}
            waiting = False

            # adopt claims and reservations already held (crash recovery:
            # the claim is written ahead of the annotation)
            for sid in sorted(slices):
                e = slices[sid]
                if e.get("claimedBy") != key:
                    continue
                idx = e.get("claimedSlice")
                if isinstance(idx, int) and 0 <= idx < total_gangs \
                        and idx not in assignments:
                    assignments[idx] = sid
                else:
                    self._release_entry(slices, sid)  # stale (scale-in)

            # the pools each replica's gang already occupies (adopted
            # claims count: the anti-affinity verdict survives crash
            # recovery); a replica's gang index is the replica's
            pools_by_replica: dict[int, set[str]] = {}
            for idx, sid in assignments.items():
                pool = slices[sid].get("pool", "")
                if pool:
                    pools_by_replica.setdefault(idx, set()).add(pool)

            def foreign_pools(gang: int) -> set[str]:
                if not anti_affine:
                    return set()
                return {p for r, ps in pools_by_replica.items()
                        if r != gang for p in ps}

            def claim(idx: int, sid: str) -> None:
                assignments[idx] = sid
                pools_by_replica.setdefault(idx, set()).add(
                    slices[sid].get("pool", ""))

            def ready_unclaimed(idx: int) -> Optional[str]:
                excluded = foreign_pools(idx)
                return next(
                    (s for s in sorted(slices)
                     if slices[s].get("state") == C.WARMSLICE_READY
                     and not slices[s].get("claimedBy")
                     and not slices[s].get("external")
                     and slices[s].get("pool", "") not in excluded),
                    None)

            def inventory(idx: int) -> list[NodeCapacity]:
                excluded = foreign_pools(idx)
                return [n for n in self._inventory(shape, st)
                        if n.pool not in excluded]

            def external_claim(idx: int, gp: GangPlacement) -> str:
                st["seq"] += 1
                nsid = f"ws-{st['seq']:04d}"
                slices[nsid] = {
                    "state": C.WARMSLICE_CLAIMED,
                    "external": True,
                    "pool": gp.pool,
                    "nodes": list(gp.nodes),
                    "claimedBy": key,
                    "claimedSlice": idx,
                }
                return nsid

            for idx in range(total_gangs):
                sid = assignments.get(idx)
                if sid is not None:
                    e = slices[sid]
                    if e.get("state") == C.WARMSLICE_PROVISIONING:
                        # a Ready gang freed since this cold reservation
                        # was written (a release, or a preemption for this
                        # very gang) serves it now; no hit/miss accounting,
                        # the miss was counted with the reservation
                        swap = ready_unclaimed(idx)
                        if swap is not None:
                            del slices[sid]
                            slices[swap].update({
                                "state": C.WARMSLICE_CLAIMED,
                                "claimedBy": key,
                                "claimedSlice": idx,
                            })
                            claim(idx, swap)
                            continue
                        # no Ready gang, but unmanaged capacity may have
                        # freed (a bypass-placed victim's external claim
                        # vanishes on release): retry bypass, so that a
                        # preemption hands the GPUs over now
                        gp = self.policy.place(shape, inventory(idx))
                        if gp is not None:
                            del slices[sid]
                            claim(idx, external_claim(idx, gp))
                        else:
                            waiting = True
                    elif e.get("state") == C.WARMSLICE_READY:
                        e["state"] = C.WARMSLICE_CLAIMED
                    continue
                # warm claim: the lowest-id Ready unclaimed pool gang on
                # a pool no other replica occupies
                cand = ready_unclaimed(idx)
                if cand is not None:
                    slices[cand].update({
                        "state": C.WARMSLICE_CLAIMED,
                        "claimedBy": key,
                        "claimedSlice": idx,
                    })
                    claim(idx, cand)
                    st["hits"] += 1
                    claims[CLAIM_HIT] += 1
                    continue
                # bypass: cost-function placement on pre-existing capacity
                # outside any warm pool (and outside other replicas' pools)
                gp = self.policy.place(shape, inventory(idx))
                if gp is not None:
                    claim(idx, external_claim(idx, gp))
                    st["bypass"] += 1
                    claims[CLAIM_BYPASS] += 1
                    continue
                # cold path: reserve a dedicated gang, provisioned by the
                # WarmPoolController once readyAt passes (the generated
                # pool name is unique per reservation, so cold replicas
                # are anti-affine by construction)
                st["seq"] += 1
                sid = f"ws-{st['seq']:04d}"
                slices[sid] = {
                    "state": C.WARMSLICE_PROVISIONING,
                    "pool": "warm-%s-%s-%04d" % (
                        shape.accelerator.name, shape.gpus, st["seq"]),
                    "readyAt": self.clock.now()
                    + self.cfg.warmpool_provision_s,
                    "claimedBy": key,
                    "claimedSlice": idx,
                }
                claim(idx, sid)
                st["misses"] += 1
                claims[CLAIM_MISS] += 1
                waiting = True

            if st != before:
                live.status = st
                self.api.update_status(live)
            out.update(waiting=waiting, assignments=assignments,
                       slices=copy.deepcopy(slices), claims=claims)

        retry_on_conflict(attempt)
        if out.get("fenced"):
            span.add_event("schedule.preemption_wait", {})
            return Result(
                requeue_after=max(self.cfg.queue_requeue_s, 1.0))

        for result, n in out["claims"].items():
            if n:
                self.metrics.warmpool_hits.labels(result).inc(n)
        if out["waiting"]:
            span.add_event("schedule.wait", {
                "reason": "provisioning",
                "slices": len(out["assignments"])})
            self._count(SCHEDULE_WAIT)
            if self.preemption is not None:
                # an admitted gang stuck on a cold provision: the engine
                # may free lower-priority checkpointed capacity instead,
                # which the reservation upgrade above claims on the next
                # pass (the pool watch wakes it when the eviction commits)
                shortfall = sum(
                    1 for sid in out["assignments"].values()
                    if out["slices"][sid].get("state")
                    == C.WARMSLICE_PROVISIONING) * shape.gpus
                self.preemption.maybe_preempt(nb, shape, shortfall, span)
            # the GPUWarmPool watch wakes us the moment the reservation
            # turns Ready; the requeue is a safety net, not the signal
            return Result(
                requeue_after=max(self.cfg.warmpool_provision_s, 1.0))

        intent = {"v": 1, "slices": {}}
        for idx in range(total_gangs):
            e = out["slices"][out["assignments"][idx]]
            entry = {"pool": e["pool"]}
            if e.get("nodes"):
                entry["nodes"] = list(e["nodes"])
            intent["slices"][str(idx)] = entry
        encoded = json.dumps(intent, sort_keys=True, separators=(",", ":"))
        wrote = [False]
        dequeued: dict = {}

        def write_intent() -> None:
            live = self.api.get("Notebook", nb.namespace, nb.name)
            if live.metadata.annotations.get(
                    C.ANNOTATION_PLACEMENT) == encoded:
                return
            # placement retires the queue membership in the same write:
            # the queue-wait clock stops when the intent lands
            dequeued.update(queued_info(live.metadata.annotations))
            live.metadata.annotations.pop(C.ANNOTATION_QUEUED, None)
            live.metadata.annotations[C.ANNOTATION_PLACEMENT] = encoded
            self.api.update(live)
            wrote[0] = True

        retry_on_conflict(write_intent)
        if wrote[0]:
            # time to placement by priority: the queue wait off the queued
            # stamp, 0 for a gang that never queued
            wait = 0.0
            since = dequeued.get("since")
            if isinstance(since, (int, float)):
                wait = max(self.clock.now() - float(since), 0.0)
            pr = dequeued.get("priority")
            if pr not in PRIORITY_RANK:
                pr = resolve_priority(nb, self.api.try_get(
                    C.TENANTQUOTA_KIND, "", C.TENANTQUOTA_NAME))
            tid = span.trace_id
            self.metrics.queue_wait_seconds.labels(pr).observe(
                wait, exemplar={"trace_id": tid} if tid else None)
            pools = sorted(e["pool"] for e in intent["slices"].values())
            span.add_event("schedule.placed", {"pools": ",".join(pools)})
            self._count(SCHEDULE_PLACED)
            self._event(nb, "Normal", EVENT_SCHEDULED,
                        "Placed %d gang(s) onto pool(s) %s" % (
                            total_gangs, ", ".join(sorted(set(pools)))))
        else:
            self._count(SCHEDULE_NOOP)
        return Result()

    # -- tenancy admission -----------------------------------------------------
    def _pending_eviction(self, key: str) -> bool:
        """True while a write-ahead preemption record in phase Pending
        names this gang as victim: the eviction owns the gang's claims
        until the record retires."""
        quota = self.api.try_get(
            C.TENANTQUOTA_KIND, "", C.TENANTQUOTA_NAME)
        if quota is None:
            return False
        rec = ((quota.body.get("status", {}) or {})
               .get("preemptions") or {}).get(key)
        return bool(rec) and rec.get("phase") == C.PREEMPTION_PENDING

    def _preempt_fence_holds(self, ann: dict) -> bool:
        """An evicted victim's re-queue fence: it stays parked until the
        beneficiary it was evicted for holds the placement, stops or
        vanishes; admitting it earlier would hand the freed GPUs straight
        back to the victim."""
        info = queued_info(ann)
        if info.get("reason") != "preempted":
            return False
        bkey = str(info.get("beneficiary") or "")
        bns, _, bname = bkey.partition("/")
        ben = self.api.try_get("Notebook", bns, bname) if bname else None
        return ben is not None and \
            ben.metadata.deletion_timestamp is None and \
            C.STOP_ANNOTATION not in ben.metadata.annotations and \
            C.ANNOTATION_PLACEMENT not in ben.metadata.annotations

    def _admission(self, nb: Notebook, shape: GpuShape,
                   total_gangs: int, span) -> Optional[Result]:
        """Quota and weighted fair-share admission, before any claim is
        written.  Returns None to admit, or a queued Result: the gang is
        stamped with the queued annotation (sliceHealth reads "Queued")
        and re-examined on every TenantQuota or pool wakeup plus a
        queue_requeue_s safety net.

        The dequeue order is deterministic and starvation-free: every
        queued gang scores rank + weight * age / queue_aging_s off its
        queued-since stamp, only gangs whose own quota admits them are
        eligible, and only the top-scoring eligible gang admits (ties on
        since, namespace, name)."""
        ann = nb.annotations
        key = f"{nb.namespace}/{nb.name}"
        # preempt > (re)place: while the write-ahead eviction record is
        # Pending, the engine owns this gang
        if self._pending_eviction(key):
            span.add_event("schedule.preemption_wait", {})
            return Result(
                requeue_after=max(self.cfg.queue_requeue_s, 1.0))
        if C.ANNOTATION_PLACEMENT in ann:
            return None  # already placed: a churn re-reconcile
        # a scheduler that died between its claim write and its intent
        # write finishes its own work, never re-queues behind it
        pool = self.api.try_get(
            C.WARMPOOL_KIND, "", pool_object_name(*_shape_key(shape)))
        if pool is not None and any(
                e.get("claimedBy") == key
                for e in (pool.body.get("status", {}).get("slices") or {})
                .values()):
            return None
        quota_obj = self.api.try_get(
            C.TENANTQUOTA_KIND, "", C.TENANTQUOTA_NAME)
        now = self.clock.now()
        policy = tenant_policy(quota_obj, nb.namespace)
        priority = resolve_priority(nb, quota_obj)
        if self._preempt_fence_holds(ann):
            return self._queue(nb, span, "preempted", priority, now)
        need = float(shape.gpus * total_gangs)
        reader = self.cache if self.cache is not None else self.api
        # notebooks holding pool claims without a placement yet (cold
        # reservations mid-flight) already spend their capacity: they
        # count toward quota usage and the fair-share "another tenant is
        # waiting" signal, but they are not in the queued line
        claimants: set[str] = set()
        for pobj in reader.list(C.WARMPOOL_KIND):
            for e in ((pobj.body.get("status", {}) or {})
                      .get("slices") or {}).values():
                if e.get("claimedBy"):
                    claimants.add(str(e["claimedBy"]))
        waiting_ns: set[str] = set()
        # one reader pass: placed GPUs per namespace and the queued line
        usage: dict[str, float] = {}
        line: list[dict] = []
        for obj in reader.list("Notebook"):
            if obj.metadata.deletion_timestamp is not None:
                continue
            oann = obj.metadata.annotations or {}
            if C.STOP_ANNOTATION in oann and \
                    C.ANNOTATION_PLACEMENT not in oann:
                continue  # stopped while queued: out of the line
            chips = gang_chips(obj)
            if C.ANNOTATION_PLACEMENT in oann:
                usage[obj.namespace] = \
                    usage.get(obj.namespace, 0.0) + chips
                continue
            if f"{obj.namespace}/{obj.name}" == key:
                continue
            if f"{obj.namespace}/{obj.name}" in claimants:
                usage[obj.namespace] = \
                    usage.get(obj.namespace, 0.0) + chips
                waiting_ns.add(obj.namespace)
                continue
            info = queued_info(oann)
            if not info:
                continue
            opolicy = tenant_policy(quota_obj, obj.namespace)
            op = info.get("priority")
            orank = rank_of(op if op in PRIORITY_RANK
                            else opolicy["priority"])
            since = float(info.get("since", now))
            line.append({
                "ns": obj.namespace, "name": obj.name, "chips": chips,
                "since": since, "quota": opolicy["chip_quota"],
                "score": orank + opolicy["weight"]
                * max(now - since, 0.0)
                / max(self.cfg.queue_aging_s, 1e-9)})
        # 1) hard quota: the tenant's placed GPUs plus this gang must fit
        if policy["chip_quota"] > 0 and \
                usage.get(nb.namespace, 0.0) + need \
                > policy["chip_quota"] + 1e-9:
            return self._queue(nb, span, "quota", priority, now)
        eligible = [e for e in line
                    if e["quota"] <= 0
                    or usage.get(e["ns"], 0.0) + e["chips"]
                    <= e["quota"] + 1e-9]
        capacity = 0.0
        total_w = 0.0
        if line or waiting_ns:
            for node in reader.list("Node"):
                if node.spec.get("unschedulable"):
                    continue
                capacity += parse_quantity(
                    node.body.get("status", {})
                    .get("allocatable", {}).get(C.GPU_RESOURCE, 0))
            active = set(usage) | {e["ns"] for e in line} \
                | waiting_ns | {nb.namespace}
            total_w = sum(tenant_policy(quota_obj, t)["weight"]
                          for t in active)

        def fair_share(tenant: str) -> float:
            w = tenant_policy(quota_obj, tenant)["weight"]
            return capacity * w / total_w if total_w > 0 else capacity

        def over_share(tenant: str, chips: float) -> bool:
            return capacity > 0 and \
                usage.get(tenant, 0.0) + chips \
                > fair_share(tenant) + 1e-9

        i_over = over_share(nb.namespace, need)
        under = [e for e in eligible
                 if not over_share(e["ns"], e["chips"])]
        # 2) the deterministic dequeue order: defer to better-scored
        # waiters of my admission class.  Under my share only under-share
        # entries count (an over-share head is parked by my very
        # presence); over my share the whole eligible line counts, so that
        # under symmetric scarcity the aged score alone decides
        my_since = float(queued_info(ann).get("since", now))
        my_score = rank_of(priority) + policy["weight"] \
            * max(now - my_since, 0.0) \
            / max(self.cfg.queue_aging_s, 1e-9)
        mine = (-my_score, my_since, nb.namespace, nb.name)
        if any((-e["score"], e["since"], e["ns"], e["name"]) < mine
               for e in (eligible if i_over else under)):
            return self._queue(nb, span, "ordered", priority, now)
        # 3) weighted fair share, binding only while it has a
        # beneficiary: another tenant's queued gang it would admit now, or
        # another tenant's gang already admitted and mid-provision.  Idle
        # capacity is never held back by a share nobody claims
        if i_over and (
                any(e["ns"] != nb.namespace for e in under)
                or waiting_ns - {nb.namespace}):
            return self._queue(nb, span, "fair-share", priority, now)
        return None

    def _queue(self, nb: Notebook, span, reason: str, priority: str,
               now: float) -> Result:
        """Park the gang: stamp the queued annotation (keeping the first
        `since` on re-evaluation, so that aging accumulates), and requeue
        on the safety-net interval."""

        def stamp(ann) -> None:
            info = queued_info(ann)
            if info.get("reason") == reason and "since" in info:
                return
            info.setdefault("since", now)
            info["priority"] = priority
            info["reason"] = reason
            ann[C.ANNOTATION_QUEUED] = json.dumps(
                info, sort_keys=True, separators=(",", ":"))

        stamped = _mutate_queue_stamp(self.api, nb.namespace, nb.name,
                                      stamp)
        span.add_event("schedule.queued",
                       {"reason": reason, "priority": priority})
        if stamped:
            self._count(SCHEDULE_QUEUED)
        return Result(requeue_after=max(self.cfg.queue_requeue_s, 1.0))

    # -- reclamation -----------------------------------------------------------
    def _release(self, nb: Notebook, shape: GpuShape, span) -> Result:
        """Culling -> reclamation: once the stopped notebook's gang is
        fully parked (sliceHealth Stopped, which postdates the
        checkpoint-on-cull handshake), its claims drain back into the warm
        pool and the placement intent is retired, so that a restart
        re-places afresh."""
        key = f"{nb.namespace}/{nb.name}"
        # a stopped notebook leaves the admission queue unconditionally
        if C.ANNOTATION_QUEUED in nb.annotations:
            def drop_queued(ann) -> None:
                ann.pop(C.ANNOTATION_QUEUED, None)

            _mutate_queue_stamp(self.api, nb.namespace, nb.name,
                                drop_queued)
        pool = self.api.try_get(
            C.WARMPOOL_KIND, "", pool_object_name(*_shape_key(shape)))
        has_claims = pool is not None and any(
            e.get("claimedBy") == key
            for e in (pool.body.get("status", {}).get("slices") or {})
            .values())
        has_intent = C.ANNOTATION_PLACEMENT in nb.annotations
        if not has_claims and not has_intent:
            return Result()
        health = (nb.status or {}).get("sliceHealth")
        if health != "Stopped":
            # still draining, or no status yet: the notebook controller's
            # status transition re-triggers us
            span.add_event("schedule.release_wait",
                           {"sliceHealth": health or ""})
            return Result()

        def release_claims() -> None:
            # the claims drain before the intent goes: the intent is what
            # lets a crashed scheduler find its claims again
            if pool is None:
                return
            live = self.api.get(C.WARMPOOL_KIND, "", pool.name)
            st = copy.deepcopy(live.body.get("status") or {})
            slices = st.setdefault("slices", {})
            changed = False
            for sid in list(slices):
                if slices[sid].get("claimedBy") == key:
                    self._release_entry(slices, sid)
                    changed = True
            if changed:
                live.status = st
                self.api.update_status(live)

        retry_on_conflict(release_claims)

        def drop_intent() -> None:
            live = self.api.get("Notebook", nb.namespace, nb.name)
            if C.ANNOTATION_PLACEMENT in live.metadata.annotations:
                del live.metadata.annotations[C.ANNOTATION_PLACEMENT]
                self.api.update(live)

        retry_on_conflict(drop_intent)
        span.add_event("schedule.released")
        self._count(SCHEDULE_RELEASED)
        self._event(nb, "Normal", EVENT_RELEASED,
                    "Gang capacity returned to the warm pool")
        return Result()

    @staticmethod
    def _release_entry(slices: dict, sid: str) -> None:
        """Un-claim one pool entry: an external (bypass) entry vanishes,
        since its capacity was never pool-managed; a warm entry turns
        Ready (a Provisioning reservation stays Provisioning) and rejoins
        the claimable pool with its nodes."""
        e = slices[sid]
        if e.get("external"):
            del slices[sid]
            return
        if e.get("state") == C.WARMSLICE_CLAIMED:
            e["state"] = C.WARMSLICE_READY
        e.pop("claimedBy", None)
        e.pop("claimedSlice", None)

    # -- capacity inventory ----------------------------------------------------
    def _inventory(self, shape: GpuShape,
                   pool_status: dict) -> list[NodeCapacity]:
        """Schedulable capacity for bypass placement: nodes of the shape's
        accelerator (their GKE accelerator label), grouped by node pool,
        with free GPUs net of bound pods and standing reservations (every
        claimed pool entry whose pods have not bound yet, the claiming
        notebook's own included).  Nodes of any warm pool are excluded:
        warm capacity moves only through claims."""
        reader = self.cache if self.cache is not None else self.api
        warm_pools: set[str] = set()
        reservations: dict[str, float] = {}
        # pods once: GPUs bound per node, and per (node, notebook)
        bound: dict[str, float] = {}
        bound_by_nb: dict[tuple[str, str], float] = {}
        for pod in reader.list("Pod"):
            node = pod.spec.get("nodeName")
            if not node:
                continue
            gpus = _gpu_request(pod.spec)
            if gpus <= 0:
                continue
            bound[node] = bound.get(node, 0.0) + gpus
            owner = "%s/%s" % (
                pod.namespace,
                pod.metadata.labels.get(C.NOTEBOOK_NAME_LABEL, ""))
            bound_by_nb[(node, owner)] = \
                bound_by_nb.get((node, owner), 0.0) + gpus
        for pool_obj in self.api.list(C.WARMPOOL_KIND):
            spec = pool_obj.spec
            try:
                pshape = resolve(str(spec.get("accelerator", "")),
                                 int(spec.get("count", 0)))
            except (TopologyError, TypeError, ValueError):
                continue
            entries = (pool_obj.body.get("status", {})
                       .get("slices") or {})
            if pool_obj.name == pool_object_name(*_shape_key(shape)):
                entries = pool_status.get("slices") or {}
            for e in entries.values():
                if not e.get("external"):
                    warm_pools.add(e.get("pool", ""))
                claimant = e.get("claimedBy", "")
                for node in e.get("nodes") or []:
                    already = bound_by_nb.get((node, claimant), 0.0) \
                        if claimant else 0.0
                    reservations[node] = reservations.get(node, 0.0) + \
                        max(pshape.gpus_per_host - already, 0.0)
        out: list[NodeCapacity] = []
        for node in reader.list("Node"):
            if node.spec.get("unschedulable"):
                continue
            labels = node.metadata.labels
            if labels.get(C.GKE_GPU_ACCELERATOR_LABEL) != \
                    shape.accelerator.gke_label:
                continue
            pool = labels.get(C.GKE_NODEPOOL_LABEL) or node.name
            if pool in warm_pools:
                continue
            total = parse_quantity(
                node.body.get("status", {})
                .get("allocatable", {}).get(C.GPU_RESOURCE, 0))
            free = total - bound.get(node.name, 0.0) \
                - reservations.get(node.name, 0.0)
            out.append(NodeCapacity(node.name, pool, free, total))
        return out

    # -- plumbing --------------------------------------------------------------
    def _ensure_pool(self, shape: GpuShape) -> KubeObject:
        name = pool_object_name(*_shape_key(shape))
        obj = self.api.try_get(C.WARMPOOL_KIND, "", name)
        if obj is not None:
            return obj
        try:
            return self.api.create(new_pool_object(*_shape_key(shape)))
        except AlreadyExistsError:
            return self.api.get(C.WARMPOOL_KIND, "", name)

    def _count(self, result: str) -> None:
        self.metrics.schedule_attempts.labels(result).inc()


def _gpu_request(pod_spec: dict) -> float:
    total = 0.0
    for c in pod_spec.get("containers", []):
        req = (c.get("resources", {}).get("requests") or {}) \
            .get(C.GPU_RESOURCE)
        if req is not None:
            total += parse_quantity(req)
    return total


def new_pool_object(accelerator: str, count: int) -> KubeObject:
    return KubeObject(
        api_version="kubeflow.org/v1",
        kind=C.WARMPOOL_KIND,
        metadata=ObjectMeta(name=pool_object_name(accelerator, count)),
        body={"spec": {"accelerator": accelerator, "count": count}},
    )


# -- warm-pool controller ------------------------------------------------------
class WarmPoolController:
    """Reconciles GPUWarmPool objects: turns Provisioning reservations
    into Ready gangs once their readyAt deadline passes (through the
    provisioner: FakeCluster.provision_slice standalone, the cloud's node
    auto-provisioner in a real cluster), garbage-collects claims whose
    notebook vanished, and runs the hit-rate autoscaler and sizing loop
    for the shapes listed in WARMPOOL_SHAPES."""

    def __init__(
        self,
        api: ApiServer,
        cfg: CoreConfig,
        metrics: NotebookMetrics,
        provisioner=None,
        clock: Optional[Clock] = None,
    ):
        self.api = api
        self.cfg = cfg
        self.metrics = metrics
        self.provisioner = provisioner
        self.clock = clock or Clock()
        self._managed_shapes = set(parse_warmpool_shapes(cfg.warmpool_shapes))

    def reconcile(self, req: Request) -> Result:
        obj = self.api.try_get(C.WARMPOOL_KIND, req.namespace, req.name)
        if obj is None:
            return Result()
        try:
            shape = resolve(str(obj.spec.get("accelerator", "")),
                            int(obj.spec.get("count", 0)))
        except (TopologyError, TypeError, ValueError):
            return Result()
        requeue = [0.0]

        def attempt() -> None:
            live = self.api.get(C.WARMPOOL_KIND, req.namespace, req.name)
            before = copy.deepcopy(live.body.get("status") or {})
            st = copy.deepcopy(before)
            requeue[0] = self._step(st, shape)
            if st != before:
                live.status = st
                self.api.update_status(live)

        retry_on_conflict(attempt)
        if requeue[0] > 0:
            return Result(requeue_after=requeue[0])
        return Result()

    def _step(self, st: dict, shape: GpuShape) -> float:
        now = self.clock.now()
        st.setdefault("target", self.cfg.warmpool_size)
        st.setdefault("seq", 0)
        for k in ("hits", "misses", "bypass"):
            st.setdefault(k, 0)
        slices = st.setdefault("slices", {})

        # orphan-claim GC: a deleted notebook never released
        for sid in list(slices):
            claimant = slices[sid].get("claimedBy")
            if not claimant:
                continue
            ns, _, name = claimant.partition("/")
            nb = self.api.try_get("Notebook", ns, name)
            if nb is None or nb.metadata.deletion_timestamp is not None:
                SliceScheduler._release_entry(slices, sid)

        # Provisioning -> Ready once the deadline passes; the provisioner
        # call is idempotent, so a conflict retry re-runs it safely
        next_due: Optional[float] = None
        for sid in sorted(slices):
            e = slices[sid]
            if e.get("state") != C.WARMSLICE_PROVISIONING:
                continue
            ready_at = float(e.get("readyAt", 0.0))
            if ready_at <= now:
                e["nodes"] = self._provision(shape, e["pool"])
                e["state"] = C.WARMSLICE_READY
                e.pop("readyAt", None)
            elif next_due is None or ready_at < next_due:
                next_due = ready_at

        if _shape_key(shape) in self._managed_shapes \
                and self.cfg.warmpool_size > 0:
            next_due = self._autoscale(st, shape, now, next_due)
        else:
            # an unmanaged shape keeps no idle capacity warm: a released
            # gang is torn straight back down
            st["target"] = 0
            for sid in sorted(slices):
                e = slices[sid]
                if e.get("state") == C.WARMSLICE_READY \
                        and not e.get("claimedBy") \
                        and not e.get("external"):
                    self._deprovision(e["pool"])
                    del slices[sid]

        return max(next_due - now, 0.0) if next_due is not None else 0.0

    def _autoscale(self, st: dict, shape: GpuShape, now: float,
                   next_due: Optional[float]) -> Optional[float]:
        """Grow the target by the misses since the last pass; decay it
        one step toward the configured base while the windowed hit rate
        holds above the goal and idle capacity covers the target.  Then
        size the pool to the target: provision the shortfall, retire idle
        excess (the youngest first, deterministically)."""
        slices = st["slices"]
        base = self.cfg.warmpool_size
        target = int(st.get("target", base))
        dm = st["misses"] - st.get("lastMisses", 0)
        dh = st["hits"] - st.get("lastHits", 0)
        # the hit rate since the last pass (an empty window is healthy)
        window = dh + dm
        hit_rate = (dh / window) if window else 1.0
        unclaimed = [
            sid for sid in sorted(slices)
            if not slices[sid].get("claimedBy")
            and not slices[sid].get("external")]
        idle_ready = [
            sid for sid in unclaimed
            if slices[sid].get("state") == C.WARMSLICE_READY]
        last_decay = float(st.setdefault("lastDecayAt", now))
        if dm > 0:
            target = min(target + dm, self.cfg.warmpool_max_size)
            st["lastDecayAt"] = now
        elif target > base and len(idle_ready) >= target \
                and hit_rate >= self.cfg.warmpool_target_hit_rate \
                and now - last_decay >= self.cfg.warmpool_decay_s:
            target -= 1
            st["lastDecayAt"] = now
        st["lastMisses"] = st["misses"]
        st["lastHits"] = st["hits"]
        st["target"] = target
        if target > base:
            # arm the next decay check: an idle pool gets no events
            decay_due = float(st["lastDecayAt"]) + self.cfg.warmpool_decay_s
            if next_due is None or decay_due < next_due:
                next_due = decay_due

        while len(unclaimed) < target:
            st["seq"] += 1
            sid = f"ws-{st['seq']:04d}"
            ready_at = now + self.cfg.warmpool_provision_s
            slices[sid] = {
                "state": C.WARMSLICE_PROVISIONING,
                "pool": "warm-%s-%s-%04d" % (
                    shape.accelerator.name, shape.gpus, st["seq"]),
                "readyAt": ready_at,
            }
            unclaimed.append(sid)
            if next_due is None or ready_at < next_due:
                next_due = ready_at
        # shrink: cancel not-yet-up reservations first, then retire the
        # youngest idle Ready gangs
        cancellable = [
            sid for sid in unclaimed
            if slices[sid].get("state") == C.WARMSLICE_PROVISIONING]
        while len(unclaimed) > target and (cancellable or idle_ready):
            sid = cancellable.pop() if cancellable else idle_ready.pop()
            self._deprovision(slices[sid]["pool"])
            del slices[sid]
            unclaimed.remove(sid)
        return next_due

    def _provision(self, shape: GpuShape, pool: str) -> list[str]:
        if self.provisioner is None:
            # a real cluster: turning capacity up belongs to the cloud's
            # node auto-provisioner; the pool entry still tracks intent
            return []
        return list(self.provisioner.provision_slice(shape, pool))

    def _deprovision(self, pool: str) -> None:
        if self.provisioner is not None:
            self.provisioner.deprovision_slice(pool)


# -- wiring --------------------------------------------------------------------
def setup_scheduler(
    mgr: Manager,
    cfg: CoreConfig,
    metrics: NotebookMetrics,
    provisioner=None,
    policy: Optional[PlacementPolicy] = None,
    session=None,
) -> tuple[SliceScheduler, WarmPoolController]:
    """Register the SliceScheduler and WarmPoolController (plus the
    PreemptionEngine and its TenantQuota reconciler) and seed the pool
    objects of WARMPOOL_SHAPES.  `provisioner` turns capacity up and down
    (the FakeCluster standalone); None leaves that to the cloud.
    `session` is the session-state store checkpoint-then-preempt secures
    a victim's state through (the engine opens one from
    CHECKPOINT_STORE_URI when it is not passed)."""
    api = mgr.api
    sched = SliceScheduler(
        api, cfg, metrics, EventRecorder(api, "slice-scheduler"),
        clock=mgr.clock, cache=mgr.cache, policy=policy)
    pools = WarmPoolController(
        api, cfg, metrics, provisioner=provisioner, clock=mgr.clock)
    # deferred import: preemption.py imports this module at top level
    from .preemption import PreemptionEngine

    engine = PreemptionEngine(
        api, cfg, metrics, EventRecorder(api, "preemption"),
        clock=mgr.clock, cache=mgr.cache, session=session)
    sched.preemption = engine
    mgr.preemption_engine = engine

    def pool_to_notebooks(obj: KubeObject) -> list[Request]:
        # a pool transition re-evaluates the notebooks holding entries
        out: list[Request] = []
        seen: set[str] = set()
        for e in (obj.body.get("status", {}).get("slices") or {}).values():
            claimant = e.get("claimedBy")
            if claimant and claimant not in seen:
                seen.add(claimant)
                ns, _, name = claimant.partition("/")
                out.append(Request(ns, name))
        return out

    def notebook_to_pool(obj: KubeObject) -> list[Request]:
        gpu = obj.spec.get("gpu") or {}
        accel = str(gpu.get("accelerator", ""))
        count = gpu.get("count")
        if not accel or count is None:
            return []
        return [Request("", pool_object_name(accel, count))]

    def quota_to_notebooks(obj: KubeObject) -> list[Request]:
        # a policy change or a preemption-record transition re-evaluates
        # every queued gang and both parties of each record
        out: list[Request] = []
        seen: set[str] = set()

        def add(ns: str, name: str) -> None:
            k = f"{ns}/{name}"
            if name and k not in seen:
                seen.add(k)
                out.append(Request(ns, name))

        for o in api.list("Notebook"):
            if C.ANNOTATION_QUEUED in o.metadata.annotations:
                add(o.namespace, o.name)
        st = obj.body.get("status", {}) or {}
        for rec in (st.get("preemptions") or {}).values():
            for k in (rec.get("beneficiary", ""), rec.get("victim", "")):
                ns, _, name = k.partition("/")
                add(ns, name)
        return out

    mgr.register(
        "slice-scheduler",
        sched,
        for_kind="Notebook",
        # no suppress_status_only: release keys off the Stopped
        # sliceHealth transition, a status-only write
        watches=[
            WatchSpec(kind=C.WARMPOOL_KIND, mapper=pool_to_notebooks),
            WatchSpec(kind=C.TENANTQUOTA_KIND, mapper=quota_to_notebooks),
        ],
    )
    mgr.register(
        "preemption",
        engine,
        for_kind=C.TENANTQUOTA_KIND,
    )
    mgr.register(
        "warm-pool",
        pools,
        for_kind=C.WARMPOOL_KIND,
        watches=[WatchSpec(
            kind="Notebook",
            mapper=notebook_to_pool,
            # only deletions matter: orphan-claim GC
            predicate=lambda ev: ev.type is EventType.DELETED,
        )],
    )
    for accel, count in parse_warmpool_shapes(cfg.warmpool_shapes):
        if api.try_get(C.WARMPOOL_KIND, "",
                       pool_object_name(accel, count)) is None:
            try:
                api.create(new_pool_object(accel, count))
            except AlreadyExistsError:
                pass
    return sched, pools


__all__ = [
    "CLAIM_BYPASS",
    "CLAIM_HIT",
    "CLAIM_MISS",
    "CostFunctionPolicy",
    "EVENT_RELEASED",
    "EVENT_SCHEDULED",
    "GangPlacement",
    "NodeCapacity",
    "PlacementPolicy",
    "SCHEDULE_NOOP",
    "SCHEDULE_PLACED",
    "SCHEDULE_QUEUED",
    "SCHEDULE_RELEASED",
    "SCHEDULE_WAIT",
    "SliceScheduler",
    "WarmPoolController",
    "gang_chips",
    "new_pool_object",
    "parse_warmpool_shapes",
    "placement_covers",
    "placement_of",
    "pool_object_name",
    "queued_info",
    "rank_of",
    "resolve_priority",
    "setup_scheduler",
    "tenant_policy",
]
