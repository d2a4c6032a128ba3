"""Active-active sharded control plane: fenced shard map + handoff.

The port's copy of kubeflow_tpu/kube/shard.py.  It shards the Notebook
keyspace across N in-process manager replicas, each running the port's
controllers on `spec.gpu` gangs:

  - **ControlPlaneShardMap** — one cluster-scoped object (the same
    optimistic-concurrency, all-state-in-status pattern as GPUWarmPool)
    holding the authoritative membership: an epoch counter, per-shard
    member leases (each stamped with the epoch of its last (re)join —
    its *incarnation*), and the pending handoff records.  The
    consistent-hash ring is DERIVED from the member list
    deterministically (`HashRing`, the reference's `_hash64` and
    `VNODES`, so the same members give the same owner for every key),
    never stored key-by-key.
  - **Namespace-affine placement** — a key's ring position hashes ONLY
    its namespace, so every key of one tenant namespace lands on one
    shard: that tenant's churn hits one cache and one workqueue.
  - **Fenced writes** — every replica's controllers write through a
    `FencedApi` proxy that calls the authority's `verify()` before each
    write verb: a deposed, evicted, or rejoined-elsewhere incarnation
    holds a stale epoch and gets `StaleEpochError` (counted), so a
    zombie of a killed replica can never clobber the new owner's state.
    The authority protocol is shared with `kube/leader.py`: a
    LeaderElector (fencing epoch = leaseTransitions) and a ShardMember
    (fencing epoch = member incarnation) are interchangeable behind
    `verify()`.
  - **Write-ahead handoff, one record per change** — every membership
    change commits, in the SAME map RMW as the epoch bump, its OWN
    handoff record (appended to `status.handoffs`) naming the shards
    that gain keys (`adopters`) and the surviving shards that lose keys
    (`drains`).  Losers observe the commit (the in-process watch fires
    synchronously at commit), stop dispatching moved keys immediately,
    finish in-flight ones, and RMW-ack out of every record's `drains`
    in one commit; adopters enqueue their gained keys ONLY once every
    record granting them has drained, then ack out of `adopters` — each
    record whose lists empty stamps `status.lastHandoff` with its
    measured duration.  The commit is strictly write-ahead of adoption
    (`ShardedReplica.join_fleet`; model-checked by
    tests/test_torch_interleave.py, two SIMULTANEOUS joins among its
    scenarios), so no key is ever reconciled by two shards in the same
    epoch and a crash mid-handoff leaves committed records any survivor
    completes.

Each replica runs its own Manager worker pool and its own
`InformerCache` with a `key_filter` that admits only owned keys of the
sharded kinds, so cache memory and watch fan-out scale per shard.
"""

from __future__ import annotations

import bisect
import copy
import hashlib
import logging
import threading
from typing import Callable, Iterable, Optional

from ..utils import invariants
from ..utils.clock import Clock, parse_iso
from ..utils.flightrecorder import FlightRecorder
from ..utils.metrics import Registry
from .cache import InformerCache
from .controller import Manager
from .errors import (ApiError, ConflictError, is_already_exists,
                     retry_on_conflict)
from .leader import FencingToken, StaleEpochError, _iso
from .meta import KubeObject, ObjectMeta

logger = logging.getLogger("kubeflow_tpu_torch.kube.shard")

SHARD_MAP_KIND = "ControlPlaneShardMap"
SHARD_MAP_API_VERSION = "kubeflow.org/v1"
DEFAULT_MAP_NAME = "control-plane"
DEFAULT_LEASE_DURATION_S = 15.0
#: virtual nodes per member on the ring — enough that a join moves
#: roughly 1/N of the keyspace instead of a contiguous half
VNODES = 32
#: the kinds whose keyspace is sharded; owned objects (StatefulSet, Pod,
#: Service, ...) hash to unrelated ring points and MUST stay visible to
#: whichever shard owns their notebook, so they are never filtered
DEFAULT_SHARDED_KINDS = ("Notebook",)


def _hash64(s: str) -> int:
    return int.from_bytes(hashlib.sha1(s.encode()).digest()[:8], "big")


def new_shard_map(name: str = DEFAULT_MAP_NAME) -> KubeObject:
    """A fresh cluster-scoped shard map (all state lives in status)."""
    return KubeObject(
        api_version=SHARD_MAP_API_VERSION,
        kind=SHARD_MAP_KIND,
        metadata=ObjectMeta(name=name),
        body={"spec": {}},
    )


class HashRing:
    """Consistent-hash ring derived deterministically from a member-id
    list: every replica that observes the same member set computes the
    same ownership, so the ring itself never needs to be persisted or
    coordinated beyond the membership.

    Placement is **namespace-affine**: the ring position hashes ONLY
    `namespace`, never the object name, so all keys of one namespace
    share one owner — one tenant's churn stays on one shard's cache and
    workqueue.  Ownership lookups memoize per namespace (a ring is
    immutable once built; membership changes build a new ring), which
    turns the hot dispatch-filter path from sha1+bisect per call into a
    dict hit."""

    __slots__ = ("members", "_points", "_keys", "_owner_cache")

    def __init__(self, members: Iterable[str], vnodes: int = VNODES) -> None:
        self.members: tuple[str, ...] = tuple(sorted(members))
        pts = []
        for sid in self.members:
            for i in range(vnodes):
                pts.append((_hash64(f"{sid}#{i}"), sid))
        pts.sort()
        self._points = pts
        self._keys = [p for p, _ in pts]
        # benign CPython race: concurrent misses compute the same value
        self._owner_cache: dict[str, str] = {}

    def owner_of(self, namespace: str, name: str) -> Optional[str]:
        if not self._points:
            return None
        owner = self._owner_cache.get(namespace)
        if owner is None:
            h = _hash64(namespace)
            idx = bisect.bisect_right(self._keys, h) % len(self._points)
            owner = self._points[idx][1]
            self._owner_cache[namespace] = owner
        return owner


def _lease_expired(member: dict, now: float) -> bool:
    renew = parse_iso(member["renewTime"]) if member.get("renewTime") \
        else 0.0
    duration = float(member.get("leaseDurationSeconds",
                                DEFAULT_LEASE_DURATION_S))
    return renew + duration < now


def _append_handoff(status: dict, now: float, adopters: set,
                    drains: set) -> None:
    """Commit a membership change's key movement as its OWN write-ahead
    record, appended to the epoch-ordered `status.handoffs` list.
    Per-change records let overlapping changes complete independently —
    N simultaneous joins each carry their own adopter/drain lists
    instead of convoying through one merged record.  Departed members
    are pruned from every pending record (a dead shard cannot ack); a
    record pruned empty simply disappears — its movement became moot
    before anyone had to act on it."""
    members = set(status.get("members") or {})
    records = []
    for h in status.get("handoffs") or ():
        a = sorted(set(h.get("adopters") or ()) & members)
        d = sorted(set(h.get("drains") or ()) & members)
        if a or d:
            records.append({"epoch": h.get("epoch"),
                            "startedAt": h.get("startedAt"),
                            "adopters": a, "drains": d})
    adopters = set(adopters) & members
    drains = set(drains) & members
    if adopters or drains:
        records.append({
            "epoch": int(status.get("epoch") or 0),
            "startedAt": _iso(now),
            "adopters": sorted(adopters),
            "drains": sorted(drains),
        })
    if records:
        status["handoffs"] = records
    else:
        status.pop("handoffs", None)


class ShardMember:
    """One replica's handle on the shard map: membership RMWs (join /
    renew / leave / handoff acks, all `retry_on_conflict` over
    update_status, the GPUWarmPool idiom) plus the fencing authority
    (`verify()`) its FencedApi writes are checked against.

    The fencing epoch is the member's **incarnation**: the map epoch at
    its last (re)join.  Renewals do not change it, so survivors stay
    valid across other members' joins; any (re)join bumps it, so the
    token held by a killed-and-evicted — or killed-and-rejoined —
    process's threads is stale the instant the change commits."""

    def __init__(self, api, shard_id: str, *,
                 map_name: str = DEFAULT_MAP_NAME,
                 lease_duration_s: float = DEFAULT_LEASE_DURATION_S,
                 clock: Optional[Clock] = None) -> None:
        self.api = api
        self.shard_id = shard_id
        self.map_name = map_name
        self.lease_duration_s = lease_duration_s
        self.clock = clock or Clock()
        self.token = FencingToken()
        #: shard-map RMW optimistic-concurrency losses (409s retried by
        #: _mutate_map): the membership-contention count
        self.rmw_conflicts = 0
        #: resourceVersion of this member's last committed map RMW.
        #: Written only by the protocol thread (join/renew/ack/leave run
        #: single-threaded per replica), so callers may read it right
        #: after an RMW returns to order the view they were handed.
        self.last_commit_rv = 0
        self._last_renew: Optional[float] = None

    # -- map access -----------------------------------------------------------
    def _exempt_get(self) -> Optional[KubeObject]:
        """Read the map fault-exempt (membership observation is protocol
        machinery, not client traffic under chaos test)."""
        exempt = getattr(self.api, "fault_exempt", None)
        if exempt is not None:
            with exempt():
                return self.api.try_get(SHARD_MAP_KIND, "", self.map_name)
        return self.api.try_get(SHARD_MAP_KIND, "", self.map_name)

    def _load(self) -> KubeObject:
        obj = self.api.try_get(SHARD_MAP_KIND, "", self.map_name)
        if obj is None:
            try:
                self.api.create(new_shard_map(self.map_name))
            except ApiError as err:
                if not is_already_exists(err):
                    raise
            obj = self.api.get(SHARD_MAP_KIND, "", self.map_name)
        return obj

    def _mutate_map(self, mutate: Callable[[dict], None]) -> dict:
        """One committed RMW of the map status; returns the committed
        view.  Conflicts re-run `mutate` on a fresh read — concurrent
        membership changes serialize into distinct epochs — with capped
        exponential backoff on the INJECTED clock: a FakeClock-driven
        run backs off in logical time (deterministic, no wall sleeps),
        and membership churn under load spreads out instead of
        hot-looping on 409s.  Every conflict is counted."""
        def attempt() -> dict:
            obj = self._load()
            status = copy.deepcopy(obj.body.get("status") or {})
            mutate(status)
            obj.body["status"] = status
            try:
                committed = self.api.update_status(obj)
            except ConflictError:
                self.rmw_conflicts += 1
                raise
            self.last_commit_rv = committed.metadata.resource_version
            return status
        return retry_on_conflict(attempt, jitter=0.0,
                                 sleep_fn=self.clock.sleep)

    def read_status(self) -> dict:
        """The committed map status (read-only view; fault-exempt so
        membership observation cannot be chaos-injected away)."""
        return self.read_status_rv()[0]

    def read_status_rv(self) -> tuple[dict, int]:
        """`read_status` plus the resourceVersion it was read at, so the
        caller can order the view against watch-delivered ones (map
        commits fan out to watchers outside the store lock, so two
        writers' events can arrive out of commit order)."""
        obj = self._exempt_get()
        if obj is None:
            return {}, 0
        return (obj.body.get("status") or {}), \
            obj.metadata.resource_version

    # -- membership mutations -------------------------------------------------
    def _join_mutation(self, status: dict, now: float) -> None:
        members = status.setdefault("members", {})
        expired = [sid for sid, m in members.items()
                   if sid != self.shard_id and _lease_expired(m, now)]
        for sid in expired:
            members.pop(sid)
        survivors = set(members) - {self.shard_id}
        epoch = int(status.get("epoch") or 0) + 1
        status["epoch"] = epoch
        members[self.shard_id] = {
            "epoch": epoch,
            "renewTime": _iso(now),
            "leaseDurationSeconds": int(self.lease_duration_s),
        }
        # the joiner gains keys from every survivor; an eviction in the
        # same commit hands the dead member's keys to ALL survivors
        adopters = {self.shard_id} | (survivors if expired else set())
        _append_handoff(status, now, adopters, survivors)

    def join(self) -> dict:
        """Commit this member into the map — epoch bump, fresh
        incarnation, expired-member eviction, and the write-ahead
        handoff record, all in ONE status commit.  The fencing token
        activates only from the committed view, never from local
        intent."""
        now = self.clock.now()
        view = self._mutate_map(lambda status:
                                self._join_mutation(status, now))
        self.token.renew(int(view["members"][self.shard_id]["epoch"]))
        self._last_renew = now
        return view

    def preview_join(self) -> dict:
        """The status view `join()` would commit, computed locally
        WITHOUT writing — a planning helper for ops tooling (how much of
        the keyspace would move?).  Adopting from a preview instead of
        the commit is exactly the write-ahead violation the seeded
        mutant in tests/test_torch_interleave.py exercises."""
        obj = self._exempt_get()
        status = copy.deepcopy(obj.body.get("status") or {}) \
            if obj is not None else {}
        self._join_mutation(status, self.clock.now())
        return status

    def renew_due(self) -> bool:
        """Whether the lease wants renewing: a third of the lease
        duration since the last committed renewal (client-go's
        renewDeadline idiom).  A fresh or fenced member is always due.
        The fleet's settle/maintain loops use this to COALESCE renewals
        — without it every settle round is a map RMW per replica, and N
        replicas' heartbeats contend for 409s they don't need."""
        if self._last_renew is None or not self.token.valid:
            return True
        return (self.clock.now() - self._last_renew) >= \
            self.lease_duration_s / 3.0

    def renew(self) -> bool:
        """Renew this member's lease (incarnation unchanged) and evict
        any member whose lease expired — eviction bumps the epoch and
        appends a handoff record in the same commit.  Returns False
        (token invalidated FIRST) if this member was itself evicted."""
        now = self.clock.now()

        def mutate(status: dict) -> None:
            members = status.setdefault("members", {})
            me = members.get(self.shard_id)
            if me is None or int(me.get("epoch", -1)) != self.token.epoch:
                raise StaleEpochError(
                    f"shard {self.shard_id}: evicted from the map "
                    f"(incarnation {self.token.epoch} gone)")
            me = dict(me)
            me["renewTime"] = _iso(now)
            members[self.shard_id] = me
            expired = [sid for sid, m in members.items()
                       if sid != self.shard_id and _lease_expired(m, now)]
            if expired:
                for sid in expired:
                    members.pop(sid)
                status["epoch"] = int(status.get("epoch") or 0) + 1
                _append_handoff(status, now, set(members), set())
            else:
                # prune departed members out of pending records even on
                # a quiet renew (their ack will never come)
                if status.get("handoffs"):
                    _append_handoff(status, now, set(), set())

        try:
            self._mutate_map(mutate)
            self._last_renew = now
            return True
        except StaleEpochError:
            self.token.invalidate()
            return False
        except ApiError as err:
            logger.warning("shard %s: lease renew failed: %s",
                           self.shard_id, err)
            return False

    def leave(self) -> dict:
        """Graceful departure.  The token dies FIRST — a successor may
        own our keys the instant the removal commits, so any of our
        writes racing past this point must already be fenced — then the
        removal commits with the survivors as adopters (and no drain:
        the caller drained us before asking)."""
        self.token.invalidate()
        now = self.clock.now()

        def mutate(status: dict) -> None:
            members = status.setdefault("members", {})
            if members.pop(self.shard_id, None) is None:
                _append_handoff(status, now, set(), set())
                return
            status["epoch"] = int(status.get("epoch") or 0) + 1
            _append_handoff(status, now, set(members), set())

        return self._mutate_map(mutate)

    # -- handoff acks ---------------------------------------------------------
    def _ack(self, status: dict, now: float, field: str,
             completed: list) -> None:
        """Remove this member from `field` of EVERY pending record in
        one commit: a drain resync runs against the CURRENT ring, so it
        covers all pending movements at once, and an adopter only acks
        when every record granting it keys has drained — N concurrent
        handoffs cost one ack RMW here, not N.  Each record whose lists
        both empty completes; completions land in epoch order, so the
        highest-epoch completion wins the `lastHandoff` stamp."""
        completed[0] = None
        records = status.get("handoffs") or []
        remaining: list = []
        done: list = []
        changed = False
        for h in records:
            if self.shard_id in (h.get(field) or ()):
                h = dict(h)
                h[field] = [s for s in h[field] if s != self.shard_id]
                changed = True
            if not h.get("adopters") and not h.get("drains"):
                done.append(h)
            else:
                remaining.append(h)
        if not changed and not done:
            return
        if remaining:
            status["handoffs"] = remaining
        else:
            status.pop("handoffs", None)
        for h in done:
            started = parse_iso(h["startedAt"]) if h.get("startedAt") \
                else now
            duration = max(now - started, 0.0)
            status["lastHandoff"] = {
                "epoch": h.get("epoch"),
                "completedAt": _iso(now),
                "durationSeconds": duration,
            }
            completed[0] = duration

    def ack_drain(self) -> dict:
        """This member finished draining keys it no longer owns."""
        now = self.clock.now()
        completed: list = [None]
        return self._mutate_map(
            lambda status: self._ack(status, now, "drains", completed))

    def ack_adopt(self) -> tuple[dict, Optional[float]]:
        """This member adopted its gained keys; returns the committed
        view plus the completed handoff's duration when THIS ack
        finished one (the handoff-duration observation point — the last
        record this ack completed, when it completed several)."""
        now = self.clock.now()
        completed: list = [None]
        view = self._mutate_map(
            lambda status: self._ack(status, now, "adopters", completed))
        return view, completed[0]

    # -- fencing authority (shared protocol with LeaderElector.verify) --------
    def verify(self) -> int:
        """Raises StaleEpochError unless the token is valid AND the
        committed map still carries this member at the token's
        incarnation epoch.  Called by FencedApi before every write."""
        tok = self.token
        if not tok.valid:
            raise StaleEpochError(
                f"shard {self.shard_id}: fencing token invalidated")
        me = (self.read_status().get("members") or {}).get(self.shard_id)
        if me is None or int(me.get("epoch", -1)) != tok.epoch:
            tok.invalidate()
            raise StaleEpochError(
                f"shard {self.shard_id}: incarnation {tok.epoch} deposed "
                f"(map now has {me or 'no such member'})")
        return tok.epoch


#: every ApiServer/KubeClient verb that commits state — each one is
#: fenced; reads, watches and introspection delegate untouched
WRITE_VERBS = ("create", "update", "update_status", "delete",
               "merge_patch", "strategic_merge_patch", "json_patch",
               "apply")


class FencedApi:
    """Write-fencing proxy: every write verb first asks the authority
    (`ShardMember` or `LeaderElector`) to `verify()` its fencing epoch
    against the committed lease, so a deposed holder's late write raises
    `StaleEpochError` (counted in `rejected_total`) instead of landing.
    Everything else — reads, watch/subscribe plumbing, `fault_exempt`,
    capability probes — delegates to the wrapped api, so Manager and
    InformerCache run on a FencedApi unchanged."""

    def __init__(self, api, authority,
                 on_rejected: Optional[Callable[[], None]] = None) -> None:
        self._api = api
        self._authority = authority
        self._on_rejected = on_rejected
        self.rejected_total = 0

    def _fence(self) -> int:
        try:
            return self._authority.verify()
        except StaleEpochError:
            self.rejected_total += 1
            if self._on_rejected is not None:
                self._on_rejected()
            raise

    def __getattr__(self, name):
        return getattr(self._api, name)


def _fenced_verb(verb: str):
    def call(self, *args, **kwargs):
        self._fence()
        return getattr(self._api, verb)(*args, **kwargs)
    call.__name__ = verb
    call.__qualname__ = f"FencedApi.{verb}"
    call.__doc__ = f"Fenced `{verb}`: verify() the epoch, then delegate."
    return call


for _verb in WRITE_VERBS:
    setattr(FencedApi, _verb, _fenced_verb(_verb))
del _verb


class ShardedReplica:
    """One control-plane replica: a ShardMember (map RMWs on the raw
    api), a FencedApi, a key-filtered InformerCache and a Manager worker
    pool whose dispatch admits only owned keys.  The replica observes
    every map commit synchronously (in-process watch), so the instant a
    membership change lands its ring view — and therefore its dispatch
    filter — is current: a key moved away stops dispatching here before
    the commit's caller even returns."""

    def __init__(self, api, shard_id: str, *,
                 clock: Optional[Clock] = None,
                 map_name: str = DEFAULT_MAP_NAME,
                 lease_duration_s: float = DEFAULT_LEASE_DURATION_S,
                 sharded_kinds: tuple = DEFAULT_SHARDED_KINDS,
                 workers: Optional[int] = None,
                 flight_recorder: Optional[FlightRecorder] = None,
                 vnodes: int = VNODES) -> None:
        self.api = api
        self.shard_id = shard_id
        self.clock = clock or Clock()
        self.sharded_kinds = tuple(sharded_kinds)
        self.alive = False
        self._vnodes = vnodes
        self._lock = invariants.tracked(
            threading.Lock(), "ShardedReplica._lock")
        self._ring = HashRing((), vnodes=vnodes)
        #: ring at the last NO-pending-handoff state: the dispatch gate
        #: for keys gained by a still-draining change.  A single
        #: previous-ring snapshot is wrong under overlapping changes
        #: (the ring one change ago is not the last stable ownership);
        #: this only advances when every record has acked out.
        self._stable_ring = self._ring
        self._epoch = 0
        self._pending_handoffs: list[dict] = []
        #: resourceVersion of the installed view — map commits fan out
        #: to watchers outside the store lock, so two writers' events
        #: can be DELIVERED out of commit order; installing by rv keeps
        #: the ring/gate view from regressing to an older commit
        self._installed_rv = 0
        #: completed-handoff durations observed by THIS replica's acks
        self.handoff_durations: list[float] = []
        self.member = ShardMember(api, shard_id, map_name=map_name,
                                  lease_duration_s=lease_duration_s,
                                  clock=self.clock)
        self.fenced = FencedApi(api, self.member)
        self.flight_recorder = flight_recorder if flight_recorder \
            is not None else FlightRecorder()
        registry = Registry()
        self.cache = InformerCache(self.fenced, registry=registry,
                                   key_filter=self._cache_filter)
        self.manager = Manager(self.fenced, clock=self.clock,
                               registry=registry, workers=workers,
                               flight_recorder=self.flight_recorder,
                               cache=self.cache, key_filter=self.owns_key)
        if hasattr(api, "watch"):
            api.watch(self._on_map_event, kinds=[SHARD_MAP_KIND])

    # -- ownership view -------------------------------------------------------
    def _on_map_event(self, ev) -> None:
        if ev.obj.kind != SHARD_MAP_KIND or \
                ev.obj.name != self.member.map_name:
            return
        self._install_status(ev.obj.body.get("status") or {},
                             rv=ev.obj.metadata.resource_version)

    def _install_status(self, status: dict,
                        rv: Optional[int] = None) -> None:
        with self._lock:
            if rv is not None:
                if rv <= self._installed_rv:
                    return    # stale delivery: a newer commit installed
                self._installed_rv = rv
            members = tuple(sorted(status.get("members") or {}))
            if members != self._ring.members:
                self._ring = HashRing(members, vnodes=self._vnodes)
            self._epoch = int(status.get("epoch") or 0)
            records = [dict(h) for h in status.get("handoffs") or ()]
            self._pending_handoffs = records
            if not records:
                # every movement acked out: current ownership is stable
                self._stable_ring = self._ring

    @property
    def epoch(self) -> int:
        return self._epoch

    def owns_key(self, namespace: str, name: str) -> bool:
        """Dispatch filter: the ring must assign the key here — and a
        key GAINED in a still-draining handoff is not dispatchable yet
        (the previous owner may have it in flight); it arrives via the
        batched adopt-enqueue at adoption time.  "Gained" is judged
        against the last STABLE ring — the ownership when no handoff was
        pending — so the gate stays correct when two changes overlap."""
        with self._lock:
            ring, stable, records = self._ring, self._stable_ring, \
                self._pending_handoffs
        if self.shard_id not in ring.members or \
                ring.owner_of(namespace, name) != self.shard_id:
            return False
        gated = any(self.shard_id in (h.get("adopters") or ())
                    and (h.get("drains") or ())
                    for h in records)
        if gated:
            if not stable.members or \
                    stable.owner_of(namespace, name) != self.shard_id:
                return False
        return True

    def _cache_filter(self, kind: str, namespace: str, name: str) -> bool:
        if kind not in self.sharded_kinds:
            return True
        with self._lock:
            ring = self._ring
        return self.shard_id in ring.members and \
            ring.owner_of(namespace, name) == self.shard_id

    # -- handoff protocol -----------------------------------------------------
    def join_fleet(self) -> None:
        """Join (or re-join) the fleet.  The map commit inside
        `member.join` is strictly WRITE-AHEAD of adoption: only after
        the RMW lands — epoch bump, fresh incarnation, handoff record
        naming this shard an adopter — does the replica install the
        committed view and start draining/adopting.  A crash between
        the two leaves a committed record any survivor completes; the
        reverse order would reconcile keys nobody committed to us
        (tests/test_torch_interleave.py model-checks it)."""
        view = self.member.join()
        self._install_status(view, rv=self.member.last_commit_rv)
        self._drain_and_adopt(view)
        self.alive = True

    def sync(self) -> None:
        """One handoff-protocol step off the committed map: refresh the
        ownership view, ack pending drains once nothing foreign is in
        flight, adopt once every record granting us keys has drained."""
        status, rv = self.member.read_status_rv()
        self._install_status(status, rv=rv)
        self._drain_and_adopt(status)

    def maintain(self) -> bool:
        """Periodic housekeeping: renew the member lease when a renewal
        is actually due (evicting expired peers), then run one handoff
        step.  Returns False when this replica found itself evicted
        (token already invalidated)."""
        if self.member.renew_due():
            if not self.member.renew():
                return False
        self.sync()
        return True

    def _drain_and_adopt(self, status: dict) -> None:
        records = status.get("handoffs") or ()
        if not records:
            return
        added: Optional[dict] = None
        if any(self.shard_id in (h.get("drains") or ()) for h in records) \
                and not self._holding_foreign_keys():
            # draining = dropping the moved keys: evict them from the
            # filtered cache before the ack tells adopters to proceed.
            # One resync against the CURRENT ring covers every pending
            # record's movement, so the ack clears all our drains.
            added = self._resync_sharded()
            status = self.member.ack_drain()
            self._install_status(status, rv=self.member.last_commit_rv)
            records = status.get("handoffs") or ()
        mine = [h for h in records
                if self.shard_id in (h.get("adopters") or ())]
        if mine and not any(h.get("drains") for h in mine):
            self._adopt(added)

    def _resync_sharded(self) -> dict:
        """Realign the filtered cache for every sharded kind; returns
        the keys the sweep newly admitted, per kind."""
        added: dict = {}
        for kind in self.sharded_kinds:
            try:
                added[kind] = set(self.cache.resync(kind))
            except ApiError as err:
                added[kind] = set()
                logger.warning("shard %s: resync of %s failed: %s",
                               self.shard_id, kind, err)
        return added

    def _adopt(self, added: Optional[dict]) -> None:
        """Adopt the keys this shard gained: realign the filtered cache
        with current ownership (unless the drain step just did), then
        enqueue the GAINED keys in one batched pass per kind — gained =
        newly admitted by the sweep plus anything the stable ring did
        not already assign here (keys that arrived by watch while the
        drain gate held) — and ack.  Runs strictly after the map commit
        that granted the keys (see join_fleet) and strictly after every
        drain ack.  The batched pass replaces a full enqueue_all walk:
        adoption cost scales with the keys that MOVED, not the keys the
        shard holds."""
        if added is None:
            added = self._resync_sharded()
        with self._lock:
            stable = self._stable_ring
        for kind in self.sharded_kinds:
            gained = set(added.get(kind) or ())
            for ns, name in self.cache.keys(kind):
                if not stable.members or \
                        stable.owner_of(ns, name) != self.shard_id:
                    gained.add((ns, name))
            self.manager.enqueue_keys(kind, sorted(gained))
        # non-sharded primary kinds (Event, TenantQuota, WarmPool, ...)
        # keep the full resync sweep: their keyspaces are small and the
        # dispatch filter still applies per namespace
        self.manager.enqueue_all(exclude_kinds=self.sharded_kinds)
        view, duration = self.member.ack_adopt()
        self._install_status(view, rv=self.member.last_commit_rv)
        if duration is not None:
            self.handoff_durations.append(duration)

    def _holding_foreign_keys(self) -> bool:
        for _reg, req in self.manager.inflight_requests():
            if not self.owns_key(req.namespace, req.name):
                return True
        return False

    # -- lifecycle ------------------------------------------------------------
    def kill(self) -> None:
        """Simulate the process dying mid-churn: workers stop (joined —
        no reconcile survives in this address space), but NO map write
        happens and the token is left as-is: the lease must expire and a
        survivor must evict us, and any zombie thread still holding the
        old FencedApi must be fenced, not trusted."""
        self.manager.stop()
        self.alive = False

    def leave_fleet(self) -> None:
        """Graceful departure: stop dispatch, drain in-flight work, then
        commit the removal (survivors adopt; nothing to drain)."""
        self.manager.stop()
        self.alive = False
        self.member.leave()

    def keys_owned(self) -> int:
        """Owned keys of the primary sharded kind, straight off the
        filtered cache (O(keys of this shard), never O(fleet))."""
        if not self.alive:
            return 0
        with self._lock:
            if self.shard_id not in self._ring.members:
                return 0  # evicted: stale cache entries are not ownership
        try:
            return len(self.cache.keys(self.sharded_kinds[0]))
        except ApiError:
            return 0

    def snapshot(self) -> dict:
        """Per-shard health for /debug/fleet and the metrics scrape."""
        return {
            "shard": self.shard_id,
            "alive": self.alive,
            "epoch": self._epoch,
            "incarnation": self.member.token.epoch,
            "token_valid": self.member.token.valid,
            "keys_owned": self.keys_owned(),
            "fenced_rejections": self.fenced.rejected_total,
            "handoffs_completed": len(self.handoff_durations),
            "rmw_conflicts": self.member.rmw_conflicts,
        }


class ShardedFleet:
    """N ShardedReplicas over one shared ApiServer: the active-active
    control plane of `main.build_sharded_fleet` and its tests.  The
    `controller_factory(replica)` callback registers each replica's
    controllers (against `replica.fenced` — that is what
    `replica.manager` hands reconcilers) before the replica joins."""

    def __init__(self, api, count: int = 3, *,
                 clock: Optional[Clock] = None,
                 controller_factory: Optional[Callable] = None,
                 workers: Optional[int] = None,
                 sharded_kinds: tuple = DEFAULT_SHARDED_KINDS,
                 lease_duration_s: float = DEFAULT_LEASE_DURATION_S,
                 map_name: str = DEFAULT_MAP_NAME) -> None:
        self.api = api
        self.clock = clock or Clock()
        self.map_name = map_name
        self.lease_duration_s = lease_duration_s
        self.sharded_kinds = tuple(sharded_kinds)
        self.workers = workers
        self._factory = controller_factory
        self.replicas: dict[str, ShardedReplica] = {}
        for i in range(count):
            self.add_replica(f"shard-{i}")

    def add_replica(self, shard_id: str) -> ShardedReplica:
        r = ShardedReplica(
            self.api, shard_id, clock=self.clock, map_name=self.map_name,
            lease_duration_s=self.lease_duration_s,
            sharded_kinds=self.sharded_kinds, workers=self.workers)
        self.replicas[shard_id] = r
        if self._factory is not None:
            self._factory(r)
        r.join_fleet()
        return r

    def kill(self, shard_id: str) -> None:
        self.replicas[shard_id].kill()

    def rejoin(self, shard_id: str) -> None:
        """Bring a killed replica back: a fresh incarnation through the
        same join path every replica uses."""
        self.replicas[shard_id].join_fleet()

    def alive_replicas(self) -> list[ShardedReplica]:
        return [r for r in self.replicas.values() if r.alive]

    def map_status(self) -> dict:
        for r in self.replicas.values():
            return r.member.read_status()
        return {}

    def pending_handoffs(self) -> list:
        """Every pending handoff record off the committed map."""
        return [dict(h) for h in self.map_status().get("handoffs") or ()]

    def rmw_conflicts(self) -> int:
        """Total shard-map RMW 409 retries across the fleet's members."""
        return sum(r.member.rmw_conflicts for r in self.replicas.values())

    def owner_of(self, namespace: str, name: str) -> Optional[str]:
        ring = HashRing(sorted(self.map_status().get("members") or {}))
        return ring.owner_of(namespace, name)

    def settle(self, max_rounds: int = 500,
               advance_clock: bool = True) -> int:
        """Round-robin the live replicas — renew, handoff step, drain
        workqueues — until a full pass does nothing and no handoff is
        pending.  Structurally idle replicas are SKIPPED: a replica with
        nothing queued, parked, or delayed, no pending record naming it,
        and a fresh lease has no step to run, so a pass costs O(active
        shards) instead of walking every replica's maintain + workqueue
        (at 10k+ notebooks the idle walks dominated handoff-stall wall
        time).  When a handoff stalls on a dead member's lease, the
        FakeClock jumps past the lease duration so survivors evict it
        (exactly what wall time does in production).  Returns total
        reconciles executed."""
        total = 0
        adv = getattr(self.clock, "advance", None) if advance_clock \
            else None
        last_status: Optional[dict] = None
        for _ in range(max_rounds):
            did = 0
            involved: set = set()
            for h in self.map_status().get("handoffs") or ():
                involved.update(h.get("adopters") or ())
                involved.update(h.get("drains") or ())
            for r in self.alive_replicas():
                busy = r.manager.has_pending_work()
                if not busy and r.shard_id not in involved and \
                        not r.member.renew_due():
                    continue
                r.maintain()
                if busy or r.manager.has_pending_work():
                    # livelock cap scaled to the shard's outstanding
                    # work: a 100k-notebook fleet legitimately drains
                    # tens of thousands of reconciles per round, so a
                    # flat cap misreads initial convergence as livelock
                    did += r.manager.run_until_idle(
                        max_iterations=max(
                            10_000, 8 * r.manager.pending_count()),
                        advance_clock=advance_clock)
            total += did
            status = self.map_status()
            changed = status != last_status
            last_status = status
            if did == 0 and not changed:
                # a full pass moved neither work nor the protocol
                if not status.get("handoffs"):
                    return total
                # a handoff waits on a member that will never ack (it
                # died): step time in sub-lease increments — survivors
                # renew each round, so only the dead lease ages past the
                # duration and gets evicted
                if adv is not None:
                    adv(self.lease_duration_s * 0.6)
                else:
                    raise RuntimeError(
                        "sharded fleet: handoff pending but no replica "
                        "made progress and the clock is not advanceable")
        raise RuntimeError("sharded fleet did not settle: handoff "
                           f"stalled after {max_rounds} rounds "
                           f"({self.pending_handoffs()})")

    def merged_records(self) -> list:
        """Every replica's flight-recorder history merged — the
        cross-process stream `flightrecorder.sweep_overlaps` (and
        ops/diagnose --merge) runs over."""
        out = []
        for r in self.replicas.values():
            out.extend(r.flight_recorder.attempts())
        return out

    def cross_process_overlaps(self) -> list:
        """Per-key serialization violations ACROSS replicas: two shards
        reconciling one key in the same wall-clock window.  Empty is the
        single-owner proof the kill/rejoin soak asserts."""
        from ..utils.flightrecorder import sweep_overlaps
        return sweep_overlaps(self.merged_records())

    def shard_snapshot(self) -> dict:
        """Fleet-wide shard health: the committed map plus each
        replica's local view — the `shards` section of /debug/fleet and
        the source the notebook_shard_* metric families scrape.  The
        `handoff` key stays the one-record rollup older dashboards read
        (None when nothing is pending); `handoffs` is the full
        per-change list."""
        status = self.map_status()
        records = [dict(h) for h in status.get("handoffs") or ()]
        merged = None
        if records:
            merged = {
                "epoch": records[-1].get("epoch"),
                "startedAt": records[0].get("startedAt"),
                "adopters": sorted({s for h in records
                                    for s in h.get("adopters") or ()}),
                "drains": sorted({s for h in records
                                  for s in h.get("drains") or ()}),
            }
        return {
            "epoch": int(status.get("epoch") or 0),
            "members": sorted(status.get("members") or {}),
            "handoff": merged,
            "handoffs": records,
            "lastHandoff": dict(status["lastHandoff"])
            if status.get("lastHandoff") else None,
            "replicas": {sid: r.snapshot()
                         for sid, r in sorted(self.replicas.items())},
        }


__all__ = [
    "DEFAULT_LEASE_DURATION_S", "DEFAULT_MAP_NAME", "DEFAULT_SHARDED_KINDS",
    "FencedApi", "HashRing", "SHARD_MAP_API_VERSION", "SHARD_MAP_KIND",
    "ShardMember", "ShardedFleet", "ShardedReplica", "StaleEpochError",
    "VNODES", "WRITE_VERBS", "new_shard_map",
]
