"""Lease-based leader election for manager HA.

The port's copy of kubeflow_tpu/kube/leader.py.

The reference enables controller-runtime leader election so two manager
replicas never double-reconcile (notebook-controller/main.go:91-93, odh
main.go:221-222).  Same protocol here: a coordination.k8s.io/v1 Lease named
per manager, acquired/renewed with optimistic concurrency; a candidate takes
over only when the holder's renewTime is older than the lease duration.
Works identically against the in-memory ApiServer and a real cluster via
KubeClient (Lease is just another object to both).

Leadership alone is not enough to keep a paused-then-resumed replica from
racing its successor: the old holder's threads may wake AFTER a rival
legally took over and issue writes under authority they no longer have.
The elector therefore carries a **fencing token** — the lease's
`leaseTransitions` count doubles as the fencing epoch, stamped onto every
lease write (`spec.fencingEpoch`) and latched into `self.token` on each
successful acquire/renew.  Any failure path (a lost round, `release()`)
invalidates the token BEFORE any subsequent write could race the new
leader, and `verify()` re-checks the lease so a deposed holder's late
write raises `StaleEpochError` instead of landing (see `kube/shard.py`
`FencedApi`, which proxies write verbs through `verify()`).
"""

from __future__ import annotations

import logging
import threading
from datetime import datetime, timezone
from typing import Callable, Optional

from ..utils.clock import Clock, parse_iso
from .errors import ApiError, ConflictError, ForbiddenError, NotFoundError
from .meta import KubeObject, ObjectMeta

logger = logging.getLogger("kubeflow_tpu_torch.kube.leader")

LEASE_KIND = "Lease"
LEASE_API_VERSION = "coordination.k8s.io/v1"


def _iso(t: float) -> str:
    return datetime.fromtimestamp(t, tz=timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.%fZ")


class StaleEpochError(ForbiddenError):
    """A write carried a fencing epoch that is no longer the authority's
    current one (deposed leader, evicted shard member, zombie process).
    Forbidden-family, not Conflict: retrying cannot help — the caller
    lost its authority and must stop writing."""


class FencingToken:
    """The local half of a fencing-token lease: the epoch the holder last
    proved authority at, plus a validity latch.  The latch is flipped off
    BEFORE any code path that could let a rival take over observes the
    loss — so a holder that merely *suspects* it lost (failed renew,
    release) stops writing immediately, and a holder that provably lost
    gets `StaleEpochError` from `verify()`."""

    __slots__ = ("epoch", "valid")

    def __init__(self) -> None:
        self.epoch = -1
        self.valid = False

    def renew(self, epoch: int) -> None:
        self.epoch = int(epoch)
        self.valid = True

    def invalidate(self) -> None:
        self.valid = False


class LeaderElector:
    """client-go leaderelection.LeaderElector over a Lease object."""

    def __init__(
        self,
        api,
        lease_name: str,
        namespace: str,
        identity: str,
        lease_duration_s: float = 15.0,
        renew_period_s: float = 10.0,
        retry_period_s: float = 2.0,
        renew_deadline_s: Optional[float] = None,
        clock: Optional[Clock] = None,
    ) -> None:
        self.api = api
        self.lease_name = lease_name
        self.namespace = namespace
        self.identity = identity
        self.lease_duration_s = lease_duration_s
        self.renew_period_s = renew_period_s
        self.retry_period_s = retry_period_s
        # client-go requires RenewDeadline < LeaseDuration: the deposed
        # leader must stop reconciling BEFORE a rival can legally take over
        # (renew + duration elapsed), or the single-writer guarantee breaks
        # for the gap.  The derived default leaves two retry rounds of
        # margin, clamped so it stays < lease_duration for short leases.
        if renew_deadline_s is None:
            renew_deadline_s = max(lease_duration_s - 2 * retry_period_s,
                                   lease_duration_s * 0.6)
        elif renew_deadline_s >= lease_duration_s:
            raise ValueError(
                f"renew_deadline_s ({renew_deadline_s}) must be < "
                f"lease_duration_s ({lease_duration_s})")
        self.renew_deadline_s = renew_deadline_s
        self.clock = clock or Clock()
        self.is_leader = False
        #: fencing token: epoch = the lease's leaseTransitions at the last
        #: successful acquire/renew; invalidated before any write can race
        #: a successor (see verify())
        self.token = FencingToken()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- single protocol step -------------------------------------------------
    def try_acquire_or_renew(self) -> bool:
        """One election round; returns True while holding leadership."""
        now = self.clock.now()
        try:
            lease = self.api.try_get(LEASE_KIND, self.namespace, self.lease_name)
            if lease is None:
                lease = KubeObject(
                    api_version=LEASE_API_VERSION,
                    kind=LEASE_KIND,
                    metadata=ObjectMeta(name=self.lease_name,
                                        namespace=self.namespace),
                    body={"spec": {
                        "holderIdentity": self.identity,
                        "leaseDurationSeconds": int(self.lease_duration_s),
                        "acquireTime": _iso(now),
                        "renewTime": _iso(now),
                        "leaseTransitions": 0,
                        "fencingEpoch": 0,
                    }},
                )
                self.api.create(lease)
                return self._became(True, epoch=0)
            spec = lease.body.get("spec", {})
            holder = spec.get("holderIdentity", "")
            renew = parse_iso(spec["renewTime"]) if spec.get("renewTime") else 0.0
            duration = float(spec.get("leaseDurationSeconds",
                                      self.lease_duration_s))
            if holder == self.identity:
                spec["renewTime"] = _iso(now)
            elif renew + duration < now:
                # stale holder: take over (the transition count doubles as
                # the fencing epoch — client-go bumps it the same way, the
                # bump is what deposes the old holder's token)
                spec["holderIdentity"] = self.identity
                spec["acquireTime"] = _iso(now)
                spec["renewTime"] = _iso(now)
                spec["leaseTransitions"] = int(spec.get("leaseTransitions", 0)) + 1
            else:
                return self._became(False)
            epoch = int(spec.get("leaseTransitions", 0))
            spec["fencingEpoch"] = epoch
            lease.body["spec"] = spec
            self.api.update(lease)
            return self._became(True, epoch=epoch)
        except (ConflictError, NotFoundError):
            return self._became(False)  # raced another candidate; retry later
        except ApiError as err:
            logger.warning("leader election round failed: %s", err)
            return self._became(False)

    def _became(self, leader: bool, epoch: Optional[int] = None) -> bool:
        if not leader:
            # invalidate FIRST: from this instant no write under this
            # elector's authority may land, even if a worker thread is
            # already past its own is_leader check
            self.token.invalidate()
        if leader != self.is_leader:
            logger.info("leader election: %s is now %s", self.identity,
                        "leader" if leader else "follower")
        self.is_leader = leader
        if leader and epoch is not None:
            self.token.renew(epoch)
        return leader

    def release(self) -> None:
        """Graceful handoff on shutdown (client-go ReleaseOnCancel).
        Leadership and the fencing token drop BEFORE the lease write: a
        successor may legally acquire the instant our update lands, so
        any of our writes racing past this point must already be fenced."""
        if not self.is_leader:
            return
        self.is_leader = False
        self.token.invalidate()
        try:
            lease = self.api.try_get(LEASE_KIND, self.namespace, self.lease_name)
            if lease and lease.body.get("spec", {}).get(
                    "holderIdentity") == self.identity:
                lease.body["spec"]["holderIdentity"] = ""
                lease.body["spec"]["renewTime"] = _iso(0.0)
                self.api.update(lease)
        except ApiError:
            pass

    def verify(self) -> int:
        """Fencing check for writes issued under this elector's authority
        (kube/shard.py FencedApi calls this before every proxied write):
        returns the fencing epoch, or raises StaleEpochError unless the
        token is valid AND the lease still names this identity at the
        token's epoch.  A verify failure invalidates the token, so every
        later write fails fast without re-reading the lease."""
        tok = self.token
        if not tok.valid:
            raise StaleEpochError(
                f"{self.identity}: fencing token invalidated (leadership "
                "lost or released)")
        try:
            lease = self.api.try_get(LEASE_KIND, self.namespace,
                                     self.lease_name)
        except ApiError:
            lease = None
        spec = (lease.body.get("spec") or {}) if lease is not None else {}
        if spec.get("holderIdentity") != self.identity or \
                int(spec.get("leaseTransitions", 0) or 0) != tok.epoch:
            tok.invalidate()
            raise StaleEpochError(
                f"{self.identity}: lease epoch moved on (held epoch "
                f"{tok.epoch}, holder now "
                f"{spec.get('holderIdentity', '<gone>')!r} at epoch "
                f"{int(spec.get('leaseTransitions', 0) or 0)})")
        return tok.epoch

    # -- blocking run loop ----------------------------------------------------
    def run(
        self,
        on_started_leading: Callable[[], None],
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ) -> None:
        """Block until leadership is acquired, invoke on_started_leading,
        then keep renewing; if leadership is lost, invoke on_stopped_leading
        and return (the process should exit and restart, as controller-runtime
        does)."""
        started = False
        last_ok = self.clock.now()
        while not self._stop.is_set():
            leader = self.try_acquire_or_renew()
            if leader:
                last_ok = self.clock.now()
                if not started:
                    started = True
                    on_started_leading()
            elif started:
                # a transient renew failure must not abdicate immediately —
                # client-go retries until the renew DEADLINE, which is
                # strictly shorter than the lease duration so we stop
                # reconciling before any rival may legally take over
                if self.clock.now() - last_ok > self.renew_deadline_s:
                    logger.error("renew deadline passed; leadership lost "
                                 "for %s", self.identity)
                    if on_stopped_leading:
                        on_stopped_leading()
                    return
                logger.warning(
                    "lease renew failed for %s; retrying within the "
                    "%.0fs renew deadline", self.identity,
                    self.renew_deadline_s)
            self._stop.wait(self.renew_period_s if leader
                            else self.retry_period_s)
        if started:
            self.release()

    def start_background(self, on_started: Callable[[], None],
                         on_stopped: Optional[Callable[[], None]] = None) -> None:
        self._thread = threading.Thread(
            target=self.run, args=(on_started, on_stopped),
            daemon=True, name="leader-elector")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None


__all__ = ["FencingToken", "LeaderElector", "StaleEpochError",
           "LEASE_KIND", "LEASE_API_VERSION"]
