"""Controller runtime: reconcilers, watch wiring, workqueue, manager.

The port's copy of kubeflow_tpu/kube/controller.py.

Mirrors the controller-runtime model the reference is built on —
level-triggered reconcilers keyed by namespace/name, For/Owns/Watches source
wiring with predicates and request mappers
(notebook-controller/controllers/notebook_controller.go:777-826), and a
manager that runs every registered controller
(notebook-controller/main.go:58-148).  Execution is deterministic and
single-threaded by default (`run_until_idle`), which replaces envtest's
eventually-consistent goroutine loop with exact test semantics; standalone
operation runs a pool of WORKQUEUE_WORKERS worker threads with strict
per-key serialization (controller-runtime workqueue semantics — an
in-flight key parks instead of double-dispatching), and `run_until_idle`
drives the same pool batch-wise so threaded soaks stay FakeClock-exact.
Reconcilers read through the manager's indexed informer cache
(kube/cache.py) rather than live api.list scans.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Protocol

from ..utils import invariants, tracing
from ..utils.clock import Clock
from ..utils.flightrecorder import FlightRecorder
from ..utils.metrics import Registry
from .cache import InformerCache
from .errors import GoneError
from .meta import KubeObject
from .store import ApiServer, EventType, WatchEvent

logger = logging.getLogger("kubeflow_tpu_torch.kube")

# every reconcile attempt runs under a root span from this tracer (noop
# until an exporter is installed — utils.tracing.set_exporter)
_TRACER = tracing.get_tracer("kubeflow_tpu_torch.kube.manager")


@dataclass(frozen=True)
class Request:
    namespace: str
    name: str


@dataclass
class Result:
    requeue: bool = False
    requeue_after: float = 0.0  # seconds


class Reconciler(Protocol):
    def reconcile(self, req: Request) -> Result: ...


Predicate = Callable[[WatchEvent], bool]
Mapper = Callable[[KubeObject], list[Request]]

# metadata keys the server rewrites on every store commit; a delta confined
# to these (plus status) is a self-inflicted status write, not user intent
_SERVER_META_KEYS = ("resourceVersion", "managedFields", "generation")


def is_status_only_update(ev: WatchEvent) -> bool:
    """True for MODIFIED events whose old→new delta is confined to `status`
    and server-managed metadata.  Only decidable when the event carries its
    pre-update state (`prev` — the in-memory watch cache provides it; a
    real-cluster informer does not, and the predicate then passes
    everything, which is merely chatty, never incorrect)."""
    if ev.type is not EventType.MODIFIED or ev.prev is None:
        return False

    def strip(obj: KubeObject) -> dict:
        d = obj.to_dict()
        d.pop("status", None)
        meta = d.get("metadata")
        if isinstance(meta, dict):
            for k in _SERVER_META_KEYS:
                meta.pop(k, None)
        return d

    return strip(ev.prev) == strip(ev.obj)


def suppress_status_only(ev: WatchEvent) -> bool:
    """for_predicate that drops self-inflicted status-only updates: a
    controller that writes its primary's status must not be re-triggered by
    that very write, or a converged fleet never reaches a zero-reconcile
    steady state.  Only correct on kinds whose status THIS manager's
    controllers write (the Notebook CR) — an owned workload's status
    (StatefulSet readyReplicas) is data-plane truth the reconciler needs,
    and those arrive via Owns/Watches wiring, not the for_kind path."""
    return not is_status_only_update(ev)


@dataclass
class WatchSpec:
    kind: str
    mapper: Mapper
    predicate: Optional[Predicate] = None


@dataclass
class _Registration:
    name: str
    reconciler: Reconciler
    for_kind: str
    owns: list[str] = field(default_factory=list)
    watches: list[WatchSpec] = field(default_factory=list)
    max_retries: int = 5
    # event filter on the primary kind (controller-runtime WithEventFilter
    # scoped to For); suppress_status_only is the canonical instance
    for_predicate: Optional[Predicate] = None


@dataclass(order=True)
class _Delayed:
    due: float
    reg_name: str = field(compare=False)
    request: Request = field(compare=False)
    # True for rate-limited retries (error backoff / Result.requeue): these
    # are part of "draining the queue" and run_until_idle may advance a fake
    # clock over them; requeue_after waits are scheduled work and are NOT
    # auto-advanced (tests drive those with advance())
    retry: bool = field(default=False, compare=False)
    # when the item entered the workqueue system (clock time); retries stamp
    # at schedule time so the backoff wait shows up in
    # workqueue_queue_duration_seconds, while requeue_after schedules (0.0)
    # stamp at promotion — a timer wait is not queueing
    enqueued_at: float = field(default=0.0, compare=False)


# -- workqueue rate limiting ---------------------------------------------------
# The controller-runtime default workqueue limiter:
# MaxOfRateLimiter(ItemExponentialFailureRateLimiter(5ms, 1000s),
#                  BucketRateLimiter(10 qps, 100 burst)).  `when(item)`
# charges the item and returns the delay before it may run again;
# `forget(item)` resets its failure history on success.


class ItemExponentialBackoff:
    """Per-item exponential backoff with bounded jitter.

    delay = min(base * 2^failures, cap), then scaled by a seeded jitter in
    [1, 1+jitter) — deterministic for a given seed, so tests can assert
    exact bounds; jitter decorrelates retry herds in threaded mode."""

    def __init__(self, base_s: float = 0.005, cap_s: float = 1000.0,
                 jitter: float = 0.1, seed: int = 0) -> None:
        self.base_s = base_s
        self.cap_s = cap_s
        self.jitter = jitter
        self._rng = random.Random(seed)
        self._failures: dict[object, int] = {}
        self._lock = invariants.tracked(
            threading.Lock(), "ItemExponentialBackoff._lock")

    def when(self, item) -> float:
        with self._lock:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
        delay = min(self.base_s * (2 ** n), self.cap_s)
        if self.jitter > 0:
            delay *= 1.0 + self.jitter * self._rng.random()
        return delay

    def forget(self, item) -> None:
        with self._lock:
            self._failures.pop(item, None)

    def num_failures(self, item) -> int:
        with self._lock:
            return self._failures.get(item, 0)


class BucketRateLimiter:
    """Token-bucket overall limiter on an injectable clock
    (client-go flowcontrol; reservations may drive tokens negative, so a
    burst of retries spreads out at 1/qps)."""

    def __init__(self, qps: float = 10.0, burst: int = 100,
                 clock: Optional[Clock] = None) -> None:
        self.qps = qps
        self.burst = max(burst, 1)
        self.clock = clock or Clock()
        self._tokens = float(self.burst)
        self._last = self.clock.now()
        self._lock = invariants.tracked(
            threading.Lock(), "BucketRateLimiter._lock")

    def when(self, item) -> float:
        if self.qps <= 0:
            return 0.0
        with self._lock:
            now = self.clock.now()
            self._tokens = min(float(self.burst),
                               self._tokens + (now - self._last) * self.qps)
            self._last = now
            self._tokens -= 1.0  # reserve (may go negative)
            if self._tokens >= 0:
                return 0.0
            return -self._tokens / self.qps

    def forget(self, item) -> None:
        pass

    def num_failures(self, item) -> int:
        return 0


class MaxOfRateLimiter:
    """The worst (longest) answer of its children — controller-runtime's
    DefaultControllerRateLimiter composition."""

    def __init__(self, *limiters) -> None:
        self.limiters = limiters

    def when(self, item) -> float:
        return max(rl.when(item) for rl in self.limiters)

    def forget(self, item) -> None:
        for rl in self.limiters:
            rl.forget(item)

    def num_failures(self, item) -> int:
        return max(rl.num_failures(item) for rl in self.limiters)


def default_rate_limiter(
    clock: Optional[Clock] = None,
    base_s: float = 0.005,
    cap_s: float = 1000.0,
    qps: float = 10.0,
    burst: int = 100,
    jitter: float = 0.1,
    seed: int = 0,
) -> MaxOfRateLimiter:
    """The workqueue limiter Manager installs by default; knobs map to
    CoreConfig.workqueue_* (utils.config) so deployments can tune them."""
    return MaxOfRateLimiter(
        ItemExponentialBackoff(base_s=base_s, cap_s=cap_s, jitter=jitter,
                               seed=seed),
        BucketRateLimiter(qps=qps, burst=burst, clock=clock),
    )


class _WatchSession:
    """The manager's droppable watch connection.  Tracks the newest
    resourceVersion delivered so a fault-injected stream drop
    (ApiServer.drop_watch_connections) can resume exactly where it left
    off via subscribe(since_rv); if the history window was compacted away
    (410 Gone) it reconnects live-only and RELISTS — enqueueing every
    primary object, the client-go reflector's relist in controller terms.

    The session registers FILTERED: it asks the apiserver only for the
    kinds some registered controller watches (`kinds`, kept current by
    Manager.register/unregister via update_watch_kinds), so an event on
    an uninteresting kind never invokes this callback at all."""

    def __init__(self, mgr: "Manager") -> None:
        self.mgr = mgr
        self.last_rv = 0
        self.connected = True
        self.drops = 0
        self.relists = 0
        # current kind filter (None until first registration: nothing is
        # interesting yet, but resume semantics want the full stream shape
        # only for watched kinds anyway)
        self.kinds: list[str] = []

    def __call__(self, ev: WatchEvent) -> None:
        rv = ev.obj.metadata.resource_version
        if isinstance(rv, int) and rv > self.last_rv:
            self.last_rv = rv
        self.mgr._on_event(ev)

    def on_watch_dropped(self) -> None:
        # noticed lazily, as a real client notices a dead stream: the
        # manager reconnects at its next processing step, so events landing
        # in between form a genuine gap the resume protocol must cover
        self.drops += 1
        self.connected = False

    def set_kinds(self, kinds: list[str]) -> None:
        self.kinds = list(kinds)
        update = getattr(self.mgr.api, "update_watch_kinds", None)
        if update is not None and self.connected:
            update(self, self.kinds)

    def reconnect(self) -> None:
        api = self.mgr.api
        try:
            api.subscribe(self, since_rv=self.last_rv, kinds=self.kinds)
        except GoneError:
            # resume window compacted away (410): reconnect live and
            # relist so no state transition is missed (level-triggered
            # reconcilers re-derive everything from current state).  The
            # relist itself is recovery machinery, not client traffic —
            # exempt from an active fault plan
            api.subscribe(self, kinds=self.kinds)
            self.relists += 1
            exempt = getattr(api, "fault_exempt", None)
            if exempt is not None:
                with exempt():
                    self.mgr.enqueue_all()
            else:
                self.mgr.enqueue_all()
        self.connected = True


class Manager:
    """Runs registered controllers against an ApiServer.

    Tests drive it with `run_until_idle()` (drains the workqueue, honoring
    requeue-after via the injected clock when `advance_clock=True`);
    standalone mode uses `start()` which spins `workers` worker threads.

    Parallelism follows controller-runtime's workqueue contract: up to
    `workers` requests process concurrently, but never two for the same
    (controller, request) key — an event for an in-flight key parks in the
    dirty set and re-queues when the running reconcile completes.  Popping
    is round-robin across controllers so one hot controller cannot starve
    the rest.  `workers` defaults to the WORKQUEUE_WORKERS env var (1 when
    unset); `run_until_idle` uses the same pool, processing per-batch with
    a barrier so FakeClock advancement stays single-threaded.
    """

    def __init__(self, api: ApiServer, clock: Optional[Clock] = None,
                 rate_limiter=None, registry: Optional[Registry] = None,
                 flight_recorder: Optional[FlightRecorder] = None,
                 workers: Optional[int] = None,
                 cache: Optional[InformerCache] = None,
                 key_filter=None) -> None:
        self.api = api
        self.clock = clock or Clock()
        # sharded control plane (kube/shard.py): admit only requests this
        # replica owns.  Checked at enqueue AND re-checked at dispatch, so
        # a key that moved away while queued is dropped, not reconciled.
        self._key_filter = key_filter
        if workers is None:
            try:
                workers = int(os.environ.get("WORKQUEUE_WORKERS", "") or 1)
            except ValueError:
                workers = 1
        self.workers = max(1, workers)
        # bounded in-process history of completed reconcile attempts, fed
        # with each attempt's finished root span (/debug/reconciles reads it)
        self.flight_recorder = flight_recorder or FlightRecorder()
        # optional fleet observers (build_manager wires them): the SLO
        # engine receives every completed AttemptRecord (exemplar latching
        # for burn alerts — utils/slo.py), the continuous profiler hangs
        # here so /debug/profile can reach it, the lifecycle ledger folds
        # every attempt into its notebook's stage partition
        # (utils/lifecycle.py), and the TSDB hangs here for /debug/timeline
        self.slo_engine = None
        self.profiler = None
        self.lifecycle = None
        self.tsdb = None
        # tenant metering ledger (utils/metering.py): receives per-tenant
        # workqueue dispatch attribution and the completed-attempt stream
        self.metering = None
        # causal diagnosis engine (utils/diagnosis.py): mines the attempt
        # stream for discrete evidence (faults, promotions, recoveries)
        self.diagnosis = None
        # replica identity for lifecycle attribution: a sharded fleet sets
        # this to the shard id so a manager change between consecutive
        # attempts of one notebook reads as handoff/adoption wait
        self.manager_id = ""
        self._limiter = rate_limiter or default_rate_limiter(self.clock)
        self._registrations: list[_Registration] = []
        self._lock = invariants.tracked(
            threading.Lock(), "Manager._lock")
        # per-controller FIFO deques, popped round-robin (fairness across
        # registrations); _queued is the dirty set — the single source of
        # truth for "this key has pending work"
        self._queues: dict[str, deque[tuple[str, Request]]] = {}
        self._queued: set[tuple[str, Request]] = set()
        # keys currently being reconciled (per-key serialization): an
        # event for one of these parks in _queued and re-queues on _done
        self._processing: set[tuple[str, Request]] = set()
        # clock time each in-flight key started processing, feeding
        # workqueue_longest_running_processor_seconds
        self._inflight_started: dict[tuple[str, Request], float] = {}
        self._rr_cursor = 0  # round-robin position over registrations
        self._delayed: list[_Delayed] = []
        self._retries: dict[tuple[str, Request], int] = {}
        self._errors: list[tuple[str, Request, BaseException]] = []
        # per-controller observability (scraped by core.metrics):
        # retries scheduled, last backoff delay, errors dropped
        self._retry_totals: dict[str, int] = {}
        self._last_backoff: dict[str, float] = {}
        # controller-runtime's canonical reconcile/workqueue telemetry, all
        # timed off the injected clock so FakeClock tests see exact values.
        # core.metrics.NotebookMetrics concatenates this registry into the
        # /metrics exposition when a manager is attached.
        self.metrics_registry = registry or Registry()
        self.reconcile_total = self.metrics_registry.counter(
            "controller_runtime_reconcile_total",
            "Total number of reconciliations per controller",
            labels=("controller", "result"))
        self.reconcile_time = self.metrics_registry.histogram(
            "controller_runtime_reconcile_time_seconds",
            "Length of time per reconciliation per controller",
            labels=("controller",))
        self.queue_duration = self.metrics_registry.histogram(
            "workqueue_queue_duration_seconds",
            "How long a request stays in the workqueue (retry backoff "
            "included) before processing starts",
            labels=("controller",))
        self.work_duration = self.metrics_registry.histogram(
            "workqueue_work_duration_seconds",
            "How long processing a request from the workqueue takes",
            labels=("controller",))
        # control-plane reaction latency, the NotebookOS headline number:
        # the clock delta from the watch event that caused an enqueue to
        # the moment its reconcile starts.  Only event-caused enqueues are
        # stamped (resyncs and retry promotions are not reactions); the
        # first cause wins while a key stays queued.
        self.event_to_reconcile = self.metrics_registry.histogram(
            "notebook_event_to_reconcile_seconds",
            "Latency from the enqueue-cause watch event to reconcile start",
            labels=("controller",),
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0,
                     120.0))
        # per-key cause stamps: (clock time, monotonic wall time) of the
        # event that put the key in the queue
        self._cause_stamps: dict[tuple[str, Request], tuple[float, float]] = {}
        # per-key tenant stamps (owning namespace at enqueue), feeding the
        # metering ledger's per-tenant dispatch attribution at _pop
        self._tenant_stamps: dict[tuple[str, Request], str] = {}
        # cause clock-time carried from _pop to the attempt's root span
        # (per-key serialization guarantees no concurrent writer per key)
        self._attempt_cause: dict[tuple[str, Request], float] = {}
        # exact wall-clock samples for percentile reporting (FakeClock runs
        # collapse the injected-clock delta to ~0, so the loadtest reads
        # real reaction time from here); bounded for long-lived managers
        self._event_latency: deque[float] = deque(maxlen=1 << 18)
        # indexed informer cache: the reconcilers' read path (hot-path
        # lookups go through registered indexes instead of api.list scans);
        # subscribes to the same watch stream as the manager, BEFORE the
        # manager's own session so an event's cache update is visible by
        # the time its reconcile request can possibly run
        self.cache = cache if cache is not None else \
            InformerCache(api, registry=self.metrics_registry)
        # enqueue timestamps feeding workqueue_queue_duration_seconds
        self._enqueued_at: dict[tuple[str, Request], float] = {}
        # one trace per retry chain: trace id held until the request
        # succeeds, schedules itself (requeue_after), or is dropped;
        # attempt numbers ride along as span attributes
        self._trace_ids: dict[tuple[str, Request], str] = {}
        self._attempt_seq: dict[tuple[str, Request], int] = {}
        self._stop = threading.Event()
        self._started = False
        self._threads: list[threading.Thread] = []
        if hasattr(api, "subscribe"):
            # in-memory ApiServer: a resumable session that survives
            # injected watch-stream drops (kube.faults), registered with an
            # (initially empty) kind filter that register() keeps current
            self._watch_session: Optional[_WatchSession] = _WatchSession(self)
            api.watch(self._watch_session, kinds=[])
        else:
            # KubeClient: its reflector informers own drop/relist recovery
            # and are already per-kind streams
            self._watch_session = None
            api.watch(self._on_event)

    def set_rate_limiter(self, rate_limiter) -> None:
        """Swap the workqueue rate limiter (see default_rate_limiter);
        in-flight failure history is dropped with the old limiter."""
        self._limiter = rate_limiter

    # -- registration ---------------------------------------------------------
    def register(
        self,
        name: str,
        reconciler: Reconciler,
        for_kind: str,
        owns: Optional[list[str]] = None,
        watches: Optional[list[WatchSpec]] = None,
        max_retries: int = 5,
        for_predicate: Optional[Predicate] = None,
    ) -> None:
        self._registrations.append(
            _Registration(
                name=name,
                reconciler=reconciler,
                for_kind=for_kind,
                owns=owns or [],
                watches=watches or [],
                max_retries=max_retries,
                for_predicate=for_predicate,
            )
        )
        with self._lock:
            self._queues.setdefault(name, deque())
        # widen (never replays) the session's kind filter to cover the new
        # controller's For/Owns/Watches set — a kind no controller watches
        # never reaches _on_event at all
        if self._watch_session is not None:
            self._watch_session.set_kinds(self.watched_kinds())

    def unregister(self, name: str) -> None:
        """Remove a controller and drop its queued/delayed work.  An
        in-flight reconcile for it finishes first (the worker holds no
        lock across reconciles, so the next _pop simply won't see it)."""
        with self._lock:
            self._registrations = [
                r for r in self._registrations if r.name != name]
            self._queues.pop(name, None)
            self._queued = {k for k in self._queued if k[0] != name}
            self._delayed = [d for d in self._delayed if d.reg_name != name]
            # retry budgets AND rate-limiter history die with the controller
            # — a later registration under the same name starts fresh, not
            # mid-backoff
            dropped = [k for k in self._retries if k[0] == name]
            self._retries = {k: v for k, v in self._retries.items()
                             if k[0] != name}
            for d in (self._enqueued_at, self._trace_ids, self._attempt_seq,
                      self._cause_stamps, self._attempt_cause,
                      self._tenant_stamps):
                for k in [k for k in d if k[0] == name]:
                    del d[k]
        for k in dropped:
            self._limiter.forget(k)
        if self._watch_session is not None:
            self._watch_session.set_kinds(self.watched_kinds())

    # -- event -> requests ----------------------------------------------------
    def _on_event(self, ev: WatchEvent) -> None:
        # one cause stamp per delivery: the (clock, wall) instant of the
        # event whose requests are about to enqueue, feeding the
        # event->reconcile-start reaction-latency metric
        cause = (self.clock.now(), time.monotonic())
        for reg in self._registrations:
            for req in self._requests_for(reg, ev):
                self._enqueue(reg.name, req, cause=cause)

    def _requests_for(self, reg: _Registration, ev: WatchEvent) -> list[Request]:
        obj = ev.obj
        if obj.kind == reg.for_kind:
            if reg.for_predicate is not None and not reg.for_predicate(ev):
                return []
            return [Request(obj.namespace, obj.name)]
        if obj.kind in reg.owns:
            ref = obj.metadata.controller_owner()
            if ref is not None and ref.kind == reg.for_kind:
                return [Request(obj.namespace, ref.name)]
            return []
        out: list[Request] = []
        for spec in reg.watches:
            if spec.kind != obj.kind:
                continue
            if spec.predicate is not None and not spec.predicate(ev):
                continue
            out.extend(spec.mapper(obj))
        return out

    def _enqueue(self, reg_name: str, req: Request,
                 enqueued_at: Optional[float] = None,
                 cause: Optional[tuple[float, float]] = None) -> None:
        if self._key_filter is not None and \
                not self._key_filter(req.namespace, req.name):
            return  # not ours: rejected before the queue, not a mutation
        invariants.yield_point("queue.add", (reg_name, req.namespace,
                                             req.name))
        with self._lock:
            key = (reg_name, req)
            if key in self._queued:
                return
            queue = self._queues.get(reg_name)
            if queue is None:
                return  # controller unregistered; drop
            self._queued.add(key)
            # per-key serialization: a key being processed is PARKED (dirty
            # only) — _done re-queues it when the running reconcile ends,
            # so no worker ever processes the same key concurrently
            if key not in self._processing:
                queue.append(key)
            self._enqueued_at.setdefault(
                key,
                self.clock.now() if enqueued_at is None else enqueued_at)
            if cause is not None:
                # first cause wins while the key stays dirty: the reaction
                # latency is measured from the event the fleet REACTED to
                self._cause_stamps.setdefault(key, cause)
            # tenant stamp rides next to the cause stamp: the owning
            # namespace at enqueue time, attributing this key's queue wait
            # and reaction latency to its tenant at dispatch (_pop)
            self._tenant_stamps.setdefault(key, req.namespace)

    def enqueue(self, reg_name: str, req: Request) -> None:
        """Manual enqueue (tests, resync ticks)."""
        self._enqueue(reg_name, req)

    def watched_kinds(self) -> list[str]:
        """Every kind any controller watches — the informer set a real-cluster
        backend must stream (controller-runtime derives the same from
        For/Owns/Watches wiring)."""
        kinds: set[str] = set()
        for reg in self._registrations:
            kinds.add(reg.for_kind)
            kinds.update(reg.owns)
            kinds.update(spec.kind for spec in reg.watches)
        return sorted(kinds)

    def enqueue_all(self, reg_name: Optional[str] = None,
                    exclude_kinds: tuple = ()) -> None:
        """Resync: enqueue every existing primary object (informer
        re-list).  Reads the informer cache — key materialization only,
        no apiserver round trip, no per-object deepcopy — and the dirty
        set dedupes against work already queued or in flight.
        `exclude_kinds` skips controllers whose For-kind is listed —
        the shard adoption path covers those via `enqueue_keys` and
        only needs the sweep for the rest."""
        if self.cache is not None:
            self.cache.ensure_connected()
        for reg in self._registrations:
            if reg_name is not None and reg.name != reg_name:
                continue
            if reg.for_kind in exclude_kinds:
                continue
            if self.cache is not None:
                keys = self.cache.keys(reg.for_kind)
            else:
                keys = [(o.namespace, o.name)
                        for o in self.api.list(reg.for_kind)]
            for ns, name in keys:
                self._enqueue(reg.name, Request(ns, name))

    def enqueue_keys(self, kind: str,
                     keys: Iterable[tuple[str, str]]) -> None:
        """Batched enqueue of specific primary keys for every controller
        whose For-kind is `kind` — ONE lock acquisition and ONE schedule
        point for the whole batch.  The shard adoption path uses this: a
        membership commit can grant thousands of keys at once, and the
        per-key _enqueue walk (lock + yield point each) was measurable
        wall time in the 10k+ fleet sweeps."""
        reqs = [Request(ns, name) for ns, name in keys]
        if self._key_filter is not None:
            reqs = [r for r in reqs
                    if self._key_filter(r.namespace, r.name)]
        reg_names = [r.name for r in self._registrations
                     if r.for_kind == kind]
        if not reqs or not reg_names:
            return
        invariants.yield_point("queue.add", (kind, "batch", len(reqs)))
        now = self.clock.now()
        with self._lock:
            for reg_name in reg_names:
                queue = self._queues.get(reg_name)
                if queue is None:
                    continue
                for req in reqs:
                    key = (reg_name, req)
                    if key in self._queued:
                        continue
                    self._queued.add(key)
                    if key not in self._processing:
                        queue.append(key)
                    self._enqueued_at.setdefault(key, now)
                    self._tenant_stamps.setdefault(key, req.namespace)

    def has_pending_work(self) -> bool:
        """Structural-idleness probe for fleet settle loops: anything
        queued, parked in flight, or waiting in delayed retry means a
        run_until_idle pass could still do work.  O(1) under the lock —
        cheap enough to ask once per replica per settle round, which is
        what lets an idle shard be skipped entirely."""
        with self._lock:
            return bool(self._queued or self._processing or self._delayed)

    def pending_count(self) -> int:
        """Outstanding work items (queued + in flight + delayed) — the
        scale factor for drain-loop livelock caps: a shard that owns N
        keys legitimately runs O(N) reconciles in one drain, so a flat
        iteration cap misreads initial convergence at fleet scale as a
        livelock."""
        with self._lock:
            return len(self._queued) + len(self._processing) + \
                len(self._delayed)

    # -- execution ------------------------------------------------------------
    def _pop(self) -> Optional[tuple[str, Request]]:
        invariants.yield_point("queue.pop", None)
        with self._lock:
            # fairness: rotate over registrations so one chatty controller
            # cannot starve the others' queues
            names = [r.name for r in self._registrations]
            key = None
            for off in range(len(names)):
                name = names[(self._rr_cursor + off) % len(names)]
                queue = self._queues.get(name)
                if queue:
                    key = queue.popleft()
                    self._rr_cursor = (self._rr_cursor + off + 1) % len(names)
                    break
            if key is None:
                return None
            self._queued.discard(key)
            self._processing.add(key)
            self._inflight_started[key] = self.clock.now()
            enqueued_at = self._enqueued_at.pop(key, None)
            cause = self._cause_stamps.pop(key, None)
            tenant = self._tenant_stamps.pop(key, key[1].namespace)
            tid = self._trace_ids.get(key, "")
            if cause is not None:
                # ride the cause clock-time to _process_item so the
                # lifecycle ledger can anchor the notebook's event->ready
                # window at the event the fleet reacted to
                self._attempt_cause[key] = cause[0]
        e2r_s = 0.0
        if cause is not None:
            # event -> reconcile-start: the injected-clock delta feeds the
            # deterministic histogram; the wall-clock delta feeds the exact
            # percentile samples the loadtest reports
            e2r_s = max(self.clock.now() - cause[0], 0.0)
            self.event_to_reconcile.labels(key[0]).observe(e2r_s)
            self._event_latency.append(
                max(time.monotonic() - cause[1], 0.0))
        queue_s = 0.0
        if enqueued_at is not None:
            # a retry's queue wait belongs to its live retry chain: exemplar
            # the observation with that trace so a fat queue-duration bucket
            # links straight to the backoff timeline that caused it
            queue_s = max(self.clock.now() - enqueued_at, 0.0)
            self.queue_duration.labels(key[0]).observe(
                queue_s,
                exemplar={"trace_id": tid} if tid else None)
        if self.metering is not None and \
                (cause is not None or enqueued_at is not None):
            try:
                # same clock-domain values the histograms above observed,
                # attributed to the owning tenant
                self.metering.observe_dispatch(tenant, queue_s, e2r_s)
            except Exception:  # noqa: BLE001 — observability must never
                # take the dispatch path down with it
                logger.exception("metering rejected a dispatch")
        return key

    def _done(self, key: tuple[str, Request]) -> None:
        """Finish processing `key`: release the per-key slot and re-queue
        it when events parked on it while it ran."""
        invariants.yield_point("queue.done", (key[0], key[1].namespace,
                                              key[1].name))
        with self._lock:
            self._processing.discard(key)
            self._inflight_started.pop(key, None)
            if key in self._queued:
                queue = self._queues.get(key[0])
                if queue is not None:
                    queue.append(key)
                else:
                    self._queued.discard(key)

    def _promote_delayed(self) -> None:
        now = self.clock.now()
        with self._lock:
            due = [d for d in self._delayed if d.due <= now]
            self._delayed = [d for d in self._delayed if d.due > now]
        for d in due:
            self._enqueue(d.reg_name, d.request,
                          enqueued_at=d.enqueued_at or None)

    def _ensure_sources(self) -> None:
        """Lazily reconnect dropped watch sessions (the cache FIRST, so a
        reconcile popped right after never reads state older than the event
        stream that will re-trigger it)."""
        if self.cache is not None:
            self.cache.ensure_connected()
        if self._watch_session is not None and \
                not self._watch_session.connected:
            self._watch_session.reconnect()

    def _process_one(self) -> bool:
        self._ensure_sources()
        self._promote_delayed()
        item = self._pop()
        if item is None:
            return False
        try:
            self._process_item(item)
        finally:
            self._done(item)
        return True

    def _process_item(self, item: tuple[str, Request]) -> None:
        """Reconcile one popped request (the caller owns _pop/_done)."""
        reg_name, req = item
        reg = next((r for r in self._registrations if r.name == reg_name),
                   None)
        if reg is None:
            return  # unregistered while queued: drop the item
        if self._key_filter is not None and \
                not self._key_filter(req.namespace, req.name):
            # ownership moved while the key sat queued (shard handoff):
            # the new owner adopts it; dispatching here would be a
            # double-reconcile in the new epoch
            return

        def alive() -> bool:
            # unregister() may run DURING the reconcile; its queue/retry
            # cleanup must not be undone by this reconcile's bookkeeping —
            # identity check, so a same-name re-registration stays clean
            with self._lock:
                return any(r is reg for r in self._registrations)

        # attempt numbering + trace identity: every attempt of one retry
        # chain (error backoff / requeue=True) shares a trace id, so a
        # chaos-soak trace shows which injected fault hit which attempt
        with self._lock:
            attempt = self._attempt_seq.get(item, 0) + 1
            self._attempt_seq[item] = attempt
            cause_ts = self._attempt_cause.pop(item, None)
        start = self.clock.now()
        # monotonic wall-time stamps ride the root span into the flight
        # recorder: under a FakeClock every attempt collapses to the same
        # instant, so per-key serialization (attempt windows never
        # overlapping for one key) is only checkable against real time
        mono_start = time.monotonic()
        outcome = "error"
        root_span: Optional[tracing.Span] = None
        try:
            with _TRACER.start_span(
                "reconcile",
                attributes={
                    "controller": reg_name,
                    "namespace": req.namespace,
                    "name": req.name,
                    "attempt": attempt,
                },
                trace_id=self._trace_ids.get(item, ""),
            ) as span:
                root_span = span
                if cause_ts is not None:
                    span.set_attribute("cause_ts", cause_ts)
                if span.recording and item not in self._trace_ids:
                    self._trace_ids[item] = span.trace_id
                try:
                    result = reg.reconciler.reconcile(req) or Result()
                    if result.requeue_after > 0:
                        outcome = "requeue_after"
                    elif result.requeue:
                        outcome = "requeue"
                    else:
                        outcome = "success"
                    span.set_attribute("reconcile.result", outcome)
                    with self._lock:
                        self._retries.pop(item, None)
                    if not alive():
                        self._clear_request_trace(item)
                        return
                    if result.requeue_after > 0:
                        # explicit schedule: Forget (controller-runtime does
                        # on RequeueAfter) and wait out the caller's delay
                        self._limiter.forget(item)
                        self._clear_request_trace(item)
                        with self._lock:
                            self._delayed.append(
                                _Delayed(self.clock.now() + result.requeue_after,
                                         reg_name, req)
                            )
                    elif result.requeue:
                        # AddRateLimited without Forget: repeated
                        # requeue=True backs off like a failure would
                        self._requeue_rate_limited(item)
                    else:
                        self._limiter.forget(item)
                        self._clear_request_trace(item)
                except Exception as err:  # controller-runtime: requeue w/ backoff
                    outcome = "error"
                    span.set_attribute("error", True)
                    span.set_attribute("reconcile.result", "error")
                    span.add_event("reconcile.error", {
                        "exception.type": type(err).__name__,
                        "exception.message": str(err),
                    })
                    if not alive():
                        self._clear_request_trace(item)
                        return
                    with self._lock:
                        count = self._retries.get(item, 0) + 1
                        self._retries[item] = count
                    if count <= reg.max_retries:
                        delay = self._requeue_rate_limited(item)
                        logger.warning(
                            "reconcile %s %s failed (attempt %d, retry in "
                            "%.3fs): %s",
                            reg_name, req, count, delay, err,
                        )
                    else:
                        logger.error(
                            "reconcile %s %s dropped after %d attempts:\n%s",
                            reg_name, req, count, traceback.format_exc(),
                        )
                        with self._lock:
                            self._errors.append((reg_name, req, err))
                            # fresh budget for future events
                            self._retries.pop(item, None)
                        self._limiter.forget(item)
                        self._clear_request_trace(item)
        finally:
            duration = max(self.clock.now() - start, 0.0)
            # exemplar the duration histograms with this attempt's trace so
            # an OpenMetrics scrape can pivot from a latency bucket to the
            # recorded trace (/debug/traces/<trace_id>)
            ex = ({"trace_id": root_span.trace_id}
                  if root_span is not None and root_span.trace_id else None)
            self.reconcile_time.labels(reg_name).observe(duration,
                                                         exemplar=ex)
            self.work_duration.labels(reg_name).observe(duration,
                                                        exemplar=ex)
            self.reconcile_total.labels(reg_name, outcome).inc()
            if root_span is not None:
                # real-time execution window for the flight recorder's
                # per-key overlap check (set after export on purpose:
                # diagnostic bookkeeping, not trace payload)
                root_span.set_attribute("mono_start", mono_start)
                root_span.set_attribute("mono_end", time.monotonic())
                try:
                    rec = self.flight_recorder.record(root_span)
                    if rec is not None and self.slo_engine is not None:
                        # attempt stream -> SLO engine: errored/slow
                        # attempts become the exemplar trace an alert
                        # links back into this very recorder
                        self.slo_engine.observe_attempt(rec)
                    if rec is not None and self.lifecycle is not None:
                        # attempt stream -> lifecycle ledger: the stage
                        # partition behind /debug/criticalpath
                        self.lifecycle.observe_attempt(
                            rec, root_span, self.manager_id)
                    if rec is not None and self.metering is not None:
                        # attempt stream -> metering ledger: latches the
                        # per-tenant exemplar trace a fired fairness
                        # alert resolves at /debug/traces
                        self.metering.observe_attempt(rec)
                    if rec is not None and self.diagnosis is not None:
                        # attempt stream -> diagnosis engine: injected
                        # faults / promotions / recoveries become the
                        # discrete timeline change points correlate to
                        self.diagnosis.observe_attempt(rec)
                except Exception:  # noqa: BLE001 — observability must
                    # never take the reconcile loop down with it
                    logger.exception("flight recorder rejected a span")

    def _clear_request_trace(self, item: tuple[str, Request]) -> None:
        """The retry chain for this request is over (success, scheduled
        requeue_after, drop, or unregister): the next event starts a fresh
        trace with attempt 1."""
        with self._lock:
            self._trace_ids.pop(item, None)
            self._attempt_seq.pop(item, None)

    def _requeue_rate_limited(self, item: tuple[str, Request]) -> float:
        """Re-enqueue through the workqueue rate limiter: per-item
        exponential backoff with jitter, bounded overall by the token
        bucket.  Zero delay (bucket not empty, first failure with a tiny
        base) still round-trips the delayed queue so a hot-looping
        reconciler cannot starve the rest of the queue."""
        reg_name, req = item
        delay = max(self._limiter.when(item), 0.0)
        with self._lock:
            self._retry_totals[reg_name] = \
                self._retry_totals.get(reg_name, 0) + 1
            self._last_backoff[reg_name] = delay
            self._delayed.append(
                _Delayed(self.clock.now() + delay, reg_name, req, retry=True,
                         enqueued_at=self.clock.now()))
        return delay

    def _drain_step(self) -> int:
        """One drain step: process up to `workers` distinct-key requests —
        concurrently when workers > 1 — and return how many ran.  The
        per-batch barrier keeps clock advancement (run_until_idle/settle)
        single-threaded: no worker is mid-reconcile while the FakeClock
        jumps over a backoff window."""
        self._ensure_sources()
        self._promote_delayed()
        batch: list[tuple[str, Request]] = []
        while len(batch) < self.workers:
            item = self._pop()
            if item is None:
                break
            batch.append(item)
        if not batch:
            return 0
        if len(batch) == 1:
            item = batch[0]
            try:
                self._process_item(item)
            finally:
                self._done(item)
            return 1
        threads = [
            threading.Thread(target=self._run_item, args=(it,),
                             name=f"kube-worker-{i}", daemon=True)
            for i, it in enumerate(batch)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return len(batch)

    def _run_item(self, item: tuple[str, Request]) -> None:
        try:
            self._process_item(item)
        except Exception:  # noqa: BLE001 — same contract as the start()
            # loop: a bookkeeping bug must not strand the batch barrier
            logger.exception("worker failed outside the reconcile handler; "
                             "continuing")
        finally:
            self._done(item)

    def run_until_idle(self, max_iterations: int = 10_000,
                       advance_clock: bool = True) -> int:
        """Drain the workqueue; returns number of reconciles executed.

        Retry backoffs (error retries, rate-limited requeues) are part of
        draining: with `advance_clock=True` (default) and an injected
        FakeClock, the clock advances to each retry's due time so backoff
        stays real AND deterministic.  requeue_after schedules are NOT
        auto-advanced — use `advance(seconds)` to move the clock and
        re-drain those, or pass advance_clock=False to observe pending
        backoff state.  With `workers > 1` each step runs a batch of
        distinct-key requests concurrently (see _drain_step)."""
        n = 0
        adv = getattr(self.clock, "advance", None)
        while True:
            ran = self._drain_step()
            if ran:
                n += ran
                if n >= max_iterations:
                    raise RuntimeError(
                        "run_until_idle: reconcile loop did not settle")
                continue
            if not advance_clock or adv is None:
                break
            with self._lock:
                retry_due = [d.due for d in self._delayed if d.retry]
            if not retry_due:
                break
            delta = min(retry_due) - self.clock.now()
            if delta > 0:
                adv(delta)
            # loop: the next drain step promotes the now-due retries
        return n

    def advance(self, seconds: float) -> int:
        """Advance a FakeClock and drain newly-due delayed requeues."""
        adv = getattr(self.clock, "advance", None)
        if adv is None:
            raise TypeError("advance() requires a FakeClock")
        adv(seconds)
        return self.run_until_idle()

    def settle(self, max_seconds: float = 3600.0,
               max_iterations: int = 100_000) -> int:
        """Drain EVERYTHING a FakeClock can reach within `max_seconds` of
        fake time: retries (run_until_idle) plus requeue_after schedules
        falling due inside the budget.  The chaos soak uses this to reach
        steady state after a fault plan drains; tests asserting on timing
        should keep using run_until_idle/advance."""
        adv = getattr(self.clock, "advance", None)
        if adv is None:
            raise TypeError("settle() requires a FakeClock")
        deadline = self.clock.now() + max_seconds
        total = 0
        while True:
            total += self.run_until_idle(max_iterations=max_iterations)
            with self._lock:
                due = [d.due for d in self._delayed]
            if not due:
                break
            nxt = min(due)
            if nxt > deadline:
                break
            delta = nxt - self.clock.now()
            if delta > 0:
                adv(delta)
        return total

    def pending_delayed(self) -> list[tuple[str, Request, float]]:
        with self._lock:
            return [(d.reg_name, d.request, d.due) for d in self._delayed]

    def inflight_requests(self) -> list[tuple[str, Request]]:
        """The (controller, request) keys currently being reconciled —
        the shard drain gate (kube/shard.py) acks a handoff only once
        none of these belongs to a departed key."""
        with self._lock:
            return list(self._processing)

    def queue_stats(self) -> dict:
        """Workqueue observability snapshot (scraped into Prometheus gauges
        by core.metrics.NotebookMetrics): per-controller queue depth,
        pending backoff count, scheduled-retry totals, last backoff delay,
        and dropped-error counts."""
        with self._lock:
            depth: dict[str, int] = {
                name: len(q) for name, q in self._queues.items() if q}
            backoff_pending: dict[str, int] = {}
            for d in self._delayed:
                if d.retry:
                    backoff_pending[d.reg_name] = \
                        backoff_pending.get(d.reg_name, 0) + 1
            errors: dict[str, int] = {}
            for reg_name, _, _ in self._errors:
                errors[reg_name] = errors.get(reg_name, 0) + 1
            now = self.clock.now()
            longest: dict[str, float] = {}
            for (reg_name, _), started in self._inflight_started.items():
                age = max(now - started, 0.0)
                if age > longest.get(reg_name, -1.0):
                    longest[reg_name] = age
            return {
                "depth": depth,
                "backoff_pending": backoff_pending,
                "retries_total": dict(self._retry_totals),
                "last_backoff_s": dict(self._last_backoff),
                "errors_total": errors,
                "longest_running_s": longest,
                "controllers": [r.name for r in self._registrations],
            }

    def workqueue_debug(self) -> dict:
        """Per-item workqueue introspection for /debug/workqueue: the live
        queue (with enqueue timestamps), every delayed item with its due
        deadline and whether it is a retry backoff or a requeue_after
        schedule, and per-item retry counts — the view queue_stats()
        aggregates away."""
        def obj(req: Request) -> str:
            return f"{req.namespace}/{req.name}"

        with self._lock:
            now = self.clock.now()
            return {
                "now": now,
                "controllers": [r.name for r in self._registrations],
                "queued": [
                    {"controller": k[0], "object": obj(k[1]),
                     "queued_for_s": max(
                         now - self._enqueued_at.get(k, now), 0.0)}
                    for q in self._queues.values() for k in q
                ],
                "processing": [
                    {"controller": k[0], "object": obj(k[1]),
                     "running_for_s": max(now - started, 0.0)}
                    for k, started in sorted(self._inflight_started.items())
                ],
                "delayed": [
                    {"controller": d.reg_name, "object": obj(d.request),
                     "due_at": d.due, "due_in_s": max(d.due - now, 0.0),
                     "retry": d.retry}
                    for d in sorted(self._delayed)
                ],
                "retries": [
                    {"controller": k[0], "object": obj(k[1]), "count": v}
                    for k, v in sorted(self._retries.items(),
                                       key=lambda kv: -kv[1])
                ],
                "depth": sum(len(q) for q in self._queues.values()),
                "backoff_pending": sum(1 for d in self._delayed if d.retry),
            }

    @property
    def dropped_errors(self) -> list[tuple[str, Request, BaseException]]:
        with self._lock:
            return list(self._errors)

    def event_latency_samples(self) -> list[float]:
        """Wall-clock event->reconcile-start latencies (seconds) of up to
        the last 2^18 event-caused reconciles, oldest first — the loadtest
        computes exact p50/p99 from these."""
        with self._lock:
            return list(self._event_latency)

    # -- readiness ------------------------------------------------------------
    @property
    def started(self) -> bool:
        """True once start() launched the worker loop (readiness gate —
        liveness is `not stopped`, see main.py /healthz vs /readyz)."""
        return self._started

    def caches_synced(self) -> bool:
        """Whether the event sources backing the workqueue are live: the
        in-memory watch session is connected (it reconnects lazily after an
        injected drop), or — on a real-cluster backend — every informer
        finished its initial list (client-go WaitForCacheSync analog)."""
        if self._watch_session is not None:
            return self._watch_session.connected
        synced = getattr(self.api, "informers_synced", None)
        if callable(synced):
            return bool(synced())
        return True

    # -- standalone threaded mode ---------------------------------------------
    def start(self, poll_interval_s: float = 0.05) -> None:
        """Spawn `workers` worker threads, each popping from the shared
        workqueue.  Per-key serialization holds across workers (an
        in-flight key parks instead of double-dispatching), so raising
        WORKQUEUE_WORKERS scales throughput without relaxing the
        one-reconcile-per-object invariant."""
        def loop() -> None:
            while not self._stop.is_set():
                try:
                    busy = self._process_one()
                except Exception:  # noqa: BLE001 — the loop must survive
                    # anything escaping the per-reconcile handler (queue
                    # bookkeeping, clock, mapping bugs): a silently-dead
                    # manager thread turns into every controller stalling,
                    # indistinguishable from a hung cluster
                    logger.exception("manager loop error; continuing")
                    busy = False
                if not busy:
                    self._stop.wait(poll_interval_s)

        self._threads = [
            threading.Thread(target=loop, daemon=True,
                             name=f"kube-manager-{i}")
            for i in range(self.workers)
        ]
        for t in self._threads:
            t.start()
        self._started = True

    def stop(self) -> None:
        self._stop.set()
        # a reconciler may request shutdown from the worker thread itself
        # (e.g. the TLS-profile watcher); joining the current thread would
        # raise, and the loop exits on the event anyway
        me = threading.current_thread()
        for t in self._threads:
            if t is not me:
                t.join(timeout=5)
        self._threads = []

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    def wait_until_stopped(self, timeout: Optional[float] = None) -> bool:
        """Block until stop() is called (standalone main loop); True when
        the stop event fired."""
        return self._stop.wait(timeout)
