"""In-memory API server: the port's copy of kubeflow_tpu/kube/store.py.

It plays the role etcd + kube-apiserver play: optimistic concurrency on
resourceVersion, admission in the write path, finalizer-gated deletion,
owner-reference garbage collection and watch fan-out, in a deterministic,
dependency-free form for pytest and for running the controllers
standalone.  The reference's internals are kept: per-kind shards with
their own lock, object map and bounded watch-history ring; filtered watch
dispatch; copy-on-write reads (`list` and watch events hand out frozen
shared snapshots, `get` a private copy); the apply fast path (an unchanged
manifest re-applied by the same field manager costs one dict lookup).

The four patch verbs (merge, strategic merge, server-side apply, JSON
patch) retry server-side on conflict.  Every top-level client verb is
counted per (verb, kind) and per (verb, kind, namespace)
(`tenant_verb_counts`, the metering ledger's apiserver attribution),
top-level writes land in the audit log, and an installed fault plan
(kube/faults.py) gates verb entry; re-entry (GC, admission, watch
fan-out) and blocks that run under `fault_exempt` (the fake data plane,
informer relists) are neither counted nor faulted, as in the reference.
"""

from __future__ import annotations

import copy
import hashlib
import json
import logging
import os
import threading
from contextlib import ExitStack, contextmanager
from dataclasses import dataclass
from enum import Enum
from typing import Callable, Iterable, Optional

from collections import deque

from ..utils import invariants
from .errors import (
    AlreadyExistsError,
    ConflictError,
    ForbiddenError,
    GoneError,
    InvalidError,
    NotFoundError,
)
from .meta import KubeObject, copy_tree, new_uid, now_iso

DEFAULT_WATCH_HISTORY_SIZE = 2048


def _default_history_size() -> int:
    try:
        return max(1, int(os.environ.get("WATCH_HISTORY_SIZE", "")
                          or DEFAULT_WATCH_HISTORY_SIZE))
    except ValueError:
        return DEFAULT_WATCH_HISTORY_SIZE


class EventType(Enum):
    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"


@dataclass
class WatchEvent:
    type: EventType
    obj: KubeObject
    # pre-update state on MODIFIED events (None on ADDED/DELETED) — the
    # watch cache keeps it so selector-filtered watches can detect an
    # object editing into/out of the selected set (the apiserver's cacher
    # does the same to synthesize ADDED/DELETED transitions)
    prev: Optional[KubeObject] = None


class AdmissionDenied(ForbiddenError):
    """Raised by a validating admission hook to reject a write."""


@dataclass
class AuditRecord:
    """One observed top-level client WRITE (create/update/patch/delete).

    The audit log is the ground truth chaos tests assert invariants
    against — e.g. that the self-healing engine only ever issues
    whole-slice pod deletions, never partial-slice ones.  `ok` is False
    when the verb raised (an injected fault or a genuine API error): the
    client still *attempted* the write, which is what atomicity claims
    are about.  Internal re-entry (GC cascades, admission, the
    FakeCluster data plane, `fault_exempt` harness calls) is NOT audited:
    the log captures controller traffic at the client↔apiserver boundary
    only.  `name` is the name as the client sent it (empty for a
    generateName create); `rv` is the cluster resourceVersion after the
    verb, an ordering key across the log."""

    verb: str
    kind: str
    namespace: str
    name: str
    ok: bool = True
    error: str = ""
    rv: int = 0


@dataclass
class AdmissionHook:
    """Registered admission webhook (mutating or validating).

    The reference registers these on the apiserver via
    WebhookInstallOptions (odh suite_test.go:121-124); handlers receive the
    old and new object and either mutate (mutating) or raise AdmissionDenied
    (validating).  `operations` is a subset of {"CREATE", "UPDATE", "DELETE"}.
    """

    kinds: tuple[str, ...]
    handler: Callable[[str, Optional[KubeObject], KubeObject], Optional[KubeObject]]
    operations: tuple[str, ...] = ("CREATE", "UPDATE")
    mutating: bool = True
    name: str = ""


def match_labels(labels: dict[str, str], selector: Optional[dict[str, str]]) -> bool:
    if not selector:
        return True
    return all(labels.get(k) == v for k, v in selector.items())


class _KindShard:
    """Per-kind store partition: object map + watch-history ring under one
    lock, so writes to different kinds never contend."""

    __slots__ = ("lock", "objects", "history", "floor")

    def __init__(self, history_size: int, kind: str = "") -> None:
        # rank = kind: under INVARIANTS_STRICT the LockTracker enforces
        # that multi-shard acquisition (subscribe replay) follows the
        # documented sorted-by-kind order
        self.lock = invariants.tracked(
            threading.RLock(), "ApiServer.shard.lock", rank=kind)
        self.objects: dict[tuple[str, str], KubeObject] = {}
        self.history: deque[WatchEvent] = deque(maxlen=history_size)
        # resourceVersions <= the floor have been evicted from this kind's
        # history: a resume from below it cannot prove nothing was missed
        # for this kind -> 410
        self.floor = 0


@dataclass
class _WatchEntry:
    """One registered watcher with its delivery filter.  `kinds=None`
    means every kind (legacy unfiltered broadcast); namespace=None means
    every namespace."""

    fn: Callable[[WatchEvent], None]
    kinds: Optional[frozenset]
    namespace: Optional[str]


class ApiServer:
    """Thread-safe in-memory object store with k8s write-path semantics."""

    def __init__(self, history_size: Optional[int] = None) -> None:
        self.history_size = history_size if history_size is not None \
            else _default_history_size()
        # INVARIANTS_STRICT=1: commit-time deep-freeze + lock-order
        # tracking (utils.invariants); read once — the strict suites set
        # the env var before constructing the ApiServer
        self._strict = invariants.strict_enabled()
        # kind -> shard (object map + history ring, per-kind lock)
        self._shards: dict[str, _KindShard] = {}
        self._shards_lock = invariants.tracked(
            threading.RLock(), "ApiServer._shards_lock")
        # rv/name counters (globally ordered; own lock so a shard-lock
        # holder can allocate without touching other shards)
        self._rv_lock = invariants.tracked(
            threading.Lock(), "ApiServer._rv_lock")
        self._rv_counter = 0
        self._name_counter = 0
        # watcher registry + per-kind dispatch index.  Lock ordering:
        # _shards_lock > shard.lock (sorted by kind) > _watch_lock; the
        # rv/audit locks are leaves and never acquire anything.
        self._watch_lock = invariants.tracked(
            threading.RLock(), "ApiServer._watch_lock")
        self._watch_entries: list[_WatchEntry] = []
        self._kind_index: dict[str, list[_WatchEntry]] = {}
        self._unfiltered: list[_WatchEntry] = []
        # (kind, "delivered"|"skipped") -> count: the fan-out audit.
        # skipped = registered watchers an unfiltered broadcast would have
        # called for the event but the per-kind index did not.
        self._dispatch_counts: dict[tuple[str, str], int] = {}
        self._mutating: list[AdmissionHook] = []
        self._validating: list[AdmissionHook] = []
        # fault injection (kube.faults): a plan gates top-level verb entry;
        # re-entrant internals and watch-driven components run at depth > 0
        # and are exempt (thread-local so threaded managers stay correct)
        self._fault_plan = None
        self._fault_ctx = threading.local()
        # bounded audit trail of top-level client writes (AuditRecord);
        # shares the depth gate with fault injection, so only controller
        # traffic is recorded — never the store's own re-entry
        self._audit_lock = invariants.tracked(
            threading.Lock(), "ApiServer._audit_lock")
        self._audit_log: deque[AuditRecord] = deque(maxlen=8192)
        # per-(verb, kind) counters over ALL top-level client verbs, reads
        # included (the audit log keeps write detail; these stay O(verbs x
        # kinds) so a load test can budget total API traffic cheaply)
        self._verb_counts: dict[tuple[str, str], int] = {}
        # per-(verb, kind, namespace) counters — the tenant-attribution
        # feed (utils/metering.py delta-reads these); cluster-scoped
        # calls land under namespace ""
        self._tenant_verb_counts: dict[tuple[str, str, str], int] = {}
        # apply fast path: (kind, ns, name) -> field_manager ->
        # (manifest digest, resulting rv); see apply()
        self._apply_lock = invariants.tracked(
            threading.Lock(), "ApiServer._apply_lock")
        self._applied_digests: dict[
            tuple[str, str, str], dict[str, tuple[str, int]]] = {}

    # -- shards ---------------------------------------------------------------
    def _shard(self, kind: str) -> _KindShard:
        with self._shards_lock:
            shard = self._shards.get(kind)
            if shard is None:
                shard = self._shards[kind] = _KindShard(
                    self.history_size, kind)
            return shard

    # -- fault injection ------------------------------------------------------
    def install_fault_plan(self, plan) -> None:
        """Install a kube.faults.FaultPlan on the API surface.  Replaces any
        existing plan; None (or clear_fault_plan) removes it."""
        self._fault_plan = plan

    def clear_fault_plan(self) -> None:
        self._fault_plan = None

    @property
    def fault_plan(self):
        return self._fault_plan

    @contextmanager
    def fault_exempt(self):
        """Run a block immune to the installed fault plan — for test-harness
        setup/assertion calls and cluster-internal components (the faults
        model client<->apiserver failures, not the store's own integrity)."""
        depth = getattr(self._fault_ctx, "depth", 0)
        self._fault_ctx.depth = depth + 1
        try:
            yield
        finally:
            self._fault_ctx.depth = depth

    @contextmanager
    def _fault_scope(self, verb: str, kind: str, namespace: str = "",
                     name: str = ""):
        """Top-level verb gate: consult the fault plan once per outermost
        call (nested ApiServer re-entry — GC, patch retry loops, admission,
        watch fan-out — runs at depth > 0 and is exempt).  Yields optional
        directives for the verb body (e.g. {"stale": True})."""
        depth = getattr(self._fault_ctx, "depth", 0)
        self._fault_ctx.depth = depth + 1
        audited = depth == 0 and verb in ("create", "update", "patch",
                                          "delete")
        if depth == 0:
            with self._audit_lock:
                key = (verb, kind)
                self._verb_counts[key] = self._verb_counts.get(key, 0) + 1
                tkey = (verb, kind, namespace)
                self._tenant_verb_counts[tkey] = \
                    self._tenant_verb_counts.get(tkey, 0) + 1
        try:
            directives = None
            if depth == 0 and self._fault_plan is not None:
                # plan actions (watch drops -> resubscribe -> relist) run
                # inside this scope, so they cannot recursively re-fault
                directives = self._fault_plan.intercept(
                    self, verb, kind, namespace, name)
            yield directives
        except BaseException as err:
            if audited:
                with self._audit_lock:
                    self._audit_log.append(AuditRecord(
                        verb, kind, namespace, name, ok=False,
                        error=str(err), rv=self._rv_counter))
            raise
        else:
            if audited:
                with self._audit_lock:
                    self._audit_log.append(AuditRecord(
                        verb, kind, namespace, name, ok=True,
                        rv=self._rv_counter))
        finally:
            self._fault_ctx.depth = depth

    # -- audit trail ----------------------------------------------------------
    def audit_log(self, verb: Optional[str] = None,
                  kind: Optional[str] = None,
                  ok: Optional[bool] = None) -> list[AuditRecord]:
        """The recorded top-level client writes, oldest first, optionally
        filtered.  Chaos tests read this to prove client-side invariants
        (e.g. slice-atomicity of recovery restarts)."""
        with self._audit_lock:
            return [
                r for r in self._audit_log
                if (verb is None or r.verb == verb)
                and (kind is None or r.kind == kind)
                and (ok is None or r.ok == ok)
            ]

    def clear_audit_log(self) -> None:
        with self._audit_lock:
            self._audit_log.clear()

    def verb_counts(self) -> dict[tuple[str, str], int]:
        """Cumulative (verb, kind) -> count over every top-level client
        call, reads included.  The loadtest convergence benchmark budgets
        API traffic against this; `fault_exempt` harness calls and internal
        re-entry are never counted."""
        with self._audit_lock:
            return dict(self._verb_counts)

    def clear_verb_counts(self) -> None:
        with self._audit_lock:
            self._verb_counts.clear()

    def tenant_verb_counts(self) -> dict[tuple[str, str, str], int]:
        """Cumulative (verb, kind, namespace) -> count — verb_counts()
        partitioned by the owning tenant (cluster-scoped calls under
        namespace "").  The metering ledger delta-reads this snapshot to
        attribute apiserver traffic per tenant."""
        with self._audit_lock:
            return dict(self._tenant_verb_counts)

    def clear_tenant_verb_counts(self) -> None:
        with self._audit_lock:
            self._tenant_verb_counts.clear()

    # -- watch / admission registration --------------------------------------
    @property
    def _watchers(self) -> list[Callable[[WatchEvent], None]]:
        """Registered callbacks (test-only introspection surface; the
        registry itself lives in filtered _WatchEntry records)."""
        with self._watch_lock:
            return [e.fn for e in self._watch_entries]

    @staticmethod
    def _kindset(kinds) -> Optional[frozenset]:
        if kinds is None:
            return None
        return frozenset(kinds)

    def _register_entry(self, entry: _WatchEntry) -> None:
        # caller holds _watch_lock
        self._watch_entries.append(entry)
        if entry.kinds is None:
            self._unfiltered.append(entry)
        else:
            for k in entry.kinds:
                self._kind_index.setdefault(k, []).append(entry)

    def _deregister_entry(self, entry: _WatchEntry) -> None:
        # caller holds _watch_lock
        self._watch_entries.remove(entry)
        if entry.kinds is None:
            self._unfiltered.remove(entry)
        else:
            for k in entry.kinds:
                bucket = self._kind_index.get(k)
                if bucket is not None:
                    if entry in bucket:
                        bucket.remove(entry)
                    if not bucket:
                        del self._kind_index[k]

    def watch(self, fn: Callable[[WatchEvent], None],
              kinds: Optional[Iterable[str]] = None,
              namespace: Optional[str] = None) -> None:
        """Register a live watcher.  `kinds` restricts delivery to those
        kinds (None = every kind); `namespace` restricts to one namespace.
        Watch callbacks receive SHARED frozen objects — they must never
        mutate the event or anything it references."""
        entry = _WatchEntry(fn, self._kindset(kinds), namespace or None)
        with self._watch_lock:
            self._register_entry(entry)

    def unwatch(self, fn: Callable[[WatchEvent], None]) -> None:
        with self._watch_lock:
            for entry in list(self._watch_entries):
                if entry.fn is fn:
                    self._deregister_entry(entry)

    def update_watch_kinds(self, fn: Callable[[WatchEvent], None],
                           kinds: Optional[Iterable[str]]) -> None:
        """Re-filter an already-registered watcher (forward-only: past
        events of newly added kinds are not replayed — new consumers prime
        with list_with_rv, which is exactly what the informer cache does)."""
        kindset = self._kindset(kinds)
        with self._watch_lock:
            for entry in self._watch_entries:
                if entry.fn is fn:
                    self._deregister_entry(entry)
                    entry.kinds = kindset
                    self._register_entry(entry)
                    return

    def subscribe(self, fn: Callable[[WatchEvent], None],
                  since_rv: Optional[int] = None,
                  kinds: Optional[Iterable[str]] = None,
                  namespace: Optional[str] = None) -> None:
        """Register a watcher, first replaying history newer than `since_rv`
        atomically (no events can be missed between replay and live stream).
        since_rv=None starts live-only; raises GoneError when since_rv
        predates the retained window of ANY kind the watcher asked for —
        per-kind rings mean Pod churn can never evict a Notebook-only
        subscriber's resume window."""
        kindset = self._kindset(kinds)
        if since_rv is None:
            self.watch(fn, kinds=kinds, namespace=namespace)
            return
        entry = _WatchEntry(fn, kindset, namespace or None)
        with self._shards_lock:
            relevant = sorted(
                k for k in self._shards
                if kindset is None or k in kindset)
            with ExitStack() as stack:
                shards = []
                for k in relevant:
                    shard = self._shards[k]
                    stack.enter_context(shard.lock)
                    shards.append(shard)
                # a resume below any relevant eviction floor cannot prove
                # nothing was missed (events <= floor left that kind's
                # window — sliding eviction or a reset_watch_history
                # compaction)
                floor = max((s.floor for s in shards), default=0)
                if since_rv < floor:
                    raise GoneError(
                        f"resourceVersion {since_rv} is too old "
                        f"(history starts at {floor + 1})"
                    )
                replay: list[WatchEvent] = []
                for shard in shards:
                    for ev in shard.history:
                        if ev.obj.metadata.resource_version <= since_rv:
                            continue
                        if entry.namespace is not None and \
                                ev.obj.namespace != entry.namespace:
                            continue
                        replay.append(ev)
                # rv order across kinds: per-kind rings are merged back
                # into the global commit order
                replay.sort(key=lambda ev: ev.obj.metadata.resource_version)
                with self._watch_lock:
                    # prev rides along: resumed selector-filtered watches
                    # need it to synthesize edit-in/edit-out transitions
                    # that happened while they were away
                    for ev in replay:
                        fn(ev)
                    self._register_entry(entry)

    def drop_watch_connections(self) -> int:
        """Disconnect every RESUMABLE watcher (one with an
        `on_watch_dropped` method) — the analog of the apiserver closing
        client watch streams.  Plain callback watchers (the FakeCluster
        data plane, test listeners) stay connected: a stream drop models
        the client side of the watch, and a consumer with no resume
        protocol would just silently go deaf.  Returns how many dropped."""
        with self._watch_lock:
            dropped = [e for e in self._watch_entries
                       if hasattr(e.fn, "on_watch_dropped")]
            for e in dropped:
                self._deregister_entry(e)
        for e in dropped:
            e.fn.on_watch_dropped()
        return len(dropped)

    def reset_watch_history(self) -> None:
        """Evict the whole watch-resume window of every kind (etcd
        compaction): any subsequent resume from a pre-reset resourceVersion
        gets 410 Gone and must relist.  Each shard's floor rises to the
        compaction point under that shard's lock, so a concurrent filtered
        subscribe either completes against the pre-compaction window or
        sees the raised floor and 410s — an evicted rv is never silently
        skipped in a replay."""
        with self._shards_lock:
            shards = list(self._shards.values())
        with self._rv_lock:
            rv = self._rv_counter
        for shard in shards:
            with shard.lock:
                shard.history.clear()
                shard.floor = max(shard.floor, rv)

    def watch_dispatch_counts(self) -> dict[tuple[str, str], int]:
        """Cumulative (kind, "delivered"|"skipped") dispatch audit.
        delivered = callbacks actually invoked for events of the kind;
        skipped = callbacks an unfiltered broadcast would have invoked but
        the per-kind index did not.  Exported by core.metrics as
        apiserver_watch_dispatch_total."""
        with self._watch_lock:
            return dict(self._dispatch_counts)

    def _stale_of(self, kind: str, namespace: str,
                  name: str) -> Optional[KubeObject]:
        """The most recent PREVIOUS version of an object still in the watch
        history — what a lagging apiserver cache would serve."""
        shard = self._shard(kind)
        with shard.lock:
            for ev in reversed(shard.history):
                o = ev.obj
                if (o.namespace, o.name) == (namespace, name) \
                        and ev.prev is not None:
                    return ev.prev.deepcopy()
        return None

    @property
    def resource_version(self) -> int:
        with self._rv_lock:
            return self._rv_counter

    def register_admission(self, hook: AdmissionHook) -> None:
        with self._watch_lock:
            (self._mutating if hook.mutating else self._validating).append(hook)

    def _notify(self, ev: WatchEvent) -> None:
        """Append to the kind's history ring and dispatch to interested
        watchers only.  Ring append + watcher snapshot are atomic with a
        subscribe()'s replay-then-register (both hold shard.lock then
        _watch_lock), so an event is delivered to a resuming watcher
        exactly once — via replay or live, never both.  The event carries
        ONE shared frozen object: no per-watcher deepcopy; callbacks must
        only read it, and may only enqueue or re-enter this ApiServer."""
        kind = ev.obj.kind
        # model-checker schedule point: a commit becoming visible is where
        # optimistic-concurrency races decide (testing/interleave.py)
        invariants.yield_point(
            "store.commit",
            (ev.type.value, kind, ev.obj.namespace, ev.obj.name))
        ev.obj.frozen = True
        if ev.prev is not None:
            ev.prev.frozen = True
        if self._strict:
            # mutation-trapping wrappers over the shared trees: any
            # escaped write raises at the mutation site (utils.invariants)
            invariants.deep_freeze(ev.obj)
            if ev.prev is not None:
                invariants.deep_freeze(ev.prev)
        shard = self._shard(kind)
        with shard.lock:
            hist = shard.history
            if hist.maxlen is not None and len(hist) == hist.maxlen and hist:
                # about to evict the oldest event: resumes at or below its
                # rv can no longer be proven complete for this kind
                shard.floor = max(
                    shard.floor,
                    hist[0].obj.metadata.resource_version)
            hist.append(ev)
            with self._watch_lock:
                entries = self._kind_index.get(kind, ())
                ns = ev.obj.namespace
                interested = [
                    e for e in entries
                    if e.namespace is None or e.namespace == ns]
                interested += [
                    e for e in self._unfiltered
                    if e.namespace is None or e.namespace == ns]
                d = self._dispatch_counts
                delivered = len(interested)
                d[(kind, "delivered")] = \
                    d.get((kind, "delivered"), 0) + delivered
                d[(kind, "skipped")] = \
                    d.get((kind, "skipped"), 0) + \
                    (len(self._watch_entries) - delivered)
        errors = 0
        for e in interested:
            try:
                e.fn(ev)
            except Exception:
                # watcher isolation: the committing writer and the watcher
                # are different actors — in the sharded control plane
                # (kube/shard.py) a peer replica's map-event callback runs
                # on OUR commit path, and coupling our write to its bug
                # would turn one bad watcher into a fleet-wide outage.
                # Strict mode re-raises: tests and the model checker want
                # escaped-mutation traps and invariant failures loud.
                if self._strict:
                    raise
                errors += 1
                logging.getLogger("kubeflow_tpu_torch.store").exception(
                    "watch callback failed for %s %s/%s",
                    kind, ev.obj.namespace, ev.obj.name)
        if errors:
            with shard.lock:
                with self._watch_lock:
                    d = self._dispatch_counts
                    d[(kind, "callback_errors")] = \
                        d.get((kind, "callback_errors"), 0) + errors

    def _next_rv(self) -> int:
        with self._rv_lock:
            self._rv_counter += 1
            return self._rv_counter

    # -- reads ----------------------------------------------------------------
    def get(self, kind: str, namespace: str, name: str) -> KubeObject:
        """Read one object.  Returns a PRIVATE copy — mutate it and
        update() it freely (the universal controller pattern)."""
        with self._fault_scope("get", kind, namespace, name) as faults:
            if faults and faults.get("stale"):
                stale = self._stale_of(kind, namespace, name)
                if stale is not None:
                    return stale
            shard = self._shard(kind)
            with shard.lock:
                obj = shard.objects.get((namespace, name))
                if obj is None:
                    raise NotFoundError(f"{kind} {namespace}/{name} not found")
                return obj.deepcopy()

    def try_get(self, kind: str, namespace: str, name: str) -> Optional[KubeObject]:
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[dict[str, str]] = None,
        predicate: Optional[Callable[[str, str], bool]] = None,
    ) -> list[KubeObject]:
        """List objects of a kind.  Returns the stored objects themselves
        (copy-on-write contract): they are frozen shared snapshots —
        READ-ONLY.  To mutate one, get() a private copy and update() it;
        mutating a listed object in place is a bug (it would corrupt every
        other reader's view and defeat the store's no-op detection).
        `predicate(namespace, name)` filters server-side BEFORE results
        materialize — a sharded informer's resync lists only its owned
        keys instead of the whole fleet (the apiserver analog is a
        field/label selector evaluated in the watch cache)."""
        with self._fault_scope("list", kind, namespace or ""):
            shard = self._shard(kind)
            with shard.lock:
                return self._list_locked(shard, namespace, label_selector,
                                         predicate)

    @staticmethod
    def _list_locked(shard: _KindShard, namespace: Optional[str],
                     label_selector: Optional[dict[str, str]],
                     predicate: Optional[Callable[[str, str], bool]] = None
                     ) -> list[KubeObject]:
        out = []
        for (ns, name), obj in shard.objects.items():
            if namespace is not None and ns != namespace:
                continue
            if predicate is not None and not predicate(ns, name):
                continue
            if label_selector and not match_labels(
                    obj.metadata.labels, label_selector):
                continue
            out.append(obj)
        out.sort(key=lambda o: (o.namespace, o.name))
        return out

    def list_with_rv(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[dict[str, str]] = None,
        predicate: Optional[Callable[[str, str], bool]] = None,
    ) -> tuple[list[KubeObject], int]:
        """List + the cluster resourceVersion as one atomic snapshot, so a
        list-then-watch client cannot miss events that land between the list
        and reading the rv (the apiserver returns both in one response).
        Same read-only and predicate contracts as list()."""
        with self._fault_scope("list", kind, namespace or ""):
            shard = self._shard(kind)
            with shard.lock:
                objs = self._list_locked(shard, namespace, label_selector,
                                         predicate)
                with self._rv_lock:
                    return objs, self._rv_counter

    # -- admission ------------------------------------------------------------
    def _admit(
        self, op: str, old: Optional[KubeObject], obj: KubeObject
    ) -> KubeObject:
        # hooks receive private copies (old may be the frozen stored
        # object; a hook must never be able to corrupt the store)
        old_copy: Optional[KubeObject] = None

        def old_for_hook() -> Optional[KubeObject]:
            nonlocal old_copy
            if old is not None and old_copy is None:
                old_copy = old.deepcopy()
            return old_copy

        for hook in self._mutating:
            if obj.kind in hook.kinds and op in hook.operations:
                mutated = hook.handler(op, old_for_hook(), obj.deepcopy())
                if mutated is not None:
                    obj = mutated
        for hook in self._validating:
            if obj.kind in hook.kinds and op in hook.operations:
                hook.handler(op, old_for_hook(), obj.deepcopy())  # raises AdmissionDenied
        return obj

    # -- writes ---------------------------------------------------------------
    def create(self, obj: KubeObject) -> KubeObject:
        with self._fault_scope("create", obj.kind, obj.metadata.namespace,
                               obj.metadata.name):
            return self._create(obj)

    def _create(self, obj: KubeObject) -> KubeObject:
        obj = obj.deepcopy()
        if not obj.metadata.name and obj.metadata.generate_name:
            with self._rv_lock:
                self._name_counter += 1
                seq = self._name_counter
            obj.metadata.name = f"{obj.metadata.generate_name}{seq:05x}"
        if not obj.metadata.name:
            raise InvalidError("metadata.name or generateName required")
        # admission OUTSIDE the store lock (as the apiserver runs webhook
        # callouts outside the etcd txn): a remote AdmissionReview handler may
        # re-enter this ApiServer from another thread.  Mutating hooks may
        # rewrite metadata, and the store must key the post-admission identity.
        obj = self._admit("CREATE", None, obj)
        shard = self._shard(obj.kind)
        key = (obj.metadata.namespace, obj.metadata.name)
        with shard.lock:
            if key in shard.objects:
                raise AlreadyExistsError(
                    f"{obj.kind} {key[0]}/{key[1]} already exists"
                )
            obj.metadata.uid = new_uid()
            obj.metadata.resource_version = self._next_rv()
            obj.metadata.generation = 1
            obj.metadata.creation_timestamp = now_iso()
            shard.objects[key] = obj  # canonical: frozen from here on
        self._notify(WatchEvent(EventType.ADDED, obj))
        # real k8s GC collects dependents whose owners are already gone (a
        # reconciler racing a cascade delete can create one — the GC's
        # attemptToDeleteItem handles exactly this); doing it synchronously
        # at create keeps the in-memory cluster deterministic
        self._collect_dangling_owners(obj)
        return obj.deepcopy()

    def _collect_dangling_owners(self, obj: KubeObject) -> None:
        """Strip ownerReferences whose owner no longer exists (by uid);
        delete the object outright when no live owner remains — the
        delete-racing-recreate fence that real GC provides.  Runs only at
        create, so a conflict must retry against fresh state here — a
        swallowed conflict would leave a dangling ref forever (and turn a
        later owner-deletion into a strip instead of a delete)."""
        if not obj.metadata.owner_references:
            return
        for _ in range(16):
            try:
                current = self.get(obj.kind, obj.namespace, obj.name)
            except NotFoundError:
                return  # someone else deleted it; done
            refs = current.metadata.owner_references
            live = []
            for r in refs:
                owner_shard = self._shard(r.kind)
                with owner_shard.lock:
                    owner = owner_shard.objects.get(
                        (current.namespace, r.name))
                if owner is not None \
                        and owner.metadata.uid == r.uid \
                        and owner.metadata.deletion_timestamp is None:
                    live.append(r)
            if len(live) == len(refs):
                return
            try:
                if live:
                    current.metadata.owner_references = live
                    self.update(current)
                else:
                    self.delete(current.kind, current.namespace, current.name)
                return
            except NotFoundError:
                return
            except ConflictError:
                continue  # concurrent writer; recompute from fresh state

    def update(self, obj: KubeObject, subresource: str = "") -> KubeObject:
        """Full-object update with optimistic concurrency.

        subresource="status" skips admission and generation bump, matching
        the /status subresource the reference writes via Status().Update()
        (notebook_controller.go:312).

        An EMPTY resourceVersion means "no precondition" (real-apiserver
        semantics): the write must replace unconditionally even under
        concurrency, so a commit-time conflict retries against fresh state
        — the analog of GuaranteedUpdate's internal retry."""
        with self._fault_scope("update", obj.kind, obj.metadata.namespace,
                               obj.metadata.name):
            return self._update(obj, subresource)

    def _update(self, obj: KubeObject, subresource: str = "") -> KubeObject:
        if not obj.metadata.resource_version:
            last: Exception | None = None
            for _ in range(16):
                try:
                    return self._update_once(obj.deepcopy(), subresource)
                except ConflictError as err:
                    last = err  # racer committed between read and CAS
            assert last is not None
            raise last
        return self._update_once(obj.deepcopy(), subresource)

    def _update_once(self, obj: KubeObject, subresource: str) -> KubeObject:
        key = (obj.metadata.namespace, obj.metadata.name)
        shard = self._shard(obj.kind)
        with shard.lock:
            old = shard.objects.get(key)
            if old is None:
                raise NotFoundError(f"{obj.kind} {key[0]}/{key[1]} not found")
        # `old` is the frozen canonical object — read-only from here on
        if not obj.metadata.resource_version:
            # real-apiserver semantics: an empty resourceVersion on update
            # means "no precondition" — the write replaces unconditionally
            # (clients that want optimistic concurrency send the RV they
            # read; all in-repo controllers do)
            obj.metadata.resource_version = old.metadata.resource_version
        if obj.metadata.resource_version != old.metadata.resource_version:
            raise ConflictError(
                f"{obj.kind} {key[0]}/{key[1]}: resourceVersion "
                f"{obj.metadata.resource_version} != {old.metadata.resource_version}"
            )
        if subresource == "status":
            merged = old.deepcopy()
            merged.body["status"] = copy_tree(obj.body.get("status", {}))
        else:
            merged = obj
            # status writes only through the status subresource
            # (copy_tree, not copy.deepcopy: the latter would preserve the
            # strict-mode FrozenDict wrappers of `old` into a private
            # object that must stay mutable)
            if "status" in old.body:
                merged.body["status"] = copy_tree(old.body["status"])
            elif "status" in merged.body:
                del merged.body["status"]
            # admission outside the lock (see create()); the commit below
            # re-checks the resourceVersion so a write that raced the
            # callout still conflicts, matching apiserver semantics
            merged = self._admit("UPDATE", old, merged)
            # name/namespace are immutable on update; keep keying sound
            merged.metadata.name = old.metadata.name
            merged.metadata.namespace = old.metadata.namespace
            if merged.body.get("spec") != old.body.get("spec"):
                merged.metadata.generation = old.metadata.generation + 1
            else:
                merged.metadata.generation = old.metadata.generation
        with shard.lock:
            current = shard.objects.get(key)
            if current is None:
                raise NotFoundError(f"{obj.kind} {key[0]}/{key[1]} not found")
            if current.metadata.resource_version != old.metadata.resource_version:
                raise ConflictError(
                    f"{obj.kind} {key[0]}/{key[1]}: object changed during "
                    "admission"
                )
            # immutable fields
            merged.metadata.uid = old.metadata.uid
            merged.metadata.creation_timestamp = old.metadata.creation_timestamp
            merged.metadata.deletion_timestamp = old.metadata.deletion_timestamp
            # no-op writes don't bump resourceVersion or wake watchers —
            # otherwise level-triggered loops (status sync) self-oscillate
            merged.metadata.resource_version = old.metadata.resource_version
            merged.frozen = False
            if merged.same_as(old):
                return old.deepcopy()
            merged.metadata.resource_version = self._next_rv()
            shard.objects[key] = merged  # canonical: frozen from here on
        self._notify(WatchEvent(EventType.MODIFIED, merged, prev=old))
        # finalizer removal on a deleting object may complete the delete
        if merged.metadata.deletion_timestamp and not merged.metadata.finalizers:
            self._finalize_delete(merged.kind, merged.namespace, merged.name)
            # the caller's view: the object as this update committed it
            return merged.deepcopy()
        return merged.deepcopy()

    def update_status(self, obj: KubeObject) -> KubeObject:
        return self.update(obj, subresource="status")

    def merge_patch(
        self, kind: str, namespace: str, name: str, patch: dict,
        view_out=None, view_in=None,
    ) -> KubeObject:
        """RFC 7386 merge patch; `None` values delete keys.  Used by the ODH
        controller's lock removal (merge-patch with null annotation value,
        odh notebook_controller.go:516-523).  Retries internally on conflict
        so callers never see one — the apiserver does the same for patch
        requests (it re-reads and re-applies server-side).

        view_out/view_in let the wire server apply the patch to a different
        API-version VIEW of the object (convert out, merge, convert back) —
        the apiserver's cross-version patch flow — without duplicating this
        retry loop: view_out(dict)->dict runs before the merge, view_in
        (KubeObject)->KubeObject after."""
        return self._patch_with_retry(
            kind, namespace, name, lambda base: _json_merge(base, patch),
            view_out, view_in)

    def strategic_merge_patch(
        self, kind: str, namespace: str, name: str, patch: dict,
        view_out=None, view_in=None,
    ) -> KubeObject:
        """Strategic merge patch: RFC 7386 shape plus patchMergeKey-keyed
        list merge and $patch/$deleteFromPrimitiveList directives
        (kube.strategicmerge).  Same server-side conflict retry and
        cross-version view hooks as merge_patch.  A malformed patch (list
        item missing its declared merge key) raises InvalidError — 422 on
        the wire, the apiserver's 'does not contain declared merge key'."""
        from .strategicmerge import strategic_merge

        def apply_smp(base: dict) -> dict:
            try:
                return strategic_merge(base, patch)
            except ValueError as err:
                raise InvalidError(str(err)) from None

        return self._patch_with_retry(
            kind, namespace, name, apply_smp, view_out, view_in)

    @staticmethod
    def _manifest_digest(applied: dict) -> str:
        """Content digest of an apply manifest (canonical JSON), keying the
        apply fast path."""
        return hashlib.sha256(
            json.dumps(applied, sort_keys=True,
                       separators=(",", ":"),
                       default=str).encode()).hexdigest()

    def apply(
        self, kind: str, namespace: str, name: str, applied: dict,
        field_manager: str, force: bool = False,
        view_out=None, view_in=None, return_created: bool = False,
    ) -> "KubeObject | tuple[KubeObject, bool]":
        """Server-side apply (kube/apply.py): upsert with managedFields
        ownership.  ApplyConflict surfaces as ConflictError (409 with the
        owning managers in the message); same conflict retry and
        cross-version view hooks as the other patch verbs.
        `return_created=True` returns (obj, created) so the wire layer can
        answer 201 for the create path without a racy pre-lookup.

        Fast path: when this field manager's previous apply of this object
        had the SAME manifest digest and the object still sits at the rv
        that apply produced, the whole merge machinery is skipped — the
        call is a proven no-op (a GitOps loop re-applying unchanged config
        on a timer costs one dict lookup per tick).  Any other writer
        bumping the object's rv invalidates the short-circuit."""
        with self._fault_scope("patch", kind, namespace, name):
            return self._apply(kind, namespace, name, applied, field_manager,
                               force, view_out, view_in, return_created)

    def _apply(
        self, kind: str, namespace: str, name: str, applied: dict,
        field_manager: str, force: bool = False,
        view_out=None, view_in=None, return_created: bool = False,
    ) -> "KubeObject | tuple[KubeObject, bool]":
        from .apply import (
            ApplyConflict,
            apply_update,
            field_set,
            sanitize_applied,
        )

        if not field_manager:
            raise InvalidError("fieldManager is required for apply")
        api_version = applied.get("apiVersion", "")
        applied = sanitize_applied(applied)
        # digest short-circuit (cross-version views excluded: the same
        # manifest can mean different stored state per view route)
        digest = ""
        obj_key = (kind, namespace, name)
        if view_out is None and view_in is None:
            digest = self._manifest_digest(applied)
            with self._apply_lock:
                prior = self._applied_digests.get(
                    obj_key, {}).get(field_manager)
            if prior is not None and prior[0] == digest:
                shard = self._shard(kind)
                with shard.lock:
                    cur = shard.objects.get((namespace, name))
                    if cur is not None and \
                            cur.metadata.resource_version == prior[1]:
                        out = cur.deepcopy()
                        return (out, False) if return_created else out
        last: Exception | None = None
        for _ in range(16):
            try:
                current = self.get(kind, namespace, name)
            except NotFoundError:
                # create path: the applied config becomes the object, with
                # this manager owning exactly what it applied
                obj = KubeObject.from_dict(copy.deepcopy(applied))
                obj.kind = kind
                obj.metadata.namespace = namespace
                obj.metadata.name = name
                obj.metadata.managed_fields = [{
                    "manager": field_manager,
                    "operation": "Apply",
                    "apiVersion": api_version or obj.api_version,
                    "fieldsType": "FieldsV1",
                    "fieldsV1": field_set(applied),
                    "time": now_iso(),
                }]
                if view_in is not None:
                    obj = view_in(obj)
                try:
                    created = self.create(obj)
                    self._record_apply(obj_key, field_manager, digest,
                                       created.metadata.resource_version)
                    return (created, True) if return_created else created
                except AlreadyExistsError as err:
                    last = err
                    continue  # raced another creator: re-apply onto it
            base = current.to_dict()
            if view_out is not None:
                base = view_out(base)
            try:
                merged_dict = apply_update(
                    base, applied, field_manager,
                    api_version or current.api_version,
                    force=force, now=now_iso())
            except ApplyConflict as err:
                raise ConflictError(str(err)) from None
            merged = KubeObject.from_dict(merged_dict)
            if view_in is not None:
                merged = view_in(merged)
            merged.metadata.resource_version = current.metadata.resource_version
            if merged.same_as(current):
                # semantic no-op apply (apply_update preserved the
                # managedFields timestamp for the unchanged field set):
                # skip the write path entirely — no admission callout, no
                # RV bump, no watch wakeup.
                self._record_apply(obj_key, field_manager, digest,
                                   current.metadata.resource_version)
                return (current, False) if return_created else current
            try:
                updated = self.update(merged)
                self._record_apply(obj_key, field_manager, digest,
                                   updated.metadata.resource_version)
                return (updated, False) if return_created else updated
            except ConflictError as err:
                last = err
            except NotFoundError as err:
                # a delete raced the read-modify-write: apply is an upsert,
                # so fall back to the create path on the next iteration
                last = err
        assert last is not None
        raise last

    def _record_apply(self, obj_key: tuple[str, str, str],
                      field_manager: str, digest: str, rv: int) -> None:
        if not digest:
            return
        with self._apply_lock:
            self._applied_digests.setdefault(
                obj_key, {})[field_manager] = (digest, rv)

    def json_patch(
        self, kind: str, namespace: str, name: str, ops: list,
        view_out=None, view_in=None,
    ) -> KubeObject:
        """RFC 6902 JSON Patch (application/json-patch+json) with the same
        server-side conflict retry and cross-version view hooks as
        merge_patch.  A failed `test` op raises InvalidError (the apiserver
        answers 422), and is NOT retried — the test expresses the caller's
        precondition, so retrying against fresh state would defeat it."""
        from .jsonpatch import PatchTestFailed, apply_patch

        def apply_ops(base: dict) -> dict:
            try:
                return apply_patch(base, ops)
            except PatchTestFailed as err:
                raise InvalidError(str(err)) from None
            except (KeyError, IndexError, TypeError, ValueError) as err:
                raise InvalidError(f"json patch failed: {err}") from None

        return self._patch_with_retry(
            kind, namespace, name, apply_ops, view_out, view_in)

    def _patch_with_retry(
        self, kind: str, namespace: str, name: str, apply_fn,
        view_out=None, view_in=None,
    ) -> KubeObject:
        """Shared patch protocol: read, apply `apply_fn` to the (possibly
        version-converted) dict view, write back pinned to the read RV, and
        retry the whole read-apply-write on conflict — the apiserver
        re-applies patches server-side the same way, so patch callers never
        see a ConflictError of their own making."""
        with self._fault_scope("patch", kind, namespace, name):
            return self._patch_with_retry_inner(
                kind, namespace, name, apply_fn, view_out, view_in)

    def _patch_with_retry_inner(
        self, kind: str, namespace: str, name: str, apply_fn,
        view_out=None, view_in=None,
    ) -> KubeObject:
        last: Exception | None = None
        for _ in range(16):
            current = self.get(kind, namespace, name)
            base = current.to_dict()
            if view_out is not None:
                base = view_out(base)
            patched = KubeObject.from_dict(apply_fn(base))
            if view_in is not None:
                patched = view_in(patched)
            patched.metadata.resource_version = current.metadata.resource_version
            try:
                return self.update(patched)
            except ConflictError as err:
                last = err
        assert last is not None
        raise last

    def delete(self, kind: str, namespace: str, name: str) -> None:
        with self._fault_scope("delete", kind, namespace, name):
            self._delete(kind, namespace, name)

    def _delete(self, kind: str, namespace: str, name: str) -> None:
        shard = self._shard(kind)
        key = (namespace, name)
        with shard.lock:
            obj = shard.objects.get(key)
            if obj is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            if obj.metadata.finalizers:
                if obj.metadata.deletion_timestamp is None:
                    # replace, never mutate: `obj` is frozen shared state
                    updated = obj.deepcopy()
                    updated.metadata.deletion_timestamp = now_iso()
                    updated.metadata.resource_version = self._next_rv()
                    shard.objects[key] = updated
                    prev = obj
                else:
                    return  # already terminating
            else:
                updated = None
        if updated is not None:
            self._notify(WatchEvent(EventType.MODIFIED, updated, prev=prev))
            return
        self._finalize_delete(kind, namespace, name)

    def _finalize_delete(self, kind: str, namespace: str, name: str) -> None:
        shard = self._shard(kind)
        with shard.lock:
            obj = shard.objects.pop((namespace, name), None)
            if obj is None:
                return
            # deletion bumps the cluster resourceVersion (as in etcd) so the
            # DELETED watch event is ordered in the history window; the
            # popped canonical object stays untouched for anyone holding it
            deleted = obj.deepcopy()
            deleted.metadata.resource_version = self._next_rv()
        with self._apply_lock:
            self._applied_digests.pop((kind, namespace, name), None)
        self._notify(WatchEvent(EventType.DELETED, deleted))
        self._garbage_collect(deleted)

    def _garbage_collect(self, owner: KubeObject) -> None:
        """Background-cascade GC, matching real k8s semantics: drop the
        now-dangling ownerReference; delete the dependent only once its last
        owner is gone (same namespace only, as in real k8s GC)."""
        to_delete: list[tuple[str, str, str]] = []
        to_strip: list[KubeObject] = []
        with self._shards_lock:
            shards = list(self._shards.items())
        for kind, shard in shards:
            with shard.lock:
                for (ns, name), obj in shard.objects.items():
                    if ns != owner.namespace:
                        continue
                    refs = obj.metadata.owner_references
                    if not any(r.uid == owner.metadata.uid for r in refs):
                        continue
                    remaining = [r for r in refs if r.uid != owner.metadata.uid]
                    if remaining:
                        stripped = obj.deepcopy()
                        stripped.metadata.owner_references = remaining
                        to_strip.append(stripped)
                    else:
                        to_delete.append((kind, ns, name))
        for obj in to_strip:
            try:
                self.update(obj)
            except (NotFoundError, ConflictError):
                pass
        for kind, ns, name in to_delete:
            try:
                self.delete(kind, ns, name)
            except NotFoundError:
                pass

    # -- test/ops helpers ------------------------------------------------------
    def force_remove_finalizers(self, kind: str, namespace: str, name: str) -> None:
        obj = self.get(kind, namespace, name)
        obj.metadata.finalizers = []
        self.update(obj)

    def dump(self) -> dict[str, list[dict]]:
        with self._shards_lock:
            shards = list(self._shards.items())
        out: dict[str, list[dict]] = {}
        for kind, shard in shards:
            with shard.lock:
                out[kind] = [o.to_dict() for o in shard.objects.values()]
        return out


def _json_merge(base: dict, patch: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _json_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


__all__ = ["AdmissionDenied", "AdmissionHook", "ApiServer", "AuditRecord",
           "EventType", "WatchEvent", "match_labels"]
