"""In-memory API server: the port's copy of kubeflow_tpu/kube/store.py.

It plays the role etcd + kube-apiserver play: optimistic concurrency on
resourceVersion, admission in the write path, finalizer-gated deletion,
owner-reference garbage collection and watch fan-out, in a deterministic,
dependency-free form for pytest and for running the controllers
standalone.  The reference's internals are kept: per-kind shards with
their own lock, object map and bounded watch-history ring; filtered watch
dispatch; copy-on-write reads (`list` and watch events hand out frozen
shared snapshots, `get` a private copy).

Left out until `ROADMAP.md` queue 1 item 17 ports `kube/{faults,apply,
strategicmerge,jsonpatch}.py`: fault plans with their exemption scope,
the audit trail and the per-verb call counts, watch-stream drops, and the
patch verbs (merge, strategic-merge, JSON patch, server-side apply),
which raise `NotImplementedError`.
"""

from __future__ import annotations

import logging
import os
import threading
from contextlib import ExitStack
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

_PATCH_VERB_MISSING = ("%s is not ported: ROADMAP.md queue 1 item 17 "
                       "(the patch verbs and kube/{apply,strategicmerge,"
                       "jsonpatch}.py)")


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
        # rv lock is a leaf and never acquires anything.
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

    # -- shards ---------------------------------------------------------------
    def _shard(self, kind: str) -> _KindShard:
        with self._shards_lock:
            shard = self._shards.get(kind)
            if shard is None:
                shard = self._shards[kind] = _KindShard(
                    self.history_size, kind)
            return shard

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

    def watch_dispatch_counts(self) -> dict[tuple[str, str], int]:
        """Cumulative (kind, "delivered"|"skipped") dispatch audit.
        delivered = callbacks actually invoked for events of the kind;
        skipped = callbacks an unfiltered broadcast would have invoked but
        the per-kind index did not.  Exported by core.metrics as
        apiserver_watch_dispatch_total."""
        with self._watch_lock:
            return dict(self._dispatch_counts)

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
                logging.getLogger("kubeflow_tpu.store").exception(
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

    def merge_patch(self, kind: str, namespace: str, name: str,
                    patch: dict, view_out=None, view_in=None):
        raise NotImplementedError(_PATCH_VERB_MISSING % "merge patch")

    def strategic_merge_patch(self, kind: str, namespace: str, name: str,
                              patch: dict, view_out=None, view_in=None):
        raise NotImplementedError(_PATCH_VERB_MISSING % "strategic merge patch")

    def apply(self, kind: str, namespace: str, name: str, applied: dict,
              field_manager: str, force: bool = False, view_out=None,
              view_in=None, return_created: bool = False):
        raise NotImplementedError(_PATCH_VERB_MISSING % "server-side apply")

    def json_patch(self, kind: str, namespace: str, name: str, ops: list,
                   view_out=None, view_in=None):
        raise NotImplementedError(_PATCH_VERB_MISSING % "JSON patch")

    def delete(self, kind: str, namespace: str, name: str) -> None:
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


__all__ = ["AdmissionDenied", "AdmissionHook", "ApiServer", "EventType",
           "WatchEvent", "match_labels"]
