"""Indexed informer cache: shared read-optimized state for reconcilers.

The port's copy of kubeflow_tpu/kube/cache.py.

Controller-runtime reconcilers never list the apiserver on their hot path —
they read an informer-fed cache with registrable indexers (client-go
cache.Indexer; FieldIndexer in controller-runtime terms), so a reconcile of
one Notebook costs O(its objects), not O(all objects).  Until now every
reconcile here did live `api.list()` scans (`_pods_of`, the owned
StatefulSet lookup, whole-fleet Notebook sweeps), which is O(cluster) work
per event — the exact shape Podracer (arXiv:2104.06272) identifies as the
throughput ceiling: workers must share a read-optimized store instead of
re-materializing state per task.

`InformerCache` subscribes to the same watch stream the Manager consumes
(kube/store.py fan-out in-memory; the reflector informers of
kube/client.py on a real cluster) and maintains:

  - per-kind object maps, primed lazily with a consistent
    `list_with_rv` snapshot and kept fresh by watch events (stale replays
    are dropped by resourceVersion comparison; deletions observed during a
    prime are tombstoned so the snapshot cannot resurrect them);
  - registrable indexers: `add_namespace_index`, `add_owner_uid_index`
    (controller ownerReference uid), and `add_label_index(kind, *keys)`
    for exact-label-selector lookups (the TPU worker pods are selected by
    their StatefulSet label);
  - `cache_index_lookups_total{index,result}` hit/miss accounting, so a
    dashboard shows when a hot path silently degraded to a brute scan.

Resume semantics mirror the Manager's `_WatchSession`: an injected watch
drop (kube/faults.py `drop_watch`) disconnects the cache too, and
reconnect resumes from the newest resourceVersion seen — or, when the
history window was compacted away (410 Gone), relists every primed kind
against the live store.  Priming and relists are recovery machinery, not
client traffic, and run fault-exempt.

The cache subscribes FILTERED (store.py kinds= filter) and widens its own
kind set lazily — the first read, indexer, or aggregate over a kind adds
it to the subscription before priming, so a kind nobody caches costs the
dispatch path nothing.

Read contract (matches ApiServer): `get` returns a PRIVATE copy — mutate
and update() freely.  `list`/`select`/`by_index` return the cached frozen
objects themselves with no per-object copy — READ-ONLY; mutating one
without a fresh get() + update() is a bug.

Incremental aggregates (`add_aggregate`) maintain per-group sums updated
O(changed) on each watch event, so metric census scrapes never rescan the
object maps (let alone the apiserver).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ..utils import invariants
from .errors import GoneError
from .meta import KubeObject
from .store import EventType, WatchEvent, match_labels

IndexFn = Callable[[KubeObject], list]


def _rv_int(obj: KubeObject) -> int:
    rv = obj.metadata.resource_version
    if isinstance(rv, int):
        return rv
    try:
        return int(rv or 0)
    except (TypeError, ValueError):
        return 0


class InformerCache:
    """Watch-fed object cache with registrable indexers (see module doc)."""

    def __init__(self, api, registry=None, key_filter=None) -> None:
        self.api = api
        # sharded control plane (kube/shard.py): `key_filter(kind, ns,
        # name)` scopes what this cache stores — a replica's cache holds
        # only the keys its shard owns, so cache memory scales per-shard.
        # Events for keys that moved away EVICT the stale copy; resync()
        # realigns the map after ownership changes.
        self._key_filter = key_filter
        self._lock = invariants.tracked(
            threading.Lock(), "InformerCache._lock")
        # kind -> (namespace, name) -> KubeObject
        self._objects: dict[str, dict[tuple[str, str], KubeObject]] = {}
        self._primed: set[str] = set()
        # kinds mid-sync: deletions seen while the list snapshot is in
        # flight, so the merge cannot resurrect an object deleted after
        # the snapshot was taken
        self._tombstones: dict[str, set[tuple[str, str]]] = {}
        self._indexers: dict[str, dict[str, IndexFn]] = {}
        # (kind, index name) -> index key -> set of object keys
        self._indexes: dict[tuple[str, str], dict[str, set[tuple[str, str]]]] = {}
        self.lookups = None
        if registry is not None:
            self.lookups = registry.counter(
                "cache_index_lookups_total",
                "Indexed cache lookups by index and hit/miss outcome "
                "(miss = the read fell back to a brute-force scan)",
                labels=("index", "result"))
        # incremental aggregates: kind -> name -> fn(obj)->{group: value};
        # (kind, name) -> group -> running sum (updated alongside indexes)
        self._agg_fns: dict[str, dict[str, Callable[[KubeObject], dict]]] = {}
        self._aggs: dict[tuple[str, str], dict[str, float]] = {}
        # watch-resume state (in-memory backend only; the KubeClient's
        # reflector informers own their drop/relist recovery and never
        # disconnect this plain-callback watcher)
        self.connected = True
        self.drops = 0
        self.relists = 0
        self.last_rv = 0
        self._conn_lock = invariants.tracked(
            threading.Lock(), "InformerCache._conn_lock")
        # kinds this cache asked the store to stream (grown lazily; only
        # meaningful on the filtered in-memory backend)
        self._watched: set[str] = set()
        self._filtered = hasattr(api, "update_watch_kinds")
        if hasattr(api, "subscribe"):
            if self._filtered:
                api.subscribe(self, kinds=[])
            else:
                api.subscribe(self)
        else:
            api.watch(self)

    # -- watch feed -----------------------------------------------------------
    def __call__(self, ev: WatchEvent) -> None:
        rv = _rv_int(ev.obj)
        with self._lock:
            if rv > self.last_rv:
                self.last_rv = rv
            kind = ev.obj.kind
            key = (ev.obj.namespace, ev.obj.name)
            store = self._objects.setdefault(kind, {})
            old = store.get(key)
            if ev.type is EventType.DELETED:
                if kind in self._tombstones:
                    self._tombstones[kind].add(key)
                if old is not None:
                    if _rv_int(old) > rv:
                        # the stored object is a NEWER incarnation: a
                        # recreate raced ahead of this DELETED in the
                        # fan-out (a data-plane watcher recreating pods
                        # reacts inside the same notify pass) — evicting
                        # it would blind every indexed read until relist
                        return
                    del store[key]
                    self._deindex(kind, key, old)
            else:
                if self._key_filter is not None and \
                        not self._key_filter(kind, key[0], key[1]):
                    # not this shard's key: never store it, and evict any
                    # copy left from before ownership moved away
                    if old is not None:
                        del store[key]
                        self._deindex(kind, key, old)
                    return
                if old is not None and _rv_int(old) > rv:
                    return  # stale replay (resume overlap); keep the newer
                self._reindex(kind, key, old, ev.obj)
                store[key] = ev.obj

    def on_watch_dropped(self) -> None:
        self.drops += 1
        self.connected = False

    def ensure_connected(self) -> None:
        """Reconnect after an injected watch drop — resume from the last
        seen resourceVersion, or relist every primed kind on 410 Gone.
        The resume keeps the kind filter: per-kind history rings mean
        churn on kinds this cache never asked for cannot evict its
        window."""
        if self.connected:
            return
        with self._conn_lock:
            if self.connected:
                return
            kinds_filter = sorted(self._watched) if self._filtered else None
            try:
                self.api.subscribe(self, since_rv=self.last_rv,
                                   kinds=kinds_filter)
            except GoneError:
                self.api.subscribe(self, kinds=kinds_filter)
                self.relists += 1
                with self._lock:
                    kinds = sorted(self._primed)
                for kind in kinds:
                    self._sync_kind(kind, prune=True)
            self.connected = True

    def _ensure_watched(self, kind: str) -> None:
        """Add `kind` to the filtered subscription BEFORE any prime/index
        touches it, so no event can slip between snapshot and stream."""
        if not self._filtered:
            return
        with self._lock:
            if kind in self._watched:
                return
            self._watched.add(kind)
            kinds = sorted(self._watched)
        if self.connected:
            self.api.update_watch_kinds(self, kinds)

    # -- indexer registration -------------------------------------------------
    def add_indexer(self, kind: str, name: str, fn: IndexFn) -> None:
        """Register an index over `kind`; `fn(obj)` returns the index keys
        the object files under.  Idempotent by (kind, name): a second
        registration under the same name is a no-op, so setup functions may
        register shared indexes without coordinating.  Registration primes
        the kind (and adds it to the filtered subscription) so the index is
        complete and stays maintained."""
        self._ensure_primed(kind)
        with self._lock:
            per_kind = self._indexers.setdefault(kind, {})
            if name in per_kind:
                return
            per_kind[name] = fn
            idx: dict[str, set[tuple[str, str]]] = {}
            for key, obj in self._objects.get(kind, {}).items():
                for k in fn(obj):
                    idx.setdefault(k, set()).add(key)
            self._indexes[(kind, name)] = idx

    def add_aggregate(self, kind: str, name: str,
                      fn: Callable[[KubeObject], dict]) -> str:
        """Register an incremental aggregate over `kind`: `fn(obj)` returns
        {group_key: float} contributions, and the cache keeps per-group
        running sums updated on every watch event — O(changed) per event,
        O(groups) per read, never a rescan.  Idempotent by (kind, name).
        The metric census (core.metrics) reads its gauges off these."""
        self._ensure_primed(kind)
        with self._lock:
            per_kind = self._agg_fns.setdefault(kind, {})
            if name in per_kind:
                return name
            per_kind[name] = fn
            sums: dict[str, float] = {}
            for obj in self._objects.get(kind, {}).values():
                for k, v in fn(obj).items():
                    sums[k] = sums.get(k, 0.0) + v
            self._aggs[(kind, name)] = sums
        return name

    def aggregate(self, kind: str, name: str) -> dict[str, float]:
        """Current per-group sums of a registered aggregate.  Raises
        KeyError for an unregistered aggregate (same loud-failure contract
        as by_index)."""
        with self._lock:
            if name not in self._agg_fns.get(kind, {}):
                raise KeyError(f"no aggregate {name!r} registered for {kind}")
            return dict(self._aggs.get((kind, name), {}))

    def add_namespace_index(self, kind: str) -> str:
        self.add_indexer(kind, "namespace", lambda o: [o.namespace])
        return "namespace"

    def add_owner_uid_index(self, kind: str) -> str:
        def fn(obj: KubeObject) -> list:
            ref = obj.metadata.controller_owner()
            return [ref.uid] if ref is not None else []

        self.add_indexer(kind, "owner-uid", fn)
        return "owner-uid"

    def add_label_index(self, kind: str, *keys: str) -> str:
        """Exact-match label index over a fixed key set; `select()` with a
        selector over exactly these keys is served from it."""
        key_tuple = tuple(sorted(keys))
        name = "label:" + ",".join(key_tuple)

        def fn(obj: KubeObject) -> list:
            labels = obj.metadata.labels
            if not all(k in labels for k in key_tuple):
                return []
            return [",".join(f"{k}={labels[k]}" for k in key_tuple)]

        self.add_indexer(kind, name, fn)
        return name

    # -- reads (all deepcopied) -----------------------------------------------
    def get(self, kind: str, namespace: str, name: str) -> Optional[KubeObject]:
        self._ensure_primed(kind)
        with self._lock:
            obj = self._objects.get(kind, {}).get((namespace, name))
            return obj.deepcopy() if obj is not None else None

    # ApiServer-read-surface alias, so cache-or-api call sites stay uniform
    try_get = get

    def keys(self, kind: str,
             namespace: Optional[str] = None) -> list[tuple[str, str]]:
        """(namespace, name) keys of a kind — enqueue_all resyncs from this
        instead of materializing every object through the apiserver."""
        self._ensure_primed(kind)
        with self._lock:
            return sorted(k for k in self._objects.get(kind, {})
                          if namespace is None or k[0] == namespace)

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[dict[str, str]] = None
             ) -> list[KubeObject]:
        """Cache-backed list; namespace-scoped listings go through the
        namespace index when one is registered (hit), else scan the kind
        map (miss).  Returns the cached objects themselves — READ-ONLY
        frozen snapshots (see module doc); no per-object copy."""
        self._ensure_primed(kind)
        with self._lock:
            store = self._objects.get(kind, {})
            if namespace is None:
                objs = list(store.values())
            elif "namespace" in self._indexers.get(kind, {}):
                hits = self._indexes.get((kind, "namespace"), {}) \
                    .get(namespace, set())
                objs = [store[k] for k in hits if k in store]
                self._count("namespace", "hit")
            else:
                objs = [o for k, o in store.items() if k[0] == namespace]
                self._count("namespace", "miss")
            if label_selector:
                objs = [o for o in objs
                        if match_labels(o.metadata.labels, label_selector)]
            return sorted(objs, key=lambda o: (o.namespace, o.name))

    def select(self, kind: str, namespace: Optional[str],
               label_selector: Optional[dict[str, str]]) -> list[KubeObject]:
        """Label-selector lookup.  Served from the exact-key-set label
        index when one is registered for the selector's keys (hit), else a
        brute-force filtered scan (miss).  Read-only results, as list()."""
        if not label_selector:
            return self.list(kind, namespace)
        key_tuple = tuple(sorted(label_selector))
        name = "label:" + ",".join(key_tuple)
        self._ensure_primed(kind)
        with self._lock:
            store = self._objects.get(kind, {})
            if name in self._indexers.get(kind, {}):
                ikey = ",".join(f"{k}={label_selector[k]}" for k in key_tuple)
                hits = self._indexes.get((kind, name), {}).get(ikey, set())
                objs = [store[k] for k in hits
                        if k in store and (namespace is None
                                           or k[0] == namespace)]
                self._count(name, "hit")
            else:
                objs = [o for k, o in store.items()
                        if (namespace is None or k[0] == namespace)
                        and match_labels(o.metadata.labels, label_selector)]
                self._count(name, "miss")
            return sorted(objs, key=lambda o: (o.namespace, o.name))

    def by_index(self, kind: str, index: str, key: str) -> list[KubeObject]:
        """Objects filed under `key` in a registered index.  Raises
        KeyError for an unregistered index — a silent brute-scan fallback
        here would hide a missing setup-time registration forever.
        Read-only results, as list()."""
        self._ensure_primed(kind)
        with self._lock:
            if index not in self._indexers.get(kind, {}):
                raise KeyError(f"no index {index!r} registered for {kind}")
            store = self._objects.get(kind, {})
            hits = self._indexes.get((kind, index), {}).get(key, set())
            self._count(index, "hit")
            return sorted((store[k] for k in hits if k in store),
                          key=lambda o: (o.namespace, o.name))

    def resync(self, kind: str) -> list[tuple[str, str]]:
        """Realign the kind map with the live store under the CURRENT key
        filter — shard adoption (kube/shard.py) calls this after gaining
        keys, so objects whose events this cache skipped while another
        shard owned them appear, and keys that moved away drop.  Returns
        the keys the sweep newly admitted (they were not cached before),
        so the adoption path can enqueue exactly what moved instead of
        sweeping every key it holds."""
        self._ensure_primed(kind)
        return self._sync_kind(kind, prune=True)

    def stats(self) -> dict:
        with self._lock:
            return {
                "primed_kinds": sorted(self._primed),
                "watched_kinds": sorted(self._watched),
                "objects": {k: len(v) for k, v in self._objects.items()},
                "indexes": {f"{kind}/{name}": len(idx)
                            for (kind, name), idx in self._indexes.items()},
                "drops": self.drops,
                "relists": self.relists,
                "connected": self.connected,
            }

    # -- internals ------------------------------------------------------------
    def _count(self, index: str, result: str) -> None:
        if self.lookups is not None:
            self.lookups.labels(index, result).inc()

    def _reindex(self, kind: str, key: tuple[str, str],
                 old: Optional[KubeObject], new: KubeObject) -> None:
        for name, fn in self._indexers.get(kind, {}).items():
            idx = self._indexes.setdefault((kind, name), {})
            if old is not None:
                for k in fn(old):
                    bucket = idx.get(k)
                    if bucket is not None:
                        bucket.discard(key)
                        if not bucket:
                            del idx[k]
            for k in fn(new):
                idx.setdefault(k, set()).add(key)
        self._reaggregate(kind, old, new)

    def _deindex(self, kind: str, key: tuple[str, str],
                 old: KubeObject) -> None:
        for name, fn in self._indexers.get(kind, {}).items():
            idx = self._indexes.get((kind, name), {})
            for k in fn(old):
                bucket = idx.get(k)
                if bucket is not None:
                    bucket.discard(key)
                    if not bucket:
                        del idx[k]
        self._reaggregate(kind, old, None)

    def _reaggregate(self, kind: str,
                     old: Optional[KubeObject],
                     new: Optional[KubeObject]) -> None:
        """O(changed) aggregate maintenance: subtract the old object's
        contributions, add the new one's.  Contributions are exact small
        counts, so the +/- arithmetic stays float-exact."""
        for name, fn in self._agg_fns.get(kind, {}).items():
            sums = self._aggs.setdefault((kind, name), {})
            if old is not None:
                for k, v in fn(old).items():
                    left = sums.get(k, 0.0) - v
                    if abs(left) < 1e-9:
                        sums.pop(k, None)
                    else:
                        sums[k] = left
            if new is not None:
                for k, v in fn(new).items():
                    sums[k] = sums.get(k, 0.0) + v

    def _ensure_primed(self, kind: str) -> None:
        with self._lock:
            if kind in self._primed:
                return
        # widen the filtered subscription FIRST: events landing between
        # the filter change and the snapshot merge via the rv guards
        self._ensure_watched(kind)
        self._sync_kind(kind, prune=False)
        with self._lock:
            self._primed.add(kind)

    def _list_live(self, kind: str) -> tuple[list[KubeObject], int]:
        """Consistent snapshot from the backing store, fault-exempt (this
        is cache machinery, not client traffic under test)."""
        def do() -> tuple[list[KubeObject], int]:
            lister = getattr(self.api, "list_with_rv", None)
            if lister is not None:
                if self._key_filter is not None:
                    # predicate pushdown: a sharded cache lists only its
                    # owned keys instead of materializing the whole
                    # fleet and filtering here (O(owned), not O(fleet),
                    # per resync — the dominant cost of an adoption
                    # sweep at 100k keys).  Backends without the
                    # parameter (remote KubeClient) fall back to the
                    # full list.
                    kf = self._key_filter
                    try:
                        return lister(
                            kind,
                            predicate=lambda ns, name: kf(kind, ns, name))
                    except TypeError:
                        return lister(kind)
                return lister(kind)
            return self.api.list(kind), 0

        exempt = getattr(self.api, "fault_exempt", None)
        if exempt is not None:
            with exempt():
                return do()
        return do()

    def _sync_kind(self, kind: str, prune: bool) -> list[tuple[str, str]]:
        """Merge a live list snapshot into the kind map.  Watch events keep
        flowing while the list is in flight: newer stored versions win by
        resourceVersion, and deletions observed mid-sync are tombstoned so
        the snapshot cannot resurrect them.  `prune=True` (relist after
        410) additionally drops entries absent from the snapshot, unless
        they are provably newer than it.  Returns the keys the merge
        newly admitted."""
        with self._lock:
            self._tombstones.setdefault(kind, set())
        try:
            objs, snapshot_rv = self._list_live(kind)
        except Exception:
            with self._lock:
                self._tombstones.pop(kind, None)
            raise
        fresh = {(o.namespace, o.name): o for o in objs}
        if self._key_filter is not None:
            fresh = {k: o for k, o in fresh.items()
                     if self._key_filter(kind, k[0], k[1])}
        with self._lock:
            tombstones = self._tombstones.pop(kind, set())
            store = self._objects.setdefault(kind, {})
            if prune:
                for key in [k for k in store if k not in fresh]:
                    cur = store[key]
                    owned = self._key_filter is None or \
                        self._key_filter(kind, key[0], key[1])
                    if owned and snapshot_rv and _rv_int(cur) > snapshot_rv:
                        continue  # created after the snapshot; event is live
                    # a key that moved to another shard drops regardless of
                    # its resourceVersion: not owned is not stored
                    del store[key]
                    self._deindex(kind, key, cur)
            added: list[tuple[str, str]] = []
            for key, obj in fresh.items():
                if key in tombstones:
                    continue  # deleted while the snapshot was in flight
                cur = store.get(key)
                if cur is not None and _rv_int(cur) >= _rv_int(obj):
                    continue
                if cur is None:
                    added.append(key)
                self._reindex(kind, key, cur, obj)
                store[key] = obj
            return added


__all__ = ["InformerCache"]
