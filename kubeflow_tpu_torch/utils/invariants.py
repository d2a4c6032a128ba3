"""Runtime concurrency sanitizer: the port's copy of
kubeflow_tpu/utils/invariants.py, the dynamic half of the invariant gate.

`ci/analyzers` proves the COW / clock / lock contracts statically where a
conservative analysis can; this module catches the escapes at runtime when
`INVARIANTS_STRICT=1` (the threaded suites — test_workers, the chaos and
self-healing soaks at WORKQUEUE_WORKERS=8 — run with it on):

  - **Deep-freeze.**  When the ApiServer commits an object it already marks
    it `frozen` (kube/meta.py skeleton-key guard).  Under strict mode the
    store additionally rebuilds the shared body/labels/annotations trees
    out of mutation-trapping `FrozenDict`/`FrozenList` wrappers, so ANY
    in-place write to a committed snapshot — the mutate-after-list bug
    class — raises `FrozenMutationError`
    AT THE MUTATION SITE, stamped with the active trace id, instead of
    silently corrupting every other reader's view.

  - **LockTracker.**  `tracked()` wraps the store/cluster/cache/manager
    locks; the tracker records each thread's acquisition stack, learns the
    global acquisition-order graph as the suite runs, and raises
    `LockInversionError` the first time two locks are taken in both
    orders — a deadlock that a real scheduler interleaving would need luck
    to hit becomes a deterministic failure.  Same-name multi-instance
    locks (the per-kind shard locks) carry a `rank` and must be acquired
    in strictly increasing rank order (the store sorts by kind).

Both hooks cost nothing when strict mode is off: `tracked()` returns the
raw lock and the store skips the wrapper rebuild.

The same instrumentation points double as the *schedule surface* for the
model checker (`kubeflow_tpu/testing/interleave.py`): when a yield hook
is installed via `set_yield_hook()`, every TrackedLock acquire/release,
store commit and workqueue add/pop/done first calls the hook, which may
suspend the calling thread and hand the schedule to another one.  With no
hook installed (the default, including all of production) `yield_point()`
is a None-check and a return.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Optional


def strict_enabled() -> bool:
    """True when INVARIANTS_STRICT=1 (checked once per ApiServer/Manager
    construction, not per operation)."""
    return os.environ.get("INVARIANTS_STRICT", "") == "1"


class InvariantViolation(Exception):
    """Base of every runtime invariant failure."""


class FrozenMutationError(InvariantViolation):
    """In-place write to a committed (frozen, shared) store snapshot."""


class LockInversionError(InvariantViolation):
    """Two locks observed acquired in both orders (deadlock potential)."""


def _active_trace_id() -> str:
    # lazy import: utils.tracing must stay importable without this module
    from . import tracing

    try:
        span = tracing.current_span()
    except Exception:
        return ""
    return getattr(span, "trace_id", "") or ""


def _mutation_error(op: str) -> FrozenMutationError:
    trace = _active_trace_id()
    where = f" (active trace {trace})" if trace else ""
    return FrozenMutationError(
        f"in-place {op} on a frozen store snapshot{where}: objects from "
        "list()/select()/by_index()/watch events are shared read-only "
        "copy-on-write state — get() a private copy and update() it")


class FrozenDict(dict):
    """Dict that raises on every mutator.  Subclasses dict (not a Mapping
    proxy) so isinstance checks, json serialization, kube.meta.copy_tree
    and strategic-merge walks all keep working on the same object."""

    __slots__ = ()

    def _reject(self, op):
        raise _mutation_error(op)

    def __setitem__(self, k, v):
        self._reject(f"[{k!r}] assignment")

    def __delitem__(self, k):
        self._reject(f"del [{k!r}]")

    def setdefault(self, k, default=None):
        if k in self:
            return self[k]
        self._reject(f"setdefault({k!r})")

    def update(self, *a, **kw):
        self._reject("update()")

    def pop(self, *a):
        self._reject("pop()")

    def popitem(self):
        self._reject("popitem()")

    def clear(self):
        self._reject("clear()")

    def __ior__(self, other):
        self._reject("|= merge")

    def copy(self):
        return dict(self)  # a copy is private and mutable again


class FrozenList(list):
    """List twin of FrozenDict — same dict/list-subclass rationale."""

    __slots__ = ()

    def _reject(self, op):
        raise _mutation_error(op)

    def __setitem__(self, i, v):
        self._reject(f"[{i!r}] assignment")

    def __delitem__(self, i):
        self._reject(f"del [{i!r}]")

    def __iadd__(self, other):
        self._reject("+= extend")

    def __imul__(self, n):
        self._reject("*= repeat")

    def append(self, v):
        self._reject("append()")

    def extend(self, it):
        self._reject("extend()")

    def insert(self, i, v):
        self._reject("insert()")

    def pop(self, *a):
        self._reject("pop()")

    def remove(self, v):
        self._reject("remove()")

    def clear(self):
        self._reject("clear()")

    def sort(self, **kw):
        self._reject("sort()")

    def reverse(self):
        self._reject("reverse()")

    def copy(self):
        return list(self)


#: what KubeObject.spec/.status return for a frozen object with no such
#: key under strict mode — a write to it must raise, not vanish
EMPTY_FROZEN_DICT = FrozenDict()


def freeze_tree(x):
    """Rebuild a JSON-shaped tree with mutation-trapping containers.
    Already-frozen subtrees are returned as-is (idempotent)."""
    if type(x) is FrozenDict or type(x) is FrozenList:
        return x
    if isinstance(x, dict):
        return FrozenDict((k, freeze_tree(v)) for k, v in x.items())
    if isinstance(x, list):
        return FrozenList(freeze_tree(v) for v in x)
    return x


def deep_freeze(obj) -> None:
    """Swap a KubeObject's shared mutable trees for trapping wrappers.
    Called by the store at commit time (after obj.frozen = True) under
    strict mode.  deepcopy()/get() still hand out plain mutable trees
    (kube.meta.copy_tree rebuilds builtin dicts/lists)."""
    obj.body = freeze_tree(obj.body)
    meta = obj.metadata
    meta.labels = freeze_tree(meta.labels)
    meta.annotations = freeze_tree(meta.annotations)


# -- schedule points ----------------------------------------------------------

#: Installed by the InterleavingExplorer for the duration of one explored
#: run; None in production and in every non-exploring test.  Signature:
#: hook(kind, detail, token) where `kind` is the yield-point class
#: ("lock.acquire", "lock.release", "store.commit", "queue.add",
#: "queue.pop", "queue.done", "test.point", "test.wait"), `detail` is a
#: small picklable payload naming the object (lock name, kind/ns/name
#: tuple, queue key) and `token` identifies the concrete lock instance
#: for ownership modelling (or a wait predicate for "test.wait").
_yield_hook: Optional[Callable[[str, object, object], None]] = None


def set_yield_hook(hook):
    """Install (or with None, remove) the schedule hook.  Returns the
    previous hook so explorers can nest/restore."""
    global _yield_hook
    prev = _yield_hook
    _yield_hook = hook
    return prev


def yield_point(kind: str, detail=None, token=None) -> None:
    """A point where the model checker may preempt this thread.  Callers
    pass unformatted payloads (tuples, not f-strings) so the production
    cost is one global read and a truth test."""
    hook = _yield_hook
    if hook is not None:
        hook(kind, detail, token)


# -- lock-order tracking ------------------------------------------------------

class LockTracker:
    """Global acquisition-order recorder shared by every TrackedLock.

    `_edges[a]` holds every lock name acquired while `a` was held.  A new
    acquisition of B with A held fails if B→A is already on record — the
    two orders together are a potential deadlock.  Re-entrant acquisition
    of the SAME instance is transparent (RLock semantics); acquisition of
    a same-name SIBLING instance (another kind's shard lock) must carry a
    strictly greater `rank` than the deepest held sibling, mirroring the
    store's sorted-by-kind multi-shard acquisition."""

    def __init__(self) -> None:
        self._graph_lock = threading.Lock()
        self._edges: dict[str, set[str]] = {}
        self._held = threading.local()

    def _stack(self) -> list:
        st = getattr(self._held, "stack", None)
        if st is None:
            st = self._held.stack = []
        return st

    def held_names(self) -> list[str]:
        return [name for (_, name, _) in self._stack()]

    def on_acquire(self, lock: "TrackedLock") -> None:
        stack = self._stack()
        for inner, _, _ in stack:
            if inner is lock:
                stack.append((lock, lock.name, lock.rank))  # re-entry
                return
        held_names = []
        for _, name, rank in stack:
            if name == lock.name:
                if lock.rank is None or rank is None or \
                        not lock.rank > rank:
                    raise LockInversionError(
                        f"same-class lock {lock.name!r} acquired out of "
                        f"rank order (held rank {rank!r}, acquiring "
                        f"{lock.rank!r}); multi-instance acquisition must "
                        "follow the canonical sort")
                continue
            if name not in held_names:
                held_names.append(name)
        with self._graph_lock:
            successors = self._edges.get(lock.name)
            if successors:
                for name in held_names:
                    if name in successors:
                        raise LockInversionError(
                            f"lock order inversion: acquiring {lock.name!r}"
                            f" while holding {name!r}, but the opposite "
                            f"order {lock.name!r} -> {name!r} was already "
                            f"observed (held: {self.held_names()})")
            for name in held_names:
                self._edges.setdefault(name, set()).add(lock.name)
        stack.append((lock, lock.name, lock.rank))

    def on_release(self, lock: "TrackedLock") -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] is lock:
                del stack[i]
                return

    def edges(self) -> dict[str, set[str]]:
        with self._graph_lock:
            return {k: set(v) for k, v in self._edges.items()}

    def reset(self) -> None:
        with self._graph_lock:
            self._edges.clear()


#: process-wide tracker; tests may instantiate their own for isolation
GLOBAL_TRACKER = LockTracker()


class TrackedLock:
    """Wrapper giving a threading.Lock/RLock acquisition-order tracking.
    Order violations raise BEFORE blocking on the lock, so the sanitizer
    reports the inversion instead of deadlocking the suite."""

    __slots__ = ("_lock", "name", "rank", "_tracker")

    def __init__(self, lock, name: str, rank=None,
                 tracker: Optional[LockTracker] = None) -> None:
        self._lock = lock
        self.name = name
        self.rank = rank
        self._tracker = tracker if tracker is not None else GLOBAL_TRACKER

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if _yield_hook is not None and blocking:
            # the hook must run BEFORE on_acquire/blocking so the explorer
            # can park this thread while the lock is modelled as held
            # elsewhere — a granted thread then never blocks for real
            _yield_hook("lock.acquire", self.name, self._lock)
        self._tracker.on_acquire(self)
        ok = self._lock.acquire(blocking, timeout)
        if not ok:
            self._tracker.on_release(self)
        return ok

    def release(self) -> None:
        if _yield_hook is not None:
            _yield_hook("lock.release", self.name, self._lock)
        self._lock.release()
        self._tracker.on_release(self)

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def tracked(lock, name: str, rank=None,
            tracker: Optional[LockTracker] = None):
    """Wrap `lock` for order tracking when strict mode is on; otherwise
    return it untouched (zero overhead on the production path)."""
    if not strict_enabled():
        return lock
    return TrackedLock(lock, name, rank=rank, tracker=tracker)
