"""Schedule-exploring concurrency model checker (CHESS-style): the port's
copy of kubeflow_tpu/testing/interleave.py.

The runtime sanitizer (utils/invariants.py, armed by INVARIANTS_STRICT=1)
gives every control-plane synchronization action a deterministic
observation point: TrackedLock acquire/release, the store commit in
ApiServer._notify, the workqueue add/pop/done in Manager.  This
module takes those same points over as *preemption* points: N logical
threads run under a cooperative scheduler that keeps exactly one runnable
at a time, and at every yield point decides — systematically, not by OS
luck — which thread runs next.

    explorer = InterleavingExplorer(scenario)
    result = explorer.explore()

`scenario` is a zero-arg factory returning `(threads, check)`: `threads`
is a list of zero-arg callables (or `(name, callable)` pairs) sharing
freshly-built state, `check` is called after every thread finishes and
raises (AssertionError) on an invariant violation.  The factory runs once
per explored schedule — stateless model checking: every schedule replays
the protocol from scratch, so a recorded schedule replays byte-identically
(`replay()` + `render()`).

Enumeration is DFS over the schedule tree with:

  - **iterative preemption bounding** (CHESS): bound 0 first — the
    schedules reachable by only switching when the running thread blocks
    or exits — then bound 1, 2, … up to `max_preemptions`.  Almost every
    real concurrency bug needs very few preemptions, so low bounds find
    them orders of magnitude sooner than unrestricted DFS.
  - **sleep-set pruning** (partial-order reduction): after fully exploring
    thread `a` at a node, sibling subtrees that would start with a step
    *independent* of `a`'s (different lock, different store object) are
    not re-explored — those schedules commute into already-visited ones.
    Independence is deliberately coarse (conservative = less pruning).

A failing schedule is shrunk to its minimal set of *preemption
directives* — the steps where the schedule deviates from the default
run-until-blocked order — by greedy delta-debugging re-execution, and the
shrunk run is rendered as a step-by-step narrative naming the (thread,
yield-point, object) at every step, switches flagged.

The explorer never blocks a granted thread on a modelled lock: a thread
whose pending acquire targets a lock owned by a *suspended* thread is
simply not schedulable until the owner releases.  All-parked with nothing
schedulable is reported as a deadlock schedule, not a hang.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..utils import invariants

# logical thread states
_NEW, _WAITING, _RUNNING, _DONE = "new", "waiting", "running", "done"


@dataclass(frozen=True)
class Op:
    """One pending action at a yield point."""

    kind: str            # lock.acquire | lock.release | store.commit | ...
    detail: str          # stable human-readable object name
    token: object = None  # lock instance (ownership) or wait predicate

    def render(self) -> str:
        return f"{self.kind:13s} {self.detail}" if self.detail \
            else f"{self.kind}"


@dataclass(frozen=True)
class TraceStep:
    step: int
    thread: str
    op: Op
    switched_from: str   # "" when the same thread keeps running
    preemption: bool     # switch while switched_from was still schedulable


@dataclass
class RunResult:
    """One executed schedule."""

    choices: tuple        # thread index chosen at each step
    trace: tuple          # TraceStep per step
    nodes: list           # [(enabled tuple, {tid: Op}, chosen)]
    error: Optional[BaseException]   # thread/check exception, or None
    deadlock: bool = False

    @property
    def failed(self) -> bool:
        return self.error is not None or self.deadlock


@dataclass
class FailingSchedule:
    message: str
    choices: tuple
    directives: dict      # step -> thread index (deviations from default)
    preemptions: int
    trace: tuple
    narrative: str


@dataclass
class ExploreResult:
    schedules: int        # DISTINCT schedules executed
    runs: int             # total executions (bounds re-visit low bounds)
    stopped: str          # exhausted | max_schedules | budget | failure
    bound_reached: int
    failure: Optional[FailingSchedule] = None

    @property
    def ok(self) -> bool:
        return self.failure is None


def checkpoint(label: str) -> None:
    """Test-authored yield point: lets scenario code mark a schedule
    point the production code doesn't have."""
    invariants.yield_point("test.point", label)


def await_cond(label: str, pred: Callable[[], bool]) -> None:
    """Test-authored blocking point: the calling logical thread is not
    schedulable until `pred()` is true (evaluated by the scheduler)."""
    invariants.yield_point("test.wait", label, pred)


def _fmt(detail) -> str:
    if detail is None:
        return ""
    if isinstance(detail, str):
        return detail
    if isinstance(detail, tuple):
        return "/".join("" if d is None else str(d) for d in detail)
    return str(detail)


def _independent(a: Op, b: Op) -> bool:
    """May the two pending ops commute?  Conservative: only provably
    disjoint lock/store actions are independent; everything else is
    treated as conflicting (costs exploration, never soundness)."""
    if a.kind == "thread.start" or b.kind == "thread.start":
        return True
    lock_kinds = ("lock.acquire", "lock.release")
    if a.kind in lock_kinds and b.kind in lock_kinds:
        return a.token is not b.token
    if a.kind == "store.commit" and b.kind == "store.commit":
        # detail = "type/kind/ns/name"; different kinds live on
        # different shards and commute
        return a.detail.split("/")[1:2] != b.detail.split("/")[1:2]
    return False


class _StopRun(BaseException):
    """Raised inside a parked logical thread when a run is abandoned."""


class _LThread:
    __slots__ = ("idx", "name", "fn", "thread", "state", "pending", "error")

    def __init__(self, idx: int, name: str, fn) -> None:
        self.idx = idx
        self.name = name
        self.fn = fn
        self.thread: Optional[threading.Thread] = None
        self.state = _NEW
        self.pending: Optional[Op] = None
        self.error: Optional[BaseException] = None


class _DfsPlan:
    """Forced choice prefix; divergence (forced thread not enabled) is a
    determinism bug and raises."""

    def __init__(self, prefix) -> None:
        self.prefix = list(prefix)

    def choose(self, step, enabled, default):
        if step < len(self.prefix):
            want = self.prefix[step]
            if want not in enabled:
                raise ReplayDivergence(
                    f"step {step}: recorded choice T{want} not enabled "
                    f"(enabled: {sorted(enabled)}) — scenario is "
                    "nondeterministic")
            return want
        return default


class _DirectivePlan:
    """Sparse step->thread overrides; inapplicable directives fall back
    to the default (used while shrinking, where dropping one directive
    shifts everything after it)."""

    def __init__(self, directives) -> None:
        self.directives = dict(directives)

    def choose(self, step, enabled, default):
        want = self.directives.get(step)
        return want if want in enabled else default


class ReplayDivergence(AssertionError):
    pass


class _PathEntry:
    __slots__ = ("enabled", "ops", "chosen", "done", "sleep", "preempts")

    def __init__(self, enabled, ops, chosen, sleep, preempts) -> None:
        self.enabled = enabled        # tuple of enabled thread idxs
        self.ops = ops                # {tid: Op}
        self.chosen = chosen
        self.done = {chosen}          # choices already (being) explored
        self.sleep = sleep            # frozenset of pruned thread idxs
        self.preempts = preempts      # preemptions up to AND INCL this step


class InterleavingExplorer:
    """Bounded-exhaustive scheduler for one scenario.  See module doc."""

    #: scheduler-side wedge guard — only trips if a granted thread blocks
    #: outside the modelled world (a real bug in the harness assumptions)
    WEDGE_TIMEOUT_S = 60.0

    def __init__(self, scenario, *, max_preemptions: int = 2,
                 max_schedules: int = 1200,
                 budget_s: float = 60.0) -> None:
        self.scenario = scenario
        self.max_preemptions = max_preemptions
        self.max_schedules = max_schedules
        self.budget_s = budget_s
        # per-run scheduler state
        self._cv = threading.Condition()
        self._lts: list[_LThread] = []
        self._by_ident: dict[int, _LThread] = {}
        self._active: Optional[_LThread] = None
        self._freerun = False

    # -- public ---------------------------------------------------------------

    def explore(self) -> ExploreResult:
        deadline = time.monotonic() + self.budget_s
        seen: set = set()
        runs = 0
        stopped = "exhausted"
        bound_reached = 0
        for bound in range(self.max_preemptions + 1):
            bound_reached = bound
            out = self._dfs(bound, deadline, seen)
            runs += out["runs"]
            if out["failure"] is not None:
                fail = self._shrink(out["failure"])
                return ExploreResult(len(seen), runs, "failure", bound,
                                     failure=fail)
            if out["stopped"] != "exhausted":
                stopped = out["stopped"]
                break
        return ExploreResult(len(seen), runs, stopped, bound_reached)

    def replay(self, choices) -> RunResult:
        """Re-execute a recorded schedule exactly; raises
        ReplayDivergence if the scenario no longer takes it."""
        return self._run(_DfsPlan(choices))

    @staticmethod
    def render(trace) -> str:
        """Stable text rendering of a trace — the byte-exactness unit."""
        lines = []
        for ts in trace:
            mark = ""
            if ts.switched_from:
                mark = (f"   << preempts {ts.switched_from}" if ts.preemption
                        else f"   << takes over from {ts.switched_from}")
            lines.append(f"step {ts.step:4d}  {ts.thread:8s} "
                         f"{ts.op.render()}{mark}")
        return "\n".join(lines)

    # -- one schedule ---------------------------------------------------------

    def _run(self, plan) -> RunResult:
        threads, check = self._build_scenario()
        self._lts = []
        self._by_ident = {}
        self._active = None
        self._freerun = False
        for i, entry in enumerate(threads):
            name, fn = entry if isinstance(entry, tuple) else (f"T{i}", entry)
            self._lts.append(_LThread(i, name, fn))

        prev_hook = invariants.set_yield_hook(self._on_yield)
        owners: dict[int, list] = {}   # id(lock) -> [lthread, depth]
        choices: list[int] = []
        trace: list[TraceStep] = []
        nodes: list = []
        error: Optional[BaseException] = None
        deadlock = False
        try:
            for lt in self._lts:
                lt.thread = threading.Thread(
                    target=self._thread_main, args=(lt,),
                    name=f"interleave-{lt.name}", daemon=True)
                lt.thread.start()
            prev_choice: Optional[int] = None
            step = 0
            while True:
                self._wait_quiescent()
                live = [lt for lt in self._lts if lt.state != _DONE]
                error = next((lt.error for lt in self._lts
                              if lt.error is not None), None)
                if error is not None or not live:
                    break
                enabled = {}
                for lt in live:
                    op = lt.pending
                    if op.kind == "lock.acquire":
                        own = owners.get(id(op.token))
                        if own is not None and own[0] is not lt:
                            continue
                    elif op.kind == "test.wait":
                        if not op.token():
                            continue
                    enabled[lt.idx] = op
                if not enabled:
                    deadlock = True
                    break
                default = prev_choice if prev_choice in enabled \
                    else min(enabled)
                chosen = plan.choose(step, enabled, default)
                op = enabled[chosen]
                if op.kind == "lock.acquire":
                    own = owners.setdefault(id(op.token), [None, 0])
                    own[0] = self._lts[chosen]
                    own[1] += 1
                elif op.kind == "lock.release":
                    own = owners.get(id(op.token))
                    if own is not None:
                        own[1] -= 1
                        if own[1] <= 0:
                            del owners[id(op.token)]
                switched = prev_choice is not None and prev_choice != chosen
                trace.append(TraceStep(
                    step=step, thread=self._lts[chosen].name, op=op,
                    switched_from=(self._lts[prev_choice].name
                                   if switched else ""),
                    preemption=switched and prev_choice in enabled))
                nodes.append((tuple(sorted(enabled)), dict(enabled), chosen))
                choices.append(chosen)
                self._grant(self._lts[chosen])
                prev_choice = chosen
                step += 1
        finally:
            self._abandon()
            invariants.set_yield_hook(prev_hook)
        if error is None and not deadlock:
            try:
                check()
            except BaseException as e:   # noqa: BLE001 — any check failure
                error = e
        return RunResult(tuple(choices), tuple(trace), nodes, error,
                         deadlock=deadlock)

    def _build_scenario(self):
        threads, check = self.scenario()
        if not threads:
            raise ValueError("scenario returned no threads")
        return threads, check

    # -- cooperative scheduling ----------------------------------------------

    def _thread_main(self, lt: _LThread) -> None:
        with self._cv:
            self._by_ident[threading.get_ident()] = lt
        try:
            self._park(lt, Op("thread.start", lt.name))
            lt.fn()
        except _StopRun:
            pass
        except BaseException as e:   # noqa: BLE001 — surfaced as failure
            if not self._freerun:
                lt.error = e
        finally:
            with self._cv:
                lt.state = _DONE
                if self._active is lt:
                    self._active = None
                self._cv.notify_all()

    def _on_yield(self, kind, detail, token) -> None:
        lt = self._by_ident.get(threading.get_ident())
        if lt is None:
            return   # main thread (setup/check) or a non-modelled thread
        self._park(lt, Op(kind, _fmt(detail), token))

    def _park(self, lt: _LThread, op: Op) -> None:
        with self._cv:
            if self._freerun:
                return
            lt.pending = op
            lt.state = _WAITING
            if self._active is lt:
                self._active = None
            self._cv.notify_all()
            while self._active is not lt:
                if self._freerun:
                    raise _StopRun
                self._cv.wait()
            lt.state = _RUNNING

    def _grant(self, lt: _LThread) -> None:
        with self._cv:
            self._active = lt
            self._cv.notify_all()

    def _wait_quiescent(self) -> None:
        deadline = time.monotonic() + self.WEDGE_TIMEOUT_S
        with self._cv:
            while True:
                if self._active is None and all(
                        t.state in (_WAITING, _DONE) for t in self._lts):
                    return
                if not self._cv.wait(timeout=1.0) and \
                        time.monotonic() > deadline:
                    self._freerun = True
                    self._cv.notify_all()
                    raise RuntimeError(
                        "interleave explorer wedged: a granted thread "
                        "blocked outside the modelled yield points")

    def _abandon(self) -> None:
        with self._cv:
            self._freerun = True
            self._cv.notify_all()
        for lt in self._lts:
            if lt.thread is not None:
                lt.thread.join(timeout=5.0)

    # -- DFS with sleep sets + preemption bound -------------------------------

    def _dfs(self, bound: int, deadline: float, seen: set) -> dict:
        path: list[_PathEntry] = []
        runs = 0
        first = True
        while True:
            if not first:
                # backtrack to the deepest entry with a viable sibling
                nxt = None
                while path:
                    e = path[-1]
                    base = path[-2].chosen if len(path) > 1 else None
                    before = path[-2].preempts if len(path) > 1 else 0
                    alts = []
                    for t in e.enabled:
                        if t in e.done or t in e.sleep:
                            continue
                        pre = before + (1 if (base in e.enabled and
                                              t != base) else 0)
                        if pre <= bound:
                            alts.append((t, pre))
                    if alts:
                        nxt = min(alts)
                        break
                    path.pop()
                if nxt is None:
                    return {"runs": runs, "failure": None,
                            "stopped": "exhausted"}
                e = path[-1]
                e.chosen, e.preempts = nxt
                e.done.add(nxt[0])
            first = False
            if time.monotonic() > deadline:
                return {"runs": runs, "failure": None, "stopped": "budget"}
            if len(seen) >= self.max_schedules:
                return {"runs": runs, "failure": None,
                        "stopped": "max_schedules"}
            run = self._run(_DfsPlan([e.chosen for e in path]))
            runs += 1
            seen.add(run.choices)
            if run.failed:
                return {"runs": runs, "failure": run, "stopped": "failure"}
            # extend the path with the default-continuation suffix
            for enabled, ops, chosen in run.nodes[len(path):]:
                if path:
                    parent = path[-1]
                    base = parent.chosen
                    before = parent.preempts
                    # a sibling explored (or slept) at the parent stays
                    # asleep here only while the executed step is
                    # independent of its pending one — a dependent step
                    # wakes it (its orderings are no longer covered)
                    ex_op = parent.ops[base]
                    slept = frozenset(
                        u for u in (parent.sleep | (parent.done - {base}))
                        if u in parent.ops and
                        _independent(parent.ops[u], ex_op))
                else:
                    base, before, slept = None, 0, frozenset()
                pre = before + (1 if (base in enabled and chosen != base)
                                else 0)
                path.append(_PathEntry(enabled, ops, chosen, slept, pre))

    # -- shrinking ------------------------------------------------------------

    def _directives_of(self, run: RunResult) -> dict:
        """Canonical sparse form: the steps where the schedule deviates
        from the default run-until-blocked continuation."""
        directives = {}
        prev = None
        for i, (enabled, _ops, chosen) in enumerate(run.nodes):
            default = prev if prev in enabled else min(enabled)
            if chosen != default:
                directives[i] = chosen
            prev = chosen
        return directives

    def _preemption_count(self, run: RunResult) -> int:
        return sum(1 for ts in run.trace if ts.preemption)

    def _shrink(self, failing: RunResult) -> FailingSchedule:
        current = self._directives_of(failing)
        best = failing
        shrunk = True
        while shrunk and current:
            shrunk = False
            for step in sorted(current):
                cand = dict(current)
                del cand[step]
                run = self._run(_DirectivePlan(cand))
                if run.failed:
                    best = run
                    current = self._directives_of(run)
                    shrunk = True
                    break
        msg = ("deadlock: no schedulable thread"
               if best.deadlock else
               f"{type(best.error).__name__}: {best.error}")
        return FailingSchedule(
            message=msg,
            choices=best.choices,
            directives=current,
            preemptions=self._preemption_count(best),
            trace=best.trace,
            narrative=(f"{msg}\nminimal preemption directives: "
                       f"{sorted(current.items())}\n"
                       + self.render(best.trace)),
        )
