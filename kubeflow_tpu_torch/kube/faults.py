"""Programmable fault injection for the in-memory control plane.

The port's copy of kubeflow_tpu/kube/faults.py.

The reference ships shift-left chaos CI (SURVEY.md §4.6,
chaos/knowledge/workbenches.yaml) whose premise is that level-triggered
reconcilers converge back to steady state under faults.  This module is the
injection surface that lets tests actually exercise that premise against the
in-memory ApiServer: a `FaultPlan` of `FaultRule`s installed via
`ApiServer.install_fault_plan` intercepts top-level API verbs and can

  - raise per-verb/per-kind API errors (409 Conflict, 500 internal,
    503 "etcd leader changed"),
  - add artificial latency (advances an attached FakeClock, so delays are
    deterministic and visible to the controller's backoff machinery),
  - serve stale reads (the previous version of the object, from the watch
    history),
  - drop watch connections and reset the resourceVersion history window,
    forcing resumable watchers through the 410 Gone → relist path.

Determinism: every probabilistic decision draws from the plan's seeded
`random.Random`, and every injected fault is appended to `plan.log` so a
test can assert exactly what was injected.  Rules carry match counts
(`max_matches`) so a plan always drains — after every rule is exhausted the
cluster is fault-free and reconcilers must converge.

Scoping: faults fire only at top-level verb entry (re-entrant ApiServer
internals — GC, patch retries, admission — and watch-event-driven
components such as the FakeCluster data plane run inside an outer verb and
are exempt).  That models client↔apiserver failures without breaking the
cluster's own invariants; use `ApiServer.fault_exempt()` to make test
harness calls immune too.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

from ..utils import tracing
from .errors import ConflictError, ServerError

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .store import ApiServer

# verbs the ApiServer gates (watch drops ride on any verb via drop_watch)
VERBS = ("get", "list", "create", "update", "patch", "delete")

_ERROR_FACTORIES = {
    "conflict": lambda: ConflictError(
        "injected: the object has been modified"),
    "server": lambda: ServerError("injected: internal error"),
    "unavailable": lambda: ServerError(
        "injected: etcd leader changed (503)"),
}

ERROR_KINDS = tuple(_ERROR_FACTORIES)


@dataclass
class FaultRule:
    """One injectable behavior.  Empty verb/kind tuples match everything.

    A rule fires on a matching call once `after` matches have been skipped,
    with probability `probability` per candidate call, at most `max_matches`
    times.  Actions: `error`, `latency_s`, `stale_read`, `drop_watch`
    (disconnect resumable watchers; they reconnect lazily and replay the
    gap), and `reset_watch_history` (etcd compaction: evict the resume
    window so a reconnect from a pre-reset resourceVersion gets
    410 Gone → relist).  drop_watch + reset_watch_history compose into the
    classic dead-resourceVersion scenario."""

    verbs: tuple[str, ...] = ()
    kinds: tuple[str, ...] = ()
    error: str = ""              # one of ERROR_KINDS, or ""
    latency_s: float = 0.0
    stale_read: bool = False
    drop_watch: bool = False
    reset_watch_history: bool = False
    probability: float = 1.0
    max_matches: int = 1
    after: int = 0
    name: str = ""

    def __post_init__(self) -> None:
        if self.error and self.error not in _ERROR_FACTORIES:
            raise ValueError(
                f"unknown error kind {self.error!r}; want one of "
                f"{sorted(_ERROR_FACTORIES)}")

    def action(self) -> str:
        parts = []
        if self.error:
            parts.append(f"error:{self.error}")
        if self.drop_watch:
            parts.append("drop_watch")
        if self.reset_watch_history:
            parts.append("reset_history")
        if self.stale_read:
            parts.append("stale_read")
        if self.latency_s:
            parts.append("latency")
        return "+".join(parts) or "noop"


@dataclass
class FaultRecord:
    """One injected fault, for post-hoc assertions.

    `trace_id`/`span_id` identify the live reconcile root span the fault
    hit — spans always record in-process (utils/tracing.py), so the ids are
    populated with or without an exporter installed and empty only when the
    fault fired outside any span.  `seq` is the fault's index in `plan.log`
    — the same value stamped on the span event, so a soak can pair every
    log entry with exactly one span event, and the flight recorder can
    attribute each fault to the attempt it hit."""

    rule: str
    action: str
    verb: str
    kind: str
    namespace: str
    name: str
    trace_id: str = ""
    span_id: str = ""
    seq: int = -1


class FaultPlan:
    """A seeded, countable set of FaultRules plus the injection log."""

    def __init__(self, rules: list[FaultRule], seed: int = 0,
                 clock=None) -> None:
        self.rules = list(rules)
        self.seed = seed
        self.clock = clock  # FakeClock: latency advances it deterministically
        self.rng = random.Random(seed)
        self.log: list[FaultRecord] = []
        self._seen: list[int] = [0] * len(self.rules)
        self._fired: list[int] = [0] * len(self.rules)

    # -- state ----------------------------------------------------------------
    def exhausted(self) -> bool:
        """True once no rule can fire again — the cluster is fault-free."""
        return all(f >= r.max_matches
                   for r, f in zip(self.rules, self._fired))

    def fired(self, rule_name: str = "") -> int:
        if not rule_name:
            return sum(self._fired)
        return sum(f for r, f in zip(self.rules, self._fired)
                   if r.name == rule_name)

    def summary(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for rec in self.log:
            out[rec.action] = out.get(rec.action, 0) + 1
        return out

    # -- the injection point (called by ApiServer._fault_scope) ---------------
    def intercept(self, api: "ApiServer", verb: str, kind: str,
                  namespace: str = "", name: str = "") -> Optional[dict]:
        """May raise an ApiError; returns directives for the verb body
        (currently {"stale": True} for stale reads) or None."""
        directives: Optional[dict] = None
        for i, rule in enumerate(self.rules):
            if self._fired[i] >= rule.max_matches:
                continue
            if rule.verbs and verb not in rule.verbs:
                continue
            if rule.kinds and kind not in rule.kinds:
                continue
            self._seen[i] += 1
            if self._seen[i] <= rule.after:
                continue
            if rule.probability < 1.0 and \
                    self.rng.random() >= rule.probability:
                continue
            self._fired[i] += 1
            # stamp the fault onto whichever reconcile attempt it hit: the
            # faulting ApiServer call may be running inside a controller
            # phase child span, so walk up to the root (the manager's
            # per-attempt reconcile span) — a chaos-soak trace then shows
            # exactly which 409/503/watch-drop landed on which attempt
            span = tracing.current_span()
            while span.parent is not None:
                span = span.parent
            rec = FaultRecord(
                rule=rule.name or f"rule{i}", action=rule.action(),
                verb=verb, kind=kind, namespace=namespace, name=name,
                trace_id=span.trace_id, span_id=span.span_id,
                seq=len(self.log))
            self.log.append(rec)
            span.add_event("fault.injected", {
                "fault.rule": rec.rule,
                "fault.action": rec.action,
                "fault.verb": verb,
                "fault.kind": kind,
                "fault.namespace": namespace,
                "fault.name": name,
                "fault.seq": rec.seq,
                "fault.plan_seed": self.seed,
            })
            if rule.latency_s > 0:
                self._inject_latency(rule.latency_s)
            if rule.reset_watch_history:
                api.reset_watch_history()
            if rule.drop_watch:
                api.drop_watch_connections()
            if rule.stale_read:
                directives = {"stale": True}
            if rule.error:
                raise _ERROR_FACTORIES[rule.error]()
        return directives

    def _inject_latency(self, seconds: float) -> None:
        advance = getattr(self.clock, "advance", None)
        if advance is not None:
            advance(seconds)
        # no real sleeping: against a wall clock latency is recorded only —
        # deterministic tests never block on injected delays


def random_fault_plan(seed: int, kinds: tuple[str, ...],
                      clock=None, max_rules: int = 4,
                      max_matches_per_rule: int = 3) -> FaultPlan:
    """A bounded random plan for soak tests: every rule has a finite match
    count, so the plan always drains and the post-fault steady state is
    reachable.  Drawn entirely from `seed` — the same seed reproduces the
    same plan AND the same per-call probability rolls."""
    rng = random.Random(seed)
    rules: list[FaultRule] = []
    n_rules = rng.randint(1, max_rules)
    for i in range(n_rules):
        roll = rng.random()
        verb_pool = ["get", "list", "create", "update", "delete", "patch"]
        verbs = tuple(rng.sample(verb_pool, rng.randint(1, 3)))
        rule_kinds = tuple(rng.sample(kinds, rng.randint(1, min(3, len(kinds)))))
        common = dict(
            verbs=verbs, kinds=rule_kinds,
            probability=rng.uniform(0.5, 1.0),
            max_matches=rng.randint(1, max_matches_per_rule),
            after=rng.randint(0, 2), name=f"soak-{seed}-{i}",
        )
        if roll < 0.55:
            rules.append(FaultRule(
                error=rng.choice(list(ERROR_KINDS)), **common))
        elif roll < 0.70:
            rules.append(FaultRule(
                latency_s=rng.uniform(0.001, 0.05), **common))
        elif roll < 0.85:
            common["verbs"] = ("get",)
            rules.append(FaultRule(stale_read=True, **common))
        else:
            rules.append(FaultRule(
                drop_watch=True,
                reset_watch_history=rng.random() < 0.5, **common))
    return FaultPlan(rules, seed=seed, clock=clock)


__all__ = [
    "ERROR_KINDS",
    "FaultPlan",
    "FaultRecord",
    "FaultRule",
    "VERBS",
    "random_fault_plan",
]
