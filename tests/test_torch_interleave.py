"""The port's interleave checker against the reference's.

`kubeflow_tpu_torch/testing/interleave.py` (the CHESS-style explorer:
DFS under preemption bounding with sleep sets, replay, render,
`checkpoint` and `await_cond`) runs on the port's yield points
(`utils/invariants.set_yield_hook`, armed by INVARIANTS_STRICT=1).  The
scenarios and mutants are the reference's own, from
tests/test_interleave.py, executed once against each package (its source
with `kubeflow_tpu` swapped for `kubeflow_tpu_torch`; see
tests/test_torch_patch.py:twin_modules):

- the shard-handoff scenario (a zombie of an evicted replica fenced while
  the joiner takes over) and the two-join scenario (two replicas join at
  once; no key is ever dispatched on two replicas), each explored
  exhaustively at preemption bound 0 and to a schedule cap at bound 2;
- the adopt-before-commit mutant (adoption from the join preview) and the
  dropped-drain-gate mutant (a joiner dispatches a gained key before the
  previous owner drained it) must fail on both packages.

Each exploration's distinct schedules, runs, stop reason and bound, and a
failure's message, shrunk directives, preemptions and rendered trace must
be equal on both packages.  Every exploration here stops as `exhausted`,
`max_schedules` or `failure`, never on its wall-clock budget.  The
dropped-drain-gate mutant is found at the 770th schedule of a bound-1
search (about a minute a package): here its shrunk schedule is replayed on
both packages, and the full searches run under `-m slow`.  The checker is
plain Python, so no tolerance applies."""

from __future__ import annotations

import importlib
import os
import threading

import pytest
from test_torch_patch import SIDES, twin_modules

from kubeflow_tpu_torch.utils.config import CoreConfig

PACKAGES = {"reference": "kubeflow_tpu", "port": "kubeflow_tpu_torch"}
# the port has no TPUSpec; the reference's module-level SPEC only feeds
# its scheduler scenarios, which are not run here
IL = twin_modules("test_interleave.py", port_lines={
    "from kubeflow_tpu_torch.api.types import Notebook, ReplicationSpec, "
    "TPUSpec": "from kubeflow_tpu_torch.api.types import Notebook, "
               "ReplicationSpec",
    'SPEC = TPUSpec("v5e", "4x4")': "SPEC = None"})
# well above any run here: a search stops on its schedule cap or its
# end, never on the wall clock
BUDGET_S = 3600.0
SCENARIOS = {"handoff": "shard_handoff_scenario",
             "two_joins": "shard_concurrent_join_scenario"}
# the dropped-drain-gate mutant's shrunk failing schedule, as the bound-1
# search finds it on both packages: one preemption, at step 49, into the
# second joiner while the first holds team-1/nb-1
DRAIN_GATE_FAILURE = (0,) * 10 + (1,) * 39 + (2,) * 38
DRAIN_GATE_MESSAGE = ("AssertionError: single-owner violation: shard-c "
                      "dispatched ('team-1', 'nb-1') while ['shard-b'] "
                      "held it")


@pytest.fixture(autouse=True)
def _strict(monkeypatch):
    """The yield points exist only with the sanitizer armed; scenario
    factories build their ApiServer and replicas under it."""
    monkeypatch.setenv("INVARIANTS_STRICT", "1")


def _mutant(side: str, name: str):
    m = IL[side]
    mutations = {"adopt_before_commit": m.MUTANT_SHARD,
                 "drain_gate": m.MUTANT_OVERLAP}[name]
    return m._load_mutant(f"{PACKAGES[side]}.kube.shard", mutations,
                          f"{PACKAGES[side]}.kube._shard_mutant_{name}")


def _scenario(side: str, scenario: str, shard_mod=None):
    fn = getattr(IL[side], SCENARIOS[scenario])
    return lambda: fn(shard_mod)


def _budget():
    """The full-depth searches' schedule cap and wall-clock budget, from
    INTERLEAVE_MAX_SCHEDULES and INTERLEAVE_BUDGET_S as the port parses
    them (the reference's own tests read them the same way)."""
    cfg = CoreConfig.from_env(dict(os.environ))
    return cfg.interleave_max_schedules, cfg.interleave_budget_s


def _explore(side: str, factory, max_preemptions: int,
             max_schedules: int, budget_s: float = BUDGET_S):
    ex = IL[side].InterleavingExplorer(
        factory, max_preemptions=max_preemptions,
        max_schedules=max_schedules, budget_s=budget_s)
    res = ex.explore()
    assert res.stopped in ("exhausted", "max_schedules", "failure"), (
        f"{side}: stopped on its {budget_s} s budget after "
        f"{res.schedules} schedules (INTERLEAVE_BUDGET_S)")
    out = {"schedules": res.schedules, "runs": res.runs,
           "stopped": res.stopped, "bound": res.bound_reached,
           "ok": res.ok}
    if res.failure is not None:
        f = res.failure
        out.update(message=f.message, directives=f.directives,
                   preemptions=f.preemptions, choices=f.choices,
                   trace=ex.render(f.trace))
    return out


def test_explorer_is_the_references_copy():
    ref = importlib.import_module("kubeflow_tpu.testing.interleave")
    port = importlib.import_module("kubeflow_tpu_torch.testing.interleave")
    assert IL["port"].InterleavingExplorer is port.InterleavingExplorer
    assert IL["reference"].InterleavingExplorer is ref.InterleavingExplorer
    assert IL["port"].await_cond is port.await_cond
    for name in ("InterleavingExplorer", "checkpoint", "await_cond",
                 "ReplayDivergence", "Op", "TraceStep", "RunResult",
                 "FailingSchedule", "ExploreResult"):
        assert hasattr(port, name), name
    assert port.InterleavingExplorer.WEDGE_TIMEOUT_S == \
        ref.InterleavingExplorer.WEDGE_TIMEOUT_S
    assert port.InterleavingExplorer(lambda: None).max_schedules == \
        ref.InterleavingExplorer(lambda: None).max_schedules == 1200


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "off"])
def test_invariants_strict_arms_the_yield_points_alike(strict, monkeypatch):
    """INVARIANTS_STRICT=1 arms the tracked locks on both packages, so
    their acquires and releases become yield points beside the store's
    commits and the workqueue's points; without it only those remain.
    The points a scenario's setup passes, in order, are equal."""
    if not strict:
        monkeypatch.delenv("INVARIANTS_STRICT")
    seen = {}
    for side in SIDES:
        inv = importlib.import_module(f"{PACKAGES[side]}.utils.invariants")
        assert inv.strict_enabled() is strict
        lock = threading.Lock()
        assert (inv.tracked(lock, "x") is lock) is not strict
        points: list = []
        prev = inv.set_yield_hook(
            lambda kind, detail, token: points.append((kind, detail)))
        try:
            IL[side].shard_concurrent_join_scenario()
        finally:
            inv.set_yield_hook(prev)
        seen[side] = points
    assert seen["port"] == seen["reference"]
    kinds = {kind for kind, _ in seen["port"]}
    assert "store.commit" in kinds
    assert ("lock.acquire" in kinds) is strict


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_default_schedule_replays_alike(scenario):
    """The run-until-blocked schedule of each scenario: the same choices
    and the same rendered trace on both packages, byte for byte, and a
    second replay of it identical."""
    out = {}
    for side in SIDES:
        ex = IL[side].InterleavingExplorer(_scenario(side, scenario))
        base = ex.replay(())
        again = ex.replay(base.choices)
        assert not base.failed and not again.failed
        assert ex.render(again.trace) == ex.render(base.trace)
        out[side] = (base.choices, ex.render(base.trace))
    assert out["port"] == out["reference"]
    assert "store.commit" in out["port"][1]


@pytest.mark.parametrize("bound,cap", [(0, 100000), (2, 60)],
                         ids=["bound0_exhausted", "bound2_capped"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_scenario_verdict_matches_the_reference(scenario, bound, cap):
    out = {side: _explore(side, _scenario(side, scenario), bound, cap)
           for side in SIDES}
    assert out["port"] == out["reference"]
    assert out["port"]["ok"]
    assert out["port"]["stopped"] == \
        ("exhausted" if bound == 0 else "max_schedules")


def test_adopt_before_commit_mutant_is_caught_alike():
    """Adoption from the join preview: caught on the first schedule on
    both packages, shrunk to no directive."""
    out = {side: _explore(side, _scenario(
        side, "handoff", _mutant(side, "adopt_before_commit")), 2, 600)
        for side in SIDES}
    assert out["port"] == out["reference"]
    assert out["port"]["stopped"] == "failure"
    assert out["port"]["preemptions"] == 0 and \
        out["port"]["directives"] == {}
    assert "StaleEpochError" in out["port"]["message"]


def test_drain_gate_mutant_fails_its_shrunk_schedule_alike():
    """The dropped drain gate's shrunk failing schedule fails the same
    way on both packages' mutants, with the same trace."""
    out = {}
    for side in SIDES:
        mod = _mutant(side, "drain_gate")
        ex = IL[side].InterleavingExplorer(
            _scenario(side, "two_joins", mod))
        run = ex.replay(DRAIN_GATE_FAILURE)
        assert run.failed
        out[side] = (f"{type(run.error).__name__}: {run.error}",
                     sum(ts.preemption for ts in run.trace),
                     ex.render(run.trace))
    assert out["port"] == out["reference"]
    assert out["port"][:2] == (DRAIN_GATE_MESSAGE, 1)


@pytest.mark.slow
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_full_depth_scenario_verdict_matches_the_reference(scenario):
    """The reference's own depth on both packages: bound 2, with the
    schedule cap (default 1200) and the wall-clock budget (default 60 s)
    taken from INTERLEAVE_MAX_SCHEDULES and INTERLEAVE_BUDGET_S.  A
    search takes 60-70 s a package at the default cap on an 8-core host,
    so a loaded host needs a larger budget, as the reference's own
    full-depth tests do."""
    cap, budget_s = _budget()
    out = {side: _explore(side, _scenario(side, scenario), 2, cap, budget_s)
           for side in SIDES}
    assert out["port"] == out["reference"]
    assert out["port"]["ok"] and \
        out["port"]["schedules"] >= min(1000, cap)


@pytest.mark.slow
def test_drain_gate_mutant_is_found_alike():
    """The bound-1 search the reference's test runs, on both packages:
    the same 770 schedules to the same shrunk failure."""
    out = {side: _explore(side, _scenario(
        side, "two_joins", _mutant(side, "drain_gate")), 1, 1500)
        for side in SIDES}
    assert out["port"] == out["reference"]
    assert out["port"]["stopped"] == "failure"
    assert out["port"]["choices"] == DRAIN_GATE_FAILURE
    assert out["port"]["message"] == DRAIN_GATE_MESSAGE
