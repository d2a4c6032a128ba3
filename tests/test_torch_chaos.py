"""The port's chaos plane against the reference's tests/test_chaos.py.

Each test method of tests/test_chaos.py is a function of
`kubeflow_tpu_torch.chaos.soaks`, written once over a stack of either
package.  Here each runs on the reference's stack (`spec.tpu` slices of
v5e 4x4, 4 hosts of 4 chips) and on the port's (`spec.gpu` gangs of 4
hosts of 8 H100s), at tests/test_chaos.py's seed and rounds, with one
worker and each side's wall-clock sources on its own FakeClocks
(tests/test_torch_faults.py:run_soak).  Every reference assertion holds
on both sides, and the two records (what those assertions read, round by
round) must be equal once uids, trace and span ids, HTTP ports and the
device word of `-tpu-`/`-gpu-` names are read as tokens.  Wall-clock
gates (the profiler's overhead, `overlapping_attempts()` empty) are held
on each side and not compared.  No tolerance applies.

This file holds the knowledge model, the fault drills and the soaks of
the control plane's engines; tests/test_torch_chaos_obs.py holds those
of its observability plane.  The twin of
`TestChaosSoak::test_seeded_random_fault_soak` is
tests/test_torch_faults.py's `test_random_fault_soak_converges_as_the_
reference`.

The knowledge model gets two checks of its own: the port's model is the
reference's in the device's words, and it declares every kind the port's
stack creates for a `spec.gpu` notebook with auth, as the stack creates
every kind it declares that is not optional."""

from __future__ import annotations

import pytest
import yaml
from test_torch_faults import ROOT, _first_difference, run_soak, twins

from kubeflow_tpu_torch.chaos import knowledge, soaks

# the reference methods held here, and the rounds tests/test_chaos.py
# gives each (None: the method has no rounds)
CASES = {
    "TestKnowledgeModel::test_model_parses_and_names_controllers": None,
    "TestKnowledgeModel::test_managed_kinds_match_reality": None,
    "TestKnowledgeModel::test_steady_state_timeout_declared": None,
    "TestFaultInjection::test_kill_worker_pod_recovers": None,
    "TestFaultInjection::test_failed_worker_degrades_then_restart_recovers":
        None,
    "TestFaultInjection::test_delete_route_recreated": None,
    "TestChaosSoak::test_trace_integrity_under_faults": None,
    "TestChaosSoak::test_soak_is_reproducible_for_a_seed": None,
    "TestSliceRecoverySoak::test_recovery_soak_with_failover": 12,
    "TestSliceRecoverySoak::test_permanent_failure_exhausts_exactly_at_cap":
        None,
    "TestMigrationRecoverySoak::test_seeded_migration_drill_restores_state":
        10,
    "TestMigrationRecoverySoak::"
    "test_failover_mid_migration_resumes_without_double_restore": None,
    "TestMigrationRecoverySoak::"
    "test_migrate_budget_shared_with_restart_exhausts_at_cap": None,
    "TestPreemptionSoak::test_seeded_kill_points_resume_exactly_once": 6,
    "TestFailoverSoak::test_failover_soak_sub_second_promotions": 50,
    "TestShardKillRejoinSoak::test_kill_rejoin_soak": 8,
}


@pytest.mark.parametrize("case", list(CASES),
                         ids=lambda c: c.replace("::", "."))
def test_soak_matches_the_reference(case):
    ref, ours = twins(soaks.SOAKS[case], CASES[case])
    assert ours == ref, _first_difference(ref, ours)


def test_every_reference_method_has_a_twin():
    """22 methods in 13 classes: 16 here, 5 in test_torch_chaos_obs.py and
    the seeded soak in test_torch_faults.py."""
    import test_torch_chaos_obs

    held = set(CASES) | set(test_torch_chaos_obs.CASES) \
        | {"TestChaosSoak::test_seeded_random_fault_soak"}
    assert held == set(soaks.SOAKS)
    assert len(held) == 22
    assert len({key.split("::")[0] for key in held}) == 13


# the four words the port's model says in the device's way
DEVICE_WORDS = {"slice": "gang", "tpu-notebook": "gpu-notebook",
                "tpu": "gpu"}


def _in_device_words(node):
    if isinstance(node, dict):
        return {k: _in_device_words(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_in_device_words(v) for v in node]
    return DEVICE_WORDS.get(node, node)


def test_knowledge_model_is_the_references_in_the_devices_words():
    ref_text = (ROOT / "chaos" / "knowledge" / "workbenches.yaml").read_text()
    text = knowledge.PATH.read_text()
    assert knowledge.load() == _in_device_words(yaml.safe_load(ref_text))
    # the fourth word is a comment: the workers' NetworkPolicy
    assert "tpu-workers-np" in ref_text and "gpu-workers-np" in text
    assert "tpu" not in text.lower().replace("kubeflow_tpu_torch", "")
    assert knowledge.PATH.is_relative_to(ROOT / "kubeflow_tpu_torch")


def test_knowledge_model_declares_what_the_port_creates():
    """Every kind the port's stack creates for a spec.gpu notebook with
    auth is declared (the soak's own drift check), and every kind the
    model declares without `optional` is created."""
    drift = run_soak(
        soaks.SOAKS["TestKnowledgeModel::test_managed_kinds_match_reality"],
        True)
    assert set(drift["created"]) <= set(drift["declared"])
    assert set(drift["required"]) <= set(drift["created"]), \
        sorted(set(drift["required"]) - set(drift["created"]))
    assert {"StatefulSet", "HTTPRoute", "NetworkPolicy"} <= \
        set(drift["required"])


def test_the_runner_runs_every_lane():
    """`python -m kubeflow_tpu_torch.chaos`, the twin of ci/chaos_soak.sh,
    at a few rounds a lane on two workers with the sanitizer on: the seed
    line first, then one line a lane, then OK."""
    import json
    import os
    import re
    import subprocess
    import sys

    env = dict(os.environ, WORKQUEUE_WORKERS="2", INVARIANTS_STRICT="1",
               CHAOS_SOAK_ROUNDS="20", SELFHEAL_SOAK_ROUNDS="2",
               MIGRATE_SOAK_ROUNDS="3", PREEMPT_SOAK_ROUNDS="3",
               SHARD_SOAK_ROUNDS="2", FAILOVER_SOAK_ROUNDS="2")
    env.pop("CHAOS_SOAK_SEED", None)
    proc = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.chaos", "--gpu",
         "h100-80gb"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    first, *lanes, last = proc.stdout.strip().splitlines()
    assert re.fullmatch(r"== chaos soak: seed=20260804 CHAOS_SOAK_ROUNDS=20 "
                        r".* workers=2 strict=1 ==", first), first
    lanes = [json.loads(line) for line in lanes]
    assert [lane["lane"] for lane in lanes] == [
        "chaos", "slice_recovery", "migration", "preemption", "fleet_slo",
        "shard", "failover"]
    assert all(lane["seed"] == soaks.SEED and lane["workers"] == 2
               for lane in lanes)
    assert lanes[-1]["counts"]["promotions"] == 2
    assert lanes[1]["counts"]["exhausted_at"] == 4
    assert lanes[4]["counts"]["alerts_fired"] == 3
    assert last == f"chaos soak OK (seed={soaks.SEED})"


def test_the_runner_draws_a_random_seed_and_names_it():
    from kubeflow_tpu_torch.chaos import __main__ as runner

    cfg = runner.settings({"CHAOS_SOAK_SEED": "random"})
    assert 0 <= cfg["seed"] < 2**30
    assert f"seed={cfg['seed']} " in runner.seed_line(cfg)
    assert f"CHAOS_SOAK_SEED={cfg['seed']} " in runner.reproduce_line(
        cfg, "h100-80gb")
    assert runner.settings({}) == {
        "seed": soaks.SEED, "workers": 8, "strict": "1",
        "CHAOS_SOAK_ROUNDS": 25, "SELFHEAL_SOAK_ROUNDS": 16,
        "MIGRATE_SOAK_ROUNDS": 12, "PREEMPT_SOAK_ROUNDS": 6,
        "SHARD_SOAK_ROUNDS": 10, "FAILOVER_SOAK_ROUNDS": 50}
