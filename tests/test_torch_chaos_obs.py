"""The port's chaos soaks of the observability plane against the
reference's tests/test_chaos.py.

The fleet SLO soak, the flight recorder's /debug soak (the port's
`main.serve_http` on loopback port 0), the straggler soak, the diagnosis
soak and the noisy-neighbour soak, as tests/test_torch_chaos.py runs the
others: each `kubeflow_tpu_torch.chaos.soaks` function on the
reference's stack and on the port's, one worker, each side's wall-clock
sources on its own FakeClocks, every reference assertion held on both
and the records equal once uids, trace and span ids, HTTP ports and the
`-tpu-`/`-gpu-` device word are read as tokens.  The profiler's overhead
(< 0.05 of wall time) is held on each side and not compared.  No
tolerance applies."""

from __future__ import annotations

import pytest
from test_torch_faults import _first_difference, twins

from kubeflow_tpu_torch.chaos import soaks

CASES = (
    "TestFlightRecorderDebugSoak::test_post_hoc_diagnosis_via_debug_endpoints",
    "TestFleetSLOSoak::test_fleet_slo_soak_end_to_end",
    "TestStragglerSoak::test_straggler_soak_attribution_and_clear",
    "TestNoisyNeighborSoak::test_noisy_neighbor_soak_attribution_and_clear",
    "TestDiagnosisSoak::test_three_window_soak_names_every_injected_cause",
)


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: c.replace("::", "."))
def test_soak_matches_the_reference(case):
    ref, ours = twins(soaks.SOAKS[case])
    assert ours == ref, _first_difference(ref, ours)
