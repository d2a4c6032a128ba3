"""The port's conformance profile (`kubeflow_tpu_torch/conformance/`)
against the reference's (`conformance/`, `ci/metrics_drift_check.sh`).

- The goldens: the port's render of the CPU workbench with auth equals
  the reference's committed golden entry, and its two-host GPU
  workbench equals the port's committed golden.
- The behaviour runners: one port manager is booted (`USE_ISTIO=true
  python -m kubeflow_tpu_torch.main --serve-api 0 --fake-gpu-nodes 4`)
  and both the reference's `conformance/behavior.py --skip-tpu --istio`
  and the port's runner with `--expect-scheduled --istio` pass against
  it, each as its own process; the port's runner refuses a gang's
  StatefulSet without `nvidia.com/gpu`.
- The metric-family gate: the port's live `/metrics` inventory equals
  its committed golden, which is the reference's golden but for the one
  family named after the device.
- `python -m kubeflow_tpu_torch.conformance` exits 0.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest

from kubeflow_tpu_torch.conformance import behavior, goldens, metrics
from kubeflow_tpu_torch.conformance.manager import ManagerProcess

ROOT = Path(__file__).resolve().parent.parent
# the reference family -> the port's family; every other family keeps
# its name (the port's gangs still count `notebook_slice_restarts_total`
# and meter `notebook_tenant_chip_seconds_total`, in GPUs)
FAMILY_RENAMES = {"notebook_tpu_chips_requested": "notebook_gpus_requested"}


@pytest.fixture(scope="module")
def rendered():
    return goldens.render_workbench_objects()


def test_cpu_workbench_equals_the_reference_golden(rendered):
    ref = json.loads(
        (ROOT / "conformance" / "goldens" / "workbench_objects.json")
        .read_text())
    assert rendered["cpu-auth-workbench"] == ref["cpu-auth-workbench"]
    assert len(rendered["cpu-auth-workbench"]) == 12


def test_gpu_workbench_equals_the_ports_golden(rendered):
    committed = json.loads(
        (goldens.GOLDEN_DIR / goldens.GOLDEN_FILE).read_text())
    assert sorted(committed) == ["cpu-auth-workbench",
                                 "gpu-multihost-workbench"]
    assert rendered["gpu-multihost-workbench"] == \
        committed["gpu-multihost-workbench"]
    assert goldens.check() == 0


def _gang_sts(rendered) -> dict:
    (sts,) = [o for o in rendered["gpu-multihost-workbench"]
              if o["kind"] == "StatefulSet"]
    return copy.deepcopy(sts)


def test_the_golden_gang_meets_the_runners_contract(rendered):
    """The committed render is what the runner checks: two hosts of
    eight GPUs, and torchrun's env as core/workload.py renders it."""
    sts = _gang_sts(rendered)
    assert behavior.check_gang_statefulset(sts, "wb-gpu") == 2
    env = {e["name"] for e in sts["spec"]["template"]["spec"]
           ["containers"][0]["env"]}
    assert set(behavior.RENDEZVOUS_ENV) <= env


@pytest.mark.parametrize("where", ["requests", "limits", "both"])
def test_runner_refuses_a_gang_without_gpus(rendered, where):
    sts = _gang_sts(rendered)
    resources = sts["spec"]["template"]["spec"]["containers"][0]["resources"]
    for kind in (("requests", "limits") if where == "both" else (where,)):
        del resources[kind]["nvidia.com/gpu"]
    with pytest.raises(AssertionError, match="nvidia.com/gpu"):
        behavior.check_gang_statefulset(sts, "wb-gpu")


def test_runner_refuses_a_gang_without_its_rank_env(rendered):
    sts = _gang_sts(rendered)
    main = sts["spec"]["template"]["spec"]["containers"][0]
    main["env"] = [e for e in main["env"] if e["name"] != "PET_NODE_RANK"]
    with pytest.raises(AssertionError, match="PET_NODE_RANK"):
        behavior.check_gang_statefulset(sts, "wb-gpu")


@pytest.fixture(scope="module")
def wire_url():
    with ManagerProcess(["--serve-api", "0", "--metrics-addr", "0",
                         "--fake-gpu-nodes", "4"],
                        env={"USE_ISTIO": "true"}) as mgr:
        yield mgr.wait_for("WIRE_API=")


def _run(argv: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=240)


def test_reference_runner_passes_against_the_port(wire_url):
    proc = _run(["conformance/behavior.py", "--server", wire_url,
                 "--namespace", "ref-runner", "--skip-tpu", "--istio"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[-1] == "behavioral conformance: PASS"


def test_port_runner_passes_against_the_port(wire_url):
    proc = _run(["-m", "kubeflow_tpu_torch.conformance.behavior",
                 "--server", wire_url, "--namespace", "port-runner",
                 "--expect-scheduled", "--istio"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert "PASS gpu topology + gang-atomic semantics" in lines
    # scheduled once before the stop and once after the resume
    assert lines.count("PASS gpu gang scheduling on real nodes") == 2
    assert lines[-1] == "behavioral conformance: PASS"


def test_metric_families_match_the_references_but_for_the_device():
    ref = (ROOT / "ci" / "metrics_families.golden").read_text().splitlines()
    ours = metrics.GOLDEN.read_text().splitlines()
    renamed = sorted(
        " ".join([FAMILY_RENAMES.get(line.split()[0], line.split()[0]),
                  line.split()[1]]) for line in ref)
    assert ours == renamed
    assert len(ours) == 59
    assert metrics.check() == 0


def test_the_profile_passes():
    proc = _run(["-m", "kubeflow_tpu_torch.conformance"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["ok"] and out["goldens"] and out["fixtures"]
    assert out["behavior"] == ["cpu_lifecycle", "served_versions",
                               "gpu_topology", "istio_routing"]
