"""The port's diagnostics bundle against the reference's.

`kubeflow_tpu_torch/ops/diagnose.py` (`redacted_config`, `collect_local`,
`collect_http` over the port's /debug surfaces, `merge_records`,
`merge_overlaps`, `merge_timelines`, `merge_changepoints`, `summarize`
and the CLI, `--merge` among its modes):

- the cases of tests/test_slo.py's TestDiagnoseBundle and
  TestDiagnoseMerge run on both packages (tests/test_torch_patch.py:
  `twin_modules`; the reference's 4x4 v5e slice on 4 hosts is a 16-GPU
  gang on 2 hosts in the port's copy), each package's assertions holding;
- `redacted_config` gives the reference's output on the same env; the
  port keeps GPU_ variables too, where the reference keeps TPU_ ones;
- `collect_local` of `main.build_manager`'s stack, a `spec.tpu` slice on
  the reference and a `spec.gpu` gang of the same host count on the port,
  gives bundles with the same sections and the same keys in each;
- one bundle per replica of the port's sharded fleet, through a kill and
  a rejoin, merged by `--merge`: no overlap, the merged artifact written,
  and the reference's merge over the same files giving the same summary.

No tolerance applies: the bundles are JSON of FakeClock runs."""

from __future__ import annotations

import json

import pytest
from test_torch_patch import case_ids, run_twins, twin_modules

import kubeflow_tpu.ops.diagnose as ref_diagnose
from kubeflow_tpu import main as ref_main
from kubeflow_tpu.api.types import Notebook as RefNotebook
from kubeflow_tpu.api.types import TPUSpec
from kubeflow_tpu.utils.clock import FakeClock as RefFakeClock
from kubeflow_tpu.utils.config import CoreConfig as RefConfig
from kubeflow_tpu.utils.config import OdhConfig as RefOdhConfig
from kubeflow_tpu_torch import kube
from kubeflow_tpu_torch.api.types import GPUSpec, Notebook
from kubeflow_tpu_torch.main import build_manager, build_sharded_fleet
from kubeflow_tpu_torch.ops import diagnose
from kubeflow_tpu_torch.utils.clock import FakeClock
from kubeflow_tpu_torch.utils.config import CoreConfig, OdhConfig

SLO = twin_modules("test_slo.py", port_lines={
    "from kubeflow_tpu_torch.api.types import CONDITION_RECOVERY_EXHAUSTED, "
    "Notebook, \\\n    TPUSpec":
        "from kubeflow_tpu_torch.api.types import "
        "CONDITION_RECOVERY_EXHAUSTED, GPUSpec",
    'cluster.add_tpu_slice_nodes("tpu-v5-lite-podslice", "4x4", 4, 4)':
        'cluster.add_gpu_nodes("h100-80gb", 2, 8)',
    'tpu=TPUSpec("v5e", "4x4")': 'gpu=GPUSpec("h100-80gb", 16)'})
CASES = case_ids(SLO["reference"], ("TestDiagnoseBundle", "TestDiagnoseMerge"))
# the merge cases that read what the CLI printed
CAPSYS = {"TestDiagnoseMerge::test_merge_flags_cross_bundle_overlap",
          "TestDiagnoseMerge::test_merge_clean_bundles_pass"}


@pytest.mark.parametrize("case", [c for c in CASES if c not in CAPSYS])
def test_diagnose_cases_hold_on_both(case, tmp_path):
    # two stores of different devices: the assertions hold, the stores
    # are not compared
    run_twins(SLO, case, tmp_path, compare=False)


@pytest.mark.parametrize("case", sorted(CAPSYS))
def test_diagnose_merge_cli_cases_hold_on_both(case, tmp_path, capsys):
    cls, _, meth = case.partition("::")
    for side in ("reference", "port"):
        path = tmp_path / side
        path.mkdir()
        getattr(getattr(SLO[side], cls)(), meth)(path, capsys)


def test_case_counts():
    assert len(CASES) == 8


def test_redacted_config_matches_the_reference():
    env = {f"{prefix}KNOB": f"v{i}"
           for i, prefix in enumerate(ref_diagnose.CONFIG_PREFIXES)}
    env.update({"OTEL_EXPORTER_OTLP_TOKEN": "hunter2",
                "CHECKPOINT_STORE_SECRET": "s3cr3t",
                "SLO_API_KEY": "k", "K8S_CERT_DIR": "/certs",
                "HOME": "/home/jovyan", "PATH": "/usr/bin", "SHELL": "/bin/sh"})
    ours = diagnose.redacted_config(env)
    assert ours == ref_diagnose.redacted_config(env)
    assert ours["CHECKPOINT_STORE_SECRET"] == diagnose.REDACTED
    assert "HOME" not in ours and "PATH" not in ours
    gpu = {"GPU_DEFAULT_IMAGE": "jupyter-cuda-pytorch:1",
           "GPU_IMAGE_TOKEN": "t"}
    assert diagnose.redacted_config(gpu) == {
        "GPU_DEFAULT_IMAGE": "jupyter-cuda-pytorch:1",
        "GPU_IMAGE_TOKEN": diagnose.REDACTED}
    assert ref_diagnose.redacted_config(gpu) == {}
    assert set(diagnose.CONFIG_PREFIXES) == \
        set(ref_diagnose.CONFIG_PREFIXES) | {"GPU_"}


def _keys(value, depth: int):
    """The key tree of `value` to `depth` levels of dicts."""
    if not isinstance(value, dict) or depth == 0:
        return type(value).__name__
    return {k: _keys(v, depth - 1) for k, v in value.items()}


def _bundle(port: bool, monkeypatch) -> dict:
    """A converged notebook and gang in `build_manager`'s stack, each on
    its own FakeClock (the reference's Manager put on it by patching
    `kubeflow_tpu.main.Manager`), and its in-process bundle."""
    if port:
        mgr, api, cluster, metrics = build_manager(
            CoreConfig(), clock=FakeClock(), odh_cfg=OdhConfig())
        cluster.add_gpu_nodes("h100-80gb", 2, 8)
        gang = Notebook.new("gang", "u1", gpu=GPUSpec("h100-80gb", 16)).obj
        cpu = Notebook.new("nb", "u2").obj
        for d in (gang, cpu):
            api.create(kube.KubeObject.from_dict(d))
    else:
        clock, manager = RefFakeClock(), ref_main.Manager
        monkeypatch.setattr(ref_main, "Manager",
                            lambda api: manager(api, clock=clock))
        mgr, api, cluster, metrics = ref_main.build_manager(
            RefConfig(), odh_cfg=RefOdhConfig())
        cluster.add_tpu_slice_nodes("tpu-v4-podslice", "2x2x2", 2, 4)
        api.create(RefNotebook.new("gang", "u1",
                                   tpu=TPUSpec("v4", "2x2x2")).obj)
        api.create(RefNotebook.new("nb", "u2").obj)
    cluster.add_node("cpu-node", allocatable={"cpu": "64",
                                              "memory": "256Gi"})
    for _ in range(3):
        mgr.enqueue_all()
        mgr.run_until_idle()
        metrics.scrape()
    mod = diagnose if port else ref_diagnose
    bundle = mod.collect_local(mgr, metrics, env={"WORKQUEUE_WORKERS": "1"})
    mgr.stop()
    return json.loads(json.dumps(bundle, default=str))


def test_local_bundle_has_the_references_sections(monkeypatch):
    ref, ours = _bundle(False, monkeypatch), _bundle(True, monkeypatch)
    # traces are keyed by their random ids, and which attempts are the
    # slowest is the wall clock's: their key trees are compared as a set
    traces = [{json.dumps(_keys(t, 2), sort_keys=True)
               for t in b.pop("traces").values()} for b in (ref, ours)]
    assert traces[1] == traces[0] and traces[0]
    assert _keys(ours, 2) == _keys(ref, 2)
    assert ours["bundle_format"] == ref["bundle_format"] == 1
    assert ours["config"] == ref["config"] == {"WORKQUEUE_WORKERS": "1"}
    assert ours["fleet"]["totals"] == ref["fleet"]["totals"]
    assert ours["reconciles"]["recorded_total"] > 0
    for section in ("alerts", "slo_verdicts", "telemetry", "criticalpath",
                    "tenants", "timeline", "diagnosis"):
        assert ours[section] is not None, section
    assert diagnose.summarize(ours).startswith("bundle: ")


def test_merge_over_a_sharded_fleets_bundles(tmp_path, capsys):
    """One bundle per replica of the port's fleet, through a kill and a
    rejoin: `--merge` finds attempts and no overlap, and writes the
    merged artifact; the reference's merge of the same files prints the
    same summary."""
    clock = FakeClock()
    fleet, api, cluster, _ = build_sharded_fleet(CoreConfig(), count=2,
                                                 clock=clock)
    cluster.add_node("cpu-node", allocatable={"cpu": "64",
                                              "memory": "256Gi"})
    for i in range(8):
        api.create(kube.KubeObject.from_dict(
            Notebook.new(f"nb-{i}", f"team-{i % 4}").obj))
    fleet.settle()
    fleet.kill("shard-0")
    for _ in range(3):
        clock.advance(8)
        fleet.settle()
    fleet.rejoin("shard-0")
    fleet.settle()
    paths = []
    for sid, replica in sorted(fleet.replicas.items()):
        path = tmp_path / f"{sid}.json"
        path.write_text(json.dumps(diagnose.collect_local(
            replica.manager, env={}), default=str))
        paths.append(str(path))
    out = tmp_path / "merged.json"
    assert diagnose.main(["--merge", *paths, "--out", str(out)]) == 0
    ours = capsys.readouterr().out
    merged = json.loads(out.read_text())
    assert merged["bundles"] == 2 and merged["overlaps"] == 0
    bundles = [json.loads(open(p).read()) for p in paths]
    records = diagnose.merge_records(bundles)
    assert records and diagnose.merge_overlaps(bundles) == []
    assert f"{len(records)} distinct attempts, 0 overlapping pairs" in ours
    assert ref_diagnose.main(["--merge", *paths]) == 0
    theirs = capsys.readouterr().out
    assert theirs.splitlines()[0] == ours.splitlines()[0]
    assert diagnose.merge_timelines(bundles) == \
        ref_diagnose.merge_timelines(bundles)
