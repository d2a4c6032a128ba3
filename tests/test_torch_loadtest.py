"""The port's fleet load generators (`kubeflow_tpu_torch/loadtest/`) against
the reference's loadtest/convergence.py, loaded by path.

Each mode runs on both packages at a small size: CPU notebooks, and a
`spec.tpu` slice against a `spec.gpu` gang of the same host count (one
host: v5e 2x4 against eight H100s; two hosts: v4 2x2x2 against sixteen;
the tenancy modes' default one-host shapes: v5e 2x2 against four H100s,
four chips or GPUs each).  Every deterministic field of the two reports
is held equal once the device's names are read as one:

- the wall-clock fields (`wall_s`, `reconciles_per_sec`,
  `handoff_wall_s`, `peak_rss_mb`) and the event->reconcile reaction
  latency (`*_event_to_reconcile_s`), which the Manager measures on the
  wall clock, are never compared;
- the pool's kind (`TPUWarmPool`, `GPUWarmPool`) and the report's
  device key (`tpu`, `gpu`) are renamed;
- a GPU node is created and then labelled by the fake device plugin
  (an update and a status update), so the port's `Node` watch
  dispatches are the reference's plus those two events per GPU node.

Both sides' store stamps, `retry_on_conflict` sleeps and jitter run on
the FakeClock each mode makes, and each mode sets its own package's
tracing clock.  The 10k fleet and the 2000/10000 sharded sweep run under
`-m slow`.
"""

from __future__ import annotations

import importlib.util
import json
import random
import types
from pathlib import Path

import pytest

from kubeflow_tpu import kube as ref_kube
from kubeflow_tpu_torch import kube
from kubeflow_tpu_torch.loadtest import convergence as ours

ROOT = Path(__file__).resolve().parent.parent
BUDGETS = ROOT / "kubeflow_tpu_torch" / "loadtest" / "budgets"


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "reference_loadtest_convergence", ROOT / "loadtest" / "convergence.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _load_reference()

WALL = frozenset({"wall_s", "reconciles_per_sec", "handoff_wall_s",
                  "peak_rss_mb", "p50_event_to_reconcile_s",
                  "p99_event_to_reconcile_s"})
RENAMES = {"TPUWarmPool": "GPUWarmPool", "tpu": "gpu"}

# one host and two hosts: (reference --tpu, port --gpu)
SHAPES = {1: ("v5e:2x4", "h100-80gb:8"), 2: ("v4:2x2x2", "h100-80gb:16")}
TENANT_SHAPES = ("v5e:2x2", "h100-80gb:4")


@pytest.fixture(autouse=True)
def _on_the_fake_clock(monkeypatch):
    """Every FakeClock a mode makes takes over its package's store stamps
    (`kube/store.py:now_iso`, which the fake kubelet copies into
    `startedAt`); `retry_on_conflict` sleeps on that clock and draws its
    jitter from a seeded generator."""
    for mod, kmod in ((ref, ref_kube), (ours, kube)):
        base = mod.FakeClock

        class Clock(base):
            def __init__(self, *args, _kmod=kmod, **kwargs):
                super().__init__(*args, **kwargs)
                monkeypatch.setattr(_kmod.store, "now_iso", self.now_iso)
                monkeypatch.setattr(_kmod.errors, "time",
                                    types.SimpleNamespace(sleep=self.sleep))

        monkeypatch.setattr(mod, "FakeClock", Clock)
        monkeypatch.setattr(kmod.errors, "random", random.Random(0))


def canon(node, gpu_nodes: int = 0):
    """A report with the wall-clock fields dropped and the device's names
    read as the port's; `gpu_nodes` lifts the reference's Node dispatches
    by the port's two labelling events a GPU node."""
    def walk(x):
        if isinstance(x, dict):
            return {RENAMES.get(k, k): walk(v) for k, v in x.items()
                    if k not in WALL and k != "_state"}
        if isinstance(x, list):
            out = [walk(v) for v in x]
            # a sorted list of kinds stays sorted under the new names
            if x and all(isinstance(v, str) for v in x) and x == sorted(x):
                out.sort()
            return out
        if isinstance(x, str):
            return RENAMES.get(x, x)
        return x

    out = walk(node)
    dispatch = out.get("watch_dispatch")
    if dispatch is not None and gpu_nodes:
        dispatch["Node:delivered"] += 4 * gpu_nodes
        dispatch["Node:skipped"] += 2 * gpu_nodes
    return out


def _device(ref_report: dict, port_report: dict) -> None:
    """The device keys name their own package's shape; the rest is equal."""
    ref_report.pop("tpu", None)
    port_report.pop("gpu", None)


# -- run_fleet ---------------------------------------------------------------

@pytest.mark.parametrize("hosts", [0, 1, 2], ids=["cpu", "1host", "2host"])
def test_fleet_report_matches_the_reference(hosts):
    n = 20
    tpu, gpu = SHAPES.get(hosts, ("", ""))
    a = ref.run_fleet(n, 1, tpu=tpu)
    b = ours.run_fleet(n, 1, gpu=gpu)
    a8 = ref.run_fleet(n, 8, tpu=tpu)
    b8 = ours.run_fleet(n, 8, gpu=gpu)
    # --compare-workers: one worker and eight converge to one state (a
    # gang's pods read as their node pool, see normalized_state)
    assert b["_state"] == b8["_state"]
    if not hosts:
        assert a["_state"] == a8["_state"]
        # CPU notebooks render the same objects in both packages
        assert canon(a["_state"]) == canon(b["_state"])
    assert b["steady_write_verbs"] == 0
    assert b["criticalpath"]["conservation"]["violations"] == 0
    assert b["criticalpath"]["conservation"]["finalized"] == n
    for x, y in ((a, b), (a8, b8)):
        if hosts:
            _device(x, y)
        assert canon(y) == canon(x, gpu_nodes=n * hosts)


@pytest.mark.parametrize("gpu", ["", "h100-80gb:16"], ids=["cpu", "gang"])
def test_fleet_meets_the_ports_budget_through_the_cli(gpu, capsys):
    """`--count --compare-workers --check-budget` exits 0 with an
    identical state and every gate of the port's budget met; a gang
    fleet is held to the budget's `gang` section."""
    budget = BUDGETS / "apiserver_call_budget.json"
    argv = ["--count", "24", "--compare-workers", "8",
            "--check-budget", str(budget)]
    rc = ours.main(argv + (["--gpu", gpu] if gpu else []))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert out["budget_ok"] and out["compare"]["state_identical"]
    assert out["gpu"] == (gpu or "cpu")
    assert out["writes_per_notebook"]["Service"] == (2.0 if gpu else 1.0)


def test_a_gang_fleet_over_the_cpu_budget_fails():
    """The headless worker Service a gang adds is over the CPU budget's
    Service writes; only the `gang` section admits it."""
    budget = json.loads((BUDGETS / "apiserver_call_budget.json").read_text())
    gang = ours.run_fleet(4, 1, gpu="h100-80gb:8", compute_state=False)
    (failure,) = ours.check_budget(gang, budget)
    assert failure.startswith("writes/notebook[Service]: 2.0 > 1.0")
    assert ours.check_budget(gang, ours.gang_budget(budget)) == []


def test_check_budget_refuses_eleven_percent_over():
    budget = json.loads((BUDGETS / "apiserver_call_budget.json").read_text())
    within = {"writes_per_notebook": {"Notebook": 2.0 * 1.09},
              "reconciles_per_notebook": {"notebook": 2.0}, "wall_s": 0.0}
    over = {"writes_per_notebook": {"Notebook": 2.0 * 1.11},
            "reconciles_per_notebook": {"notebook": 2.0}, "wall_s": 0.0}
    assert ours.check_budget(within, budget) == []
    (failure,) = ours.check_budget(over, budget)
    assert failure.startswith("writes/notebook[Notebook]: 2.22 > 2.0")
    assert ref.check_budget(over, budget) == [failure]


def test_a_refused_gpu_shape_raises():
    """No quiet fallback to CPU notebooks: a count `resolve` refuses (12
    is more than one host and not whole hosts) and a malformed flag
    raise."""
    with pytest.raises(Exception, match="count 12"):
        ours.parse_gpu("h100-80gb:12")
    with pytest.raises(ValueError, match="ACCEL:COUNT"):
        ours.parse_gpu("h100-80gb")
    with pytest.raises(Exception, match="unknown accelerator"):
        ours.run_fleet(2, 1, gpu="v5e:8")


# -- the budgets -------------------------------------------------------------

@pytest.mark.parametrize("name", ["apiserver_call_budget.json",
                                  "warmpool_budget.json", "fleet_budget.json"])
def test_budgets_are_the_references(name):
    """The port's deterministic counts equal the reference's at the same
    shape, so its budgets hold the reference's numbers under the same
    keys (only the warm budget's prose comment names the port's
    command), and the call budget adds a `gang` section."""
    mine = json.loads((BUDGETS / name).read_text())
    theirs = json.loads((ROOT / "ci" / name).read_text())
    mine.pop("_comment", None)
    theirs.pop("_comment", None)
    gang = mine.pop("gang", None)
    assert mine == theirs
    if gang is not None:
        # the port's own section: the gang's counts, which equal the
        # reference's for a spec.tpu slice of one host (two Services)
        assert gang["writes_per_notebook"] == {
            **theirs["writes_per_notebook"], "Service": 2.0}
        assert gang["reconciles_per_notebook"] == \
            theirs["reconciles_per_notebook"]


# -- bursty ------------------------------------------------------------------

@pytest.mark.parametrize("hosts", [1, 2], ids=["1host", "2host"])
def test_bursty_matches_the_reference(hosts):
    tpu, gpu = SHAPES[hosts]
    reports = {}
    for warm in (2, 0):
        a = ref.run_bursty(4, 2, 300.0, tpu, warm)
        b = ours.run_bursty(4, 2, 300.0, gpu, warm)
        assert canon(b) == canon(a)
        reports[warm] = b
    warm, cold = reports[2], reports[0]
    assert warm["hits"] > 0 and cold["hits"] == 0
    assert ours.check_warm_budget(warm, cold, {"min_hit_rate": 0.5}) == []


# -- the sharded fleet -------------------------------------------------------

def test_sharded_fleet_matches_the_reference():
    a = ref.run_sharded_fleet(30, 3)
    b = ours.run_sharded_fleet(30, 3)
    assert canon(b) == canon(a)
    assert b["killed_shard"] and b["epoch"] > 1
    assert sum(b["keys_owned"].values()) == 30
    assert b["cross_process_overlaps"] == 0
    assert b["steady_data_plane_writes"] == 0


def test_sweep_names_its_knee(capsys):
    assert ours.main(["--sweep", "12,24", "--shards", "3"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["points"] == [12, 24] and out["gpu"] == "cpu"
    assert out["knee"]["count"] == 24
    assert all(r["binding_stage"] == "queue_wait" for r in out["sweep"])


# -- tenancy -----------------------------------------------------------------

def test_tenants_match_the_reference():
    """Four tenants of one notebook each is the smallest fleet whose
    flood the detector flags."""
    tpu, gpu = TENANT_SHAPES
    a = ref.run_tenants(4, 1, 1, tpu)
    b = ours.run_tenants(4, 1, 1, gpu)
    assert a["tpu"] == tpu and b["gpu"] == gpu
    _device(a, b)
    assert canon(b) == canon(a)
    assert b["flagged_during_flood"] == ["tenant-1"]
    assert b["noisy_warning_events"] == 1
    assert ours.check_tenant_budget(b, {}) == []


def test_priorities_match_the_reference():
    tpu, gpu = TENANT_SHAPES
    a = ref.run_priorities(1, 1, 1, 1, tpu)
    b = ours.run_priorities(1, 1, 1, 1, gpu)
    _device(a, b)
    assert canon(b) == canon(a)
    assert b["evicted_victims"] == b["restored_victims"] == 1
    assert ours.check_priorities_budget(b, {"min_evictions": 1}) == []


# -- fleet scale (-m slow) ---------------------------------------------------

@pytest.mark.slow
def test_ten_thousand_notebooks_within_the_fleet_budget(capsys):
    rc = ours.main(["--count", "10000", "--check-budget",
                    str(BUDGETS / "fleet_budget.json")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["budget_ok"]


@pytest.mark.slow
def test_sharded_scale_sweep_within_its_points(capsys):
    rc = ours.main(["--sweep", "2000,10000", "--shards", "5",
                    "--check-budget", str(BUDGETS / "fleet_budget.json"),
                    "--budget-section", "sharded_100k"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert all(r["budget_ok"] for r in out["sweep"])
