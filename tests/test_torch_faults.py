"""The port's fault plans against the reference's.

`kube/faults.py` (FaultRule, the seeded FaultPlan, random_fault_plan) and
the ApiServer's gate: verb errors, latency on the FakeClock, stale reads,
watch-stream drops and history resets.

- The cases of tests/test_faults.py (12) run as twins, as
  tests/test_torch_patch.py runs its reference cases: each case's source
  once against each package, the reference's assertions on both, and
  then every plan's log (rule, action, verb, kind, object, sequence),
  every ApiServer's objects, audit log and verb counts equal, once uids
  and wall-clock stamps are read as tokens.
- The convergence soak of tests/test_chaos.py::TestChaosSoak, through
  `kubeflow_tpu_torch.chaos.soaks.chaos_soak`: its 20 rounds of
  `random_fault_plan` from its seed, each with a perturbation, on the
  reference's `spec.tpu` slice of 4 hosts (v5e 4x4) and the port's
  `spec.gpu` gang of 4 hosts (32 H100s), with the ODH plane on.  Every
  plan's log, the perturbations, the steady state after each round, the
  ledgers' conservation and the apiserver's verb counts must be equal,
  once device names are read as one token.
- The diagnosis engine's `explain` on a notebook whose Service creates a
  real plan failed with 503s: the cause is the fault injection, its
  evidence names the plan's rule, and the two packages' answers are
  equal once trace and span ids are read as one token.

It also holds what tests/test_torch_chaos.py and
tests/test_torch_chaos_obs.py share: the reference's soak stack
(`ref_stack`), each side's clocks (`run_soak`), the tokens (`canon`) and
`_first_difference`.  The clocks are fake and the plans seeded, so no
tolerance applies.  No process is launched."""

from __future__ import annotations

import contextlib
import json
import random
import re
import types
from pathlib import Path

import pytest
import yaml
from test_torch_patch import case_ids, run_twins, twin_modules

from kubeflow_tpu import kube as ref_kube
from kubeflow_tpu.api.types import Notebook as RefNotebook
from kubeflow_tpu.api.types import TPUSpec
from kubeflow_tpu.core import constants as ref_constants
from kubeflow_tpu.core.notebook_controller import (
    setup_core_controllers as ref_setup,
)
from kubeflow_tpu.odh import constants as ref_odh_constants
from kubeflow_tpu.odh.controller import setup_odh_controllers as ref_odh
from kubeflow_tpu.utils import diagnosis as ref_diagnosis
from kubeflow_tpu.utils import flightrecorder as ref_flightrecorder
from kubeflow_tpu.utils import tracing as ref_tracing
from kubeflow_tpu.utils.clock import FakeClock as RefFakeClock
from kubeflow_tpu.utils.config import CoreConfig as RefConfig
from kubeflow_tpu.utils.config import OdhConfig as RefOdhConfig
from kubeflow_tpu_torch import kube
from kubeflow_tpu_torch.api.types import GPUSpec, Notebook
from kubeflow_tpu_torch.chaos import soaks
from kubeflow_tpu_torch.core import constants
from kubeflow_tpu_torch.core.notebook_controller import setup_core_controllers
from kubeflow_tpu_torch.odh import constants as odh_constants
from kubeflow_tpu_torch.odh.controller import setup_odh_controllers
from kubeflow_tpu_torch.utils import diagnosis, flightrecorder, tracing
from kubeflow_tpu_torch.utils.clock import FakeClock
from kubeflow_tpu_torch.utils.config import CoreConfig, OdhConfig

FAULTS = twin_modules("test_faults.py")


@pytest.mark.parametrize("case", case_ids(FAULTS["reference"]))
def test_fault_cases_match_the_reference(case, tmp_path):
    run_twins(FAULTS, case, tmp_path)


def test_case_count():
    assert len(case_ids(FAULTS["reference"])) == 12


# -- the chaos soak --------------------------------------------------------------

CENTRAL_NS = "opendatahub"
HOSTS = 4
# tests/test_chaos.py's defaults
SOAK_SEED, SOAK_ROUNDS = 20260804, 20


class Side:
    """One package's stack for `explain`: the core and ODH controllers on
    a FakeClock over a cluster with room for one 4-host gang."""

    def __init__(self, port: bool):
        self.port = port
        self.kube = kube if port else ref_kube
        self.C = constants if port else ref_constants
        self.OC = odh_constants if port else ref_odh_constants
        self.tracing = tracing if port else ref_tracing
        self.clock = (FakeClock if port else RefFakeClock)()
        self.api = self.kube.ApiServer()
        self.cluster = self.kube.FakeCluster(self.api)
        self.cluster.add_node("cpu-node",
                              allocatable={"cpu": "64", "memory": "256Gi"})
        if port:
            self.cluster.add_gpu_nodes("h100-80gb", HOSTS, 8)
        else:
            self.cluster.add_tpu_slice_nodes("tpu-v5-lite-podslice", "4x4",
                                             HOSTS, 4)
        recorder = (flightrecorder if port else ref_flightrecorder)
        self.mgr = self.kube.Manager(
            self.api, clock=self.clock,
            flight_recorder=recorder.FlightRecorder(capacity=4096,
                                                    per_object=1024))
        (setup_core_controllers if port else ref_setup)(
            self.mgr, (CoreConfig if port else RefConfig)())
        (setup_odh_controllers if port else ref_odh)(
            self.mgr, (OdhConfig if port else RefOdhConfig)(
                controller_namespace=CENTRAL_NS))

    def create(self, name: str, ns: str) -> None:
        annotations = {self.OC.ANNOTATION_INJECT_AUTH: "true"}
        if self.port:
            self.api.create(kube.KubeObject.from_dict(Notebook.new(
                name, ns, gpu=GPUSpec("h100-80gb", 8 * HOSTS),
                annotations=annotations).obj))
        else:
            self.api.create(RefNotebook.new(
                name, ns, tpu=TPUSpec("v5e", "4x4"),
                annotations=annotations).obj)
        self.mgr.run_until_idle()


@contextlib.contextmanager
def _on_the_side_clock(side: Side):
    """Take the soak's wall-clock sources off the wall, onto the side's
    FakeClock.

    - The tracer's clock.
    - The store stamps creation and deletion times with the real clock at
      one-second resolution, and the fake kubelet copies a pod's creation
      stamp into its container's `startedAt`, which the notebook's status
      mirrors: a recreated pod that lands in another wall second forces
      one more status write (a get and an update of the Notebook).
    - `retry_on_conflict` sleeps in wall time with jitter from the
      process-wide `random`: each side draws from its own seeded
      generator, and the wait passes on its FakeClock."""
    side.tracing.set_clock(side.clock)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(side.kube.store, "now_iso", side.clock.now_iso)
            mp.setattr(side.kube.errors, "random", random.Random(SOAK_SEED))
            mp.setattr(side.kube.errors, "time",
                       types.SimpleNamespace(sleep=side.clock.sleep))
            yield
    finally:
        side.tracing.set_clock(None)


# -- what the soak twins share --------------------------------------------

ROOT = Path(__file__).resolve().parent.parent


def ref_stack() -> types.SimpleNamespace:
    """The reference's control plane as a `chaos.soaks` stack: its gangs
    are v5e 4x4 slices (4 hosts of 4 chips), a notebook of several gangs
    a notebook of several slices."""
    import kubeflow_tpu.ops.diagnose as ref_diagnose
    from kubeflow_tpu import main as ref_main
    from kubeflow_tpu.api.types import ReplicationSpec
    from kubeflow_tpu.core import metrics as ref_metrics
    from kubeflow_tpu.core import preemption as ref_preemption
    from kubeflow_tpu.core import sessionstate as ref_sessionstate
    from kubeflow_tpu.core import telemetry as ref_telemetry
    from kubeflow_tpu.models.configs import LLAMA2_350M
    from kubeflow_tpu.utils import lifecycle as ref_lifecycle
    from kubeflow_tpu.utils import metering as ref_metering
    from kubeflow_tpu.utils import profiler as ref_profiler
    from kubeflow_tpu.utils import slo as ref_slo
    from kubeflow_tpu.utils import tsdb as ref_tsdb

    def gang_notebook(name, ns, hosts, gangs=1, priority=None,
                      replication=None, annotations=None):
        assert hosts in (0, HOSTS), hosts
        nb = RefNotebook.new(
            name, ns, tpu=TPUSpec("v5e", "4x4", gangs) if hosts else None,
            annotations=annotations, replication=replication)
        if priority is not None:
            nb.obj.spec["priority"] = priority
        return nb.obj

    def gang_demand(hosts, gangs):
        shape = TPUSpec("v5e", "4x4", gangs).shape
        return shape, gangs * float(shape.chips)

    return types.SimpleNamespace(
        kube=ref_kube, C=ref_constants, OC=ref_odh_constants,
        CoreConfig=RefConfig, OdhConfig=RefOdhConfig,
        setup_core_controllers=ref_setup, setup_odh_controllers=ref_odh,
        metrics=ref_metrics, placement_units=ref_metrics.placement_chips,
        FakeClock=RefFakeClock,
        FlightRecorder=ref_flightrecorder.FlightRecorder,
        tracing=ref_tracing, lifecycle=ref_lifecycle,
        metering=ref_metering, sessionstate=ref_sessionstate,
        preemption=ref_preemption, slo=ref_slo, profiler=ref_profiler,
        diagnose=ref_diagnose, diagnosis=ref_diagnosis, tsdb=ref_tsdb,
        telemetry=ref_telemetry, serve_http=ref_main.serve_http,
        build_sharded_fleet=ref_main.build_sharded_fleet,
        LLAMA2_350M=LLAMA2_350M, ReplicationSpec=ReplicationSpec,
        knowledge=lambda: yaml.safe_load(
            (ROOT / "chaos" / "knowledge" / "workbenches.yaml").read_text()),
        fleet_budget=lambda: json.loads(
            (ROOT / "ci" / "fleet_budget.json").read_text()),
        telemetry_kw={"num_chips": 4},
        gang_notebook=gang_notebook,
        add_gang_nodes=lambda cluster, hosts, pool=None:
            cluster.add_tpu_slice_nodes("tpu-v5-lite-podslice", "4x4",
                                        hosts, 4, pool=pool),
        gang_demand=gang_demand, view=RefNotebook)


class CurrentClock:
    """The FakeClock a soak made last.  A soak makes a clock for each
    environment it builds; the store's stamps, the tracer and the conflict
    retries read whichever is current."""

    def __init__(self, cls):
        self.cls = cls
        self.clock = cls()

    def make(self):
        self.clock = self.cls()
        return self.clock

    def now(self) -> float:
        return self.clock.now()

    def monotonic(self) -> float:
        return self.clock.monotonic()

    def now_iso(self) -> str:
        return self.clock.now_iso()

    def sleep(self, seconds: float) -> None:
        self.clock.sleep(seconds)


def run_soak(fn, port: bool, rounds=None) -> dict:
    """`fn` of `chaos.soaks` on one side's stack with one worker, every
    wall-clock source on the side's FakeClocks."""
    stack = soaks.port_stack() if port else ref_stack()
    clock = CurrentClock(stack.FakeClock)
    stack.FakeClock = clock.make
    side = types.SimpleNamespace(kube=stack.kube, tracing=stack.tracing,
                                 clock=clock)
    with _on_the_side_clock(side):
        return fn(stack, SOAK_SEED, rounds, workers=1)


_TOKENS = (
    (re.compile(r"\b[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                r"[0-9a-f]{12}\b"), "<uid>"),
    (re.compile(r"(?<![\d.])\b[0-9a-f]{16}(?:[0-9a-f]{16})?\b"), "<id>"),
    (re.compile(r"127\.0\.0\.1:\d+"), "127.0.0.1:<port>"),
    (re.compile(r"-[tg]pu-"), "-<device>-"),
)


def canon(record: dict) -> dict:
    """A soak's record with uids, trace and span ids, HTTP ports and the
    device word of `-tpu-`/`-gpu-` names read as tokens; wall-clock
    readings (`wall`) are held on each side and never compared."""
    text = json.dumps({k: v for k, v in record.items() if k != "wall"},
                      sort_keys=True, default=str)
    for pattern, token in _TOKENS:
        text = pattern.sub(token, text)
    return json.loads(text)


def _first_difference(ref, ours, path: str = "record") -> str:
    """Where two records first differ: the round and key, as a path."""
    if isinstance(ref, dict) and isinstance(ours, dict):
        for key in list(ref) + [k for k in ours if k not in ref]:
            if key not in ref or key not in ours:
                return f"{path}.{key}: only in the " + (
                    "port" if key in ours else "reference")
            if ref[key] != ours[key]:
                return _first_difference(ref[key], ours[key],
                                         f"{path}.{key}")
    if isinstance(ref, list) and isinstance(ours, list):
        for i, (a, b) in enumerate(zip(ref, ours)):
            if a != b:
                return _first_difference(a, b, f"{path}[{i}]")
        if len(ref) != len(ours):
            return f"{path}: {len(ref)} items != {len(ours)}"
    return f"{path}: reference {ref!r}, port {ours!r}"


def twins(fn, rounds=None) -> tuple:
    """`fn` on both stacks, each record read through `canon`."""
    return (canon(run_soak(fn, False, rounds)),
            canon(run_soak(fn, True, rounds)))


def test_random_fault_soak_converges_as_the_reference():
    ref, ours = twins(soaks.chaos_soak, SOAK_ROUNDS)
    assert ours == ref, _first_difference(ref, ours)
    assert sum(len(r["faults"]) for r in ours["rounds"]) > SOAK_ROUNDS
    for r in ours["rounds"]:
        assert r["dropped"] == []
        assert r["steady"]["readyReplicas"] == HOSTS
        assert r["steady"]["sliceHealth"] in ("Healthy", "Stopped")
        assert len(r["steady"]["routes"]) == 1
    assert ours["lifecycle"]["violations"] == 0
    assert ours["metering"]["violations"] == 0


# -- explain names a real plan's faults ----------------------------------------

def _explain(port: bool) -> dict:
    side = Side(port)
    dx = diagnosis if port else ref_diagnosis
    engine = dx.DiagnosisEngine(side.clock, recorder=side.mgr.flight_recorder,
                                api=side.api)
    side.mgr.diagnosis = engine
    saved = random.getstate()
    random.seed(SOAK_SEED)
    side.tracing.set_clock(side.clock)
    try:
        side.create("faulty", "user1")
        plan = side.kube.FaultPlan([side.kube.FaultRule(
            verbs=("create",), kinds=("Service",), error="unavailable",
            max_matches=3, name="diag-api")], clock=side.clock)
        with side.api.fault_exempt():
            side.api.delete("Service", "user1", "faulty")
        side.api.install_fault_plan(plan)
        with side.api.fault_exempt():
            side.mgr.enqueue_all()
        side.mgr.settle(max_seconds=7200.0)
        side.api.clear_fault_plan()
        verdict = engine.explain("user1", "faulty")
    finally:
        side.tracing.set_clock(None)
        random.setstate(saved)
    text = re.sub(r"\b[0-9a-f]{16,32}\b", "<id>", repr(verdict))
    return {"log": [(r.rule, r.action, r.verb, r.kind, r.name)
                    for r in plan.log],
            "cause": verdict["cause"], "verdict": text,
            "cause_name": dx.CAUSE_FAULT_INJECTION}


def test_explain_names_a_real_plans_faults():
    ref, ours = _explain(False), _explain(True)
    assert ours == ref
    assert len(ours["log"]) == 3
    assert ours["cause"] == ours["cause_name"]
    assert "diag-api" in ours["verdict"]
