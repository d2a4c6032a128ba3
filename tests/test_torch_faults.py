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
- A convergence soak of tests/test_chaos.py::TestChaosSoak: its 20
  rounds of `random_fault_plan` from its seed, each with a perturbation,
  on the reference's `spec.tpu` slice of 4 hosts (v5e 4x4) and the port's
  `spec.gpu` gang of 4 hosts (32 H100s), with the ODH plane on.  Every
  plan's log (the workers' NetworkPolicy read under the port's device
  word), the perturbations, the steady state after each round and the
  apiserver's verb counts must be equal.
- The diagnosis engine's `explain` on a notebook whose Service creates a
  real plan failed with 503s: the cause is the fault injection, its
  evidence names the plan's rule, and the two packages' answers are
  equal once trace and span ids are read as one token.

The clocks are fake and the plans seeded, so no tolerance applies.  No
process is launched."""

from __future__ import annotations

import contextlib
import random
import re
import types

import pytest
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
# tests/test_chaos.py's FAULT_KINDS
FAULT_KINDS = ("Notebook", "StatefulSet", "Pod", "Service", "HTTPRoute",
               "NetworkPolicy", "ConfigMap", "Secret", "ServiceAccount",
               "Event")


class Side:
    """One package's soak stack: the core and ODH controllers on a
    FakeClock over a cluster with room for one 4-host gang."""

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

    def perturb(self, rng: random.Random, name: str) -> str:
        """tests/test_chaos.py's TestChaosSoak._perturb, exempt from the
        plan."""
        api, kind = self.api, rng.choice(
            ["kill_pod", "fail_pod", "delete_route", "touch", "none"])
        with api.fault_exempt():
            if kind == "kill_pod":
                api.delete("Pod", "user1", f"{name}-{rng.randrange(HOSTS)}")
            elif kind == "fail_pod":
                self.cluster.fail_pod("user1",
                                      f"{name}-{rng.randrange(HOSTS)}")
            elif kind == "delete_route":
                api.delete("HTTPRoute", CENTRAL_NS, f"nb-user1-{name}")
            elif kind == "touch":
                nb = api.get("Notebook", "user1", name)
                nb.metadata.annotations["chaos/touch"] = str(rng.random())
                api.update(nb)
            if kind == "fail_pod":
                nb = api.get("Notebook", "user1", name)
                nb.metadata.annotations[
                    self.C.ANNOTATION_NOTEBOOK_RESTART] = "true"
                api.update(nb)
        return kind

    def steady(self, name: str) -> dict:
        status = self.api.get("Notebook", "user1", name).body.get(
            "status", {})
        routes = self.api.list(
            "HTTPRoute", namespace=CENTRAL_NS,
            label_selector={self.OC.NOTEBOOK_NAME_LABEL: name,
                            self.OC.NOTEBOOK_NAMESPACE_LABEL: "user1"})
        return {"readyReplicas": status.get("readyReplicas"),
                "sliceHealth": status.get("sliceHealth"),
                "routes": sorted(r.name for r in routes)}


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


def _first_difference(ref: dict, ours: dict) -> str:
    """The first round and key that differ, or the verbs that do."""
    for i, (a, b) in enumerate(zip(ref["rounds"], ours["rounds"])):
        for key in a:
            if a[key] != b.get(key):
                return f"round {i}, {key}: reference {a[key]!r}, port " \
                       f"{b.get(key)!r}"
    if len(ref["rounds"]) != len(ours["rounds"]):
        return f"rounds: {len(ref['rounds'])} != {len(ours['rounds'])}"
    a, b = dict(ref["verbs"]), dict(ours["verbs"])
    return "verbs (reference, port): " + ", ".join(
        f"{v}: {a.get(v)}, {b.get(v)}" for v in sorted(a.keys() | b.keys())
        if a.get(v) != b.get(v))


def _soak(side: Side) -> dict:
    with _on_the_side_clock(side):
        side.create("soak", "user1")
        rng = random.Random(SOAK_SEED)
        rounds = []
        for _ in range(SOAK_ROUNDS):
            plan = side.kube.random_fault_plan(
                rng.randrange(2**31), kinds=FAULT_KINDS, clock=side.clock)
            side.api.install_fault_plan(plan)
            perturbation = side.perturb(rng, "soak")
            with side.api.fault_exempt():
                side.mgr.enqueue_all()
            side.mgr.settle(max_seconds=7200.0)
            side.api.clear_fault_plan()
            with side.api.fault_exempt():
                side.mgr.enqueue_all()
            side.mgr.settle(max_seconds=7200.0)
            rounds.append({
                "perturbation": perturbation,
                # the workers' NetworkPolicy is named for the device
                "faults": [(r.rule, r.action, r.verb, r.kind, r.namespace,
                            r.name.replace("-tpu-workers", "-gpu-workers"),
                            r.seq) for r in plan.log],
                "dropped": sorted(map(str, side.mgr.dropped_errors)),
                "steady": side.steady("soak")})
        return {"rounds": rounds,
                "verbs": sorted(side.api.verb_counts().items())}


def test_random_fault_soak_converges_as_the_reference():
    ref, ours = _soak(Side(False)), _soak(Side(True))
    assert ours == ref, _first_difference(ref, ours)
    assert sum(len(r["faults"]) for r in ours["rounds"]) > SOAK_ROUNDS
    for r in ours["rounds"]:
        assert r["dropped"] == []
        assert r["steady"]["readyReplicas"] == HOSTS
        assert r["steady"]["sliceHealth"] in ("Healthy", "Stopped")
        assert len(r["steady"]["routes"]) == 1


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
