"""The port's patch verbs against the reference's.

RFC 6902 JSON patch (`kube/jsonpatch.py`), strategic merge patch
(`kube/strategicmerge.py`) and server-side apply (`kube/apply.py` with
`ApiServer.apply`), and the four store verbs built on them.

- The cases of tests/test_apply.py (24), tests/test_strategicmerge.py
  (24) and tests/test_realcluster.py::TestJsonPatch (6) run as twins:
  each case's source is executed once against each package (the port's
  copy with the package name swapped, and a `Notebook.new` that takes
  the reference's arguments; see `twin_modules`), so the reference's
  own assertions hold on both.  Every value the case's patch functions
  return, and every ApiServer's objects, audit log and verb counts at its
  end, must then be equal, once uids and wall-clock stamps are read as
  tokens.  A case whose controllers run on threads (the applied notebook
  reconciled over the wire) keeps the assertions and compares no state:
  its write order is the scheduler's.
- Seeded random documents go through both packages' `diff`,
  `apply_patch` and `strategic_merge`, with equal outputs.
- The four store verbs in one sequence on both ApiServers: objects,
  resourceVersion, generation, `managedFields`, the audit log and the
  verb counts equal.

`twin_modules` and `run_twins` are shared with tests/test_torch_faults.py
and tests/test_torch_wire.py.  The functions are plain Python, so no
tolerance applies.  No process is launched."""

from __future__ import annotations

import contextlib
import copy
import inspect
import random
import re
import types
from pathlib import Path
from typing import Callable, Optional

import pytest

import kubeflow_tpu.kube as ref_kube
import kubeflow_tpu_torch.kube as port_kube
from kubeflow_tpu.kube import jsonpatch as ref_jsonpatch
from kubeflow_tpu.kube import strategicmerge as ref_smp
from kubeflow_tpu_torch.api import types as port_types
from kubeflow_tpu_torch.kube import jsonpatch as port_jsonpatch
from kubeflow_tpu_torch.kube import strategicmerge as port_smp

TESTS = Path(__file__).resolve().parent
SIDES = ("reference", "port")
KUBE = {"reference": ref_kube, "port": port_kube}
# stamps a case cannot fix: wall-clock times, and names, uids and
# resourceVersions read back from another process's clock
_VOLATILE = {"creationTimestamp", "deletionTimestamp", "time", "renewTime",
             "acquireTime", "lastTransitionTime", "firstTimestamp",
             "lastTimestamp", "eventTime", "lastHeartbeatTime"}


def _port_notebook(KubeObject):
    """`Notebook` for the port's copy of a reference case: `new` takes
    the reference's arguments (`version`; `tpu` has no port twin and is
    refused) and returns `.obj` as a KubeObject, as the reference's
    does."""
    class Notebook:
        @staticmethod
        def new(name, namespace, pod_spec=None, tpu=None, version=None,
                **kw):
            assert tpu is None, "a spec.tpu case needs a twin of its own"
            d = port_types.Notebook.new(name, namespace, pod_spec, **kw).obj
            if version is not None:
                d["apiVersion"] = f"{port_types.GROUP}/{version}"
            return types.SimpleNamespace(obj=KubeObject.from_dict(d))
    return Notebook


def twin_modules(filename: str,
                 port_lines: Optional[dict] = None) -> dict:
    """tests/`filename` executed once against each package: {side:
    module}.  The port's copy has `kubeflow_tpu` swapped for
    `kubeflow_tpu_torch`, then each line in `port_lines` replaced, and its
    `Notebook` is the reference's signature over the port's types."""
    src = (TESTS / filename).read_text()
    out = {}
    for side in SIDES:
        text = src
        if side == "port":
            text = re.sub(r"\bkubeflow_tpu\b", "kubeflow_tpu_torch", text)
            for old, new in (port_lines or {}).items():
                assert old in text, old
                text = text.replace(old, new)
        mod = types.ModuleType(f"twin_{side}_{Path(filename).stem}")
        mod.__file__ = str(TESTS / filename)
        exec(compile(text, str(TESTS / filename), "exec"), mod.__dict__)
        if side == "port":
            mod.Notebook = _port_notebook(port_kube.KubeObject)
        out[side] = mod
    return out


def case_ids(mod, classes: Optional[tuple] = None) -> list:
    """"Class::test_x" for every test method (of `classes` when given),
    and "test_x" for module-level test functions, in source order."""
    ids = []
    for name, obj in vars(mod).items():
        if inspect.isclass(obj) and name.startswith("Test") and (
                classes is None or name in classes):
            ids += [f"{name}::{m}" for m in vars(obj)
                    if m.startswith("test_")]
        elif classes is None and inspect.isfunction(obj) \
                and name.startswith("test_"):
            ids.append(name)
    return ids


def _fixture_function(fx):
    get = getattr(fx, "_get_wrapped_function", None)
    return get() if get else fx.__pytest_wrapped__.obj


def _call(fn, inst, mod, stack, tmp_path, bound: bool):
    """fn with its arguments resolved as pytest would: monkeypatch,
    tmp_path, and the case's own class and module fixtures (generator
    fixtures finalized when `stack` closes)."""
    kwargs = {}
    params = list(inspect.signature(fn).parameters)
    if not bound and params and params[0] == "self":
        params = params[1:]
    for name in params:
        if name == "monkeypatch":
            kwargs[name] = stack.enter_context(pytest.MonkeyPatch.context())
        elif name == "tmp_path":
            kwargs[name] = tmp_path
        else:
            fx = getattr(type(inst), name, None) if inst is not None \
                else None
            owner = inst if fx is not None else None
            fx = fx if fx is not None else getattr(mod, name)
            raw = _fixture_function(fx)
            if owner is not None:
                raw = raw.__get__(owner)
            value = _call(raw, owner, mod, stack, tmp_path, True)
            if inspect.isgenerator(value):
                gen = value
                value = next(gen)
                stack.callback(lambda g=gen: next(g, None))
            kwargs[name] = value
    return fn(**kwargs)


def normalize(value, tokens: dict):
    """`value` with uids as tokens in the order they first appear and
    wall-clock stamps blanked."""
    if isinstance(value, dict):
        out = {}
        for k in sorted(value, key=str):
            v = value[k]
            if k in _VOLATILE and v:
                out[k] = "<t>"
            elif k == "uid" and isinstance(v, str) and v:
                out[k] = tokens.setdefault(v, f"<uid{len(tokens)}>")
            else:
                out[k] = normalize(v, tokens)
        return out
    if isinstance(value, (list, tuple)):
        return [normalize(v, tokens) for v in value]
    return value


class Recorder:
    """What one side's run of a case produced: the return values (or
    raised errors) of the wrapped functions, every ApiServer built, and
    every FaultPlan's log (trace ids, random on each side, read as
    present or not)."""

    def __init__(self):
        self.calls: list = []
        self.stores: list = []
        self.plans: list = []

    def wrap(self, name: str, fn: Callable) -> Callable:
        def recorded(*args, **kwargs):
            try:
                out = fn(*args, **kwargs)
            except Exception as err:
                self.calls.append((name, "raised", type(err).__name__,
                                   str(err)))
                raise
            if inspect.isgenerator(out):
                out = list(out)
                self.calls.append((name, copy.deepcopy(out)))
                return iter(out)
            self.calls.append((name, copy.deepcopy(out)))
            return out
        return recorded

    def state(self) -> dict:
        tokens: dict = {}
        stores = []
        for api in self.stores:
            with api.fault_exempt():
                dump = api.dump()
            stores.append({
                "objects": dump, "rv": api.resource_version,
                "audit": [(r.verb, r.kind, r.namespace, r.name, r.ok,
                           r.error, r.rv) for r in api.audit_log()],
                "verbs": sorted(api.verb_counts().items()),
                "tenant_verbs": sorted(api.tenant_verb_counts().items())})
        plans = [[(r.rule, r.action, r.verb, r.kind, r.namespace, r.name,
                   r.seq, bool(r.trace_id)) for r in plan.log]
                 for plan in self.plans]
        return normalize({"calls": self.calls, "stores": stores,
                          "plans": plans}, tokens)


def run_case(mod, case: str, side: str, tmp_path: Path,
             record: tuple = ()) -> dict:
    """Run one case of `mod` on `side`, with the names in `record`
    wrapped in its globals; returns the Recorder's state."""
    rec = Recorder()
    cls_name, _, meth = case.rpartition("::")
    inst = getattr(mod, cls_name)() if cls_name else None
    fn = getattr(inst, meth) if inst is not None else getattr(mod, meth)
    side_tmp = tmp_path / side
    side_tmp.mkdir()

    def registering(cls, into: list):
        init = cls.__init__

        def register(self, *args, **kwargs):
            init(self, *args, **kwargs)
            into.append(self)
        return register

    # backoff jitter draws from the global generator: both sides draw the
    # same numbers, and the caller's state comes back
    saved = random.getstate()
    random.seed(0)
    with contextlib.ExitStack() as stack:
        stack.callback(random.setstate, saved)
        mp = stack.enter_context(pytest.MonkeyPatch.context())
        for cls, into in ((KUBE[side].ApiServer, rec.stores),
                          (KUBE[side].FaultPlan, rec.plans)):
            mp.setattr(cls, "__init__", registering(cls, into))
        for name in record:
            if name in mod.__dict__:
                mp.setitem(mod.__dict__, name, rec.wrap(name,
                                                        mod.__dict__[name]))
        if inst is not None and hasattr(inst, "setup_method"):
            inst.setup_method(fn)
        _call(fn, inst, mod, stack, side_tmp, True)
    return rec.state()


def run_twins(mods: dict, case: str, tmp_path: Path, record: tuple = (),
              compare: bool = True) -> dict:
    """The case on both sides; with `compare`, their recorded outputs
    must be equal.  Returns {side: state}."""
    states = {side: run_case(mods[side], case, side, tmp_path, record)
              for side in SIDES}
    if compare:
        assert states["port"] == states["reference"], case
    return states


# -- the reference's cases -----------------------------------------------------

APPLY = twin_modules("test_apply.py")
SMP = twin_modules("test_strategicmerge.py")
REALCLUSTER = twin_modules("test_realcluster.py")
RECORD = ("field_set", "leaf_paths", "strategic_merge", "diff",
          "apply_patch")
# controllers on threads: the assertions hold, the write order is the
# scheduler's
THREADED = {"TestApplyOverTheWire::test_controllers_tolerate_applied_notebooks"}


@pytest.mark.parametrize("case", case_ids(APPLY["reference"]))
def test_apply_cases_match_the_reference(case, tmp_path):
    run_twins(APPLY, case, tmp_path, RECORD, compare=case not in THREADED)


@pytest.mark.parametrize("case", case_ids(SMP["reference"]))
def test_strategic_merge_cases_match_the_reference(case, tmp_path):
    run_twins(SMP, case, tmp_path, RECORD)


@pytest.mark.parametrize("case", case_ids(REALCLUSTER["reference"],
                                          ("TestJsonPatch",)))
def test_json_patch_cases_match_the_reference(case, tmp_path):
    run_twins(REALCLUSTER, case, tmp_path, RECORD)


def test_case_counts():
    assert len(case_ids(APPLY["reference"])) == 24
    assert len(case_ids(SMP["reference"])) == 24
    assert len(case_ids(REALCLUSTER["reference"], ("TestJsonPatch",))) == 6


# -- seeded random documents ---------------------------------------------------

def _random_value(rng: random.Random, depth: int):
    roll = rng.random()
    if depth <= 0 or roll < 0.35:
        return rng.choice([rng.randint(0, 9), f"s{rng.randint(0, 5)}",
                           True, None, "a/b~c"])
    if roll < 0.55:
        return [_random_value(rng, depth - 1)
                for _ in range(rng.randint(0, 4))]
    return {rng.choice(["a", "b", "c", "a/b", "m~n", "x"]):
            _random_value(rng, depth - 1) for _ in range(rng.randint(0, 4))}


def _random_podspec(rng: random.Random) -> dict:
    """A pod-spec-shaped document: keyed lists (containers, env, ports,
    volumeMounts), an atomic list (args) and maps."""
    return {"metadata": {"labels": {f"l{i}": str(rng.randint(0, 3))
                                    for i in range(rng.randint(0, 3))}},
            "spec": {"replicas": rng.randint(0, 3),
                     "args": [f"--{i}" for i in range(rng.randint(0, 3))],
                     "template": {"spec": {"containers": [
                         {"name": f"c{i}", "image": f"img:{rng.randint(0, 2)}",
                          "env": [{"name": f"E{j}",
                                   "value": str(rng.randint(0, 2))}
                                  for j in rng.sample(range(4),
                                                      rng.randint(0, 3))],
                          "ports": [{"containerPort": 8000 + j,
                                     "protocol": "TCP"}
                                    for j in range(rng.randint(0, 2))],
                          "volumeMounts": [{"mountPath": f"/m{j}",
                                            "name": f"v{j}"}
                                           for j in range(rng.randint(0, 2))]}
                         for i in rng.sample(range(4),
                                             rng.randint(1, 3))]}}}}


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as err:
        return ("raised", type(err).__name__, str(err))


@pytest.mark.parametrize("seed", range(4))
def test_random_documents_patch_alike(seed):
    rng = random.Random(seed)
    for _ in range(50):
        old, new = _random_value(rng, 3), _random_value(rng, 3)
        if not isinstance(old, dict) or not isinstance(new, dict):
            continue
        ops = ref_jsonpatch.diff(old, new)
        assert port_jsonpatch.diff(old, new) == ops
        assert port_jsonpatch.apply_patch(old, ops) == \
            ref_jsonpatch.apply_patch(old, ops) == new
        assert _outcome(port_smp.strategic_merge, old, new) == \
            _outcome(ref_smp.strategic_merge, old, new)
    for _ in range(30):
        base, patch = _random_podspec(rng), _random_podspec(rng)
        # directives on a random container and env entry
        containers = patch["spec"]["template"]["spec"]["containers"]
        if rng.random() < 0.5:
            containers[0]["$patch"] = "delete"
        if rng.random() < 0.3:
            patch["spec"]["$retainKeys"] = ["template", "replicas"]
        if rng.random() < 0.3:
            patch["spec"]["$deleteFromPrimitiveList/args"] = ["--0"]
        assert _outcome(port_smp.strategic_merge, base, patch) == \
            _outcome(ref_smp.strategic_merge, base, patch)
        ops = ref_jsonpatch.diff(base, patch)
        assert port_jsonpatch.diff(base, patch) == ops


# -- the four store verbs in one sequence --------------------------------------

def _verb_sequence(kube) -> dict:
    """Create a ConfigMap and a Notebook, then merge patch, strategic merge
    patch, apply by two managers (a 409, then force), JSON patch (one
    refused by a failed test op), and a no-op re-apply: the store's
    objects, rv, audit log and verb counts at the end."""
    api = kube.ApiServer()
    out = []
    api.create(kube.KubeObject.from_dict({
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": "cm", "namespace": "ns", "labels": {"a": "1"}},
        "data": {"k": "v"}}))
    nb = {"apiVersion": "kubeflow.org/v1", "kind": "Notebook",
          "metadata": {"name": "wb", "namespace": "ns"},
          "spec": {"template": {"spec": {"containers": [
              {"name": "wb", "image": "jupyter:1",
               "env": [{"name": "A", "value": "1"}]},
              {"name": "proxy", "image": "proxy:1"}]}}}}
    api.create(kube.KubeObject.from_dict(nb))
    steps = [
        lambda: api.merge_patch("ConfigMap", "ns", "cm", {
            "metadata": {"labels": {"a": None, "b": "2"}},
            "data": {"k2": "v2"}}),
        lambda: api.strategic_merge_patch("Notebook", "ns", "wb", {
            "spec": {"template": {"spec": {"containers": [
                {"name": "wb", "env": [{"name": "B", "value": "2"}]},
                {"name": "proxy", "$patch": "delete"}]}}}}),
        lambda: api.apply("Notebook", "ns", "wb", {
            "apiVersion": "kubeflow.org/v1", "kind": "Notebook",
            "metadata": {"name": "wb", "namespace": "ns",
                         "labels": {"team": "ml"}},
            "spec": {"template": {"spec": {"containers": [
                {"name": "wb", "image": "jupyter:2"}]}}}},
            field_manager="gitops"),
        lambda: api.apply("Notebook", "ns", "wb", {
            "apiVersion": "kubeflow.org/v1", "kind": "Notebook",
            "metadata": {"name": "wb", "namespace": "ns"},
            "spec": {"template": {"spec": {"containers": [
                {"name": "wb", "image": "jupyter:3"}]}}}},
            field_manager="dev"),
        lambda: api.apply("Notebook", "ns", "wb", {
            "apiVersion": "kubeflow.org/v1", "kind": "Notebook",
            "metadata": {"name": "wb", "namespace": "ns"},
            "spec": {"template": {"spec": {"containers": [
                {"name": "wb", "image": "jupyter:3"}]}}}},
            field_manager="dev", force=True),
        lambda: api.json_patch("Notebook", "ns", "wb", [
            {"op": "add", "path": "/metadata/annotations/x", "value": "y"},
            {"op": "replace", "path": "/spec/template/spec/containers/0/name",
             "value": "wb"}]),
        lambda: api.json_patch("Notebook", "ns", "wb", [
            {"op": "test", "path": "/metadata/annotations/x", "value": "z"},
            {"op": "remove", "path": "/metadata/annotations/x"}]),
        lambda: api.apply("ConfigMap", "ns", "cm2", {
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": "cm2", "namespace": "ns"},
            "data": {"z": "1"}}, field_manager="gitops"),
        lambda: api.apply("ConfigMap", "ns", "cm2", {
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": "cm2", "namespace": "ns"},
            "data": {"z": "1"}}, field_manager="gitops"),
    ]
    for step in steps:
        try:
            obj = step()
            out.append(("ok", obj.metadata.resource_version,
                        obj.metadata.generation, obj.to_dict()))
        except kube.ApiError as err:
            out.append(("raised", type(err).__name__, str(err)))
    rec = Recorder()
    rec.stores.append(api)
    rec.calls = out
    return rec.state()


def test_store_verbs_in_sequence_match_the_reference():
    ref, ours = _verb_sequence(ref_kube), _verb_sequence(port_kube)
    assert ours == ref
    outcomes = [step[0] for step in ours["calls"]]
    assert outcomes == ["ok", "ok", "ok", "raised", "ok", "ok", "raised",
                        "ok", "ok"]
    (store,) = ours["stores"]
    assert {(verb, kind) for (verb, kind), _ in store["verbs"]} >= {
        ("patch", "ConfigMap"), ("patch", "Notebook"), ("create", "Notebook")}
    assert [a[0] for a in store["audit"]].count("patch") == 9
