"""The port's deploy manifests and Notebook schema against the reference's.

`kubeflow_tpu_torch/deploy/manifests.py` renders the three profiles
(kubeflow, openshift, standalone) the reference renders, and
`kubeflow_tpu_torch/api/validation.py` is the structural schema hook
`setup_core_controllers` installs:

- every profile's documents equal the reference's once the reference's
  are read with the port's names for what is the device's: the Notebook
  CRD's `spec.tpu` block for the port's `spec.gpu`, `spec.priority` and
  `spec.replication` (as api/types.py defines them), the warm pool's
  kind and its `topology` for `count`, the image variable and default,
  and the manager's module; the ClusterRole adds the rules for the kinds
  the port's controllers read that the reference's role leaves out;
- `validate_docs` passes on all three profiles, the YAML round-trips, and
  `python -m kubeflow_tpu_torch.deploy` prints what `render_yaml` gives;
- every kind a fully wired manager watches (slice scheduler, culling and
  the ODH plane on), the shard map and the Lease has a rule that lets it
  be listed and watched;
- a table of CRs goes through both packages' schema hooks
  (`install_notebook_schema` alone on an ApiServer) with the same verdict
  and, where the reference refuses, the same message (its device's name
  read as the port's where the check is the device's own); through the
  port's full admission (`setup_core_controllers`) each CR is refused
  once, with the schema hook's message, and `spec.tpu` is refused only
  after the schema admitted it.

The renders are plain data, so no tolerance applies."""

from __future__ import annotations

import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from kubeflow_tpu import kube as ref_kube
from kubeflow_tpu.api import validation as ref_validation
from kubeflow_tpu.api.types import Notebook as RefNotebook
from kubeflow_tpu.api.types import ReplicationSpec as RefReplicationSpec
from kubeflow_tpu.api.types import TPUSpec
from kubeflow_tpu.deploy import manifests as ref_manifests
from kubeflow_tpu_torch import kube
from kubeflow_tpu_torch.api import validation
from kubeflow_tpu_torch.api.types import (
    PRIORITY_CLASSES,
    GPUSpec,
    Notebook,
    ReplicationSpec,
)
from kubeflow_tpu_torch.core.notebook_controller import setup_core_controllers
from kubeflow_tpu_torch.deploy import manifests
from kubeflow_tpu_torch.gpu.topology import ACCELERATORS
from kubeflow_tpu_torch.kube.resources import DEFAULT_SCHEME
from kubeflow_tpu_torch.main import build_manager
from kubeflow_tpu_torch.utils.clock import FakeClock
from kubeflow_tpu_torch.utils.config import CoreConfig, OdhConfig

ROOT = Path(__file__).resolve().parent.parent
# what names the device in the reference's render, read as the port's
DEVICE_NAMES = (("tpuwarmpools", "gpuwarmpools"),
                ("tpuwarmpool", "gpuwarmpool"),
                ("TPUWarmPool", "GPUWarmPool"),
                ("TPU_DEFAULT_IMAGE", "GPU_DEFAULT_IMAGE"),
                ("jupyter-tpu-jax:latest", "jupyter-cuda-pytorch:latest"),
                ("kubeflow-tpu-controller:latest",
                 "kubeflow-gpu-controller:latest"),
                ("kubeflow_tpu.main", "kubeflow_tpu_torch.main"))
# the ClusterRole's rules beyond the reference's: Nodes (gang placement
# and health), TenantQuota, the shard map and Istio's VirtualService
EXTRA_RULES = [
    {"apiGroups": [""], "resources": ["nodes"],
     "verbs": ["get", "list", "watch"]},
    {"apiGroups": ["kubeflow.org"],
     "resources": ["tenantquotas", "controlplaneshardmaps"],
     "verbs": ["get", "list", "watch", "create", "update", "patch"]},
    {"apiGroups": ["kubeflow.org"],
     "resources": ["tenantquotas/status", "controlplaneshardmaps/status"],
     "verbs": ["get", "update", "patch"]},
    {"apiGroups": ["networking.istio.io"], "resources": ["virtualservices"],
     "verbs": ["get", "list", "watch", "create", "update", "patch",
               "delete"]},
]


def _as_ports(doc: dict) -> dict:
    """A reference document with the port's names for the device."""
    text = json.dumps(doc)
    for old, new in DEVICE_NAMES:
        text = text.replace(old, new)
    out = json.loads(text)
    if out["kind"] == "CustomResourceDefinition" and \
            out["spec"]["names"]["kind"] == "Notebook":
        for v in out["spec"]["versions"]:
            props = v["schema"]["openAPIV3Schema"]["properties"]["spec"][
                "properties"]
            props.pop("tpu")
            props["gpu"] = manifests._gpu_schema()
            props["priority"] = {
                "type": "string", "enum": list(PRIORITY_CLASSES),
                "description": "priority class; unset defers to the "
                               "tenant's default"}
            props["replication"] = manifests._replication_schema()
    elif out["kind"] == "CustomResourceDefinition":
        spec = out["spec"]["versions"][0]["schema"]["openAPIV3Schema"][
            "properties"]["spec"]["properties"]
        spec.pop("topology")
        spec["count"] = {"type": "integer"}
    elif out["kind"] == "ClusterRole":
        out["rules"] += copy.deepcopy(EXTRA_RULES)
    return out


@pytest.mark.parametrize("profile", manifests.PROFILES)
def test_profile_matches_the_reference_but_for_the_device(profile):
    ours = manifests.render_profile(profile)
    ref = ref_manifests.render_profile(profile)
    assert [d["kind"] for d in ours] == [d["kind"] for d in ref]
    assert ours == [_as_ports(d) for d in ref]
    manifests.validate_docs(ours)
    parsed = list(yaml.safe_load_all(manifests.render_yaml(profile)))
    assert parsed == ours
    assert manifests.PROFILES == ref_manifests.PROFILES


def test_crd_carries_the_gpu_block_as_the_types_define_it():
    crd = manifests.notebook_crd()
    versions = {v["name"]: v for v in crd["spec"]["versions"]}
    assert set(versions) == {"v1alpha1", "v1beta1", "v1"}
    assert versions["v1"]["storage"] is True
    assert crd["spec"]["conversion"]["strategy"] == "Webhook"
    spec = versions["v1"]["schema"]["openAPIV3Schema"]["properties"][
        "spec"]["properties"]
    gpu = spec["gpu"]
    assert gpu["required"] == ["accelerator"]
    assert gpu["properties"]["accelerator"]["enum"] == sorted(ACCELERATORS)
    # count: GPUSpec's default, and the least topology.resolve takes
    assert gpu["properties"]["count"]["default"] == GPUSpec("x").count
    assert gpu["properties"]["count"]["minimum"] == 1
    assert spec["priority"]["enum"] == list(PRIORITY_CLASSES)
    rep = spec["replication"]["properties"]
    assert (rep["replicas"]["minimum"], rep["replicas"]["maximum"],
            rep["replicas"]["default"], rep["antiAffine"]["default"]) == \
        (2, 8, ReplicationSpec().replicas, ReplicationSpec().anti_affine)
    assert "tpu" not in spec
    assert "conversion" not in manifests.notebook_crd(
        conversion_webhook=False)["spec"]
    pool = manifests.warmpool_crd()
    assert pool["spec"]["names"]["kind"] == "GPUWarmPool"
    assert pool["spec"]["scope"] == "Cluster"


def test_cli_prints_each_profile(tmp_path):
    for profile in manifests.PROFILES:
        out = subprocess.run(
            [sys.executable, "-m", "kubeflow_tpu_torch.deploy", profile,
             "--image", "registry.example/ctl:1"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout == manifests.render_yaml(
            profile, image="registry.example/ctl:1")
        docs = list(yaml.safe_load_all(out.stdout))
        manifests.validate_docs(docs)
        (deploy,) = [d for d in docs if d["kind"] == "Deployment"]
        container = deploy["spec"]["template"]["spec"]["containers"][0]
        assert container["image"] == "registry.example/ctl:1"
        assert container["command"][:3] == ["python", "-m",
                                            "kubeflow_tpu_torch.main"]


def test_validate_docs_refuses_what_the_reference_refuses():
    for bad in ({"kind": "X", "metadata": {"name": "a"}},
                {"apiVersion": "v1", "kind": "X", "metadata": {}}):
        for mod in (manifests, ref_manifests):
            with pytest.raises(ValueError):
                mod.validate_docs([bad])
    doc = {"apiVersion": "v1", "kind": "X", "metadata": {"name": "a"}}
    with pytest.raises(ValueError, match="duplicate manifest"):
        manifests.validate_docs([doc, doc])


def _plural(kind: str) -> tuple:
    if kind in DEFAULT_SCHEME.kinds():
        info = DEFAULT_SCHEME.by_kind(kind)
        return info.group, info.plural
    # the in-memory kinds the wire scheme does not serve
    return "kubeflow.org", kind.lower() + "s"


def test_rbac_covers_every_kind_the_controllers_watch():
    mgr, _, _, _ = build_manager(
        CoreConfig.from_env({"ENABLE_SLICE_SCHEDULER": "true",
                             "ENABLE_CULLING": "true",
                             "USE_ISTIO": "true"}),
        clock=FakeClock(), odh_cfg=OdhConfig())
    kinds = set(mgr.watched_kinds()) | {"ControlPlaneShardMap", "Lease"}
    rules = manifests.rbac_role()["rules"]
    for kind in sorted(kinds):
        group, plural = _plural(kind)
        verbs = set()
        for rule in rules:
            if group in rule["apiGroups"] and plural in rule["resources"]:
                verbs |= set(rule["verbs"])
        assert {"get", "list", "watch"} <= verbs, (kind, group, plural)


# -- the schema hook -------------------------------------------------------------


def _cr(port: bool, *, device: bool = False, containers=True,
        api_version: str = "", priority=None, replicas=None,
        bad_device: bool = False) -> dict:
    """One CR on either side: the reference's spec.tpu {v5e, 2x4}, the
    port's spec.gpu {h100-80gb, 8} of the same host count."""
    pod_spec = {"containers": [{"name": "nb"}] if containers else []}
    if port:
        gpu = GPUSpec("x100" if bad_device else "h100-80gb", 8) \
            if device else None
        d = Notebook.new("nb", "u1", pod_spec=pod_spec, gpu=gpu,
                         priority=priority,
                         replication=ReplicationSpec(replicas)
                         if replicas is not None else None).obj
    else:
        tpu = TPUSpec("v9" if bad_device else "v5e", "2x4") \
            if device else None
        nb = RefNotebook.new("nb", "u1", pod_spec=pod_spec, tpu=tpu,
                             replication=RefReplicationSpec(replicas)
                             if replicas is not None else None)
        if priority is not None:
            nb.obj.spec["priority"] = priority
        d = nb.obj.to_dict()
    if api_version:
        d["apiVersion"] = api_version
    return d


# (case, the CR's arguments, whether the check is the device's own)
SCHEMA_CASES = [
    ("cpu", {}, False),
    ("device", {"device": True}, False),
    ("v1alpha1", {"api_version": "kubeflow.org/v1alpha1"}, False),
    ("v1beta1", {"api_version": "kubeflow.org/v1beta1"}, False),
    ("unserved_version", {"api_version": "kubeflow.org/v2"}, False),
    ("other_group", {"api_version": "example.com/v1"}, False),
    ("no_containers", {"containers": False}, False),
    ("no_containers_device", {"containers": False, "device": True}, False),
    ("priority_low", {"priority": "low"}, False),
    ("priority_high", {"priority": "high", "device": True}, False),
    ("priority_unknown", {"priority": "urgent"}, False),
    ("replicated", {"device": True, "replicas": 2}, False),
    ("replicated_eight", {"device": True, "replicas": 8}, False),
    ("one_replica", {"device": True, "replicas": 1}, False),
    ("nine_replicas", {"device": True, "replicas": 9}, False),
    ("replicated_cpu", {"replicas": 2}, True),
    ("unknown_device", {"device": True, "bad_device": True}, True),
]


def _verdict(api, d: dict, kube_mod, op: str) -> str:
    obj = kube_mod.KubeObject.from_dict(d)
    try:
        if op == "CREATE":
            api.create(obj)
        else:
            live = api.get("Notebook", "u1", "nb")
            live.body["spec"] = obj.body["spec"]
            api.update(live)
    except kube_mod.AdmissionDenied as err:
        return str(err)
    return "admitted"


def _device_words(text: str) -> str:
    """The reference's device names read as the port's."""
    for old, new in (("spec.tpu", "spec.gpu"), ("'v9'", "'x100'")):
        text = text.replace(old, new)
    return text


@pytest.mark.parametrize("op", ["CREATE", "UPDATE"])
@pytest.mark.parametrize("case,args,device_check", SCHEMA_CASES,
                         ids=[c[0] for c in SCHEMA_CASES])
def test_schema_hook_matches_the_reference(case, args, device_check, op):
    verdicts = {}
    for port in (False, True):
        k = kube if port else ref_kube
        api = k.ApiServer()
        (validation if port else ref_validation).install_notebook_schema(
            api)
        if op == "UPDATE":
            api.create(k.KubeObject.from_dict(_cr(port, device=True)))
        verdicts[port] = _verdict(api, _cr(port, **args), k, op)
    ours, ref = verdicts[True], verdicts[False]
    if device_check:
        # the check is the device's own: refused alike, the message up to
        # the device's own list of supported types
        assert ref != "admitted" and ours != "admitted"
        assert ours.split("; supported")[0] == \
            _device_words(ref).split("; supported")[0]
    else:
        assert ours == ref
    # the port's whole admission: refused once, with the schema's message
    mgr = kube.Manager(kube.ApiServer(), clock=FakeClock())
    setup_core_controllers(mgr, CoreConfig())
    if op == "UPDATE":
        mgr.api.create(kube.KubeObject.from_dict(_cr(True, device=True)))
    assert _verdict(mgr.api, _cr(True, **args), kube, op) == ours


def test_schema_refusals_come_before_the_tpu_refusal():
    """A spec.tpu CR the schema refuses gets the schema's message; one
    it admits gets the port's refusal of spec.tpu, once.  A replicated
    spec.tpu CR, which the reference admits, gets the refusal of
    spec.tpu; one the reference refuses for its replica count gets the
    reference's message."""
    mgr = kube.Manager(kube.ApiServer(), clock=FakeClock())
    setup_core_controllers(mgr, CoreConfig())
    names = [h.name for h in mgr.api._validating]
    assert names.index("notebook-crd-schema") < \
        names.index("notebook-gpu-admission")
    tpu = _cr(True)
    tpu["spec"]["tpu"] = {"accelerator": "v5e", "topology": "2x4"}
    assert _verdict(mgr.api, tpu, kube, "CREATE").startswith(
        "spec.tpu: this controller runs GPU gangs")
    for replicas, want in ((2, None), (1, "invalid Notebook: "
                                          "spec.replication.replicas must "
                                          "be >= 2")):
        tpu["spec"]["replication"] = ReplicationSpec(replicas).to_dict()
        ref = RefNotebook.new("nb", "u1", tpu=TPUSpec("v5e", "2x4"),
                              replication=RefReplicationSpec(replicas))
        ref_api = ref_kube.ApiServer()
        ref_validation.install_notebook_schema(ref_api)
        ref_verdict = _verdict(ref_api, ref.obj.to_dict(), ref_kube,
                               "CREATE")
        ours = _verdict(mgr.api, tpu, kube, "CREATE")
        if want is None:
            assert ref_verdict == "admitted"
            assert ours.startswith("spec.tpu: this controller runs GPU gangs")
        else:
            assert ours == ref_verdict == want
    del tpu["spec"]["replication"]
    tpu["spec"]["template"]["spec"]["containers"] = []
    assert _verdict(mgr.api, tpu, kube, "CREATE") == (
        "invalid Notebook: spec.template.spec.containers must be "
        "non-empty")
    assert mgr.api.list("Notebook") == []
