"""The port's real-cluster backend against the reference's, over sockets.

`kube/wire.py` (the Kubernetes REST protocol over the in-memory store),
`kube/client.py` (KubeClient, RateLimiter, list-then-watch informers),
`kube/certs.py`, `odh/webhook_server.py` (AdmissionReview and
ConversionReview over HTTPS), `kube/leader.py` and `kube/fixtures.py`.

- The classes of tests/test_realcluster.py (the wire protocol, the watch
  history, controllers over the wire, admission over HTTPS, the
  conversion webhook, the manager CLI, discovery, OpenAPI with the CRD
  field models, the rate limiter, the 410 reflector and the audit log;
  TestJsonPatch runs in tests/test_torch_patch.py) and the 11 cases of
  tests/test_leader.py run as twins, as tests/test_torch_patch.py runs
  its reference cases: the reference's assertions on both packages, then
  every ApiServer's objects, audit log and verb counts equal, once uids
  and wall-clock stamps are read as tokens; the leader's fencing case
  runs the port's FencedApi (kube/shard.py) over the port's elector.  The
  CRD field models are served from each package's own rendered CRD
  (deploy/manifests.py:notebook_crd): the reference's case asserts its
  `spec.tpu` models, so the port's twin of it is a test of its own, which
  finds `spec.gpu` and holds the rest of the served Notebook model to the
  reference's.
  Cases whose controllers, informers or electors run on threads keep the
  assertions and compare no state: their write order is the scheduler's.
  The reference's TPU image swap has no GPU twin (a spec.gpu notebook
  keeps its image); its guarantee, a spec.template mutation surviving the
  HTTPS JSONPatch round trip, is held by a spec.gpu CR admitted over
  HTTPS equal to the same CR admitted in process.
- The ten transcripts of conformance/apiserver_fixtures replay against
  both packages' wire servers, with the same verdict on each.
- `python -m kubeflow_tpu_torch.main --kubeconfig ...
  --enable-leader-election` as a separate process takes the Lease,
  reconciles a `spec.gpu` notebook to Healthy, and exits within 2 s of
  SIGINT, releasing the Lease.

Every server binds a free port.  Waits are on the port's Clock."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import urllib.request

import pytest
from test_torch_patch import TESTS, case_ids, run_twins, twin_modules

from kubeflow_tpu import kube as ref_kube
from kubeflow_tpu.kube import ApiServer as RefApiServer
from kubeflow_tpu.kube.fixtures import FixtureFailure as RefFixtureFailure
from kubeflow_tpu.kube.fixtures import FixtureRunner as RefFixtureRunner
from kubeflow_tpu.kube.fixtures import load_fixtures as ref_load_fixtures
from kubeflow_tpu.kube.wire import KubeApiWireServer as RefWireServer
from kubeflow_tpu_torch import kube
from kubeflow_tpu_torch.api.types import GPUSpec, Notebook
from kubeflow_tpu_torch.kube.certs import mint_serving_cert
from kubeflow_tpu_torch.kube.client import KubeClient, RestConfig
from kubeflow_tpu_torch.kube.fixtures import FixtureFailure, FixtureRunner
from kubeflow_tpu_torch.kube.fixtures import load_fixtures
from kubeflow_tpu_torch.kube.wire import KubeApiWireServer
from kubeflow_tpu_torch.odh import constants as OC
from kubeflow_tpu_torch.odh.webhook import (
    NotebookMutatingWebhook,
    NotebookValidatingWebhook,
)
from kubeflow_tpu_torch.odh.webhook_server import (
    AdmissionReviewServer,
    RemoteAdmissionHook,
)
from kubeflow_tpu_torch.utils.clock import Clock
from kubeflow_tpu_torch.utils.config import OdhConfig

REALCLUSTER = twin_modules("test_realcluster.py")
LEADER = twin_modules("test_leader.py", port_lines={
    # the module's Notebook: the reference's signature over the port's
    "from kubeflow_tpu_torch.api.types import Notebook": "pass"})
# the reference's spec.tpu image swap, held by the spec.gpu admission
# below, and its spec.tpu field models, held by the port's CRD below;
# TestJsonPatch runs in tests/test_torch_patch.py
NOT_TWINNED = {"TestAdmissionOverHttps::test_tpu_image_swap_via_https",
               "TestOpenApiCrdFieldModels::"
               "test_notebook_spec_fields_served_from_crd"}
REALCLUSTER_CASES = [c for c in case_ids(REALCLUSTER["reference"])
                     if not c.startswith("TestJsonPatch::")
                     and c not in NOT_TWINNED]
# controllers, informers, reflectors or electors on threads, and servers
# whose audit trail holds wall-clock reads: the assertions hold, the
# write order is the scheduler's
THREADED_CLASSES = ("TestControllersOverWire::", "TestManagerCli::",
                    "TestReflector410::")
THREADED = {"TestWireProtocol::test_watch_bookmarks",
            "TestWireProtocol::test_namespace_scoped_informer",
            "TestWireProtocol::test_informer_list_then_watch",
            "TestLeaderElection::test_renew_deadline_abdicates_before_"
            "takeover_is_possible",
            "TestLeaderElection::test_background_run_invokes_callbacks"}


def _threaded(case: str) -> bool:
    return case in THREADED or case.startswith(THREADED_CLASSES)


@pytest.mark.parametrize("case", REALCLUSTER_CASES)
def test_realcluster_cases_match_the_reference(case, tmp_path):
    run_twins(REALCLUSTER, case, tmp_path, compare=not _threaded(case))


@pytest.mark.parametrize("case", case_ids(LEADER["reference"]))
def test_leader_cases_match_the_reference(case, tmp_path):
    run_twins(LEADER, case, tmp_path, compare=not _threaded(case))


def test_case_counts():
    assert len(case_ids(LEADER["reference"])) == 11
    assert len(REALCLUSTER_CASES) == len(case_ids(REALCLUSTER["reference"])) \
        - 6 - len(NOT_TWINNED)


# -- the Notebook CRD's field models --------------------------------------------


def _served_notebook(api, crd: dict, server_cls) -> dict:
    """The Notebook model /openapi/v2 serves once `crd` is stored."""
    api.create(api_kube(api).KubeObject.from_dict(crd))
    srv = server_cls(api).start()
    try:
        with urllib.request.urlopen(srv.url + "/openapi/v2",
                                    timeout=5) as resp:
            return json.loads(resp.read())["definitions"][
                "kubeflow.org.v1.Notebook"]
    finally:
        srv.stop()


def api_kube(api):
    return kube if isinstance(api, kube.ApiServer) else ref_kube


def test_notebook_spec_fields_served_from_the_ports_crd():
    """The port's CRD (deploy/manifests.py) served as field models: the
    `spec.gpu` block, `spec.priority` and `spec.replication`; the rest of
    the Notebook model equal to what the reference serves from its own
    CRD, whose accelerator block is `spec.tpu`."""
    from kubeflow_tpu.deploy.manifests import notebook_crd as ref_crd
    from kubeflow_tpu_torch.deploy.manifests import notebook_crd

    ours = _served_notebook(kube.ApiServer(),
                            notebook_crd(conversion_webhook=False),
                            KubeApiWireServer)
    ref = _served_notebook(RefApiServer(),
                           ref_crd(conversion_webhook=False), RefWireServer)
    props = ours["properties"]["spec"]["properties"]
    assert set(props["gpu"]["properties"]) == {"accelerator", "count"}
    assert props["gpu"]["properties"]["accelerator"]["enum"] == \
        ["a100-80gb", "h100-80gb", "h200-141gb"]
    assert props["priority"]["enum"] == ["low", "standard", "high"]
    assert set(props["replication"]["properties"]) == \
        {"replicas", "antiAffine"}
    for side, blocks in ((ours, ("gpu", "priority", "replication")),
                         (ref, ("tpu",))):
        for block in blocks:
            side["properties"]["spec"]["properties"].pop(block)
    assert ours == ref


# -- admission of a spec.gpu CR over HTTPS -------------------------------------

def _gpu_notebook() -> kube.KubeObject:
    return kube.KubeObject.from_dict(Notebook.new(
        "gpu-wb", "default", gpu=GPUSpec("h100-80gb", 8),
        annotations={OC.ANNOTATION_INJECT_AUTH: "true"},
        pod_spec={"containers": [{"name": "gpu-wb",
                                  "image": "cuda-notebook:1"}]}).obj)


def _normalized(obj: kube.KubeObject) -> dict:
    d = obj.to_dict()
    for key in ("uid", "creationTimestamp", "resourceVersion"):
        d["metadata"].pop(key, None)
    return d


def test_gpu_notebook_admitted_over_https_as_in_process():
    cfg = OdhConfig.from_env({})
    in_process = kube.ApiServer()
    for hook in (NotebookMutatingWebhook(in_process, cfg).hook(),
                 NotebookValidatingWebhook(in_process, cfg).hook()):
        in_process.register_admission(hook)
    want = in_process.create(_gpu_notebook())

    api = kube.ApiServer()
    bundle = mint_serving_cert()
    whsrv = AdmissionReviewServer(
        [NotebookMutatingWebhook(api, cfg).hook(),
         NotebookValidatingWebhook(api, cfg).hook()], bundle=bundle).start()
    api.register_admission(RemoteAdmissionHook(
        whsrv.url, "/mutate-notebook-v1", mutating=True,
        ca_pem=bundle.ca_cert_pem).as_hook())
    api.register_admission(RemoteAdmissionHook(
        whsrv.url, "/validate-notebook-v1", mutating=False,
        ca_pem=bundle.ca_cert_pem, operations=("UPDATE",)).as_hook())
    srv = KubeApiWireServer(api).start()
    try:
        got = KubeClient(RestConfig(server=srv.url)).create(_gpu_notebook())
    finally:
        srv.stop()
        whsrv.stop()
    assert whsrv.url.startswith("https://")
    assert _normalized(got) == _normalized(want)
    assert got.annotations.get("kubeflow-resource-stopped") == \
        "odh-notebook-controller-lock"
    # inject-auth's kube-rbac-proxy sidecar: the template mutation came
    # back through the JSONPatch
    containers = got.body["spec"]["template"]["spec"]["containers"]
    assert len(containers) == 2
    assert containers[0]["image"] == "cuda-notebook:1"


# -- the conformance transcripts -------------------------------------------------

FIXTURES = load_fixtures()


def _verdict(runner_cls, failure_cls, server_cls, api_cls, fixture) -> str:
    srv = server_cls(api_cls()).start()
    try:
        runner_cls(srv.url).run(fixture)
        return "pass"
    except failure_cls as err:
        return f"fail: {err}"
    finally:
        srv.stop()


@pytest.mark.parametrize("fixture", FIXTURES, ids=[f["name"]
                                                   for f in FIXTURES])
def test_fixture_verdicts_match_the_reference(fixture):
    ours = _verdict(FixtureRunner, FixtureFailure, KubeApiWireServer,
                    kube.ApiServer, fixture)
    ref = _verdict(RefFixtureRunner, RefFixtureFailure, RefWireServer,
                   RefApiServer, fixture)
    assert ours == ref == "pass"


def test_the_ten_fixtures_are_the_references():
    assert len(FIXTURES) == 10
    assert FIXTURES == ref_load_fixtures()


# -- the manager CLI under leader election ----------------------------------------

LEASE = "kubeflow-tpu-notebook-controller"


def _wait(predicate, clock: Clock, timeout_s: float, what: str):
    deadline = clock.now() + timeout_s
    while clock.now() < deadline:
        value = predicate()
        if value:
            return value
        clock.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def test_kubeconfig_manager_with_leader_election_reaches_healthy(tmp_path):
    clock = Clock()
    api = kube.ApiServer()
    cluster = kube.FakeCluster(api)
    cluster.add_node("cpu-node", allocatable={"cpu": "32", "memory": "64Gi"})
    cluster.add_gpu_nodes("h100-80gb", 1, 8)
    srv = KubeApiWireServer(api, token="cli-token").start()
    kubeconfig = tmp_path / "kubeconfig"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "wire",
        "contexts": [{"name": "wire", "context": {"cluster": "wire",
                                                  "user": "wire"}}],
        "clusters": [{"name": "wire", "cluster": {"server": srv.url}}],
        "users": [{"name": "wire", "user": {"token": "cli-token"}}]}))
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent))
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.main",
         "--kubeconfig", str(kubeconfig), "--enable-leader-election",
         "--leader-election-namespace", "default", "--webhook-port", "-1",
         "--metrics-addr", "0", "--run-seconds", "60"],
        env=env, cwd=str(TESTS.parent), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        lease = _wait(lambda: api.try_get("Lease", "default", LEASE), clock,
                      25, "the Lease")
        assert lease.body["spec"]["holderIdentity"].endswith(
            f"-{proc.pid}")
        api.create(kube.KubeObject.from_dict(Notebook.new(
            "cli-gpu", "default", gpu=GPUSpec("h100-80gb", 8)).obj))

        def healthy():
            nb = api.try_get("Notebook", "default", "cli-gpu")
            return nb is not None and nb.body.get("status", {}).get(
                "sliceHealth") == "Healthy"

        _wait(healthy, clock, 25, "the notebook Healthy")
        sts = api.get("StatefulSet", "default", "cli-gpu")
        (c,) = [c for c in sts.spec["template"]["spec"]["containers"]
                if c["name"] == "cli-gpu"]
        assert c["resources"]["limits"]["nvidia.com/gpu"] == "8"
    finally:
        t0 = clock.monotonic()
        proc.send_signal(signal.SIGINT)
        try:
            code = proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            code = proc.wait()
        exit_s = clock.monotonic() - t0
        srv.stop()
    assert code == 0 and exit_s < 2.0, (code, exit_s)
    released = api.get("Lease", "default", LEASE)
    assert not released.body["spec"].get("holderIdentity"), released.body


# -- the standalone manager served over the wire --------------------------------

def test_serve_api_with_fake_gpu_nodes_and_audit_log(tmp_path):
    """`--serve-api 0 --fake-gpu-nodes 1 --audit-log PATH`: the standalone
    store over the wire with the Notebook converter and the port's
    Notebook CRD (its /openapi serves `spec.gpu`), one full H100 host,
    and the request trail."""
    clock = Clock()
    audit = tmp_path / "audit.jsonl"
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.main", "--serve-api",
         "0", "--fake-gpu-nodes", "1", "--audit-log", str(audit),
         "--metrics-addr", "0", "--run-seconds", "30"],
        env=dict(os.environ, PYTHONPATH=str(TESTS.parent)),
        cwd=str(TESTS.parent), stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        # the process exits after --run-seconds, so this read ends
        url = next((line.strip().split("=", 1)[1] for line in proc.stdout
                    if line.startswith("WIRE_API=")), None)
        assert url, "no WIRE_API line"
        with urllib.request.urlopen(url + "/openapi/v2", timeout=10) as r:
            served = json.loads(r.read())["definitions"][
                "kubeflow.org.v1.Notebook"]["properties"]["spec"]
        assert set(served["properties"]["gpu"]["properties"]) == \
            {"accelerator", "count"}
        client = KubeClient(RestConfig(server=url))
        (node,) = [n for n in client.list("Node")
                   if n.name.startswith("fake-gpu")]
        assert node.status["allocatable"]["nvidia.com/gpu"] == "8"
        nb = Notebook.new("served", "default", gpu=GPUSpec("h100-80gb", 8))
        beta = dict(nb.obj, apiVersion="kubeflow.org/v1beta1")
        beta_client = KubeClient(RestConfig(server=url), scheme=_beta_scheme())
        created = beta_client.create(kube.KubeObject.from_dict(beta))
        assert created.api_version == "kubeflow.org/v1beta1"
        _wait(lambda: client.try_get("StatefulSet", "default", "served"),
              clock, 25, "the StatefulSet over the wire")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    trail = [json.loads(line) for line in audit.read_text().splitlines()]
    assert {"POST", "GET"} <= {r["verb"] for r in trail}
    assert any(r["path"].startswith("/apis/kubeflow.org/v1beta1/")
               and r["code"] == 201 for r in trail)


def _beta_scheme():
    from kubeflow_tpu_torch.kube.resources import ResourceInfo, Scheme

    scheme = Scheme()
    scheme.register(ResourceInfo("Notebook", "kubeflow.org", "v1beta1",
                                 "notebooks"))
    return scheme
