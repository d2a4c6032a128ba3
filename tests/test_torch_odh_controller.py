"""The port's ODH reconciler, routing, TLS profile and Istio against the
reference's.

On tests/test_torch_odh.py's two stacks (the core controllers and the
ODH plane, each on its own FakeClock), the scenarios of
tests/test_odh_routing.py and tests/test_tls_profile.py, each written
once and run on both:

- CPU notebooks: every object of both stores equal once the STRIPPED
  fields are removed (HTTPRoutes and their generateName fallback, the
  ReferenceGrant and its deletion with the namespace's last notebook,
  the finalizers and their cleanup, the auth objects, the
  NetworkPolicies, the legacy OAuthClient, and the Istio VirtualService
  under USE_ISTIO);
- a `spec.gpu` gang against a `spec.tpu` slice of the same host count:
  the ODH objects equal, and the gang's worker NetworkPolicy held to the
  slice's under its rule (the same selectors, peers, policy types and
  owner; the `-gpu-workers-np` name for `-tpu-workers-np`, and any TCP
  port for the TPU's two fixed ones);
- the reference's fault and the port's fix, on the replicated tier of
  tests/test_torch_replication.py: after a promotion the reference's
  kube-rbac-proxy Service still selects the demoted gang, the port's
  selects the new primary's;
- with the gang scheduler on, a CR admitted under the reconciliation
  lock is placed only once the lock comes off, on both stacks alike;
- the TLS profile's resolution and its watcher, and the port's
  `main.build_manager`, which wires the watcher to stop the manager.

Only the reference's control plane is imported."""

from __future__ import annotations

import dataclasses
import json

import pytest

from kubeflow_tpu.core import constants as RK
from kubeflow_tpu.core.workload import (
    generate_virtual_service as ref_virtual_service,
)
from kubeflow_tpu.odh import tls_profile as ref_tls
from kubeflow_tpu.odh.controller import setup_odh_controllers as ref_setup_odh
from kubeflow_tpu.utils.config import OdhConfig as RefOdhConfig
from kubeflow_tpu_torch import kube
from kubeflow_tpu_torch import main as port_main
from kubeflow_tpu_torch.core import constants as K
from kubeflow_tpu_torch.odh import constants as C
from kubeflow_tpu_torch.odh import tls_profile
from kubeflow_tpu_torch.odh.controller import setup_odh_controllers
from kubeflow_tpu_torch.utils.clock import FakeClock
from kubeflow_tpu_torch.utils.config import CoreConfig, OdhConfig
from test_torch_odh import CENTRAL_NS, NS, Stack, run_both
from test_torch_replication import NAME as REP, NS as REP_NS, RepSide

AUTH = {C.ANNOTATION_INJECT_AUTH: "true"}


def _routes(s: Stack, name="wb"):
    return s.api.list("HTTPRoute", namespace=CENTRAL_NS,
                      label_selector={C.NOTEBOOK_NAME_LABEL: name})


def _backend(s: Stack, name="wb") -> dict:
    (route,) = _routes(s, name)
    return route.spec["rules"][0]["backendRefs"][0]


# -- HTTPRoutes ----------------------------------------------------------------


def _route_created(s: Stack):
    s.create_nb()
    route = s.api.get("HTTPRoute", CENTRAL_NS, "nb-user1-wb")
    assert route.metadata.labels == {"notebook-name": "wb",
                                     "notebook-namespace": "user1"}
    assert route.spec["parentRefs"] == [
        {"name": "data-science-gateway", "namespace": "openshift-ingress"}]
    rule = route.spec["rules"][0]
    assert rule["matches"][0]["path"]["value"] == "/notebook/user1/wb"
    assert rule["backendRefs"][0] == {"name": "wb", "namespace": "user1",
                                      "port": 8888}
    finalizers = s.api.get("Notebook", NS, "wb").metadata.finalizers
    assert finalizers == [C.HTTPROUTE_FINALIZER, C.REFERENCEGRANT_FINALIZER]
    return {"finalizers": finalizers}


def _route_recreated(s: Stack):
    s.create_nb()
    s.api.delete("HTTPRoute", CENTRAL_NS, "nb-user1-wb")
    s.mgr.run_until_idle()
    assert s.api.try_get("HTTPRoute", CENTRAL_NS, "nb-user1-wb") is not None
    return {}


def _route_drift_reverted(s: Stack):
    s.create_nb()
    route = s.api.get("HTTPRoute", CENTRAL_NS, "nb-user1-wb")
    route.spec["rules"][0]["matches"][0]["path"]["value"] = "/hacked"
    s.api.update(route)
    s.mgr.run_until_idle()
    route = s.api.get("HTTPRoute", CENTRAL_NS, "nb-user1-wb")
    path = route.spec["rules"][0]["matches"][0]["path"]["value"]
    assert path == "/notebook/user1/wb"
    return {"path": path}


def _route_long_name(s: Stack):
    long_name = "a" * 60
    s.create_nb(name=long_name)
    (route,) = _routes(s, long_name)
    assert route.metadata.generate_name == f"nb-user1-{'a' * 10}-"
    assert len(route.name) <= 63 + 6
    return {"prefix": route.metadata.generate_name}


def _route_deleted_with_notebook(s: Stack):
    s.create_nb()
    s.api.delete("Notebook", NS, "wb")
    s.mgr.run_until_idle()
    assert s.api.try_get("Notebook", NS, "wb") is None
    assert s.api.try_get("HTTPRoute", CENTRAL_NS, "nb-user1-wb") is None
    return {}


def _route_follows_auth_mode(s: Stack):
    s.create_nb()
    s.update(NS, "wb", lambda nb: nb.metadata.annotations.update(AUTH))
    s.mgr.run_until_idle()
    on = dict(_backend(s))
    assert (on["name"], on["port"]) == ("wb-kube-rbac-proxy", 8443)
    s.update(NS, "wb", lambda nb: nb.metadata.annotations.pop(
        C.ANNOTATION_INJECT_AUTH))
    s.mgr.run_until_idle()
    off = dict(_backend(s))
    assert off["port"] == 8888
    return {"on": on, "off": off}


# -- the ReferenceGrant, the OAuthClient ---------------------------------------


def _grant_shared(s: Stack):
    s.create_nb(name="wb1")
    grant = s.api.get("ReferenceGrant", NS, C.REFERENCEGRANT_NAME)
    assert grant.spec["from"][0]["namespace"] == CENTRAL_NS
    assert grant.spec["to"][0]["kind"] == "Service"
    rv = grant.metadata.resource_version
    s.create_nb(name="wb2")
    untouched = s.api.get("ReferenceGrant", NS, C.REFERENCEGRANT_NAME
                          ).metadata.resource_version == rv
    assert untouched
    return {"untouched": untouched}


def _grant_goes_with_last_notebook(s: Stack):
    s.create_nb(name="wb1")
    s.create_nb(name="wb2")
    s.api.delete("Notebook", NS, "wb1")
    s.mgr.run_until_idle()
    kept = s.api.try_get("ReferenceGrant", NS, C.REFERENCEGRANT_NAME)
    assert kept is not None
    s.api.delete("Notebook", NS, "wb2")
    s.mgr.run_until_idle()
    assert s.api.try_get("ReferenceGrant", NS, C.REFERENCEGRANT_NAME) is None
    return {}


def _oauth_client_cleaned(s: Stack):
    for name in ("wb-user1-oauth-client", "other-user1-oauth-client"):
        s.make("OAuthClient", name, body={"grantMethod": "auto"},
               api_version="oauth.openshift.io/v1")
    s.create_nb()
    finalizers = s.api.get("Notebook", NS, "wb").metadata.finalizers
    assert C.OAUTH_CLIENT_FINALIZER in finalizers
    s.api.delete("Notebook", NS, "wb")
    s.mgr.run_until_idle()
    assert s.api.try_get("Notebook", NS, "wb") is None
    assert s.api.try_get("OAuthClient", "", "wb-user1-oauth-client") is None
    assert s.api.try_get("OAuthClient", "", "other-user1-oauth-client") \
        is not None
    return {"finalizers": finalizers}


def _deletion_without_client(s: Stack):
    s.create_nb()
    s.api.delete("Notebook", NS, "wb")
    s.mgr.run_until_idle()
    assert s.api.try_get("Notebook", NS, "wb") is None
    return {}


# -- NetworkPolicies, the auth objects -----------------------------------------


def _policies(s: Stack):
    s.create_nb()
    ctrl = s.api.get("NetworkPolicy", NS, "wb-ctrl-np").spec["ingress"][0]
    assert ctrl["ports"] == [{"protocol": "TCP", "port": 8888}]
    assert ctrl["from"][0]["namespaceSelector"]["matchLabels"] == {
        "kubernetes.io/metadata.name": CENTRAL_NS}
    proxy = s.api.get("NetworkPolicy", NS, "wb-kube-rbac-proxy-np"
                      ).spec["ingress"][0]
    assert proxy == {"ports": [{"protocol": "TCP", "port": 8443}]}
    names = sorted(p.name for p in s.api.list("NetworkPolicy"))
    # a CPU notebook: no worker policy
    assert names == ["wb-ctrl-np", "wb-kube-rbac-proxy-np"]
    return {"names": names}


def _policies_collected(s: Stack):
    s.create_nb()
    s.api.delete("Notebook", NS, "wb")
    s.mgr.run_until_idle()
    assert not s.api.list("NetworkPolicy")
    return {}


def _auth_objects(s: Stack):
    s.create_nb(annotations=AUTH)
    assert s.api.try_get("ServiceAccount", NS, "wb") is not None
    svc = s.api.get("Service", NS, "wb-kube-rbac-proxy")
    assert svc.metadata.annotations[C.SERVING_CERT_ANNOTATION] == \
        "wb-kube-rbac-proxy-tls"
    assert svc.spec["ports"][0]["port"] == 8443
    assert svc.spec["selector"] == {K.STATEFULSET_LABEL: "wb"}
    config = s.api.get("ConfigMap", NS, "wb-kube-rbac-proxy-config"
                       ).body["data"]["config-file.yaml"]
    assert "resource: notebooks" in config and "name: wb" in config
    crb = s.api.get("ClusterRoleBinding", "", "wb-rbac-user1-auth-delegator")
    assert crb.body["roleRef"]["name"] == "system:auth-delegator"
    assert crb.body["subjects"][0] == {"kind": "ServiceAccount",
                                       "name": "wb", "namespace": "user1"}
    # the SA's pull secret, minted by the fake cluster, let the lock go
    sa = s.api.get("ServiceAccount", NS, "wb")
    assert sa.body["imagePullSecrets"] == [{"name": "wb-dockercfg"}]
    live = s.api.get("Notebook", NS, "wb")
    assert C.STOP_ANNOTATION not in live.metadata.annotations
    assert C.KUBE_RBAC_PROXY_FINALIZER in live.metadata.finalizers
    return {"finalizers": live.metadata.finalizers}


def _crb_cleaned_on_delete(s: Stack):
    s.create_nb(annotations=AUTH)
    s.api.delete("Notebook", NS, "wb")
    s.mgr.run_until_idle()
    assert s.api.try_get("ClusterRoleBinding", "",
                         "wb-rbac-user1-auth-delegator") is None
    return {}


def _crb_cleaned_when_auth_off(s: Stack):
    s.create_nb(annotations=AUTH)
    s.update(NS, "wb", lambda nb: nb.metadata.annotations.update(
        {C.ANNOTATION_INJECT_AUTH: "false"}))
    s.mgr.run_until_idle()
    assert s.api.try_get("ClusterRoleBinding", "",
                         "wb-rbac-user1-auth-delegator") is None
    return {}


def _pipeline_rbac(s: Stack):
    s.make("Role", C.PIPELINE_ROLE_NAME, NS, {"rules": []},
           api_version="rbac.authorization.k8s.io/v1")
    s.create_nb()
    rb = s.api.get("RoleBinding", NS, C.PIPELINE_ROLEBINDING_PREFIX + "wb")
    assert rb.body["roleRef"]["name"] == C.PIPELINE_ROLE_NAME
    return {}


# -- Istio -----------------------------------------------------------------------


def _virtual_service(s: Stack):
    s.create_nb(annotations={K.ANNOTATION_REWRITE_URI: "/",
                             K.ANNOTATION_HEADERS_REQUEST_SET:
                             '{"X-Team": "ml"}'})
    vs = s.api.get("VirtualService", NS, "notebook-user1-wb")
    assert vs.spec["hosts"] == ["nb.example.com"]
    assert vs.spec["gateways"] == ["istio/gw"]
    http = vs.spec["http"][0]
    assert http["rewrite"] == {"uri": "/"}
    assert http["headers"] == {"request": {"set": {"X-Team": "ml"}}}
    assert vs.metadata.controller_owner().kind == "Notebook"
    # drift is reverted, and the VirtualService goes with its notebook
    vs.spec["hosts"] = ["evil"]
    s.api.update(vs)
    s.mgr.run_until_idle()
    hosts = s.api.get("VirtualService", NS, "notebook-user1-wb").spec["hosts"]
    assert hosts == ["nb.example.com"]
    return {"http": http}


# scenario -> (function, CoreConfig fields, OdhConfig fields)
SCENARIOS = {
    "route_created": (_route_created, {}, {}),
    "route_recreated": (_route_recreated, {}, {}),
    "route_drift_reverted": (_route_drift_reverted, {}, {}),
    "route_long_name": (_route_long_name, {}, {}),
    "route_deleted_with_notebook": (_route_deleted_with_notebook, {}, {}),
    "route_follows_auth_mode": (_route_follows_auth_mode, {}, {}),
    "grant_shared": (_grant_shared, {}, {}),
    "grant_goes_with_last_notebook": (_grant_goes_with_last_notebook, {}, {}),
    "oauth_client_cleaned": (_oauth_client_cleaned, {}, {}),
    "deletion_without_client": (_deletion_without_client, {}, {}),
    "policies": (_policies, {}, {}),
    "policies_collected": (_policies_collected, {}, {}),
    "auth_objects": (_auth_objects, {}, {}),
    "crb_cleaned_on_delete": (_crb_cleaned_on_delete, {}, {}),
    "crb_cleaned_when_auth_off": (_crb_cleaned_when_auth_off, {}, {}),
    "pipeline_rbac": (_pipeline_rbac, {}, {"set_pipeline_rbac": True}),
    "virtual_service": (_virtual_service, {
        "use_istio": True, "istio_gateway": "istio/gw",
        "istio_host": "nb.example.com"}, {}),
}


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_cpu_notebook_reconciler_matches_the_reference(scenario):
    fn, core, odh = SCENARIOS[scenario]
    (ref, ours), (ref_out, our_out) = run_both(fn, core=core, **odh)
    assert our_out == ref_out
    assert ours.snapshot() == ref.snapshot()


# -- a GPU gang against a TPU slice of the same host count ---------------------


def test_gpu_gang_policies_and_routes_match_the_tpu_slice():
    stacks = []
    for port in (False, True):
        s = Stack(port)
        s.create_nb(hosts=1, annotations=AUTH)
        stacks.append(s)
    ref, ours = stacks
    assert ours.device_snapshot() == ref.device_snapshot()
    snaps = [s.snapshot(("NetworkPolicy",))["NetworkPolicy"] for s in stacks]
    (ref_np,), (our_np,) = ([p for p in snap
                             if p["metadata"]["name"].endswith("-workers-np")]
                            for snap in snaps)
    assert ref_np["metadata"]["name"] == "wb-tpu-workers-np"
    assert our_np["metadata"]["name"] == "wb-gpu-workers-np"
    assert our_np["metadata"]["ownerReferences"] == \
        ref_np["metadata"]["ownerReferences"]
    (rule,), (ref_rule,) = (our_np["spec"]["ingress"],
                            ref_np["spec"]["ingress"])
    assert rule["from"] == ref_rule["from"]
    assert {p["port"] for p in ref_rule["ports"]} == {8471, 8080}
    assert rule["ports"] == [{"protocol": "TCP"}]
    for key in ("podSelector", "policyTypes"):
        assert our_np["spec"][key] == ref_np["spec"][key]


# -- the reference's fault: the proxy Service after a promotion -----------------


def _promoted(port: bool) -> dict:
    """tests/test_torch_replication.py's replicated tier with the ODH
    plane: an inject-auth CR of two gangs, the follower warmed, replica
    0's worker failed and the follower promoted; then every controller
    resynced."""
    s = RepSide(port, 1)
    (setup_odh_controllers if port else ref_setup_odh)(
        s.mgr, (OdhConfig if port else RefOdhConfig)(
            controller_namespace=CENTRAL_NS))
    if port:
        from kubeflow_tpu_torch.api.types import GPUSpec, Notebook
        from kubeflow_tpu_torch.api.types import ReplicationSpec
        obj = kube.KubeObject.from_dict(Notebook.new(
            REP, REP_NS, gpu=GPUSpec("h100-80gb", 8),
            replication=ReplicationSpec(2), annotations=AUTH).obj)
    else:
        from kubeflow_tpu.api.types import Notebook as RefNotebook
        from kubeflow_tpu.api.types import ReplicationSpec as RefReplication
        from kubeflow_tpu.api.types import TPUSpec
        obj = RefNotebook.new(REP, REP_NS, tpu=TPUSpec("v5e", "2x4"),
                              replication=RefReplication(2),
                              annotations=AUTH).obj
    s.api.create(obj)
    s.mgr.run_until_idle()

    def selectors():
        return [s.api.get("Service", REP_NS, name).spec["selector"][
                    K.STATEFULSET_LABEL]
                for name in (REP, REP + C.KUBE_RBAC_PROXY_SERVICE_SUFFIX)]

    before = selectors()
    s.warm_follower()
    s.settle()
    s.cluster.fail_pod(REP_NS, f"{REP}-0")
    s.mgr.run_until_idle()
    rep = s.api.get("Notebook", REP_NS, REP).body["status"]["replication"]
    after = selectors()
    s.settle()
    return {"before": before, "primary": rep["primary"], "after": after,
            "resynced": selectors()}


def test_proxy_service_follows_the_promoted_primary():
    """The reference's kube-rbac-proxy Service keeps selecting replica 0's
    gang after a promotion, even after a resync of every controller; the
    port's selects the new primary's, as both stacks' plain Services do."""
    ref, ours = _promoted(False), _promoted(True)
    assert ref["before"] == ours["before"] == ["rep", "rep"]
    assert ref["primary"] == ours["primary"] == 1
    # [plain Service, kube-rbac-proxy Service], once every controller
    # has been resynced
    assert ref["resynced"] == ["rep-r1", "rep"]
    assert ours["resynced"] == ["rep-r1", "rep-r1"]
    # with no resync, the port's ODH reconciler took the promotion from
    # the Notebook's status write itself; the reference's ignored it
    assert (ref["after"][1], ours["after"][1]) == ("rep", "rep-r1")


# -- the lock under the gang scheduler -----------------------------------------


def _locked_then_placed(s: Stack):
    if s.port:
        s.cluster.add_gpu_nodes("h100-80gb", 1, 8)
    else:
        s.cluster.add_tpu_slice_nodes("tpu-v5-lite-podslice", "2x4", 1, 8)
    seen = []

    def on_event(ev):
        ann = ev.obj.metadata.annotations
        step = ("lock" if ann.get(C.STOP_ANNOTATION)
                == C.RECONCILIATION_LOCK_VALUE else "open",
                K.ANNOTATION_PLACEMENT in ann)
        if not seen or seen[-1] != step:
            seen.append(step)
    s.api.watch(on_event, kinds=["Notebook"])
    live = s.create_nb(hosts=1)
    pod = s.api.get("Pod", NS, "wb-0")
    assert seen == [("lock", False), ("open", False), ("open", True)]
    assert C.STOP_ANNOTATION not in live.metadata.annotations
    assert json.loads(live.metadata.annotations[K.ANNOTATION_PLACEMENT]
                      )["slices"]["0"]["nodes"] == [pod.spec["nodeName"]]
    return {"seen": seen,
            "health": live.body["status"].get("sliceHealth")}


def test_scheduler_places_the_gang_once_the_lock_comes_off():
    (ref, ours), (ref_out, our_out) = run_both(
        _locked_then_placed, core={"enable_slice_scheduler": True})
    assert our_out == ref_out
    assert our_out["health"] == "Healthy"
    assert RK.ANNOTATION_PLACEMENT == K.ANNOTATION_PLACEMENT


# -- the VirtualService's render, the TLS profile, the manager's wiring -------


def test_virtual_service_render_matches_the_reference():
    from kubeflow_tpu.api.types import Notebook as RefNotebook
    from kubeflow_tpu.utils.config import CoreConfig as RefCoreConfig
    from kubeflow_tpu_torch.api.types import Notebook
    from kubeflow_tpu_torch.core.workload import generate_virtual_service

    for ann in ({}, {K.ANNOTATION_REWRITE_URI: "  ",
                     K.ANNOTATION_HEADERS_REQUEST_SET: "not json"}):
        cfg = dict(cluster_domain="corp.local", istio_host="h",
                   istio_gateway="ns/gw")
        ref = ref_virtual_service(RefNotebook.new("wb", NS, annotations=ann),
                                  RefCoreConfig(**cfg)).to_dict()
        ours = generate_virtual_service(Notebook.new("wb", NS,
                                                     annotations=ann),
                                        CoreConfig(**cfg))
        assert ours == {k: ref[k] for k in ("apiVersion", "kind", "spec")} \
            | {"metadata": {k: ref["metadata"][k]
                            for k in ("name", "namespace")}}


def _apiserver_cr(k, profile: dict):
    return k.KubeObject(api_version="config.openshift.io/v1",
                        kind="APIServer", metadata=k.ObjectMeta(name="cluster"),
                        body={"spec": {"tlsSecurityProfile": profile}})


@pytest.mark.parametrize("profile", [None, {"type": "Modern"}, {
    "type": "Custom", "custom": {"minTLSVersion": "VersionTLS13",
                                "ciphers": ["TLS_AES_256_GCM_SHA384"]}},
    {"type": "Old"}, {}])
def test_tls_profile_matches_the_reference(profile):
    from kubeflow_tpu import kube as ref_kube

    got = []
    for k, mod in ((ref_kube, ref_tls), (kube, tls_profile)):
        api = k.ApiServer()
        if profile is not None:
            api.create(_apiserver_cr(k, profile))
        got.append(dataclasses.asdict(mod.fetch_apiserver_tls_profile(api)))
    assert got[1] == got[0]
    if not profile:
        assert got[1] == dataclasses.asdict(tls_profile.HARDENED_FALLBACK)


def test_tls_watcher_fires_once_and_stops_the_manager():
    """The watcher fires once on a changed profile, as the reference's;
    `main.build_manager` wires it to stop the manager."""
    from kubeflow_tpu import kube as ref_kube
    from kubeflow_tpu.utils.clock import FakeClock as RefFakeClock

    fired = []
    for k, mod, clock in ((ref_kube, ref_tls, RefFakeClock()),
                          (kube, tls_profile, FakeClock())):
        api = k.ApiServer()
        api.create(_apiserver_cr(k, {"type": "Intermediate"}))
        mgr = k.Manager(api, clock=clock)
        changes = []
        mod.SecurityProfileWatcher(
            api, mod.fetch_apiserver_tls_profile(api),
            lambda old, new: changes.append((old.min_version,
                                             new.min_version))).setup(mgr)
        mgr.run_until_idle()
        for kind in ("Modern", "Old"):
            cr = api.get("APIServer", "", "cluster")
            cr.spec["tlsSecurityProfile"] = {"type": kind}
            api.update(cr)
            mgr.run_until_idle()
        fired.append(changes)
    assert fired[1] == fired[0] == [("VersionTLS12", "VersionTLS13")]

    mgr, api, _, _ = port_main.build_manager(
        CoreConfig(), clock=FakeClock(),
        odh_cfg=OdhConfig(controller_namespace=CENTRAL_NS))
    assert {r.name for r in mgr._registrations} >= {
        "notebook", "odh-notebook", "tls-profile-watcher"}
    # no APIServer CR at the start: the hardened fallback, until one
    # appears with another profile
    mgr.run_until_idle()
    assert not mgr.stopped
    api.create(_apiserver_cr(kube, {"type": "Modern"}))
    mgr.run_until_idle()
    assert mgr.stopped
