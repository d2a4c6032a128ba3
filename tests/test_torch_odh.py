"""The port's ODH admission webhooks against the reference's.

The same scenarios go through the reference's stack (kubeflow_tpu's
ApiServer, FakeCluster, Manager, core controllers and ODH plane) and the
port's (kubeflow_tpu_torch's), each on its own FakeClock, with the
webhooks in the API server's admission chain: the scenarios of
tests/test_odh_webhook.py, each written once and run on both stacks.

- CPU notebooks: every object of both stores (the Notebook with its
  status, the StatefulSets, Services, Events and every ODH object) is
  equal once tests/test_torch_controller.py's STRIPPED fields are
  removed;
- a `spec.tpu` slice against a `spec.gpu` gang of the same host count:
  every ODH object, the CR's metadata and the ODH part of its pod
  template are equal.  The device is all that may differ, each part
  under its own rule: the CR's `spec.tpu` / `spec.gpu`; the main
  container's image, which each stack's swap aims at its own device
  (the reference's default `jupyter-tpu-jax:latest`, the port's
  `jupyter-cuda-pytorch:latest`; an image the user aimed at the device,
  a JAX one on the reference's side and a CUDA one on the port's, is
  kept by both); and the gang's worker NetworkPolicy (in
  tests/test_torch_odh_controller.py).

Only the reference's control plane is imported."""

from __future__ import annotations

import base64
import json

import pytest

from kubeflow_tpu import kube as ref_kube
from kubeflow_tpu.api.types import Notebook as RefNotebook
from kubeflow_tpu.api.types import TPUSpec
from kubeflow_tpu.core.notebook_controller import (
    setup_core_controllers as ref_setup_core,
)
from kubeflow_tpu.odh import constants as RC
from kubeflow_tpu.odh import diff as ref_diff
from kubeflow_tpu.odh import runtime_images as ref_runtime_images
from kubeflow_tpu.odh.controller import setup_odh_controllers as ref_setup_odh
from kubeflow_tpu.odh.gateway import (
    get_hostname_for_public_endpoint as ref_public_endpoint,
)
from kubeflow_tpu.utils import tracing as ref_tracing
from kubeflow_tpu.utils.clock import FakeClock as RefFakeClock
from kubeflow_tpu.utils.config import CoreConfig as RefCoreConfig
from kubeflow_tpu.utils.config import OdhConfig as RefOdhConfig
from kubeflow_tpu_torch import kube
from kubeflow_tpu_torch.api.types import GPUSpec, Notebook
from kubeflow_tpu_torch.core.notebook_controller import setup_core_controllers
from kubeflow_tpu_torch.odh import constants as C
from kubeflow_tpu_torch.odh import diff, runtime_images
from kubeflow_tpu_torch.odh.controller import setup_odh_controllers
from kubeflow_tpu_torch.odh.gateway import get_hostname_for_public_endpoint
from kubeflow_tpu_torch.utils import tracing
from kubeflow_tpu_torch.utils.clock import FakeClock
from kubeflow_tpu_torch.utils.config import CoreConfig, OdhConfig
from test_torch_controller import _stripped

NS, CENTRAL_NS = "user1", "opendatahub"
# hosts of the gang -> (the reference's TPU topology, the port's GPUs):
# the same host count, each a whole host
DEVICES = {1: ("2x4", 8)}
# the compared kinds: the core controller's and everything the ODH plane
# writes
KINDS = ("Notebook", "StatefulSet", "Service", "Event", "ConfigMap",
         "Secret", "ServiceAccount", "NetworkPolicy", "RoleBinding",
         "ClusterRoleBinding", "HTTPRoute", "ReferenceGrant", "OAuthClient",
         "VirtualService")
ODH_KINDS = ("ConfigMap", "Secret", "ServiceAccount", "NetworkPolicy",
             "RoleBinding", "ClusterRoleBinding", "HTTPRoute",
             "ReferenceGrant", "OAuthClient")


def fake_cert(tag: bytes = b"") -> str:
    """tests/test_odh_webhook.py's minimal structurally valid PEM; `tag`
    marks which source contributed it."""
    der = b"\x30\x82\x01\x0a" + tag + b"\x00" * (32 - len(tag))
    return ("-----BEGIN CERTIFICATE-----\n"
            + base64.b64encode(der).decode()
            + "\n-----END CERTIFICATE-----")


FAKE_CERT = fake_cert()


class Stack:
    """One stack with the ODH plane: the reference's (`port=False`) or the
    port's.  `device` scenarios make a spec.tpu slice on the reference's
    and a spec.gpu gang of as many hosts on the port's."""

    def __init__(self, port: bool, core=None, **odh):
        k = kube if port else ref_kube
        self.port, self.kube = port, k
        self.api = k.ApiServer()
        self.cluster = k.FakeCluster(self.api)
        self.cluster.add_node("cpu-node",
                              allocatable={"cpu": "64", "memory": "256Gi"})
        self.clock = FakeClock() if port else RefFakeClock()
        self.mgr = k.Manager(self.api, clock=self.clock)
        (setup_core_controllers if port else ref_setup_core)(
            self.mgr, (CoreConfig if port else RefCoreConfig)(
                enable_self_healing=False, **(core or {})))
        self.cfg = (OdhConfig if port else RefOdhConfig)(
            controller_namespace=CENTRAL_NS, **odh)
        self.rec = (setup_odh_controllers if port else ref_setup_odh)(
            self.mgr, self.cfg)
        self.tracing = tracing if port else ref_tracing
        # what the device scenarios compare under their own rules
        self.default_image = ("jupyter-cuda-pytorch:latest" if port
                              else "jupyter-tpu-jax:latest")
        self.device_image = "my-cuda-image:2" if port else "my-jax-image:2"
        self.mapped_image = "cuda-notebook:9" if port else "tpu-notebook:9"

    # -- objects ---------------------------------------------------------------
    def new_nb(self, name="wb", ns=NS, hosts=None, pod_spec=None,
               annotations=None, labels=None):
        """A Notebook CR of this stack, not yet created; `hosts` makes it
        a slice (reference) or a gang (port) of that many hosts."""
        kw = dict(pod_spec=pod_spec, annotations=annotations, labels=labels)
        if self.port:
            if hosts is not None:
                kw["gpu"] = GPUSpec("h100-80gb", DEVICES[hosts][1])
            return kube.KubeObject.from_dict(
                Notebook.new(name, ns, **kw).obj)
        if hosts is not None:
            kw["tpu"] = TPUSpec("v5e", DEVICES[hosts][0])
        return RefNotebook.new(name, ns, **kw).obj

    def create_nb(self, name="wb", ns=NS, **kw):
        self.api.create(self.new_nb(name, ns, **kw))
        self.mgr.run_until_idle()
        return self.api.get("Notebook", ns, name)

    def make(self, kind, name, ns="", body=None, labels=None,
             api_version="v1", owner=None):
        obj = self.kube.KubeObject(
            api_version=api_version, kind=kind,
            metadata=self.kube.ObjectMeta(name=name, namespace=ns,
                                          labels=dict(labels or {})),
            body=body or {})
        if owner is not None:
            obj.metadata.owner_references.append(owner.owner_reference())
        return self.api.create(obj)

    def make_cm(self, name, key, value, ns=NS):
        return self.make("ConfigMap", name, ns, {"data": {key: value}})

    def update(self, ns, name, fn):
        live = self.api.get("Notebook", ns, name)
        fn(live)
        return self.api.update(live)

    def denied(self, fn) -> str:
        """fn() must be refused by admission: the refusal's message."""
        with pytest.raises(self.kube.ForbiddenError) as err:
            fn()
        return str(err.value)

    # -- snapshots -------------------------------------------------------------
    def snapshot(self, kinds=KINDS) -> dict:
        return {kind: sorted((_stripped(o.to_dict())
                              for o in self.api.list(kind)),
                             key=lambda d: (d["metadata"].get("namespace",
                                                              ""),
                                            d["metadata"]["name"]))
                for kind in kinds}

    def device_snapshot(self) -> dict:
        """The ODH objects and the CR but its device: `spec.tpu` /
        `spec.gpu`, its status (the core controller's, held to the
        reference in tests/test_torch_controller.py) and the main
        container's image, which the scenarios compare under their
        rule.  The worker NetworkPolicy is left to its own test."""
        snap = self.snapshot(ODH_KINDS)
        snap["NetworkPolicy"] = [p for p in snap["NetworkPolicy"]
                                 if not p["metadata"]["name"].endswith(
                                     "-workers-np")]
        snap.update(self.snapshot(("Notebook",)))
        for nb in snap["Notebook"]:
            nb["spec"].pop("tpu", None)
            nb["spec"].pop("gpu", None)
            nb.pop("status", None)
            for c in nb["spec"]["template"]["spec"]["containers"]:
                if c["name"] == nb["metadata"]["name"]:
                    c.pop("image", None)
        return snap


def pod_spec(live) -> dict:
    return live.spec["template"]["spec"]


def main_of(live) -> dict:
    return pod_spec(live)["containers"][0]


def env_of(container) -> dict:
    return {e["name"]: e.get("value") for e in container.get("env") or []}


def volumes(live) -> list:
    return [v["name"] for v in pod_spec(live).get("volumes") or []]


# -- the reconciliation lock ----------------------------------------------------


def _lock_on_create(s: Stack):
    created = s.api.create(s.new_nb())
    stamped = created.metadata.annotations.get(C.STOP_ANNOTATION)
    assert stamped == C.RECONCILIATION_LOCK_VALUE
    s.mgr.run_until_idle()
    live = s.api.get("Notebook", NS, "wb")
    assert C.STOP_ANNOTATION not in live.metadata.annotations
    sts = s.api.get("StatefulSet", NS, "wb")
    assert sts.spec["replicas"] == 1
    return {"stamped": stamped, "replicas": sts.spec["replicas"]}


def _lock_not_on_update(s: Stack):
    s.create_nb()
    s.update(NS, "wb", lambda nb: nb.metadata.labels.update(touched="true"))
    live = s.api.get("Notebook", NS, "wb")
    assert C.STOP_ANNOTATION not in live.metadata.annotations
    return {"annotations": dict(live.metadata.annotations)}


# -- image resolution --------------------------------------------------------------


def _imagestream(s: Stack, ns=CENTRAL_NS):
    s.make("ImageStream", "datascience-notebook", ns, {"status": {"tags": [{
        "tag": "2024.1",
        "items": [{"created": "2024-01-01T00:00:00Z",
                   "dockerImageReference": "registry/ds@sha256:old"},
                  {"created": "2024-06-01T00:00:00Z",
                   "dockerImageReference": "registry/ds@sha256:new"}]}]}},
        api_version="image.openshift.io/v1")


def _imagestream_newest(s: Stack):
    _imagestream(s)
    live = s.create_nb(
        annotations={C.ANNOTATION_LAST_IMAGE_SELECTION:
                     "datascience-notebook:2024.1"},
        pod_spec={"containers": [{
            "name": "wb", "image": "stale",
            "env": [{"name": "JUPYTER_IMAGE", "value": "x"}]}]})
    main = main_of(live)
    assert main["image"] == "registry/ds@sha256:new"
    assert env_of(main)["JUPYTER_IMAGE"] == "datascience-notebook:2024.1"
    return {"main": main}


def _imagestream_internal_registry(s: Stack):
    _imagestream(s)
    image = "image-registry.openshift-image-registry.svc:5000/ns/img:1"
    live = s.create_nb(
        annotations={C.ANNOTATION_LAST_IMAGE_SELECTION:
                     "datascience-notebook:2024.1"},
        pod_spec={"containers": [{"name": "wb", "image": image}]})
    assert main_of(live)["image"] == image
    return {"image": image}


def _imagestream_missing_span_event(s: Stack):
    exporter = s.tracing.InMemorySpanExporter()
    s.tracing.set_exporter(exporter)
    try:
        s.create_nb(annotations={C.ANNOTATION_LAST_IMAGE_SELECTION: "nope:1"},
                    pod_spec={"containers": [{"name": "wb",
                                              "image": "stale"}]})
    finally:
        s.tracing.set_exporter(None)
    handles = exporter.find("NotebookWebhook.Handle")
    events = sorted({e.name for span in handles for e in span.events})
    assert "ImageStreamNotFound" in events
    return {"handle_spans": len(handles), "events": events,
            "operations": sorted({sp.attributes["operation"]
                                  for sp in handles})}


def _imagestream_no_tags_denied(s: Stack):
    s.make("ImageStream", "empty", CENTRAL_NS, {"status": {}},
           api_version="image.openshift.io/v1")
    exporter = s.tracing.InMemorySpanExporter()
    s.tracing.set_exporter(exporter)
    try:
        with pytest.raises(ValueError, match="no status or tags"):
            s.api.create(s.new_nb(
                annotations={C.ANNOTATION_LAST_IMAGE_SELECTION: "empty:1"}))
    finally:
        s.tracing.set_exporter(None)
    assert "ImageStreamTagNotFound" in exporter.events()
    return {"events": exporter.events()}


# -- the CA bundle -----------------------------------------------------------------


def _install_bundles(s: Stack):
    s.make("ConfigMap", C.ODH_TRUSTED_CA_BUNDLE_CONFIGMAP, NS,
           {"data": {"ca-bundle.crt": FAKE_CERT, "odh-ca-bundle.crt": ""}})
    s.make_cm(C.KUBE_ROOT_CA_CONFIGMAP, "ca.crt", FAKE_CERT)


def _ca_built_and_mounted(s: Stack):
    _install_bundles(s)
    first = s.create_nb(name="first")  # the first notebook builds the CM
    cm = s.api.get("ConfigMap", NS, C.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP)
    assert cm.body["data"]["ca-bundle.crt"].count("BEGIN CERTIFICATE") == 2
    # the bundle now exists: the next notebook mounts it at CREATE
    live = s.create_nb(name="wb")
    assert C.TRUSTED_CA_BUNDLE_VOLUME in volumes(live)
    assert set(C.CA_BUNDLE_ENV_VARS) <= set(env_of(main_of(live)))
    return {"first_volumes": volumes(first), "volumes": volumes(live),
            "first_pending": first.metadata.annotations.get(
                C.ANNOTATION_UPDATE_PENDING)}


def _ca_invalid_pem_skipped(s: Stack):
    s.make_cm(C.ODH_TRUSTED_CA_BUNDLE_CONFIGMAP, "ca-bundle.crt",
              "not a certificate")
    s.create_nb()
    cm = s.api.try_get("ConfigMap", NS, C.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP)
    assert cm is None
    return {"built": cm is not None}


def _ca_unset_when_deleted(s: Stack):
    _install_bundles(s)
    s.create_nb(name="first")
    live = s.create_nb(name="wb")
    assert C.TRUSTED_CA_BUNDLE_VOLUME in volumes(live)
    s.api.delete("ConfigMap", NS, C.ODH_TRUSTED_CA_BUNDLE_CONFIGMAP)
    s.api.delete("ConfigMap", NS, C.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP)
    s.mgr.run_until_idle()
    live = s.api.get("Notebook", NS, "wb")
    assert C.TRUSTED_CA_BUNDLE_VOLUME not in volumes(live)
    assert not set(C.CA_BUNDLE_ENV_VARS) & set(env_of(main_of(live)))
    return {"volumes": volumes(live)}


def _ca_three_sources(s: Stack):
    odh, root, svc = (fake_cert(b"odh"), fake_cert(b"root"),
                      fake_cert(b"svc"))
    s.make_cm(C.ODH_TRUSTED_CA_BUNDLE_CONFIGMAP, C.TRUSTED_CA_BUNDLE_FILE, odh)
    s.make_cm(C.KUBE_ROOT_CA_CONFIGMAP, "ca.crt", root)
    s.make_cm(C.OPENSHIFT_SERVICE_CA_CONFIGMAP, "service-ca.crt", svc)
    s.create_nb()
    merged = s.api.get("ConfigMap", NS, C.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP
                       ).body["data"][C.TRUSTED_CA_BUNDLE_FILE]
    assert [merged.count(c) for c in (odh, root, svc)] == [1, 1, 1]
    return {"merged": merged}


def _ca_absent_odh_bundle_gates(s: Stack):
    s.make_cm(C.KUBE_ROOT_CA_CONFIGMAP, "ca.crt", FAKE_CERT)
    s.make_cm(C.OPENSHIFT_SERVICE_CA_CONFIGMAP, "service-ca.crt", FAKE_CERT)
    s.create_nb()
    built = s.api.try_get("ConfigMap", NS,
                          C.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP)
    assert built is None
    return {"built": False}


def _ca_empty_odh_key(s: Stack):
    s.make_cm(C.ODH_TRUSTED_CA_BUNDLE_CONFIGMAP, C.TRUSTED_CA_BUNDLE_FILE, "")
    s.make_cm(C.KUBE_ROOT_CA_CONFIGMAP, "ca.crt", FAKE_CERT)
    s.create_nb()
    built = s.api.try_get("ConfigMap", NS,
                          C.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP)
    assert built is None
    return {"built": False}


# -- the kube-rbac-proxy sidecar ---------------------------------------------------


def _sidecar(live) -> dict:
    return next(c for c in pod_spec(live)["containers"]
                if c["name"] == C.KUBE_RBAC_PROXY_CONTAINER_NAME)


def _sidecar_injected(s: Stack):
    live = s.create_nb(annotations={C.ANNOTATION_INJECT_AUTH: "true"})
    sidecar = _sidecar(live)
    assert "--secure-listen-address=0.0.0.0:8443" in sidecar["args"]
    assert sidecar["resources"] == {
        "requests": {"cpu": "100m", "memory": "64Mi"},
        "limits": {"cpu": "100m", "memory": "64Mi"}}
    assert {"kube-rbac-proxy-config", "kube-rbac-proxy-tls-certificates"} \
        <= set(volumes(live))
    assert pod_spec(live)["serviceAccountName"] == "wb"
    return {"sidecar": sidecar}


def _sidecar_resources_from_annotations(s: Stack):
    live = s.create_nb(annotations={
        C.ANNOTATION_INJECT_AUTH: "true",
        C.ANNOTATION_AUTH_SIDECAR_CPU_REQUEST: "250m",
        C.ANNOTATION_AUTH_SIDECAR_MEMORY_LIMIT: "256Mi"})
    resources = _sidecar(live)["resources"]
    assert resources == {"requests": {"cpu": "250m", "memory": "64Mi"},
                         "limits": {"cpu": "250m", "memory": "256Mi"}}
    return {"resources": resources}


def _sidecar_invalid_resources_denied(s: Stack):
    out = {}
    for key, value in ((C.ANNOTATION_AUTH_SIDECAR_CPU_REQUEST,
                        "not-a-quantity"),
                       (C.ANNOTATION_AUTH_SIDECAR_MEMORY_LIMIT, "0")):
        out[value] = s.denied(lambda: s.api.create(s.new_nb(annotations={
            C.ANNOTATION_INJECT_AUTH: "true", key: value})))
    assert s.api.try_get("Notebook", NS, "wb") is None
    return out


# -- restart blocking ----------------------------------------------------------


def _workbench_bundle(s: Stack):
    s.make_cm(C.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP, "ca-bundle.crt",
              FAKE_CERT)


def _restart_webhook_change_blocked(s: Stack):
    s.create_nb()
    _workbench_bundle(s)
    s.update(NS, "wb", lambda nb: nb.metadata.labels.update(touch="1"))
    live = s.api.get("Notebook", NS, "wb")
    assert C.TRUSTED_CA_BUNDLE_VOLUME not in volumes(live)
    pending = live.metadata.annotations[C.ANNOTATION_UPDATE_PENDING]
    assert pending
    return {"pending": pending}


def _restart_user_change_not_blocked(s: Stack):
    s.create_nb()
    _workbench_bundle(s)
    s.update(NS, "wb", lambda nb: main_of(nb).update(image="new-image:2"))
    live = s.api.get("Notebook", NS, "wb")
    assert C.TRUSTED_CA_BUNDLE_VOLUME in volumes(live)
    assert C.ANNOTATION_UPDATE_PENDING not in live.metadata.annotations
    return {"volumes": volumes(live)}


def _restart_stopped_not_blocked(s: Stack):
    s.create_nb()
    _workbench_bundle(s)
    s.update(NS, "wb", lambda nb: nb.metadata.annotations.update(
        {C.STOP_ANNOTATION: "2024-01-01T00:00:00Z"}))
    live = s.api.get("Notebook", NS, "wb")
    assert C.TRUSTED_CA_BUNDLE_VOLUME in volumes(live)
    return {"volumes": volumes(live)}


# -- Feast, MLflow, the cluster proxy ------------------------------------------


def _feast_mount_unmount(s: Stack):
    live = s.create_nb(labels={C.LABEL_FEAST_INTEGRATION: "true"})
    assert C.FEAST_VOLUME_NAME in volumes(live)
    mount = next(m for m in main_of(live)["volumeMounts"]
                 if m["name"] == C.FEAST_VOLUME_NAME)
    assert mount["mountPath"] == C.FEAST_MOUNT_PATH

    def unlabel(nb):
        del nb.metadata.labels[C.LABEL_FEAST_INTEGRATION]
        nb.metadata.annotations[C.STOP_ANNOTATION] = "stopped"
    s.update(NS, "wb", unlabel)
    after = s.api.get("Notebook", NS, "wb")
    assert C.FEAST_VOLUME_NAME not in volumes(after)
    return {"mounted": volumes(live), "unmounted": volumes(after)}


def _gateway(s: Stack):
    s.make("Gateway", "data-science-gateway", "openshift-ingress",
           {"spec": {"listeners": [{"hostname": "apps.example.com"}]}},
           api_version="gateway.networking.k8s.io/v1")


def _cluster_role(s: Stack):
    s.make("ClusterRole", C.MLFLOW_CLUSTER_ROLE, body={"rules": []},
           api_version="rbac.authorization.k8s.io/v1")


def _mlflow_env(s: Stack):
    _gateway(s)
    live = s.create_nb(annotations={C.ANNOTATION_MLFLOW_INSTANCE: "team-a"})
    env = env_of(main_of(live))
    assert env[C.MLFLOW_TRACKING_URI_ENV] == \
        "https://apps.example.com/mlflow-team-a"
    assert env[C.MLFLOW_K8S_INTEGRATION_ENV] == "true"
    assert env[C.MLFLOW_TRACKING_AUTH_ENV] == "kubernetes-namespaced"
    return {"env": env}


def _mlflow_rolebinding_waits(s: Stack):
    s.create_nb(annotations={C.ANNOTATION_MLFLOW_INSTANCE: "mlflow"})
    before = s.api.try_get("RoleBinding", NS, "wb-mlflow")
    assert before is None and s.mgr.pending_delayed()
    _cluster_role(s)
    s.mgr.advance(31)
    rb = s.api.get("RoleBinding", NS, "wb-mlflow")
    assert rb.body["roleRef"]["name"] == C.MLFLOW_CLUSTER_ROLE
    return {"delayed": len(s.mgr.pending_delayed())}


def _mlflow_removal_denied(s: Stack):
    _cluster_role(s)
    s.create_nb(annotations={C.ANNOTATION_MLFLOW_INSTANCE: "mlflow"})

    def drop(nb):
        del nb.metadata.annotations[C.ANNOTATION_MLFLOW_INSTANCE]
    refused = s.denied(lambda: s.update(NS, "wb", drop))
    # a stopped notebook may drop it
    s.update(NS, "wb", lambda nb: nb.metadata.annotations.update(
        {C.STOP_ANNOTATION: "stopped"}))
    s.update(NS, "wb", drop)
    s.mgr.run_until_idle()
    assert s.api.try_get("RoleBinding", NS, "wb-mlflow") is None
    return {"refused": refused}


def _proxy_cr(s: Stack, http="http://proxy:3128", https="https://proxy:3129",
              no="cluster.local"):
    s.make("Proxy", "cluster", body={"status": {
        "httpProxy": http, "httpsProxy": https, "noProxy": no}},
        api_version="config.openshift.io/v1")


def _proxy_env_injected(s: Stack):
    _proxy_cr(s)
    env = env_of(main_of(s.create_nb()))
    assert {k: env[k] for k in C.PROXY_ENV_VARS} == {
        "HTTP_PROXY": "http://proxy:3128", "HTTPS_PROXY": "https://proxy:3129",
        "NO_PROXY": "cluster.local"}
    return {"env": env}


def _proxy_user_value_overwritten(s: Stack):
    _proxy_cr(s, https="", no="")
    live = s.create_nb(pod_spec={"containers": [{
        "name": "wb", "env": [{"name": "HTTP_PROXY",
                               "value": "http://stale:1"}]}]})
    env = main_of(live)["env"]
    assert env == [{"name": "HTTP_PROXY", "value": "http://proxy:3128"}]
    return {"env": env}


def _proxy_no_cr(s: Stack):
    env = env_of(main_of(s.create_nb()))
    assert not set(C.PROXY_ENV_VARS) & set(env)
    return {"env": env}


def _proxy_off_by_default(s: Stack):
    _proxy_cr(s)
    env = env_of(main_of(s.create_nb()))
    assert "HTTP_PROXY" not in env
    return {"env": env}


# -- the Elyra secret, runtime images ---------------------------------------------


def _dspa(s: Stack, ns=NS, **overrides):
    spec = {"objectStorage": {"externalStorage": {
        "host": "minio.svc", "scheme": "http", "bucket": "pipelines",
        "s3CredentialSecret": {"secretName": "s3-creds",
                               "accessKey": "AWS_ACCESS_KEY_ID",
                               "secretKey": "AWS_SECRET_ACCESS_KEY"}}}}
    spec.update(overrides)
    s.make("DataSciencePipelinesApplication", "dspa", ns, {
        "spec": spec, "status": {"components": {"apiServer": {
            "externalUrl": "https://dspa.apps/pipelines"}}}},
        api_version="datasciencepipelinesapplications.opendatahub.io/v1")


def _s3_secret(s: Stack, ns=NS):
    s.make("Secret", "s3-creds", ns, {"data": {
        "AWS_ACCESS_KEY_ID": base64.b64encode(b"minio-user").decode(),
        "AWS_SECRET_ACCESS_KEY": base64.b64encode(b"minio-pass").decode()}})


def _elyra_payload(s: Stack) -> dict:
    secret = s.api.get("Secret", NS, C.ELYRA_SECRET_NAME)
    return json.loads(base64.b64decode(secret.body["data"][C.ELYRA_SECRET_KEY]))


def _elyra_built_and_mounted(s: Stack):
    _dspa(s)
    _s3_secret(s)
    live = s.create_nb()
    payload = _elyra_payload(s)
    md = payload["metadata"]
    assert payload["schema_name"] == "kfp"
    assert (md["api_endpoint"], md["cos_endpoint"], md["cos_bucket"],
            md["cos_username"], md["cos_password"]) == (
        "https://dspa.apps/pipelines", "http://minio.svc", "pipelines",
        "minio-user", "minio-pass")
    (ref,) = s.api.get("Secret", NS, C.ELYRA_SECRET_NAME
                       ).metadata.owner_references
    assert ref.kind == "DataSciencePipelinesApplication"
    mount = next(m for m in main_of(live)["volumeMounts"]
                 if m["name"] == C.ELYRA_VOLUME_NAME)
    assert mount["mountPath"] == C.ELYRA_MOUNT_PATH
    return {"payload": payload}


def _elyra_no_dspa(s: Stack):
    s.create_nb()
    assert s.api.try_get("Secret", NS, C.ELYRA_SECRET_NAME) is None
    return {}


def _elyra_broken_dspa(s: Stack):
    _dspa(s, objectStorage={})
    live = s.create_nb()
    assert s.api.try_get("Secret", NS, C.ELYRA_SECRET_NAME) is None
    assert C.ELYRA_VOLUME_NAME in volumes(live)
    return {"volumes": volumes(live)}


def _elyra_public_endpoint_listener(s: Stack):
    s.make("Gateway", s.cfg.gateway_name, s.cfg.gateway_namespace,
           {"spec": {"listeners": [{"name": "https",
                                    "hostname": "ds.apps.example.com"}]}},
           api_version="gateway.networking.k8s.io/v1")
    _dspa(s)
    _s3_secret(s)
    s.create_nb()
    endpoint = _elyra_payload(s)["metadata"]["public_api_endpoint"]
    assert endpoint == "https://ds.apps.example.com/external/elyra/user1"
    return {"endpoint": endpoint}


def _elyra_route_fallback_labelled(s: Stack):
    gw = s.make("Gateway", s.cfg.gateway_name, s.cfg.gateway_namespace,
                {"spec": {"listeners": [{"name": "https"}]}},
                api_version="gateway.networking.k8s.io/v1")
    s.make("Route", "stray", s.cfg.gateway_namespace,
           {"spec": {"host": "stray.apps"}},
           api_version="route.openshift.io/v1")
    s.make("Route", "gw-route", s.cfg.gateway_namespace,
           {"spec": {"host": "gw.apps.example.com"}},
           labels={"gateway.networking.k8s.io/gateway-name": gw.name},
           api_version="route.openshift.io/v1")
    _dspa(s)
    _s3_secret(s)
    s.create_nb()
    endpoint = _elyra_payload(s)["metadata"]["public_api_endpoint"]
    assert endpoint == "https://gw.apps.example.com/external/elyra/user1"
    return {"endpoint": endpoint}


def _elyra_route_fallback_owned(s: Stack):
    gw = s.make("Gateway", s.cfg.gateway_name, s.cfg.gateway_namespace,
                {"spec": {"listeners": [{"name": "https"}]}},
                api_version="gateway.networking.k8s.io/v1")
    stranger = s.make("ConfigMap", "stranger", s.cfg.gateway_namespace)
    s.make("Route", "a-decoy", s.cfg.gateway_namespace,
           {"spec": {"host": "decoy.apps.example.com"}},
           api_version="route.openshift.io/v1", owner=stranger)
    s.make("Route", "gw-owned", s.cfg.gateway_namespace,
           {"spec": {"host": "owned.apps.example.com"}},
           api_version="route.openshift.io/v1", owner=gw)
    public = get_hostname_for_public_endpoint if s.port \
        else ref_public_endpoint
    host = public(s.api, s.cfg)
    assert host == "owned.apps.example.com"
    return {"host": host}


def _elyra_follows_dspa(s: Stack):
    _dspa(s)
    _s3_secret(s)
    s.create_nb()
    dspa = s.api.get("DataSciencePipelinesApplication", NS, "dspa")
    dspa.spec["objectStorage"]["externalStorage"]["bucket"] = "nextgen"
    s.api.update(dspa)
    s.mgr.run_until_idle()
    s.update(NS, "wb", lambda nb: nb.metadata.labels.update(touch="1"))
    s.mgr.run_until_idle()
    assert _elyra_payload(s)["metadata"]["cos_bucket"] == "nextgen"
    return {}


def _runtime_imagestream(s: Stack, name, labels):
    s.make("ImageStream", name, CENTRAL_NS, {"spec": {"tags": [{
        "name": "2024.1", "from": {"name": "registry/runtime:2024.1"},
        "annotations": {C.ANNOTATION_RUNTIME_IMAGE_METADATA:
                        '[{"display_name": "Data Science Runtime", '
                        '"metadata": {}}]'}}]}},
        labels=labels, api_version="image.openshift.io/v1")


def _runtime_images_unlabelled(s: Stack):
    _runtime_imagestream(s, "plain-is", {})
    s.create_nb()
    assert s.api.try_get("ConfigMap", NS, C.RUNTIME_IMAGES_CONFIGMAP) is None
    return {}


def _runtime_images_synced(s: Stack):
    _runtime_imagestream(s, "runtime-ds", {C.LABEL_RUNTIME_IMAGE: "true"})
    live = s.create_nb()
    data = s.api.get("ConfigMap", NS, C.RUNTIME_IMAGES_CONFIGMAP).body["data"]
    assert "registry/runtime:2024.1" in data["data-science-runtime.json"]
    mount = next(m for m in main_of(live)["volumeMounts"]
                 if m["name"] == C.RUNTIME_IMAGES_VOLUME)
    assert mount["mountPath"] == C.RUNTIME_IMAGES_MOUNT_PATH
    return {"data": data}


# scenario -> (function, the OdhConfig fields both stacks run with)
CPU_SCENARIOS = {
    "lock_on_create": (_lock_on_create, {}),
    "lock_not_on_update": (_lock_not_on_update, {}),
    "imagestream_newest": (_imagestream_newest, {}),
    "imagestream_internal_registry": (_imagestream_internal_registry, {}),
    "imagestream_missing_span_event": (_imagestream_missing_span_event, {}),
    "imagestream_no_tags_denied": (_imagestream_no_tags_denied, {}),
    "ca_built_and_mounted": (_ca_built_and_mounted, {}),
    "ca_invalid_pem_skipped": (_ca_invalid_pem_skipped, {}),
    "ca_unset_when_deleted": (_ca_unset_when_deleted, {}),
    "ca_three_sources": (_ca_three_sources, {}),
    "ca_absent_odh_bundle_gates": (_ca_absent_odh_bundle_gates, {}),
    "ca_empty_odh_key": (_ca_empty_odh_key, {}),
    "sidecar_injected": (_sidecar_injected, {}),
    "sidecar_resources_from_annotations": (
        _sidecar_resources_from_annotations, {}),
    "sidecar_invalid_resources_denied": (
        _sidecar_invalid_resources_denied, {}),
    "restart_webhook_change_blocked": (_restart_webhook_change_blocked, {}),
    "restart_user_change_not_blocked": (_restart_user_change_not_blocked, {}),
    "restart_stopped_not_blocked": (_restart_stopped_not_blocked, {}),
    "feast_mount_unmount": (_feast_mount_unmount, {}),
    "mlflow_env": (_mlflow_env, {"mlflow_enabled": True}),
    "mlflow_rolebinding_waits": (_mlflow_rolebinding_waits, {
        "mlflow_enabled": True, "gateway_url": "apps.example.com"}),
    "mlflow_removal_denied": (_mlflow_removal_denied, {
        "mlflow_enabled": True, "gateway_url": "apps.example.com"}),
    "proxy_env_injected": (_proxy_env_injected,
                           {"inject_cluster_proxy_env": True}),
    "proxy_user_value_overwritten": (_proxy_user_value_overwritten,
                                     {"inject_cluster_proxy_env": True}),
    "proxy_no_cr": (_proxy_no_cr, {"inject_cluster_proxy_env": True}),
    "proxy_off_by_default": (_proxy_off_by_default, {}),
    "elyra_built_and_mounted": (_elyra_built_and_mounted,
                                {"set_pipeline_secret": True}),
    "elyra_no_dspa": (_elyra_no_dspa, {"set_pipeline_secret": True}),
    "elyra_broken_dspa": (_elyra_broken_dspa, {"set_pipeline_secret": True}),
    "elyra_public_endpoint_listener": (_elyra_public_endpoint_listener,
                                       {"set_pipeline_secret": True}),
    "elyra_route_fallback_labelled": (_elyra_route_fallback_labelled,
                                      {"set_pipeline_secret": True}),
    "elyra_route_fallback_owned": (_elyra_route_fallback_owned,
                                   {"set_pipeline_secret": True}),
    "elyra_follows_dspa": (_elyra_follows_dspa, {"set_pipeline_secret": True}),
    "runtime_images_unlabelled": (_runtime_images_unlabelled, {}),
    "runtime_images_synced": (_runtime_images_synced, {}),
}


def run_both(fn, core=None, **odh):
    """fn on the reference's stack, then on the port's: (stacks, results)."""
    stacks = [Stack(port, core=core, **odh) for port in (False, True)]
    return stacks, [fn(s) for s in stacks]


@pytest.mark.parametrize("scenario", CPU_SCENARIOS)
def test_cpu_notebook_webhooks_match_the_reference(scenario):
    fn, odh = CPU_SCENARIOS[scenario]
    (ref, ours), (ref_out, our_out) = run_both(fn, **odh)
    assert our_out == ref_out
    assert ours.snapshot() == ref.snapshot()


# -- a GPU gang against a TPU slice of the same host count ---------------------


def _swap_default(s: Stack):
    live = s.create_nb(hosts=1, pod_spec={"containers": [
        {"name": "wb", "image": "cuda-notebook:1" if not s.port
         else "minimal-notebook:1"}]})
    assert main_of(live)["image"] == s.default_image
    return {}


def _swap_mapped(s: Stack):
    live = s.create_nb(hosts=1, pod_spec={"containers": [
        {"name": "wb", "image": "cuda-notebook:1" if not s.port
         else "jax-notebook:1"}]})
    assert main_of(live)["image"] == s.mapped_image
    return {}


def _swap_device_image_kept(s: Stack):
    live = s.create_nb(hosts=1, pod_spec={"containers": [
        {"name": "wb", "image": s.device_image}]})
    assert main_of(live)["image"] == s.device_image
    return {}


def _swap_cpu_untouched(s: Stack):
    live = s.create_nb(pod_spec={"containers": [{"name": "wb",
                                                 "image": "minimal:1"}]})
    assert main_of(live)["image"] == "minimal:1"
    return {}


def _device_gang_edit_not_blocked(s: Stack):
    """The carve-out: an edit of spec.tpu (reference) or spec.gpu (port)
    restarts the whole slice or gang, so the webhook's own changes pass."""
    s.create_nb(hosts=1, pod_spec={"containers": [{
        "name": "wb", "image": s.device_image}]})
    _workbench_bundle(s)

    def grow(nb):
        if s.port:
            nb.spec["gpu"]["count"] = 4
        else:
            nb.spec["tpu"]["topology"] = "2x2"
    s.update(NS, "wb", grow)
    live = s.api.get("Notebook", NS, "wb")
    assert C.TRUSTED_CA_BUNDLE_VOLUME in volumes(live)
    assert C.ANNOTATION_UPDATE_PENDING not in live.metadata.annotations
    return {"volumes": volumes(live)}


def _device_odh_life(s: Stack):
    """A slice or gang through every mutation at once: auth, the CA
    bundle, Feast, MLflow, the Elyra secret and the runtime images."""
    _install_bundles(s)
    _gateway(s)
    _cluster_role(s)
    _dspa(s)
    _s3_secret(s)
    _runtime_imagestream(s, "runtime-ds", {C.LABEL_RUNTIME_IMAGE: "true"})
    s.create_nb(name="first", hosts=1)
    live = s.create_nb(hosts=1, labels={C.LABEL_FEAST_INTEGRATION: "true"},
                       annotations={C.ANNOTATION_INJECT_AUTH: "true",
                                    C.ANNOTATION_MLFLOW_INSTANCE: "team-a"})
    assert main_of(live)["image"] == s.default_image
    assert {C.TRUSTED_CA_BUNDLE_VOLUME, C.FEAST_VOLUME_NAME,
            C.ELYRA_VOLUME_NAME, C.RUNTIME_IMAGES_VOLUME} <= set(volumes(live))
    assert _sidecar(live)["ports"][0]["containerPort"] == 8443
    return {}


DEVICE_SCENARIOS = {
    "swap_default": (_swap_default, {}),
    "swap_mapped": (_swap_mapped, {}),
    "swap_device_image_kept": (_swap_device_image_kept, {}),
    "swap_cpu_untouched": (_swap_cpu_untouched, {}),
    "gang_edit_not_blocked": (_device_gang_edit_not_blocked, {}),
    "odh_life": (_device_odh_life, {"mlflow_enabled": True,
                                    "set_pipeline_secret": True,
                                    "set_pipeline_rbac": True}),
}


@pytest.mark.parametrize("scenario", DEVICE_SCENARIOS)
def test_gpu_gang_webhooks_match_the_tpu_slice(scenario):
    fn, odh = DEVICE_SCENARIOS[scenario]
    stacks = []
    for port in (False, True):
        extra = dict(odh)
        if scenario == "swap_mapped":
            source = "jax-notebook:1" if port else "cuda-notebook:1"
            # the map's target carries its device's marker, or the next
            # admission of the CR swaps it again
            extra["gpu_image_map" if port else "tpu_image_map"] = {
                source: "cuda-notebook:9" if port else "tpu-notebook:9"}
        s = Stack(port, **extra)
        fn(s)
        stacks.append(s)
    ref, ours = stacks
    assert ours.device_snapshot() == ref.device_snapshot()


def test_gpu_default_image_env():
    """GPU_DEFAULT_IMAGE is the twin of TPU_DEFAULT_IMAGE, and every other
    OdhConfig field reads the reference's env name."""
    env = {"SET_PIPELINE_RBAC": "true", "SET_PIPELINE_SECRET": "true",
           "INJECT_CLUSTER_PROXY_ENV": "true", "MLFLOW_ENABLED": "true",
           "GATEWAY_URL": "gw.example", "NOTEBOOK_GATEWAY_NAME": "gw",
           "NOTEBOOK_GATEWAY_NAMESPACE": "ingress", "K8S_NAMESPACE": "ctl",
           "KUBE_RBAC_PROXY_IMAGE": "proxy:2",
           "GPU_DEFAULT_IMAGE": "cuda-wb:3", "TPU_DEFAULT_IMAGE": "jax-wb:3"}
    for e in ({}, env):
        ours, ref = OdhConfig.from_env(e), RefOdhConfig.from_env(e)
        for f in ("set_pipeline_rbac", "set_pipeline_secret",
                  "inject_cluster_proxy_env", "mlflow_enabled", "gateway_url",
                  "gateway_name", "gateway_namespace", "controller_namespace",
                  "kube_rbac_proxy_image"):
            assert getattr(ours, f) == getattr(ref, f), f
    assert OdhConfig.from_env(env).gpu_default_image == "cuda-wb:3"
    assert OdhConfig.from_env({}).gpu_default_image == \
        "jupyter-cuda-pytorch:latest"


# -- the pure helpers ----------------------------------------------------------


DIFF_CASES = [
    ({"spec": {"containers": [{"name": "wb", "image": "jupyter:1"}]}},
     {"spec": {"containers": [{"name": "wb", "image": "jupyter:2"}]}}),
    ({"a": 1}, {}), ({"envs": [1]}, {"envs": [1, 2]}),
    ({"replicas": 1}, {"replicas": "1"}),
    ({"x": [1, {"y": 2}]}, {"x": [1, {"y": 2}]}),
]


def test_first_difference_and_runtime_image_helpers_match_the_reference():
    got = [diff.first_difference(a, b) for a, b in DIFF_CASES]
    assert got == [ref_diff.first_difference(a, b) for a, b in DIFF_CASES]
    assert got[0] == ".spec.containers[0].image: 'jupyter:1' != 'jupyter:2'"
    assert got[2] == ".envs[1]: <absent> != 2" and got[4] == ""
    names = ["Data Science Runtime", "  PyTorch + CUDA (2024a)! ", "___", ""]
    assert [runtime_images.format_key_name(n) for n in names] == \
        [ref_runtime_images.format_key_name(n) for n in names] == \
        ["data-science-runtime.json", "pytorch-cuda-2024a.json", "", ""]
    raws = ["not json", "{}", "[]", '[{"display_name": "R", "metadata": {}}]']
    assert [runtime_images.parse_runtime_image_metadata(r, "reg/r:1")
            for r in raws] == \
        [ref_runtime_images.parse_runtime_image_metadata(r, "reg/r:1")
         for r in raws]
    assert C.__dict__.keys() - {"__builtins__", "__cached__", "__file__",
                                "__loader__", "__name__", "__package__",
                                "__spec__", "__doc__"} == \
        RC.__dict__.keys() - {"__builtins__", "__cached__", "__file__",
                              "__loader__", "__name__", "__package__",
                              "__spec__", "__doc__",
                              "TPU_WORKER_NETWORK_POLICY_SUFFIX"}
    for name in dir(C):
        if name.isupper():
            assert getattr(C, name) == getattr(RC, name), name
