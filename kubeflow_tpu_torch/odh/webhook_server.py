"""HTTPS AdmissionReview v1 server + apiserver-side webhook callout.

The port's copy of kubeflow_tpu/odh/webhook_server.py.

The reference serves its admission webhooks from the manager's webhook
server (odh main.go:285-311 registers /mutate-notebook-v1 and
/validate-notebook-v1 with TLS from the serving-cert secret).  Here the same
AdmissionHook objects that the in-memory ApiServer runs in-process are
exposed over real HTTPS speaking the AdmissionReview v1 wire format:
request.object/oldObject in, JSONPatch (mutating) or allowed=false
(validating) out.

`RemoteAdmissionHook` is the other half of the choreography: installed into
a (wire-served) ApiServer it POSTs the AdmissionReview to the webhook URL
during the write path and applies the returned patch — exactly what a real
kube-apiserver does with a MutatingWebhookConfiguration, so integration
tests exercise admission over real sockets end to end.
"""

from __future__ import annotations

import base64
import json
import logging
import ssl
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..kube import AdmissionDenied, AdmissionHook, KubeObject
from ..kube.certs import CertBundle
from ..kube.jsonpatch import apply_patch, diff

logger = logging.getLogger("kubeflow_tpu_torch.odh.webhook_server")

_NOTEBOOK_CONVERT = object()  # sentinel: default to the Notebook converter


def handle_admission_review(hooks: list[AdmissionHook], path: str,
                            review: dict) -> dict:
    """Run the hook registered at `path` over one AdmissionReview request."""
    req = review.get("request", {})
    uid = req.get("uid", "")
    op = req.get("operation", "CREATE")
    obj_dict = req.get("object") or {}
    old_dict = req.get("oldObject")
    obj = KubeObject.from_dict(obj_dict)
    old = KubeObject.from_dict(old_dict) if old_dict else None

    response: dict = {"uid": uid, "allowed": True}
    hook = next((h for h in hooks if f"/{h.name}" == path), None)
    if hook is None:
        response = {"uid": uid, "allowed": False,
                    "status": {"message": f"no webhook at {path}", "code": 404}}
    elif obj.kind not in hook.kinds or op not in hook.operations:
        pass  # not a match: allow unmodified (apiserver filters, we tolerate)
    else:
        try:
            mutated = hook.handler(op, old, obj.deepcopy())
            if hook.mutating and mutated is not None:
                ops = diff(obj_dict, mutated.to_dict())
                if ops:
                    response["patchType"] = "JSONPatch"
                    response["patch"] = base64.b64encode(
                        json.dumps(ops).encode()).decode()
        except AdmissionDenied as err:
            response = {"uid": uid, "allowed": False,
                        "status": {"message": err.message, "code": 403}}
    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "response": response,
    }


def handle_conversion_review(review: dict, convert_fn) -> dict:
    """ConversionReview v1: convert request.objects to desiredAPIVersion.

    The other half of the CRD's `spec.conversion` clause
    (deploy/manifests.py renders path /convert) — what kube-apiserver calls
    on every read/write of a non-storage version.  Reference:
    notebook-controller/api/v1/notebook_conversion.go:25-69 + the
    conversion-webhook patches under its config/crd/."""
    req = review.get("request") or {}
    uid = req.get("uid", "")
    desired = req.get("desiredAPIVersion", "")
    try:
        converted = [convert_fn(o, desired) for o in req.get("objects") or []]
        response = {"uid": uid, "convertedObjects": converted,
                    "result": {"status": "Success"}}
    except Exception as err:  # a Failure result, not a dead connection
        logger.exception("conversion to %s failed", desired)
        response = {"uid": uid,
                    "result": {"status": "Failure", "message": str(err)}}
    return {
        "apiVersion": review.get("apiVersion") or "apiextensions.k8s.io/v1",
        "kind": "ConversionReview",
        "response": response,
    }


class _AdmissionHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    hooks: list[AdmissionHook] = []
    convert_fn = None  # (obj_dict, desired_api_version) -> obj_dict

    def log_message(self, *args):
        logger.debug("%s", args)

    def do_POST(self):  # noqa: N802
        length = int(self.headers.get("Content-Length", 0))
        try:
            review = json.loads(self.rfile.read(length) or b"{}")
            if self.path == "/convert" and self.convert_fn is not None:
                out = handle_conversion_review(review, type(self).convert_fn)
            else:
                out = handle_admission_review(self.hooks, self.path, review)
            data = json.dumps(out).encode()
            self.send_response(200)
        except Exception as err:  # a broken review must not kill the server
            logger.exception("admission handler failed")
            data = json.dumps({"error": str(err)}).encode()
            self.send_response(500)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802  — readyz probe for the webhook port
        data = b"ok"
        self.send_response(200 if self.path in ("/readyz", "/healthz") else 404)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


class AdmissionReviewServer:
    """TLS server exposing AdmissionHooks at /{hook.name}."""

    def __init__(self, hooks: list[AdmissionHook],
                 bundle: Optional[CertBundle] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 cert_file: str = "", key_file: str = "",
                 convert_fn=_NOTEBOOK_CONVERT) -> None:
        self.hooks = hooks
        self.bundle = bundle
        if convert_fn is _NOTEBOOK_CONVERT:
            from ..api.types import convert_notebook_dict

            convert_fn = convert_notebook_dict
        handler = type("Handler", (_AdmissionHandler,), {
            "hooks": hooks,
            "convert_fn": staticmethod(convert_fn) if convert_fn else None,
        })
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        if cert_file:
            ctx.load_cert_chain(cert_file, key_file or None)
        elif bundle is not None:
            ctx = bundle.server_ssl_context()
        else:
            raise ValueError("AdmissionReviewServer needs a cert: "
                             "pass bundle= or cert_file=/key_file=")
        self._httpd.socket = ctx.wrap_socket(self._httpd.socket,
                                             server_side=True)
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"https://{host}:{port}"

    def start(self) -> "AdmissionReviewServer":
        # a 0.1 s shutdown poll (the stdlib's is 0.5 s): the manager's
        # SIGINT exit waits for it
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name="webhook-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)


def _webhook_client_ssl(ca_pem: Optional[bytes],
                        insecure_skip_verify: bool) -> ssl.SSLContext:
    """Verified-by-default client TLS for webhook callouts.  A provided CA
    is trusted with full hostname checking (minted serving certs carry the
    host IP SAN, kube/certs.py); skipping verification is an explicit
    opt-in, mirroring kubeconfig's insecure-skip-tls-verify."""
    if insecure_skip_verify:
        return ssl._create_unverified_context()
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.verify_mode = ssl.CERT_REQUIRED
    ctx.check_hostname = True
    if ca_pem is not None:
        ctx.load_verify_locations(cadata=ca_pem.decode())
    else:
        ctx.load_default_certs()
    return ctx


class RemoteAdmissionHook:
    """ApiServer-side callout to a remote AdmissionReview endpoint.

    Wraps a webhook URL as an in-process AdmissionHook so the wire-served
    apiserver invokes it during writes, like kube-apiserver with a
    MutatingWebhookConfiguration (deploy/manifests.py renders that object
    for real clusters)."""

    def __init__(self, url: str, path: str, mutating: bool,
                 ca_pem: Optional[bytes] = None,
                 kinds: tuple[str, ...] = ("Notebook",),
                 operations: tuple[str, ...] = ("CREATE", "UPDATE"),
                 timeout_s: float = 10.0,
                 insecure_skip_verify: bool = False) -> None:
        self.endpoint = url.rstrip("/") + path
        self.path = path
        self.mutating = mutating
        self.kinds = kinds
        self.operations = operations
        self.timeout_s = timeout_s
        self._ctx = _webhook_client_ssl(ca_pem, insecure_skip_verify)

    def __call__(self, op: str, old: Optional[KubeObject],
                 obj: KubeObject) -> Optional[KubeObject]:
        obj_dict = obj.to_dict()
        review = {
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "request": {
                "uid": obj.metadata.uid or "pending",
                "operation": op,
                "object": obj_dict,
                "oldObject": old.to_dict() if old else None,
            },
        }
        req = urllib.request.Request(
            self.endpoint, data=json.dumps(review).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s,
                                    context=self._ctx) as resp:
            out = json.loads(resp.read())
        response = out.get("response", {})
        if not response.get("allowed", False):
            msg = response.get("status", {}).get("message", "denied")
            raise AdmissionDenied(msg)
        patch_b64 = response.get("patch")
        if self.mutating and patch_b64:
            ops = json.loads(base64.b64decode(patch_b64))
            return KubeObject.from_dict(apply_patch(obj_dict, ops))
        return None

    def as_hook(self, name: str = "") -> AdmissionHook:
        return AdmissionHook(
            kinds=self.kinds, handler=self.__call__,
            operations=self.operations, mutating=self.mutating,
            name=name or self.path.lstrip("/"))


class RemoteConverter:
    """Apiserver-side ConversionReview callout to /convert.

    Plugs into KubeApiWireServer(converter=...) so version-crossing reads
    and writes go over the wire to the webhook server — the CRD
    `spec.conversion` choreography end to end, like kube-apiserver with a
    Webhook conversion strategy."""

    def __init__(self, url: str, ca_pem: Optional[bytes] = None,
                 timeout_s: float = 10.0,
                 insecure_skip_verify: bool = False) -> None:
        self.endpoint = url.rstrip("/") + "/convert"
        self.timeout_s = timeout_s
        self._ctx = _webhook_client_ssl(ca_pem, insecure_skip_verify)
        self._uid = 0

    def __call__(self, obj: dict, desired_api_version: str) -> dict:
        return self.convert_many([obj], desired_api_version)[0]

    def convert_many(self, objs: list[dict],
                     desired_api_version: str) -> list[dict]:
        """One ConversionReview for the whole batch — the apiserver converts
        an entire LIST in a single callout, and so does the wire server
        (kube/wire.py _convert_out_many)."""
        self._uid += 1
        review = {
            "apiVersion": "apiextensions.k8s.io/v1",
            "kind": "ConversionReview",
            "request": {
                "uid": f"conv-{self._uid}",
                "desiredAPIVersion": desired_api_version,
                "objects": objs,
            },
        }
        req = urllib.request.Request(
            self.endpoint, data=json.dumps(review).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s,
                                    context=self._ctx) as resp:
            out = json.loads(resp.read())
        response = out.get("response") or {}
        result = response.get("result") or {}
        if result.get("status") != "Success":
            raise RuntimeError(
                f"conversion webhook failed: {result.get('message', result)}")
        converted = response.get("convertedObjects") or []
        if len(converted) != len(objs):
            raise RuntimeError(
                f"conversion webhook returned {len(converted)} objects "
                f"for {len(objs)}")
        return converted


__all__ = ["AdmissionReviewServer", "RemoteAdmissionHook", "RemoteConverter",
           "handle_admission_review", "handle_conversion_review"]
