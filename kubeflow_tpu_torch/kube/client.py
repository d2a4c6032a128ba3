"""Real-cluster client: the Kubernetes REST API over HTTP(S).

The port's copy of kubeflow_tpu/kube/client.py.

The drop-in counterpart of the in-memory ApiServer (kube/store.py): exposes
the same read/write surface (get/list/create/update/update_status/
merge_patch/delete) plus reflector-style informers feeding the Manager's
watch callbacks, so `Manager(KubeClient(...))` reconciles a *real* cluster
with the controllers unchanged.  Mirrors the client-go stack the reference
sits on: rest.Config + kubeconfig/in-cluster loading
(notebook-controller/main.go:87-89), client-side qps/burst throttling
(main.go:71-72,80-85), and a list-then-watch reflector with 410-Gone relist
(controller-runtime's informer cache).  Dependency-free: stdlib http.client,
ssl, and PyYAML for kubeconfig.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import socket
import ssl
import tempfile
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional
from urllib.parse import urlencode, urlsplit

import http.client

from .errors import (
    AlreadyExistsError,
    ApiError,
    ConflictError,
    ForbiddenError,
    GoneError,
    InvalidError,
    NotFoundError,
    ServerError,
)
from .meta import KubeObject
from .resources import DEFAULT_SCHEME, Scheme
from .store import AdmissionHook, EventType, WatchEvent

logger = logging.getLogger("kubeflow_tpu_torch.kube.client")

SA_MOUNT = "/var/run/secrets/kubernetes.io/serviceaccount"

_ERR_BY_REASON = {
    "NotFound": NotFoundError,
    "AlreadyExists": AlreadyExistsError,
    "Conflict": ConflictError,
    "Invalid": InvalidError,
    "Forbidden": ForbiddenError,
    "Expired": GoneError,
}
_ERR_BY_CODE = {
    404: NotFoundError, 409: ConflictError, 422: InvalidError,
    401: ForbiddenError, 403: ForbiddenError, 410: GoneError,
}


# canonical namespace detection lives in utils.config (odh main.go:127-139)
from ..utils.clock import Clock  # noqa: E402
from ..utils.config import detect_namespace  # noqa: E402  (re-export)


@dataclass
class RestConfig:
    """Where the apiserver is and how to authenticate — rest.Config."""

    server: str
    token: str = ""
    ca_file: str = ""
    client_cert_file: str = ""
    client_key_file: str = ""
    insecure_skip_verify: bool = False
    namespace: str = "default"
    qps: float = 0.0   # 0 = unlimited (client-go default left to the lib)
    burst: int = 0

    @classmethod
    def from_kubeconfig(cls, path: str, context: Optional[str] = None) -> "RestConfig":
        import yaml

        with open(path) as f:
            kc = yaml.safe_load(f) or {}
        ctx_name = context or kc.get("current-context", "")
        ctx = next((c["context"] for c in kc.get("contexts", [])
                    if c.get("name") == ctx_name), {})
        cluster = next((c["cluster"] for c in kc.get("clusters", [])
                        if c.get("name") == ctx.get("cluster")), {})
        user = next((u["user"] for u in kc.get("users", [])
                     if u.get("name") == ctx.get("user")), {})

        def materialize(data_key: str, file_key: str) -> str:
            # *-data keys are base64-inline; write to a temp file for ssl
            if user.get(data_key) or cluster.get(data_key):
                raw = base64.b64decode(user.get(data_key) or cluster.get(data_key))
                tf = tempfile.NamedTemporaryFile(delete=False, suffix=".pem")
                tf.write(raw)
                tf.close()
                return tf.name
            return user.get(file_key) or cluster.get(file_key) or ""

        return cls(
            server=cluster.get("server", ""),
            token=user.get("token", ""),
            ca_file=materialize("certificate-authority-data", "certificate-authority"),
            client_cert_file=materialize("client-certificate-data", "client-certificate"),
            client_key_file=materialize("client-key-data", "client-key"),
            insecure_skip_verify=bool(cluster.get("insecure-skip-tls-verify", False)),
            namespace=ctx.get("namespace", "default"),
        )

    @classmethod
    def in_cluster(cls) -> "RestConfig":
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise RuntimeError("not running in-cluster "
                               "(KUBERNETES_SERVICE_HOST unset)")
        with open(os.path.join(SA_MOUNT, "token")) as f:
            token = f.read().strip()
        return cls(
            server=f"https://{host}:{port}",
            token=token,
            ca_file=os.path.join(SA_MOUNT, "ca.crt"),
            namespace=detect_namespace(),
        )


class RateLimiter:
    """Token bucket — client-go's flowcontrol.NewTokenBucketRateLimiter.
    Time flows through the injected Clock (clock discipline): a real Clock
    sleeps; a FakeClock advances, so tests never block."""

    def __init__(self, qps: float, burst: int,
                 clock: Optional[Clock] = None) -> None:
        self.qps = qps
        self.burst = max(burst, 1)
        self.clock = clock or Clock()
        self._tokens = float(self.burst)
        self._last = self.clock.monotonic()
        self._lock = threading.Lock()

    def acquire(self) -> None:
        if self.qps <= 0:
            return
        while True:
            with self._lock:
                now = self.clock.monotonic()
                self._tokens = min(self.burst,
                                   self._tokens + (now - self._last) * self.qps)
                self._last = now
                if self._tokens >= 1:
                    self._tokens -= 1
                    return
                wait = (1 - self._tokens) / self.qps
            self.clock.sleep(wait)


@dataclass
class _Informer:
    kind: str
    thread: threading.Thread
    stop: threading.Event = field(default_factory=threading.Event)
    conn: Optional[http.client.HTTPConnection] = None  # live watch stream
    namespace: Optional[str] = None  # None = cluster-wide
    # last-known objects, mutated only by this informer's thread — used to
    # synthesize DELETED events for objects that vanished while the watch
    # was down (client-go's DeletedFinalStateUnknown)
    known: dict[tuple[str, str], KubeObject] = field(default_factory=dict)
    # set once the initial list completed (client-go HasSynced): readiness
    # gates on every informer reaching this point
    synced: threading.Event = field(default_factory=threading.Event)


class KubeClient:
    """ApiServer-compatible facade over a real apiserver."""

    def __init__(self, config: RestConfig, scheme: Optional[Scheme] = None,
                 watch_timeout_s: float = 300.0) -> None:
        self.config = config
        self.scheme_registry = scheme or DEFAULT_SCHEME
        self.limiter = RateLimiter(config.qps, config.burst)
        self.watch_timeout_s = watch_timeout_s
        self._watchers: list[Callable[[WatchEvent], None]] = []
        self._watchers_lock = threading.Lock()
        self._informers: dict[str, _Informer] = {}
        self._admission: list[AdmissionHook] = []
        split = urlsplit(config.server)
        self._host = split.hostname or "127.0.0.1"
        self._port = split.port or (443 if split.scheme == "https" else 80)
        self._tls = split.scheme == "https"
        self._ssl_ctx = self._build_ssl() if self._tls else None

    def _build_ssl(self) -> ssl.SSLContext:
        """Verification is dropped ONLY on explicit opt-in
        (insecure-skip-tls-verify), as in client-go; a kubeconfig without
        certificate-authority data falls back to the system trust roots and
        fails the handshake loudly rather than silently accepting any cert
        while still sending the bearer token."""
        ctx = ssl.create_default_context(cafile=self.config.ca_file or None)
        if self.config.insecure_skip_verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        if self.config.client_cert_file:
            ctx.load_cert_chain(self.config.client_cert_file,
                                self.config.client_key_file or None)
        return ctx

    # -- transport ------------------------------------------------------------
    def _connect(self, timeout: float) -> http.client.HTTPConnection:
        if self._tls:
            return http.client.HTTPSConnection(
                self._host, self._port, timeout=timeout, context=self._ssl_ctx)
        return http.client.HTTPConnection(self._host, self._port, timeout=timeout)

    def _headers(self, content_type: str = "application/json") -> dict:
        h = {"Content-Type": content_type, "Accept": "application/json"}
        if self.config.token:
            h["Authorization"] = f"Bearer {self.config.token}"
        return h

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 content_type: str = "application/json",
                 timeout: float = 30.0) -> dict:
        self.limiter.acquire()
        conn = self._connect(timeout)
        try:
            payload = json.dumps(body).encode() if body is not None else None
            conn.request(method, path, body=payload,
                         headers=self._headers(content_type))
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status >= 400:
                self._raise_status(resp.status, raw)
            return json.loads(raw) if raw else {}
        except (OSError, http.client.HTTPException) as err:
            raise ServerError(f"{method} {path}: {err}") from err
        finally:
            conn.close()

    @staticmethod
    def _raise_status(code: int, raw: bytes) -> None:
        reason, message = "", ""
        try:
            status = json.loads(raw)
            reason = status.get("reason", "")
            message = status.get("message", "")
        except (ValueError, AttributeError):
            message = raw.decode(errors="replace")[:500]
        err_cls = _ERR_BY_REASON.get(reason) or _ERR_BY_CODE.get(code) or ServerError
        raise err_cls(message or f"HTTP {code}")

    # -- ApiServer-compatible surface -----------------------------------------
    def get(self, kind: str, namespace: str, name: str) -> KubeObject:
        info = self.scheme_registry.by_kind(kind)
        d = self._request("GET", info.object_path(namespace, name))
        return KubeObject.from_dict(d)

    def try_get(self, kind: str, namespace: str, name: str) -> Optional[KubeObject]:
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[dict[str, str]] = None,
             field_selector: Optional[str] = None) -> list[KubeObject]:
        """`field_selector` is the raw fieldSelector string
        ("metadata.name=wb,involvedObject.kind=Notebook") — server-side
        filtering on dotted field paths."""
        info = self.scheme_registry.by_kind(kind)
        path = info.collection_path(namespace)
        q: dict[str, str] = {}
        if label_selector:
            q["labelSelector"] = ",".join(
                f"{k}={v}" for k, v in sorted(label_selector.items()))
        if field_selector:
            q["fieldSelector"] = field_selector
        if q:
            path += "?" + urlencode(q)
        d = self._request("GET", path)
        return sorted(
            (KubeObject.from_dict(i) for i in d.get("items", [])),
            key=lambda o: (o.namespace, o.name),
        )

    def create(self, obj: KubeObject) -> KubeObject:
        info = self.scheme_registry.by_kind(obj.kind)
        d = self._request("POST", info.collection_path(obj.namespace or None),
                          body=obj.to_dict())
        return KubeObject.from_dict(d)

    def update(self, obj: KubeObject, subresource: str = "") -> KubeObject:
        info = self.scheme_registry.by_kind(obj.kind)
        path = info.object_path(obj.namespace or None, obj.name)
        if subresource:
            path += f"/{subresource}"
        d = self._request("PUT", path, body=obj.to_dict())
        return KubeObject.from_dict(d)

    def update_status(self, obj: KubeObject) -> KubeObject:
        return self.update(obj, subresource="status")

    def merge_patch(self, kind: str, namespace: str, name: str,
                    patch: dict) -> KubeObject:
        info = self.scheme_registry.by_kind(kind)
        d = self._request("PATCH", info.object_path(namespace or None, name),
                          body=patch,
                          content_type="application/merge-patch+json")
        return KubeObject.from_dict(d)

    def strategic_merge_patch(self, kind: str, namespace: str, name: str,
                              patch: dict) -> KubeObject:
        """client-go types.StrategicMergePatchType: keyed-list merge on the
        server (containers by name, volumeMounts by mountPath, ...)."""
        info = self.scheme_registry.by_kind(kind)
        d = self._request("PATCH", info.object_path(namespace or None, name),
                          body=patch,
                          content_type="application/strategic-merge-patch+json")
        return KubeObject.from_dict(d)

    def apply(self, obj: KubeObject, field_manager: str,
              force: bool = False) -> KubeObject:
        """Server-side apply (client-go types.ApplyPatchType): declarative
        upsert with managedFields ownership arbitration on the server."""
        info = self.scheme_registry.by_kind(obj.kind)
        path = info.object_path(obj.namespace or None, obj.name)
        path += "?" + urlencode({"fieldManager": field_manager,
                                 "force": "true" if force else "false"})
        d = self._request("PATCH", path, body=obj.to_dict(),
                          content_type="application/apply-patch+yaml")
        return KubeObject.from_dict(d)

    def json_patch(self, kind: str, namespace: str, name: str,
                   ops: list) -> KubeObject:
        """RFC 6902 patch (client-go types.JSONPatchType); `test` ops carry
        preconditions the server answers 422 for on mismatch."""
        info = self.scheme_registry.by_kind(kind)
        d = self._request("PATCH", info.object_path(namespace or None, name),
                          body=ops,
                          content_type="application/json-patch+json")
        return KubeObject.from_dict(d)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        info = self.scheme_registry.by_kind(kind)
        self._request("DELETE", info.object_path(namespace or None, name))

    # -- admission: collected here, served by the webhook HTTPS server --------
    def register_admission(self, hook: AdmissionHook) -> None:
        """On a real cluster admission runs in the apiserver write path via
        webhook callout (odh main.go:285-311); the client only collects the
        hooks for odh.webhook_server.AdmissionReviewServer to serve."""
        self._admission.append(hook)

    @property
    def admission_hooks(self) -> list[AdmissionHook]:
        return list(self._admission)

    # -- informers ------------------------------------------------------------
    def watch(self, fn: Callable[[WatchEvent], None]) -> None:
        with self._watchers_lock:
            self._watchers.append(fn)

    def _dispatch(self, ev: WatchEvent) -> None:
        with self._watchers_lock:
            fns = list(self._watchers)
        for fn in fns:
            try:
                fn(ev)
            except Exception:  # watcher bugs must not kill the informer
                logger.exception("watch callback failed for %s", ev.obj.key())

    def start_informers(self, kinds: list[str],
                        namespace: Optional[str] = None) -> None:
        """List-and-watch reflectors.  `namespace` scopes every informer to
        one namespace (client-go cache.Options.DefaultNamespaces) — a
        single-tenant deployment should not list/watch the whole cluster."""
        for kind in kinds:
            if kind in self._informers:
                continue
            info = self.scheme_registry.by_kind(kind)
            ns = namespace if info.namespaced else None
            inf = _Informer(kind, thread=None,  # type: ignore[arg-type]
                            namespace=ns)
            inf.thread = threading.Thread(
                target=self._informer_loop, args=(inf,),
                daemon=True, name=f"informer-{kind.lower()}")
            self._informers[kind] = inf
            inf.thread.start()

    def informers_synced(self) -> bool:
        """True once every started informer finished its initial list
        (cache.WaitForCacheSync); False with no informers running — a
        manager that never started its event sources is not ready."""
        if not self._informers:
            return False
        return all(inf.synced.is_set() for inf in self._informers.values())

    def stop_informers(self) -> None:
        for inf in self._informers.values():
            inf.stop.set()
            # shutdown() the live watch socket to unblock the reader thread;
            # conn.close() would deadlock on the response-buffer lock the
            # blocked readline() holds, and without either, every join waits
            # out a read timeout
            conn = inf.conn
            sock = getattr(conn, "sock", None)
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        for inf in self._informers.values():
            inf.thread.join(timeout=2)
        self._informers.clear()

    def _informer_loop(self, inf: _Informer) -> None:
        """List-then-watch reflector.  A clean stream end (idle timeout,
        server close) resumes the watch from the newest resourceVersion seen
        on the stream, as client-go does; a full relist — which re-dispatches
        ADDED for every object — happens only on 410 Gone or a transport
        error, so controllers are not re-reconciling the whole cluster every
        watch_timeout_s."""
        info = self.scheme_registry.by_kind(inf.kind)
        path = info.collection_path(inf.namespace)
        while not inf.stop.is_set():
            try:
                # paginated relist (client-go's pager, 500/page): a large
                # cluster must not be materialized in one response
                rv = 0
                fresh: dict[tuple[str, str], KubeObject] = {}
                params: dict[str, str] = {"limit": "500"}
                while True:
                    listing = self._request(
                        "GET", f"{path}?{urlencode(params)}")
                    meta = listing.get("metadata", {})
                    rv = int(meta.get("resourceVersion", 0) or 0)
                    for item in listing.get("items", []):
                        obj = KubeObject.from_dict(item)
                        fresh[(obj.namespace, obj.name)] = obj
                        self._dispatch(WatchEvent(EventType.ADDED, obj))
                    if not meta.get("continue"):
                        break
                    params["continue"] = meta["continue"]
                # objects that vanished while the watch was down get a
                # synthetic DELETED with their last-known state
                for key, gone in inf.known.items():
                    if key not in fresh:
                        self._dispatch(WatchEvent(EventType.DELETED, gone))
                inf.known = fresh
                inf.synced.set()
                while not inf.stop.is_set():
                    rv = self._watch_stream(info, rv, inf)
            except GoneError:
                continue  # history window lost: relist
            except ApiError as err:
                logger.warning("informer %s: %s; backing off", inf.kind, err)
                inf.stop.wait(1.0)
            except Exception:
                if inf.stop.is_set():
                    return  # socket torn down by stop_informers
                logger.exception("informer %s crashed; restarting", inf.kind)
                inf.stop.wait(1.0)

    def _watch_stream(self, info, rv: int, inf: _Informer) -> int:
        """Stream watch events from `rv`; returns the newest resourceVersion
        seen so the caller can resume without a relist."""
        qs = urlencode({"watch": "true", "resourceVersion": str(rv),
                        "allowWatchBookmarks": "true"})
        path = f"{info.collection_path(inf.namespace)}?{qs}"
        self.limiter.acquire()
        conn = self._connect(timeout=self.watch_timeout_s)
        inf.conn = conn
        try:
            conn.request("GET", path, headers=self._headers())
            resp = conn.getresponse()
            if resp.status >= 400:
                self._raise_status(resp.status, resp.read())
            while not inf.stop.is_set():
                try:
                    line = resp.readline()
                except (TimeoutError, OSError, http.client.HTTPException):
                    return rv  # idle timeout or teardown: resume from rv
                if not line:
                    return rv  # server closed the stream: resume from rv
                line = line.strip()
                if not line:
                    continue
                ev = json.loads(line)
                if ev["type"] == "BOOKMARK":
                    # progress notify: advance the resume RV, dispatch nothing
                    try:
                        rv = max(rv, int(ev["object"].get("metadata", {})
                                         .get("resourceVersion", 0)))
                    except (TypeError, ValueError):
                        pass
                    continue
                if ev["type"] == "ERROR":
                    # mid-stream Status event: the apiserver compacted our
                    # resourceVersion away (410 Gone / Expired).  The resume
                    # RV is dead — raise GoneError so the informer loop
                    # RELISTS instead of resuming from it (client-go
                    # reflector does exactly this on watch.Error + Expired)
                    status = ev.get("object") or {}
                    if status.get("code") == 410 or \
                            status.get("reason") == "Expired":
                        raise GoneError(
                            status.get("message", "watch expired"))
                    raise ServerError(
                        status.get("message", "watch stream error"))
                etype = EventType(ev["type"])
                obj = KubeObject.from_dict(ev["object"])
                try:
                    rv = max(rv, int(obj.metadata.resource_version or 0))
                except ValueError:
                    pass  # opaque RV (a real apiserver may send one): keep last
                if etype is EventType.DELETED:
                    inf.known.pop((obj.namespace, obj.name), None)
                    self._dispatch(WatchEvent(etype, obj))
                else:
                    # last-known state rides along as `prev` (the in-memory
                    # watch cache provides the same), so event predicates
                    # like suppress_status_only work on a real cluster too
                    prev = inf.known.get((obj.namespace, obj.name))
                    inf.known[(obj.namespace, obj.name)] = obj
                    self._dispatch(WatchEvent(
                        etype, obj,
                        prev=prev if etype is EventType.MODIFIED else None))
            return rv
        finally:
            inf.conn = None
            conn.close()


__all__ = ["KubeClient", "RestConfig", "RateLimiter", "detect_namespace"]
