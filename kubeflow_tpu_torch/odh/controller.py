"""ODH extension reconciler: routing, auth, integrations, lock protocol.

The port of kubeflow_tpu/odh/controller.py, the port of
OpenshiftNotebookReconciler (odh notebook_controller.go:190-526):
finalizer lifecycle for the cross-namespace / cluster-scoped objects
(HTTPRoute, ReferenceGrant, kube-rbac-proxy CRB, legacy OAuthClient), the CA
bundle ConfigMap, NetworkPolicies, pipeline integrations, the auth/non-auth
routing branch, MLflow, and removal of the reconciliation lock the mutating
webhook stamped on create.

The lock comes off by one merge patch, as in the reference.  The
reconciler ignores the core controller's status-only writes but one: a
change of `status.replication.primary`, the promotion of a replicated
notebook, after which the kube-rbac-proxy Service must select the new
primary's gang (auth.py).
"""

from __future__ import annotations

import logging
from typing import Optional

from ..kube import (
    ApiServer,
    EventRecorder,
    KubeObject,
    Manager,
    NotFoundError,
    Request,
    Result,
    WatchEvent,
    WatchSpec,
    is_status_only_update,
    retry_on_conflict,
)
from ..utils import tracing
from ..utils.config import OdhConfig
from . import auth, ca_bundle, constants as C, network, oauth, rbac, routing
from .dspa import sync_elyra_runtime_config_secret
from .mlflow import reconcile_mlflow_integration
from .runtime_images import sync_runtime_images_configmap
from .webhook import NotebookMutatingWebhook, NotebookValidatingWebhook

logger = logging.getLogger("kubeflow_tpu_torch.odh")

# phase child spans (cert_trust/auth/routing) parent onto the manager's
# per-attempt reconcile root span via the shared context stack
_TRACER = tracing.get_tracer("kubeflow_tpu_torch.odh.controller")

LOCK_PULL_SECRET_MAX_ATTEMPTS = 3


def reconciliation_lock_is_enabled(nb: KubeObject) -> bool:
    """ReconciliationLockIsEnabled (notebook_controller.go:145-151)."""
    return (
        nb.metadata.annotations.get(C.STOP_ANNOTATION) == C.RECONCILIATION_LOCK_VALUE
    )


def _primary(obj: KubeObject):
    return ((obj.body.get("status") or {}).get("replication") or {}).get(
        "primary")


def suppress_status_only_but_promotion(ev: WatchEvent) -> bool:
    """for_predicate: drop the Notebook's status-only updates, as
    `suppress_status_only` does, but let a change of the primary replica
    through: the routing objects follow the primary."""
    if not is_status_only_update(ev):
        return True
    return _primary(ev.prev) != _primary(ev.obj)


class OpenshiftNotebookReconciler:
    def __init__(
        self,
        api: ApiServer,
        cfg: OdhConfig,
        recorder: Optional[EventRecorder] = None,
    ):
        self.api = api
        self.cfg = cfg
        self.recorder = recorder or EventRecorder(api, "odh-notebook-controller")
        # per-notebook attempts waiting for the SA pull secret before the
        # lock is removed anyway (best-effort wait, reference retry.OnError
        # Steps:3, notebook_controller.go:158-181)
        self._lock_wait_attempts: dict[tuple[str, str], int] = {}

    # -- main loop -------------------------------------------------------------
    def reconcile(self, req: Request) -> Result:
        obj = self.api.try_get("Notebook", req.namespace, req.name)
        if obj is None:
            return Result()
        nb = obj

        if obj.metadata.deletion_timestamp is not None:
            return self._handle_deletion(nb)

        # finalizers first; adding them requeues (notebook_controller.go:335-381)
        if self._ensure_finalizers(nb):
            return Result(requeue=True)

        with _TRACER.start_span("cert_trust",
                                {"phase": "cert_trust"}) as ct_span:
            ca_bundle.create_notebook_cert_configmap(self.api, nb)
            if ca_bundle.is_configmap_deleted(self.api, nb):
                ct_span.add_event("cert_trust.source_configmap_deleted")
                ca_bundle.unset_notebook_cert_config(self.api, nb)

        network.reconcile_all_network_policies(
            self.api, nb, self.cfg.controller_namespace
        )
        sync_runtime_images_configmap(
            self.api, nb.namespace, self.cfg.controller_namespace
        )
        if self.cfg.set_pipeline_rbac:
            rbac.reconcile_role_bindings(self.api, nb)
        if self.cfg.set_pipeline_secret:
            try:
                sync_elyra_runtime_config_secret(self.api, nb, self.cfg)
            except Exception as err:
                logger.warning("elyra secret reconcile failed: %s", err)

        with _TRACER.start_span("routing",
                                {"phase": "routing"}) as routing_span:
            auth_mode = self._auth_enabled(nb)
            routing_span.set_attribute("auth_enabled", auth_mode)
            # ReferenceGrant before HTTPRoutes (notebook_controller.go:427-433)
            routing.reconcile_reference_grant(
                self.api, nb, self.cfg.controller_namespace)

            if auth_mode:
                routing.ensure_conflicting_httproute_absent(
                    self.api, nb, self.cfg.controller_namespace,
                    is_auth_mode=True
                )
                with _TRACER.start_span("auth", {"phase": "auth"}):
                    auth.reconcile_auth_resources(self.api, nb)
                routing.reconcile_httproute(
                    self.api,
                    nb,
                    self.cfg.controller_namespace,
                    self.cfg.gateway_name,
                    self.cfg.gateway_namespace,
                    new_route=routing.new_kube_rbac_proxy_httproute,
                )
            else:
                routing.ensure_conflicting_httproute_absent(
                    self.api, nb, self.cfg.controller_namespace,
                    is_auth_mode=False
                )
                with _TRACER.start_span("auth", {"phase": "auth"}):
                    auth.cleanup_cluster_role_binding(self.api, nb)
                routing.reconcile_httproute(
                    self.api,
                    nb,
                    self.cfg.controller_namespace,
                    self.cfg.gateway_name,
                    self.cfg.gateway_namespace,
                )

        if self.cfg.mlflow_enabled:
            delay = reconcile_mlflow_integration(self.api, nb, self.recorder)
            if delay is not None:
                return Result(requeue_after=delay)

        if reconciliation_lock_is_enabled(nb):
            return self._remove_reconciliation_lock(nb)
        return Result()

    # -- helpers ---------------------------------------------------------------
    def _auth_enabled(self, nb: KubeObject) -> bool:
        return nb.metadata.annotations.get(C.ANNOTATION_INJECT_AUTH) == "true"

    def _ensure_finalizers(self, nb: KubeObject) -> bool:
        """Add missing finalizers; True when a write happened (and the
        reconcile should requeue)."""
        want = [C.HTTPROUTE_FINALIZER, C.REFERENCEGRANT_FINALIZER]
        if self._auth_enabled(nb):
            want.append(C.KUBE_RBAC_PROXY_FINALIZER)
        if C.OAUTH_CLIENT_FINALIZER not in nb.metadata.finalizers \
                and self.api.try_get(
                    "OAuthClient", "",
                    oauth.oauth_client_name(nb)) is not None:
            # a legacy RHOAI 2.x client exists for this notebook: gate its
            # deletion-time cleanup (without this the _handle_deletion
            # branch at OAUTH_CLIENT_FINALIZER is unreachable).  The
            # already-present check keeps the cluster-scoped lookup off
            # the steady-state reconcile path
            want.append(C.OAUTH_CLIENT_FINALIZER)
        missing = [f for f in want if f not in nb.metadata.finalizers]
        if not missing:
            return False

        def add() -> None:
            live = self.api.get("Notebook", nb.namespace, nb.name)
            changed = False
            for f in missing:
                if f not in live.metadata.finalizers:
                    live.metadata.finalizers.append(f)
                    changed = True
            if changed:
                self.api.update(live)

        retry_on_conflict(add)
        return True

    def _handle_deletion(self, nb: KubeObject) -> Result:
        """Finalizer-gated cleanup of cross-namespace / cluster-scoped
        objects (notebook_controller.go:206-333)."""
        finalizers = list(nb.metadata.finalizers)
        to_remove: list[str] = []
        if C.OAUTH_CLIENT_FINALIZER in finalizers:
            oauth.delete_oauth_client(self.api, nb)
            to_remove.append(C.OAUTH_CLIENT_FINALIZER)
        if C.HTTPROUTE_FINALIZER in finalizers:
            routing.delete_httproutes_for_notebook(
                self.api, nb, self.cfg.controller_namespace
            )
            to_remove.append(C.HTTPROUTE_FINALIZER)
        if C.REFERENCEGRANT_FINALIZER in finalizers:
            routing.delete_reference_grant_if_last_notebook(self.api, nb)
            to_remove.append(C.REFERENCEGRANT_FINALIZER)
        if C.KUBE_RBAC_PROXY_FINALIZER in finalizers:
            auth.cleanup_cluster_role_binding(self.api, nb)
            to_remove.append(C.KUBE_RBAC_PROXY_FINALIZER)
        if not to_remove:
            return Result()

        def strip() -> None:
            try:
                live = self.api.get("Notebook", nb.namespace, nb.name)
            except NotFoundError:
                return
            live.metadata.finalizers = [
                f for f in live.metadata.finalizers if f not in to_remove
            ]
            self.api.update(live)

        retry_on_conflict(strip)
        self._lock_wait_attempts.pop((nb.namespace, nb.name), None)
        return Result()

    def _remove_reconciliation_lock(self, nb: KubeObject) -> Result:
        """Wait (bounded, best-effort) for the notebook SA's pull secret,
        then merge-patch the lock annotation away
        (RemoveReconciliationLock, notebook_controller.go:155-186)."""
        key = (nb.namespace, nb.name)
        sa = self.api.try_get("ServiceAccount", nb.namespace, nb.name)
        pull_secrets = (sa.body.get("imagePullSecrets") if sa else None) or []
        if sa is not None and not pull_secrets:
            attempts = self._lock_wait_attempts.get(key, 0)
            if attempts < LOCK_PULL_SECRET_MAX_ATTEMPTS:
                self._lock_wait_attempts[key] = attempts + 1
                return Result(requeue_after=1.0 * (5**attempts))
        self._lock_wait_attempts.pop(key, None)
        self.api.merge_patch(
            "Notebook",
            nb.namespace,
            nb.name,
            {"metadata": {"annotations": {C.STOP_ANNOTATION: None}}},
        )
        return Result()


def setup_odh_controllers(
    mgr: Manager, cfg: Optional[OdhConfig] = None
) -> OpenshiftNotebookReconciler:
    """Register the ODH reconciler and both webhooks (odh main.go:141-347).
    Watch wiring mirrors SetupWithManager (:736-884): Owns the namespaced
    objects; Watches central-ns HTTPRoutes and CA-bundle ConfigMaps with
    label/name fan-out mappers."""
    cfg = cfg or OdhConfig.from_env()
    api = mgr.api
    rec = OpenshiftNotebookReconciler(api, cfg)

    api.register_admission(NotebookMutatingWebhook(api, cfg).hook())
    api.register_admission(NotebookValidatingWebhook(api, cfg).hook())

    # fleet sweeps in the fan-out mappers below read the informer cache's
    # namespace index instead of live-listing every Notebook per event
    cache = mgr.cache
    if cache is not None:
        cache.add_namespace_index("Notebook")

    def list_notebooks(namespace: str) -> list[KubeObject]:
        if cache is not None:
            return cache.list("Notebook", namespace=namespace)
        return api.list("Notebook", namespace=namespace)

    def httproute_to_request(route: KubeObject) -> list[Request]:
        name = route.metadata.labels.get(C.NOTEBOOK_NAME_LABEL)
        namespace = route.metadata.labels.get(C.NOTEBOOK_NAMESPACE_LABEL)
        if name and namespace:
            return [Request(namespace, name)]
        return []

    def configmap_to_requests(cm: KubeObject) -> list[Request]:
        # owned ConfigMaps (kube-rbac-proxy config) map to their notebook;
        # CA-bundle source ConfigMaps fan out to every notebook in the
        # namespace (odh SetupWithManager ConfigMap watch, :812-860)
        ref = cm.metadata.controller_owner()
        if ref is not None and ref.kind == "Notebook":
            return [Request(cm.namespace, ref.name)]
        if cm.name not in (
            C.ODH_TRUSTED_CA_BUNDLE_CONFIGMAP,
            C.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP,
            C.KUBE_ROOT_CA_CONFIGMAP,
            C.OPENSHIFT_SERVICE_CA_CONFIGMAP,
        ):
            return []
        return [
            Request(n.namespace, n.name)
            for n in list_notebooks(cm.namespace)
        ]

    def referencegrant_to_requests(grant: KubeObject) -> list[Request]:
        if grant.name != C.REFERENCEGRANT_NAME:
            return []
        notebooks = list_notebooks(grant.namespace)
        return [Request(n.namespace, n.name) for n in notebooks[:1]]

    mgr.register(
        "odh-notebook",
        rec,
        for_kind="Notebook",
        owns=[
            "ServiceAccount",
            "Service",
            "Secret",
            "NetworkPolicy",
            "RoleBinding",
        ],
        watches=[
            WatchSpec(kind="HTTPRoute", mapper=httproute_to_request),
            WatchSpec(kind="ReferenceGrant", mapper=referencegrant_to_requests),
            WatchSpec(kind="ConfigMap", mapper=configmap_to_requests),
        ],
        # the odh reconciler reads no Notebook status but the primary
        # replica; the core controller's other status writes must not
        # re-run the routing/auth pass
        for_predicate=suppress_status_only_but_promotion,
    )
    return rec
