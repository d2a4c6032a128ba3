"""Group/Version/Resource registry: kind -> REST path mapping.

The port's copy of kubeflow_tpu/kube/resources.py.

The reference gets this from the client-go scheme + RESTMapper (every typed
client call resolves a GVK to a request path).  We keep an explicit table for
the kinds the notebook stack touches; unknown kinds can be registered at
runtime (the analog of AddToScheme, notebook-controller/main.go:47-56).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ResourceInfo:
    kind: str
    group: str          # "" for the core group
    version: str
    plural: str
    namespaced: bool = True

    @property
    def api_version(self) -> str:
        return self.version if not self.group else f"{self.group}/{self.version}"

    def prefix(self) -> str:
        """URL prefix up to (not including) the namespace/resource segments."""
        if not self.group:
            return f"/api/{self.version}"
        return f"/apis/{self.group}/{self.version}"

    def collection_path(self, namespace: str | None) -> str:
        if self.namespaced and namespace:
            return f"{self.prefix()}/namespaces/{namespace}/{self.plural}"
        return f"{self.prefix()}/{self.plural}"

    def object_path(self, namespace: str | None, name: str) -> str:
        return f"{self.collection_path(namespace)}/{name}"


_CORE = [
    ("Pod", "pods"), ("Service", "services"), ("ConfigMap", "configmaps"),
    ("Secret", "secrets"), ("ServiceAccount", "serviceaccounts"),
    ("Event", "events"),
]

_BUILTIN: list[ResourceInfo] = [
    *[ResourceInfo(k, "", "v1", p) for k, p in _CORE],
    ResourceInfo("Node", "", "v1", "nodes", namespaced=False),
    # cluster-scoped: discovery must say namespaced=false (the route
    # special-case in wire.route_path already treats it that way)
    ResourceInfo("Namespace", "", "v1", "namespaces", namespaced=False),
    ResourceInfo("StatefulSet", "apps", "v1", "statefulsets"),
    ResourceInfo("Deployment", "apps", "v1", "deployments"),
    ResourceInfo("NetworkPolicy", "networking.k8s.io", "v1", "networkpolicies"),
    ResourceInfo("Role", "rbac.authorization.k8s.io", "v1", "roles"),
    ResourceInfo("RoleBinding", "rbac.authorization.k8s.io", "v1", "rolebindings"),
    ResourceInfo("ClusterRole", "rbac.authorization.k8s.io", "v1",
                 "clusterroles", namespaced=False),
    ResourceInfo("ClusterRoleBinding", "rbac.authorization.k8s.io", "v1",
                 "clusterrolebindings", namespaced=False),
    ResourceInfo("Lease", "coordination.k8s.io", "v1", "leases"),
    ResourceInfo("Notebook", "kubeflow.org", "v1", "notebooks"),
    ResourceInfo("HTTPRoute", "gateway.networking.k8s.io", "v1", "httproutes"),
    ResourceInfo("Gateway", "gateway.networking.k8s.io", "v1", "gateways"),
    ResourceInfo("ReferenceGrant", "gateway.networking.k8s.io", "v1beta1",
                 "referencegrants"),
    # v1alpha3 matches what the controller renders (workload.py
    # generate_virtual_service; reference notebook_controller.go:581)
    ResourceInfo("VirtualService", "networking.istio.io", "v1alpha3",
                 "virtualservices"),
    ResourceInfo("ImageStream", "image.openshift.io", "v1", "imagestreams"),
    ResourceInfo("Route", "route.openshift.io", "v1", "routes"),
    ResourceInfo("Proxy", "config.openshift.io", "v1", "proxies", namespaced=False),
    ResourceInfo("APIServer", "config.openshift.io", "v1", "apiservers",
                 namespaced=False),
    ResourceInfo("OAuthClient", "oauth.openshift.io", "v1", "oauthclients",
                 namespaced=False),
    ResourceInfo("DataSciencePipelinesApplication",
                 "datasciencepipelinesapplications.opendatahub.io", "v1",
                 "datasciencepipelinesapplications"),
    ResourceInfo("CustomResourceDefinition", "apiextensions.k8s.io", "v1",
                 "customresourcedefinitions", namespaced=False),
    ResourceInfo("MutatingWebhookConfiguration", "admissionregistration.k8s.io",
                 "v1", "mutatingwebhookconfigurations", namespaced=False),
    ResourceInfo("ValidatingWebhookConfiguration", "admissionregistration.k8s.io",
                 "v1", "validatingwebhookconfigurations", namespaced=False),
]


class Scheme:
    """Kind <-> resource-path mapping with runtime registration."""

    def __init__(self) -> None:
        self._by_kind: dict[str, ResourceInfo] = {}
        self._by_path: dict[tuple[str, str, str], ResourceInfo] = {}
        for info in _BUILTIN:
            self.register(info)
        # Notebook serves three versions (reference CRD: v1 storage, all
        # served — api/v1/notebook_types.go:65-68); the extra versions are
        # path aliases so /apis/kubeflow.org/v1beta1/... routes, while
        # by_kind (the storage version clients default to) stays v1.
        for v in ("v1alpha1", "v1beta1"):
            self.register_served(ResourceInfo("Notebook", "kubeflow.org", v,
                                              "notebooks"))

    def register(self, info: ResourceInfo) -> None:
        self._by_kind[info.kind] = info
        self._by_path[(info.group, info.version, info.plural)] = info

    def register_served(self, info: ResourceInfo) -> None:
        """Register an additional served version: routable by path, but not
        the kind's storage/default version."""
        self._by_path[(info.group, info.version, info.plural)] = info

    def by_kind(self, kind: str) -> ResourceInfo:
        info = self._by_kind.get(kind)
        if info is None:
            raise KeyError(f"kind {kind!r} not registered in scheme")
        return info

    def served(self) -> list[ResourceInfo]:
        """Every served (group, version, plural) mapping — the discovery
        document source (storage versions AND path aliases)."""
        return list(self._by_path.values())

    def storage_versions(self) -> set[tuple[str, str]]:
        """(group, version) pairs that are some kind's storage/default
        version — discovery marks these preferred."""
        return {(i.group, i.version) for i in self._by_kind.values()}

    def by_path(self, group: str, version: str, plural: str) -> ResourceInfo | None:
        return self._by_path.get((group, version, plural))

    def kinds(self) -> list[str]:
        return sorted(self._by_kind)


DEFAULT_SCHEME = Scheme()
