"""Cluster TLS security-profile negotiation + change watcher.

The port's copy of kubeflow_tpu/odh/tls_profile.py, the port of the ODH
manager's TLS posture handling (odh main.go:68-78,178-214,
324-340 and its tls package): read the OpenShift `APIServer` cluster CR's
`spec.tlsSecurityProfile`, translate it to a cipher list + minimum TLS
version for the webhook/metrics servers, fall back to the hardened Mozilla
Intermediate set when the CR doesn't exist (non-OpenShift), and watch for
profile changes — a change triggers a deliberate graceful restart so the
servers reload with the new posture.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..kube import ApiServer, Manager, Request, Result

# Mozilla Intermediate (odh main.go:70-78) — the hardened fallback
INTERMEDIATE_CIPHERS = (
    "TLS_ECDHE_ECDSA_WITH_AES_128_GCM_SHA256",
    "TLS_ECDHE_RSA_WITH_AES_128_GCM_SHA256",
    "TLS_ECDHE_ECDSA_WITH_AES_256_GCM_SHA384",
    "TLS_ECDHE_RSA_WITH_AES_256_GCM_SHA384",
    "TLS_ECDHE_ECDSA_WITH_CHACHA20_POLY1305_SHA256",
    "TLS_ECDHE_RSA_WITH_CHACHA20_POLY1305_SHA256",
)

# OpenShift named profiles (configv1.TLSProfiles subset we honor)
_PROFILES: dict[str, tuple[str, tuple[str, ...]]] = {
    "Old": ("VersionTLS10", INTERMEDIATE_CIPHERS),
    "Intermediate": ("VersionTLS12", INTERMEDIATE_CIPHERS),
    "Modern": (
        "VersionTLS13",
        (
            "TLS_AES_128_GCM_SHA256",
            "TLS_AES_256_GCM_SHA384",
            "TLS_CHACHA20_POLY1305_SHA256",
        ),
    ),
}


@dataclass(frozen=True)
class TLSProfileSpec:
    min_version: str
    ciphers: tuple[str, ...]
    source: str  # "apiserver" | "fallback"


HARDENED_FALLBACK = TLSProfileSpec(
    "VersionTLS12", INTERMEDIATE_CIPHERS, "fallback"
)


def profile_from_spec(spec: dict) -> TLSProfileSpec:
    """tlsSecurityProfile dict -> resolved profile.  `Custom` profiles carry
    explicit ciphers/minTLSVersion; named profiles use the table."""
    profile_type = spec.get("type", "Intermediate")
    if profile_type == "Custom":
        custom = spec.get("custom") or {}
        return TLSProfileSpec(
            custom.get("minTLSVersion", "VersionTLS12"),
            tuple(custom.get("ciphers") or INTERMEDIATE_CIPHERS),
            "apiserver",
        )
    min_version, ciphers = _PROFILES.get(profile_type, _PROFILES["Intermediate"])
    return TLSProfileSpec(min_version, ciphers, "apiserver")


def fetch_apiserver_tls_profile(api: ApiServer) -> TLSProfileSpec:
    """FetchAPIServerTLSProfile analog: APIServer CR `cluster` (cluster
    scoped), hardened fallback when absent (odh main.go:191-201)."""
    apiserver = api.try_get("APIServer", "", "cluster")
    if apiserver is None:
        return HARDENED_FALLBACK
    spec = apiserver.spec.get("tlsSecurityProfile") or {}
    if not spec:
        return HARDENED_FALLBACK
    return profile_from_spec(spec)


@dataclass
class SecurityProfileWatcher:
    """Reconciler on the APIServer CR: when the resolved profile differs
    from the one the servers started with, invoke on_change (the manager
    cancels/restarts — odh main.go:324-340)."""

    api: ApiServer
    initial: TLSProfileSpec
    on_change: Callable[[TLSProfileSpec, TLSProfileSpec], None]
    _fired: bool = field(default=False, init=False)

    def reconcile(self, req: Request) -> Result:
        if req.name != "cluster" or self._fired:
            return Result()
        current = fetch_apiserver_tls_profile(self.api)
        if current.source == "apiserver" and current != self.initial:
            self._fired = True
            self.on_change(self.initial, current)
        return Result()

    def setup(self, mgr: Manager) -> None:
        mgr.register("tls-profile-watcher", self, for_kind="APIServer")
