"""Jupyter server activity probing.

The port's copy of kubeflow_tpu/core/jupyter.py.

The reference talks plain HTTP to the Jupyter REST API through the notebook
Service DNS (culling_controller.go:244-322):
GET http://{name}.{ns}.svc.{domain}/notebook/{ns}/{name}/api/kernels and
/api/terminals, 10s timeout, 1MiB body cap, nil on non-200 or bad JSON.

The transport is a protocol so the culling controller is testable without a
network (the fake holds per-notebook kernel/terminal state) and so a future
gRPC/ipc activity channel (e.g. a TPU MFU heartbeat) can slot in."""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Optional, Protocol

PROBE_TIMEOUT_S = 10.0
BODY_LIMIT = 1 << 20


class JupyterAPI(Protocol):
    def get_kernels(self, name: str, namespace: str) -> Optional[list[dict]]: ...
    def get_terminals(self, name: str, namespace: str) -> Optional[list[dict]]: ...


class HttpJupyterClient:
    """Production transport (getNotebookResourceResponse, :244-274): in-cluster
    Service DNS, or the kubectl proxy path under DEV."""

    def __init__(self, cluster_domain: str = "cluster.local", dev: bool = False,
                 base_url: str = ""):
        self.cluster_domain = cluster_domain
        self.dev = dev
        # base_url overrides host resolution (a third transport next to
        # in-cluster DNS and the DEV kubectl-proxy path): tests and
        # port-forward setups point it at a concrete host:port while keeping
        # the /notebook/{ns}/{name} path contract
        self.base_url = base_url.rstrip("/")

    def _url(self, name: str, namespace: str, resource: str) -> str:
        if self.base_url:
            return (f"{self.base_url}/notebook/{namespace}/{name}"
                    f"/api/{resource}")
        if self.dev:
            # port name must match generate_service's "http-notebook" (the
            # reference's dev path addresses "http-{name}", which only works
            # for a notebook literally named "notebook" — fixed here)
            return (
                f"http://localhost:8001/api/v1/namespaces/{namespace}/services/"
                f"{name}:http-notebook/proxy/notebook/{namespace}/{name}/api/{resource}"
            )
        return (
            f"http://{name}.{namespace}.svc.{self.cluster_domain}"
            f"/notebook/{namespace}/{name}/api/{resource}"
        )

    def _get(self, name: str, namespace: str, resource: str) -> Optional[list[dict]]:
        url = self._url(name, namespace, resource)
        try:
            with urllib.request.urlopen(url, timeout=PROBE_TIMEOUT_S) as resp:
                if resp.status != 200:
                    return None
                body = resp.read(BODY_LIMIT)
        except (urllib.error.URLError, OSError, ValueError):
            return None
        try:
            data = json.loads(body)
        except ValueError:
            return None
        return data if isinstance(data, list) else None

    def get_kernels(self, name: str, namespace: str) -> Optional[list[dict]]:
        return self._get(name, namespace, "kernels")

    def get_terminals(self, name: str, namespace: str) -> Optional[list[dict]]:
        return self._get(name, namespace, "terminals")


class FakeJupyterState:
    """Test/standalone transport: per-notebook kernel and terminal state.

    kernels entries: {"id", "name", "last_activity", "execution_state",
    "connections"}; terminals: {"name", "last_activity"} — the shapes the
    Jupyter API returns (KernelStatus/TerminalStatus,
    culling_controller.go:63-85)."""

    def __init__(self) -> None:
        self._kernels: dict[tuple[str, str], Optional[list[dict]]] = {}
        self._terminals: dict[tuple[str, str], Optional[list[dict]]] = {}

    def set_kernels(
        self, namespace: str, name: str, kernels: Optional[list[dict]]
    ) -> None:
        self._kernels[(namespace, name)] = kernels

    def set_terminals(
        self, namespace: str, name: str, terminals: Optional[list[dict]]
    ) -> None:
        self._terminals[(namespace, name)] = terminals

    def get_kernels(self, name: str, namespace: str) -> Optional[list[dict]]:
        return self._kernels.get((namespace, name))

    def get_terminals(self, name: str, namespace: str) -> Optional[list[dict]]:
        return self._terminals.get((namespace, name))
