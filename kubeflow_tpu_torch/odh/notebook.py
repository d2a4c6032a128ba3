"""The Notebook CR as the ODH plane reads and changes it.

The reference's ODH modules take its `api.types.Notebook`, a view that
changes the store object it wraps.  The port's `api.types.Notebook` is a
read-only view over a dict, so the port's ODH plane works on the CR's
`KubeObject` itself (`nb.name`, `nb.metadata.annotations`, ...), through
the accessors here for what the reference's view adds.
"""

from __future__ import annotations

from typing import Optional

from ..kube import KubeObject


def pod_spec(nb: KubeObject) -> dict:
    """The CR's PodSpec passthrough, created when absent, to change in
    place (the reference's `Notebook.pod_spec`)."""
    return nb.spec.setdefault("template", {}).setdefault("spec", {})


def main_container(nb: KubeObject) -> Optional[dict]:
    """The container named after the notebook, where JupyterLab runs."""
    for container in pod_spec(nb).get("containers") or []:
        if container.get("name") == nb.name:
            return container
    return None


__all__ = ["main_container", "pod_spec"]
