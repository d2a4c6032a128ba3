"""Notebook controller metrics: the port of kubeflow_tpu/core/metrics.py's
`NotebookMetrics`, for the families the port's reconcilers write.

Counters for creations, failures, cullings and cull checkpoints, the
last-cull timestamp, the first-readiness histogram, and a scraper-style
gauge that counts running notebooks from the workload StatefulSets
carrying the notebook-name label, with the GPUs their running gangs
request beside it.  The families keep the reference's names and labels,
on the port's `utils/metrics.py` Registry; the GPU gauge is the twin of
the reference's `notebook_tpu_chips_requested`.

The reference's other registrations (diagnosis, lifecycle, metering,
profiler, SLO, data plane, self-healing, scheduler, shards) wait for the
modules that write them (`ROADMAP.md` queue 1 item 16).
"""

from __future__ import annotations

from typing import Optional

from ..kube import ApiServer, parse_quantity
from ..utils.metrics import Registry
from . import constants as C


class NotebookMetrics:
    # the census keys' separator (never in a namespace or notebook name)
    _SEP = "\x1f"

    def __init__(self, api: ApiServer, registry: Optional[Registry] = None,
                 manager=None):
        self.api = api
        self.registry = registry or Registry()
        self.manager = manager  # kube.Manager: its registry joins /metrics
        self.running = self.registry.gauge(
            "notebook_running",
            "Current running notebooks in the cluster",
            labels=("namespace",),
        )
        self.creation = self.registry.counter(
            "notebook_create_total",
            "Total times of creating notebooks",
            labels=("namespace",),
        )
        self.fail_creation = self.registry.counter(
            "notebook_create_failed_total",
            "Total failure times of creating notebooks",
            labels=("namespace",),
        )
        self.culling = self.registry.counter(
            "notebook_culling_total",
            "Total times of culling notebooks",
            labels=("namespace", "name"),
        )
        self.last_culling_timestamp = self.registry.gauge(
            "last_notebook_culling_timestamp_seconds",
            "Timestamp of the last notebook culling in seconds",
            labels=("namespace", "name"),
        )
        self.gpus_requested = self.registry.gauge(
            "notebook_gpus_requested",
            "GPUs requested by running notebook gangs",
            labels=("namespace",),
        )
        # first-readiness latency, observed once per notebook by the
        # NotebookReconciler off the injected clock
        self.notebook_ready_seconds = self.registry.histogram(
            "notebook_to_ready_seconds",
            "Latency from Notebook creation to all workers Ready",
            labels=("namespace",),
            buckets=(1.0, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
                     1800.0, 3600.0),
        )
        # cull checkpoints the culler confirmed (trigger: cull)
        self.checkpoint_snapshots = self.registry.counter(
            "notebook_checkpoint_snapshots_total",
            "Session checkpoints recorded or confirmed by the controllers",
            labels=("namespace", "trigger"),
        )

    def attach_manager(self, manager) -> None:
        self.manager = manager

    @classmethod
    def _sts_census(cls, sts) -> dict:
        """One StatefulSet's contribution: a running key per (namespace,
        notebook) while it has replicas, and the GPUs its pods request."""
        nb_name = (sts.spec.get("template", {}).get("metadata", {})
                   .get("labels", {}).get(C.NOTEBOOK_NAME_LABEL))
        if nb_name is None:
            return {}
        out: dict[str, float] = {}
        replicas = int(sts.spec.get("replicas", 0) or 0)
        if replicas > 0:
            out[cls._SEP.join(("run", sts.namespace, nb_name))] = 1.0
        gpus = 0.0
        for c in sts.spec.get("template", {}).get("spec", {}).get(
                "containers", []):
            q = (c.get("resources", {}).get("requests") or {}).get(
                C.GPU_RESOURCE)
            if q:
                gpus += parse_quantity(q) * replicas
        if gpus:
            out[cls._SEP.join(("gpus", sts.namespace))] = gpus
        return out

    def scrape(self, openmetrics: bool = False) -> str:
        """Recompute the census gauges (off the informer cache's
        incremental aggregate when a manager is attached, else by listing
        StatefulSets) and render the exposition."""
        cache = getattr(self.manager, "cache", None)
        if cache is not None:
            # registered once (idempotent), then kept by the watch stream
            cache.add_aggregate("StatefulSet", "nb-census", self._sts_census)
            census = cache.aggregate("StatefulSet", "nb-census")
        else:
            census = {}
            for sts in self.api.list("StatefulSet"):
                for key, v in self._sts_census(sts).items():
                    census[key] = census.get(key, 0.0) + v
        running: dict[str, int] = {}
        for key, v in census.items():
            parts = key.split(self._SEP)
            if parts[0] == "run":
                running[parts[1]] = running.get(parts[1], 0) + 1
            elif parts[0] == "gpus":
                self.gpus_requested.labels(parts[1]).set(v)
        for ns, n in running.items():
            self.running.labels(ns).set(n)
        return self.render(openmetrics=openmetrics)

    def render(self, openmetrics: bool = False) -> str:
        """This registry plus the attached manager's reconcile/workqueue
        registry as one exposition (OpenMetrics ends with `# EOF`)."""
        text = self.registry.render(openmetrics=openmetrics)
        mgr_registry = getattr(self.manager, "metrics_registry", None)
        if mgr_registry is not None:
            text += mgr_registry.render(openmetrics=openmetrics)
        if openmetrics:
            text += "# EOF\n"
        return text


__all__ = ["NotebookMetrics"]
