"""Manager entrypoint: `python -m kubeflow_tpu_torch.main`.

The port of kubeflow_tpu/main.py: one manager running the notebook
controller, the event re-emitter, (with ENABLE_CULLING) the culler, and
the ODH extension plane (odh/: its reconciler, its two admission
webhooks, and the TLS profile watcher, whose change stops the manager for
a restart), with the health/readiness/metrics HTTP side real.  Env vars
are the config surface (utils/config.py), under the reference's names.

Backends:
- real cluster: `--kubeconfig PATH` or `--in-cluster` builds a KubeClient
  speaking the Kubernetes REST API (`--qps`/`--burst` throttle it), starts
  list-then-watch informers for every watched kind (cluster-wide, or one
  namespace with `--watch-namespace`), serves the admission webhooks over
  HTTPS (`--webhook-port`, `--cert-dir`; a dev pair is minted when the
  directory holds none) and, with `--enable-leader-election`, reconciles
  only while it holds the Lease (`--leader-election-namespace`): /readyz
  reads "not the leader" until then, and a lost lease stops the manager.
- standalone: the in-memory API server with the fake data plane.
  `--serve-api PORT` serves that store over the Kubernetes REST wire
  protocol with the Notebook converter (`--audit-log PATH` appends its
  JSONL request trail), and `--fake-gpu-nodes N` adds N full H100 hosts
  labelled by `gpu/device_plugin.py:label_gpu_node`, so a CR sent over
  the wire schedules.  Under `--serve-api` the store is seeded with the
  port's Notebook CRD (`deploy/manifests.py:notebook_crd`), so /openapi
  serves its field models, `spec.gpu` among them.

The observability plane runs in every manager: the SLO engine, the
data-plane telemetry rollup, the lifecycle ledger, the TSDB, the tenant
metering ledger and the diagnosis engine are attached to the metrics
scrape, and the continuous profiler runs under
ENABLE_CONTINUOUS_PROFILER.  Their /debug surfaces answer loopback peers
only (`HealthAndMetricsHandler`), and `/state` is served behind
`--expose-state`.  `--log-format json` logs one JSON object a line with
the live span's trace and span ids (utils/logging.py).

`--demo` creates a sample GPU notebook (`spec.gpu {--demo-accelerator,
--demo-count}`) on fake GPU nodes sized to its gang, prints its status
once it reads Healthy, after the ODH reconciler has lifted the
reconciliation lock the webhook stamped on it, and stamps one telemetry
summary per worker for the data-plane rollup: the twin of
`python -m kubeflow_tpu.main --demo`.

`build_sharded_fleet` is the active-active control plane (SHARD_COUNT
replicas, kube/shard.py) over one in-memory ApiServer, with one
lifecycle ledger, TSDB, metering ledger and diagnosis engine serving
every replica.
"""

from __future__ import annotations

import argparse
import http.server
import json
import logging
import os
import socket
import threading
import urllib.parse
from typing import Optional

from .api.types import GPUSpec, Notebook
from .core.culling_controller import setup_culling
from .core.metrics import NotebookMetrics
from .core.notebook_controller import setup_core_controllers
from .core.telemetry import WorkerTelemetryAggregator
from .gpu import topology
from .kube import (
    ApiServer,
    EventRecorder,
    FakeCluster,
    KubeObject,
    LeaderElector,
    Manager,
    ShardedFleet,
)
from .odh.controller import setup_odh_controllers
from .odh.tls_profile import SecurityProfileWatcher, fetch_apiserver_tls_profile
from .utils.clock import Clock
from .utils.config import CoreConfig, OdhConfig
from .utils.diagnosis import DiagnosisEngine
from .utils.lifecycle import LifecycleLedger
from .utils.logging import setup_structured_logging
from .utils.metering import TenantMeteringLedger
from .utils.profiler import ContinuousProfiler
from .utils.slo import SLOEngine, default_objectives
from .utils.tsdb import TimeSeriesStore

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4"
OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"


def negotiate_metrics_format(accept: str) -> bool:
    """True when the Accept header asks for OpenMetrics (media ranges with
    q-values: Prometheus sends
    `application/openmetrics-text;version=1.0.0;q=0.5,text/plain;q=0.3`
    and expects the exemplar-capable format to win; a plain curl gets the
    classic text format)."""
    q_om, q_plain = 0.0, 0.0
    for part in (accept or "").split(","):
        bits = part.split(";")
        media = bits[0].strip().lower()
        q = 1.0
        for param in bits[1:]:
            param = param.strip()
            if param.startswith("q="):
                try:
                    q = float(param[2:])
                except ValueError:
                    q = 0.0
        if media == "application/openmetrics-text":
            q_om = max(q_om, q)
        elif media in ("text/plain", "text/*", "*/*"):
            q_plain = max(q_plain, q)
    return q_om > 0 and q_om >= q_plain


class HealthAndMetricsHandler(http.server.BaseHTTPRequestHandler):
    """Probe + scrape + debug surface (main.go:125-133, metrics on :8080):

    - /healthz  — liveness: process up and the manager not stopped;
    - /readyz   — readiness: additionally the manager STARTED, its
      watch/informer caches synced, and (when leader election is on) this
      replica leading: a follower is alive but must not take traffic;
    - /metrics  — content-negotiated: OpenMetrics (exemplars + `# EOF`)
      when the scraper asks for it, Prometheus text 0.0.4 otherwise;
    - /debug/reconciles, /debug/traces/<id>, /debug/workqueue — the flight
      recorder and workqueue introspection, loopback-only (same rationale
      as /state: diagnosis happens via `kubectl exec`/port-forward, and
      trace payloads carry object names and error strings that must not be
      scrapeable from off-pod);
    - /debug/alerts — the SLO engine's burn-alert surface: objective
      stats, firing alerts (each annotated with the diagnosis engine's
      one-line verdict for its exemplar), and the bounded fire/resolve
      history (each alert carrying an exemplar trace_id resolvable at
      /debug/traces);
    - /debug/explain — ?object=<ns>/<name> returns the diagnosis
      engine's ranked causal chain for one notebook, every link citing
      its evidence (trace_id, event, metric sample);
    - /debug/changepoints — the fleet change-point detector's annotated
      findings over the TSDB's watched series, each correlated against
      the discrete event timeline (fault windows, promotions, shard
      epochs, warm-pool resizes, straggler onsets, noisy tenants);
    - /debug/profile — the continuous profiler's aggregated collapsed
      stacks (JSON, or flamegraph text with ?format=collapsed);
    - /debug/fleet — per-namespace / per-shape health rollup off the
      informer cache's incremental census (O(series) per request) plus
      the SLO verdicts;
    - /debug/criticalpath — the lifecycle ledger's fleet-wide stage
      ranking (mean/p99 contribution per stage to event->ready) and its
      conservation check (attributed sum vs measured wall time);
    - /debug/timeline — the in-process TSDB: ?series=<name>&tier=raw|10s|
      60s returns one downsampled series; ?dump=1 the full multi-tier
      capture (what a diagnose bundle keeps); without either the
      inventory;
    - /debug/tenants — the tenant metering ledger: per-tenant chip-second
      buckets and control-plane attribution, top-K consumers, fairness
      verdicts (noisy-neighbor flags), and the chip-second conservation
      gate;
    - /state    — in-memory store dump (includes Secret data; additionally
      gated on --expose-state)."""

    manager: Optional[Manager] = None
    metrics: Optional[NotebookMetrics] = None
    expose_state: bool = False  # /state dumps Secrets — loopback/debug only
    elector = None  # LeaderElector when --enable-leader-election

    def _loopback_only(self) -> bool:
        """True when the request may see debug payloads: the TCP peer is a
        loopback address (pod-local exec / port-forward lands here)."""
        host = self.client_address[0]
        return host in ("127.0.0.1", "::1", "::ffff:127.0.0.1")

    def _not_ready(self) -> str:
        """Empty string when ready to serve traffic, else the reason."""
        mgr = self.manager
        if mgr is None:
            return "no manager"
        if mgr.stopped:
            return "manager stopped"
        if not mgr.started:
            return "manager not started"
        if not mgr.caches_synced():
            return "caches not synced"
        if self.elector is not None and not self.elector.is_leader:
            return "not the leader"
        return ""

    def do_GET(self):  # noqa: N802  (stdlib API)
        url = urllib.parse.urlsplit(self.path)
        path = url.path
        if path == "/healthz":
            # liveness only: a stopped manager (TLS-profile restart, fatal
            # error) must fail so the Deployment actually restarts the pod,
            # but an unsynced follower is perfectly alive
            if self.manager is not None and self.manager.stopped:
                self._respond(503, "manager stopped", "text/plain")
            else:
                self._respond(200, "ok", "text/plain")
        elif path == "/readyz":
            reason = self._not_ready()
            if reason:
                self._respond(503, f"not ready: {reason}", "text/plain")
            else:
                self._respond(200, "ok", "text/plain")
        elif path == "/metrics":
            # scrape() recomputes list-derived gauges and folds in the
            # manager's reconcile/workqueue registry; a bare render() would
            # serve stale gauges and miss the controller_runtime_* families
            openmetrics = negotiate_metrics_format(
                self.headers.get("Accept", ""))
            if self.metrics is not None:
                body = self.metrics.scrape(openmetrics=openmetrics)
            else:
                body = "# EOF\n" if openmetrics else ""
            self._respond(200, body,
                          OPENMETRICS_CONTENT_TYPE if openmetrics
                          else PROMETHEUS_CONTENT_TYPE)
        elif path.startswith("/debug/"):
            if not self._loopback_only():
                self._respond(403, "debug endpoints are loopback-only",
                              "text/plain")
                return
            self._serve_debug(path, urllib.parse.parse_qs(url.query))
        elif path == "/state" and self.expose_state:
            if not self._loopback_only():
                self._respond(403, "/state is loopback-only", "text/plain")
                return
            api = self.manager.api if self.manager else None
            # the real-cluster KubeClient has no dump(); only the in-memory
            # store can be exported
            dump = getattr(api, "dump", None)
            body = json.dumps(dump() if callable(dump) else {}, default=str)
            self._respond(200, body, "application/json")
        else:
            self._respond(404, "not found", "text/plain")

    def _serve_debug(self, path: str, query: dict) -> None:
        mgr = self.manager
        if mgr is None:
            self._respond(503, "no manager", "text/plain")
            return
        recorder = mgr.flight_recorder
        if path == "/debug/reconciles":
            object_key = (query.get("object") or [None])[0]
            body = recorder.snapshot(object_key=object_key)
            self._respond(200, json.dumps(body, default=str),
                          "application/json")
        elif path.startswith("/debug/traces/"):
            trace_id = path[len("/debug/traces/"):]
            trace = recorder.trace(trace_id)
            if trace is None:
                self._respond(404, json.dumps(
                    {"error": f"trace {trace_id!r} not recorded "
                     "(unknown, or evicted from the bounded trace store)"}),
                    "application/json")
            else:
                self._respond(200, json.dumps(trace, default=str),
                              "application/json")
        elif path == "/debug/workqueue":
            self._respond(200, json.dumps(mgr.workqueue_debug(), default=str),
                          "application/json")
        elif path == "/debug/alerts":
            engine = getattr(mgr, "slo_engine", None)
            body = engine.snapshot() if engine is not None else {
                "enabled": False,
                "error": "no SLO engine attached to this manager"}
            diagnosis = getattr(mgr, "diagnosis", None)
            if engine is not None and diagnosis is not None:
                # each firing alert gains a one-line `diagnosis` verdict
                # for its latched exemplar ("" when no verdict, never an
                # error)
                body = diagnosis.annotate_alerts(body)
            self._respond(200, json.dumps(body, default=str),
                          "application/json")
        elif path == "/debug/explain":
            diagnosis = getattr(mgr, "diagnosis", None)
            object_key = (query.get("object") or [""])[0]
            if diagnosis is None:
                body = {"enabled": False,
                        "error": "no diagnosis engine attached to this "
                                 "manager"}
            elif "/" not in object_key:
                body = {"error": "pass ?object=<namespace>/<name>",
                        "object": object_key, "verdict": ""}
            else:
                ns, _, name = object_key.partition("/")
                body = diagnosis.explain(ns, name)
            self._respond(200, json.dumps(body, default=str),
                          "application/json")
        elif path == "/debug/changepoints":
            diagnosis = getattr(mgr, "diagnosis", None)
            if diagnosis is None:
                body = {"enabled": False,
                        "error": "no diagnosis engine attached to this "
                                 "manager"}
            else:
                # evaluate on read so an operator polling between scrapes
                # sees shifts in the latest samples, not the last scrape's
                diagnosis.evaluate()
                body = diagnosis.snapshot()
            self._respond(200, json.dumps(body, default=str),
                          "application/json")
        elif path == "/debug/profile":
            profiler = getattr(mgr, "profiler", None)
            fmt = (query.get("format") or ["json"])[0]
            if profiler is None:
                if fmt == "collapsed":
                    self._respond(200, "", "text/plain")
                else:
                    self._respond(200, json.dumps(
                        {"enabled": False, "samples_total": 0, "stacks": [],
                         "hint": "set ENABLE_CONTINUOUS_PROFILER=true"}),
                        "application/json")
            elif fmt == "collapsed":
                self._respond(200, profiler.collapsed(), "text/plain")
            else:
                self._respond(200, json.dumps(profiler.snapshot(),
                                              default=str),
                              "application/json")
        elif path == "/debug/fleet":
            if self.metrics is None:
                self._respond(503, "no metrics", "text/plain")
                return
            self._respond(200, json.dumps(self.metrics.fleet_snapshot(),
                                          default=str),
                          "application/json")
        elif path == "/debug/criticalpath":
            ledger = getattr(mgr, "lifecycle", None)
            body = ledger.snapshot() if ledger is not None else {
                "enabled": False,
                "error": "no lifecycle ledger attached to this manager"}
            self._respond(200, json.dumps(body, default=str),
                          "application/json")
        elif path == "/debug/tenants":
            metering = getattr(mgr, "metering", None)
            body = metering.snapshot() if metering is not None else {
                "enabled": False,
                "error": "no tenant metering ledger attached to this "
                         "manager"}
            if self.metrics is not None:
                # per-tenant admission-gate view (queue depth, quota
                # usage, recent preemptions) — same source as the
                # tenancy section of /debug/fleet
                body["tenancy"] = self.metrics.tenancy_snapshot()
            self._respond(200, json.dumps(body, default=str),
                          "application/json")
        elif path == "/debug/timeline":
            store = getattr(mgr, "tsdb", None)
            if store is None:
                body = {"enabled": False,
                        "error": "no time-series store attached"}
            else:
                series = (query.get("series") or [None])[0]
                tier = (query.get("tier") or ["raw"])[0]
                dump = (query.get("dump") or [""])[0]
                if series:
                    body = store.query(series, tier=tier)
                elif dump in ("1", "true"):
                    body = store.dump()  # full capture, for bundles
                else:
                    body = store.snapshot()
            self._respond(200, json.dumps(body, default=str),
                          "application/json")
        else:
            self._respond(404, "not found", "text/plain")

    def _respond(self, code: int, body: str, ctype: str) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):  # quiet
        pass


def serve_http(port: int, manager: Manager, metrics: NotebookMetrics,
               expose_state: bool = False, elector=None):
    """Health + metrics on all interfaces (the kubelet probes the pod IP
    and Prometheus scrapes :8080).  The /debug/* endpoints answer only
    loopback clients, and the /state dump, which includes Secret data,
    additionally needs `expose_state` (--expose-state); /readyz gates on
    `elector`'s leadership when one is given.  Returns the running server
    (port 0 picks a free one: `server.server_address[1]`)."""
    handler = type(
        "Handler",
        (HealthAndMetricsHandler,),
        {"manager": manager, "metrics": metrics,
         "expose_state": expose_state, "elector": elector},
    )
    server = http.server.ThreadingHTTPServer(("0.0.0.0", port), handler)
    # a 0.1 s shutdown poll (the stdlib's is 0.5 s): a SIGINT exit waits
    # for it
    threading.Thread(target=server.serve_forever,
                     kwargs={"poll_interval": 0.1}, daemon=True).start()
    return server


def build_manager(
    core_cfg: Optional[CoreConfig] = None,
    clock: Optional[Clock] = None,
    jupyter=None,
    odh_cfg: Optional[OdhConfig] = None,
    api=None,
):
    """Wire the full stack; returns (manager, api, cluster, metrics).

    `api` is a KubeClient (a real cluster, and then no fake data plane:
    `cluster` is None) or None (the in-memory store with a FakeCluster);
    both expose the same read/write/watch surface.

    `clock` (a FakeClock in tests and in the card's smoke run) drives the
    manager and every controller; `jupyter` is the culler's activity
    probe (`core.jupyter.FakeJupyterState` standalone; by default the
    HTTP client of the reference); `odh_cfg` configures the ODH plane
    (`OdhConfig.from_env()` when not given).  The observability engines
    are attached in the reference's order and hang on the manager
    (`slo_engine`, `telemetry_aggregator`, `lifecycle`, `tsdb`,
    `metering`, `diagnosis`, and `profiler` when it runs); the caller
    stops a running profiler (`mgr.profiler.stop()`)."""
    core_cfg = core_cfg or CoreConfig.from_env()
    odh_cfg = odh_cfg or OdhConfig.from_env()
    real_cluster = api is not None
    if api is None:
        api = ApiServer(history_size=core_cfg.watch_history_size)
    cluster = None if real_cluster else FakeCluster(api)
    mgr = Manager(api, clock=clock)
    metrics = NotebookMetrics(api, manager=mgr)
    # fleet SLO engine: declared objectives (SLO_* knobs) over the metric
    # streams, evaluated at every scrape; alerts serve at /debug/alerts
    engine = SLOEngine(
        default_objectives(core_cfg),
        registries=[metrics.registry, mgr.metrics_registry],
        clock=mgr.clock,
        windows=(core_cfg.slo_short_window_s, core_cfg.slo_long_window_s),
        burn_threshold=core_cfg.slo_burn_alert_threshold,
        recorder=mgr.flight_recorder)
    metrics.attach_slo(engine)
    mgr.slo_engine = engine
    # data-plane rollup: per-worker telemetry annotations -> per-notebook
    # series + straggler detection, evaluated at every scrape (before the
    # SLO engine, which burns against its verdict counters) and surfaced
    # in /debug/fleet
    aggregator = WorkerTelemetryAggregator(
        api, metrics.registry, mgr.clock, cache=mgr.cache,
        recorder=EventRecorder(api, "dataplane-telemetry"),
        straggler_ratio=core_cfg.dataplane_straggler_ratio,
        min_workers=core_cfg.dataplane_straggler_min_workers,
        mfu_target=core_cfg.dataplane_mfu_target)
    metrics.attach_dataplane(aggregator)
    mgr.telemetry_aggregator = aggregator
    # lifecycle stage ledger + in-process TSDB: the manager feeds the
    # ledger with every finished attempt (critical-path attribution at
    # /debug/criticalpath), and each metrics scrape appends one TSDB
    # sample (p99-vs-time history at /debug/timeline)
    ledger = LifecycleLedger(
        registry=metrics.registry,
        max_notebooks=core_cfg.lifecycle_max_notebooks,
        samples_per_stage=core_cfg.lifecycle_samples_per_stage,
        tolerance=core_cfg.lifecycle_tolerance)
    mgr.lifecycle = ledger
    metrics.attach_lifecycle(ledger)
    tsdb = TimeSeriesStore(
        raw_capacity=core_cfg.tsdb_raw_capacity,
        tier10_capacity=core_cfg.tsdb_tier10_capacity,
        tier60_capacity=core_cfg.tsdb_tier60_capacity,
        max_series=core_cfg.tsdb_max_series)
    mgr.tsdb = tsdb
    metrics.attach_tsdb(tsdb, clock=mgr.clock)
    # tenant metering ledger: chip-second accrual + control-plane
    # attribution + noisy-neighbor detection, fed by the manager's
    # dispatch/attempt hooks and each metrics scrape; serves at
    # /debug/tenants and rides in /debug/fleet
    metering = TenantMeteringLedger(
        mgr.clock, registry=metrics.registry,
        recorder=EventRecorder(api, "tenant-metering"),
        max_tenants=core_cfg.metering_max_tenants,
        max_notebooks=core_cfg.metering_max_notebooks,
        tolerance=core_cfg.metering_tolerance,
        fairshare_factor=core_cfg.tenant_fairshare_factor,
        top_k=core_cfg.tenant_top_k,
        slo_engine=engine)
    mgr.metering = metering
    metrics.attach_metering(metering)
    # causal diagnosis engine: fuses every stream above into per-notebook
    # verdicts (/debug/explain) and TSDB change-point findings
    # (/debug/changepoints); evaluated once per scrape after the TSDB
    # sample lands
    diagnosis = DiagnosisEngine(
        mgr.clock, registry=metrics.registry,
        recorder=mgr.flight_recorder, lifecycle=ledger, slo_engine=engine,
        metering=metering, tsdb=tsdb, dataplane=aggregator, api=api)
    mgr.diagnosis = diagnosis
    metrics.attach_diagnosis(diagnosis)
    if core_cfg.enable_continuous_profiler:
        # always-on (controller, phase) CPU attribution; self-overhead is
        # exported so "can it stay on" is a gauge (/debug/profile)
        mgr.profiler = ContinuousProfiler(
            registry=metrics.registry,
            interval_s=max(core_cfg.profiler_interval_ms, 1.0) / 1000.0)
        mgr.profiler.start()
    # the fake cluster doubles as the warm pool's provisioner: with
    # ENABLE_SLICE_SCHEDULER the scheduler turns capacity up and down
    # through it
    rec = setup_core_controllers(mgr, core_cfg, metrics,
                                 provisioner=cluster)
    # the cluster plays the pods' checkpoint sidecars against the store
    # the reconciler opened: it answers final-snapshot requests and stamps
    # what a restored pod restored
    if rec.session is not None and cluster is not None:
        cluster.attach_session_store(rec.session)
    setup_culling(mgr, core_cfg, jupyter, metrics)
    setup_odh_controllers(mgr, odh_cfg)

    # TLS posture: resolve at startup, restart-on-change (odh main.go:178-214,
    # 324-340); in standalone mode the "restart" is a manager stop — the
    # supervising process (Deployment) brings it back with the new profile
    profile = fetch_apiserver_tls_profile(api)
    log = logging.getLogger("kubeflow_tpu_torch")
    log.info("TLS profile: %s (min %s)", profile.source, profile.min_version)

    def on_change(old, new) -> None:
        log.warning("TLS profile changed (%s -> %s); initiating graceful "
                    "restart", old.min_version, new.min_version)
        mgr.stop()

    SecurityProfileWatcher(api, profile, on_change=on_change).setup(mgr)
    return mgr, api, cluster, metrics


def build_sharded_fleet(
    core_cfg: Optional[CoreConfig] = None,
    count: Optional[int] = None,
    clock=None,
):
    """Active-active standalone control plane (SHARD_COUNT > 1): `count`
    ShardedReplicas over one in-memory ApiServer, each running the full
    core controller set against its fenced client (kube/shard.py), so a
    deposed shard's late writes are rejected with a stale epoch instead
    of racing the new owner.  Returns (fleet, api, cluster, metrics);
    per-shard health lands in /debug/fleet via metrics.attach_shard()."""
    core_cfg = core_cfg or CoreConfig.from_env()
    count = count or core_cfg.shard_count
    api = ApiServer(history_size=core_cfg.watch_history_size)
    cluster = FakeCluster(api)
    metrics = NotebookMetrics(api)
    # ONE lifecycle ledger + TSDB across every replica: a notebook's
    # attempts land on one timeline no matter which shard ran them, so a
    # manager-id change between consecutive attempts reads as
    # handoff/adoption wait (utils/lifecycle.py)
    ledger = LifecycleLedger(
        registry=metrics.registry,
        max_notebooks=core_cfg.lifecycle_max_notebooks,
        samples_per_stage=core_cfg.lifecycle_samples_per_stage,
        tolerance=core_cfg.lifecycle_tolerance)
    metrics.attach_lifecycle(ledger)
    tsdb = TimeSeriesStore(
        raw_capacity=core_cfg.tsdb_raw_capacity,
        tier10_capacity=core_cfg.tsdb_tier10_capacity,
        tier60_capacity=core_cfg.tsdb_tier60_capacity,
        max_series=core_cfg.tsdb_max_series)
    # clock=None falls back to the first replica manager's clock at feed
    # time (setup_core_controllers attaches it to `metrics`)
    metrics.attach_tsdb(tsdb, clock=clock)
    # ONE metering ledger across every replica (same sharing rationale as
    # the lifecycle ledger): tenant attribution survives shard handoffs
    metering = TenantMeteringLedger(
        clock, registry=metrics.registry,
        recorder=EventRecorder(api, "tenant-metering"),
        max_tenants=core_cfg.metering_max_tenants,
        max_notebooks=core_cfg.metering_max_notebooks,
        tolerance=core_cfg.metering_tolerance,
        fairshare_factor=core_cfg.tenant_fairshare_factor,
        top_k=core_cfg.tenant_top_k)
    metrics.attach_metering(metering)
    # ONE diagnosis engine across every replica (same sharing rationale):
    # change points and verdicts read the fleet-wide fused timeline
    diagnosis = DiagnosisEngine(
        clock, registry=metrics.registry, lifecycle=ledger,
        metering=metering, tsdb=tsdb, api=api)
    metrics.attach_diagnosis(diagnosis)

    def controllers(replica):
        # replica.manager.api is the FencedApi: every controller write is
        # epoch-checked against the committed shard map before it lands
        replica.manager.lifecycle = ledger
        replica.manager.manager_id = replica.shard_id
        replica.manager.tsdb = tsdb
        replica.manager.metering = metering
        replica.manager.diagnosis = diagnosis
        if metering.clock is None:
            # clock=None build: the first replica's manager clock drives
            # the accrual timestamps (same fallback as the TSDB feed)
            metering.clock = replica.manager.clock
        if diagnosis.clock is None:
            diagnosis.clock = replica.manager.clock
        if diagnosis.recorder is None:
            # the first replica's flight recorder anchors trace->object
            # resolution for alert annotation (each replica records its
            # own attempts; explain() still works per replica via the
            # shared ledger)
            diagnosis.recorder = replica.manager.flight_recorder
        setup_core_controllers(replica.manager, core_cfg, metrics,
                               provisioner=cluster)
        setup_culling(replica.manager, core_cfg, metrics=metrics)

    fleet = ShardedFleet(
        api, count=count, clock=clock, controller_factory=controllers,
        lease_duration_s=core_cfg.shard_lease_duration_s)
    metrics.attach_shard(fleet)
    # membership epochs feed the diagnosis engine's discrete timeline
    diagnosis.fleet = fleet
    return fleet, api, cluster, metrics


def build_real_backend(args):
    """KubeClient from --kubeconfig/--in-cluster with the qps/burst knobs
    (notebook-controller/main.go:71-89)."""
    from .kube.client import KubeClient, RestConfig

    if args.kubeconfig:
        cfg = RestConfig.from_kubeconfig(args.kubeconfig)
    else:
        cfg = RestConfig.in_cluster()
    cfg.qps = args.qps
    cfg.burst = args.burst
    return KubeClient(cfg)


def start_webhook_server(api, args):
    """Serve the collected AdmissionHooks over HTTPS (odh
    main.go:285-311).  Certs come from --cert-dir (tls.crt/tls.key, the
    serving-cert layout); without them a self-signed pair is minted, as
    envtest does.  Returns the running server, or None when there are no
    hooks or --webhook-port is negative."""
    hooks = getattr(api, "admission_hooks", None)
    if not hooks or args.webhook_port < 0:
        return None
    from .odh.webhook_server import AdmissionReviewServer

    cert = os.path.join(args.cert_dir, "tls.crt") if args.cert_dir else ""
    if cert and os.path.exists(cert):
        server = AdmissionReviewServer(
            hooks, cert_file=cert,
            key_file=os.path.join(args.cert_dir, "tls.key"),
            host="0.0.0.0", port=args.webhook_port)
    else:
        from .kube.certs import mint_serving_cert

        logging.warning("no serving certs in %r; minting a self-signed pair",
                        args.cert_dir)
        server = AdmissionReviewServer(
            hooks, bundle=mint_serving_cert(),
            host="0.0.0.0", port=args.webhook_port)
    server.start()
    logging.info("webhook server on %s", server.url)
    return server


def _demo(api: ApiServer, cluster: FakeCluster, accelerator: str,
          count: int) -> dict:
    """Create the demo GPU notebook on nodes sized to its gang, wait
    (wall clock, against the threaded manager) until it reads Healthy,
    play its workers' training loops (one telemetry summary per worker,
    a real TelemetryAgent's, for the /debug/fleet data-plane rollup) and
    return its status."""
    gpu = GPUSpec(accelerator, count)
    shape = gpu.validate()
    cluster.add_gpu_nodes(accelerator, shape.num_hosts, shape.gpus_per_host,
                          name_prefix="demo-gpu")
    api.create(KubeObject.from_dict(
        Notebook.new("demo", "default", gpu=gpu).obj))
    wall = Clock()
    deadline = wall.now() + 10
    while wall.now() < deadline:
        live = api.try_get("Notebook", "default", "demo")
        if live and live.body.get("status", {}).get("sliceHealth") \
                == "Healthy":
            break
        wall.sleep(0.05)
    status = api.get("Notebook", "default", "demo").body.get("status", {})
    from .models.configs import LLAMA2_350M

    cluster.stamp_worker_telemetry(
        "default", "demo", step_time_s=0.5, config=LLAMA2_350M, batch=8,
        seq_len=2048, num_chips=shape.gpus_per_host,
        accelerator=topology.ACCELERATORS[accelerator].device_name,
        now=wall.now())
    return status


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="GPU notebook controller")
    parser.add_argument("--metrics-addr", type=int, default=8080,
                        help="port for /metrics + health endpoints")
    parser.add_argument("--kubeconfig", default="",
                        help="path to a kubeconfig; reconcile that cluster")
    parser.add_argument("--in-cluster", action="store_true",
                        help="use the ServiceAccount token mount")
    parser.add_argument("--qps", type=float, default=0.0,
                        help="client-side request rate limit (0 = unlimited)")
    parser.add_argument("--burst", type=int, default=0,
                        help="client-side burst size")
    parser.add_argument("--webhook-port", type=int, default=9443,
                        help="admission webhook HTTPS port (0 = a free "
                             "one, -1 = disabled)")
    parser.add_argument("--cert-dir", default="",
                        help="dir with tls.crt/tls.key for the webhook server")
    parser.add_argument("--enable-leader-election", action="store_true",
                        help="gate reconciling on a coordination.k8s.io Lease")
    parser.add_argument("--watch-namespace", default="",
                        help="scope informers to one namespace instead of "
                             "cluster-wide list/watch")
    parser.add_argument("--leader-election-namespace", default="",
                        help="namespace for the election Lease")
    parser.add_argument("--demo", action="store_true",
                        help="create a sample GPU notebook and print its "
                             "status")
    parser.add_argument("--demo-accelerator", default="h100-80gb",
                        choices=sorted(topology.ACCELERATORS))
    parser.add_argument("--demo-count", type=int, default=8,
                        help="GPUs in the demo notebook's gang")
    parser.add_argument("--run-seconds", type=float, default=0.0,
                        help="exit after N seconds (0 = run forever)")
    parser.add_argument("--expose-state", action="store_true",
                        help="serve the /state object-store dump (includes "
                             "Secret data; loopback, standalone/debug only)")
    parser.add_argument("--serve-api", type=int, default=-1, metavar="PORT",
                        help="standalone mode: serve the in-memory store "
                             "over the Kubernetes REST wire protocol on "
                             "PORT (0 = ephemeral)")
    parser.add_argument("--fake-gpu-nodes", type=int, default=0,
                        metavar="N",
                        help="standalone mode: add N full H100 hosts "
                             "(GKE accelerator label + nvidia.com/gpu "
                             "allocatable, gpu/device_plugin.py) so GPU "
                             "workloads schedule")
    parser.add_argument("--audit-log", default="", metavar="PATH",
                        help="with --serve-api: append a JSONL request "
                             "trail (ts/verb/path/code)")
    parser.add_argument("--debug-log", action="store_true")
    parser.add_argument("--log-format", choices=("text", "json"),
                        default="text",
                        help="json: one JSON object a line with "
                             "trace_id/span_id correlation "
                             "(utils/logging.py)")
    args = parser.parse_args(argv)

    level = logging.DEBUG if args.debug_log else logging.INFO
    if args.log_format == "json":
        setup_structured_logging(level)
    else:
        logging.basicConfig(
            level=level,
            format="%(asctime)s %(name)s %(levelname)s %(message)s",
        )
    real = bool(args.kubeconfig or args.in_cluster)
    backend = build_real_backend(args) if real else None
    mgr, api, cluster, metrics = build_manager(api=backend)
    if cluster is not None:
        cluster.add_node("cpu-node",
                         allocatable={"cpu": "64", "memory": "256Gi"})
        if args.fake_gpu_nodes > 0:
            acc = topology.ACCELERATORS["h100-80gb"]
            cluster.add_gpu_nodes(acc.name, args.fake_gpu_nodes,
                                  acc.gpus_per_host, name_prefix="fake-gpu")
    if args.expose_state and real:
        logging.warning("--expose-state ignored with a real cluster backend "
                        "(the KubeClient has no store to dump; /state "
                        "stays 404)")
    # the elector is built before the HTTP server so /readyz can gate on
    # leadership (a follower is alive but not ready); it starts later
    elector: Optional[LeaderElector] = None
    if args.enable_leader_election:
        elector = LeaderElector(
            api,
            lease_name="kubeflow-tpu-notebook-controller",
            namespace=args.leader_election_namespace
            or OdhConfig.from_env().controller_namespace,
            identity=f"{socket.gethostname()}-{os.getpid()}",
        )
    server = serve_http(args.metrics_addr, mgr, metrics,
                        expose_state=args.expose_state and not real,
                        elector=elector)
    webhook_server = start_webhook_server(api, args) if real else None
    wire_server = None
    if args.serve_api >= 0 and real:
        logging.warning("--serve-api ignored with a real cluster backend "
                        "(there is no in-memory store to serve)")
    if args.serve_api >= 0 and not real:
        from .api.types import convert_notebook_dict
        from .deploy.manifests import notebook_crd
        from .kube.wire import KubeApiWireServer

        # the Notebook CRD object, so /openapi serves its field models
        # (the wire server reads field schemas off stored CRDs, as a real
        # apiserver does)
        if api.try_get("CustomResourceDefinition", "",
                       "notebooks.kubeflow.org") is None:
            api.create(KubeObject.from_dict(
                notebook_crd(conversion_webhook=False)))
        wire_server = KubeApiWireServer(
            api, host="127.0.0.1", port=args.serve_api,
            converter=convert_notebook_dict,
            audit_log=args.audit_log or None).start()
        logging.info("wire apiserver on %s", wire_server.url)
        print(f"WIRE_API={wire_server.url}", flush=True)

    def start_reconciling():
        if real:
            api.start_informers(mgr.watched_kinds(),
                                namespace=args.watch_namespace or None)
        mgr.start()
        logging.info("manager started; metrics on :%d",
                     server.server_address[1])

    if elector is not None:
        elector.start_background(
            on_started=start_reconciling,
            on_stopped=mgr.stop,  # lost lease -> exit 1 -> pod restart
        )
        logging.info("leader election enabled; waiting for lease")
    else:
        start_reconciling()
    if args.demo and cluster is not None:
        status = _demo(api, cluster, args.demo_accelerator, args.demo_count)
        print(json.dumps(status, indent=2), flush=True)

    exit_code = 0
    try:
        # exits when run_seconds elapses OR the manager stops itself (a
        # TLS-profile change, a lost lease): a non-zero exit makes the
        # Deployment restart the pod
        timeout = args.run_seconds if args.run_seconds > 0 else None
        stopped = mgr.wait_until_stopped(timeout)
        if stopped and timeout is None:
            logging.warning("manager stopped itself; exiting for restart")
            exit_code = 1
    except KeyboardInterrupt:
        pass
    finally:
        if elector is not None:
            elector.stop()
        if mgr.profiler is not None:
            mgr.profiler.stop()
        mgr.stop()
        if wire_server is not None:
            wire_server.stop()
        if webhook_server is not None:
            webhook_server.stop()
        if real:
            api.stop_informers()
        server.shutdown()
        server.server_close()
    return exit_code


if __name__ == "__main__":
    raise SystemExit(main())
