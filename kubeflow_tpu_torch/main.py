"""Manager entrypoint: `python -m kubeflow_tpu_torch.main`.

The port of kubeflow_tpu/main.py's standalone path: one manager running
the notebook controller, the event re-emitter and (with ENABLE_CULLING)
the culler against the in-memory API server and the fake data plane, with
the health/readiness/metrics HTTP side real.  Env vars are the config
surface (utils/config.py), under the reference's names.

`--demo` creates a sample GPU notebook (`spec.gpu {--demo-accelerator,
--demo-count}`) on fake GPU nodes sized to its gang and prints its status
once it reads Healthy: the twin of `python -m kubeflow_tpu.main --demo`.

Not ported yet (`ROADMAP.md` queue 1 item 17): the real-cluster backend
(`--kubeconfig`, `--in-cluster`), leader election, the sharded fleet, the
webhook server, `--serve-api` (and with it the twin of
`--fake-tpu-nodes`, whose nodes only a CR from the API could use),
`--audit-log`, and the /debug and /state surfaces with the SLO,
diagnosis, lifecycle, metering and profiler engines behind them.
"""

from __future__ import annotations

import argparse
import http.server
import json
import logging
import threading
import urllib.parse
from typing import Optional

from .api.types import GPUSpec, Notebook
from .core.culling_controller import setup_culling
from .core.metrics import NotebookMetrics
from .core.notebook_controller import setup_core_controllers
from .gpu import topology
from .kube import ApiServer, FakeCluster, KubeObject, Manager
from .utils.clock import Clock
from .utils.config import CoreConfig

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
    """Probe + scrape surface (main.go:125-133, metrics on :8080):

    - /healthz — liveness: process up and the manager not stopped;
    - /readyz — readiness: the manager started and its caches synced;
    - /metrics — OpenMetrics when the scraper asks for it, Prometheus
      text 0.0.4 otherwise."""

    manager: Optional[Manager] = None
    metrics: Optional[NotebookMetrics] = None

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
        return ""

    def do_GET(self):  # noqa: N802  (stdlib API)
        path = urllib.parse.urlsplit(self.path).path
        if path == "/healthz":
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
            # scrape() recomputes the census gauges and folds in the
            # manager's reconcile/workqueue registry
            openmetrics = negotiate_metrics_format(
                self.headers.get("Accept", ""))
            if self.metrics is not None:
                body = self.metrics.scrape(openmetrics=openmetrics)
            else:
                body = "# EOF\n" if openmetrics else ""
            self._respond(200, body,
                          OPENMETRICS_CONTENT_TYPE if openmetrics
                          else PROMETHEUS_CONTENT_TYPE)
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


def serve_http(port: int, manager: Manager, metrics: NotebookMetrics):
    """Health + metrics on all interfaces (the kubelet probes the pod IP
    and Prometheus scrapes :8080).  Returns the running server (port 0
    picks a free one: `server.server_address[1]`)."""
    handler = type(
        "Handler",
        (HealthAndMetricsHandler,),
        {"manager": manager, "metrics": metrics},
    )
    server = http.server.ThreadingHTTPServer(("0.0.0.0", port), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def build_manager(
    core_cfg: Optional[CoreConfig] = None,
    clock: Optional[Clock] = None,
    jupyter=None,
):
    """Wire the standalone stack; returns (manager, api, cluster, metrics).

    `clock` (a FakeClock in tests and in the card's smoke run) drives the
    manager and every controller; `jupyter` is the culler's activity
    probe (`core.jupyter.FakeJupyterState` standalone; by default the
    HTTP client of the reference)."""
    core_cfg = core_cfg or CoreConfig.from_env()
    api = ApiServer(history_size=core_cfg.watch_history_size)
    cluster = FakeCluster(api)
    mgr = Manager(api, clock=clock)
    metrics = NotebookMetrics(api, manager=mgr)
    setup_core_controllers(mgr, core_cfg, metrics)
    setup_culling(mgr, core_cfg, jupyter, metrics)
    return mgr, api, cluster, metrics


def _demo(api: ApiServer, cluster: FakeCluster, accelerator: str,
          count: int) -> dict:
    """Create the demo GPU notebook on nodes sized to its gang, wait
    (wall clock, against the threaded manager) until it reads Healthy,
    and return its status."""
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
    return api.get("Notebook", "default", "demo").body.get("status", {})


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="GPU notebook controller (standalone)")
    parser.add_argument("--metrics-addr", type=int, default=8080,
                        help="port for /metrics + health endpoints")
    parser.add_argument("--demo", action="store_true",
                        help="create a sample GPU notebook and print its "
                             "status")
    parser.add_argument("--demo-accelerator", default="h100-80gb",
                        choices=sorted(topology.ACCELERATORS))
    parser.add_argument("--demo-count", type=int, default=8,
                        help="GPUs in the demo notebook's gang")
    parser.add_argument("--run-seconds", type=float, default=0.0,
                        help="exit after N seconds (0 = run forever)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    mgr, api, cluster, metrics = build_manager()
    cluster.add_node("cpu-node",
                     allocatable={"cpu": "64", "memory": "256Gi"})
    server = serve_http(args.metrics_addr, mgr, metrics)
    mgr.start()
    logging.info("manager started; metrics on :%d",
                 server.server_address[1])
    if args.demo:
        status = _demo(api, cluster, args.demo_accelerator, args.demo_count)
        print(json.dumps(status, indent=2), flush=True)

    exit_code = 0
    try:
        timeout = args.run_seconds if args.run_seconds > 0 else None
        stopped = mgr.wait_until_stopped(timeout)
        if stopped and timeout is None:
            logging.warning("manager stopped itself; exiting for restart")
            exit_code = 1
    except KeyboardInterrupt:
        pass
    finally:
        mgr.stop()
        server.shutdown()
        server.server_close()
    return exit_code


if __name__ == "__main__":
    raise SystemExit(main())
