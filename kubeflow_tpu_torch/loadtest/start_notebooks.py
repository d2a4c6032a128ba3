"""Load test: spawn N notebooks, measure notebook-to-ready latency.

The port of the reference's loadtest/start_notebooks.py.  It drives the
port's standalone stack and reports the north-star metric:
notebook-to-ready latency (p50/p95/max), for CPU notebooks and GPU gangs.

    python -m kubeflow_tpu_torch.loadtest.start_notebooks -l 50 \
        --gpu h100-80gb:16

`--wire` routes everything through the real-cluster backend instead of
the in-memory store: the ApiServer is served over the k8s wire protocol
and both the controllers (KubeClient + informers) and the load generator
talk to it over sockets — end-to-end latency including the REST/watch
round trips.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

from ..api.types import Notebook
from ..kube import KubeObject
from ..main import build_manager
from .convergence import parse_gpu


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("-l", "--count", type=int, default=3,
                        help="number of notebooks (reference default 3)")
    parser.add_argument("--namespace", default="loadtest")
    parser.add_argument("--gpu", default="",
                        help="accelerator:count, e.g. h100-80gb:16 "
                        "(default CPU)")
    parser.add_argument("--timeout", type=float, default=30.0)
    parser.add_argument("--wire", action="store_true",
                        help="drive through the wire-protocol backend "
                        "(real sockets + informers) instead of in-memory")
    args = parser.parse_args(argv)
    gpu = parse_gpu(args.gpu) if args.gpu else None

    srv = client = None
    if args.wire:
        from ..kube import ApiServer, FakeCluster
        from ..kube.client import KubeClient, RestConfig
        from ..kube.wire import KubeApiWireServer

        store = ApiServer()
        cluster = FakeCluster(store)
        srv = KubeApiWireServer(store).start()
        client = KubeClient(RestConfig(server=srv.url))
        mgr, api, _, _ = build_manager(api=client)
        client.start_informers(mgr.watched_kinds())
    else:
        mgr, api, cluster, _ = build_manager()
    cluster.add_node("cpu-node", allocatable={"cpu": "512", "memory": "2048Gi"})
    expected = 1
    if gpu is not None:
        shape = gpu.validate()
        cluster.add_gpu_nodes(gpu.accelerator, shape.num_hosts * args.count,
                              shape.gpus_per_host)
        expected = shape.num_hosts
    mgr.start()

    latencies: list[float] = []
    try:
        t_start = time.perf_counter()
        for i in range(args.count):
            name = f"loadtest-nb-{i}"
            t0 = time.perf_counter()
            api.create(KubeObject.from_dict(
                Notebook.new(name, args.namespace, gpu=gpu).obj))
            deadline = t0 + args.timeout
            while time.perf_counter() < deadline:
                live = api.try_get("Notebook", args.namespace, name)
                status = (live.body.get("status") or {}) if live else {}
                if status.get("readyReplicas") == expected:
                    latencies.append(time.perf_counter() - t0)
                    break
                time.sleep(0.01)
            else:
                print(f"TIMEOUT waiting for {name}", file=sys.stderr)
                return 1
        total = time.perf_counter() - t_start
    finally:
        mgr.stop()
        if mgr.profiler is not None:
            mgr.profiler.stop()
        if client is not None:
            client.stop_informers()
        if srv is not None:
            srv.stop()

    latencies.sort()
    print(json.dumps({
        "notebooks": args.count,
        "backend": "wire" if args.wire else "in-memory",
        "gpu": args.gpu or "cpu",
        "total_s": round(total, 3),
        "ready_latency_p50_s": round(statistics.median(latencies), 4),
        "ready_latency_p95_s": round(
            latencies[max(0, int(len(latencies) * 0.95) - 1)], 4),
        "ready_latency_max_s": round(latencies[-1], 4),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
