"""One-shot diagnostics bundle: `python -m kubeflow_tpu_torch.ops.diagnose`,
the port's copy of kubeflow_tpu/ops/diagnose.py.  It imports no torch.

An operator paged about a degraded fleet needs everything at once —
metrics, firing alerts, the flight recorder's retained attempts WITH
their span trees, the workqueue state, the live profile, and the config
the manager is actually running — in one artifact that can be attached
to an incident and analyzed offline, long after the pod restarted.

Two collection modes:

  - **HTTP** (the CLI default): walk the manager's loopback debug
    surface (`/metrics`, `/debug/{fleet,alerts,reconciles,workqueue,
    profile,criticalpath,tenants,timeline}`), then resolve the span trees
    of
    every retained slowest/
    errored attempt via `/debug/traces/<id>` — so the bundle can
    reconstruct, offline, exactly the attempts an operator gets paged
    about.  Run it where the manager runs (`kubectl exec`), like every
    other loopback debug consumer.
  - **in-process** (`collect_local`): the same bundle straight off live
    Manager/NotebookMetrics objects — one per replica of a sharded
    fleet, with no HTTP server in the loop.

Config capture is REDACTED: only recognized configuration variables are
included, and any name that smells like a credential has its value
masked — the bundle is made to be shared.

A third, offline mode — `--merge a.json b.json c.json` — takes one
bundle per manager replica of a sharded fleet and sweeps the COMBINED
attempt histories for same-key reconciles with overlapping real-time
windows: the cross-process double-reconcile audit that no single
replica's recorder can run alone.  It also folds each bundle's TSDB
timeline into one merged per-series curve (timestamp-sorted, tagged
with its source replica) and runs the offline change-point sweep over
the fused curves — fleet-wide level shifts that no single replica's
capture can see (pass --out to write the merged artifact).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import urllib.error
import urllib.request
from typing import Mapping, Optional

from ..utils.clock import Clock

BUNDLE_FORMAT = 1

# environment prefixes that are configuration surface (utils/config.py +
# the observability/tracing knobs): the reference's, and GPU_ for the
# port's GPU_DEFAULT_IMAGE and GPU image map; everything else stays out of
# the bundle entirely
CONFIG_PREFIXES = (
    "SLO_", "WORKQUEUE_", "RECOVERY_", "CHECKPOINT_", "WARMPOOL_",
    "CULL", "ENABLE_", "TRACE_", "OTEL_", "PROFILER_", "WATCH_",
    "INVARIANTS_", "K8S_", "IDLENESS_", "CLUSTER_DOMAIN", "USE_ISTIO",
    "ISTIO_", "ADD_FSGROUP", "DEV", "SET_PIPELINE_", "GATEWAY_",
    "NOTEBOOK_GATEWAY_", "MLFLOW_", "INJECT_", "TPU_", "GPU_", "KUBE_",
    "DATAPLANE_", "TELEMETRY_", "LIFECYCLE_", "TSDB_", "METERING_",
    "TENANT_", "METRICS_",
)
_SECRET_RE = re.compile(r"TOKEN|SECRET|PASSWORD|PASSWD|CREDENTIAL|APIKEY"
                        r"|API_KEY|PRIVATE|CERT", re.IGNORECASE)
REDACTED = "**redacted**"


def redacted_config(env: Optional[Mapping[str, str]] = None) -> dict:
    """The recognized config surface of `env` (default: this process —
    under `kubectl exec` that IS the manager's environment), with
    credential-shaped names masked."""
    env = env if env is not None else os.environ
    out = {}
    for key in sorted(env):
        if not any(key.startswith(p) for p in CONFIG_PREFIXES):
            continue
        out[key] = REDACTED if _SECRET_RE.search(key) else env[key]
    return out


def _trace_ids(reconciles: dict) -> list[str]:
    """Trace ids of the retained slowest + errored attempts — the ones a
    bundle must make reconstructable offline."""
    ids: list[str] = []
    for section in ("slowest", "errored"):
        for a in reconciles.get(section, ()):
            tid = a.get("trace_id")
            if tid and tid not in ids:
                ids.append(tid)
    return ids


def collect_local(manager, metrics=None, env: Optional[Mapping[str, str]]
                  = None) -> dict:
    """Assemble the bundle from in-process objects (no HTTP).  `manager`
    is a kube.Manager; `metrics` a core.metrics.NotebookMetrics (scraped
    for the exposition + fleet rollup when given)."""
    engine = getattr(manager, "slo_engine", None)
    profiler = getattr(manager, "profiler", None)
    aggregator = getattr(manager, "telemetry_aggregator", None)
    ledger = getattr(manager, "lifecycle", None)
    metering = getattr(manager, "metering", None)
    tsdb = getattr(manager, "tsdb", None)
    diagnosis = getattr(manager, "diagnosis", None)
    reconciles = manager.flight_recorder.snapshot()
    traces = {}
    for tid in _trace_ids(reconciles):
        trace = manager.flight_recorder.trace(tid)
        if trace is not None:
            traces[tid] = trace
    return {
        "bundle_format": BUNDLE_FORMAT,
        "captured_at": manager.clock.now(),
        "source": "in-process",
        "metrics": (metrics.scrape() if metrics is not None
                    else manager.metrics_registry.render()),
        "fleet": (metrics.fleet_snapshot() if metrics is not None
                  else None),
        # firing alerts annotated with the diagnosis engine's one-line
        # verdict per exemplar (same body /debug/alerts serves)
        "alerts": ((diagnosis.annotate_alerts(engine.snapshot())
                    if diagnosis is not None else engine.snapshot())
                   if engine is not None else None),
        "slo_verdicts": engine.verdicts() if engine is not None else None,
        "reconciles": reconciles,
        "traces": traces,
        "workqueue": manager.workqueue_debug(),
        "profile": (profiler.snapshot() if profiler is not None
                    else {"enabled": False}),
        "telemetry": (aggregator.snapshot() if aggregator is not None
                      else None),
        "criticalpath": (ledger.snapshot() if ledger is not None
                         else None),
        # per-tenant usage + the noisy-neighbor verdict: who used the
        # chips/control plane and who was flagged, offline
        "tenants": (metering.snapshot() if metering is not None
                    else None),
        # full multi-tier dump, not just the inventory: the bundle is
        # what reconstructs a loadtest's p99-vs-time curve offline
        "timeline": tsdb.dump() if tsdb is not None else None,
        # change-point findings + per-object causal verdicts: both halves
        # of the diagnosis engine reconstruct offline (and
        # changepoints_from_bundle re-runs the detector over `timeline`)
        "diagnosis": diagnosis.export() if diagnosis is not None else None,
        "config": redacted_config(env),
    }


def _get(base: str, path: str, timeout: float) -> tuple[int, str]:
    req = urllib.request.Request(base + path)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def collect_http(addr: str, timeout: float = 10.0) -> dict:
    """Assemble the bundle over the manager's loopback debug surface."""
    base = addr.rstrip("/")
    if not base.startswith("http"):
        base = "http://" + base

    def get_json(path: str):
        code, body = _get(base, path, timeout)
        if code != 200:
            return {"error": f"GET {path} -> {code}"}
        return json.loads(body)

    code, metrics_text = _get(base, "/metrics", timeout)
    if code != 200:
        metrics_text = f"# GET /metrics -> {code}"
    fleet = get_json("/debug/fleet")
    reconciles = get_json("/debug/reconciles")
    traces = {}
    for tid in _trace_ids(reconciles):
        trace = get_json(f"/debug/traces/{tid}")
        if "error" not in trace:
            traces[tid] = trace
    alerts = get_json("/debug/alerts")
    # mirror collect_local's diagnosis export: the change-point snapshot
    # plus one causal verdict per recorded object (bounded)
    diagnosis = get_json("/debug/changepoints")
    if isinstance(diagnosis, dict) and "error" not in diagnosis:
        explanations = {}
        objects = (reconciles.get("objects") or {}
                   if isinstance(reconciles, dict) else {})
        for key in sorted(objects)[:64]:
            verdict = get_json(f"/debug/explain?object={key}")
            if isinstance(verdict, dict):
                explanations[key] = verdict
        diagnosis["explanations"] = explanations
    return {
        "bundle_format": BUNDLE_FORMAT,
        "captured_at": Clock().now(),
        "source": base,
        "metrics": metrics_text,
        "fleet": fleet,
        "alerts": alerts,
        "slo_verdicts": None,  # verdicts need an engine; alerts carry
        # the per-objective stats over HTTP
        "reconciles": reconciles,
        "traces": traces,
        "workqueue": get_json("/debug/workqueue"),
        "profile": get_json("/debug/profile"),
        # the fleet rollup's data-plane section, lifted to the same
        # top-level key collect_local uses so offline consumers need one
        # lookup path for worker telemetry
        "telemetry": (fleet.get("dataplane")
                      if isinstance(fleet, dict) else None),
        "criticalpath": get_json("/debug/criticalpath"),
        "tenants": get_json("/debug/tenants"),
        "timeline": get_json("/debug/timeline?dump=1"),
        "diagnosis": diagnosis,
        "config": redacted_config(),
    }


def merge_records(bundles) -> list:
    """Every recorded attempt across several managers' bundles, deduped
    by span id (an attempt retained in both the ring and a slowest/
    errored set must count once).  The input of the offline
    cross-process double-reconcile sweep."""
    from ..utils.flightrecorder import record_from_dict

    records, seen = [], set()
    for bundle in bundles:
        reconciles = bundle.get("reconciles") or {}
        for section in ("attempts", "slowest", "errored"):
            for d in reconciles.get(section) or ():
                key = d.get("span_id") or (
                    d.get("trace_id"), d.get("object"), d.get("attempt"),
                    d.get("mono_start"))
                if key in seen:
                    continue
                seen.add(key)
                records.append(record_from_dict(d))
    return records


def merge_overlaps(bundles) -> list:
    """Cross-process serialization audit: pairs of attempts for the same
    (controller, object) whose real-time windows overlap, swept over the
    MERGED attempt histories of several managers' bundles.  In a sharded
    fleet each replica records only its own attempts; an overlap that
    only exists across bundles is exactly a cross-process
    double-reconcile — the thing the shard map's fencing must prevent."""
    from ..utils.flightrecorder import sweep_overlaps

    return sweep_overlaps(merge_records(bundles))


def merge_timelines(bundles) -> dict:
    """Fold each bundle's TSDB capture into one merged per-series curve
    (timestamp-sorted, per-replica source tag) so sharded-fleet
    change-point analysis works offline across per-replica bundles."""
    from ..utils.diagnosis import merge_timelines as _merge

    return _merge(bundles)


def merge_changepoints(merged: dict, bundles) -> list:
    """Offline change-point sweep over the merged curves, correlated
    against the union of the bundles' discrete event timelines."""
    from ..utils.diagnosis import (correlate_events, detect_level_shifts,
                                   matched_kind, watched_series)

    events = []
    for bundle in bundles:
        events.extend((bundle.get("diagnosis") or {}).get("timeline") or ())
    events.sort(key=lambda e: e.get("t", 0.0))
    out = []
    for name, points in merged.get("series", {}).items():
        if not watched_series(name):
            continue
        for hit in detect_level_shifts([(p["t"], p["v"]) for p in points]):
            matched = correlate_events(events, hit["t_start"], hit["t_end"])
            hit.update({"series": name, "matched": matched_kind(matched),
                        "events": matched[-8:]})
            out.append(hit)
    return out


def summarize_merge(bundles, records, overlaps, merged=None,
                    changepoints=None) -> str:
    lines = [
        f"merged {len(bundles)} bundles: {len(records)} distinct attempts, "
        f"{len(overlaps)} overlapping pairs"
    ]
    for prev, cur in overlaps:
        lines.append(
            f"  OVERLAP {cur.controller} {cur.object_key}: "
            f"[{prev.mono_start:.6f}, {prev.mono_end:.6f}] vs "
            f"[{cur.mono_start:.6f}, {cur.mono_end:.6f}]")
    if merged is not None:
        lines.append(
            f"  timeline: {len(merged['series'])} merged series, "
            f"{merged['points_total']} points from "
            f"{len(merged['sources'])} sources")
    for cp in changepoints or ():
        lines.append(
            f"  CHANGEPOINT {cp['series']} {cp['direction']} "
            f"{cp['baseline']:.3g}->{cp['level']:.3g} at "
            f"t={cp['t_start']:.1f} (matched={cp['matched']})")
    return "\n".join(lines)


def summarize(bundle: dict) -> str:
    """One human line per bundle — printed by the CLI so the operator
    sees what they captured."""
    reconciles = bundle.get("reconciles") or {}
    alerts = bundle.get("alerts") or {}
    profile = bundle.get("profile") or {}
    fleet = bundle.get("fleet") or {}
    firing = alerts.get("firing")
    return (
        f"bundle: {reconciles.get('recorded_total', 0)} attempts recorded, "
        f"{len(reconciles.get('slowest') or ())} slowest + "
        f"{len(reconciles.get('errored') or ())} errored retained, "
        f"{len(bundle.get('traces') or {})} traces resolved, "
        f"{len(firing) if firing is not None else 0} alerts firing, "
        f"{profile.get('samples_total', 0)} profile samples, "
        f"{fleet.get('notebooks', 0)} notebooks in the fleet rollup"
    )


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubeflow_tpu_torch.ops.diagnose",
        description="capture a one-shot diagnostics bundle from a running "
                    "manager's loopback debug surface")
    parser.add_argument("--addr", default="http://127.0.0.1:8080",
                        help="manager health/metrics address "
                             "(default %(default)s; loopback-only surface "
                             "— run this where the manager runs)")
    parser.add_argument("--out", default="bundle.json",
                        help="bundle output path (default %(default)s)")
    parser.add_argument("--timeout", type=float, default=10.0)
    parser.add_argument("--merge", nargs="+", metavar="BUNDLE",
                        help="offline mode: merge several managers' "
                             "bundles and sweep the combined attempt "
                             "histories for cross-process overlapping "
                             "reconciles (exit 1 when any pair overlaps)")
    args = parser.parse_args(argv)

    if args.merge:
        bundles = []
        for path in args.merge:
            try:
                with open(path) as f:
                    bundles.append(json.load(f))
            except (OSError, ValueError) as err:
                print(f"diagnose: cannot load {path}: {err}",
                      file=sys.stderr)
                return 1
        records = merge_records(bundles)
        overlaps = merge_overlaps(bundles)
        merged = merge_timelines(bundles)
        changepoints = merge_changepoints(merged, bundles)
        print(summarize_merge(bundles, records, overlaps, merged,
                              changepoints))
        if args.out != parser.get_default("out"):
            # an explicit --out in merge mode writes the merged artifact:
            # the fused per-series curves + the offline change-point sweep
            with open(args.out, "w") as f:
                json.dump({"merged_timeline": merged,
                           "changepoints": changepoints,
                           "bundles": len(bundles),
                           "overlaps": len(overlaps)},
                          f, indent=2, sort_keys=True, default=str)
                f.write("\n")
            print(f"wrote {args.out}")
        return 1 if overlaps else 0

    try:
        bundle = collect_http(args.addr, timeout=args.timeout)
    except (OSError, urllib.error.URLError) as err:
        print(f"diagnose: cannot reach {args.addr}: {err}", file=sys.stderr)
        return 1
    with open(args.out, "w") as f:
        json.dump(bundle, f, indent=2, sort_keys=True, default=str)
        f.write("\n")
    print(summarize(bundle))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())


__all__ = ["BUNDLE_FORMAT", "CONFIG_PREFIXES", "REDACTED", "collect_http",
           "collect_local", "main", "merge_changepoints", "merge_overlaps",
           "merge_records", "merge_timelines", "redacted_config",
           "summarize", "summarize_merge"]
