"""What a run of one cell reports, found by name.

`BENCHMARK.json` at the checkout's root lists the cells and the metrics;
`cells/<name>.json` says which runner drives the cell and its limits;
each metric is read by `metrics/<name>.py`, a module with
`read(run) -> float | None`.  A metric goes into a cell's line when its
`workloads` name the cell or, without that key, when the cell reports the
end-to-end metric it `moves`.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

from .shapes import ROOT, load_json

BENCHMARK = ROOT.parent / "BENCHMARK.json"


def benchmark(path: Path = BENCHMARK) -> dict:
    return load_json(path)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"benchmark: no workload {name!r} in BENCHMARK.json")


# The keys a cell file may hold: each is read by the run or its runner.
CELL_KEYS = {"runner", "limits", "check_steps", "check_rows",
             "trace_seconds"}


def cell(name: str) -> dict:
    setting = load_json(ROOT / "cells" / f"{name}.json")
    unread = sorted(set(setting) - CELL_KEYS)
    if unread:
        raise ValueError(f"cell {name}: no run reads {unread}")
    return setting


def _applies(metric: dict, name: str, reported: set) -> bool:
    if "workloads" in metric:
        return name in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def metrics_for(bench: dict, name: str, traced: bool) -> list:
    """The metric entries a run of cell `name` reports: its end-to-end
    metrics, or with a trace its per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    if not traced:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if _applies(m, name, reported)]


def reader(name: str):
    """The `read` function of metrics/<name>.py."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def runner(kind: str):
    """The runner module `runners/<kind>.py`."""
    return importlib.import_module(f"benchmark.runners.{kind}")


__all__ = ["BENCHMARK", "CELL_KEYS", "benchmark", "cell", "metrics_for",
           "reader", "runner", "workload"]
