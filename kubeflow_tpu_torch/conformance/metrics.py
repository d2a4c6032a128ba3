"""Metric-family inventory gate: the port's twin of the reference's
ci/metrics_drift_check.sh.

Boots the port's standalone manager (`--metrics-addr` on a free port,
`--webhook-port -1`), scrapes `/metrics`, and diffs the metric-family
inventory (name + type, from the `# TYPE` exposition lines, plus the
data-plane families of the runtime's step metrics) against the committed
golden list (metrics_families.golden beside this file).  A rename,
removal, or type change of any family fails here instead of silently
breaking dashboards and recording rules downstream.

    python -m kubeflow_tpu_torch.conformance.metrics [--update]
"""

from __future__ import annotations

import argparse
import difflib
import time
import urllib.request
from pathlib import Path

from .manager import ManagerProcess, free_port

GOLDEN = Path(__file__).resolve().parent / "metrics_families.golden"


def scrape(port: int, timeout: float = 30.0) -> str:
    """The first /metrics body that carries a `# TYPE` line."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=2).read().decode()
            if "# TYPE" in body:
                return body
        except OSError:
            pass
        if time.monotonic() > deadline:
            raise RuntimeError("manager never served /metrics")
        time.sleep(0.25)


def families_of(exposition: str) -> list[str]:
    """`name type` of every `# TYPE` line."""
    return [" ".join(line.split()[2:4]) for line in exposition.splitlines()
            if line.startswith("# TYPE ")]


def step_families() -> list[str]:
    """The data-plane families of the runtime's StepTimer registry
    (runtime/metrics.py imports no torch)."""
    from ..runtime.metrics import register_step_metrics
    from ..utils.metrics import Registry

    reg = Registry()
    register_step_metrics(reg)
    return [f"{name} {kind}" for name, kind in reg.families()]


def inventory() -> list[str]:
    """The manager's live families and the step metrics', sorted."""
    port = free_port()
    with ManagerProcess(["--metrics-addr", str(port), "--webhook-port",
                         "-1", "--run-seconds", "30"]):
        body = scrape(port)
    return sorted(families_of(body) + step_families())


def check(update: bool = False) -> int:
    lines = inventory()
    text = "\n".join(lines) + "\n"
    if update:
        GOLDEN.write_text(text)
        print(f"updated {GOLDEN.name} ({len(lines)} families)")
        return 0
    if not GOLDEN.exists():
        print(f"missing {GOLDEN.name}: bootstrap with --update")
        return 1
    golden = GOLDEN.read_text()
    if golden != text:
        for line in difflib.unified_diff(
                golden.splitlines(), lines, fromfile=GOLDEN.name,
                tofile="scraped", lineterm=""):
            print(line)
        print(f"metric-family inventory drifted from {GOLDEN.name}; if "
              "intentional, refresh it with --update")
        return 1
    print(f"metrics drift check OK ({len(lines)} families)")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--update", action="store_true",
                        help="regenerate the golden family list")
    return check(parser.parse_args(argv).update)


if __name__ == "__main__":
    raise SystemExit(main())
