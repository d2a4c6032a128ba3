"""Notebook conformance profile of the port — the twin of the reference's
conformance/run.sh, in Python because the port is a package.

    python -m kubeflow_tpu_torch.conformance [--skip-fixtures]

  1. rendered-object goldens (`goldens`): the port's render of the
     canonical workbenches against its committed goldens;
  2. the apiserver wire-protocol fixtures (`kube.fixtures`), unless
     --skip-fixtures, replayed against a wire server over a store no
     controller writes: a transcript captures resourceVersions, and
     against a live manager the controller's own status write to the
     fixture's Notebook can land between two of its steps and turn the
     next write into a 409 (the reference's run.sh, which replays them
     against its manager, fails so now and then);
  3. boots `USE_ISTIO=true python -m kubeflow_tpu_torch.main --serve-api 0
     --metrics-addr 0 --fake-gpu-nodes 4` and reads the wire apiserver's
     URL off its `WIRE_API=` line (the fake GPU nodes let the gang
     schedule, so the runner can assert node binding);
  4. runs the black-box behaviour runner (`behavior`) against it with
     --expect-scheduled --istio.

It kills the manager on every path and exits non-zero on any failure.
The last line of its output is one JSON object: each part's verdict and
the seconds the whole profile took.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time

from . import behavior, goldens
from .manager import ManagerProcess

MANAGER_ARGS = ["--serve-api", "0", "--metrics-addr", "0",
                "--fake-gpu-nodes", "4"]


def _terminate(signum, frame):
    # a SIGTERM unwinds through the `with` that owns the manager
    raise SystemExit(128 + signum)


def run_fixtures() -> bool:
    """Every fixture against a fresh wire server; True when all pass."""
    from ..kube import ApiServer
    from ..kube.fixtures import FixtureFailure, FixtureRunner, load_fixtures
    from ..kube.wire import KubeApiWireServer

    srv = KubeApiWireServer(ApiServer()).start()
    ok = True
    try:
        runner = FixtureRunner(srv.url)
        for fixture in load_fixtures():
            try:
                runner.run(fixture)
                print(f"PASS {fixture['name']}")
            except FixtureFailure as err:
                print(f"FAIL {fixture['name']}: {err}")
                ok = False
    finally:
        srv.stop()
    return ok


def run_profile(fixtures: bool = True) -> dict:
    """Every part in order; a dict of verdicts with `ok` set when all
    passed.  A failing part is recorded and the profile stops there."""
    t0 = time.perf_counter()
    out: dict = {"goldens": goldens.check() == 0, "fixtures": None,
                 "behavior": [], "ok": False}
    if out["goldens"] and fixtures:
        out["fixtures"] = run_fixtures()
    if out["goldens"] and out["fixtures"] is not False:
        with ManagerProcess(MANAGER_ARGS, env={"USE_ISTIO": "true"}) as mgr:
            url = mgr.wait_for("WIRE_API=")
            print(f"== manager's wire apiserver at {url} ==", flush=True)
            try:
                out["behavior"] = behavior.run(
                    url, expect_scheduled=True, istio=True)
            except AssertionError as err:
                print(f"CONFORMANCE FAIL: {err}")
                out["behavior_failure"] = str(err)
            else:
                out["ok"] = True
    out["seconds"] = round(time.perf_counter() - t0, 3)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--skip-fixtures", action="store_true",
                        help="leave out the apiserver wire fixtures")
    args = parser.parse_args(argv)
    signal.signal(signal.SIGTERM, _terminate)
    result = run_profile(fixtures=not args.skip_fixtures)
    print("notebook conformance: " + ("PASS" if result["ok"] else "FAIL"))
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
