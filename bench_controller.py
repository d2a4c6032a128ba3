"""The notebook_train phase's controller work without its training, timed
per round, for one tree of this repo.

    python bench_controller.py [--tree DIR] [--rounds N]

chip_smoke.py's notebook_train phase drives the port's manager
(`NotebookController`) through a start, a cull, an unstop, a drain
migration, a dead card, a preemption, a promotion drill and their
readiness checks, between training runs on the card.  This script drives
the same sequence from `DIR`'s chip_smoke.py and `kubeflow_tpu_torch`
(default: the directory it lives in), with 1 KB in place of the train
state's bytes and no training, so that the snapshot stores' file writes
are small and what is left is the control plane's own work.  Where the
tree has the observability plane, run A's telemetry summary is made by a
TelemetryAgent from four step times and published onto the pod, and the
plane's gates run at the end (`NotebookController.observability`).

Each round prints one JSON line: the controller's wall ms over the
sequence's stages and its reconciles, and, where the tree times them,
the observability engines' per-attempt and dispatch hooks and the
store's client-verb accounting.  A last line gives the medians over the
rounds after the first (the first pays the imports' warm-up).  Run one
tree per process (the trees share the package's name) and alternate
them: parent, change, change, parent.  Host work only, but the
controller labels its node with the card's name and count, so it needs
the card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path


def one_round(cs, agent, device_name: str) -> dict:
    payload = b"x" * 1024
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        c = cs.NotebookController(device_name, Path(tmp))
        rendered = c.start()
        if hasattr(c, "telemetry"):
            c.telemetry(agent)
        c.cull()
        c.unstop(rendered)
        c.busy()
        c.migrate(payload)
        c.ready("drain")
        c.kill_card()
        c.ready("failure")
        c.preempt(payload)
        c.hold_beneficiary()
        c.stop_beneficiary()
        chain = cs.start_chain(c, payload, {"losses": [1.0] * cs.NB_STEPS})
        c.ready("preempt")
        c.replicate()
        chain["future"].result()
        chain["pool"].shutdown()
        c.catch_up()
        c.promote()
        obs = None
        try:
            if hasattr(c, "observability"):
                obs = c.observability("")
        finally:
            if hasattr(c, "close"):
                c.close()
        wall_s = time.perf_counter() - t0
    out = {"wall_ms": c.cost["wall_ms"], "reconciles": c.cost["reconciles"],
           "sequence_s": wall_s}
    if obs is not None:
        out.update({k: obs[k] for k in ("hook_ms", "hooks",
                                        "verb_accounting", "scrape_ms",
                                        "eval_ms", "profiler_ms",
                                        "engines_s", "observer_errors")
                    if k in obs})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    p.add_argument("--rounds", type=int, default=5)
    args = p.parse_args(argv)
    tree = str(Path(args.tree).resolve())
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("bench_controller: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from kubeflow_tpu_torch.models.configs import BENCH_CHIP
    from kubeflow_tpu_torch.runtime.telemetry import TelemetryAgent

    device_name = torch.cuda.get_device_name(0)
    agent = TelemetryAgent(config=BENCH_CHIP, batch=8,
                           seq_len=BENCH_CHIP.max_seq_len, num_chips=1,
                           accelerator=device_name, worker=cs.NB_NAME,
                           hbm_fn=lambda: {})
    for dt in (0.41, 0.40, 0.41, 0.40):
        agent.record_step(dt)
    rounds = []
    for i in range(args.rounds):
        r = one_round(cs, agent, device_name)
        rounds.append(r)
        print(json.dumps({"tree": tree, "round": i, **r}), flush=True)
    rest = rounds[1:] or rounds
    summary = {"tree": tree, "rounds": len(rounds),
               "median_wall_ms": statistics.median(
                   r["wall_ms"] for r in rest),
               "median_reconciles": statistics.median(
                   r["reconciles"] for r in rest)}
    if "hook_ms" in rest[0]:
        summary["median_hook_ms"] = statistics.median(
            r["hook_ms"] for r in rest)
        summary["median_verb_ms"] = statistics.median(
            r["verb_accounting"]["ms"] for r in rest)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
