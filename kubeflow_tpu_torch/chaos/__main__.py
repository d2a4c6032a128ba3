"""Run the seeded chaos soaks' lanes against the port's control plane.

    python -m kubeflow_tpu_torch.chaos [--gpu ACCEL] [--only LANE]

The twin of the reference's ci/chaos_soak.sh: its seven lanes (the
random fault soak, self-healing recovery, checkpoint migration,
preemption, the fleet SLO soak, the sharded fleet's kill and rejoin, and
replica failover), each a group of `chaos.soaks` functions, with the
script's knobs and defaults read from the environment:

    CHAOS_SOAK_SEED      20260804, or `random` for a fresh draw
    CHAOS_SOAK_ROUNDS    25   the random fault soak
    SELFHEAL_SOAK_ROUNDS 16   the recovery soak
    MIGRATE_SOAK_ROUNDS  12   the migration soak
    PREEMPT_SOAK_ROUNDS  6    the preemption soak
    SHARD_SOAK_ROUNDS    10   the kill/rejoin soak
    FAILOVER_SOAK_ROUNDS 50   the failover soak
    WORKQUEUE_WORKERS    8    every manager's worker pool
    INVARIANTS_STRICT    1    the runtime concurrency sanitizer

The gangs are `--gpu` hosts (default h100-80gb, 8 GPUs a host).  It
prints the seed line first, then one JSON line a lane with its seconds
and its records' counts; on a failure it prints the line that reproduces
the run and exits 1.  Everything runs on FakeClocks in this process; no
card is needed.

The script's opt-in deep sections have twins of their own:
INTERLEAVE_DEEP is `kubeflow_tpu_torch/testing/interleave.py` under
INTERLEAVE_MAX_SCHEDULES and INTERLEAVE_BUDGET_S (tests/
test_torch_interleave.py, `-m slow` for the full depth), and
FLEET_SCALE_DEEP is `python -m kubeflow_tpu_torch.loadtest.convergence
--sweep 50000,100000 --shards 5 --budget-section sharded_100k`."""

from __future__ import annotations

import argparse
import json
import logging
import os
import random
import sys
import time
import traceback

from . import soaks

# lane -> (its rounds knob and the script's default, the soaks it runs);
# the knob sets the first soak's rounds, the others run at their own
LANES = {
    "chaos": (("CHAOS_SOAK_ROUNDS", 25), (
        soaks.chaos_soak, soaks.trace_integrity_soak,
        soaks.reproducible_plan)),
    "slice_recovery": (("SELFHEAL_SOAK_ROUNDS", 16), (
        soaks.recovery_soak, soaks.recovery_exhaustion)),
    "migration": (("MIGRATE_SOAK_ROUNDS", 12), (
        soaks.migration_soak, soaks.migration_failover,
        soaks.migration_exhaustion)),
    "preemption": (("PREEMPT_SOAK_ROUNDS", 6), (soaks.preemption_soak,)),
    "fleet_slo": (None, (soaks.fleet_slo_soak,)),
    "shard": (("SHARD_SOAK_ROUNDS", 10), (soaks.shard_soak,)),
    "failover": (("FAILOVER_SOAK_ROUNDS", 50), (soaks.failover_soak,)),
}
KNOBS = [knob for knob, _ in LANES.values() if knob is not None]


def settings(env=None) -> dict:
    """The script's knobs from `env` (the process's by default), with a
    `random` seed drawn here."""
    env = os.environ if env is None else env
    seed = env.get("CHAOS_SOAK_SEED", "20260804")
    if seed == "random":
        seed = random.SystemRandom().randrange(2**30)
    out = {"seed": int(seed),
           "workers": int(env.get("WORKQUEUE_WORKERS", "8")),
           "strict": env.get("INVARIANTS_STRICT", "1")}
    for name, default in KNOBS:
        out[name] = int(env.get(name, str(default)))
    return out


def seed_line(cfg: dict) -> str:
    return (f"== chaos soak: seed={cfg['seed']} "
            + " ".join(f"{name}={cfg[name]}" for name, _ in KNOBS)
            + f" workers={cfg['workers']} strict={cfg['strict']} ==")


def reproduce_line(cfg: dict, gpu: str) -> str:
    knobs = " ".join(f"{name}={cfg[name]}" for name, _ in KNOBS)
    return (f"CHAOS_SOAK_SEED={cfg['seed']} {knobs} "
            f"WORKQUEUE_WORKERS={cfg['workers']} "
            f"INVARIANTS_STRICT={cfg['strict']} "
            f"python -m kubeflow_tpu_torch.chaos --gpu {gpu}")


def merge_counts(records) -> dict:
    """A lane's counts: summed over its soaks, but the attempt at which
    an exhaustion case exhausted, which is kept as it is."""
    out: dict = {}
    for rec in records:
        for key, value in rec["counts"].items():
            out[key] = value if key == "exhausted_at" \
                else out.get(key, 0) + value
    return out


def run_lane(lane: str, cfg: dict, stack) -> dict:
    """One lane on `stack`: its soaks in order, at the knob's rounds and
    the configured workers and sanitizer.  Raises SoakFailure."""
    knob, fns = LANES[lane]
    t0 = time.perf_counter()
    records = []
    with soaks.environ("INVARIANTS_STRICT", cfg["strict"]):
        for i, fn in enumerate(fns):
            rounds = cfg[knob[0]] if knob is not None and i == 0 else None
            records.append(fn(stack, cfg["seed"], rounds,
                              workers=cfg["workers"]))
    return {"lane": lane, "seconds": time.perf_counter() - t0,
            "rounds": cfg[knob[0]] if knob is not None else None,
            "workers": cfg["workers"], "seed": cfg["seed"],
            "counts": merge_counts(records), "records": records}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubeflow_tpu_torch.chaos",
        description=__doc__.split("\n\n")[0],
        epilog="Deep sections: INTERLEAVE_DEEP's twin is "
               "kubeflow_tpu_torch/testing/interleave.py (tests/"
               "test_torch_interleave.py -m slow); FLEET_SCALE_DEEP's is "
               "python -m kubeflow_tpu_torch.loadtest.convergence --sweep "
               "50000,100000 --shards 5 --budget-section sharded_100k.")
    parser.add_argument("--gpu", default="h100-80gb",
                        help="the gangs' accelerator (default h100-80gb)")
    parser.add_argument("--only", choices=sorted(LANES), action="append",
                        help="run only this lane (may repeat)")
    args = parser.parse_args(argv)
    cfg = settings()
    print(seed_line(cfg), flush=True)
    logging.basicConfig(level=logging.CRITICAL)
    stack = soaks.port_stack(args.gpu)
    for lane in LANES:
        if args.only and lane not in args.only:
            continue
        try:
            result = run_lane(lane, cfg, stack)
        except Exception:
            traceback.print_exc()
            print(f"chaos soak FAILED in lane {lane}; reproduce with:\n  "
                  + reproduce_line(cfg, args.gpu), file=sys.stderr)
            return 1
        result.pop("records")
        print(json.dumps(result), flush=True)
    print(f"chaos soak OK (seed={cfg['seed']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
