"""The readings that set a cell's limits, many seeds in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds <s1,s2,...>
        [--control <n>] [--faults <n>] [--calls <n>] [--out <file.jsonl>]

For each seed the program's readings are taken as a run takes them (the
set-up's first training steps; or for serving, `--calls` calls of the
closed loop, every prompt length among them) and compared with the
reference: these are the sound runs' readings.  For the first
`--control` seeds the control, the reference computed in fp8 in the
program's place, is compared the same way; for the first `--faults`
seeds of a training cell so is the reference with half of the batch
left out.  One JSON line a seed and reading; no window is timed.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import checks, spec, traffic
from .run import Context, _pin_caches
from .shapes import load_shape


def _look(got, ref) -> dict:
    """Where a training number comes from: its widest leaves."""
    if got is None:
        return {}
    return {"worst_grad": checks.worst_leaves(got.grad, ref.grad),
            "worst_change": checks.worst_leaves(
                got.change, ref.change, checks.moving_leaves(ref.grad)),
            "losses": [got.losses, ref.losses]}


def readings(name: str, seed: int, calls: int, control: bool, faults: bool,
             device, shape=None, mix=None) -> list:
    bench = spec.benchmark()
    wl = spec.workload(bench, name)
    cell = spec.cell(name)
    ctx = Context(name=name, seed=seed, seconds=0.0, traced=False,
                  device=torch.device(device), cell=cell, workload=wl,
                  shape=shape or load_shape(wl["config"]),
                  mix=mix or traffic.load(wl["traffic"]))
    run = spec.runner(cell["runner"]).Runner(ctx)
    t0 = time.perf_counter()
    run.setup()
    if cell["runner"] == "decode":
        for _ in range(calls):
            run.unit()
            run.boundary()
    setup_s = time.perf_counter() - t0
    run.free()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = run.reference()
    out = [{"seed": seed, "reading": "program",
            "numbers": run.numbers(ref), "setup_s": setup_s,
            "reference_s": time.perf_counter() - t0,
            **_look(run.readings if cell["runner"] == "train" else None,
                    ref)}]
    if control:
        low = run.reference("fp8")
        numbers = (checks.train_numbers(low, ref)
                   if cell["runner"] == "train" else run.numbers(low))
        out.append({"seed": seed, "reading": "control_fp8",
                    "numbers": numbers,
                    **_look(low if cell["runner"] == "train" else None,
                            ref)})
    if faults and cell["runner"] == "train":
        half = run.reference(half_batch=True)
        out.append({"seed": seed, "reading": "fault_half_batch",
                    "numbers": checks.train_numbers(half, ref)})
    return out


def main(argv=None) -> None:
    _pin_caches()
    p = argparse.ArgumentParser(prog="benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--calls", type=int, default=5)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.calibrate: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None
    for i, seed in enumerate(seeds):
        for line in readings(args.workload, seed, args.calls,
                             i < args.control, i < args.faults, "cuda"):
            line["workload"] = args.workload
            text = json.dumps(line)
            print(text, flush=True)
            if sink:
                sink.write(text + "\n")
                sink.flush()


if __name__ == "__main__":
    main()
