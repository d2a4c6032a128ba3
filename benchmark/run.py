"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (loading, the seeded weights, warming every shape the cell's
traffic uses, the cell's first training steps) is timed as `setup_s`.
The window then runs whole units (training steps or `generate` calls)
and ends at the first unit boundary after `--seconds`, with a
synchronize; a rate is all the window's work over all its time.  With
`--trace 1` the window (cut to the cell's `trace_seconds`) runs under
torch.profiler and the line carries the per-layer metrics, the device's
busy and window seconds and the breakdown.  Once the window has closed
and its peak memory is read, the program's state is freed and the plain
reference checks what the window's path produced; each number compared
is printed beside its limit as the last lines on standard error and
under "checks", the line's last key.  The last line of standard output
is the JSON result.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "kubeflow_tpu")


def _pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = CHECKOUT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


@dataclass
class Context:
    """What a runner and a metric reader see of the run."""
    name: str
    seed: int
    seconds: float
    traced: bool
    device: object
    cell: dict
    workload: dict
    shape: object
    mix: dict
    check_s: float = 0.0
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0
    work: int = 0
    unit_sizes: list = field(default_factory=list)
    peak_bytes: int = 0
    trace: object = None
    device_name: str = ""
    power_limit_w: float = 0.0


def power_limit() -> float:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0]) if out else 0.0
    except (OSError, ValueError, subprocess.SubprocessError):
        return 0.0


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def window(ctx: Context, run, seconds: float) -> None:
    """Whole units until the first boundary after `seconds`."""
    import torch

    from .trace import span, sync

    sync()
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    while True:
        with span(run.unit_span, ctx.traced):
            size = run.unit()
        ctx.units += 1
        ctx.work += size
        with span("between_calls", ctx.traced):
            run.boundary()
            done = time.perf_counter() - t0 >= seconds
        if done:
            break
    sync()
    run.finish()
    ctx.window_s = time.perf_counter() - t0
    if ctx.device.type == "cuda":
        ctx.peak_bytes = torch.cuda.max_memory_allocated()


def main(argv=None, device=None, shape=None, mix=None, cell=None) -> dict:
    """One run; returns the result (also printed).  The keyword
    arguments are for the tests: a CPU device (the look for a card is
    then skipped), a small shape and mix, the cell's settings."""
    _pin_caches()
    p = argparse.ArgumentParser(prog="benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from . import spec, traffic
    from .checks import judged
    from .shapes import load_shape
    from .trace import profiled

    bench = spec.benchmark()
    wl = spec.workload(bench, args.workload)
    cell = cell or spec.cell(args.workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < wl["chips"]:
            print(f"benchmark: the cell needs {wl['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            raise SystemExit(2)
        device = torch.device("cuda", 0)
    ctx = Context(name=args.workload, seed=args.seed, seconds=args.seconds,
                  traced=bool(args.trace), device=torch.device(device),
                  cell=cell, workload=wl,
                  shape=shape or load_shape(wl["config"]),
                  mix=mix or traffic.load(wl["traffic"]))
    if ctx.device.type == "cuda":
        ctx.device_name = torch.cuda.get_device_name(ctx.device)
        ctx.power_limit_w = power_limit()
    run = spec.runner(cell["runner"]).Runner(ctx)
    run.setup()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    ctx.setup_s = time.perf_counter() - START - ctx.check_s

    if ctx.traced:
        traces: list = []
        with profiled(traces):
            window(ctx, run, min(args.seconds,
                                 cell.get("trace_seconds", args.seconds)))
        ctx.trace = traces[0]
    else:
        window(ctx, run, args.seconds)
    attempted = getattr(run, "requests", ctx.units)
    failed = run.failed()
    wanted = spec.metrics_for(bench, ctx.name, ctx.traced)
    metrics = {}
    for m in wanted:
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    run.free()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    reference = run.reference()
    found = judged(run.numbers(reference), cell["limits"])
    correct = failed == 0 and all(c.ok for c in found) and bool(found)

    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        raise SystemExit(3)
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": ctx.device_name or str(ctx.device), "count": 1,
           "memory_peak_bytes": ctx.peak_bytes,
           "power_limit_w": ctx.power_limit_w}
    if ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if ctx.trace is not None:
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in found}
    for name, value in sorted(metrics.items()):
        print(f"metric {name} {value['value']} {value['unit']} "
              f"(power limit {ctx.power_limit_w} W)", file=sys.stderr)
    for c in found:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
