"""MFU sweep: `BENCH_CHIP` training variants on the card, one process each.

The twin of ci/mfu_sweep.py and ci/mfu_sweep_r5.py.  Two modes:

  --run '<json>'   run ONE config in this process and print one JSON line
  (sweep)          run the staged sweep, one subprocess per config (so an
                   out-of-memory or a kernel fault cannot poison later
                   runs), append every result to tools/sweep_h100.jsonl
                   (or --results=PATH) and print a ranked summary

A spec reads as the reference's `run_one` reads it (`sweep_config`):
`batch` (24), `seq` (2048), `num_steps` (10) and `mu_dtype` (None: an fp32
first moment) are taken out, and every other key is a field of
`BENCH_CHIP.with_(...)`.  The grid holds the knobs that the port's
`TransformerConfig` and bench expose: batch, `loss_chunks`,
`remat_policy`, `mu_dtype` and `attention_impl` (the flash CUDA kernels
against the einsum path).  The reference's flash tile sizes
(`flash_block_q`/`flash_block_k`) are TPU tiles that nothing in the port
reads, since the CUDA kernels fix their own tiles, so they are not in the
grid.  Stage "r5" is mfu_sweep_r5.py's: batch 40, 44 and 48 at seq 2048
over 12 steps, its top two measured again.

A run sets up the step, takes 2 warm-up steps, then times `num_steps`
steps in one CUDA-event window (`synchronize()` on each side).  Its line
gives the MFU against the card's bf16 peak, tokens/s, the step time, the
loss, the setup seconds (the kernels' build included on a first run),
the peak memory and the flash launches a step; a flash config that does
not launch all three flash kernels every step, or an einsum config that
launches one, fails.

    python -m kubeflow_tpu_torch.tools.mfu_sweep --run '<json>' [--cpu]
    python -m kubeflow_tpu_torch.tools.mfu_sweep [--results=PATH] [--cpu]

--cpu runs each config on TINY at batch <= 2, seq <= 64, 2 steps: a smoke
run whose numbers measure no card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
RESULTS = HERE / "sweep_h100.jsonl"
TOOL = "mfu_sweep"

# BENCH_CHIP as `python -m kubeflow_tpu_torch.bench` runs it: the anchor
BASE = {"batch": 40, "loss_chunks": 32, "mu_dtype": "bfloat16"}

# (label, specs over BASE, how many of the stage's best to measure again)
STAGES: list = [
    # the anchor and the loss and optimizer knobs alone
    ("0", [{}, {"loss_chunks": 16}, {"loss_chunks": 64},
           {"mu_dtype": None}], 0),
    # batch around the anchor's
    ("1", [{"batch": 32}, {"batch": 48}, {"batch": 56}], 0),
    # what each layer's checkpoint keeps, and the attention path
    ("2", [{"remat_policy": "dots"}, {"remat_policy": "attn"},
           {"remat_policy": "none"}, {"attention_impl": "xla"}], 0),
    # ci/mfu_sweep_r5.py: batch at 2k over 12 steps, the top two again
    ("r5", [{"batch": 48, "num_steps": 12}, {"batch": 40, "num_steps": 12},
            {"batch": 44, "num_steps": 12}], 2),
]


def sweep_config(spec: dict, base=None) -> tuple:
    """(config, batch, seq, num_steps, mu_dtype) of a spec, read as
    ci/mfu_sweep.py:run_one reads it; every key but the four is a field
    of `base` (BENCH_CHIP)."""
    from ..models.configs import BENCH_CHIP

    spec = dict(spec)
    batch = spec.pop("batch", 24)
    seq = spec.pop("seq", 2048)
    num_steps = spec.pop("num_steps", 10)
    mu_dtype = spec.pop("mu_dtype", None)
    return ((base or BENCH_CHIP).with_(**spec), batch, seq, num_steps,
            mu_dtype)


def run_one(spec: dict, argv: list) -> dict:
    """One config in this process: its result line's fields."""
    import torch

    from ..models.configs import TINY
    from ..models.train import default_optimizer, mfu, setup_training
    from ..ops import launch_counts
    from .common import run_device, window_ms

    device, name, smi = run_device(TOOL, argv)
    on_cpu = device.type == "cpu"
    config, batch, seq, num_steps, mu_dtype = sweep_config(
        spec, TINY if on_cpu else None)
    if on_cpu:
        batch, seq, num_steps = min(batch, 2), min(seq, 64), min(num_steps, 2)

    t0 = time.perf_counter()
    setup = setup_training(config, device=device,
                           optimizer=default_optimizer(mu_dtype=mu_dtype))
    gen = torch.Generator(device=device).manual_seed(0)
    inputs = torch.randint(0, config.vocab_size, (batch, seq),
                           generator=gen, device=device)
    data = {"inputs": inputs, "targets": torch.roll(inputs, -1, dims=1)}
    state = setup.state
    for _ in range(2):
        state, metrics = setup.train_step(state, data)
    float(metrics["loss"])
    setup_s = time.perf_counter() - t0
    if not on_cpu:
        torch.cuda.reset_peak_memory_stats(device)
    before = launch_counts.snapshot()

    def steps():
        nonlocal state
        for _ in range(num_steps):
            state, out = setup.train_step(state, data)
        return out

    metrics, ms = window_ms(steps, device)
    setup.state = state
    launches = {k: v / num_steps
                for k, v in launch_counts.since(before).items()
                if k.startswith("flash_")}
    flash = config.attention_impl == "flash" and not on_cpu
    if flash and not all(launches.values()) \
            or not flash and any(launches.values()):
        raise RuntimeError(f"{TOOL}: attention_impl "
                           f"{config.attention_impl!r} launched {launches} "
                           f"flash kernels a step")
    step_s = ms / 1e3 / num_steps
    tokens_per_s = batch * seq / step_s
    achieved = None if on_cpu else mfu(tokens_per_s, config, seq, 1, name)
    return {
        "mfu": achieved,
        "tokens_per_s": tokens_per_s,
        "step_time_s": step_s,
        "loss": float(metrics["loss"]),
        "setup_s": setup_s,
        "peak_memory_gb": None if on_cpu else
        torch.cuda.max_memory_allocated(device) / 2**30,
        "flash_launches_per_step": launches,
        "batch": batch, "seq": seq, "num_steps": num_steps,
        "device": name, "nvidia_smi": smi,
    }


def run_spec(spec: dict, runner: Callable, cpu: bool,
             timeout: float) -> dict:
    """One config through `runner` (subprocess.run's signature), in its
    own `python -m kubeflow_tpu_torch.tools.mfu_sweep --run` process: the
    process's JSON line, or its error and exit code."""
    argv = [sys.executable, "-m", "kubeflow_tpu_torch.tools.mfu_sweep",
            "--run", json.dumps(spec)] + (["--cpu"] if cpu else [])
    try:
        proc = runner(argv, capture_output=True, text=True, timeout=timeout,
                      cwd=ROOT)
    except subprocess.TimeoutExpired:
        return {"error": f"timed out after {timeout} s", "rc": None}
    lines = proc.stdout.strip().splitlines()
    try:
        return json.loads(lines[-1])
    except (json.JSONDecodeError, IndexError):
        # the exception's own line, without the traceback's paths
        errors = proc.stderr.strip().splitlines()
        return {"error": errors[-1] if errors else "no output",
                "rc": proc.returncode}


def drive(stages: list, base: dict, results: Path,
          runner: Callable = subprocess.run, cpu: bool = False,
          timeout: float = 1200.0) -> list:
    """Run every stage's specs over `base`, one process each, appending
    each record to `results` as it comes and carrying on past a failed
    config; then measure each stage's top `confirm` again.  Returns the
    records, ranked by MFU in the summary it prints."""
    records = []

    def record(stage: str, spec: dict, **extra) -> dict:
        result = run_spec(spec, runner, cpu, timeout)
        rec = {"stage": stage, "spec": spec, **extra, **result}
        with results.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        records.append(rec)
        shown = ({k: v for k, v in result.items()
                  if k in ("mfu", "tokens_per_s", "step_time_s")}
                 if "error" not in result else f"FAILED rc={result['rc']}")
        print(f"    -> {shown}", flush=True)
        return rec

    for label, specs, confirm in stages:
        ran = []
        for spec in specs:
            merged = {**base, **spec}
            print(f"[stage {label}] {json.dumps(merged, sort_keys=True)}",
                  flush=True)
            ran.append(record(label, merged))
        ok = sorted((r for r in ran if r.get("mfu") is not None),
                    key=lambda r: -r["mfu"])
        for r in ok[:confirm]:
            print(f"[stage {label} confirm] "
                  f"{json.dumps(r['spec'], sort_keys=True)}", flush=True)
            record(label, r["spec"], confirm=True)

    ranked = sorted((r for r in records if r.get("mfu") is not None),
                    key=lambda r: -r["mfu"])
    print("\n=== ranked ===")
    for r in ranked[:10]:
        print(f"mfu={r['mfu']:.4f} tok/s={r['tokens_per_s']:>10.1f} "
              f"{json.dumps(r['spec'], sort_keys=True)}")
    return records


def main(argv: Optional[list] = None) -> None:
    from .common import flag_value

    argv = sys.argv[1:] if argv is None else list(argv)
    if "--run" in argv:
        spec = json.loads(argv[argv.index("--run") + 1])
        print(json.dumps(run_one(spec, argv)), flush=True)
        return
    results = Path(flag_value(argv, "results") or RESULTS)
    drive(STAGES, BASE, results, cpu="--cpu" in argv)


if __name__ == "__main__":
    main()
