"""What the tools share: the device a run measures, the card's name and
power limit beside every number, CUDA-event windows, and one JSON line
per measurement."""

from __future__ import annotations

import json
import subprocess
import time
from typing import Callable, Optional

import torch

from ..bench import _device


def run_device(tool: str, argv: list) -> tuple:
    """(device, its name, the nvidia-smi line) of a tool's run: the CPU
    with --cpu (no nvidia-smi line), else the first card, TF32 off.  With
    no card and no --cpu the tool exits non-zero: a measurement never
    falls back to the CPU."""
    on_cpu = "--cpu" in argv
    if not on_cpu and not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device; pass --cpu for the CPU "
                         f"smoke run")
    device, name = _device(on_cpu)
    return device, name, None if on_cpu else nvidia_smi()


def nvidia_smi() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def window_ms(fn: Callable, device: torch.device) -> tuple:
    """(fn(), its milliseconds): on a card, CUDA events inside a
    `synchronize()` on each side; on the CPU the host clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(end)


def emit(tool: str, measurement: str, device_name: str,
         smi: Optional[str], **fields) -> dict:
    """Print one measurement as a JSON line and return it."""
    record = {"tool": tool, "measurement": measurement,
              "device": device_name, "nvidia_smi": smi, **fields}
    print(json.dumps(record), flush=True)
    return record


def flag_value(argv: list, name: str) -> Optional[str]:
    """The value of `--name=value` in argv, or None."""
    prefix = f"--{name}="
    for arg in argv:
        if arg.startswith(prefix):
            return arg[len(prefix):]
    return None


__all__ = ["emit", "flag_value", "nvidia_smi", "run_device", "window_ms"]
