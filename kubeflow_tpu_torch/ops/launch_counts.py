"""The launch counts of the port's kernels, read and credited as one set.

Each kernel's wrapper adds one to its count where it launches the kernel
(`int4_matmul.launches`, `flash_attention.launches`).  Under a CUDA
graph's capture the wrapper is called but records the launch instead of
making it, and a replay launches what was recorded without calling the
wrapper.  So whoever captures a graph takes back what the capture counted
(`restore`) and credits that count at each replay (`credit`).
"""

from __future__ import annotations

from . import flash_attention, int4_matmul


def snapshot() -> dict:
    """Every kernel's count: {"int4_matmul": n, "flash_fwd": n, ...}."""
    return {"int4_matmul": int4_matmul.launches,
            **{f"flash_{k}": v for k, v in flash_attention.launches.items()}}


def restore(counts: dict) -> None:
    """Set every kernel's count to `counts` (a `snapshot`)."""
    int4_matmul.launches = counts["int4_matmul"]
    for key in flash_attention.launches:
        flash_attention.launches[key] = counts[f"flash_{key}"]


def since(before: dict) -> dict:
    """The launches counted since the snapshot `before`."""
    now = snapshot()
    return {k: now[k] - before[k] for k in now}


def credit(per_call: dict, calls: int = 1) -> None:
    """Add `calls` times `per_call` (a `since` delta) to the counts."""
    now = snapshot()
    restore({k: now[k] + calls * per_call[k] for k in now})


__all__ = ["credit", "restore", "since", "snapshot"]
