"""Long-context (seq 4096) MFU sweep of `BENCH_CHIP` on the card.

The twin of ci/longctx_sweep.py: its base (seq 4096, batch 24, 32 loss
chunks, a bf16 first moment) and its grid without the flash tile sizes,
which the port's CUDA kernels fix for themselves (tools/mfu_sweep.py):
the anchor and the bench's batch 20 (`bench --long-context`), the `attn`
remat policy and batch, then loss chunking at the larger batch.  Each
config runs in its own `python -m kubeflow_tpu_torch.tools.mfu_sweep
--run` process, so an out-of-memory cannot poison later runs, and every
result is appended to tools/longctx_h100.jsonl (or --results=PATH).

    python -m kubeflow_tpu_torch.tools.longctx_sweep [--results=PATH] [--cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional

from .common import flag_value
from .mfu_sweep import HERE, drive

RESULTS = HERE / "longctx_h100.jsonl"

BASE = {"seq": 4096, "batch": 24, "loss_chunks": 32, "mu_dtype": "bfloat16"}

STAGES: list = [
    # the reference's anchor and the port's bench point
    ("0", [{}, {"batch": 20}], 0),
    # what each layer's checkpoint keeps, and batch
    ("1", [{"remat_policy": "attn", "batch": 16}, {"batch": 16},
           {"batch": 32}], 0),
    # loss chunking at the larger batch
    ("2", [{"loss_chunks": 64, "batch": 32},
           {"loss_chunks": 16, "batch": 32}], 0),
]


def main(argv: Optional[list] = None) -> list:
    argv = sys.argv[1:] if argv is None else list(argv)
    results = Path(flag_value(argv, "results") or RESULTS)
    return drive(STAGES, BASE, results, cpu="--cpu" in argv,
                 timeout=1800.0)


if __name__ == "__main__":
    main()
