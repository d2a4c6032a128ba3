"""A frozen copy of the int4 quantizer's arithmetic, and its inverse.

A kernel [K, N] (contract rows flattened first) is cut into groups of 64
rows; each group and column gets the scale absmax / 7 (at least 1e-12),
rounded to bf16 as stored; a weight is round-half-to-even(w / scale),
clipped to [-8, 7], computed with the fp32 scale before rounding.  The
dequantized weight is that integer times the stored bf16 scale.
"""

from __future__ import annotations

import torch

GROUP = 64


def dequantized(kernel: torch.Tensor) -> torch.Tensor:
    """kernel [K, N] (any float dtype) -> fp32 [K, N], as int4 with one
    bf16 scale per 64 rows and column holds it."""
    k32 = kernel.to(torch.float32)
    rows, cols = k32.shape
    g = k32.reshape(rows // GROUP, GROUP, cols)
    scale = torch.clamp_min(g.abs().amax(dim=1, keepdim=True) / 7.0, 1e-12)
    q = torch.clamp(torch.round(g / scale), -8, 7)
    stored = scale.to(torch.bfloat16).to(torch.float32)
    return (q * stored).reshape(rows, cols)


__all__ = ["GROUP", "dequantized"]
