"""Matmul against nibble-packed int4 weights: the Hopper kernel and its
plain PyTorch version.

`int4_matmul(x, packed, scales)` computes `x[M, K] @ W` where W's row 2i is
the sign-extended low nibble and row 2i+1 the high nibble of
`packed[K/2, N]` (int8), and every 64 contract rows share one bf16 scale
per column, `scales[K/64, 1, N]` (models/quant.py's layout).

- On a CUDA tensor it launches the hand-written sm_90a kernel
  (`csrc/int4_matmul.cu`), built with nvcc at first use into
  `build/kernels/` and bound through ctypes (`ops/_build.py`).  A failed build or launch
  raises; nothing falls back.
- On a CPU tensor it runs `int4_matmul_reference`, the plain version.

`launches` counts the kernel's launches, so a run can show that its path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

GROUP = 64  # contract rows per scale (models.quant.INT4_GROUP)

SOURCE = _build.CSRC / "int4_matmul.cu"

launches = 0  # kernel launches since import (or since a caller reset it)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """packed [K/2, N] int8 -> W [K, N] int32, rows interleaved lo/hi."""
    p = packed.to(torch.int32)
    lo = (p << 28) >> 28
    hi = p >> 4
    return torch.stack([lo, hi], dim=1).reshape(2 * p.shape[0], p.shape[1])


def int4_matmul_reference(x: torch.Tensor, packed: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """The plain version: unpack, scale, one matmul with an fp32 result.

    For bf16 x it keeps the kernel's rounding points: nibble * scale in
    fp32, rounded to bf16; the products summed in fp32; the sum rounded
    to bf16.  For fp32 x it is the reference package's CPU fallback
    (models/quant.py Int4DenseGeneral): weights scaled in fp32, an fp32
    matmul."""
    k = 2 * packed.shape[0]
    n = packed.shape[1]
    w = unpack_int4(packed).reshape(k // GROUP, GROUP, n).to(torch.float32)
    w = (w * scales.reshape(k // GROUP, 1, n).to(torch.float32)).reshape(k, n)
    if x.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16)
    out = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return out.to(x.dtype)


def _check(x, packed, scales) -> None:
    if x.dim() != 2 or packed.dim() != 2:
        raise ValueError(f"int4_matmul wants x [M, K] and packed [K/2, N]; "
                         f"got {tuple(x.shape)} and {tuple(packed.shape)}")
    m, k = x.shape
    n = packed.shape[1]
    if k % GROUP or packed.shape[0] * 2 != k:
        raise ValueError(f"contract size {k} must be a multiple of {GROUP} "
                         f"and twice packed's {packed.shape[0]} rows")
    if scales.numel() != (k // GROUP) * n or scales.shape[-1] != n:
        raise ValueError(f"scales {tuple(scales.shape)} do not match "
                         f"[{k // GROUP}, 1, {n}]")
    if packed.dtype != torch.int8:
        raise TypeError(f"packed must be int8, got {packed.dtype}")
    if not (x.device == packed.device == scales.device):
        raise ValueError("x, packed and scales must be on one device")


def int4_matmul(x: torch.Tensor, packed: torch.Tensor,
                scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ int4-packed W -> [M, N] in x's dtype (bf16 on CUDA)."""
    global launches
    _check(x, packed, scales)
    if x.device.type == "cpu":
        return int4_matmul_reference(x, packed, scales)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul runs on cuda or cpu, not {x.device}")
    m, k = x.shape
    n = packed.shape[1]
    if x.dtype != torch.bfloat16 or scales.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 x and scales; got "
                        f"{x.dtype} and {scales.dtype}")
    if not (x.is_contiguous() and packed.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("int4_matmul wants contiguous x, packed, scales")
    if n % 4 or not 0 < m <= 65535 * 16:
        raise ValueError(f"the kernel wants N % 4 == 0 and 0 < M <= "
                         f"{65535 * 16}; got M={m}, N={n}")
    if packed.data_ptr() % 4 or scales.data_ptr() % 8:
        raise ValueError("packed must be 4-byte and scales 8-byte aligned")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.int4_matmul_bf16(x.data_ptr(), packed.data_ptr(),
                                  scales.data_ptr(), out.data_ptr(),
                                  m, k, n, stream)
    if rc != 0:
        raise RuntimeError(f"int4_matmul kernel launch failed: CUDA error "
                           f"{rc} at M={m} K={k} N={n}")
    launches += 1
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.int4_matmul_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


__all__ = ["GROUP", "SOURCE", "int4_matmul", "int4_matmul_reference",
           "unpack_int4"]
