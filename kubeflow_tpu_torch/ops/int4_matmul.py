"""Matmul against nibble-packed int4 weights: the Hopper kernel and its
plain PyTorch version.

`int4_matmul(x, packed, scales)` computes `x[M, K] @ W` where W's row 2i is
the sign-extended low nibble and row 2i+1 the high nibble of
`packed[K/2, N]` (int8), and every 64 contract rows share one bf16 scale
per column, `scales[K/64, 1, N]` (models/quant.py's layout).

- On a CUDA tensor it launches the hand-written sm_90a kernel
  (`csrc/int4_matmul.cu`: wgmma with the dequantized weights as the
  register operand, TMA loads, split-K across blocks where the output
  tiles alone leave SMs idle), built with nvcc at first use into
  `build/kernels/` and bound through ctypes (`ops/_build.py`).  A shape
  outside the kernel's contract, a failed build or a failed launch
  raises; nothing falls back.
- On a CPU tensor it runs `int4_matmul_reference`, the plain version.

`plan(m, k, n, sms)` is the kernel's tile and split, a pure function of
the shape and the card's SM count.  `launches` counts the kernel's
launches, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build

GROUP = 64  # contract rows per scale (models.quant.INT4_GROUP)

SOURCE = _build.CSRC / "int4_matmul.cu"

launches = 0  # kernel launches since import (or since a caller reset it)

WG_COLS = 128          # output columns of one consumer warpgroup
TOKEN_TILES = (16, 64, 128)


class Plan(NamedTuple):
    """How the kernel covers an [M, K] x [K, N] product: token tiles of
    `bm` rows, `consumers` warpgroups of 128 columns a block, and K split
    into `splits` runs of `groups_per_split` scale groups (the last run
    may be shorter)."""
    bm: int
    consumers: int
    splits: int
    groups_per_split: int


def plan(m: int, k: int, n: int, sms: int) -> Plan:
    """The kernel's tiling for x [m, k] @ W [k, n] on a card of `sms`
    SMs.  The token tile is the smallest of 16, 64, 128 that holds m (or
    128).  Where the output tiles fill less than three quarters of the
    blocks the card holds at once (two a SM at bm 16, one otherwise), K
    is split so that they do, keeping at least 4 scale groups a split at
    bm 16 and 8 otherwise, so the fp32 partials stay small beside the
    weight bytes."""
    groups = k // GROUP
    bm = next((t for t in TOKEN_TILES if m <= t), TOKEN_TILES[-1])
    consumers = 2 if bm == 128 else 1
    tiles = math.ceil(m / bm) * math.ceil(n / (consumers * WG_COLS))
    target = sms * (2 if bm == 16 else 1)
    splits = 1
    if 4 * tiles < 3 * target:
        min_groups = 4 if bm == 16 else 8
        splits = max(1, min(math.ceil(target / tiles), groups // min_groups))
    per = math.ceil(groups / splits)
    return Plan(bm, consumers, math.ceil(groups / per), per)


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
    _check_kernel(x, packed, scales)
    p = plan(m, k, n, _sm_count(x.device))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    ws = counters = None
    if p.splits > 1:
        ws = torch.empty((p.splits, m, n), dtype=torch.float32,
                         device=x.device)
        counters = _counters(x.device, math.ceil(m / p.bm)
                             * math.ceil(n / WG_COLS))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.int4_matmul_bf16(
            x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(), m, k, n,
            p.bm, p.splits, p.groups_per_split, stream)
    if rc != 0:
        what = {-1: "bad shape", -2: "TMA descriptor not encoded"}.get(
            rc, f"CUDA error {rc}")
        raise RuntimeError(f"int4_matmul kernel launch failed ({what}) at "
                           f"M={m} K={k} N={n}")
    launches += 1
    return out


def _check_kernel(x, packed, scales) -> None:
    """The kernel's contract beyond _check: contiguous, 16-byte aligned
    operands (TMA reads them) and N % 16 == 0 (a packed row is a TMA
    stride, a multiple of 16 bytes).  Raises ValueError outside it."""
    m, n = x.shape[0], packed.shape[1]
    if not (x.is_contiguous() and packed.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("int4_matmul wants contiguous x, packed, scales")
    if m < 1 or n % 16:
        raise ValueError(f"the kernel wants M >= 1 and N % 16 == 0; got "
                         f"M={m}, N={n}")
    if any(t.data_ptr() % 16 for t in (x, packed, scales)):
        raise ValueError("x, packed and scales must be 16-byte aligned")


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_COUNTERS: dict = {}


def _counters(device: torch.device, size: int) -> torch.Tensor:
    """Zeroed split-K tile counters for `device`, kept between calls: the
    kernel's last block of each tile sets its counter back to 0."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < size:
        buf = torch.zeros(max(size, 4096), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def counter_buffers() -> tuple:
    """The split-K counter buffers in use now.  A captured CUDA graph
    records a buffer's address, and a later eager call with a larger
    tile grid replaces the buffer (freeing it once nothing else holds
    it), so whoever keeps a graph keeps these too."""
    return tuple(_COUNTERS.values())


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.int4_matmul_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


__all__ = ["GROUP", "Plan", "SOURCE", "counter_buffers", "int4_matmul",
           "int4_matmul_reference", "plan", "unpack_int4"]
