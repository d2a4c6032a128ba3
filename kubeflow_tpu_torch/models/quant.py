"""Quantized weight streaming for decode: int8 and nibble-packed int4.

Decode reads every matmul weight once per token step, so fewer bytes per
weight lower its floor.  The port keeps the reference package's stored
layouts (kubeflow_tpu/models/quant.py), so a quantized tree converts
leaf for leaf:

- int8: `kernel_q` int8 in the dense kernel's own layout [contract...,
  features...] and a per-output-channel `kernel_scale` bf16 of shape
  [1..., features...].  `Int8Linear` multiplies them out at the matmul;
  `StackedInt8Linear` does the same for MoE expert kernels [E, K, N]
  with scales [E, 1, N].
- int4: `kernel_q4` [K/2, N] int8 (byte i holds contract row 2i in its
  low nibble and row 2i+1 in its high nibble) and `kernel_scale`
  [K/64, 1, N] bf16, one scale per 64 contract rows and column.
  `Int4Linear` runs the Hopper kernel of ops/int4_matmul.py on a CUDA
  tensor and the plain version on a CPU tensor.

Every quantized parameter records logical axis names (`logical_axes`),
so models/train.py `shard_parameters` cuts it for tensor-parallel decode
by the same rule table as a full-precision kernel, and each layer takes
its sizes from its parameters' shapes.  The int8 kernels carry their
dense kernel's axes and the scales its feature axes, as in the
reference.  The int4 layout is flat, [K/2, N]: the reference names only
its columns (`(None, k_axes[-1])`), which GSPMD may cut anywhere, since
it computes on the whole array.  Here each rank multiplies its own
block, so the packed rows and the scale groups carry the dense kernel's
outermost contract axis (out and down are cut over K, row-parallel) and
the columns its outermost named feature axis (qkv, gate_up and the head
are cut over N, column-parallel; models/convert.py regroups the fused
ones so that each rank's columns are contiguous).

The quantizers work on the reference's param tree layout (nested dicts
of tensors, models/convert.py) and give bytes identical to the reference's
numpy quantizers, on either device.
"""

from __future__ import annotations

from collections.abc import Mapping
from math import prod
from typing import Sequence, Union

import torch
from torch import nn

from ..ops.int4_matmul import int4_matmul, int4_matmul_reference

INT4_GROUP = 64  # contract rows per int4 scale


def _as_tuple(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,)


def _named(param: nn.Parameter, axes: tuple) -> nn.Parameter:
    param.logical_axes = axes
    return param


def int4_axes(axes, n_contract: int) -> tuple:
    """(packed rows, columns) axis names of an int4 kernel whose dense
    layout has logical `axes` with `n_contract` contract dims: the
    outermost contract axis and the outermost named feature axis."""
    if not axes:
        return None, None
    return axes[0], next((a for a in axes[n_contract:] if a is not None),
                         None)


class Int8Linear(nn.Module):
    """The port of Int8DenseGeneral: a bias-free dense layer whose kernel
    is int8 with per-output-channel bf16 scales.  The contracted dims are
    the trailing `n_contract` dims of the input."""

    def __init__(self, contract: Union[int, Sequence[int]],
                 features: Union[int, Sequence[int]],
                 dtype=torch.bfloat16, device="cuda", axes=None):
        super().__init__()
        self.contract, self.features = _as_tuple(contract), _as_tuple(features)
        self.dtype = dtype
        nc = len(self.contract)
        shape = self.contract + self.features
        scale_shape = (1,) * nc + self.features
        axes = tuple(axes) if axes else (None,) * len(shape)
        self.kernel_q = _named(nn.Parameter(
            torch.zeros(shape, dtype=torch.int8, device=device),
            requires_grad=False), axes)
        self.kernel_scale = _named(nn.Parameter(
            torch.ones(scale_shape, dtype=torch.bfloat16, device=device),
            requires_grad=False), (None,) * nc + axes[nc:])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # sizes from the kernel: a tensor-parallel shard computes its block
        nc = len(self.contract)
        shape = self.kernel_q.shape
        w = self.kernel_q.to(self.dtype) * self.kernel_scale.to(self.dtype)
        k = prod(shape[:nc])
        lead = x.shape[:x.dim() - nc]
        out = x.to(self.dtype).reshape(-1, k) @ w.reshape(k, -1)
        return out.reshape(lead + shape[nc:])


class StackedInt8Linear(nn.Module):
    """Int8Linear for stacked expert kernels, the layout the reference's
    quantize_params gives them: `kernel_q` [E, K, N] int8 and per-expert,
    per-output-channel `kernel_scale` [E, 1, N] bf16.  x [E, ..., K] ->
    [E, ..., N], dequantized in `dtype` and multiplied per expert."""

    def __init__(self, experts: int, contract: int, features: int,
                 dtype=torch.bfloat16, device="cuda", axes=None):
        super().__init__()
        self.contract, self.features, self.dtype = contract, features, dtype
        axes = tuple(axes) if axes else (None, None, None)
        self.kernel_q = _named(nn.Parameter(
            torch.zeros((experts, contract, features), dtype=torch.int8,
                        device=device), requires_grad=False), axes)
        self.kernel_scale = _named(nn.Parameter(
            torch.ones((experts, 1, features), dtype=torch.bfloat16,
                       device=device), requires_grad=False),
            (axes[0], None, axes[2]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # sizes from the kernel: an expert/tensor shard computes its block
        e, contract, features = self.kernel_q.shape
        w = self.kernel_q.to(self.dtype) * self.kernel_scale.to(self.dtype)
        lead = x.shape[1:-1]
        out = torch.bmm(x.to(self.dtype).reshape(e, -1, contract), w)
        return out.reshape((e,) + lead + (features,))


class Int4Linear(nn.Module):
    """The port of Int4DenseGeneral: a bias-free dense layer with 4-bit
    weights packed two per int8 byte, in the reference's stored layout.

    On a CUDA tensor the matmul always goes through the hand-written
    kernel (ops/int4_matmul.py); on a CPU tensor through its plain
    version.  `plain = True` sends a CUDA tensor through the plain version
    as well, so a check on the card can hold the kernel path against it.

    `axes` are the dense kernel's logical axes; the packed kernel and the
    scales record `int4_axes` of them.  A tensor-parallel shard takes its
    K from the packed rows and its N from the columns: the output has
    `features` but for the dim the column cut splits."""

    def __init__(self, contract: Union[int, Sequence[int]],
                 features: Union[int, Sequence[int]],
                 dtype=torch.bfloat16, device="cuda", axes=None):
        super().__init__()
        self.contract, self.features = _as_tuple(contract), _as_tuple(features)
        self.dtype = dtype
        self.plain = False
        flat_in, flat_out = prod(self.contract), prod(self.features)
        if flat_in % (2 * INT4_GROUP) != 0:
            raise ValueError(f"contract size {flat_in} not divisible by "
                             f"2*INT4_GROUP={2 * INT4_GROUP}")
        rows, cols = int4_axes(axes, len(self.contract))
        # the feature dim a column cut splits
        self.split = (tuple(axes[len(self.contract):]).index(cols)
                      if cols is not None else 0)
        self.kernel_q4 = _named(nn.Parameter(
            torch.zeros((flat_in // 2, flat_out), dtype=torch.int8,
                        device=device), requires_grad=False), (rows, cols))
        self.kernel_scale = _named(nn.Parameter(
            torch.ones((flat_in // INT4_GROUP, 1, flat_out),
                       dtype=torch.bfloat16, device=device),
            requires_grad=False), (rows, None, cols))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = 2 * self.kernel_q4.shape[0]
        lead = x.shape[:x.dim() - len(self.contract)]
        x2 = x.to(self.dtype).reshape(-1, k)
        if self.plain:
            out = int4_matmul_reference(x2, self.kernel_q4, self.kernel_scale)
        else:
            out = int4_matmul(x2.contiguous(), self.kernel_q4,
                              self.kernel_scale)
        features = list(self.features)
        features[self.split] = -1
        return out.reshape(lead + tuple(features))


# ---------------------------------------------------------------------------
# quantizers over the reference param tree layout


def _quantize_kernel(kernel: torch.Tensor, lead: int = 0,
                     n_contract: int = 1) -> dict:
    """Symmetric per-output-channel absmax int8 (the reference's
    _quantize_kernel): one scale per feature coordinate, reduced over the
    `n_contract` dims after `lead` stacked axes."""
    k32 = kernel.to(torch.float32)
    dims = tuple(range(lead, lead + n_contract))
    absmax = torch.amax(torch.abs(k32), dim=dims, keepdim=True)
    scale = torch.clamp_min(absmax / 127.0, 1e-12)
    q = torch.clamp(torch.round(k32 / scale), -127, 127).to(torch.int8)
    return {"kernel_q": q, "kernel_scale": scale.to(torch.bfloat16)}


def quantize_params(params, skip: tuple = ("embed", "router")) -> dict:
    """Param tree -> the tree Int8Linear layers load: every dict holding a
    `kernel` becomes {kernel_q, kernel_scale}; subtrees named in `skip`
    and other leaves pass through.  A stacked `layers` (or `experts`)
    subtree keeps its leading axis per slice."""
    def walk(node, name="", lead=0):
        if isinstance(node, Mapping):
            if name in skip:
                return node
            if "kernel" in node and not isinstance(node["kernel"], Mapping):
                kernel = node["kernel"]
                n_contract = 2 if (name == "out"
                                   and kernel.dim() - lead == 3) else 1
                rest = {k: v for k, v in node.items() if k != "kernel"}
                return {**rest, **_quantize_kernel(kernel, lead, n_contract)}
            return {k: walk(v, k,
                            lead + (1 if k in ("layers", "experts") else 0))
                    for k, v in node.items()}
        return node

    return walk(params)


def quantize_kernel_int4(kernel: torch.Tensor, n_contract: int = 1) -> dict:
    """Kernel [contract..., features...] -> {kernel_q4 [K/2, N] int8,
    kernel_scale [K/64, 1, N] bf16}, byte-identical to the reference's
    numpy _quantize_kernel_int4 (round half to even, clip to [-8, 7]) on
    either device.  `n_contract` leading dims are contracted (2 for the
    attention out projection [heads, head_dim, embed])."""
    k32 = kernel.to(torch.float32)
    n_in = prod(k32.shape[:n_contract])
    flat = k32.reshape(n_in, -1)
    n_out = flat.shape[1]
    g = flat.reshape(n_in // INT4_GROUP, INT4_GROUP, n_out)
    absmax = torch.amax(torch.abs(g), dim=1, keepdim=True)
    scale = torch.clamp_min(absmax / 7.0, 1e-12)
    q = torch.clamp(torch.round(g / scale), -8, 7).to(torch.int32)
    q = q.reshape(n_in, n_out)
    packed = ((q[1::2] << 4) | (q[0::2] & 0x0F)).to(torch.int8)
    return {"kernel_q4": packed, "kernel_scale": scale.to(torch.bfloat16)}


def quantize_params_int4(params, skip: tuple = ("embed", "router")) -> dict:
    """Param tree -> the Int4Linear tree.  MoE trees are rejected: the flat
    packed layout does not cover stacked expert kernels.  A stacked
    `layers` tree is unrolled to `layer_i` first (decode always unrolls)."""
    def has_experts(node) -> bool:
        return isinstance(node, Mapping) and any(
            k == "experts" or has_experts(v) for k, v in node.items())

    if has_experts(params):
        raise ValueError(
            "quantize_params_int4 cannot quantize MoE expert kernels: the "
            "flat nibble-packed layout does not cover stacked experts.  Use "
            "quantize_params (int8) for MoE serving.")
    if "layers" in params:
        from .generate import unroll_params

        params = unroll_params(params)

    def walk(node, name=""):
        if isinstance(node, Mapping):
            if name in skip:
                return node
            if "kernel" in node and not isinstance(node["kernel"], Mapping):
                rest = {k: v for k, v in node.items() if k != "kernel"}
                kernel = node["kernel"]
                n_contract = 2 if name == "out" and kernel.dim() == 3 else 1
                return {**rest, **quantize_kernel_int4(kernel, n_contract)}
            return {k: walk(v, k) for k, v in node.items()}
        return node

    return walk(params)


def fill_random(model: nn.Module, generator: torch.Generator,
                std: float = 0.02) -> int:
    """Random weights for a quantized decoder, made and quantized leaf by
    leaf on the model's device, so no float copy of the whole model is
    ever held: every leaf N(0, std^2) (the embedding, norm scales and any
    bf16 kernel included), each int4 kernel drawn in bf16 and quantized
    where it lies.  Decode speed does not depend on the values.  Returns
    the bytes of the int4 layers, packed weights and scales: what a
    decode step streams through them."""
    from .transformer import DenseGeneral, Embed, RMSNorm

    leaves = {Embed: "embedding", RMSNorm: "scale", DenseGeneral: "kernel"}
    streamed = 0
    with torch.no_grad():
        for mod in model.modules():
            name = leaves.get(type(mod))
            if name is not None:
                leaf = getattr(mod, name)
                leaf.copy_(torch.randn(leaf.shape, generator=generator,
                                       device=leaf.device) * std)
            if not isinstance(mod, Int4Linear):
                continue
            w = torch.randn(mod.contract + mod.features, generator=generator,
                            device=mod.kernel_q4.device) * std
            q = quantize_kernel_int4(w.to(torch.bfloat16), len(mod.contract))
            mod.kernel_q4.copy_(q["kernel_q4"])
            mod.kernel_scale.copy_(q["kernel_scale"])
            streamed += mod.kernel_q4.numel() + mod.kernel_scale.numel() * 2
    return streamed


def quantized_bytes(params, exclude: tuple = ("embed",)) -> int:
    """Bytes one decode step streams with the tree: every leaf outside the
    subtrees named in `exclude` (the embedding is a row lookup, not a
    stream).  Pass exclude=() for the resident bytes."""
    def walk(node, name=""):
        if isinstance(node, Mapping):
            if name in exclude:
                return 0
            return sum(walk(v, k) for k, v in node.items())
        return node.numel() * node.element_size()

    return walk(params)


__all__ = ["INT4_GROUP", "Int4Linear", "Int8Linear", "StackedInt8Linear",
           "fill_random", "int4_axes", "quantize_kernel_int4",
           "quantize_params", "quantize_params_int4", "quantized_bytes"]
