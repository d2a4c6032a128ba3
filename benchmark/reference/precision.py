"""The products' precision: float32 for the reference, and the control's
fp8, the step below bf16, as fp8 training runs a product: the operands
of the forward in e4m3, and the gradient that comes back into the
product in e5m2, each under one scale a tensor (its amax to the
format's largest).  So both backward products (dX = dY W^T and
dW = X^T dY) take fp8 operands too: the saved e4m3 operand and the
e5m2 gradient.

`EXACT.mm(a, b)` is `a @ b`; `FP8.mm(a, b)` rounds a and b, multiplies
in float32, and rounds the gradient of the result on its way back.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to the fp8 `dtype` under a per-tensor scale, back in
    x's dtype."""
    top = torch.finfo(dtype).max
    scale = top / x.abs().amax().float().clamp_min(1e-30)
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Operand(torch.autograd.Function):
    """e4m3 in the forward; the gradient passes on as it comes."""

    @staticmethod
    def forward(ctx, x):
        return rounded(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _Gradient(torch.autograd.Function):
    """Unchanged in the forward; the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        return rounded(grad, torch.float8_e5m2)


@dataclass(frozen=True)
class Precision:
    name: str
    lowered: bool

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return _Operand.apply(x) if self.lowered else x

    def result(self, y: torch.Tensor) -> torch.Tensor:
        return _Gradient.apply(y) if self.lowered and y.requires_grad else y

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.result(self.operand(a) @ self.operand(b))

    def einsum(self, equation: str, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
        return self.result(torch.einsum(equation, self.operand(a),
                                        self.operand(b)))


EXACT = Precision("fp32", False)
FP8 = Precision("fp8", True)
PRECISIONS = {p.name: p for p in (EXACT, FP8)}


def strict_fp32() -> None:
    """float32 products stay float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


__all__ = ["EXACT", "FP8", "PRECISIONS", "Precision", "rounded",
           "strict_fp32"]
