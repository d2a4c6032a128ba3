"""Causal flash attention: the Hopper kernels and their plain versions.

`flash_attention(q, k, v, scale)` computes softmax(Q K^T * scale) V over
[B, S, H, D] tensors (k and v with KVH <= H heads, H % KVH == 0), causal
with the mask top-left aligned, and is differentiable:

- On a CUDA tensor it launches the hand-written sm_90a kernels of
  `csrc/flash_attention.cu`: `flash_fwd` (q, k, v -> o, lse), and in the
  backward `flash_bwd_dkv` and `flash_bwd_dq` (from q, k, v, dO, lse and
  di = rowsum(dO * O), which is computed here in plain torch, as the
  reference computes it outside its kernels).  They are built with nvcc at
  first use into `build/kernels/` and bound through ctypes
  (`ops/_build.py`).  A shape, dtype or layout the kernels do not take,
  a failed build or a failed launch raises; nothing falls back.
- On a CPU tensor it runs the plain versions, `flash_forward_reference`
  and `flash_backward_reference`, which keep the kernels' algorithm and
  rounding points: fp32 scores (fp64 for fp64 inputs), P rounded to the
  input dtype before the PV product, the backward recomputing P from the
  log-sum-exp and forming dS = P * (dP - di) * scale.

Grouped-query attention: the forward and dQ kernels read kv head
h // (H / KVH) in place; the dK/dV kernel sums the query heads of each kv
head itself.  The plain versions repeat k and v and sum the groups.

The forward runs as the custom op `kubeflow_tpu_torch::flash_fwd`, so a
selective-checkpoint policy can name its outputs (the decoder's "attn"
remat policy keeps them, and the recompute then skips the forward).

`launches` counts each kernel's launches, so a run can show that its path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import sys
from typing import Optional

import torch

from . import CallableModule, _build

SOURCE = _build.CSRC / "flash_attention.cu"
HEAD_DIMS = (64, 128, 256)   # head dims the kernels are built for
SEQ_TILE = 64           # the kernels' sequence tile: S must be a multiple

launches = {"fwd": 0, "dkv": 0, "dq": 0}  # kernel launches since import


def _repeat_kv(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    if x.shape[2] == num_heads:
        return x
    return torch.repeat_interleave(x, num_heads // x.shape[2], dim=2)


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _scores(q, k, scale: float, causal: bool, cdt) -> torch.Tensor:
    """[B, H, Sq, Sk] scaled scores in `cdt`, -inf above the diagonal."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(cdt),
                     _repeat_kv(k, q.shape[2]).to(cdt)) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        above = torch.ones((sq, sk), dtype=torch.bool,
                           device=s.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    return s


def flash_forward_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float,
                            causal: bool = True):
    """The plain forward: (o [B, S, H, D] in q's dtype, lse [B, H, S] fp32,
    fp64 for fp64 inputs).  P = exp(s - rowmax) is rounded to v's dtype
    before the PV product and the sum divided out after it, as the kernel
    (and the Pallas kernel) do."""
    cdt = _compute_dtype(q.dtype)
    s = _scores(q, k, scale, causal, cdt)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(cdt),
                     _repeat_kv(v, q.shape[2]).to(cdt))
    o = o / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def row_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(dO * O) in fp32 (fp64 for fp64 inputs), [B, H, S]."""
    cdt = _compute_dtype(o.dtype)
    return (do.to(cdt) * o.to(cdt)).sum(dim=-1).transpose(1, 2).contiguous()


def _probs(q, k, lse, scale: float, causal: bool, cdt) -> torch.Tensor:
    """P = exp(s - lse), [B, H, Sq, Sk]: the forward's probabilities."""
    return torch.exp(_scores(q, k, scale, causal, cdt)
                     - lse.to(cdt)[..., None])


def _dscores(q, k, v, do, lse, di, scale: float, causal: bool, cdt):
    """(P, dS): dS = P (dP - di) * scale with dP = dO V^T, rounded to the
    input dtype, as the kernels feed it to the tensor cores."""
    p = _probs(q, k, lse, scale, causal, cdt)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(cdt),
                      _repeat_kv(v, q.shape[2]).to(cdt))
    ds = p * (dp - di.to(cdt)[..., None]) * scale
    return p, ds.to(q.dtype).to(cdt)


def _sum_groups(x: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """[B, S, H, D] per query head -> [B, S, KVH, D], each kv head's
    query heads summed."""
    batch, seq, heads, dim = x.shape
    return x.reshape(batch, seq, kv_heads, heads // kv_heads, dim).sum(3)


def flash_bwd_dkv_reference(q, k, v, do, lse, di, scale: float,
                            causal: bool = True):
    """The plain dK/dV: dV = P^T dO with P rounded to the input dtype,
    dK = dS^T Q; the query heads of a kv head summed, rounded once."""
    cdt = _compute_dtype(q.dtype)
    p, ds = _dscores(q, k, v, do, lse, di, scale, causal, cdt)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).to(cdt), do.to(cdt))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(cdt))
    kv_heads = k.shape[2]
    return (_sum_groups(dk, kv_heads).to(k.dtype),
            _sum_groups(dv, kv_heads).to(v.dtype))


def flash_bwd_dq_reference(q, k, v, do, lse, di, scale: float,
                           causal: bool = True):
    """The plain dQ = dS K."""
    cdt = _compute_dtype(q.dtype)
    _, ds = _dscores(q, k, v, do, lse, di, scale, causal, cdt)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds,
                      _repeat_kv(k, q.shape[2]).to(cdt))
    return dq.to(q.dtype)


def flash_backward_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             scale: float, causal: bool = True):
    """The plain backward, the kernels' algorithm (not autograd of the
    einsums): P recomputed from lse, di = rowsum(dO * O), dS = P (dP -
    di) * scale; returns (dq, dk, dv)."""
    di = row_dot(o, do)
    dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, di, scale, causal)
    dq = flash_bwd_dq_reference(q, k, v, do, lse, di, scale, causal)
    return dq, dk, dv


def unsupported(q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> Optional[str]:
    """Why the kernels cannot take these tensors, or None if they can
    (device aside)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        return (f"want q [B, S, H, D] and k, v [B, S, KVH, D]; got "
                f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    batch, seq, heads, dim = q.shape
    if k.shape[0] != batch or k.shape[3] != dim:
        return f"q {tuple(q.shape)} and k {tuple(k.shape)} do not match"
    if k.shape[1] != seq:
        return f"the kernels want q_len == kv_len; got {seq}, {k.shape[1]}"
    if seq % SEQ_TILE:
        return f"sequence {seq} is not a multiple of {SEQ_TILE}"
    if dim not in HEAD_DIMS:
        return f"head dim {dim} is not one of {HEAD_DIMS}"
    if heads % k.shape[2]:
        return f"{heads} query heads do not split into {k.shape[2]} kv heads"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            return f"the kernels take bf16; {name} is {t.dtype}"
    return None


def _layout_error(name: str, t: torch.Tensor) -> Optional[str]:
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
        return (f"{name} must have a contiguous last dim and batch, seq "
                f"and head strides that are multiples of 8; got "
                f"{t.stride()}")
    if t.data_ptr() % 16:
        return f"{name} must be 16-byte aligned"
    return None


def _check_cuda(**tensors) -> None:
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        err = _layout_error(name, t)
        if err:
            raise ValueError(f"flash attention kernel: {err}")


def _strides(t: torch.Tensor) -> tuple:
    return tuple(t.stride()[:3])


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, causal: bool = True):
    """Launch flash_fwd: (o [B, S, H, D] bf16, lse [B, H, S] fp32)."""
    err = unsupported(q, k, v)
    if err:
        raise ValueError(f"flash attention kernel: {err}")
    _check_cuda(q=q, k=k, v=v)
    batch, seq, heads, dim = q.shape
    o = torch.empty((batch, seq, heads, dim), dtype=torch.bfloat16,
                    device=q.device)
    lse = torch.empty((batch, heads, seq), dtype=torch.float32,
                      device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), batch, seq, heads, k.shape[2], dim, int(causal),
            scale, *_strides(q), *_strides(k), *_strides(v), stream)
    _raise_on(rc, "flash_fwd", q.shape, k.shape)
    launches["fwd"] += 1
    return o, lse


def _bwd_args(q, k, v, do, lse, di, scale: float, causal: bool):
    err = unsupported(q, k, v)
    if err:
        raise ValueError(f"flash attention kernel: {err}")
    _check_cuda(q=q, k=k, v=v, do=do)
    for name, t in (("lse", lse), ("di", di)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.shape != (q.shape[0], q.shape[2], q.shape[1]):
            raise ValueError(f"{name} must be contiguous fp32 [B, H, S]")
    batch, seq, heads, dim = q.shape
    return (batch, seq, heads, k.shape[2], dim, int(causal), scale,
            *_strides(q), *_strides(k), *_strides(v), *_strides(do))


def flash_bwd_dkv(q, k, v, do, lse, di, scale: float, causal: bool = True):
    """Launch flash_bwd_dkv: (dk, dv) [B, S, KVH, D] bf16."""
    args = _bwd_args(q, k, v, do, lse, di, scale, causal)
    dk = torch.empty(k.shape, dtype=torch.bfloat16, device=q.device)
    dv = torch.empty_like(dk)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dkv_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *args, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "flash_bwd_dkv", q.shape, k.shape)
    launches["dkv"] += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, di, scale: float, causal: bool = True):
    """Launch flash_bwd_dq: dq [B, S, H, D] bf16."""
    args = _bwd_args(q, k, v, do, lse, di, scale, causal)
    dq = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dq_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), *args,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "flash_bwd_dq", q.shape, k.shape)
    launches["dq"] += 1
    return dq


def flash_backward(q, k, v, o, lse, do, scale: float, causal: bool = True):
    """di in plain torch, then the dK/dV and dQ kernels: (dq, dk, dv)."""
    do = do.contiguous()
    di = row_dot(o, do)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, scale, causal)
    return flash_bwd_dq(q, k, v, do, lse, di, scale, causal), dk, dv


def _raise_on(rc: int, kernel: str, q_shape, k_shape) -> None:
    if rc != 0:
        what = {-1: "bad shape", -2: "TMA descriptor not encoded"}.get(
            rc, f"CUDA error {rc}")
        raise RuntimeError(f"{kernel} launch failed ({what}) at q "
                           f"{tuple(q_shape)}, k {tuple(k_shape)}")


@torch.library.custom_op("kubeflow_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float, causal: bool) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """The forward as one op: the kernel on CUDA, the plain version on
    the CPU."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return flash_forward(q, k, v, scale, causal)


class FlashAttention(torch.autograd.Function):
    """o = flash_attention(q, k, v); the backward from (q, k, v, o, lse):
    the two backward kernels on CUDA, the plain backward on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        o, lse = torch.ops.kubeflow_tpu_torch.flash_fwd(q, k, v, scale,
                                                         causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_backward_reference(q, k, v, o, lse, do, ctx.scale,
                                             ctx.causal)
        else:
            grads = flash_backward(q, k, v, o, lse, do, ctx.scale,
                                   ctx.causal)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None,
                    causal: bool = True) -> torch.Tensor:
    """[B, S, H, D] attention through the kernels (CUDA) or their plain
    versions (CPU); scale defaults to D ** -0.5."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return FlashAttention.apply(q, k, v, scale, causal)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    ptr, i32, f32, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_longlong)
    lib.flash_fwd_bf16.argtypes = ([ptr] * 5 + [i32] * 6 + [f32]
                                   + [i64] * 9 + [ptr])
    lib.flash_bwd_dkv_bf16.argtypes = ([ptr] * 8 + [i32] * 6 + [f32]
                                       + [i64] * 12 + [ptr])
    lib.flash_bwd_dq_bf16.argtypes = ([ptr] * 7 + [i32] * 6 + [f32]
                                      + [i64] * 12 + [ptr])
    for fn in (lib.flash_fwd_bf16, lib.flash_bwd_dkv_bf16,
               lib.flash_bwd_dq_bf16):
        fn.restype = ctypes.c_int
    return lib


__all__ = ["FlashAttention", "HEAD_DIMS", "SEQ_TILE", "SOURCE",
           "flash_attention", "flash_backward", "flash_backward_reference",
           "flash_bwd_dkv", "flash_bwd_dkv_reference", "flash_bwd_dq",
           "flash_bwd_dq_reference", "flash_forward",
           "flash_forward_reference", "launches", "row_dot", "unsupported"]

# the package exports this module under the name of its `flash_attention`
# function (ops/__init__.py): calling the module calls the function
sys.modules[__name__].__class__ = CallableModule
