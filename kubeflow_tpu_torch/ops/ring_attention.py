"""Ring attention: exact causal attention over a sequence-sharded axis,
the port of kubeflow_tpu/ops/ring_attention.py.

Each rank of the `sequence` group holds a [B, S/n, H, D] block of q, k
and v (H the rank's own heads under tensor parallelism).  The k/v blocks
go round the ring, rank i to rank i+1, by point-to-point sends
(`batch_isend_irecv`), and each rank folds every block that visits it
into an online softmax in fp32 (flash-attention style max and sum
accumulators), so the [S, S] scores are never formed and k/v are never
gathered.  Causality comes from global position vectors that ride the
ring with their k/v block: the mask is a comparison of the query
positions with the visiting block's, so shifted or packed positions work
unchanged.  Fully masked blocks still go round, which keeps every rank's
sends in the same order.  Grouped-query k/v heads are repeated locally.

Autograd cannot differentiate through sends, so the backward is its own
ring (`RingAttention.backward`): from the saved log-sum-exp it recomputes
each visiting block's probabilities, adds the local queries' dQ, and
sends the block's dK/dV accumulators along with it, so after n hops each
rank holds the full dK/dV of its own block.  The block products are
plain torch, as they are einsums in the reference: no kernel here.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch
import torch.distributed as dist

from . import CallableModule


def _repeat(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, kvH, D] -> [B, S, H, D] in fp32."""
    x = x.to(torch.float32)
    if x.shape[2] == heads:
        return x
    return torch.repeat_interleave(x, heads // x.shape[2], dim=2)


def _sum_groups(x: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """[B, S, H, D] -> [B, S, kvH, D], each kv head's query heads summed."""
    b, s, h, d = x.shape
    return x.reshape(b, s, kv_heads, h // kv_heads, d).sum(3)


def ring_pass(tensors: list, group) -> list:
    """Send each tensor to the next rank of `group` and receive the
    previous rank's, all at once."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, prv, group) for t in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _scores(q32, k_blk, q_pos, kv_pos, scale: float,
            causal: bool) -> torch.Tensor:
    """[B, H, Sq, Sk] fp32 scores, -inf where a key lies after its query."""
    s = torch.einsum("bqhd,bkhd->bhqk", q32,
                     _repeat(k_blk, q32.shape[2])) * scale
    if causal:
        visible = q_pos[:, None, :, None] >= kv_pos[:, None, None, :]
        s = s.masked_fill(~visible, float("-inf"))
    return s


class RingAttention(torch.autograd.Function):
    """out = ring attention of the local blocks; see the module doc."""

    @staticmethod
    def forward(ctx, q, k, v, positions, group, scale, causal):
        n = 1 if group is None else dist.get_world_size(group)
        batch, q_len, heads, dim = q.shape
        q32 = q.to(torch.float32)
        acc = q32.new_zeros((batch, heads, q_len, dim))
        row_max = q32.new_full((batch, heads, q_len), float("-inf"))
        row_sum = q32.new_zeros((batch, heads, q_len))
        k_blk, v_blk, kv_pos = k, v, positions
        for step in range(n):
            s = _scores(q32, k_blk, positions, kv_pos, scale, causal)
            new_max = torch.maximum(row_max, s.amax(-1))
            # rows with nothing visible yet keep a -inf max: no NaNs
            corr = torch.where(torch.isfinite(row_max),
                               torch.exp(row_max - new_max), 0.0)
            p = torch.where(torch.isfinite(s),
                            torch.exp(s - new_max[..., None]), 0.0)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, _repeat(v_blk, heads))
            row_sum = row_sum * corr + p.sum(-1)
            row_max = new_max
            if step < n - 1:
                k_blk, v_blk, kv_pos = ring_pass([k_blk, v_blk, kv_pos],
                                                 group)
        out = acc / torch.clamp_min(row_sum, 1e-30)[..., None]
        lse = row_max + torch.log(row_sum)
        out = out.transpose(1, 2).to(q.dtype)
        ctx.save_for_backward(q, k, v, positions, out, lse)
        ctx.group, ctx.scale, ctx.causal = group, scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, positions, out, lse = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        n = 1 if group is None else dist.get_world_size(group)
        heads, kv_heads = q.shape[2], k.shape[2]
        q32 = q.to(torch.float32)
        do = dout.to(torch.float32)
        di = (do * out.to(torch.float32)).sum(-1).transpose(1, 2)  # [B,H,Sq]
        dq = torch.zeros_like(q32)
        k_blk, v_blk, kv_pos = k, v, positions
        dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_blk = torch.zeros_like(dk_blk)
        for step in range(n):
            s = _scores(q32, k_blk, positions, kv_pos, scale, ctx.causal)
            p = torch.exp(s - lse[..., None])
            v_rep = _repeat(v_blk, heads)
            dv_blk = dv_blk + _sum_groups(
                torch.einsum("bhqk,bqhd->bkhd", p, do), kv_heads)
            dp = torch.einsum("bqhd,bkhd->bhqk", do, v_rep)
            ds = p * (dp - di[..., None]) * scale
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds,
                                   _repeat(k_blk, heads))
            dk_blk = dk_blk + _sum_groups(
                torch.einsum("bhqk,bqhd->bkhd", ds, q32), kv_heads)
            if step < n - 1:
                k_blk, v_blk, kv_pos, dk_blk, dv_blk = ring_pass(
                    [k_blk, v_blk, kv_pos, dk_blk, dv_blk], group)
            elif n > 1:
                # one more hop brings each block's gradients home
                dk_blk, dv_blk = ring_pass([dk_blk, dv_blk], group)
        return (dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype),
                None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   positions: Optional[torch.Tensor] = None, group=None,
                   causal: bool = True,
                   softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel exact attention of this rank's [B, S/n, H, D]
    blocks over the ranks of `group` (the mesh's "sequence" group; None
    for one rank).  positions [B, S/n] are the block's global token
    positions (default: the block of an unsharded sequence starting at
    0, which is right only for group None)."""
    if positions is None:
        positions = torch.arange(q.shape[1], device=q.device
                                 ).expand(q.shape[:2])
    scale = softmax_scale if softmax_scale is not None \
        else q.shape[-1] ** -0.5
    return RingAttention.apply(q, k, v, positions.contiguous(), group,
                               scale, causal)


__all__ = ["RingAttention", "ring_attention", "ring_pass"]

# the package exports this module under the name of its `ring_attention`
# function (ops/__init__.py): calling the module calls the function
sys.modules[__name__].__class__ = CallableModule
