"""Differentiable collectives for the model-parallel regions.

Two kinds of group meet in a sharded step, and their backwards differ:

- Over `tensor` and `expert` every rank holds the same tokens and the
  same loss.  A replicated value entering a region that each rank
  computes a part of goes through `copy_to` (forward identity, backward
  all-reduce of the parts' gradients), and partial results leave through
  `reduce_from` (forward all-reduce, backward identity) or `gather_from`
  (forward all-gather, backward this rank's slice of the gradient, which
  every rank holds alike): Megatron's f and g.
- Over `data`, `fsdp` and `sequence` each rank holds its own tokens and
  its own loss, and the step averages the ranks' gradients.  A gather
  there (`gather_seq`) sums, in the backward, what every rank's loss
  sends back to this rank's slice (reduce-scatter), and `mean_over`
  averages a value across the ranks in both directions.

Every function takes group None (no mesh, or a degree of 1) and then
returns its input untouched, so a one-device run takes no extra op.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.group, ctx.dim), None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _slice(_all_reduce(grad, ctx.group), ctx.group,
                      ctx.dim), None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        for group in groups:
            x = _all_reduce(x, group) / dist.get_world_size(group)
        return x

    @staticmethod
    def backward(ctx, grad):
        for group in ctx.groups:
            grad = _all_reduce(grad, group) / dist.get_world_size(group)
        return grad, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Enter a tensor- or expert-parallel region (Megatron's f)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum the region's partial results (Megatron's g)."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate the region's blocks along `dim` on every rank."""
    return x if group is None else _GatherFrom.apply(x, group, dim)


def gather_seq(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather along `dim` over ranks that hold their own losses; the
    backward reduce-scatters."""
    return x if group is None else _GatherSeq.apply(x, group, dim)


def mean_over(x: torch.Tensor, groups) -> torch.Tensor:
    """The mean of `x` over the ranks of every group in `groups` (Nones
    skipped), averaging the gradient back the same way."""
    groups = tuple(g for g in groups if g is not None)
    return _MeanOver.apply(x, groups) if groups else x


def take_block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of a tensor every rank of `group` holds alike."""
    return x if group is None else x.chunk(
        dist.get_world_size(group), dim=dim)[dist.get_rank(group)]


__all__ = ["copy_to", "gather_from", "gather_seq", "mean_over",
           "reduce_from", "take_block"]
