"""Mixture-of-Experts MLP: the port of kubeflow_tpu/models/moe.py.

A router (fp32, on fp32 inputs) picks each token's top-k experts and
renormalizes their probabilities; tokens go into fixed-capacity
per-expert buffers, the experts' gated MLPs run as batched products over
the expert axis, and each token sums its experts' outputs weighted by
the gate values.  A (token, choice) past its expert's capacity is
dropped: its weight is zero and the residual stream carries the token on.
The load-balance loss (Switch Transformers eq. 4) comes back beside the
output.

Dispatch modes (cfg.moe_dispatch), each with the reference's semantics:
- "einsum": GShard's one-hot dispatch and combine products; capacity per
  batch row, over the row's flattened (S, k) dispatch order;
- "hybrid": the same dispatch, combined by gathering each (token,
  choice)'s row of the expert output (BENCH_MOE's mode);
- "sort": a stable argsort by expert, a scatter-add into the buffers and
  a gather plus fp32 scatter-add back; capacity is global over the batch.

The expert weights are stacked, as the reference's vmapped experts store
them: gate and up [E, D, M], down [E, M, D] (`StackedDense`), or int8
with per-expert, per-output-channel scales [E, 1, M]
(`quant.StackedInt8Linear`).  None of this runs a hand-written kernel:
the reference computes it with XLA ops, so here it is PyTorch ops.

On a mesh (the reference's expert-parallel layout, where the batch is
sharded over data and fsdp only, so every rank of an expert group holds
the same tokens):
- each expert rank holds E/ep experts' stacked weights, their MLP hidden
  dim split over "tensor" (gate/up column-, down row-parallel);
- the router, top-k, capacity and the [E, B, C, D] buffers are computed
  alike on every rank of the group; each rank runs its experts on its
  slice of the buffer;
- "einsum" combines each rank's slice into a partial output and sums
  the partials over the expert group; "hybrid" and "sort", whose combine
  gathers rows of any expert, all-gather the expert outputs first (what
  the reference's SPMD partitioner makes of their gathers);
- the load-balance loss takes its means over the whole batch (an
  all-reduce over data and fsdp), as the reference's global arrays do;
- on a sequence-sharded mesh the layer all-gathers the sequence first,
  since capacity counts over each batch row's full sequence, and keeps
  its own block of the output; "sort", whose capacity counts over the
  whole batch, all-gathers the rows over data and fsdp as well;
- a decode config (models/generate.py) runs the same layer on its rank's
  rows of the batch (all of them under "sort"): the expert stack split
  over "expert", each expert's hidden dim over "tensor", and the
  sequence, which decode replicates, taken whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.profiler import record_function

from ..parallel.collectives import (
    copy_to,
    gather_from,
    gather_seq,
    mean_over,
    reduce_from,
    take_block,
)
from ..parallel.mesh import axis_group
from .configs import TransformerConfig
from .quant import StackedInt8Linear
from .transformer import DenseGeneral, logical, torch_dtype


def load_balance_loss(probs: torch.Tensor, expert_mask: torch.Tensor,
                      groups: tuple = ()) -> torch.Tensor:
    """Switch Transformers eq. 4 in fp32: num_experts * sum_e(f_e * P_e),
    f_e the fraction of tokens whose top-1 choice is e, P_e the mean
    router probability of e.  1.0 under uniform routing.  With `groups`
    (process groups whose ranks hold other tokens of the batch) the means
    are over the tokens of all of them."""
    num_experts = probs.shape[-1]
    f = expert_mask.to(torch.float32).reshape(-1, num_experts).mean(0)
    p = probs.to(torch.float32).reshape(-1, num_experts).mean(0)
    with torch.no_grad():
        f = mean_over(f, groups)
    return num_experts * torch.sum(f * mean_over(p, groups))


def one_hot(index: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """jax.nn.one_hot: an index outside [0, n) gives a row of zeros."""
    classes = torch.arange(n, device=index.device)
    return (index.unsqueeze(-1) == classes).to(dtype)


class StackedDense(nn.Module):
    """One bias-free dense layer per expert, kernels stacked as [E, K, N]:
    x [E, ..., K] -> [E, ..., N], a batched product in `dtype`."""

    def __init__(self, experts: int, contract: int, features: int,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 device="cuda", axes=None):
        super().__init__()
        self.contract, self.features, self.dtype = contract, features, dtype
        self.kernel = logical(nn.Parameter(torch.zeros(
            (experts, contract, features), dtype=param_dtype,
            device=device)), axes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # sizes from the kernel: an expert/tensor shard computes its block
        e, contract, features = self.kernel.shape
        lead = x.shape[1:-1]
        out = torch.bmm(x.to(self.dtype).reshape(e, -1, contract),
                        self.kernel.to(self.dtype))
        return out.reshape((e,) + lead + (features,))


def _stacked(experts: int, contract: int, features: int,
             cfg: TransformerConfig, device, axes: tuple) -> nn.Module:
    dtype = torch_dtype(cfg.dtype)
    if cfg.weight_dtype == "int8":
        return StackedInt8Linear(experts, contract, features, dtype, device,
                                 axes)
    if cfg.weight_dtype:
        raise ValueError(f"expert layers take weight_dtype '' or 'int8', "
                         f"not {cfg.weight_dtype!r}")
    return StackedDense(experts, contract, features, dtype,
                        torch_dtype(cfg.param_dtype), device, axes)


class ExpertFFN(nn.Module):
    """Every expert's gated MLP at once: [E, ..., D] -> [E, ..., D]; on a
    tensor mesh the hidden dim is split and the output all-reduced."""

    def __init__(self, cfg: TransformerConfig, device="cuda", mesh=None):
        super().__init__()
        e, d = cfg.moe_experts, cfg.embed_dim
        m = cfg.moe_mlp_dim or cfg.mlp_dim
        self.mesh = mesh
        self.gate = _stacked(e, d, m, cfg, device, ("expert", "embed", "mlp"))
        self.up = _stacked(e, d, m, cfg, device, ("expert", "embed", "mlp"))
        self.down = _stacked(e, m, d, cfg, device, ("expert", "mlp", "embed"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = axis_group(self.mesh, "tensor")
        x = copy_to(x, tp)
        return reduce_from(self.down(F.silu(self.gate(x)) * self.up(x)), tp)


class MoEMLP(nn.Module):
    """Drop-in MLP replacement: [B, S, D] -> ([B, S, D], aux loss).

    Its stages run under profiler ranges (moe.router, moe.dispatch,
    moe.experts, moe.combine), so a trace shows where its time goes."""

    def __init__(self, cfg: TransformerConfig, device="cuda", mesh=None):
        super().__init__()
        if cfg.moe_dispatch not in ("einsum", "hybrid", "sort"):
            raise ValueError(f"unknown moe_dispatch {cfg.moe_dispatch!r}")
        self.cfg, self.mesh = cfg, mesh
        self.router = DenseGeneral(cfg.embed_dim, cfg.moe_experts,
                                   torch.float32, torch.float32, device,
                                   ("embed", None))
        self.experts = ExpertFFN(cfg, device, mesh)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg, mesh = self.cfg, self.mesh
        # decode replicates the sequence: every rank holds all of it
        sp = None if cfg.decode else axis_group(mesh, "sequence")
        x = gather_seq(x, sp, dim=1)
        # "sort" counts capacity over the whole batch: in training it
        # gathers the rows too (fsdp blocks inside data blocks); decode
        # holds the whole batch on every rank for it (models/generate.py)
        rows = [axis_group(mesh, a) for a in ("fsdp", "data")] \
            if cfg.moe_dispatch == "sort" and not cfg.decode else []
        for group in rows:
            x = gather_seq(x, group, dim=0)
        with record_function("moe.router"):
            probs = torch.softmax(self.router(x.to(torch.float32)), dim=-1)
            gate_vals, gate_idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
            gate_vals = gate_vals / torch.clamp_min(
                gate_vals.sum(-1, keepdim=True), 1e-9)
            top1 = one_hot(gate_idx[..., 0], cfg.moe_experts, torch.float32)
            aux = load_balance_loss(probs, top1, (
                axis_group(mesh, "data"), axis_group(mesh, "fsdp")))
        if cfg.moe_dispatch == "sort":
            out = self._sort_dispatch(x, gate_vals, gate_idx)
        else:
            out = self._buffer_dispatch(x, gate_vals, gate_idx)
        for group in reversed(rows):
            out = take_block(out, group, dim=0)
        return take_block(out, sp, dim=1), aux

    def _local_experts(self, expert_in: torch.Tensor) -> torch.Tensor:
        """[E, ...] buffers, alike on every expert rank -> this rank's
        experts' outputs [E/ep, ...]."""
        ep = axis_group(self.mesh, "expert")
        return self.experts(take_block(copy_to(expert_in, ep), ep, dim=0))

    def _all_experts(self, expert_in: torch.Tensor) -> torch.Tensor:
        """[E, ...] buffers -> every expert's outputs [E, ...] on every
        expert rank."""
        return gather_from(self._local_experts(expert_in),
                           axis_group(self.mesh, "expert"), dim=0)

    def _positions(self, gate_idx: torch.Tensor, capacity: int):
        """Per batch row, each (token, choice)'s slot in its expert's
        buffer: the running count over the row's flattened (S, k) order.
        Returns the choice one-hot [B, S, k, E], the slot of each choice
        under its expert and the kept mask (slot < capacity), both
        [B, S, k, E] fp32."""
        batch, seq, top_k = gate_idx.shape
        experts = self.cfg.moe_experts
        choice = one_hot(gate_idx, experts, torch.float32)
        flat = choice.reshape(batch, seq * top_k, experts)
        position = torch.cumsum(flat, dim=1) - flat
        within = (position < capacity).to(torch.float32) * flat
        shape = (batch, seq, top_k, experts)
        return choice, position.reshape(shape), within.reshape(shape)

    def _buffer_dispatch(self, x, gate_vals, gate_idx):
        """The einsum and hybrid modes: per-row capacity, one-hot dispatch
        into [E, B, C, D] buffers; the combine is the one-hot product
        (einsum) or a gather of each choice's row (hybrid)."""
        cfg = self.cfg
        batch, seq, _ = x.shape
        capacity = max(1, int(cfg.moe_capacity_factor * seq * cfg.moe_top_k
                              / cfg.moe_experts))
        with record_function("moe.dispatch"):
            choice, position, within = self._positions(gate_idx, capacity)
            if cfg.moe_dispatch == "einsum":
                slot = one_hot(position.to(torch.int64), capacity,
                               torch.float32)
                combine = (gate_vals[..., None, None] * within[..., None]
                           * slot).sum(2)                  # [B, S, E, C]
                dispatch = (combine > 0.0).to(x.dtype)
            else:
                pos_k = (position * choice).sum(-1).to(torch.int64)
                keep_k = within.sum(-1)                    # [B, S, k]
                slot_k = one_hot(pos_k, capacity, x.dtype)
                dispatch = torch.einsum("bske,bskc->bsec",
                                        within.to(x.dtype), slot_k)
            expert_in = torch.einsum("bsec,bsd->ebcd", dispatch, x)
        ep = axis_group(self.mesh, "expert")
        if cfg.moe_dispatch == "einsum":
            with record_function("moe.experts"):
                expert_out = self._local_experts(expert_in)  # [E/ep,B,C,D]
            with record_function("moe.combine"):
                mine = take_block(copy_to(combine, ep), ep, dim=2)
                return reduce_from(torch.einsum(
                    "bsec,ebcd->bsd", mine.to(expert_out.dtype),
                    expert_out), ep)
        with record_function("moe.experts"):
            expert_out = self._all_experts(expert_in)      # [E, B, C, D]
        with record_function("moe.combine"):
            # a dropped choice's slot lies past the buffer: read the last
            # row instead (its weight is zero), as JAX clamps the gather
            b_idx = torch.arange(batch, device=x.device)[:, None, None]
            rows = expert_out[gate_idx, b_idx,
                              pos_k.clamp(max=capacity - 1)]  # [B, S, k, D]
            weight = (gate_vals * keep_k).to(rows.dtype)
            return (rows * weight[..., None]).sum(2)

    def _sort_dispatch(self, x, gate_vals, gate_idx):
        """Sort by expert (stable, so token order holds within an expert),
        rank within each expert, scatter the first `capacity` into the
        buffers; after the experts, gather each choice's row and add it,
        weighted, into an fp32 output.  Capacity is global."""
        cfg = self.cfg
        experts, top_k = cfg.moe_experts, cfg.moe_top_k
        batch, seq, dim = x.shape
        tokens = batch * seq
        n = tokens * top_k
        capacity = max(1, int(cfg.moe_capacity_factor * tokens * top_k
                              / experts))
        with record_function("moe.dispatch"):
            xf = x.reshape(tokens, dim)
            e_flat = gate_idx.reshape(-1)                  # token-major
            g_flat = gate_vals.reshape(-1).to(torch.float32)
            tok = torch.arange(tokens, device=x.device
                               ).repeat_interleave(top_k)
            order = torch.argsort(e_flat, stable=True)
            e_s, tok_s, g_s = e_flat[order], tok[order], g_flat[order]
            counts = torch.bincount(e_flat, minlength=experts)
            starts = torch.cumsum(counts, 0) - counts
            rank = torch.arange(n, device=x.device) - starts[e_s]
            keep = rank < capacity
            # kept choices get their own slots; dropped ones add zeros
            # into their expert's last slot
            slot = e_s * capacity + rank.clamp(max=capacity - 1)
            gathered = torch.where(keep[:, None], xf[tok_s],
                                   torch.zeros((), dtype=x.dtype,
                                               device=x.device))
            expert_in = torch.zeros((experts * capacity, dim), dtype=x.dtype,
                                    device=x.device).index_add(
                0, slot, gathered).reshape(experts, capacity, dim)
        with record_function("moe.experts"):
            expert_out = self._all_experts(expert_in)      # [E, C, D]
        with record_function("moe.combine"):
            rows = expert_out.reshape(experts * capacity, dim)[slot]
            weighted = rows.to(torch.float32) * (g_s * keep)[:, None]
            out = torch.zeros((tokens, dim), dtype=torch.float32,
                              device=x.device).index_add(0, tok_s, weighted)
            return out.to(x.dtype).reshape(batch, seq, dim)


__all__ = ["ExpertFFN", "MoEMLP", "StackedDense", "load_balance_loss",
           "one_hot"]
