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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.profiler import record_function

from .configs import TransformerConfig
from .quant import StackedInt8Linear
from .transformer import DenseGeneral, torch_dtype


def load_balance_loss(probs: torch.Tensor,
                      expert_mask: torch.Tensor) -> torch.Tensor:
    """Switch Transformers eq. 4 in fp32: num_experts * sum_e(f_e * P_e),
    f_e the fraction of tokens whose top-1 choice is e, P_e the mean
    router probability of e.  1.0 under uniform routing."""
    num_experts = probs.shape[-1]
    f = expert_mask.to(torch.float32).reshape(-1, num_experts).mean(0)
    p = probs.to(torch.float32).reshape(-1, num_experts).mean(0)
    return num_experts * torch.sum(f * p)


def one_hot(index: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """jax.nn.one_hot: an index outside [0, n) gives a row of zeros."""
    classes = torch.arange(n, device=index.device)
    return (index.unsqueeze(-1) == classes).to(dtype)


class StackedDense(nn.Module):
    """One bias-free dense layer per expert, kernels stacked as [E, K, N]:
    x [E, ..., K] -> [E, ..., N], a batched product in `dtype`."""

    def __init__(self, experts: int, contract: int, features: int,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.contract, self.features, self.dtype = contract, features, dtype
        self.kernel = nn.Parameter(torch.zeros(
            (experts, contract, features), dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e, lead = x.shape[0], x.shape[1:-1]
        out = torch.bmm(x.to(self.dtype).reshape(e, -1, self.contract),
                        self.kernel.to(self.dtype))
        return out.reshape((e,) + lead + (self.features,))


def _stacked(experts: int, contract: int, features: int,
             cfg: TransformerConfig, device) -> nn.Module:
    dtype = torch_dtype(cfg.dtype)
    if cfg.weight_dtype == "int8":
        return StackedInt8Linear(experts, contract, features, dtype, device)
    if cfg.weight_dtype:
        raise ValueError(f"expert layers take weight_dtype '' or 'int8', "
                         f"not {cfg.weight_dtype!r}")
    return StackedDense(experts, contract, features, dtype,
                        torch_dtype(cfg.param_dtype), device)


class ExpertFFN(nn.Module):
    """Every expert's gated MLP at once: [E, ..., D] -> [E, ..., D]."""

    def __init__(self, cfg: TransformerConfig, device="cuda"):
        super().__init__()
        e, d = cfg.moe_experts, cfg.embed_dim
        m = cfg.moe_mlp_dim or cfg.mlp_dim
        self.gate = _stacked(e, d, m, cfg, device)
        self.up = _stacked(e, d, m, cfg, device)
        self.down = _stacked(e, m, d, cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class MoEMLP(nn.Module):
    """Drop-in MLP replacement: [B, S, D] -> ([B, S, D], aux loss).

    Its stages run under profiler ranges (moe.router, moe.dispatch,
    moe.experts, moe.combine), so a trace shows where its time goes."""

    def __init__(self, cfg: TransformerConfig, device="cuda"):
        super().__init__()
        if cfg.moe_dispatch not in ("einsum", "hybrid", "sort"):
            raise ValueError(f"unknown moe_dispatch {cfg.moe_dispatch!r}")
        self.cfg = cfg
        self.router = DenseGeneral(cfg.embed_dim, cfg.moe_experts,
                                   torch.float32, torch.float32, device)
        self.experts = ExpertFFN(cfg, device)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        with record_function("moe.router"):
            probs = torch.softmax(self.router(x.to(torch.float32)), dim=-1)
            gate_vals, gate_idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
            gate_vals = gate_vals / torch.clamp_min(
                gate_vals.sum(-1, keepdim=True), 1e-9)
            top1 = one_hot(gate_idx[..., 0], cfg.moe_experts, torch.float32)
            aux = load_balance_loss(probs, top1)
        if cfg.moe_dispatch == "sort":
            return self._sort_dispatch(x, gate_vals, gate_idx), aux
        return self._buffer_dispatch(x, gate_vals, gate_idx), aux

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
        with record_function("moe.experts"):
            expert_out = self.experts(expert_in)           # [E, B, C, D]
        with record_function("moe.combine"):
            if cfg.moe_dispatch == "einsum":
                return torch.einsum("bsec,ebcd->bsd",
                                    combine.to(expert_out.dtype), expert_out)
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
            expert_out = self.experts(expert_in)           # [E, C, D]
        with record_function("moe.combine"):
            rows = expert_out.reshape(experts * capacity, dim)[slot]
            weighted = rows.to(torch.float32) * (g_s * keep)[:, None]
            out = torch.zeros((tokens, dim), dtype=torch.float32,
                              device=x.device).index_add(0, tok_s, weighted)
            return out.to(x.dtype).reshape(batch, seq, dim)


__all__ = ["ExpertFFN", "MoEMLP", "StackedDense", "load_balance_loss",
           "one_hot"]
