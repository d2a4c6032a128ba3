"""The float32 decoder, written from the published description.

`weights` is {group: stacked tensor} as `benchmark.weights` makes them.
Each product goes through `prec.mm` or `prec.einsum`, `prec` being
float32 for the reference and fp8 for the control (`precision`).  Attention is causal
with grouped kv heads (head h reads kv head h // (H / kvH)), RoPE the
split-half form.  A MoE layer routes each token to its top-k experts by
an fp32 softmax router, renormalises the k gates, keeps a choice only if
its slot in its expert (the running count over the row's flattened
(S, k) order) is under the capacity, and adds the kept experts' SwiGLU
outputs weighted by their gates; its load-balance loss is
E * sum_e f_e P_e over the top-1 choice (Switch Transformers eq. 4).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..shapes import Shape
from .precision import EXACT

LOSS_BLOCK = 4096   # tokens a block of the loss's logits


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x [B, S, H, Dh] rotated by position, split-half convention."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    angle = positions[..., None].float() * freq
    cos, sin = torch.cos(angle)[:, :, None], torch.sin(angle)[:, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_row(q, k, v, prec):
    """One row's causal attention: q [S, H, Dh], k and v [S, kvH, Dh]."""
    groups = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(groups, dim=1)
    v = v.repeat_interleave(groups, dim=1)
    s = prec.einsum("qhd,khd->hqk", q, k) * q.shape[-1] ** -0.5
    seq = q.shape[0]
    above = torch.ones(seq, seq, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(s.masked_fill(above, float("-inf")), dim=-1)
    return prec.einsum("hqk,khd->qhd", p, v)


def _swiglu(x, gate, up, down, prec):
    return prec.mm(F.silu(prec.mm(x, gate)) * prec.mm(x, up), down)


def moe(h: torch.Tensor, w: dict, i: int, shape: Shape, prec):
    """(output, load-balance loss) of layer i's experts on h [B, S, D]."""
    batch, seq, dim = h.shape
    probs = torch.softmax(h @ w["router"][i], dim=-1)        # fp32 router
    gates, picks = torch.topk(probs, shape.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    top1 = F.one_hot(picks[..., 0], shape.experts).float()
    aux = shape.experts * torch.sum(
        top1.reshape(-1, shape.experts).mean(0)
        * probs.reshape(-1, shape.experts).mean(0))
    choice = F.one_hot(picks, shape.experts).float()         # [B, S, k, E]
    flat = choice.reshape(batch, seq * shape.top_k, shape.experts)
    slot = (torch.cumsum(flat, dim=1) - flat).reshape(choice.shape)
    kept = ((slot < shape.capacity(seq)).float() * choice).sum(-1) > 0
    tokens = h.reshape(-1, dim)
    out = torch.zeros_like(tokens)
    for e in range(shape.experts):
        mine = (picks == e) & kept                            # [B, S, k]
        weight = (gates * mine).sum(-1).reshape(-1)
        rows = mine.any(-1).reshape(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        y = _swiglu(tokens[rows], w["gate"][i][e], w["up"][i][e],
                    w["down"][i][e], prec)
        out = out.index_add(0, rows, y * weight[rows, None])
    return out.reshape(batch, seq, dim), aux


def layer(x: torch.Tensor, w: dict, i: int, shape: Shape, prec=EXACT):
    """Decoder layer i on x [B, S, D]: (x, load-balance loss)."""
    batch, seq, dim = x.shape
    positions = torch.arange(seq, device=x.device).expand(batch, seq)
    mm = prec.mm

    h = rms_norm(x, w["attn_norm"][i], shape.eps).reshape(-1, dim)
    q = mm(h, w["q"][i].reshape(dim, -1)).reshape(
        batch, seq, shape.heads, shape.head_dim)
    k = mm(h, w["k"][i].reshape(dim, -1)).reshape(
        batch, seq, shape.kv_heads, shape.head_dim)
    v = mm(h, w["v"][i].reshape(dim, -1)).reshape(
        batch, seq, shape.kv_heads, shape.head_dim)
    q = rope(q, positions, shape.rope_theta)
    k = rope(k, positions, shape.rope_theta)
    rows = [checkpoint(_attend_row, q[b], k[b], v[b], prec,
                       use_reentrant=False) if torch.is_grad_enabled()
            else _attend_row(q[b], k[b], v[b], prec) for b in range(batch)]
    o = torch.stack(rows).reshape(-1, shape.heads * shape.head_dim)
    x = x + mm(o, w["out"][i].reshape(-1, dim)).reshape(batch, seq, dim)
    h = rms_norm(x, w["mlp_norm"][i], shape.eps)
    if shape.moe:
        y, aux = moe(h, w, i, shape, prec)
        return x + y, aux
    y = _swiglu(h.reshape(-1, dim), w["gate"][i], w["up"][i], w["down"][i],
                prec)
    return x + y.reshape(batch, seq, dim), x.new_zeros(())


def hidden(w: dict, tokens: torch.Tensor, shape: Shape, prec=EXACT,
           remat: bool = True):
    """(final normed hidden state [B, S, D], summed load-balance loss)."""
    x = w["embed"][tokens]
    aux = x.new_zeros(())
    for i in range(shape.layers):
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(layer, x, w, i, shape, prec,
                              use_reentrant=False)
        else:
            x, a = layer(x, w, i, shape, prec)
        aux = aux + a
    return rms_norm(x, w["final_norm"], shape.eps), aux


def _nll_block(h, targets, head, prec):
    logits = prec.mm(h, head)
    return -torch.log_softmax(logits, dim=-1).gather(
        -1, targets[:, None])[:, 0].sum()


def loss(w: dict, inputs: torch.Tensor, targets: torch.Tensor, shape: Shape,
         prec=EXACT) -> torch.Tensor:
    """The training loss: mean next-token NLL over every token, plus
    aux_coef times the summed load-balance loss for a MoE model."""
    h, aux = hidden(w, inputs, shape, prec)
    h = h.reshape(-1, shape.dim)
    t = targets.reshape(-1)
    total = h.new_zeros(())
    for start in range(0, h.shape[0], LOSS_BLOCK):
        part = slice(start, start + LOSS_BLOCK)
        total = total + checkpoint(_nll_block, h[part], t[part], w["head"],
                                   prec, use_reentrant=False)
    ce = total / h.shape[0]
    return ce + shape.aux_coef * aux if shape.moe else ce


def logits(w: dict, tokens: torch.Tensor, shape: Shape, prec=EXACT):
    """Logits [B, S, V] of a forward without gradients."""
    with torch.no_grad():
        h, _ = hidden(w, tokens, shape, prec, remat=False)
        return prec.mm(h, w["head"])


__all__ = ["hidden", "layer", "logits", "loss", "moe", "rms_norm", "rope"]
