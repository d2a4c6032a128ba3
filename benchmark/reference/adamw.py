"""Training steps of the reference, with the port's optimizer arithmetic,
and the readings the training checks compare.

The optimizer is optax's chain of clip_by_global_norm and adamw with a
bf16 first moment, as the configuration's `assumed.optimizer` states:
the gradients divided by their global norm (times the clip) when it is
not below the clip; mu = (1 - b1) g + b1 mu with b1 mu taken in bf16
and b1 rounded to bf16; nu = (1 - b2) g^2 + b2 nu in fp32; the update
mu_hat / (sqrt(nu_hat) + eps) plus weight_decay * p, scaled by the
warmup-cosine rate of the count before the step; mu stored in bf16.

Readings (`Readings`), each a float on the host:
- `losses`: each step's loss;
- `grad`: {leaf: norm of the first step's gradient as the optimizer
  gets it, after clipping};
- `change`: {leaf: norm of the parameters' change over the steps}.
A leaf is one layer's slice of a group ("q/3"), or a whole group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from .. import weights as W
from ..shapes import Shape
from . import model
from .precision import EXACT


def rate(opt: dict, count: int) -> float:
    """optax.warmup_cosine_decay_schedule from 0 to the peak rate."""
    peak, warm = opt["learning_rate"], opt["warmup_steps"]
    total = max(opt["total_steps"], warm + 1)
    if count < warm:
        return peak * count / warm
    t = min(count - warm, total - warm)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / (total - warm)))


@dataclass
class Readings:
    losses: list = field(default_factory=list)
    grad: dict = field(default_factory=dict)
    change: dict = field(default_factory=dict)


def leaf_norms(shape: Shape, name: str, t: torch.Tensor) -> dict:
    """{leaf key: fp32 norm} of one group's stacked tensor."""
    return {key: float(torch.linalg.vector_norm(W.leaf(t, key).float()))
            for key in W.layer_slices(shape, name)}


def leaves(shape: Shape, seed: int, device) -> dict:
    """{leaf key: fp32 tensor requiring grad}: each group made in one
    call, then cut into its layers' leaves."""
    out = {}
    for name in W.groups(shape):
        group = W.make(shape, name, seed, torch.float32, device)
        for key in W.layer_slices(shape, name):
            out[key] = W.leaf(group, key).clone().requires_grad_(True)
        del group
    return out


def stacked(params: dict, shape: Shape) -> dict:
    """{group: its leaves, a list by layer, or the one tensor}, the
    layout `model` indexes as w[group][layer]."""
    out = {}
    for name in W.groups(shape):
        keys = W.layer_slices(shape, name)
        out[name] = ([params[k] for k in keys] if len(keys) > 1
                     or "/" in keys[0] else params[keys[0]])
    return out


def change_norms(shape: Shape, params: dict, seed: int, device) -> dict:
    """{leaf: norm of its change from the seed's initial weights}, each
    initial group made again on its own."""
    out = {}
    with torch.no_grad():
        for name in W.groups(shape):
            start = W.make(shape, name, seed, torch.float32, device)
            for key in W.layer_slices(shape, name):
                out[key] = float(torch.linalg.vector_norm(
                    params[key].detach() - W.leaf(start, key)))
            del start
    return out


def train(shape: Shape, opt: dict, batches: list, seed: int, device,
          prec=EXACT, half_batch: bool = False) -> Readings:
    """Run len(batches) steps from the seed's weights; the readings.
    `half_batch` is a fault: the loss takes the mean over the first
    half of the rows only."""
    params = leaves(shape, seed, device)
    w = stacked(params, shape)
    names = list(params)
    mu = {n: torch.zeros_like(params[n], dtype=torch.bfloat16)
          for n in names}
    nu = {n: torch.zeros_like(params[n]) for n in names}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    b1_mu = torch.tensor(b1, dtype=torch.bfloat16).item()
    clip, decay = opt["max_grad_norm"], opt["weight_decay"]
    out = Readings()
    for count, batch in enumerate(batches):
        inputs, targets = batch["inputs"], batch["targets"]
        if half_batch:
            rows = inputs.shape[0] // 2
            inputs, targets = inputs[:rows], targets[:rows]
        loss = model.loss(w, inputs, targets, shape, prec)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        out.losses.append(float(loss.detach()))
        del loss
        with torch.no_grad():
            norm = float(torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads])))
            factor = 1.0 if clip <= 0 or norm < clip else clip / norm
            lr = rate(opt, count)
            bc1, bc2 = 1.0 - b1 ** (count + 1), 1.0 - b2 ** (count + 1)
            for n, g in zip(names, grads):
                g.mul_(factor)
                if count == 0:
                    out.grad[n] = float(torch.linalg.vector_norm(g))
                p = params[n]
                m = (1.0 - b1) * g + (b1_mu * mu[n]).float()
                v = (1.0 - b2) * (g * g) + b2 * nu[n]
                update = (m / bc1) / (torch.sqrt(v / bc2) + eps) + decay * p
                p.sub_(lr * update)
                mu[n].copy_(m)
                nu[n].copy_(v)
                del m, v, update
        del grads
    del mu, nu
    out.change = change_norms(shape, params, seed, device)
    return out


__all__ = ["Readings", "change_norms", "leaf_norms", "leaves", "rate",
           "stacked", "train"]
