"""Training on one device: loss, optimizer, train step, MFU accounting.

The port of kubeflow_tpu/models/train.py for one card, dense and MoE,
with no pipeline schedule.  JAX's functional train state becomes a mutable one: the
model holds the parameters, the optimizer its moments, and
`train_step(state, batch)` updates both in place and returns the same
state with the metrics, keeping the reference's call shape.

The optimizer follows optax, not torch.optim: `default_optimizer` is
clip_by_global_norm then AdamW on a warmup-cosine schedule, with optax's
arithmetic (see `AdamW`).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..runtime.roofline import mfu as roofline_mfu
from ..runtime.roofline import train_step_flops
from .configs import TransformerConfig
from .transformer import Transformer, init_params, torch_dtype


# -- schedules ----------------------------------------------------------------


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear from init_value to
    peak_value over warmup_steps, then cosine to end_value at decay_steps
    (which counts the warmup)."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


# -- optimizers ---------------------------------------------------------------


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as optax.global_norm."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class SGD:
    """optax.sgd with a constant learning rate: p -= lr * g."""

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, params) -> None:
        pass

    @torch.no_grad()
    def step(self, params, grads, grad_norm: torch.Tensor) -> None:
        torch._foreach_add_(params, grads, alpha=-self.learning_rate)


class AdamW:
    """optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule, b1,
    b2, eps, weight_decay, mu_dtype)), with optax's arithmetic:

    - clipping leaves the gradients as they are when their global norm is
      below max_grad_norm, else divides them by the norm (no epsilon) and
      multiplies by max_grad_norm;
    - mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, where b1 * mu
      is taken in mu's dtype with b1 rounded to it (JAX's weak-typed
      scalar: 0.8984375 for a bf16 mu); the update is mu_hat /
      (sqrt(nu_hat) + eps) with bias corrections 1 - b^(count+1); with
      mu_dtype the step uses the un-rounded mu and stores it rounded;
    - weight decay (every parameter) is added to the update, and the sum
      is scaled by -schedule(count), the count before this step."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, max_grad_norm: float = 0.0,
                 mu_dtype: Optional[str] = None):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm
        self.mu_dtype = torch_dtype(mu_dtype) if mu_dtype else None
        self.count = 0
        self.b1_mu = b1   # b1 as mu's dtype holds it (set by init)
        self.mu: list = []
        self.nu: list = []

    def init(self, params) -> None:
        self.mu = [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                   for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0
        if self.mu_dtype is not None:
            self.b1_mu = torch.tensor(self.b1, dtype=self.mu_dtype).item()

    @torch.no_grad()
    def step(self, params, grads, grad_norm: torch.Tensor) -> None:
        if self.max_grad_norm > 0:
            keep = grad_norm < self.max_grad_norm
            grads = [torch.where(keep, g, g / grad_norm * self.max_grad_norm)
                     for g in grads]
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            m = (1.0 - self.b1) * g + self.b1_mu * mu
            v = (1.0 - self.b2) * (g * g) + self.b2 * nu
            update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            update = update + self.weight_decay * p
            p.add_(update, alpha=-lr)
            mu.copy_(m)
            nu.copy_(v)


def default_optimizer(learning_rate: float = 3e-4, warmup_steps: int = 100,
                      total_steps: int = 10_000, weight_decay: float = 0.1,
                      max_grad_norm: float = 1.0,
                      mu_dtype: Optional[str] = None) -> AdamW:
    """AdamW (b1 0.9, b2 0.95) on warmup-cosine from 0, clipped at
    max_grad_norm; mu_dtype="bfloat16" halves the first moment's bytes
    (the second stays fp32)."""
    schedule = warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps, max(total_steps, warmup_steps + 1))
    return AdamW(schedule, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=weight_decay, max_grad_norm=max_grad_norm,
                 mu_dtype=mu_dtype)


# -- losses -------------------------------------------------------------------


def cross_entropy_loss(logits: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL in fp32 over the full [B, S] (no padding)."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(-1, targets[..., None].long())[..., 0].mean()


def _chunk_nll(h_c: torch.Tensor, t_c: torch.Tensor, kernel: torch.Tensor,
               softcap: float) -> torch.Tensor:
    # the operands are the hidden dtype's values, multiplied and summed in
    # fp32: the logits are never rounded to bf16
    logits = h_c.to(torch.float32) @ kernel
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, t_c[:, None])[:, 0].sum()


def chunked_cross_entropy(hidden: torch.Tensor, targets: torch.Tensor,
                          head_kernel: torch.Tensor, num_chunks: int,
                          softcap: float = 0.0) -> torch.Tensor:
    """Mean NLL over [B, S] computed in `num_chunks` chunks of the
    flattened tokens (row-major), each chunk's fp32 logits recomputed in
    the backward (torch.utils.checkpoint), so the full [tokens, vocab]
    logits never exist.  head_kernel [D, V] (the embedding's transpose
    when tied) is cast to the hidden dtype, as the reference does."""
    batch, seq, dim = hidden.shape
    tokens = batch * seq
    if tokens % num_chunks:
        raise ValueError(f"{tokens} tokens not divisible by {num_chunks} "
                         f"chunks")
    h = hidden.reshape(num_chunks, tokens // num_chunks, dim)
    t = targets.reshape(num_chunks, tokens // num_chunks).long()
    kernel = head_kernel.to(hidden.dtype).to(torch.float32)
    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(num_chunks):
        total = total + checkpoint(_chunk_nll, h[i], t[i], kernel, softcap,
                                   use_reentrant=False)
    return total / tokens


# -- the train step -----------------------------------------------------------


@dataclass
class TrainState:
    """What the reference's TrainState holds: the parameters (in the
    model), the optimizer state (in the optimizer) and the step count."""

    model: Transformer
    optimizer: object
    step: int = 0


@dataclass
class TrainSetup:
    model: Transformer
    state: TrainState
    train_step: Callable[[TrainState, dict], tuple[TrainState, dict]]
    config: TransformerConfig


def loss_terms(model: Transformer, batch: dict
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, cross-entropy, MoE aux) of `batch` ({"inputs", "targets"}
    [B, S]): chunked cross-entropy over the final hidden state when
    cfg.loss_chunks > 0, else cross-entropy over the full logits; the
    total adds cfg.moe_aux_weight times the summed load-balance loss for
    MoE configs and is the cross-entropy otherwise."""
    cfg = model.cfg
    if cfg.loss_chunks > 0:
        hidden, aux = model(batch["inputs"], return_hidden=True,
                            return_aux=True)
        if cfg.tie_embeddings:
            kernel = model.embed.embedding.T
        else:
            kernel = model.lm_head.kernel
        ce = chunked_cross_entropy(hidden, batch["targets"], kernel,
                                   cfg.loss_chunks, cfg.logits_softcap)
    else:
        logits, aux = model(batch["inputs"], return_aux=True)
        ce = cross_entropy_loss(logits, batch["targets"])
    total = ce + cfg.moe_aux_weight * aux if cfg.moe_experts > 0 else ce
    return total, ce, aux


def loss_fn(model: Transformer, batch: dict) -> torch.Tensor:
    """The training loss of `batch`: the total of `loss_terms`."""
    return loss_terms(model, batch)[0]


def make_train_step(model: Transformer, optimizer):
    """step(state, batch) -> (state, metrics): loss and gradients of every
    parameter, the optimizer's update in place; metrics "loss",
    "grad_norm" (of the unclipped gradients) and "step" (before the
    update), and for MoE configs "ce_loss" and "moe_aux_loss".  The
    pipeline schedules are not ported yet."""
    params = [p for p in model.parameters() if p.requires_grad]
    moe = model.cfg.moe_experts > 0

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        loss, ce, aux = loss_terms(model, batch)
        grads = torch.autograd.grad(loss, params)
        grad_norm = global_norm(grads)
        state.optimizer.step(params, grads, grad_norm)
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm,
                   "step": state.step}
        if moe:
            metrics["ce_loss"] = ce.detach()
            metrics["moe_aux_loss"] = aux.detach()
        state.step += 1
        return state, metrics

    return step


def setup_training(config: TransformerConfig, device="cuda", seed: int = 0,
                   optimizer=None) -> TrainSetup:
    """Build the model on `device`, draw its weights with `init_params`
    from a generator seeded with `seed` on that device, and initialize
    `optimizer` (default: `default_optimizer()`)."""
    device = torch.device(device)
    model = Transformer(config, device)
    init_params(model, torch.Generator(device=device).manual_seed(seed))
    optimizer = optimizer if optimizer is not None else default_optimizer()
    optimizer.init([p for p in model.parameters() if p.requires_grad])
    state = TrainState(model, optimizer)
    return TrainSetup(model, state, make_train_step(model, optimizer),
                      config)


# -- MFU accounting -----------------------------------------------------------


# the reference's names for runtime.roofline's one definition of each
model_flops_per_step = train_step_flops
mfu = roofline_mfu


def timed_steps(setup: TrainSetup, batch: dict, num_steps: int = 10,
                warmup: int = 2) -> dict:
    """Run `warmup` then `num_steps` steps; the window ends with one host
    read of the last loss, which waits for the device."""
    state = setup.state
    metrics = None
    for _ in range(warmup):
        state, metrics = setup.train_step(state, batch)
    if metrics is not None:
        float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(num_steps):
        state, metrics = setup.train_step(state, batch)
    loss = float(metrics["loss"])
    dt = time.perf_counter() - t0
    setup.state = state
    b, s = batch["inputs"].shape
    step_time = dt / num_steps
    return {
        "loss": loss,
        "step_time_s": step_time,
        "tokens_per_s": b * s / step_time,
        "flops_per_step": model_flops_per_step(setup.config, b, s),
    }


__all__ = ["AdamW", "SGD", "TrainSetup", "TrainState", "chunked_cross_entropy",
           "cross_entropy_loss", "default_optimizer", "global_norm",
           "loss_fn", "loss_terms", "make_train_step", "mfu",
           "model_flops_per_step", "setup_training", "timed_steps", "warmup_cosine_decay_schedule"]
