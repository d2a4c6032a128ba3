"""Training: loss, optimizer, train step, MFU accounting.

The port of kubeflow_tpu/models/train.py, dense and MoE, on one card or
on a device mesh, with no pipeline schedule yet.  JAX's functional train
state becomes a mutable one: the model holds the parameters, the
optimizer its moments, and `train_step(state, batch)` updates both in
place and returns the same state with the metrics, keeping the
reference's call shape.

The optimizer follows optax, not torch.optim: `default_optimizer` is
clip_by_global_norm then AdamW on a warmup-cosine schedule, with optax's
arithmetic (see `AdamW`).

On a mesh (`setup_training(config, mesh)`), as the reference's sharded
step on its mesh:
- every rank draws the full weights from the same seeded generator, so a
  sharded run starts from the single-device weights bit for bit; then
  `parallelize` cuts each parameter to its block over "tensor" and
  "expert" by the logical rule table and applies FSDP2 `fully_shard`
  over ("data", "fsdp") to every layer and the root: replicated over
  data, sharded over fsdp (HSDP);
- the train step takes the global batch on every rank and keeps its
  rows (over data and fsdp) and its sequence block (over sequence);
- each rank's loss is the mean over its tokens; FSDP2 averages the
  gradients over data and fsdp, the step averages them over sequence,
  and tensor and expert ranks hold the same loss, so the gradient is
  that of the global mean.  `grad_norm` is the global norm, and the
  optimizer steps each rank's shards and holds only their moments.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import copy_to, mean_over, reduce_from
from ..parallel.mesh import axis_group, axis_size
from ..parallel.sharding import (
    local_shard,
    logical_to_spec,
    rules_for_mesh,
    spec_axes,
)
from ..runtime.roofline import mfu as roofline_mfu
from ..runtime.roofline import train_step_flops
from .configs import TransformerConfig
from .transformer import Transformer, init_params, logical, torch_dtype


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


def _nll(logits: torch.Tensor, targets: torch.Tensor,
         vocab: Optional[tuple]) -> torch.Tensor:
    """Per-token NLL of fp32 logits.  With vocab = (tensor group, first
    index) the logits are this rank's slice of the vocabulary: the
    log-sum-exp and the target's logit are summed across the group."""
    targets = targets.long()
    if vocab is None:
        logp = F.log_softmax(logits, dim=-1)
        return -logp.gather(-1, targets[..., None])[..., 0]
    group, start = vocab
    rows = logits.shape[-1]
    with torch.no_grad():
        shift = logits.amax(-1, keepdim=True)
        dist.all_reduce(shift, dist.ReduceOp.MAX, group=group)
    sumexp = reduce_from(torch.exp(logits - shift).sum(-1), group)
    local = targets - start
    inside = (local >= 0) & (local < rows)
    picked = logits.gather(-1, local.clamp(0, rows - 1)[..., None])[..., 0]
    picked = reduce_from(torch.where(inside, picked, 0.0), group)
    return shift[..., 0] + torch.log(sumexp) - picked


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       vocab: Optional[tuple] = None) -> torch.Tensor:
    """Mean next-token NLL in fp32 over the full [B, S] (no padding);
    `vocab` as in `Transformer.vocab_shard`."""
    return _nll(logits.to(torch.float32), targets, vocab).mean()


def _chunk_nll(h_c: torch.Tensor, t_c: torch.Tensor, kernel: torch.Tensor,
               softcap: float, vocab: Optional[tuple]) -> torch.Tensor:
    # the operands are the hidden dtype's values, multiplied and summed in
    # fp32: the logits are never rounded to bf16
    logits = h_c.to(torch.float32) @ kernel
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    return _nll(logits, t_c, vocab).sum()


def chunked_cross_entropy(hidden: torch.Tensor, targets: torch.Tensor,
                          head_kernel: torch.Tensor, num_chunks: int,
                          softcap: float = 0.0,
                          vocab: Optional[tuple] = None) -> torch.Tensor:
    """Mean NLL over [B, S] computed in `num_chunks` chunks of the
    flattened tokens (row-major), each chunk's fp32 logits recomputed in
    the backward (torch.utils.checkpoint), so the full [tokens, vocab]
    logits never exist.  head_kernel [D, V] (the embedding's transpose
    when tied) is cast to the hidden dtype, as the reference does.  With
    `vocab` (see `Transformer.vocab_shard`) head_kernel is this rank's
    [D, V/tp] slice and the log-sum-exp runs across the tensor group."""
    batch, seq, dim = hidden.shape
    tokens = batch * seq
    if tokens % num_chunks:
        raise ValueError(f"{tokens} tokens not divisible by {num_chunks} "
                         f"chunks")
    if vocab is not None:
        hidden = copy_to(hidden, vocab[0])
    h = hidden.reshape(num_chunks, tokens // num_chunks, dim)
    t = targets.reshape(num_chunks, tokens // num_chunks).long()
    kernel = head_kernel.to(hidden.dtype).to(torch.float32)
    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(num_chunks):
        total = total + checkpoint(_chunk_nll, h[i], t[i], kernel, softcap,
                                   vocab, use_reentrant=False)
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
    [B, S], and on a mesh "positions", their global positions): chunked
    cross-entropy over the final hidden state when cfg.loss_chunks > 0,
    else cross-entropy over the full logits; the total adds
    cfg.moe_aux_weight times the summed load-balance loss for MoE configs
    and is the cross-entropy otherwise."""
    cfg = model.cfg
    positions, vocab = batch.get("positions"), model.vocab_shard()
    if cfg.loss_chunks > 0:
        hidden, aux = model(batch["inputs"], positions, return_hidden=True,
                            return_aux=True)
        if cfg.tie_embeddings:
            kernel = model.embed.embedding.T
        else:
            kernel = model.lm_head.kernel
        ce = chunked_cross_entropy(hidden, batch["targets"], kernel,
                                   cfg.loss_chunks, cfg.logits_softcap,
                                   vocab)
    else:
        logits, aux = model(batch["inputs"], positions, return_aux=True)
        ce = cross_entropy_loss(logits, batch["targets"], vocab)
    total = ce + cfg.moe_aux_weight * aux if cfg.moe_experts > 0 else ce
    return total, ce, aux


def loss_fn(model: Transformer, batch: dict) -> torch.Tensor:
    """The training loss of `batch`: the total of `loss_terms`."""
    return loss_terms(model, batch)[0]


# mesh axes over which a parameter is cut before FSDP2 shards it
_MODEL_AXES = ("tensor", "expert")


def param_spec(axes: tuple, rules) -> tuple:
    """A parameter's spec under `rules`, with "fsdp" on dim 0 when no dim
    claims it (the norm scales): FSDP2 shards every parameter it holds,
    where the reference keeps those replicated."""
    spec = logical_to_spec(axes, rules)
    if any("fsdp" in spec_axes(e) for e in spec):
        return spec
    if spec[0] is not None:
        raise ValueError(f"no dim of {axes} is free for fsdp")
    return ("fsdp",) + spec[1:]


def shard_parameters(module: nn.Module, mesh) -> dict:
    """Cut every parameter of `module` (all still full, alike on every
    rank) to its block over "tensor" and "expert": DTensor's split under
    the rule table, nothing sent.  Returns {parameter name: spec}."""
    rules = rules_for_mesh(mesh)
    specs = {}
    for name, param in list(module.named_parameters()):
        axes = getattr(param, "logical_axes", None)
        if axes is None:
            raise ValueError(f"{name} has no logical axes to shard by")
        spec = param_spec(axes, rules)
        block = local_shard(param.detach(), spec, mesh, _MODEL_AXES).clone()
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner), leaf,
                logical(nn.Parameter(block, param.requires_grad), axes))
        specs[name] = spec
    return specs


def parallelize(model: Transformer, mesh) -> dict:
    """Shard a model built on `mesh` whose parameters are still full:
    `shard_parameters`, then FSDP2 `fully_shard` over the ("data",
    "fsdp") sub-mesh on every layer and the root, each parameter sharded
    on the dim its spec gives "fsdp".  Returns {parameter name: spec},
    which `make_train_step` reads from `model.param_specs`."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    specs = shard_parameters(model, mesh)
    fsdp_dim = {param: next(d for d, e in enumerate(specs[name])
                            if "fsdp" in spec_axes(e))
                for name, param in model.named_parameters()}
    dp_mesh = mesh["data", "fsdp"]

    def placement(param):
        return Shard(fsdp_dim[param])

    for layer in model.layers:
        fully_shard(layer, mesh=dp_mesh, shard_placement_fn=placement)
    fully_shard(model, mesh=dp_mesh, shard_placement_fn=placement)
    model.param_specs = specs
    return specs


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's block of a global {"inputs", "targets"} [B, S] batch:
    its rows over ("data", "fsdp") and its sequence block over
    "sequence", with "positions", their global positions."""
    spec = logical_to_spec(("batch", "seq"), rules_for_mesh(mesh))
    inputs = batch["inputs"]
    positions = torch.arange(inputs.shape[1], device=inputs.device
                             ).expand(inputs.shape)
    return {"inputs": local_shard(inputs, spec, mesh).contiguous(),
            "targets": local_shard(batch["targets"], spec, mesh
                                   ).contiguous(),
            "positions": local_shard(positions, spec, mesh).contiguous()}


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the same storage under no_grad)."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _sharded_norm(grads: list, axes: list, mesh) -> torch.Tensor:
    """The global norm of gradients each sharded over the mesh axes in
    its entry of `axes`: local sums of squares, summed across the ranks
    of each such axis."""
    buckets: dict = {}
    for g, ax in zip(grads, axes):
        buckets.setdefault(tuple(ax), []).append(g)
    total = None
    for ax in sorted(buckets):
        sq = torch.stack([g.float().square().sum() for g in buckets[ax]]
                         ).sum()
        for name in ax:
            dist.all_reduce(sq, group=axis_group(mesh, name))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def mesh_loss_and_grads(model: Transformer, batch: dict):
    """One forward and backward of a parallelized model on the global
    `batch`: (metrics, local parameters, local gradients, grad_norm), the
    metrics "loss", "ce_loss" and "moe_aux_loss" as global means, the
    gradients those of the global mean loss, each rank's shards."""
    mesh = model.mesh
    total, ce, aux = loss_terms(model, shard_batch(batch, mesh))
    total.backward()
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    params = [p for p in model.parameters() if p.requires_grad]
    with torch.no_grad():
        local = [local_tensor(p) for p in params]
        grads = [local_tensor(p.grad) for p in params]
        for p in params:
            p.grad = None
        sp = axis_group(mesh, "sequence")
        if sp is not None:
            for g in grads:
                dist.all_reduce(g, group=sp)
                g.div_(dist.get_world_size(sp))
        axes = [[a for e in model.param_specs[n] for a in spec_axes(e)
                 if axis_size(mesh, a) > 1] for n in names]
        grad_norm = _sharded_norm(grads, axes, mesh)
        tokens = [axis_group(mesh, a) for a in ("data", "fsdp", "sequence")]
        metrics = {"loss": mean_over(total.detach(), tokens),
                   "ce_loss": mean_over(ce.detach(), tokens),
                   "moe_aux_loss": aux.detach()}
    return metrics, local, grads, grad_norm


def make_train_step(model: Transformer, optimizer):
    """step(state, batch) -> (state, metrics): loss and gradients of every
    parameter, the optimizer's update in place; metrics "loss",
    "grad_norm" (of the unclipped gradients) and "step" (before the
    update), and for MoE configs "ce_loss" and "moe_aux_loss".  A model
    on a mesh (after `parallelize`) takes the sharded step; a populated
    pipeline axis is refused: the pipeline schedules are not ported
    yet."""
    moe = model.cfg.moe_experts > 0
    if model.mesh is not None:
        if axis_size(model.mesh, "pipeline") > 1:
            raise NotImplementedError("pipeline schedules are not ported yet")

        def mesh_step(state: TrainState, batch: dict
                      ) -> tuple[TrainState, dict]:
            metrics, params, grads, grad_norm = mesh_loss_and_grads(
                model, batch)
            state.optimizer.step(params, grads, grad_norm)
            metrics.update(grad_norm=grad_norm, step=state.step)
            if not moe:
                del metrics["ce_loss"], metrics["moe_aux_loss"]
            state.step += 1
            return state, metrics

        return mesh_step
    params = [p for p in model.parameters() if p.requires_grad]

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


def setup_training(config: TransformerConfig, mesh=None, device="cuda",
                   seed: int = 0, optimizer=None) -> TrainSetup:
    """Build the model on `device`, draw its weights with `init_params`
    from a generator seeded with `seed` on that device, and initialize
    `optimizer` (default: `default_optimizer()`).  With a `mesh`
    (parallel.mesh.make_mesh) every rank draws the full weights alike,
    then `parallelize` shards them and the optimizer holds each rank's
    shards only."""
    device = torch.device(device)
    if mesh is not None and axis_size(mesh, "pipeline") > 1:
        raise NotImplementedError("pipeline schedules are not ported yet")
    model = Transformer(config, device, mesh)
    init_params(model, torch.Generator(device=device).manual_seed(seed))
    if mesh is not None:
        parallelize(model, mesh)
    optimizer = optimizer if optimizer is not None else default_optimizer()
    with torch.no_grad():
        optimizer.init([local_tensor(p) for p in model.parameters()
                        if p.requires_grad])
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
           "local_tensor", "loss_fn", "loss_terms", "make_train_step",
           "mesh_loss_and_grads", "mfu", "model_flops_per_step",
           "parallelize", "param_spec", "setup_training", "shard_batch",
           "shard_parameters", "timed_steps",
           "warmup_cosine_decay_schedule"]
