"""Training: loss, optimizer, train step, MFU accounting.

The port of kubeflow_tpu/models/train.py, dense and MoE, on one card or
on a device mesh, with the reference's two pipeline schedules.  JAX's
functional train state becomes a mutable one: the model holds the
parameters, the optimizer its moments, and `train_step(state, batch)`
updates both in place and returns the same state with the metrics,
keeping the reference's call shape.

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

A populated "pipeline" axis (parallel/pipeline.py) runs the layer stack
under `pipeline_schedule`, "gpipe" or "1f1b", with
`pipeline_microbatches` microbatches (default 2 x stages):
- each rank holds its stage's layers (FSDP2 over data and fsdp as
  above) and the embedding, final norm and head whole over the pipeline
  and over data and fsdp, since FSDP2's root wrapping needs the whole
  model's forward, which a stage never runs;
- microbatch m is rows [m B/M, (m+1) B/M) of the global batch, cut over
  data, fsdp and sequence like a batch; stage 0 embeds, the last stage
  runs the head and the loss (inside the 1F1B schedule, per microbatch)
  and the backward comes back to stage 0, which carries it through the
  embedding;
- the embedding, final norm and head gradients are summed over the
  stages (with tied embeddings: the lookup's on stage 0 and the head's
  on the last) and averaged over data and fsdp; a layer's gradient
  counts once in the global norm, on its stage.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import copy_to, mean_over, reduce_from
from ..parallel.mesh import axis_group, axis_rank, axis_size
from ..parallel.sharding import (
    local_shard,
    logical_to_spec,
    rules_for_mesh,
    spec_axes,
    spec_placements,
)
from ..runtime.roofline import mfu as roofline_mfu
from ..runtime.roofline import train_step_flops
from .configs import TransformerConfig
from .transformer import Transformer, init_params, logical, torch_dtype

SCHEDULES = ("gpipe", "1f1b")


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
    """optax.sgd with a constant learning rate: p -= lr * g.  It holds no
    state, so its state dict is empty."""

    def __init__(self, learning_rate: float):
        self.learning_rate = learning_rate

    def init(self, params, names: Optional[Sequence[str]] = None) -> None:
        pass

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        if state:
            raise ValueError(f"SGD holds no state, got {sorted(state)}")

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
        self.names: list = []
        self.mu: list = []
        self.nu: list = []

    def init(self, params, names: Optional[Sequence[str]] = None) -> None:
        """Zero moments for `params`, keyed in the state dict by `names`
        (the parameters' names; default their indices)."""
        params = list(params)
        self.names = (list(names) if names is not None
                      else [str(i) for i in range(len(params))])
        if len(self.names) != len(params):
            raise ValueError(f"{len(self.names)} names for {len(params)} "
                             f"parameters")
        self.mu = [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                   for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0
        if self.mu_dtype is not None:
            self.b1_mu = torch.tensor(self.b1, dtype=self.mu_dtype).item()

    def state_dict(self) -> dict:
        """{"mu", "nu": {parameter name: moment}, "count", "b1_mu"}: the
        moments themselves (not copies).  `count` sets both the schedule's
        learning rate and the bias corrections, and `b1_mu` is b1 as a
        bf16 mu rounds it, so a restore needs both."""
        return {"mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu)),
                "count": self.count, "b1_mu": self.b1_mu}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy `state` (as `state_dict` gives it) into this optimizer's
        moments, keeping their dtypes and devices; the names must be the
        ones `init` was given."""
        for key, moments in (("mu", self.mu), ("nu", self.nu)):
            if set(state[key]) != set(self.names):
                raise ValueError(
                    f"{key} holds {sorted(set(state[key]) ^ set(self.names))}"
                    f" other than this optimizer's parameters")
            for name, moment in zip(self.names, moments):
                moment.copy_(state[key][name])
        self.count = int(state["count"])
        self.b1_mu = float(state["b1_mu"])

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


def adamw(learning_rate: float, weight_decay: float = 1e-4) -> AdamW:
    """optax.adamw(learning_rate, weight_decay=weight_decay) (b1 0.9, b2
    0.999, eps 1e-8, decay on every parameter, a constant rate, no
    clipping); weight_decay=0 is optax.adam."""
    return AdamW(lambda count: learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=weight_decay)


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


def head_cross_entropy(model: Transformer, out: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the model's output `out` against `targets`:
    `out` is the final hidden state when cfg.loss_chunks > 0 (chunked
    against the head kernel, the embedding's transpose when tied), else
    the logits."""
    cfg, vocab = model.cfg, model.vocab_shard()
    if cfg.loss_chunks > 0:
        if cfg.tie_embeddings:
            kernel = model.embed.embedding.T
        else:
            kernel = model.lm_head.kernel
        return chunked_cross_entropy(out, targets, kernel, cfg.loss_chunks,
                                     cfg.logits_softcap, vocab)
    return cross_entropy_loss(out, targets, vocab)


def loss_terms(model: Transformer, batch: dict
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, cross-entropy, MoE aux) of `batch` ({"inputs", "targets"}
    [B, S], and on a mesh "positions", their global positions): chunked
    cross-entropy over the final hidden state when cfg.loss_chunks > 0,
    else cross-entropy over the full logits; the total adds
    cfg.moe_aux_weight times the summed load-balance loss for MoE configs
    and is the cross-entropy otherwise."""
    cfg = model.cfg
    out, aux = model(batch["inputs"], batch.get("positions"),
                     return_hidden=cfg.loss_chunks > 0, return_aux=True)
    ce = head_cross_entropy(model, out, batch["targets"])
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


def _is_layer(name: str) -> bool:
    return name.startswith("layers.")


def _without(spec: tuple, axis: str) -> tuple:
    """`spec` with `axis` taken out of every entry."""
    out = []
    for entry in spec:
        kept = tuple(a for a in spec_axes(entry) if a != axis)
        out.append(None if not kept else kept[0] if len(kept) == 1
                   else kept)
    return tuple(out)


def _fsdp_applies(mesh, device: torch.device) -> bool:
    """Whether FSDP2 wraps the model: not where its data x fsdp group has
    one rank and the backend is gloo on CUDA tensors, whose all-gather
    and reduce-scatter have no CUDA path (the group is left out)."""
    return mesh["data", "fsdp"].size() > 1 or not (
        dist.get_backend() == "gloo" and device.type == "cuda")


def parallelize(model: Transformer, mesh) -> dict:
    """Shard a model built on `mesh` whose parameters are still full:
    `shard_parameters`, then FSDP2 `fully_shard` over the ("data",
    "fsdp") sub-mesh on every layer and the root, each parameter sharded
    on the dim its spec gives "fsdp".  On a pipeline mesh the root is not
    wrapped: the embedding, final norm and head stay whole over data and
    fsdp (their specs lose "fsdp").  Returns {parameter name: spec},
    which `make_train_step` reads from `model.param_specs`."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    specs = shard_parameters(model, mesh)
    staged = axis_size(mesh, "pipeline") > 1
    if staged:
        specs.update({name: _without(spec, "fsdp")
                      for name, spec in specs.items() if not _is_layer(name)})
    model.param_specs = specs
    if not _fsdp_applies(mesh, model.device):
        return specs
    fsdp_dim = {param: next(d for d, e in enumerate(specs[name])
                            if "fsdp" in spec_axes(e))
                for name, param in model.named_parameters()
                if _is_layer(name) or not staged}
    dp_mesh = mesh["data", "fsdp"]

    def placement(param):
        return Shard(fsdp_dim[param])

    for layer in model.layers:
        fully_shard(layer, mesh=dp_mesh, shard_placement_fn=placement)
    if not staged:
        fully_shard(model, mesh=dp_mesh, shard_placement_fn=placement)
    return specs


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's block of a global {"inputs", "targets"} [B, S] batch:
    its rows over ("data", "fsdp") and its sequence block over
    "sequence", with "positions", their global positions."""
    local = shard_microbatches(batch, mesh, 1)
    return {"inputs": local["inputs"][0], "targets": local["targets"][0],
            "positions": local["positions"]}


def shard_microbatches(batch: dict, mesh, microbatches: int) -> dict:
    """This rank's blocks of `microbatches` microbatches of a global
    {"inputs", "targets"} [B, S] batch, microbatch m being rows
    [m B/M, (m+1) B/M) as the reference splits it: "inputs" and "targets"
    [M, mb, s], each microbatch's rows over ("data", "fsdp") and its
    sequence block over "sequence", and "positions" [mb, s], their global
    positions (alike in every microbatch)."""
    inputs = batch["inputs"]
    rows, seq = inputs.shape
    if rows % microbatches:
        raise ValueError(f"batch {rows} not divisible by {microbatches} "
                         f"microbatches")
    spec = logical_to_spec(("batch", "seq"), rules_for_mesh(mesh))
    shape = (microbatches, rows // microbatches, seq)

    def cut(t):
        return local_shard(t.reshape(shape), (None,) + spec, mesh
                           ).contiguous()

    positions = torch.arange(seq, device=inputs.device).expand(shape[1:])
    return {"inputs": cut(inputs), "targets": cut(batch["targets"]),
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


def pipeline_backward(model: Transformer, batch: dict, microbatches: int,
                      schedule: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward and backward of the global `batch` through this rank's
    pipeline stage under `schedule`, the gradients left in the
    parameters' `.grad`: (cross-entropy, MoE aux), each the mean over
    this rank's tokens, alike on every stage."""
    from ..parallel import pipeline

    mesh, cfg = model.mesh, model.cfg
    moe = cfg.moe_experts > 0
    weight = cfg.moe_aux_weight if moe else 0.0
    local = shard_microbatches(batch, mesh, microbatches)
    inputs = local["inputs"].flatten(0, 1)
    targets = local["targets"].flatten(0, 1)
    stage, stages = axis_rank(mesh, "pipeline"), axis_size(mesh, "pipeline")
    if stage == 0:
        x = model.embed_tokens(inputs)
    else:
        x = torch.empty(inputs.shape + (cfg.embed_dim,),
                        dtype=torch_dtype(cfg.dtype), device=inputs.device)

    def run_stage(x_mb):
        y, aux = model.run_stack(x_mb, local["positions"])
        return (y, aux) if moe else y

    def head_loss(y, t):
        out = model.head(y, return_hidden=cfg.loss_chunks > 0)
        return head_cross_entropy(model, out, t)

    if schedule == "1f1b":
        ce, aux, _, _, dx = pipeline.pipeline_1f1b(
            run_stage, head_loss, x, targets, mesh, microbatches,
            layer_has_aux=moe, aux_weight=weight)
    else:
        run = pipeline.gpipe(run_stage, x, mesh, microbatches,
                             layer_has_aux=moe)
        ce = head_loss(run.out, targets) if stage == stages - 1 else None
        dx = run.backward(ce, weight)
        ce = pipeline.stage_sum(x.new_zeros((), dtype=torch.float32)
                                if ce is None else ce,
                                axis_group(mesh, "pipeline"))
        aux = run.aux
    if dx is not None:
        x.backward(dx)
    return ce, aux


def mesh_loss_and_grads(model: Transformer, batch: dict,
                        microbatches: int = 0, schedule: str = "gpipe"):
    """One forward and backward of a parallelized model on the global
    `batch`: (metrics, local parameters, local gradients, grad_norm), the
    metrics "loss", "ce_loss" and "moe_aux_loss" as global means, the
    gradients those of the global mean loss, each rank's shards.  A
    pipeline mesh runs `schedule` with `microbatches` microbatches
    (default 2 x stages)."""
    mesh, cfg = model.mesh, model.cfg
    stages = axis_size(mesh, "pipeline")
    if stages > 1:
        ce, aux = pipeline_backward(model, batch,
                                    microbatches or 2 * stages, schedule)
        total = ce + cfg.moe_aux_weight * aux if cfg.moe_experts > 0 else ce
    else:
        total, ce, aux = loss_terms(model, shard_batch(batch, mesh))
        total.backward()
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    with torch.no_grad():
        local = [local_tensor(p) for _, p in named]
        grads = [torch.zeros_like(t) if p.grad is None
                 else local_tensor(p.grad) for t, (_, p) in zip(local, named)]
        for _, p in named:
            p.grad = None
        if stages > 1:
            # the embedding, final norm and head: summed over the stages,
            # averaged over data and fsdp, where they are whole
            pp = axis_group(mesh, "pipeline")
            dp = [g for g in (axis_group(mesh, a) for a in ("data", "fsdp"))
                  if g is not None]
            for (name, _), g in zip(named, grads):
                if _is_layer(name):
                    continue
                dist.all_reduce(g, group=pp)
                for group in dp:
                    dist.all_reduce(g, group=group)
                    g.div_(dist.get_world_size(group))
        sp = axis_group(mesh, "sequence")
        if sp is not None:
            for g in grads:
                dist.all_reduce(g, group=sp)
                g.div_(dist.get_world_size(sp))
        # a layer's gradient lives on one stage: its squares are summed
        # over the pipeline too
        axes = [[a for e in model.param_specs[n] for a in spec_axes(e)
                 if axis_size(mesh, a) > 1]
                + (["pipeline"] if stages > 1 and _is_layer(n) else [])
                for n, _ in named]
        grad_norm = _sharded_norm(grads, axes, mesh)
        tokens = [axis_group(mesh, a) for a in ("data", "fsdp", "sequence")]
        metrics = {"loss": mean_over(total.detach(), tokens),
                   "ce_loss": mean_over(ce.detach(), tokens),
                   "moe_aux_loss": aux.detach()}
    return metrics, local, grads, grad_norm


def make_train_step(model: Transformer, optimizer,
                    pipeline_microbatches: int = 0,
                    pipeline_schedule: str = "gpipe"):
    """step(state, batch) -> (state, metrics): loss and gradients of every
    parameter, the optimizer's update in place; metrics "loss",
    "grad_norm" (of the unclipped gradients) and "step" (before the
    update), and for MoE configs "ce_loss" and "moe_aux_loss".  A model
    on a mesh (after `parallelize`) takes the sharded step, and on a
    populated pipeline axis runs `pipeline_schedule` ("gpipe" or "1f1b")
    with `pipeline_microbatches` microbatches (default 2 x stages)."""
    if pipeline_schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {pipeline_schedule!r}")
    moe = model.cfg.moe_experts > 0
    if model.mesh is not None:
        def mesh_step(state: TrainState, batch: dict
                      ) -> tuple[TrainState, dict]:
            metrics, params, grads, grad_norm = mesh_loss_and_grads(
                model, batch, pipeline_microbatches, pipeline_schedule)
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
                   seed: int = 0, optimizer=None,
                   pipeline_microbatches: int = 0,
                   pipeline_schedule: str = "gpipe") -> TrainSetup:
    """Build the model on `device`, draw its weights with `init_params`
    from a generator seeded with `seed` on that device, and initialize
    `optimizer` (default: `default_optimizer()`).  With a `mesh`
    (parallel.mesh.make_mesh) every rank draws the full weights alike
    (a pipeline stage those of its own layers), then `parallelize`
    shards them and the optimizer holds each rank's shards only.  A
    populated "pipeline" axis runs the layer stack under
    `pipeline_schedule`: "gpipe" (a forward pipeline, then the backward
    stage by stage) or "1f1b" (parallel.pipeline.pipeline_1f1b, at most
    `stages` microbatch graphs held a stage), with `pipeline_microbatches`
    microbatches (default 2 x stages)."""
    if pipeline_schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {pipeline_schedule!r}")
    device = torch.device(device)
    model = Transformer(config, device, mesh)
    init_params(model, torch.Generator(device=device).manual_seed(seed))
    if mesh is not None:
        parallelize(model, mesh)
    optimizer = optimizer if optimizer is not None else default_optimizer()
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    with torch.no_grad():
        optimizer.init([local_tensor(p) for _, p in named],
                       [n for n, _ in named])
    state = TrainState(model, optimizer)
    step = make_train_step(model, optimizer, pipeline_microbatches,
                           pipeline_schedule)
    return TrainSetup(model, state, step, config)


# -- the train state as a state dict -----------------------------------------


def _mesh_dtensor(t: torch.Tensor, param: torch.Tensor, spec: tuple,
                  mesh):
    """`t`, this rank's shard of `param` (or of one of its moments), as a
    DTensor over the whole `mesh`: Shard on every mesh dim `spec` (the
    parameter's) cuts it over, so the sharded checkpoint holds each
    block once and can reshard it."""
    from torch.distributed.tensor import DTensor

    shape = list(param.shape)   # the block over "tensor" and "expert"
    for dim, entry in enumerate(spec):
        for axis in spec_axes(entry):
            if axis in _MODEL_AXES:
                shape[dim] *= axis_size(mesh, axis)
    stride = [1] * len(shape)
    for dim in range(len(shape) - 2, -1, -1):
        stride[dim] = stride[dim + 1] * shape[dim + 1]
    return DTensor.from_local(t, mesh, spec_placements(spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


@torch.no_grad()
def train_state_dict(state: TrainState) -> dict:
    """The train state as a state dict: {"model": {name: parameter},
    "optimizer": the optimizer's `state_dict()` (moments keyed by
    parameter name), "step": int}.  The tensors are the live ones, not
    copies.  On a mesh every parameter and moment is a DTensor over the
    whole mesh (see `_mesh_dtensor`), what torch.distributed.checkpoint
    saves and loads in place."""
    model = state.model
    opt = state.optimizer.state_dict()
    named = dict(model.named_parameters())
    params = {n: local_tensor(p) for n, p in named.items()}
    if model.mesh is not None:
        def wrap(tensors: dict) -> dict:
            return {n: _mesh_dtensor(t, named[n], model.param_specs[n],
                                     model.mesh) for n, t in tensors.items()}

        params = wrap(params)
        for key in ("mu", "nu"):
            if key in opt:
                opt[key] = wrap(opt[key])
    return {"model": params, "optimizer": opt, "step": state.step}


@torch.no_grad()
def load_train_state(state: TrainState, state_dict: dict) -> TrainState:
    """Copy `state_dict` (as `train_state_dict` gives it, DTensors or
    plain tensors) into `state`'s parameters, optimizer and step, in
    place; every parameter must be there."""
    model = state.model
    params = dict(model.named_parameters())
    stored = state_dict["model"]
    if set(stored) != set(params):
        raise ValueError(f"the state dict's parameters differ from the "
                         f"model's: {sorted(set(stored) ^ set(params))}")
    for name, param in params.items():
        local_tensor(param).copy_(local_tensor(stored[name]))
    opt = dict(state_dict["optimizer"])
    for key in ("mu", "nu"):
        if key in opt:
            opt[key] = {n: local_tensor(t) for n, t in opt[key].items()}
    state.optimizer.load_state_dict(opt)
    state.step = int(state_dict["step"])
    return state


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


__all__ = ["AdamW", "SCHEDULES", "SGD", "TrainSetup", "TrainState",
           "adamw", "chunked_cross_entropy", "cross_entropy_loss",
           "default_optimizer", "global_norm", "head_cross_entropy",
           "load_train_state", "local_tensor", "loss_fn", "loss_terms",
           "make_train_step",
           "mesh_loss_and_grads", "mfu", "model_flops_per_step",
           "parallelize", "param_spec", "pipeline_backward",
           "setup_training", "shard_batch", "shard_microbatches",
           "shard_parameters", "timed_steps", "train_state_dict",
           "warmup_cosine_decay_schedule"]
