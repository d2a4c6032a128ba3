"""Pipeline parallelism over the "pipeline" mesh axis: the port of
kubeflow_tpu/parallel/pipeline.py.

Each pipeline rank holds one stage: L/S consecutive decoder layers
(`stage_layers`).  The global batch splits into M microbatches, and
activations hop from stage s to stage s+1 (cotangents back from s+1 to
s) by point-to-point sends to the same coordinate of the neighbouring
stage, in one `batch_isend_irecv` per hop, as the ring of
ops/ring_attention.py sends.  The reference runs its schedules as SPMD
code over every tick, bubbles computed and masked; here each rank runs
only its own forward (F) and backward (B) operations, in the order the
reference's tick formulas give, and computes nothing in the bubbles.

Two schedules, the reference's two:

- `gpipe`: F of every microbatch, each stage keeping the autograd graph
  of all M until the outer backward (`GPipeRun.backward`), which runs
  the microbatches' backwards from the last stage to the first: GPipe's
  trade of memory for simplicity.  The output is whole on the last
  stage only: the loss runs there, where the reference replicates the
  output so that its head runs on every stage.
- `pipeline_1f1b`: the non-interleaved 1F1B (PipeDream-flush) training
  engine, which owns its backward.  Stage s runs F of microbatch m at
  tick s + 2m and B at tick 2S-1-s + 2m; the per-microbatch mean loss
  runs inside the schedule on the last stage and its gradient seeds the
  backward.  Each F keeps its microbatch's graph until its B frees it,
  so a stage holds at most S graphs (the reference recomputes the
  forward inside its vjp instead).  A tick's forward send and backward
  receive go into one `batch_isend_irecv`: as two blocking calls, two
  neighbours that both send first would wait on each other.

`stash` records the most microbatch graphs a stage held in the last run
of either engine: M under GPipe, at most S under 1F1B.

With MoE layers (`layer_has_aux`) the stage returns (activation, aux),
and the load-balance loss is the reference's per-microbatch estimator
averaged over the microbatches, weighted by `aux_weight` in the
backward.

Transport: NCCL, and gloo on CPU tensors, send the tensors themselves.
gloo has no CUDA send or receive, so with gloo and CUDA tensors every
hop goes through pinned host memory (`transport`).  The choice is made
from the backend and the device, before anything is sent.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .mesh import axis_group, axis_rank, axis_size

PIPELINE_AXIS = "pipeline"

# the most microbatch graphs one stage held in the last engine run
stash = {"peak": 0}


def num_stages(mesh, axis_name: str = PIPELINE_AXIS) -> int:
    return axis_size(mesh, axis_name)


def stage_layers(num_layers: int, stages: int, stage: int) -> range:
    """The global indices of the layers stage `stage` of `stages` holds."""
    if num_layers % stages != 0:
        raise ValueError(f"{num_layers} layers not divisible by {stages} "
                         f"stages")
    per = num_layers // stages
    return range(stage * per, (stage + 1) * per)


def transport(group, device: torch.device) -> str:
    """"host" when `group`'s backend cannot send tensors on `device`
    (gloo and CUDA): every hop is staged through pinned host memory;
    "direct" otherwise."""
    host = dist.get_backend(group) == "gloo" and device.type == "cuda"
    return "host" if host else "direct"


class _Hops:
    """This rank's neighbours on the pipeline axis and the sends to them."""

    def __init__(self, mesh, axis_name: str, device: torch.device):
        self.group = axis_group(mesh, axis_name)
        self.stages = axis_size(mesh, axis_name)
        self.stage = axis_rank(mesh, axis_name)
        self.device = device
        self.host = transport(self.group, device) == "host"

        def peer(i):
            return dist.get_global_rank(self.group, i)

        self.prev = peer(self.stage - 1) if self.stage > 0 else None
        self.next = peer(self.stage + 1) if self.stage < self.stages - 1 \
            else None

    def exchange(self, sends: list, recvs: list) -> list:
        """Send each (tensor, peer) of `sends` and receive one tensor for
        each (shape, dtype, peer) of `recvs`, all in one batch; returns the
        received tensors on the device."""
        if not sends and not recvs:
            return []
        ops, landed = [], []
        for t, peer in sends:
            t = t.detach()
            if self.host:
                t = torch.empty(t.shape, dtype=t.dtype,
                                pin_memory=True).copy_(t)
            ops.append(dist.P2POp(dist.isend, t.contiguous(), peer,
                                  self.group))
        for shape, dtype, peer in recvs:
            buf = (torch.empty(shape, dtype=dtype, pin_memory=True)
                   if self.host else
                   torch.empty(shape, dtype=dtype, device=self.device))
            landed.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, peer, self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if self.host:
            landed = [b.to(self.device, non_blocking=True) for b in landed]
        return landed



def stage_sum(value: torch.Tensor, group) -> torch.Tensor:
    """The sum of a scalar over the stages of the pipeline `group`,
    detached."""
    value = value.detach().clone()
    dist.all_reduce(value, group=group)
    return value


def _check(batch: int, num_microbatches: int) -> None:
    if batch % num_microbatches != 0:
        raise ValueError(f"batch {batch} not divisible by "
                         f"{num_microbatches} microbatches")


def _run(stage, x_in: torch.Tensor, layer_has_aux: bool):
    """(output, aux) of the stage on one microbatch; aux None if dense."""
    out = stage(x_in)
    return out if layer_has_aux else (out, None)


def _backward(outputs: list, seeds: list, auxes: list,
              aux_scale: float) -> None:
    """One backward of `outputs` seeded with `seeds`, plus aux_scale
    times each aux of `auxes` (None for dense stages)."""
    if aux_scale != 0.0:
        for aux in auxes:
            if aux is not None and aux.requires_grad:
                outputs = outputs + [aux]
                seeds = seeds + [torch.full_like(aux, aux_scale)]
    torch.autograd.backward(outputs, seeds)


class GPipeRun:
    """One GPipe forward: `out` the stage output of the whole batch on
    the last stage (None elsewhere), `aux` the aux loss summed over the
    stages (a detached scalar, alike on every stage; 0 if dense).  Call
    `backward` once on every stage of the pipeline."""

    def __init__(self, hops: Optional[_Hops], inputs: list, outputs: list,
                 auxes: list):
        self._hops, self._inputs = hops, inputs
        self._outputs, self._auxes = outputs, auxes
        last = hops is None or hops.next is None
        self.out = torch.cat(outputs) if last else None
        local = sum((a.detach() for a in auxes if a is not None),
                    torch.zeros((), device=inputs[0].device))
        local = local / len(inputs)
        self.aux = local if hops is None else stage_sum(local, hops.group)

    def backward(self, loss: Optional[torch.Tensor] = None,
                 aux_weight: float = 0.0) -> torch.Tensor:
        """The outer backward: of `loss` (a scalar function of `out`, on
        the last stage; None elsewhere) plus aux_weight times the mean
        aux over the microbatches, stage by stage from the last to the
        first.  Returns the gradient of the stage-0 input `x` on stage 0
        (None elsewhere): the caller carries it on through whatever made
        `x`."""
        hops, inputs, outputs = self._hops, self._inputs, self._outputs
        scale = aux_weight / len(inputs)
        if hops is None or hops.next is None:
            _backward([loss], [torch.ones_like(loss)], self._auxes, scale)
            if hops is not None:
                for m in reversed(range(len(inputs))):
                    hops.exchange([(inputs[m].grad, hops.prev)], [])
        else:
            for m in reversed(range(len(inputs))):
                y = outputs[m]
                (g,) = hops.exchange([], [(y.shape, y.dtype, hops.next)])
                _backward([y], [g], [self._auxes[m]], scale)
                if hops.prev is not None:
                    hops.exchange([(inputs[m].grad, hops.prev)], [])
        self._outputs = self._auxes = None
        if hops is not None and hops.prev is not None:
            return None
        return torch.cat([x.grad for x in inputs])


def gpipe(stage: Callable, x: torch.Tensor, mesh, num_microbatches: int,
          axis_name: str = PIPELINE_AXIS,
          layer_has_aux: bool = False) -> GPipeRun:
    """Run this rank's stage of a GPipe pipeline forward.

    stage(x_mb) applies the stage's layers to one microbatch [mb, ...]
    and returns the activation of the same shape (with layer_has_aux,
    (activation, aux scalar)).  x: [B, ...] with B % num_microbatches
    == 0, the input of stage 0; the other stages read only its shape,
    dtype and device.  With one stage the whole batch runs as one
    microbatch, the plain loop.

    Composition: a stage body that shards the batch over data and fsdp
    needs each microbatch to divide by data * fsdp, as in the reference.
    """
    stages = num_stages(mesh, axis_name)
    if stages <= 1:
        x_in = x.detach().requires_grad_()
        out, aux = _run(stage, x_in, layer_has_aux)
        stash["peak"] = 1
        return GPipeRun(None, [x_in], [out], [aux])
    _check(x.shape[0], num_microbatches)
    hops = _Hops(mesh, axis_name, x.device)
    chunks = x.chunk(num_microbatches)
    inputs, outputs, auxes = [], [], []
    for m in range(num_microbatches):
        if hops.prev is None:
            x_in = chunks[m].detach()
        else:
            (x_in,) = hops.exchange([], [(chunks[m].shape, x.dtype,
                                          hops.prev)])
        x_in.requires_grad_()
        y, aux = _run(stage, x_in, layer_has_aux)
        if hops.next is not None:
            hops.exchange([(y, hops.next)], [])
        inputs.append(x_in)
        outputs.append(y)
        auxes.append(aux)
    stash["peak"] = len(outputs)
    return GPipeRun(hops, inputs, outputs, auxes)


def pipeline_1f1b(stage: Callable, head_loss: Callable, x: torch.Tensor,
                  targets: torch.Tensor, mesh, num_microbatches: int,
                  axis_name: str = PIPELINE_AXIS,
                  layer_has_aux: bool = False, aux_weight: float = 0.0,
                  stage_params=(), head_params=()):
    """1F1B pipeline training: returns (loss, aux, layer grads, head
    grads, dx).

    stage(x_mb) as in `gpipe`; head_loss(y_mb, t_mb) maps the last
    stage's output microbatch and its targets (rows of `targets`) to the
    microbatch's MEAN loss.  loss and aux are batch means summed over
    the stages, alike on every stage.  The backward seeds each
    microbatch's loss with 1/M and each stage's aux with aux_weight/M,
    and accumulates into the `.grad` of the parameters it reaches;
    layer and head grads are those `.grad`s of `stage_params` and
    `head_params` on this rank.  dx is the gradient of `x` on stage 0
    (None elsewhere), for the caller to carry through whatever made x.
    """
    stages = num_stages(mesh, axis_name)
    _check(x.shape[0], num_microbatches)
    if stages <= 1:
        raise ValueError("pipeline_1f1b requires a populated pipeline axis")
    hops = _Hops(mesh, axis_name, x.device)
    S, s, M = stages, hops.stage, num_microbatches
    last = hops.next is None
    chunks, target_chunks = x.chunk(M), targets.chunk(M)
    mb_shape = chunks[0].shape
    ops = {s + 2 * m: ("F", m) for m in range(M)}
    ops.update({2 * S - 1 - s + 2 * m: ("B", m) for m in range(M)})
    live: dict = {}
    inbox: dict = {}
    dxs = [None] * M
    loss = torch.zeros((), device=x.device)
    aux_sum = torch.zeros((), device=x.device)
    peak = 0
    for t in range(2 * (M + S - 1)):
        sends = []
        kind, m = ops.get(t, (None, None))
        if kind == "F":
            x_in = (chunks[m].detach() if hops.prev is None
                    else inbox.pop(("x", m))).requires_grad_()
            y, aux = _run(stage, x_in, layer_has_aux)
            out = head_loss(y, target_chunks[m]) if last else y
            live[m] = (x_in, out, aux)
            peak = max(peak, len(live))
            if not last:
                sends.append((y, hops.next))
        elif kind == "B":
            x_in, out, aux = live.pop(m)
            seed = (torch.full_like(out, 1.0 / M) if last
                    else inbox.pop(("g", m)))
            _backward([out], [seed], [aux], aux_weight / M)
            if last:
                loss = loss + out.detach() / M
            if aux is not None:
                aux_sum = aux_sum + aux.detach() / M
            if hops.prev is None:
                dxs[m] = x_in.grad
            else:
                sends.append((x_in.grad, hops.prev))
            del x_in, out, aux
        recvs, keys = [], []
        kind, m = ops.get(t + 1, (None, None))
        if kind == "F" and hops.prev is not None:
            recvs.append((mb_shape, x.dtype, hops.prev))
            keys.append(("x", m))
        elif kind == "B" and not last:
            recvs.append((mb_shape, x.dtype, hops.next))
            keys.append(("g", m))
        inbox.update(zip(keys, hops.exchange(sends, recvs)))
    stash["peak"] = peak
    dx = torch.cat(dxs) if hops.prev is None else None
    return (stage_sum(loss, hops.group), stage_sum(aux_sum, hops.group),
            [p.grad for p in stage_params], [p.grad for p in head_params],
            dx)


__all__ = ["GPipeRun", "PIPELINE_AXIS", "gpipe", "num_stages",
           "pipeline_1f1b", "stage_layers", "stage_sum", "stash",
           "transport"]
