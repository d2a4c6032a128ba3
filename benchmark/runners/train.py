"""Training cells: the port's `setup_training` and `train_step`.

Set-up builds one training state with the port's AdamW (the
configuration's `assumed.optimizer`), puts the benchmark's seeded
weights into it, and drives it through the first `check_steps` steps of
the feed by the window's own call.  After step 1 it reads each leaf's
first gradient from the optimizer's second moment (nu = (1 - b2) g^2
after one step), after the last each leaf's change from the seed's
weights made again.  The window then goes on with the same state.  After
the window the state is freed and the reference follows the same steps.
"""

from __future__ import annotations

import time

import torch

from .. import checks
from .. import weights as W
from ..reference import adamw as ref_adamw
from ..reference.precision import PRECISIONS, strict_fp32

# the port's parameter of each weight group ({i}: the layer)
PORT_NAMES = {
    "embed": "embed.embedding", "head": "lm_head.kernel",
    "final_norm": "final_norm.scale",
    "attn_norm": "layers.{i}.attn_norm.scale",
    "q": "layers.{i}.attn.q.kernel", "k": "layers.{i}.attn.k.kernel",
    "v": "layers.{i}.attn.v.kernel", "out": "layers.{i}.attn.out.kernel",
    "mlp_norm": "layers.{i}.mlp_norm.scale",
}
DENSE = {g: f"layers.{{i}}.mlp.{g}.kernel" for g in ("gate", "up", "down")}
MOE = {"router": "layers.{i}.moe.router.kernel",
       **{g: f"layers.{{i}}.moe.experts.{g}.kernel"
          for g in ("gate", "up", "down")}}


def port_name(shape, key: str) -> str:
    group, _, index = key.partition("/")
    table = {**PORT_NAMES, **(MOE if shape.moe else DENSE)}
    return table[group].format(i=index)


def port_config(shape, mix: dict):
    from kubeflow_tpu_torch.models.configs import TransformerConfig

    a = shape.assumed
    extra = {}
    if shape.moe:
        extra = dict(moe_experts=shape.experts, moe_top_k=shape.top_k,
                     moe_capacity_factor=a["capacity_factor"],
                     moe_mlp_dim=shape.mlp, moe_aux_weight=shape.aux_coef,
                     moe_dispatch=a["moe_dispatch"])
    return TransformerConfig(
        vocab_size=shape.vocab, num_layers=shape.layers,
        embed_dim=shape.dim, num_heads=shape.heads,
        num_kv_heads=shape.kv_heads, head_dim=shape.head_dim,
        mlp_dim=shape.mlp, max_seq_len=mix["seq"],
        rope_theta=shape.rope_theta, norm_eps=shape.eps, dtype=a["dtype"],
        param_dtype=a["param_dtype"], attention_impl=a["attention_impl"],
        remat=a["remat_policy"] != "none", remat_policy=a["remat_policy"],
        loss_chunks=a["loss_chunks"], **extra)


class Runner:
    unit_span = "train_step"

    def __init__(self, ctx):
        self.ctx = ctx
        self.shape, self.mix = ctx.shape, ctx.mix
        self.opt = self.shape.assumed["optimizer"]
        self.steps = ctx.cell.get("check_steps", 3)
        self.readings = ref_adamw.Readings()
        self.prev = self.pending = None
        self.losses: list = []

    def setup(self) -> None:
        from kubeflow_tpu_torch.models.train import (
            default_optimizer,
            setup_training,
        )

        ctx, shape = self.ctx, self.shape
        opt = self.opt
        optimizer = default_optimizer(
            learning_rate=opt["learning_rate"],
            warmup_steps=opt["warmup_steps"], total_steps=opt["total_steps"],
            weight_decay=opt["weight_decay"],
            max_grad_norm=opt["max_grad_norm"], mu_dtype=opt["mu_dtype"])
        if (optimizer.b1, optimizer.b2, optimizer.eps) != (
                opt["b1"], opt["b2"], opt["eps"]):
            raise SystemExit("the port's default AdamW is not the "
                             "configuration's")
        self.setup_ = setup_training(port_config(shape, self.mix),
                                     device=ctx.device, seed=ctx.seed,
                                     optimizer=optimizer)
        params = dict(self.setup_.model.named_parameters())
        with torch.no_grad():
            for name in W.groups(shape):
                group = W.make(shape, name, ctx.seed, torch.float32,
                               ctx.device)
                for key in W.layer_slices(shape, name):
                    params[port_name(shape, key)].copy_(W.leaf(group, key))
                del group
        from ..traffic import TrainFeed

        self.feed = TrainFeed(self.mix, shape.vocab, ctx.seed, ctx.device)
        for step in range(self.steps):
            _, metrics = self.setup_.train_step(self.setup_.state,
                                                self.feed.next())
            self.readings.losses.append(float(metrics["loss"]))
            t0 = time.perf_counter()
            if step == 0:
                self.readings.grad = self._first_gradient()
            if step == self.steps - 1:
                self.readings.change = self._change()
            ctx.check_s += time.perf_counter() - t0

    def _first_gradient(self) -> dict:
        """{leaf: norm of the first clipped gradient}, from nu."""
        opt = self.setup_.state.optimizer
        nu = dict(zip(opt.names, opt.nu))
        b2 = self.opt["b2"]
        out = {}
        for name in W.groups(self.shape):
            for key in W.layer_slices(self.shape, name):
                total = nu[port_name(self.shape, key)].double().sum()
                out[key] = float(torch.sqrt(total / (1.0 - b2)))
        return out

    def _change(self) -> dict:
        params = dict(self.setup_.model.named_parameters())
        out = {}
        with torch.no_grad():
            for name in W.groups(self.shape):
                start = W.make(self.shape, name, self.ctx.seed,
                               torch.float32, self.ctx.device)
                for key in W.layer_slices(self.shape, name):
                    out[key] = float(torch.linalg.vector_norm(
                        params[port_name(self.shape, key)] - W.leaf(start,
                                                                    key)))
                del start
        return out

    def unit(self) -> int:
        _, metrics = self.setup_.train_step(self.setup_.state,
                                            self.feed.next())
        self.prev, last = metrics["loss"], self.prev
        self.pending = last
        return self.feed.tokens

    def boundary(self) -> None:
        """Wait for the step before the last: the host stays at most one
        step ahead, so the window's clock sees the device's progress."""
        if self.pending is not None:
            self.losses.append(float(self.pending))

    def finish(self) -> None:
        if self.prev is not None:
            self.losses.append(float(self.prev))

    def failed(self) -> int:
        return sum(1 for v in self.losses if v != v or abs(v) == float("inf"))

    def free(self) -> None:
        self.setup_ = None
        self.feed = None

    def reference(self, precision: str = "fp32", half_batch: bool = False):
        """The reference's readings over the same first steps."""
        from ..traffic import TrainFeed

        strict_fp32()
        feed = TrainFeed(self.mix, self.shape.vocab, self.ctx.seed,
                         self.ctx.device)
        batches = [feed.next() for _ in range(self.steps)]
        return ref_adamw.train(self.shape, self.opt, batches, self.ctx.seed,
                               self.ctx.device, PRECISIONS[precision], half_batch)

    def numbers(self, reference) -> dict:
        return checks.train_numbers(self.readings, reference)


__all__ = ["DENSE", "MOE", "PORT_NAMES", "Runner", "port_config",
           "port_name"]
