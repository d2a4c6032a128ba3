"""MNIST MLP: the BASELINE "v5e-1 single chip" smoke workload.

The port of kubeflow_tpu/models/mlp.py: dense layers `dense_i` with
flax's layouts (kernel [in, out], bias), ReLU between them, on flattened
inputs; trained by Adam at 1e-3 (optax.adam: models.train.adamw with no
weight decay) on softmax cross-entropy against integer labels.  Small on
purpose: it shows that a card answers and a step runs, not how fast.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .train import adamw
from .transformer import Dense, lecun_normal_


class MLP(nn.Module):
    """x [B, ...] -> logits [B, features[-1]] fp32."""

    def __init__(self, features: Sequence[int] = (512, 256, 10),
                 in_features: int = 28 * 28, device="cuda"):
        super().__init__()
        self.num_layers = len(features)
        for i, feat in enumerate(features):
            self.add_module(f"dense_{i}", Dense(in_features, feat, device))
            in_features = feat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_layers):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


def init_mlp_params(model: MLP, generator: torch.Generator) -> None:
    """flax's nn.Dense initializers: kernels lecun_normal, biases zeros."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Dense):
                lecun_normal_(mod.kernel, mod.kernel.shape[0], generator)
                mod.bias.zero_()


def train_steps(model: MLP, x: torch.Tensor, y: torch.Tensor,
                num_steps: int, learning_rate: float = 1e-3) -> list:
    """`num_steps` Adam steps on one batch; each step's loss, before its
    update, as a float."""
    params = list(model.parameters())
    opt = adamw(learning_rate, weight_decay=0.0)
    opt.init(params)
    losses = []
    for _ in range(num_steps):
        model.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(x), y.long())
        loss.backward()
        opt.step(params, [p.grad for p in params], None)
        losses.append(loss.detach())
    return [float(v) for v in losses]


def train_mnist_steps(num_steps: int = 20, batch: int = 128, seed: int = 0,
                      device="cuda") -> dict:
    """A training sanity loop on synthetic MNIST-shaped data (N(0, 1)
    images [B, 28, 28, 1], uniform labels, from a generator seeded
    `seed`): {"first_loss", "last_loss"}, so a caller can check that the
    loss fell."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, 28, 28, 1), generator=gen, device=device)
    y = torch.randint(0, 10, (batch,), generator=gen, device=device)
    model = MLP(device=device)
    init_mlp_params(model, gen)
    losses = train_steps(model, x, y, num_steps)
    return {"first_loss": losses[0], "last_loss": losses[-1]}


__all__ = ["MLP", "init_mlp_params", "train_mnist_steps", "train_steps"]
