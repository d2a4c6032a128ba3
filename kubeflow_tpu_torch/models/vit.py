"""ViT: the encoder of the BASELINE "v5e-8 single host" fine-tune workload.

The port of kubeflow_tpu/models/vit.py.  Parameters keep the flax
module's names and layouts, so its param tree loads leaf for leaf
(models/convert.py:vit_params_from_flax):

- `patch_embed` is flax's nn.Conv with the patch as kernel and stride:
  kernel [p, p, C, D] (HWIO) and a bias, on NHWC images.  With the stride
  equal to the kernel and the image a whole number of patches, 'SAME'
  padding adds nothing, so the convolution is one product of each
  patch's p * p * C values (in h, w, c order) with the flattened kernel;
- `pos_embed` [1, tokens, D] is stored in fp32 and cast to the
  activation dtype;
- each `block_i` holds bias-free q/k/v [D, H, Dh], out [H, Dh, D], up
  [D, M] and down [M, D] (the decoder's DenseGeneral) and two RMSNorms;
  the MLP's GELU is flax's default, the tanh approximation;
- `head` is a dense layer with a bias, run in fp32 after the mean pool.

Attention is bidirectional (causal=False) through ops.attention's
"auto" dispatch.  ViT-B/16's 196 tokens are no multiple of 128, so both
packages take the einsum path there, and the ViT path runs no hand-written
kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import prod

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from .train import AdamW
from .transformer import (
    Dense,
    DenseGeneral,
    RMSNorm,
    lecun_normal_,
    torch_dtype,
)


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    num_layers: int = 12
    embed_dim: int = 768
    num_heads: int = 12
    mlp_dim: int = 3072
    dtype: str = "bfloat16"


VIT_B16 = ViTConfig()
VIT_TINY = ViTConfig(
    image_size=32, patch_size=8, num_classes=10, num_layers=2,
    embed_dim=64, num_heads=4, mlp_dim=128, dtype="float32",
)


def vit_flops_per_image(cfg: ViTConfig) -> float:
    """Training (forward and backward) matmul FLOPs per image: 6 per
    matmul parameter per token, the bidirectional attention term
    12 * L * S * D per token, and the classifier head once per image."""
    tokens = (cfg.image_size // cfg.patch_size) ** 2
    d = cfg.embed_dim
    per_layer = 4 * d * d + 2 * d * cfg.mlp_dim
    matmul_params = (cfg.num_layers * per_layer
                     + cfg.patch_size * cfg.patch_size * 3 * d)
    attn = 12 * cfg.num_layers * tokens * d
    head = 6.0 * d * cfg.num_classes
    return (6.0 * matmul_params + attn) * tokens + head


class PatchEmbed(nn.Module):
    """nn.Conv(D, kernel (p, p), strides (p, p)) on NHWC images ->
    [B, tokens, D] in `dtype`."""

    def __init__(self, patch: int, channels: int, dim: int, dtype,
                 device="cuda"):
        super().__init__()
        self.patch, self.dtype = patch, dtype
        self.kernel = nn.Parameter(torch.zeros(
            (patch, patch, channels, dim), dtype=torch.float32,
            device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32,
                                             device=device))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        batch, height, width, channels = images.shape
        p = self.patch
        if height % p or width % p:
            raise ValueError(f"image {height}x{width} is not a whole "
                             f"number of {p}x{p} patches")
        patches = images.to(self.dtype).reshape(
            batch, height // p, p, width // p, p, channels
        ).transpose(2, 3).reshape(batch, -1, p * p * channels)
        kernel = self.kernel.to(self.dtype).reshape(p * p * channels, -1)
        return patches @ kernel + self.bias.to(self.dtype)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, device="cuda"):
        super().__init__()
        dtype, d = torch_dtype(cfg.dtype), cfg.embed_dim
        heads = (cfg.num_heads, d // cfg.num_heads)
        qkv = ("embed", "heads", "kv")

        def dense(contract, features, axes):
            return DenseGeneral(contract, features, dtype, torch.float32,
                                device, axes)

        self.attn_norm = RMSNorm(d, 1e-5, dtype, device)
        self.q, self.k, self.v = (dense(d, heads, qkv) for _ in range(3))
        self.out = dense(heads, d, ("heads", "kv", "embed"))
        self.mlp_norm = RMSNorm(d, 1e-5, dtype, device)
        self.up = dense(d, cfg.mlp_dim, ("embed", "mlp"))
        self.down = dense(cfg.mlp_dim, d, ("mlp", "embed"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn_norm(x)
        out = attention(self.q(h), self.k(h), self.v(h), causal=False)
        x = x + self.out(out)
        h = F.gelu(self.up(self.mlp_norm(x)), approximate="tanh")
        return x + self.down(h)


class ViT(nn.Module):
    """images [B, H, W, C] -> logits [B, num_classes] fp32.  Weights start
    as zeros (ones for norm scales); draw them with `init_vit_params` or
    load a flax tree with models.convert.vit_params_from_flax."""

    def __init__(self, cfg: ViTConfig, device="cuda"):
        super().__init__()
        self.cfg, self.device = cfg, torch.device(device)
        dtype, d = torch_dtype(cfg.dtype), cfg.embed_dim
        tokens = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embed = PatchEmbed(cfg.patch_size, 3, d, dtype, device)
        self.pos_embed = nn.Parameter(torch.zeros(
            (1, tokens, d), dtype=torch.float32, device=device))
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", ViTBlock(cfg, device))
        self.final_norm = RMSNorm(d, 1e-5, dtype, device)
        self.head = Dense(d, cfg.num_classes, device)

    def blocks(self) -> list:
        return [getattr(self, f"block_{i}")
                for i in range(self.cfg.num_layers)]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dtype = torch_dtype(self.cfg.dtype)
        x = self.patch_embed(images)
        x = (x + self.pos_embed.to(dtype)).to(dtype)
        for block in self.blocks():
            x = block(x)
        return self.head(self.final_norm(x).mean(dim=1))


def init_vit_params(model: ViT, generator: torch.Generator) -> None:
    """Draw fresh weights in place, as the flax initializers do: dense and
    conv kernels lecun_normal (fan_in the product of the contracted dims,
    p * p * C for the conv), biases zeros, `pos_embed` N(0, 0.02^2), norm
    scales ones.  `generator` lives on the model's device."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, DenseGeneral):
                lecun_normal_(mod.kernel, prod(mod.contract), generator)
            elif isinstance(mod, (Dense, PatchEmbed)):
                lecun_normal_(mod.kernel, mod.kernel[..., 0].numel(),
                              generator)
                mod.bias.zero_()
            elif isinstance(mod, RMSNorm):
                mod.scale.fill_(1.0)
        model.pos_embed.normal_(0.0, 0.02, generator=generator)


def vit_train_step(model: ViT, optimizer: AdamW, images: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """One step of mean softmax cross-entropy against integer labels:
    loss, gradients, `optimizer` on every parameter (models.train.adamw
    (1e-4) is the reference bench's optax.adamw(1e-4); init it with
    `optimizer.init(model.parameters())` first).  Returns the loss before
    the update, on the device."""
    params = list(model.parameters())
    model.zero_grad(set_to_none=True)
    loss = F.cross_entropy(model(images), labels.long())
    loss.backward()
    optimizer.step(params, [p.grad for p in params], None)
    return loss.detach()


__all__ = ["PatchEmbed", "VIT_B16", "VIT_TINY", "ViT", "ViTBlock",
           "ViTConfig", "init_vit_params", "vit_flops_per_image",
           "vit_train_step"]
