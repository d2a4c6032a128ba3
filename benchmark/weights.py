"""Seeded weights, made by the benchmark on the device and handed to both
sides: the port gets them at set-up, the reference makes them again.

Each group is one stacked tensor over the layers (q [L, D, H, Dh], an
expert stack [L, E, D, M], ...) drawn by one call from a generator of
its own seeded from (seed, group), so a group can be made again alone.
Matrices are N(0, init_std^2), RMSNorm scales 1 + N(0, 0.1^2).
"""

from __future__ import annotations

import torch

from .shapes import Shape

NORMS = ("attn_norm", "mlp_norm", "final_norm")


def groups(shape: Shape) -> dict:
    """{group: its stacked shape}, in draw order."""
    L, D, H, K, Dh = (shape.layers, shape.dim, shape.heads, shape.kv_heads,
                      shape.head_dim)
    M, V, E = shape.mlp, shape.vocab, shape.experts
    out = {"embed": (V, D), "attn_norm": (L, D), "q": (L, D, H, Dh),
           "k": (L, D, K, Dh), "v": (L, D, K, Dh), "out": (L, H, Dh, D),
           "mlp_norm": (L, D)}
    if shape.moe:
        out.update(router=(L, D, E), gate=(L, E, D, M), up=(L, E, D, M),
                   down=(L, E, M, D))
    else:
        out.update(gate=(L, D, M), up=(L, D, M), down=(L, M, D))
    out.update(final_norm=(D,), head=(D, V))
    return out


def group_seed(seed: int, name: str) -> int:
    """A generator seed of (run seed, group), inside torch's 64 bits."""
    salt = sum((i + 1) * ord(c) for i, c in enumerate(name))
    return (int(seed) * 1_000_003 + salt * 7919) % (2 ** 63)


def make(shape: Shape, name: str, seed: int, dtype=torch.float32,
         device="cuda") -> torch.Tensor:
    """Group `name` of `shape` for run `seed`, in `dtype` on `device`."""
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, name))
    t = torch.randn(groups(shape)[name], generator=gen, dtype=dtype,
                    device=device)
    if name in NORMS:
        return t.mul_(shape.assumed.get("norm_scale_std", 0.1)).add_(1.0)
    return t.mul_(shape.init_std)


def layer_slices(shape: Shape, name: str) -> list:
    """The leaf keys of group `name`: one a layer for stacked groups."""
    if name in ("embed", "final_norm", "head"):
        return [name]
    return [f"{name}/{i}" for i in range(shape.layers)]


def leaf(group: torch.Tensor, key: str) -> torch.Tensor:
    """Leaf `key` ("q/3" or "embed") of its group's stacked tensor."""
    _, _, index = key.partition("/")
    return group[int(index)] if index else group


__all__ = ["NORMS", "group_seed", "groups", "layer_slices", "leaf", "make"]
