"""The reference package's flax param tree -> the port's modules.

The port names its parameters after the flax tree, so conversion is a
walk: `{"layer_3": {"attn": {"q": {"kernel": a}}}}` is the port's
`layers.3.attn.q.kernel`.  Leaves are numpy arrays (as `jax.device_get`
returns them) or torch tensors; every dense layout of the reference loads
as it is stored: q/k/v [D, H, Dh], out [H, Dh, D], gate/up [D, M], down
[M, D], embed [V, D], lm_head [D, V], fused qkv [D, H+2kvH, Dh] and
gate_up [D, 2, M], int8 {kernel_q, kernel_scale}, int4 {kernel_q4,
kernel_scale}, norm `scale`, and a MoE layer's `moe/router/kernel` [D, E]
with `moe/experts/{gate,up,down}` stacked over the experts ([E, D, M],
[E, M, D]; int8 scales [E, 1, M]).  A stacked `layers` subtree (leading
[L] axis, the reference's scan_layers=True layout) is unrolled on the
way in.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .configs import TransformerConfig
from .transformer import Transformer


def to_tensor(leaf) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16, which torch.from_numpy
    refuses) or torch leaf -> a torch tensor of the same dtype and bits."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.ascontiguousarray(np.asarray(leaf))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _unrolled(params: Mapping) -> dict:
    if "layers" not in params:
        return dict(params)
    from .generate import unroll_params

    return unroll_params(params)


def state_dict_from_flax(params: Mapping) -> dict:
    """Flax param tree -> {port parameter name: tensor}."""
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            if key.startswith("layer_"):
                key = "layers." + key[len("layer_"):]
            name = f"{prefix}.{key}" if prefix else key
            if isinstance(val, Mapping):
                walk(val, name)
            else:
                out[name] = to_tensor(val)

    walk(_unrolled(params), "")
    return out


def params_from_flax(params: Mapping, cfg: TransformerConfig,
                     device="cuda") -> Transformer:
    """Build the port's Transformer for `cfg` and load the flax tree into
    it.  The tree's layout must be the one `cfg` builds (fused or not,
    bf16/int8/int4): a missing, extra or misshapen leaf raises."""
    model = Transformer(cfg, device)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


__all__ = ["params_from_flax", "state_dict_from_flax", "to_tensor"]
