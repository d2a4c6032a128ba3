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
way in.  `load_flax_tree` loads the trees whose paths are already the
port's names (the ViT's, `vit_params_from_flax`, and the MNIST MLP's).
`flax_tree` is the inverse walk, and `opt_state_from_optax`
carries the reference's AdamW state across beside the parameters, so a
reference run can be continued in the port.

On a tensor mesh (`params_from_flax(..., mesh=)`, tensor-parallel
decode) the full tree goes to every rank, which keeps its block of each
leaf: the fused projections are first regrouped so that a contiguous cut
over "tensor" is one rank's (`regroup_fused`), then the rule table cuts
every leaf (models/train.py `shard_parameters`).
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


def regroup_fused(state: dict, cfg: TransformerConfig, ways: int) -> dict:
    """A state dict whose fused projections are ordered so that a
    contiguous cut into `ways` blocks gives each tensor rank its own:

    - qkv ([D, H+2kvH, Dh] and int8's [1, H+2kvH, Dh] scale, or int4's
      flat [K/2, (H+2kvH) Dh] and [K/64, 1, (H+2kvH) Dh]): heads ordered
      rank by rank, each rank's q heads, then its k heads, then its v;
    - int4's gate_up ([K/2, 2M], [K/64, 1, 2M], gate's M columns then
      up's): columns ordered rank by rank, each rank's gate block, then
      its up block.  The unflattened gate_up [D, 2, M] is cut over M as it
      is.

    Other leaves pass through."""
    if ways == 1:
        return state
    h, kvh, hd, m = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                     cfg.mlp_dim)
    qh, kh = h // ways, kvh // ways
    order = torch.cat([torch.cat([
        torch.arange(r * qh, (r + 1) * qh),
        h + torch.arange(r * kh, (r + 1) * kh),
        h + kvh + torch.arange(r * kh, (r + 1) * kh)]) for r in range(ways)])
    int4 = cfg.weight_dtype == "int4"
    out = {}
    for name, leaf in state.items():
        if ".attn.qkv." in name:
            lead = leaf.shape[:-1] if int4 else leaf.shape[:1]
            heads = leaf.reshape(lead + (h + 2 * kvh, hd))
            leaf = heads.index_select(len(lead), order).reshape(leaf.shape)
        elif ".mlp.gate_up." in name and int4:
            lead = leaf.shape[:-1]
            blocks = leaf.reshape(lead + (2, ways, m // ways))
            leaf = blocks.transpose(-3, -2).reshape(leaf.shape)
        out[name] = leaf
    return out


def params_from_flax(params: Mapping, cfg: TransformerConfig,
                     device="cuda", mesh=None) -> Transformer:
    """Build the port's Transformer for `cfg` and load the flax tree into
    it.  The tree's layout must be the one `cfg` builds (fused or not,
    bf16/int8/int4): a missing, extra or misshapen leaf raises.  With a
    tensor `mesh` (a decode config; models/transformer.py
    `check_decode_mesh`) the model is built on it and keeps this rank's
    block of every leaf of the full tree."""
    model = Transformer(cfg, device, mesh)
    state = state_dict_from_flax(params)
    if mesh is not None:
        from ..parallel.mesh import axis_size

        state = regroup_fused(state, cfg, axis_size(mesh, "tensor"))
    model.load_state_dict(state, strict=True)
    if mesh is not None:
        from .train import shard_parameters

        shard_parameters(model, mesh)
    return model


def load_flax_tree(module: torch.nn.Module, params: Mapping):
    """Load a flax param tree whose paths are `module`'s parameter names,
    `block_0/q/kernel` as `block_0.q.kernel` (the ViT's and the MNIST
    MLP's trees); a missing, extra or misshapen leaf raises.  Returns
    `module`."""
    flat = {}

    def walk(node, prefix):
        for key, val in node.items():
            name = f"{prefix}.{key}" if prefix else key
            if isinstance(val, Mapping):
                walk(val, name)
            else:
                flat[name] = to_tensor(val)

    walk(params, "")
    module.load_state_dict(flat, strict=True)
    return module


def vit_params_from_flax(params: Mapping, cfg, device="cuda"):
    """Build the port's ViT for `cfg` (a models.vit.ViTConfig) and load the
    reference ViT's flax param tree into it."""
    from .vit import ViT

    return load_flax_tree(ViT(cfg, device), params)


def flax_tree(model: Transformer) -> dict:
    """A port model's parameters in the reference's tree layout (what the
    quantizers and `generate` take): `layers.3.x` becomes `layer_3/x`.
    The leaves are the model's own tensors."""
    tree: dict = {}
    for name, tensor in model.state_dict().items():
        parts = name.split(".")
        if parts[0] == "layers":
            parts = [f"layer_{parts[1]}"] + parts[2:]
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = tensor
    return tree


def _adam_state(opt_state):
    """The ScaleByAdamState (`count`, `mu`, `nu`) inside an optax state,
    a nest of tuples and namedtuples."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for child in opt_state:
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def opt_state_from_optax(opt_state, b1: float = 0.9) -> dict:
    """The reference's optax state of `default_optimizer` (clip, then
    AdamW), its leaves as numpy (`jax.device_get` of the unboxed tree),
    -> the port's `AdamW.state_dict()`: `mu` and `nu` by port parameter
    name in their stored dtypes (bf16 under mu_dtype="bfloat16"),
    `count`, and `b1_mu`, b1 as a bf16 mu rounds it.  Load it with
    `AdamW.load_state_dict` into an optimizer built with the same
    arguments, beside `params_from_flax`'s parameters."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the "
                         "optax state")
    mu = state_dict_from_flax(adam.mu)
    dtypes = {t.dtype for t in mu.values()}
    if len(dtypes) != 1:
        raise ValueError(f"mu holds several dtypes {sorted(map(str, dtypes))}")
    dtype = dtypes.pop()
    # AdamW.init: b1 stays a Python float unless mu_dtype rounds it
    b1_mu = b1 if dtype == torch.float32 else torch.tensor(
        b1, dtype=dtype).item()
    return {"mu": mu, "nu": state_dict_from_flax(adam.nu),
            "count": int(np.asarray(adam.count)), "b1_mu": b1_mu}


__all__ = ["flax_tree", "load_flax_tree", "opt_state_from_optax",
           "params_from_flax", "regroup_fused", "state_dict_from_flax",
           "to_tensor", "vit_params_from_flax"]
