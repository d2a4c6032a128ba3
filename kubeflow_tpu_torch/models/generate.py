"""Autoregressive generation with a preallocated KV cache.

The port of kubeflow_tpu/models/generate.py.  A prefill runs the whole
prompt through the decode path in one call, filling the cache, then
`max_new_tokens - 1` single-token steps follow, each at its global
position.  The cache is one [B, kvH, max_seq_len, Dh] tensor per layer,
written in place (models/transformer.py KVCache), where the reference
threads it functionally through a lax.scan.  Tokens stay on the device
and no step waits for the host.

Sampling is greedy (temperature 0) or temperature + top-k from a
`torch.Generator`; its bits differ from jax.random's, so the two packages
agree exactly only under greedy decoding.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional, Union

import torch

from .configs import TransformerConfig
from .transformer import Transformer


def decode_config(cfg: TransformerConfig,
                  unroll_layers: bool = True) -> TransformerConfig:
    """Training config -> decode config: remat off, XLA attention, unrolled
    layers, and (when converting a training config) fused projections and
    staged KV writes; a config already stamped `decode` keeps its own
    fused_projections/staged_kv choices."""
    already_decode = cfg.decode
    fused = cfg.fused_projections if already_decode else True
    staged = cfg.staged_kv if already_decode else True
    if not unroll_layers:
        if already_decode and cfg.staged_kv:
            raise ValueError("staged_kv is not supported under scanned "
                             "layers")
        staged = False
    return cfg.with_(decode=True, remat=False, attention_impl="xla",
                     scan_layers=not unroll_layers,
                     fused_projections=fused, staged_kv=staged)


def unroll_params(params: Mapping, num_layers: Optional[int] = None) -> dict:
    """Stacked `layers` subtree (leading layer axis) -> `layer_i` subtrees.
    The layer count defaults to the stacked leading dim."""
    if "layers" not in params:
        return dict(params)
    stacked = params["layers"]

    def first_leaf(node):
        return first_leaf(next(iter(node.values()))) \
            if isinstance(node, Mapping) else node

    if num_layers is None:
        num_layers = first_leaf(stacked).shape[0]

    def take(node, i):
        if isinstance(node, Mapping):
            return {k: take(v, i) for k, v in node.items()}
        return node[i]

    rest = {k: v for k, v in params.items() if k != "layers"}
    for i in range(num_layers):
        rest[f"layer_{i}"] = take(stacked, i)
    return rest


def _cat(parts, axis: int, stack: bool):
    if isinstance(parts[0], torch.Tensor):
        return (torch.stack if stack else torch.cat)(parts, dim=axis)
    import numpy as np

    return (np.stack if stack else np.concatenate)(parts, axis=axis)


def fuse_decode_params(params: Mapping) -> dict:
    """Separate q/k/v and gate/up kernels -> one qkv kernel [D, H+2kvH, Dh]
    and one gate_up kernel [D, 2, M] per layer.  Runs before quantization
    (scales do not concatenate); a no-op on a fused tree."""
    def fuse_layer(layer):
        layer = dict(layer)
        attn = layer.get("attn")
        if attn is not None and "q" in attn:
            attn = dict(attn)
            attn["qkv"] = {"kernel": _cat(
                [attn.pop(n)["kernel"] for n in ("q", "k", "v")], 1, False)}
            layer["attn"] = attn
        mlp = layer.get("mlp")
        if mlp is not None and "gate" in mlp:
            mlp = dict(mlp)
            mlp["gate_up"] = {"kernel": _cat(
                [mlp.pop(n)["kernel"] for n in ("gate", "up")], 1, True)}
            layer["mlp"] = mlp
        return layer

    return {k: (fuse_layer(v) if k.startswith("layer_") else v)
            for k, v in params.items()}


def prepare_decode(cfg: TransformerConfig, params: Mapping,
                   unroll_layers: bool = True):
    """(training cfg, training-or-quantized tree) -> (decode cfg,
    decode-layout tree): unroll a stacked tree, then fuse q/k/v and
    gate/up when the tree still holds raw `kernel`s.  A quantized unfused
    tree cannot be fused, so its decode config keeps the unfused layout."""
    cfg = decode_config(cfg, unroll_layers=unroll_layers)
    if cfg.scan_layers:
        return cfg.with_(fused_projections=False), params
    params = unroll_params(params, cfg.num_layers)
    attn0 = params.get("layer_0", {}).get("attn", {})
    if not cfg.fused_projections or "qkv" in attn0:
        return cfg, params
    if "kernel" in attn0.get("q", {}):
        return cfg, fuse_decode_params(params)
    return cfg.with_(fused_projections=False), params


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 temperature: float, top_k: int = 0) -> torch.Tensor:
    """[B, V] logits -> [B] token ids: argmax under temperature 0 (or no
    generator), else a draw from softmax(logits / temperature) restricted
    to the top_k largest logits when top_k > 0."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1)
    logits = logits.to(torch.float32) / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(cfg: TransformerConfig, params: Union[Mapping, Transformer],
             prompt, max_new_tokens: int, temperature: float = 0.0,
             top_k: int = 0, generator: Optional[torch.Generator] = None,
             device="cuda") -> torch.Tensor:
    """prompt [B, P] -> [B, P + max_new_tokens] token ids on `device`.

    `params` is a reference-layout param tree (nested dicts of numpy
    arrays or tensors, stacked or unrolled; converted with
    prepare_decode and params_from_flax) or a port Transformer built for
    `cfg` itself (a decode config).  Prompts are unpadded and of equal length, and
    P + max_new_tokens must fit cfg.max_seq_len."""
    if isinstance(params, Transformer):
        model = params
        if cfg != model.cfg:
            raise ValueError("generate got a Transformer built for another "
                             "config than `cfg`")
        device = model.device
    else:
        from .convert import params_from_flax

        cfg, tree = prepare_decode(cfg, params)
        model = params_from_flax(tree, cfg, device)
    prompt = torch.as_tensor(prompt, device=device).to(torch.int64)
    batch, prompt_len = prompt.shape
    if prompt_len + max_new_tokens > model.cfg.max_seq_len:
        raise ValueError(f"prompt({prompt_len}) + new({max_new_tokens}) "
                         f"exceeds max_seq_len {model.cfg.max_seq_len}")
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=device).manual_seed(0)

    with torch.inference_mode():
        cache = model.new_cache(batch)
        logits = model(prompt, cache=cache)
        tok = sample_token(logits[:, -1, :], generator, temperature, top_k)
        tokens = [tok]
        for step in range(max_new_tokens - 1):
            positions = torch.full((batch, 1), prompt_len + step,
                                   device=device)
            logits = model(tok[:, None], positions=positions, cache=cache)
            tok = sample_token(logits[:, -1, :], generator, temperature,
                               top_k)
            tokens.append(tok)
        return torch.cat([prompt, torch.stack(tokens, dim=1)], dim=1)


__all__ = ["decode_config", "fuse_decode_params", "generate",
           "prepare_decode", "sample_token", "unroll_params"]
