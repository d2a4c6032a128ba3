"""Autoregressive generation with a preallocated KV cache.

The port of kubeflow_tpu/models/generate.py.  A prefill runs the whole
prompt through the decode path in one call, filling the cache, then
`max_new_tokens - 1` single-token steps follow, each at its global
position.  The cache is one [B, kvH, max_seq_len, Dh] tensor per layer,
written in place (models/transformer.py KVCache), where the reference
threads it functionally through a lax.scan.

The single-token step (`DecodeStep`) works on fixed buffers: the last
token, the cache's fill index on the device and the output tokens.  On a
CUDA device `generate` captures it once as a CUDA graph and replays the
graph once a token (`GraphedStep`), the counterpart of the reference's
one compiled scan: a replay launches the step's several hundred kernels
without Python, and writes nothing from the host.  The prefill stays
eager, and on the CPU the whole loop is eager.  `cuda_graph=False` runs
the eager loop on the card too, for holding the graph against it.
MoE's "sort" dispatch sizes a buffer from a host read (torch.bincount),
so a config with it runs the eager loop by choice (`capturable`).

Sampling is greedy (temperature 0) or temperature + top-k from a
`torch.Generator`, which the graph registers; its bits differ from
jax.random's, so the two packages agree exactly only under greedy
decoding.

With a `mesh` (the reference's argument) whose only populated axis is
"tensor", every rank builds the decoder on it and decodes its block:
heads, kv heads (its own KV cache), MLP and vocabulary split over
"tensor" (models/transformer.py `check_decode_mesh`, models/convert.py
`params_from_flax(..., mesh=)`).  The head gives each rank its slice of
the vocabulary; the step all-gathers the logits over "tensor" and
samples on the whole row, so every rank, drawing from an identically
seeded generator, holds the same tokens.  The step is captured per rank
only where the tensor group's backend is NCCL: a gloo collective cannot
be captured, so on gloo the loop is eager.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional, Union

import torch
import torch.distributed as dist

from ..ops import int4_matmul, launch_counts
from ..parallel.collectives import gather_from
from .configs import TransformerConfig
from .transformer import KVCache, Transformer


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
    return race(torch.softmax(logits, dim=-1), generator)


def race(probs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw from each row of `probs` [B, V]: torch.multinomial's draw
    of one sample (an exponential race, the argmax of p / E with E ~
    Exp(1)), less its host-side check of the probabilities, which a
    captured step cannot make."""
    e = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / e, dim=-1)


def vocab_group(model: Transformer):
    """The group over which `model`'s logits are split, None without a
    mesh: the mesh's "tensor" group, of one rank too, so that a world-1
    mesh gathers its logits through its backend as a wider one does."""
    return None if model.mesh is None else model.mesh.get_group("tensor")


def full_logits(logits: torch.Tensor, group) -> torch.Tensor:
    """[..., V / tp] logits of this rank's vocabulary block -> [..., V],
    the blocks all-gathered over `group` in rank order."""
    return gather_from(logits, group, dim=-1)


def capturable(cfg: TransformerConfig) -> bool:
    """Whether `cfg`'s single-token step can be captured as a CUDA graph:
    every config but MoE's "sort" dispatch, whose torch.bincount reads
    the largest expert index back to the host to size its output."""
    return not (cfg.moe_experts > 0 and cfg.moe_dispatch == "sort")


class DecodeStep:
    """One single-token step of `generate` on fixed buffers.

    `tokens` [B, P + N] int64 holds the sequence; after the prefill its
    column `cache.index` holds the first sampled token.  A call feeds
    `last` (the token at the cache's fill index) at that position,
    samples the next token, writes it into `tokens` at the advanced fill
    index and into `last`.  Every position and index is read from the
    device (`cache.pos`), so a captured call replays as the next step.
    On a mesh the logits are gathered over "tensor" before sampling."""

    def __init__(self, model: Transformer, cache: KVCache,
                 tokens: torch.Tensor, temperature: float = 0.0,
                 top_k: int = 0,
                 generator: Optional[torch.Generator] = None):
        self.model, self.cache, self.tokens = model, cache, tokens
        self.temperature, self.top_k = temperature, top_k
        self.generator = generator
        self.group = vocab_group(model)
        self.last = tokens[:, cache.index].clone()

    def __call__(self) -> None:
        cache, batch = self.cache, self.last.shape[0]
        logits = self.model(self.last[:, None],
                            positions=cache.pos.expand(batch, 1),
                            cache=cache)
        tok = sample_token(full_logits(logits[:, -1, :], self.group),
                           self.generator, self.temperature, self.top_k)
        self.tokens.index_copy_(1, cache.pos.view(1), tok[:, None])
        self.last.copy_(tok)


def warm_up(fn, device: torch.device) -> None:
    """fn() once on a side stream: the warm-up PyTorch asks for before a
    capture (cuBLAS workspaces, the int4 kernel's split-K counters and
    the kernel libraries come into being outside the graph)."""
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)


class CapturedCall:
    """fn() captured as one CUDA graph.  The capture runs no kernel: it
    records them.  What the kernels' wrappers counted during it is taken
    back and credited at each replay (ops/launch_counts.py).  A sampling
    call's `generator` is registered with the graph, so each replay draws
    anew.  The graph keeps the int4 kernel's split-K counter buffers it
    was captured with, so an eager call that replaces them cannot free
    them under it."""

    def __init__(self, fn, generator: Optional[torch.Generator] = None):
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        before = launch_counts.snapshot()
        with torch.cuda.graph(self.graph):
            fn()
        # the int4 kernel's counters live outside the graph's memory pool
        self.counters = int4_matmul.counter_buffers()
        self.launches = launch_counts.since(before)
        launch_counts.restore(before)

    def replay(self, times: int = 1) -> None:
        for _ in range(times):
            self.graph.replay()
        launch_counts.credit(self.launches, times)


class GraphedStep:
    """A `DecodeStep` captured as one CUDA graph, replayed once a token.

    Construction runs the step once eagerly (`warm_up`); that is the
    run's first step, and its token is kept: it advances the cache, so
    the capture that follows records the step at the next position, and
    no position is written twice.  The cache's host mirror, which the
    captured call advanced, is set back."""

    def __init__(self, step: DecodeStep):
        cache = step.cache
        warm_up(step, cache.pos.device)
        self.step, index = step, cache.index
        self.captured = CapturedCall(
            step, step.generator if step.temperature > 0.0 else None)
        cache.index = index

    def replay(self, steps: int) -> None:
        """Run `steps` more steps, one replay each."""
        cache = self.step.cache
        rows = cache.k[0].shape[2]
        if cache.index + steps > rows:
            raise ValueError(f"cache holds {rows} positions; cannot run "
                             f"{steps} steps from {cache.index}")
        self.captured.replay(steps)
        cache.index += steps


def generate(cfg: TransformerConfig, params: Union[Mapping, Transformer],
             prompt, max_new_tokens: int, temperature: float = 0.0,
             top_k: int = 0, generator: Optional[torch.Generator] = None,
             mesh=None, unroll_layers: bool = True, device="cuda",
             cuda_graph: bool = True) -> torch.Tensor:
    """prompt [B, P] -> [B, P + max_new_tokens] token ids on `device`.

    `params` is a reference-layout param tree (nested dicts of numpy
    arrays or tensors, stacked or unrolled; converted with
    prepare_decode(cfg, params, unroll_layers) and params_from_flax) or a
    port Transformer built for `cfg` itself (a decode config).  Prompts
    are unpadded and of equal length, and P + max_new_tokens must fit
    cfg.max_seq_len.  `generator` takes the reference's `rng`.  `mesh`
    decodes tensor-parallel (a tree is converted into this rank's blocks;
    a Transformer must have been built on `mesh`); every rank returns the
    whole sequence.  On a CUDA device the single-token steps replay one
    captured graph unless `cuda_graph=False`, the config is not
    `capturable` or the mesh's tensor group is not on NCCL."""
    if isinstance(params, Transformer):
        model = params
        if cfg != model.cfg:
            raise ValueError("generate got a Transformer built for another "
                             "config than `cfg`")
        if mesh is not None and mesh is not model.mesh:
            raise ValueError("generate got a Transformer built on another "
                             "mesh than `mesh`")
        device = model.device
    else:
        from .convert import params_from_flax

        cfg, tree = prepare_decode(cfg, params, unroll_layers=unroll_layers)
        model = params_from_flax(tree, cfg, device, mesh)
    prompt = torch.as_tensor(prompt, device=device).to(torch.int64)
    batch, prompt_len = prompt.shape
    total = prompt_len + max_new_tokens
    if total > model.cfg.max_seq_len:
        raise ValueError(f"prompt({prompt_len}) + new({max_new_tokens}) "
                         f"exceeds max_seq_len {model.cfg.max_seq_len}")
    if generator is None and temperature > 0.0:
        generator = torch.Generator(device=device).manual_seed(0)
    group = vocab_group(model)
    graphed = (cuda_graph and model.device.type == "cuda"
               and capturable(model.cfg)
               and (group is None or dist.get_backend(group) == "nccl"))

    with torch.inference_mode():
        cache = model.new_cache(batch)
        tokens = torch.zeros((batch, total), dtype=torch.int64,
                             device=model.device)
        tokens[:, :prompt_len] = prompt
        logits = model(prompt, cache=cache)
        tokens[:, prompt_len] = sample_token(
            full_logits(logits[:, -1, :], group), generator, temperature,
            top_k)
        del logits
        step = DecodeStep(model, cache, tokens, temperature, top_k,
                          generator)
        steps = max_new_tokens - 1
        if graphed and steps > 1:
            GraphedStep(step).replay(steps - 1)   # the first step warms up
        else:
            for _ in range(steps):
                step()
        return tokens


__all__ = ["CapturedCall", "DecodeStep", "GraphedStep", "capturable",
           "decode_config", "full_logits", "fuse_decode_params", "generate",
           "prepare_decode", "race", "sample_token", "unroll_params",
           "vocab_group", "warm_up"]
