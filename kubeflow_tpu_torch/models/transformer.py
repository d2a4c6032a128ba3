"""Llama-family decoder in PyTorch: the port of kubeflow_tpu/models/
transformer.py for the serving and training paths.

- Parameters keep the reference's names and layouts, so the flax param
  tree loads leaf for leaf (models/convert.py): dense kernels are
  [contract..., features...] (q/k/v [D, H, Dh], out [H, Dh, D], the fused
  qkv [D, H+2kvH, Dh] and gate_up [D, 2, M]), norms carry an fp32
  `scale`, the embedding table is `embed.embedding` [V, D].
- Layers are an nn.ModuleList run by a Python loop (no scan).  With
  cfg.remat each layer runs under torch.utils.checkpoint when gradients
  are on, per cfg.remat_policy (`REMAT_POLICIES`).
- Training attention goes through `ops.attention.attention` with
  cfg.attention_impl ("flash" runs the Hopper kernels on the card).
- `init_params` draws the reference's flax initializers.
- Decode keeps a preallocated [B, kvH, max_seq_len, Dh] cache per layer
  (`KVCache`) and writes each call's keys and values into it in place;
  the reference threads the same cache through its steps functionally.
- MoE configs (cfg.moe_experts > 0) put models/moe.py's MoEMLP in each
  layer's `moe` slot; the stack sums its load-balance losses, which
  `forward(..., return_aux=True)` returns beside the output.
- Every parameter records the reference's logical axis names
  (`param.logical_axes`, e.g. q ("embed", "heads", "kv")), so one rule
  table (parallel/sharding.py) shards the model on a mesh.
- On a mesh (`Transformer(cfg, device, mesh)`, sharded by
  models.train.parallelize) heads, the MLP hidden dim and the vocabulary
  are split over "tensor": q/k/v and gate/up are column-parallel, out and
  down row-parallel with an all-reduce over the tensor group, the
  embedding masks the rows it does not own and all-reduces, and the LM
  head returns this rank's slice of the vocabulary.  Attention is ring
  attention over "sequence" when that axis is populated.  Layers read
  their local sizes from their parameters' shapes.
- A decode config (`cfg.decode`) on a mesh whose only populated axis is
  "tensor" decodes tensor-parallel (`check_decode_mesh`): int4/int8
  weights and fused projections are allowed there, the fused qkv block
  of a rank holds its q, k and v heads (models/convert.py regroups
  them), and `new_cache` holds the rank's kv heads.
- On a mesh with a populated "pipeline" axis each rank builds only its
  stage's decoder layers (parallel/pipeline.py:stage_layers), named by
  their global indices (`layers.4.attn.q.kernel` on the second of two
  stages of 8 layers), beside the embedding, final norm and head, which
  every stage holds; such a model trains through models/train.py's
  pipelined step, not through `forward`.
- Entry points build on "cuda" unless the caller passes device="cpu".
"""

from __future__ import annotations

import functools
from math import prod
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.attention import attention, decode_attention
from ..parallel.collectives import copy_to, reduce_from
from ..parallel.mesh import axis_group, axis_rank, axis_size, mesh_sizes
from ..parallel.pipeline import stage_layers
from .configs import TransformerConfig
from .quant import Int4Linear, Int8Linear, StackedInt8Linear, _as_tuple

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# What each layer's checkpoint keeps across forward and backward (the
# reference's _REMAT_POLICIES): the ops whose outputs are saved; every
# other op of the layer is recomputed in the backward.
#   nothing - save nothing (plain checkpoint);
#   dots    - save the dense layers' 2-D matmuls (the reference's
#             "dots with no batch dims": not the attention einsums);
#   attn    - save the flash forward's outputs (the reference's
#             checkpoint_name "attn_out"), so the recompute skips the
#             flash kernel; the "xla" path has no such op and recomputes
#             all;
#   none    - no checkpoint.
REMAT_POLICIES = {
    "nothing": (),
    "dots": (torch.ops.aten.mm.default,),
    "attn": (torch.ops.kubeflow_tpu_torch.flash_fwd.default,),
    "none": None,
}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def logical(param: nn.Parameter, axes: tuple) -> nn.Parameter:
    """Record the reference's logical axis names on a parameter."""
    param.logical_axes = axes
    return param


class RMSNorm(nn.Module):
    """fp32 statistics and an fp32 scale; the output in `dtype`."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = logical(nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device)), ("norm",))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        norm = x32 * torch.rsqrt(
            torch.mean(x32 * x32, dim=-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(self.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding on [B, S, H, D]: split-half convention, fp32 trig,
    positions taken as given (global positions in decode).  The frequency
    table is made on x's device: a copy from host memory would make every
    call wait for the card."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angle = positions[..., None].to(torch.float32) * freq   # [B, S, half]
    cos = torch.cos(angle)[:, :, None, :]
    sin = torch.sin(angle)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


class DenseGeneral(nn.Module):
    """Bias-free dense layer over the trailing `contract` dims, kernel in
    the reference's [contract..., features...] layout; kernel and input
    are cast to `dtype` for the product (flax DenseGeneral).  `axes` are
    the kernel's logical names.  The product takes its sizes from the
    kernel, so a tensor-parallel shard computes its own block."""

    def __init__(self, contract, features, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device="cuda", axes=None):
        super().__init__()
        self.contract, self.features = _as_tuple(contract), _as_tuple(features)
        self.dtype = dtype
        self.kernel = logical(nn.Parameter(torch.zeros(
            self.contract + self.features, dtype=param_dtype,
            device=device)), axes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        nc = len(self.contract)
        shape = self.kernel.shape
        k = prod(shape[:nc])
        lead = x.shape[:x.dim() - nc]
        out = x.to(self.dtype).reshape(-1, k) @ \
            self.kernel.to(self.dtype).reshape(k, -1)
        return out.reshape(lead + shape[nc:])


class Dense(nn.Module):
    """flax's nn.Dense: kernel [in, out] and bias [out], fp32 parameters
    and an fp32 product (the ViT head and the MNIST MLP)."""

    def __init__(self, features_in: int, features_out: int, device="cuda"):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(
            (features_in, features_out), dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(
            features_out, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.float32) @ self.kernel + self.bias


def _dense(contract, features, cfg: TransformerConfig, device,
           axes: tuple) -> nn.Module:
    """bf16/fp32, int8 or int4 dense layer, per cfg.weight_dtype."""
    dtype = torch_dtype(cfg.dtype)
    if cfg.weight_dtype in ("int8", "int4"):
        cls = Int8Linear if cfg.weight_dtype == "int8" else Int4Linear
        return cls(contract, features, dtype=dtype, device=device, axes=axes)
    if cfg.weight_dtype:
        raise ValueError(f"unknown weight_dtype {cfg.weight_dtype!r}")
    return DenseGeneral(contract, features, dtype,
                        torch_dtype(cfg.param_dtype), device, axes)


class KVCache:
    """Per-layer [B, kvH, max_seq_len, Dh] key and value buffers, written
    in place, and the fill index shared by all layers.

    The fill index lives on the device as `pos`, a 0-dim int64 tensor:
    writes land at `pos + arange(q_len)` and the stack advances it in
    place, so a step that a CUDA graph replays moves it without the host.
    `index` is its host mirror, for the bounds check and for the callers
    that steer by it (models/speculative.py); whoever moves one moves the
    other (`set_index`)."""

    def __init__(self, cfg: TransformerConfig, batch: int, dtype,
                 device="cuda"):
        shape = (batch, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim)
        self.k = [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(cfg.num_layers)]
        self.v = [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(cfg.num_layers)]
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.index = 0

    def set_index(self, index: int) -> None:
        """Move the fill index, host mirror and device tensor, to `index`."""
        self.index = index
        self.pos.fill_(index)


_QKV = ("embed", "heads", "kv")


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device="cuda", mesh=None):
        super().__init__()
        self.cfg, self.mesh = cfg, mesh
        d, h, kvh, hd = (cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim)
        if cfg.fused_projections:
            self.qkv = _dense(d, (h + 2 * kvh, hd), cfg, device, _QKV)
        else:
            self.q = _dense(d, (h, hd), cfg, device, _QKV)
            self.k = _dense(d, (kvh, hd), cfg, device, _QKV)
            self.v = _dense(d, (kvh, hd), cfg, device, _QKV)
        self.out = _dense((h, hd), d, cfg, device, ("heads", "kv", "embed"))

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                kv: Optional[tuple] = None,
                slots: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        # this rank's heads: a fused block holds its q, then k, then v
        ways = axis_size(self.mesh, "tensor")
        h, kvh = cfg.num_heads // ways, cfg.num_kv_heads // ways
        tp = axis_group(self.mesh, "tensor")
        x = copy_to(x, tp)
        if cfg.fused_projections:
            qkv = self.qkv(x)
            q, k, v = qkv[..., :h, :], qkv[..., h:h + kvh, :], \
                qkv[..., h + kvh:, :]
        else:
            q, k, v = self.q(x), self.k(x), self.v(x)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if kv is not None:
            # decode: rope used global positions, so cached keys need no
            # re-rotation.  The reference's staged_kv option stages
            # single-token writes in an 8-row buffer to suit the TPU's
            # (8, 128) tiles; here every write goes straight into the
            # cache, which holds the same logical contents.  `slots` are
            # the cache rows of this call's tokens, a device tensor, so
            # the write needs no host value (Transformer.run_stack checked
            # the bounds on the host mirror).
            k_cache, v_cache = kv
            k_cache.index_copy_(2, slots, k.transpose(1, 2).to(k_cache.dtype))
            v_cache.index_copy_(2, slots, v.transpose(1, 2).to(v_cache.dtype))
            out = decode_attention(q, k_cache, v_cache, q_offset=slots[0])
        elif cfg.attention_impl == "ring" or \
                axis_size(self.mesh, "sequence") > 1:
            # a sequence-sharded mesh always takes the ring: a local
            # attention would miss the other ranks' keys
            out = attention(q, k, v, causal=True, impl="ring",
                            positions=positions,
                            group=axis_group(self.mesh, "sequence"))
        else:
            out = attention(q, k, v, causal=True, impl=cfg.attention_impl)
        return reduce_from(self.out(out), tp)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device="cuda", mesh=None):
        super().__init__()
        self.fused, self.mesh = cfg.fused_projections, mesh
        d, m = cfg.embed_dim, cfg.mlp_dim
        if self.fused:
            self.gate_up = _dense(d, (2, m), cfg, device,
                                  ("embed", None, "mlp"))
        else:
            self.gate = _dense(d, m, cfg, device, ("embed", "mlp"))
            self.up = _dense(d, m, cfg, device, ("embed", "mlp"))
        self.down = _dense(m, d, cfg, device, ("mlp", "embed"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = axis_group(self.mesh, "tensor")
        x = copy_to(x, tp)
        if self.fused:
            gu = self.gate_up(x)
            gate, up = gu[..., 0, :], gu[..., 1, :]
        else:
            gate, up = self.gate(x), self.up(x)
        return reduce_from(self.down(F.silu(gate) * up), tp)


class DecoderLayer(nn.Module):
    """One decoder block.  Dense configs return the residual stream; MoE
    configs (cfg.moe_experts > 0) hold a `moe` MoEMLP in place of `mlp`
    and return (stream, load-balance loss)."""

    def __init__(self, cfg: TransformerConfig, device="cuda", mesh=None):
        super().__init__()
        dtype = torch_dtype(cfg.dtype)
        self.attn_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, dtype, device)
        self.attn = Attention(cfg, device, mesh)
        self.mlp_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, dtype, device)
        if cfg.moe_experts > 0:
            from .moe import MoEMLP

            self.moe = MoEMLP(cfg, device, mesh)
        else:
            self.mlp = MLP(cfg, device, mesh)

    def forward(self, x, positions, kv=None, slots=None):
        x = x + self.attn(self.attn_norm(x), positions, kv, slots)
        if hasattr(self, "moe"):
            out, aux = self.moe(self.mlp_norm(x))
            return x + out, aux
        return x + self.mlp(self.mlp_norm(x))


class Embed(nn.Module):
    """The [V, D] table; on a tensor mesh this rank holds the rows of its
    block of the vocabulary, looks up the tokens that fall in it (zeros
    for the rest) and all-reduces over the tensor group."""

    def __init__(self, vocab: int, dim: int, dtype, param_dtype,
                 device="cuda", mesh=None):
        super().__init__()
        self.dtype, self.mesh = dtype, mesh
        self.embedding = logical(nn.Parameter(
            torch.zeros((vocab, dim), dtype=param_dtype, device=device)),
            ("vocab", "embed"))

    def vocab_start(self) -> int:
        """The first vocabulary row this rank holds."""
        return axis_rank(self.mesh, "tensor") * self.embedding.shape[0]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tp = axis_group(self.mesh, "tensor")
        if tp is None:
            return F.embedding(tokens, self.embedding).to(self.dtype)
        rows = self.embedding.shape[0]
        local = tokens - self.vocab_start()
        inside = (local >= 0) & (local < rows)
        found = F.embedding(local.clamp(0, rows - 1), self.embedding)
        found = torch.where(inside[..., None], found, 0.0)
        return reduce_from(found, tp).to(self.dtype)


class StageLayers(nn.ModuleList):
    """A pipeline stage's decoder layers, registered under their global
    indices so that parameter names match the whole model's; iterated in
    order like a ModuleList."""

    def __init__(self, layers: dict):
        super().__init__()
        for index, layer in layers.items():
            self.add_module(str(index), layer)


class Transformer(nn.Module):
    """Decoder-only LM: tokens [B, S] int64 -> logits [B, S, V] fp32.

    Weights start as zeros (ones for norm scales and int8/int4 scales);
    load them with models.convert.params_from_flax or copy them in.
    Passing a `KVCache` runs the decode path: keys and values land in the
    cache at its fill index (`cache.pos` on the device), attention reads
    the cache, and the index advances by the number of tokens, on the
    device and in its host mirror `cache.index`."""

    def __init__(self, cfg: TransformerConfig, device="cuda", mesh=None):
        super().__init__()
        if cfg.moe_experts > 0 and cfg.weight_dtype == "int4":
            raise ValueError(
                "weight_dtype='int4' does not support MoE configs "
                "(moe_experts > 0): int4 packing covers dense kernels "
                "only.  Use weight_dtype='int8' for quantized MoE serving.")
        if mesh is not None:
            (check_decode_mesh if cfg.decode else check_mesh)(cfg, mesh)
        self.cfg, self.mesh = cfg, mesh
        self.device = torch.device(device)
        dtype, pdtype = torch_dtype(cfg.dtype), torch_dtype(cfg.param_dtype)
        self.embed = Embed(cfg.vocab_size, cfg.embed_dim, dtype, pdtype,
                           device, mesh)
        stages = axis_size(mesh, "pipeline")
        self.layer_ids = stage_layers(cfg.num_layers, stages,
                                      axis_rank(mesh, "pipeline"))
        layers = {i: DecoderLayer(cfg, device, mesh) for i in self.layer_ids}
        self.layers = (StageLayers(layers) if stages > 1
                       else nn.ModuleList(layers.values()))
        self.final_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = _dense(cfg.embed_dim, cfg.vocab_size, cfg, device,
                                  ("embed", "vocab"))

    def vocab_shard(self) -> Optional[tuple]:
        """(tensor group, first vocabulary index) when the logits are this
        rank's slice of the vocabulary; None when they are all of it."""
        tp = axis_group(self.mesh, "tensor")
        return None if tp is None else (tp, self.embed.vocab_start())

    def new_cache(self, batch: int) -> KVCache:
        """The decode cache; on a tensor mesh, of this rank's kv heads."""
        if self.mesh is not None and not self.cfg.decode:
            raise ValueError("the KV-cache decode path runs on one device "
                             "or on a decode config's tensor mesh")
        ways = axis_size(self.mesh, "tensor")
        cfg = self.cfg.with_(num_kv_heads=self.cfg.num_kv_heads // ways)
        return KVCache(cfg, batch, torch_dtype(cfg.dtype), self.device)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed(tokens)

    def run_stack(self, x: torch.Tensor, positions: torch.Tensor,
                  cache: Optional[KVCache] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """The layer stack: (x, aux), aux the MoE load-balance loss summed
        over the layers (0.0 for dense configs)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        moe = self.cfg.moe_experts > 0
        if cache is None:
            saved = REMAT_POLICIES[self.cfg.remat_policy]
            remat = (self.cfg.remat and saved is not None
                     and torch.is_grad_enabled())
            for layer in self.layers:
                if not remat:
                    out = layer(x, positions)
                elif not saved:
                    out = checkpoint(layer, x, positions, use_reentrant=False)
                else:
                    out = checkpoint(
                        layer, x, positions, use_reentrant=False,
                        context_fn=functools.partial(
                            create_selective_checkpoint_contexts,
                            list(saved)))
                x, aux = (out[0], aux + out[1]) if moe else (out, aux)
            return x, aux
        q_len, rows = x.shape[1], cache.k[0].shape[2]
        if cache.index + q_len > rows:
            raise ValueError(f"cache holds {rows} positions; cannot write "
                             f"{q_len} at {cache.index}")
        slots = cache.pos + torch.arange(q_len, device=cache.pos.device)
        for i, layer in enumerate(self.layers):
            out = layer(x, positions, (cache.k[i], cache.v[i]), slots)
            x, aux = (out[0], aux + out[1]) if moe else (out, aux)
        cache.index += q_len
        cache.pos += q_len
        return x, aux

    def head(self, x: torch.Tensor, return_hidden: bool = False):
        cfg = self.cfg
        x = self.final_norm(x)
        if return_hidden:
            return x
        x = copy_to(x, axis_group(self.mesh, "tensor"))
        if cfg.tie_embeddings:
            dtype = torch_dtype(cfg.dtype)
            logits = x.to(dtype) @ self.embed.embedding.to(dtype).T
        else:
            logits = self.lm_head(x)
        if cfg.logits_softcap > 0.0:
            cap = cfg.logits_softcap
            logits = torch.tanh(logits.to(torch.float32) / cap) * cap
        return logits.to(torch.float32)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None,
                return_hidden: bool = False, return_aux: bool = False):
        """Logits [B, S, V] fp32 (the final hidden state with
        return_hidden), and with return_aux also the summed MoE
        load-balance loss.  On a mesh, tokens are this rank's block and
        positions their global positions; the logits are this rank's
        slice of the vocabulary (`vocab_shard`)."""
        if axis_size(self.mesh, "pipeline") > 1:
            raise ValueError(f"this pipeline stage holds layers "
                             f"{list(self.layer_ids)} of "
                             f"{self.cfg.num_layers}: it trains through "
                             f"the pipelined train step")
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device
                                     ).expand(tokens.shape)
        x = self.embed_tokens(tokens)
        x, aux = self.run_stack(x, positions, cache)
        out = self.head(x, return_hidden)
        return (out, aux) if return_aux else out


def check_mesh(cfg: TransformerConfig, mesh) -> None:
    """Raise ValueError unless `cfg` can train sharded on `mesh`: bf16/fp32
    weights in separate projections, heads, kv heads, MLP and vocabulary
    divisible by the tensor degree, experts by the expert degree, layers
    by the pipeline degree."""
    if cfg.weight_dtype or cfg.fused_projections:
        raise ValueError("a mesh trains bf16/fp32 weights in separate "
                         "projections (weight_dtype '' and "
                         "fused_projections False)")
    tp, ep = axis_size(mesh, "tensor"), axis_size(mesh, "expert")
    dims = {"num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
            "vocab_size": cfg.vocab_size,
            "mlp_dim": (cfg.moe_mlp_dim or cfg.mlp_dim)
            if cfg.moe_experts else cfg.mlp_dim}
    bad = {k: v for k, v in dims.items() if v % tp}
    if bad:
        raise ValueError(f"{bad} not divisible by the tensor degree {tp}")
    if cfg.moe_experts % ep:
        raise ValueError(f"moe_experts={cfg.moe_experts} not divisible by "
                         f"the expert degree {ep}")
    pp = axis_size(mesh, "pipeline")
    if cfg.num_layers % pp:
        raise ValueError(f"{cfg.num_layers} layers not divisible by {pp} "
                         f"stages")


def check_decode_mesh(cfg: TransformerConfig, mesh) -> None:
    """Raise ValueError unless decode config `cfg` can decode on `mesh`:
    "tensor" the only populated axis, a dense config, heads, kv heads,
    MLP and vocabulary divisible by the tensor degree, and with int4
    weights every shard within the kernel's contract
    (ops/int4_matmul.py): K / tp a multiple of 64 for the row-parallel
    layers (out: heads x head_dim, down: the MLP) and N / tp a multiple
    of 16 for the column-parallel ones (q/k/v or qkv, gate/up or gate_up,
    the head)."""
    for axis, size in mesh_sizes(mesh).items():
        if axis != "tensor" and size > 1:
            raise ValueError(f"decode runs tensor-parallel only: the mesh's "
                             f"{axis!r} axis has {size} ranks")
    if cfg.moe_experts > 0:
        raise ValueError("tensor-parallel decode takes dense configs, not "
                         "MoE (moe_experts > 0)")
    tp = axis_size(mesh, "tensor")
    h, kvh, hd, m = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                     cfg.mlp_dim)
    dims = {"num_heads": h, "num_kv_heads": kvh, "mlp_dim": m,
            "vocab_size": cfg.vocab_size}
    bad = {k: v for k, v in dims.items() if v % tp}
    if bad:
        raise ValueError(f"{bad} not divisible by the tensor degree {tp}")
    if cfg.weight_dtype != "int4":
        return
    rows = {"out": h * hd, "down": m}
    cols = ({"qkv": (h + 2 * kvh) * hd} if cfg.fused_projections
            else {"q": h * hd, "k": kvh * hd, "v": kvh * hd})
    cols.update({"gate_up": 2 * m} if cfg.fused_projections
                else {"gate": m, "up": m})
    if not cfg.tie_embeddings:
        cols["lm_head"] = cfg.vocab_size
    bad = [f"{name} K/{tp} = {k // tp}" for name, k in rows.items()
           if (k // tp) % 64]
    bad += [f"{name} N/{tp} = {n // tp}" for name, n in cols.items()
            if (n // tp) % 16]
    if bad:
        raise ValueError(f"int4 shards outside the kernel's contract (K a "
                         f"multiple of 64, N of 16): {', '.join(bad)}")


# flax's lecun_normal draws from N(0, 1) truncated to [-2, 2] and divides
# by this, the standard deviation of that truncated normal
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(kernel: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's lecun_normal in place: a normal truncated at +-2 sigma with
    sigma = sqrt(1 / fan_in) / 0.8796..."""
    nn.init.trunc_normal_(kernel, 0.0, 1.0, -2.0, 2.0, generator=generator)
    kernel.mul_(fan_in ** -0.5 / _TRUNC_STD)


def _drawn_modules(model: nn.Module):
    """`model.modules()` in the whole model's order; a layer this pipeline
    stage does not hold comes as a scratch layer, drawn and dropped."""
    if not isinstance(model, Transformer) or \
            axis_size(model.mesh, "pipeline") == 1:
        yield from model.modules()
        return
    held = dict(zip(model.layer_ids, model.layers))
    scratch = None
    for name, child in model.named_children():
        if name != "layers":
            yield from child.modules()
            continue
        for i in range(model.cfg.num_layers):
            if i not in held and scratch is None:
                scratch = DecoderLayer(model.cfg, model.device)
            yield from held.get(i, scratch).modules()


def init_params(model: Transformer, generator: torch.Generator) -> None:
    """Draw fresh weights in place, as the reference's flax initializers
    do: dense kernels lecun_normal (a normal truncated at +-2 sigma with
    sigma = sqrt(1 / fan_in) / 0.8796..., fan_in the product of the
    contract dims, since flax's DenseGeneral flattens the kernel to
    [prod(contract), prod(features)] first); the embedding N(0, 1); norm
    scales ones.  A MoE layer's router is a DenseGeneral [D, E]; its
    stacked expert kernels draw each expert's own lecun_normal, fan_in D
    for gate and up and the expert hidden M for down (the reference's
    vmapped experts).  `generator` lives on the model's device.  A
    pipeline stage draws the whole model's sequence and keeps its own
    layers' draws, so its weights are the whole model's."""
    from .moe import StackedDense

    with torch.no_grad():
        for mod in _drawn_modules(model):
            if isinstance(mod, (DenseGeneral, StackedDense)):
                fan_in = (mod.contract if isinstance(mod, StackedDense)
                          else prod(mod.contract))
                lecun_normal_(mod.kernel, fan_in, generator)
            elif isinstance(mod, Embed):
                mod.embedding.normal_(0.0, 1.0, generator=generator)
            elif isinstance(mod, RMSNorm):
                mod.scale.fill_(1.0)
            elif isinstance(mod, (Int8Linear, Int4Linear,
                                  StackedInt8Linear)):
                raise ValueError("init_params draws float weights; "
                                 "quantize a float model instead")


__all__ = ["Attention", "DecoderLayer", "Dense", "DenseGeneral", "KVCache",
           "MLP", "REMAT_POLICIES", "RMSNorm", "StageLayers", "Transformer",
           "check_decode_mesh", "check_mesh", "init_params", "lecun_normal_",
           "logical", "rope", "torch_dtype"]
