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


class RMSNorm(nn.Module):
    """fp32 statistics and an fp32 scale; the output in `dtype`."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

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
    are cast to `dtype` for the product (flax DenseGeneral)."""

    def __init__(self, contract, features, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device="cuda"):
        super().__init__()
        self.contract, self.features = _as_tuple(contract), _as_tuple(features)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(
            self.contract + self.features, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, n = prod(self.contract), prod(self.features)
        lead = x.shape[:x.dim() - len(self.contract)]
        out = x.to(self.dtype).reshape(-1, k) @ \
            self.kernel.to(self.dtype).reshape(k, n)
        return out.reshape(lead + self.features)


def _dense(contract, features, cfg: TransformerConfig, device) -> nn.Module:
    """bf16/fp32, int8 or int4 dense layer, per cfg.weight_dtype."""
    dtype = torch_dtype(cfg.dtype)
    if cfg.weight_dtype in ("int8", "int4"):
        cls = Int8Linear if cfg.weight_dtype == "int8" else Int4Linear
        return cls(contract, features, dtype=dtype, device=device)
    if cfg.weight_dtype:
        raise ValueError(f"unknown weight_dtype {cfg.weight_dtype!r}")
    return DenseGeneral(contract, features, dtype,
                        torch_dtype(cfg.param_dtype), device)


class KVCache:
    """Per-layer [B, kvH, max_seq_len, Dh] key and value buffers, written
    in place, and the fill index shared by all layers."""

    def __init__(self, cfg: TransformerConfig, batch: int, dtype,
                 device="cuda"):
        shape = (batch, cfg.num_kv_heads, cfg.max_seq_len, cfg.head_dim)
        self.k = [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(cfg.num_layers)]
        self.v = [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(cfg.num_layers)]
        self.index = 0


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        d, h, kvh, hd = (cfg.embed_dim, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim)
        if cfg.fused_projections:
            self.qkv = _dense(d, (h + 2 * kvh, hd), cfg, device)
        else:
            self.q = _dense(d, (h, hd), cfg, device)
            self.k = _dense(d, (kvh, hd), cfg, device)
            self.v = _dense(d, (kvh, hd), cfg, device)
        self.out = _dense((h, hd), d, cfg, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                kv: Optional[tuple] = None, cur: int = 0) -> torch.Tensor:
        cfg = self.cfg
        h, kvh = cfg.num_heads, cfg.num_kv_heads
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
            # cache, which holds the same logical contents.
            k_cache, v_cache = kv
            q_len = x.shape[1]
            if cur + q_len > k_cache.shape[2]:
                raise ValueError(f"cache holds {k_cache.shape[2]} positions; "
                                 f"cannot write {q_len} at {cur}")
            k_cache[:, :, cur:cur + q_len] = k.transpose(1, 2)
            v_cache[:, :, cur:cur + q_len] = v.transpose(1, 2)
            out = decode_attention(q, k_cache, v_cache, q_offset=cur)
        else:
            out = attention(q, k, v, causal=True, impl=cfg.attention_impl)
        return self.out(out)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device="cuda"):
        super().__init__()
        self.fused = cfg.fused_projections
        d, m = cfg.embed_dim, cfg.mlp_dim
        if self.fused:
            self.gate_up = _dense(d, (2, m), cfg, device)
        else:
            self.gate = _dense(d, m, cfg, device)
            self.up = _dense(d, m, cfg, device)
        self.down = _dense(m, d, cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            gu = self.gate_up(x)
            gate, up = gu[..., 0, :], gu[..., 1, :]
        else:
            gate, up = self.gate(x), self.up(x)
        return self.down(F.silu(gate) * up)


class DecoderLayer(nn.Module):
    """One decoder block.  Dense configs return the residual stream; MoE
    configs (cfg.moe_experts > 0) hold a `moe` MoEMLP in place of `mlp`
    and return (stream, load-balance loss)."""

    def __init__(self, cfg: TransformerConfig, device="cuda"):
        super().__init__()
        dtype = torch_dtype(cfg.dtype)
        self.attn_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, dtype, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, dtype, device)
        if cfg.moe_experts > 0:
            from .moe import MoEMLP

            self.moe = MoEMLP(cfg, device)
        else:
            self.mlp = MLP(cfg, device)

    def forward(self, x, positions, kv=None, cur: int = 0):
        x = x + self.attn(self.attn_norm(x), positions, kv, cur)
        if hasattr(self, "moe"):
            out, aux = self.moe(self.mlp_norm(x))
            return x + out, aux
        return x + self.mlp(self.mlp_norm(x))


class Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, dtype, param_dtype,
                 device="cuda"):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(
            torch.zeros((vocab, dim), dtype=param_dtype, device=device))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embedding).to(self.dtype)


class Transformer(nn.Module):
    """Decoder-only LM: tokens [B, S] int64 -> logits [B, S, V] fp32.

    Weights start as zeros (ones for norm scales and int8/int4 scales);
    load them with models.convert.params_from_flax or copy them in.
    Passing a `KVCache` runs the decode path: keys and values land in the
    cache at `cache.index`, attention reads the cache, and the index
    advances by the number of tokens."""

    def __init__(self, cfg: TransformerConfig, device="cuda"):
        super().__init__()
        if cfg.moe_experts > 0 and cfg.weight_dtype == "int4":
            raise ValueError(
                "weight_dtype='int4' does not support MoE configs "
                "(moe_experts > 0): int4 packing covers dense kernels "
                "only.  Use weight_dtype='int8' for quantized MoE serving.")
        self.cfg = cfg
        self.device = torch.device(device)
        dtype, pdtype = torch_dtype(cfg.dtype), torch_dtype(cfg.param_dtype)
        self.embed = Embed(cfg.vocab_size, cfg.embed_dim, dtype, pdtype,
                           device)
        self.layers = nn.ModuleList(
            [DecoderLayer(cfg, device) for _ in range(cfg.num_layers)])
        self.final_norm = RMSNorm(cfg.embed_dim, cfg.norm_eps, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = _dense(cfg.embed_dim, cfg.vocab_size, cfg, device)

    def new_cache(self, batch: int) -> KVCache:
        return KVCache(self.cfg, batch, torch_dtype(self.cfg.dtype),
                       self.device)

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
        for i, layer in enumerate(self.layers):
            out = layer(x, positions, (cache.k[i], cache.v[i]), cache.index)
            x, aux = (out[0], aux + out[1]) if moe else (out, aux)
        cache.index += x.shape[1]
        return x, aux

    def head(self, x: torch.Tensor, return_hidden: bool = False):
        cfg = self.cfg
        x = self.final_norm(x)
        if return_hidden:
            return x
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
        load-balance loss."""
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device
                                     ).expand(tokens.shape)
        x = self.embed_tokens(tokens)
        x, aux = self.run_stack(x, positions, cache)
        out = self.head(x, return_hidden)
        return (out, aux) if return_aux else out


# flax's lecun_normal draws from N(0, 1) truncated to [-2, 2] and divides
# by this, the standard deviation of that truncated normal
_TRUNC_STD = 0.87962566103423978


def init_params(model: Transformer, generator: torch.Generator) -> None:
    """Draw fresh weights in place, as the reference's flax initializers
    do: dense kernels lecun_normal (a normal truncated at +-2 sigma with
    sigma = sqrt(1 / fan_in) / 0.8796..., fan_in the product of the
    contract dims, since flax's DenseGeneral flattens the kernel to
    [prod(contract), prod(features)] first); the embedding N(0, 1); norm
    scales ones.  A MoE layer's router is a DenseGeneral [D, E]; its
    stacked expert kernels draw each expert's own lecun_normal, fan_in D
    for gate and up and the expert hidden M for down (the reference's
    vmapped experts).  `generator` lives on the model's device."""
    from .moe import StackedDense

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (DenseGeneral, StackedDense)):
                fan_in = (mod.contract if isinstance(mod, StackedDense)
                          else prod(mod.contract))
                nn.init.trunc_normal_(mod.kernel, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                mod.kernel.mul_(fan_in ** -0.5 / _TRUNC_STD)
            elif isinstance(mod, Embed):
                mod.embedding.normal_(0.0, 1.0, generator=generator)
            elif isinstance(mod, RMSNorm):
                mod.scale.fill_(1.0)
            elif isinstance(mod, (Int8Linear, Int4Linear,
                                  StackedInt8Linear)):
                raise ValueError("init_params draws float weights; "
                                 "quantize a float model instead")


__all__ = ["Attention", "DecoderLayer", "DenseGeneral", "KVCache", "MLP",
           "REMAT_POLICIES", "RMSNorm", "Transformer", "init_params", "rope",
           "torch_dtype"]
