"""Attention for the port: the dispatch, the einsum reference, flash
attention and KV-cache decode.

Shapes follow the reference package's [batch, seq, heads, head_dim]
convention; the decode cache is [batch, kv_heads, seq, head_dim], the
layout the decode products consume directly.  Scores are computed and
soft-maxed in fp32 and the probabilities are cast to v's dtype before
the PV product, as in kubeflow_tpu/ops/attention.py.

`attention()` picks between "xla" (`xla_attention`, the einsum reference),
"flash" (`ops/flash_attention.py`: the hand-written Hopper kernels on
a CUDA tensor, their plain versions on a CPU tensor) and "ring"
(`ops/ring_attention.py`: exact attention over a sequence-sharded group).
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention, unsupported
from .ring_attention import ring_attention


def causal_mask_bias(q_len: int, kv_len: int, q_offset: int = 0,
                     dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Additive -inf bias above the causal diagonal, top-left aligned;
    q_offset shifts the query positions."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(q_pos >= kv_pos, zero, float("-inf")).to(dtype)


def _repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """GQA: tile kv heads up to the query head count ([B, S, kvH, D])."""
    num_kv = k.shape[2]
    if num_kv == num_q_heads:
        return k
    return torch.repeat_interleave(k, num_q_heads // num_kv, dim=2)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, q_offset: int = 0,
                  softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Reference einsum attention with fp32 scores."""
    head_dim = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else head_dim ** -0.5
    k = _repeat_kv(k, q.shape[2])
    v = _repeat_kv(v, q.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        scores = scores + causal_mask_bias(q.shape[1], k.shape[1], q_offset,
                                           device=q.device)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, q_offset: int,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """KV-cache attention with the cache in [B, kvH, S, D] layout.

    q: [B, Q, H, D]; q_offset: global position of q[:, 0].  Positions past
    q_offset + i (unwritten or future cache slots) are masked with -1e30,
    not -inf, as in the reference.  Grouped-query heads fold into the q
    reshape instead of a repeated cache."""
    batch, q_len, num_heads, head_dim = q.shape
    kv_heads, kv_len = k_cache.shape[1], k_cache.shape[2]
    groups = num_heads // kv_heads
    scale = softmax_scale if softmax_scale is not None else head_dim ** -0.5
    qg = q.reshape(batch, q_len, kv_heads, groups, head_dim)
    scores = torch.einsum("bqkgd,bksd->bkgqs", qg.to(torch.float32),
                          k_cache.to(torch.float32)) * scale
    q_pos = q_offset + torch.arange(q_len, device=q.device)[:, None]
    visible = torch.arange(kv_len, device=q.device)[None, :] <= q_pos
    scores = torch.where(visible, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgqs,bksd->bqkgd", probs, v_cache)
    return out.reshape(batch, q_len, num_heads, head_dim)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, impl: str = "auto",
              softmax_scale: Optional[float] = None,
              q_offset: int = 0, positions: Optional[torch.Tensor] = None,
              group=None) -> torch.Tensor:
    """Dispatch, as the reference's `attention()` does on its TPU.

    - "auto": flash on a CUDA tensor when the kernels take the shape
      (seq a multiple of 128, q_len == kv_len, a head dim they are built
      for, bf16) and there is no q_offset; "xla" otherwise, the CPU
      included;
    - "flash": the kernels on a CUDA tensor, raising on a shape they do
      not take (never a quiet fallback); the plain version on a CPU
      tensor;
    - "xla": the einsum reference;
    - "ring": `ring_attention` of this rank's sequence block over the
      sequence `group` (None for one rank), `positions` the block's
      global token positions.

    The reference's flash tile sizes (`flash_block_q`/`flash_block_k` of
    the config) are TPU VMEM tiles; nothing in the port reads them: the
    kernels pick their own tiles."""
    if impl == "auto":
        seq_ok = q.shape[1] % 128 == 0 and k.shape[1] % 128 == 0
        impl = "flash" if (q.is_cuda and seq_ok and not q_offset
                           and unsupported(q, k, v) is None) else "xla"
    if impl == "flash":
        if q_offset:
            raise ValueError("flash attention path has no q_offset support")
        return flash_attention(q, k, v, softmax_scale, causal)
    if impl == "xla":
        return xla_attention(q, k, v, causal=causal, q_offset=q_offset,
                             softmax_scale=softmax_scale)
    if impl == "ring":
        if q_offset:
            raise ValueError("ring attention takes positions, not q_offset")
        return ring_attention(q, k, v, positions, group, causal,
                              softmax_scale)
    raise ValueError(f"unknown attention impl {impl!r}")


__all__ = ["attention", "causal_mask_bias", "decode_attention",
           "xla_attention"]
