"""Peaks of the card, and the operations and bytes the measured work
needs at the least, from shapes alone.

Every count is of what the work needs, whatever implements it: each
input byte read once and each output byte written once, each product's
multiply-adds counted twice, a causal product over the lower triangle.
The functions take plain numbers, so a later metric can call them at
any shape.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Peak:
    bf16_flops: float      # dense tensor-core bf16, FLOP/s
    hbm_bytes: float       # device memory, bytes/s
    source: str


# NVIDIA H100 data sheet, SXM5 part, dense rates (no sparsity) at the
# full 700 W power limit: 989 TFLOP/s bf16, 3.35 TB/s HBM3.  A card not
# in the table has no peak: its shares are left out, never guessed.
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peak(989e12, 3.35e12,
                                  "NVIDIA H100 data sheet, SXM5, dense"),
}


def peak(device_name: str):
    return PEAKS.get(device_name)


def least_seconds(flops: float, nbytes: float, pk: Peak) -> tuple:
    """(least seconds at the peaks, the bound: "flops" or "bytes")."""
    t_f, t_b = flops / pk.bf16_flops, nbytes / pk.hbm_bytes
    return (t_f, "flops") if t_f >= t_b else (t_b, "bytes")


# -- training -------------------------------------------------------------


def matmul_params(shape) -> float:
    """Parameters a token's products touch, per token: attention, the
    dense MLP or the router and top-k experts, and the LM head; the
    embedding is a lookup and does not count."""
    d, dh = shape.dim, shape.head_dim
    attn = d * shape.heads * dh * 2 + d * shape.kv_heads * dh * 2
    if shape.moe:
        mlp = shape.top_k * 3 * d * shape.mlp + d * shape.experts
    else:
        mlp = 3 * d * shape.mlp
    return float(shape.layers * (attn + mlp) + d * shape.vocab)


def train_flops_per_token(shape, seq: int) -> float:
    """A training step's FLOPs a token (PaLM appendix B): 6 x the
    activated product parameters, plus causal attention,
    12 x layers x seq x heads x head_dim / 2.  A MoE model counts only
    its top-k experts."""
    attn = 12.0 * shape.layers * seq * shape.heads * shape.head_dim / 2
    return 6.0 * matmul_params(shape) + attn


def flash_unit(batch: int, heads: int, seq: int, head_dim: int) -> float:
    """FLOPs of one causal [S, S] product over every head of a batch."""
    return 2.0 * batch * heads * seq * seq * head_dim / 2


def flash_fwd_flops(batch, heads, seq, head_dim) -> float:
    """The forward: Q K^T and P V, causal."""
    return 2 * flash_unit(batch, heads, seq, head_dim)


def flash_bwd_flops(batch, heads, seq, head_dim) -> float:
    """The backward, dK/dV and dQ together: Q K^T again (P is not kept),
    dO V^T, P^T dO, dS^T Q and dS K, causal."""
    return 5 * flash_unit(batch, heads, seq, head_dim)


# -- int4 decode ----------------------------------------------------------


def int4_layer(m: int, k: int, n: int) -> tuple:
    """(FLOPs, bytes) of x [M, K] bf16 times a [K, N] int4 kernel with
    one bf16 scale per 64 rows and column, out [M, N] bf16."""
    nbytes = k * n / 2 + (k / 64) * n * 2 + m * k * 2 + m * n * 2
    return 2.0 * m * k * n, nbytes


def int4_kernels(shape) -> list:
    """(K, N) of every int4 product of one forward of the served model:
    per layer q/k/v, out, gate/up and down, then the head."""
    d, dh = shape.dim, shape.head_dim
    per_layer = [(d, (shape.heads + 2 * shape.kv_heads) * dh),
                 (shape.heads * dh, d), (d, 2 * shape.mlp), (shape.mlp, d)]
    return per_layer * shape.layers + [(d, shape.vocab)]


def int4_forward(shape, tokens: int) -> tuple:
    """(FLOPs, bytes) of the int4 products of one forward of `tokens`."""
    flops = nbytes = 0.0
    for k, n in int4_kernels(shape):
        f, b = int4_layer(tokens, k, n)
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes


def decode_step(shape, batch: int, position: int) -> tuple:
    """(FLOPs, bytes) of one single-token step of `batch` rows whose new
    token sits at `position`: the int4 products, the embedding rows, the
    norms, attention over the cache up to and with the new token (bf16 K
    and V, read once; the new K and V written once) and the logits."""
    flops, nbytes = int4_forward(shape, batch)
    kv = 2 * shape.layers * batch * shape.kv_heads * shape.head_dim * 2
    nbytes += kv * (position + 1) + kv                  # read + write
    flops += 4.0 * shape.layers * batch * shape.heads * shape.head_dim \
        * (position + 1)
    nbytes += batch * shape.dim * 2 + (2 * shape.layers + 1) * shape.dim * 2
    return flops, nbytes


def prefill(shape, batch: int, length: int) -> tuple:
    """(FLOPs, bytes) of the prompt's forward: the int4 products at
    batch x length rows, causal attention, the cache written once."""
    flops, nbytes = int4_forward(shape, batch * length)
    flops += 4.0 * shape.layers * batch * shape.heads * shape.head_dim \
        * length * length / 2
    nbytes += 2 * shape.layers * batch * shape.kv_heads * shape.head_dim \
        * length * 2
    nbytes += batch * length * shape.dim * 2
    return flops, nbytes


def generate_call(shape, batch: int, prompt: int, new_tokens: int,
                  pk: Peak) -> float:
    """Least seconds of one `generate` call: the prefill (bound by its
    FLOPs at the cells' sizes), then new_tokens - 1 single-token steps
    (bound by their bytes), each at the larger of its two times."""
    work = [prefill(shape, batch, prompt)] + [
        decode_step(shape, batch, prompt + i) for i in range(new_tokens - 1)]
    return sum(least_seconds(f, b, pk)[0] for f, b in work)


__all__ = ["PEAKS", "Peak", "decode_step", "flash_bwd_flops",
           "flash_fwd_flops", "flash_unit", "generate_call", "int4_forward",
           "int4_kernels", "int4_layer", "least_seconds", "matmul_params",
           "peak", "prefill", "train_flops_per_token"]
