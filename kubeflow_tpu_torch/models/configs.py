"""Decoder configuration for the PyTorch port.

A copy of the reference package's `TransformerConfig` (field for field,
so a config prints and compares the same on both sides) and its presets:
`LLAMA2_7B` (the serving slice), `LLAMA2_13B`, `GEMMA_7B` (head dim 256,
tied embeddings, logits softcap 30), `LLAMA2_350M`, `BENCH_CHIP` (the
training slice, the step `python -m kubeflow_tpu_torch.bench` times),
`BENCH_MOE` (its Mixture-of-Experts twin, `bench --moe`) and the test
config `TINY`.  The port keeps its own copy rather than
importing the reference package.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32_000
    num_layers: int = 32
    embed_dim: int = 4096
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    mlp_dim: int = 11_008
    max_seq_len: int = 4096
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"     # master weights
    weight_dtype: str = ""           # decode-time weight format: "" keeps
                                     # param_dtype; "int8" / "int4" build
                                     # quantized layers (models.quant)
    attention_impl: str = "auto"     # auto | flash | xla | ring
    remat: bool = True               # per-layer checkpointing (training)
    scan_layers: bool = True         # stacked "layers" param layout
    tie_embeddings: bool = False
    logits_softcap: float = 0.0      # gemma-style tanh softcap; 0 = off
    loss_chunks: int = 0             # >0: chunked cross-entropy
    remat_policy: str = "nothing"    # nothing|dots|attn|none
    flash_block_q: int = 0           # flash attention tile sizes; 0 = the
    flash_block_k: int = 0           # kernel's defaults
    moe_experts: int = 0             # >0: MLPs become MoE
    moe_top_k: int = 2               # experts per token
    moe_capacity_factor: float = 1.25
    moe_mlp_dim: int = 0             # per-expert hidden; 0 = mlp_dim
    moe_aux_weight: float = 0.01     # load-balance loss weight
    decode: bool = False             # set by models.generate.decode_config:
                                     # a cfg carrying it keeps its explicit
                                     # fused_projections/staged_kv choices
    staged_kv: bool = False          # decode KV writes through an 8-row
                                     # stage; the port writes the cache in
                                     # place either way (models.transformer)
    fused_projections: bool = False  # one qkv + one gate_up matmul per
                                     # layer instead of five
    moe_dispatch: str = "einsum"     # einsum | hybrid | sort

    def with_(self, **kw) -> "TransformerConfig":
        return replace(self, **kw)

    @property
    def num_params(self) -> int:
        """Parameter count (embed + per-layer attn/mlp/norms + final norm
        [+ untied output head]); MoE multiplies the MLP by the expert count
        and adds the router."""
        d, l = self.embed_dim, self.num_layers
        attn = d * self.num_heads * self.head_dim * 2  # q + out
        attn += d * self.num_kv_heads * self.head_dim * 2  # k + v
        if self.moe_experts > 0:
            expert_mlp = 3 * d * (self.moe_mlp_dim or self.mlp_dim)
            mlp = self.moe_experts * expert_mlp + d * self.moe_experts
        else:
            mlp = 3 * d * self.mlp_dim  # gate, up, down
        norms = 2 * d
        per_layer = attn + mlp + norms
        embed = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        return embed + l * per_layer + d + head

    def flops_per_token(self, seq_len: int) -> float:
        """Training (fwd+bwd) matmul FLOPs per token: 6x the activated
        matmul parameters plus the causal attention term
        12*L*S*(H*Dh)/2 (QK^T and AV, halved for causality), the PaLM
        appendix B accounting.  An untied embedding is a lookup and does
        not count; a tied one is also the logits weight and does.  For
        MoE only the top-k activated experts count, scaled down by a
        capacity factor below 1."""
        matmul_params = self.num_params - (
            0 if self.tie_embeddings else self.vocab_size * self.embed_dim
        )
        if self.moe_experts > 0:
            expert_mlp = 3 * self.embed_dim * (self.moe_mlp_dim
                                               or self.mlp_dim)
            inactive = self.moe_experts - min(self.moe_top_k,
                                              self.moe_experts)
            matmul_params -= self.num_layers * inactive * expert_mlp
            if self.moe_capacity_factor < 1.0:
                active_mlp = min(self.moe_top_k, self.moe_experts) \
                    * expert_mlp
                matmul_params -= self.num_layers * active_mlp * (
                    1.0 - self.moe_capacity_factor)
        attn = (12 * self.num_layers * seq_len * self.num_heads
                * self.head_dim / 2)
        return 6.0 * matmul_params + attn


LLAMA2_7B = TransformerConfig()

LLAMA2_13B = TransformerConfig(
    num_layers=40,
    embed_dim=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    mlp_dim=13_824,
)

GEMMA_7B = TransformerConfig(
    vocab_size=256_128,
    num_layers=28,
    embed_dim=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    mlp_dim=24_576,
    max_seq_len=8192,
    tie_embeddings=True,
    logits_softcap=30.0,
)

LLAMA2_350M = TransformerConfig(
    num_layers=24,
    embed_dim=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    mlp_dim=2816,
    max_seq_len=2048,
)

# The flagship training config (~0.47B parameters): 10 layers 1536 wide,
# 12 heads of 128, MLP 6144, seq 2048, flash attention, cross-entropy in
# 32 chunks so the [tokens, vocab] fp32 logits never exist at once.
# flash_block_q/flash_block_k are the reference's TPU tile sizes; the
# port's kernels choose their own tiles and read neither field.
BENCH_CHIP = TransformerConfig(
    num_layers=10,
    embed_dim=1536,
    num_heads=12,
    num_kv_heads=12,
    head_dim=128,
    mlp_dim=6144,
    max_seq_len=2048,
    attention_impl="flash",
    loss_chunks=32,
    flash_block_q=1024,
    flash_block_k=512,
)

# The MoE training config (~0.76B parameters, ~0.48B activated):
# BENCH_CHIP's trunk with each dense MLP replaced by 4 experts of hidden
# 3072, top-2 routing at capacity 1.0, hybrid dispatch (one-hot dispatch,
# gather combine).  MFU counts the activated experts (flops_per_token).
BENCH_MOE = BENCH_CHIP.with_(
    moe_experts=4,
    moe_top_k=2,
    moe_mlp_dim=3072,
    moe_capacity_factor=1.0,
    flash_block_q=512,
    flash_block_k=512,
    moe_dispatch="hybrid",
)

# test config: tiny but structurally identical (GQA, two layers)
TINY = TransformerConfig(
    vocab_size=256,
    num_layers=2,
    embed_dim=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    mlp_dim=128,
    max_seq_len=128,
    dtype="float32",
    param_dtype="float32",
)

PRESETS = {"llama2-7b": LLAMA2_7B, "llama2-13b": LLAMA2_13B,
           "gemma-7b": GEMMA_7B, "llama2-350m": LLAMA2_350M,
           "bench-chip": BENCH_CHIP, "bench-moe": BENCH_MOE, "tiny": TINY}

__all__ = ["BENCH_CHIP", "BENCH_MOE", "GEMMA_7B", "LLAMA2_13B",
           "LLAMA2_350M", "LLAMA2_7B", "PRESETS", "TINY",
           "TransformerConfig"]
