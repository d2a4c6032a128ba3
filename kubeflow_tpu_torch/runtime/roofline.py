"""Analytic roofline for NVIDIA cards: decode and training steps.

The port's copy of kubeflow_tpu/runtime/roofline.py: the bytes and FLOPs
one single-token decode step or one training step needs at the least,
the floors they imply on a card, and the MFU definition.  Peaks come from
`GPU_PEAKS`, keyed by `torch.cuda.get_device_name()` and derived from the
accelerator table (gpu/topology.py); a card missing from the table gives
no floor and no MFU (None), never a guess.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..gpu.topology import ACCELERATORS


@dataclass(frozen=True)
class GpuPeak:
    bf16_tflops: float   # dense bf16 tensor-core peak
    hbm_gbps: float      # device-memory bandwidth, GB/s


# NVIDIA data sheets, SXM parts, dense rates at the full power limit:
# one row per card of the accelerator table (gpu/topology.py), so each
# peak is written once
GPU_PEAKS = {
    acc.device_name: GpuPeak(bf16_tflops=acc.bf16_peak_tflops,
                             hbm_gbps=acc.hbm_gbps)
    for acc in ACCELERATORS.values()
}

# bytes per element by dtype name; int4 is nibble-packed
DTYPE_BYTES = {
    "float32": 4.0,
    "float16": 2.0,
    "bfloat16": 2.0,
    "int8": 1.0,
    "int4": 0.5,
}


# fp32 Adam moments (mu and nu), each read and written once per step
_ADAM_MOMENT_BYTES = 2 * 2 * 4.0


def dtype_bytes(name: str, default: float = 2.0) -> float:
    return DTYPE_BYTES.get(name, default)


def matmul_params(config) -> float:
    """Parameters that take part in matmuls: all but an untied embedding
    table, which is a row lookup."""
    p = float(config.num_params)
    if not config.tie_embeddings:
        p -= config.vocab_size * config.embed_dim
    return p


def train_step_flops(config, batch: int, seq_len: int) -> float:
    """Fwd+bwd matmul FLOPs per training step, the MFU numerator: one
    definition with `TransformerConfig.flops_per_token`."""
    return config.flops_per_token(seq_len) * batch * seq_len


def train_step_hbm_bytes(config, batch: int, seq_len: int) -> float:
    """First-order device-memory traffic per training step: every
    parameter's compute copy read by forward and backward, the fp32
    master read and written by the optimizer, both Adam moments read and
    written, and the remat stash (one [B, S, D] residual per layer,
    written by the forward and read back by the backward).  Attention
    score traffic rides on top of this floor."""
    ab = dtype_bytes(config.dtype)
    pb = dtype_bytes(config.param_dtype, 4.0)
    weights = config.num_params * (2 * ab + 2 * pb + _ADAM_MOMENT_BYTES)
    stash = 2.0 * batch * seq_len * config.embed_dim * config.num_layers * ab
    return weights + stash


def decode_weight_stream_bytes(config) -> float:
    """Weight bytes one decode step streams: every matmul weight once, in
    the decode dtype (bf16 unless weight_dtype names int8/int4).  Group
    scales are not counted; pass measured bytes to decode_estimate for
    them."""
    return matmul_params(config) * dtype_bytes(config.weight_dtype
                                               or "bfloat16")


def decode_kv_bytes(config, batch: int) -> float:
    """The static KV cache read once per step: K and V, [B, kvH,
    max_seq_len, Dh] bf16 per layer."""
    return (2.0 * batch * config.max_seq_len * config.num_kv_heads
            * config.head_dim * 2.0 * config.num_layers)


def decode_step_flops(config, batch: int) -> float:
    """Matmul FLOPs of one single-token step: 2 per streamed weight per
    token, plus QK^T and PV over the cache."""
    attn = (4.0 * config.num_layers * config.num_heads * config.head_dim
            * config.max_seq_len)
    return (2.0 * matmul_params(config) + attn) * batch


@dataclass(frozen=True)
class RooflineEstimate:
    """Analytic floors for one workload on `num_chips` cards named
    `accelerator`; every floor is None for a card not in GPU_PEAKS."""

    mode: str
    accelerator: str
    num_chips: int
    flops: float
    hbm_bytes: float
    tokens: int

    @property
    def peak(self) -> Optional[GpuPeak]:
        return GPU_PEAKS.get(self.accelerator)

    @property
    def compute_floor_s(self) -> Optional[float]:
        if self.peak is None:
            return None
        return self.flops / (self.peak.bf16_tflops * 1e12 * self.num_chips)

    @property
    def memory_floor_s(self) -> Optional[float]:
        if self.peak is None:
            return None
        return self.hbm_bytes / (self.peak.hbm_gbps * 1e9 * self.num_chips)

    @property
    def step_floor_s(self) -> Optional[float]:
        if self.peak is None:
            return None
        return max(self.compute_floor_s, self.memory_floor_s)

    @property
    def bound(self) -> Optional[str]:
        if self.peak is None:
            return None
        return ("compute" if self.compute_floor_s >= self.memory_floor_s
                else "memory")

    def roofline_fraction(self, step_time_s: float) -> Optional[float]:
        """Floor / measured: 1.0 runs at the floor; above 1.0 the
        first-order model under-counts the workload (not clamped)."""
        if self.peak is None:
            return None
        if step_time_s <= 0:
            return 0.0
        return self.step_floor_s / step_time_s

    @property
    def tokens_per_s_ceiling(self) -> Optional[float]:
        floor = self.step_floor_s
        return None if not floor else self.tokens / floor

    def to_dict(self) -> dict:
        return {
            "mode": self.mode,
            "accelerator": self.accelerator,
            "num_chips": self.num_chips,
            "flops_per_step": self.flops,
            "hbm_bytes_per_step": self.hbm_bytes,
            "tokens_per_step": self.tokens,
            "compute_floor_s": self.compute_floor_s,
            "memory_floor_s": self.memory_floor_s,
            "step_floor_s": self.step_floor_s,
            "bound": self.bound,
            "tokens_per_s_ceiling": self.tokens_per_s_ceiling,
        }


def mfu_from_flops(tokens_per_second: float, flops_per_token: float,
                   num_chips: int, accelerator: str) -> Optional[float]:
    """Achieved fraction of the cards' dense bf16 peak; None for a card
    not in GPU_PEAKS.  Every MFU the port reports comes from here."""
    peak = GPU_PEAKS.get(accelerator)
    if peak is None:
        return None
    return (tokens_per_second * flops_per_token
            / (peak.bf16_tflops * 1e12 * num_chips))


def mfu(tokens_per_second: float, config, seq_len: int, num_chips: int,
        accelerator: str) -> Optional[float]:
    return mfu_from_flops(tokens_per_second, config.flops_per_token(seq_len),
                          num_chips, accelerator)


def train_estimate(config, batch: int, seq_len: int, accelerator: str,
                   num_chips: int = 1) -> RooflineEstimate:
    """One training step of `batch` x `seq_len` tokens."""
    return RooflineEstimate(
        mode="train", accelerator=accelerator, num_chips=num_chips,
        flops=train_step_flops(config, batch, seq_len),
        hbm_bytes=train_step_hbm_bytes(config, batch, seq_len),
        tokens=batch * seq_len)


def decode_estimate(config, batch: int, accelerator: str,
                    num_chips: int = 1,
                    param_bytes: float = 0.0) -> RooflineEstimate:
    """One single-token decode step.  `param_bytes` replaces the analytic
    weight-stream bytes with measured ones (which include group scales)."""
    stream = param_bytes or decode_weight_stream_bytes(config)
    return RooflineEstimate(
        mode="decode", accelerator=accelerator, num_chips=num_chips,
        flops=decode_step_flops(config, batch),
        hbm_bytes=stream + decode_kv_bytes(config, batch), tokens=batch)


__all__ = ["DTYPE_BYTES", "GPU_PEAKS", "GpuPeak", "RooflineEstimate",
           "decode_estimate", "decode_kv_bytes", "decode_step_flops",
           "decode_weight_stream_bytes", "dtype_bytes", "matmul_params",
           "mfu", "mfu_from_flops", "train_estimate", "train_step_flops",
           "train_step_hbm_bytes"]
