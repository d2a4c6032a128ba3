"""Decode profiler: decode variants against the traffic model, and the
card's achievable HBM read bandwidth.

The twin of ci/decode_profile.py.  It times `generate` on
`decode_config(BENCH_CHIP)` at batch 16, prompt 128 and 256 new tokens
(max_seq_len 384) in three variants: bf16 with the single-token steps
replayed as one CUDA graph (the shipped program), the same model eager,
and int4 under the graph (the int4 CUDA kernel).  Each variant's best
call of 3 gives tokens/s, the step time and the effective bandwidth of
the traffic model (every weight once plus the whole static cache once a
step).  The reference's scanned-layers variant has no counterpart: the
port's decoder is one Python loop over its layers.

--probe-bw also measures the HBM read bandwidth: the best of 4 windows of
an fp32-accumulated sum over a 4 GiB bf16 tensor (a plain reduction
that reads every byte once, a measurement of the card and not a kernel
of the port).  The last line puts the roofline of the traffic model at
the spec sheet's rate (`runtime/roofline.py:GPU_PEAKS`) and, with the
probe, at the measured one (`roofline_basis`).

    python -m kubeflow_tpu_torch.tools.decode_profile [--quick]
                                                      [--probe-bw] [--cpu]

--quick times only the graphed bf16 variant.  --cpu runs TINY at batch
2, prompt 8, 8 new tokens, with a 1 MiB probe and no int4 (TINY's
contract dims are below the kernel's 128-row rule): a smoke run whose
numbers measure no card.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from ..bench import decode_model
from ..models.configs import BENCH_CHIP, TINY
from ..models.generate import decode_config, generate
from ..runtime.roofline import (
    GPU_PEAKS,
    decode_kv_bytes,
    decode_weight_stream_bytes,
)
from .common import emit, run_device, window_ms

TOOL = "decode_profile"
BATCH, PROMPT, NEW = 16, 128, 256
PROBE_ELEMENTS = 2 * 1024**3        # 4 GiB of bf16


def measure_hbm_read_gbps(device: torch.device,
                          n: int = PROBE_ELEMENTS,
                          windows: int = 4) -> float:
    """Achievable HBM read bandwidth, GB/s: the best of `windows`
    event-timed sums of `n` bf16 ones accumulated in fp32 (the reduction
    reads the bf16 input as it is; its output is one number)."""
    x = torch.ones((n,), dtype=torch.bfloat16, device=device)
    x.sum(dtype=torch.float32)                       # warm-up
    best = 0.0
    for _ in range(windows):
        _, ms = window_ms(lambda: x.sum(dtype=torch.float32), device)
        best = max(best, 2.0 * n / (ms / 1e3) / 1e9)
    del x
    return best


def decode_traffic_bytes(cfg, batch: int) -> dict:
    """Per-step HBM traffic of one decode step, as the reference counts
    it: every weight streamed once (`decode_weight_stream_bytes`; the
    reference counts an untied embedding table too) plus the whole static
    KV cache read once (`decode_kv_bytes`: max_seq_len whatever the
    fill)."""
    w = decode_weight_stream_bytes(cfg)
    if not cfg.tie_embeddings:
        w += cfg.vocab_size * cfg.embed_dim * 2.0
    kv = decode_kv_bytes(cfg, batch)
    return {"weight_bytes": w, "kv_bytes": kv, "total": w + kv}


def prompts(cfg, batch: int, prompt_len: int, seed: int,
            device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device=device)


def best_tok_s(cfg, model, batch: int, prompt_len: int, new: int,
               device: torch.device, windows: int = 3,
               cuda_graph: bool = True) -> float:
    """One warm-up `generate` call, then the best tokens/s of `windows`
    event-timed calls, each on a fresh seeded prompt."""
    generate(cfg, model, prompts(cfg, batch, prompt_len, 0, device), new,
             cuda_graph=cuda_graph)
    best = 0.0
    for i in range(windows):
        p = prompts(cfg, batch, prompt_len, 1000 + i, device)
        _, ms = window_ms(lambda: generate(cfg, model, p, new,
                                           cuda_graph=cuda_graph), device)
        best = max(best, batch * new / (ms / 1e3))
    return best


def time_variant(name: str, config, quant: str, cuda_graph: bool,
                 batch: int, prompt_len: int, new: int, device,
                 device_name: str, smi: Optional[str],
                 windows: int = 3) -> dict:
    """One variant's line: tokens/s, step ms, the traffic model's bytes a
    step and the bandwidth they imply at the measured step."""
    cfg, model, _ = decode_model(
        config.with_(max_seq_len=prompt_len + new), quant, device)
    best = best_tok_s(cfg, model, batch, prompt_len, new, device, windows,
                      cuda_graph)
    del model
    traffic = decode_traffic_bytes(cfg, batch)
    step_s = batch / best
    return emit(TOOL, "variant", device_name, smi, variant=name,
                weights=quant or "bf16",
                cuda_graph=cuda_graph and device.type == "cuda",
                batch=batch, prompt_len=prompt_len, new_tokens=new,
                tok_s=best, step_ms=step_s * 1e3,
                traffic_mb=traffic["total"] / 1e6,
                effective_gbps=traffic["total"] / step_s / 1e9)


def main(argv: Optional[list] = None) -> list:
    argv = sys.argv[1:] if argv is None else list(argv)
    device, name, smi = run_device(TOOL, argv)
    on_cpu = device.type == "cpu"
    config, batch, prompt_len, new = ((TINY, 2, 8, 8) if on_cpu
                                      else (BENCH_CHIP, BATCH, PROMPT, NEW))
    lines = []
    measured = None
    if "--probe-bw" in argv:
        measured = measure_hbm_read_gbps(
            device, n=2**20 if on_cpu else PROBE_ELEMENTS)
        lines.append(emit(TOOL, "hbm_read", name, smi, gbps=measured,
                          bytes=2 * (2**20 if on_cpu else PROBE_ELEMENTS),
                          windows=4))
    variants = [("bf16 graphed", "", True), ("bf16 eager", "", False)]
    if not on_cpu:
        variants.append(("int4 graphed", "int4", True))
    if "--quick" in argv:
        variants = variants[:1]
    for label, quant, graphed in variants:
        lines.append(time_variant(label, config, quant, graphed, batch,
                                  prompt_len, new, device, name, smi))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    lines.append(roofline_line(config, batch, prompt_len, new, name, smi,
                               measured))
    return lines


def roofline_line(config, batch: int, prompt_len: int, new: int,
                  device_name: str, smi: Optional[str],
                  measured_gbps: Optional[float]) -> dict:
    """The traffic model's tokens/s ceiling at the spec sheet's rate and,
    when probed, at the measured one."""
    cfg = decode_config(config).with_(max_seq_len=prompt_len + new)
    t = decode_traffic_bytes(cfg, batch)
    peak = GPU_PEAKS.get(device_name)
    spec = None if peak is None else peak.hbm_gbps

    def ceiling(gbps):
        return None if gbps is None else gbps * 1e9 / t["total"] * batch

    return emit(TOOL, "roofline", device_name, smi,
                weight_mb=t["weight_bytes"] / 1e6,
                kv_mb=t["kv_bytes"] / 1e6, batch=batch,
                roofline_basis={"measured_gbps": measured_gbps,
                                "spec_gbps": spec},
                roofline_tok_s={"measured": ceiling(measured_gbps),
                                "spec": ceiling(spec)})


if __name__ == "__main__":
    main()
