"""Decode overhead attribution: structured ablations of the decode step,
each step-time delta against the HBM traffic it removes.

The twin of ci/decode_ablate.py.  It times the graphed bf16 `generate`
of `decode_config(BENCH_CHIP)` (max_seq_len 384, batch 16, prompt 128,
256 new tokens) and four ablations of it: kv heads 6 (half the cache),
vocab 16k (half the head), layers 5 (half the stack: weights, cache and
the per-layer ops) and batch 32 (the same weights, twice the cache).
Each config's line gives tokens/s, the step time (a call's time over its
new tokens, the prefill included, as the reference counts it), the bytes
one step must stream (`streamed_bytes`: every matmul weight once plus
the whole static cache once), the step time those bytes take at the
measured HBM read bandwidth, and the gap between the two; each ablation
also gives its step-time delta against the baseline beside the bytes it
removes and their time.  A delta far above its bytes' time says the
removed part carries hidden cost (copies, serialisation); at parity it
is roofline-clean.

    python -m kubeflow_tpu_torch.tools.decode_ablate [--cpu]

Each config's best of 3 calls is timed; the bandwidth is
tools/decode_profile.py's probe, taken first.  --cpu runs the same
halvings of TINY at batch 2, prompt 8, 8 new: a smoke run whose numbers
measure no card.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from ..bench import decode_model
from ..models.configs import BENCH_CHIP, TINY
from ..models.generate import decode_config
from ..runtime.roofline import decode_kv_bytes, decode_weight_stream_bytes
from .common import emit, run_device
from .decode_profile import PROBE_ELEMENTS, best_tok_s, measure_hbm_read_gbps

TOOL = "decode_ablate"
BATCH, PROMPT, NEW = 16, 128, 256


def streamed_bytes(cfg, batch: int) -> tuple:
    """(weight bytes, KV bytes) one decode step streams: every matmul
    weight once (the embedding is a row lookup) and the static cache."""
    return decode_weight_stream_bytes(cfg), decode_kv_bytes(cfg, batch)


def ablations(config, batch: int, max_seq_len: int) -> list:
    """[(name, decode config, batch)]: the baseline and the reference's
    four halvings of it (at BENCH_CHIP: kv heads 6, vocab 16k, layers 5,
    batch 32)."""
    base = decode_config(config).with_(max_seq_len=max_seq_len)
    return [
        ("baseline", base, batch),
        ("kv-heads/2", base.with_(num_kv_heads=base.num_kv_heads // 2),
         batch),
        ("vocab/2", base.with_(vocab_size=base.vocab_size // 2), batch),
        ("layers/2", base.with_(num_layers=base.num_layers // 2), batch),
        ("batch x2", base, 2 * batch),
    ]


def time_cfg(name: str, cfg, batch: int, prompt_len: int, new: int,
             hbm_gbps: float, device, device_name: str,
             smi: Optional[str], windows: int = 3,
             baseline: Optional[dict] = None, model=None) -> dict:
    """One config's line; with `baseline` (the baseline's line) also its
    delta and the bytes it removes.  `model` is a bf16 decode model built
    for `cfg` (`bench.decode_model`), or None to build one."""
    if model is None:
        cfg, model, _ = decode_model(cfg, "", device)
    best = best_tok_s(cfg, model, batch, prompt_len, new, device, windows)
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    w, kv = streamed_bytes(cfg, batch)
    step_ms = batch / best * 1e3
    ideal_ms = (w + kv) / (hbm_gbps * 1e9) * 1e3
    fields = dict(config={"num_layers": cfg.num_layers,
                          "num_kv_heads": cfg.num_kv_heads,
                          "vocab_size": cfg.vocab_size,
                          "max_seq_len": cfg.max_seq_len},
                  batch=batch, prompt_len=prompt_len, new_tokens=new,
                  windows=windows, tok_s=best, step_ms=step_ms,
                  weight_mb=w / 1e6, kv_mb=kv / 1e6, ideal_ms=ideal_ms,
                  gap_ms=step_ms - ideal_ms, hbm_gbps=hbm_gbps,
                  effective_gbps=(w + kv) / (step_ms / 1e3) / 1e9)
    if baseline is not None:
        removed = (baseline["weight_mb"] + baseline["kv_mb"]) * 1e6 \
            - (w + kv)
        fields.update(delta_ms=baseline["step_ms"] - step_ms,
                      removed_mb=removed / 1e6,
                      removed_ms=removed / (hbm_gbps * 1e9) * 1e3)
    return emit(TOOL, name, device_name, smi, **fields)


def main(argv: Optional[list] = None) -> list:
    argv = sys.argv[1:] if argv is None else list(argv)
    device, name, smi = run_device(TOOL, argv)
    on_cpu = device.type == "cpu"
    config, batch, prompt_len, new = ((TINY, 2, 8, 8) if on_cpu
                                      else (BENCH_CHIP, BATCH, PROMPT, NEW))
    hbm = measure_hbm_read_gbps(device, n=2**20 if on_cpu
                                else PROBE_ELEMENTS)
    lines, baseline = [], None
    for label, cfg, b in ablations(config, batch, prompt_len + new):
        line = time_cfg(label, cfg, b, prompt_len, new, hbm, device, name,
                        smi, baseline=baseline)
        baseline = baseline or line
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
