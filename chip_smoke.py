#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kubeflow_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and the script exits
non-zero without its result line):

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; TF32 off, so fp32 products are full fp32;
2. build: compile csrc/int4_matmul.cu with nvcc from this checkout;
3. kernel: the int4 dequant-matmul kernel against its plain version on the
   card at the four shapes of ci/int4_kernel_check.py and the ten shapes
   of Llama-2-7B serving (decode M=16 and prefill M=2048), with
   max|got-ref| / max|ref| < 1e-2 (same rounding points, another
   summation order); CUDA-event medians of the kernel, the plain version
   and, as a yardstick that reads 4x the weight bytes, torch.matmul on
   the dequantized bf16 weight, each launch with a cold L2 cache.  The
   library figure is torch._weight_int4pack_mm, PyTorch's tensor-core
   int4 GEMM, on the same weights repacked once into its layout; it must
   agree with the plain version as the kernel must.  Only this script
   calls it;
4. slice: Llama-2-7B at full width and depth, every leaf N(0, 0.02^2)
   from a seeded generator on the card (ci/llama7b_decode.py's scheme),
   int4 kernels quantized there; `generate` at batch 16, prompt 128, 128
   new tokens, greedy, its prefill and its 127 decode steps timed within
   the one call.  Every int4 layer must run the kernel,
   (4 * 32 + 1) * 128 = 16512 launches; a second run must repeat every
   token; the same weights through the plain version must give prefill
   logits within 2e-2 (max relative error) and, with the kernel path's
   tokens as context (teacher forced), >= 0.95 of the same next tokens.
   Free-running greedy agreement is printed beside it: on a random
   model one early flip changes the rest of a sequence, so it is no gate.

It prints one JSON line per kernel shape and for the slice, then a
"kernels" line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

KERNEL_TOL = 1e-2
LOGITS_TOL = 2e-2
MIN_FORCED_AGREEMENT = 0.95
REPS = 25
SEED = 0

# (K, N) of the int4 layers of Llama-2-7B with fused projections
LLAMA_LAYERS = {"qkv": (4096, 12288), "out": (4096, 4096),
                "gate_up": (4096, 22016), "down": (11008, 4096),
                "lm_head": (4096, 32000)}
CHECK_SHAPES = [(16, 1536, 6144), (16, 6144, 1536), (16, 1536, 32000),
                (128, 1536, 1536)]   # ci/int4_kernel_check.py


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def timed_ms(fn, flush, reps: int = REPS) -> float:
    """Median CUDA-event time of fn(), each run after an L2 flush."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_bound(m: int, k: int, n: int, peak):
    """Least time for one call: packed + scales + x + out bytes at the
    card's memory rate, or 2*M*N*K operations at its bf16 peak."""
    nbytes = k * n // 2 + (k // 64) * n * 2 + m * k * 2 + m * n * 2
    flops = 2.0 * m * n * k
    if peak is None:
        return None, None
    bytes_ms = nbytes / (peak.hbm_gbps * 1e9) * 1e3
    ops_ms = flops / (peak.bf16_tflops * 1e12) * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def int4pack_mm(packed, scales):
    """x -> x @ W through torch._weight_int4pack_mm, for the W of `packed`
    and `scales` (group 64).  The library wants W as [N, K/2] uint8 of
    unsigned nibbles (the int4 value + 8, even K index in the high
    nibble), tiled once by torch._convert_weight_to_int4pack, and
    dequantizes as (q - 8) * scale + zero: zero points of 0 give the
    kernel's nibble * scale."""
    import torch

    from kubeflow_tpu_torch.ops.int4_matmul import GROUP, unpack_int4

    k, n = 2 * packed.shape[0], packed.shape[1]
    q = (unpack_int4(packed) + 8).t().contiguous()
    tiled = torch._convert_weight_to_int4pack(
        ((q[:, 0::2] << 4) | q[:, 1::2]).to(torch.uint8), 8)
    s = scales.reshape(k // GROUP, n)
    scale_zero = torch.stack([s, torch.zeros_like(s)], dim=-1).contiguous()
    return lambda x: torch._weight_int4pack_mm(x, tiled, GROUP, scale_zero)


def kernel_phase(gen, device, peak, flush) -> dict:
    """Kernel against plain version at every shape; returns per-shape
    results keyed by (m, k, n)."""
    import torch

    from kubeflow_tpu_torch.models.quant import quantize_kernel_int4
    from kubeflow_tpu_torch.ops import int4_matmul as i4

    shapes = CHECK_SHAPES + [(m, k, n) for m in (16, 2048)
                             for k, n in LLAMA_LAYERS.values()]
    results, failed = {}, []
    for m, k, n in shapes:
        w = torch.randn((k, n), generator=gen, device=device) * 0.05
        q = quantize_kernel_int4(w.to(torch.bfloat16))
        packed, scales = q["kernel_q4"], q["kernel_scale"]
        x = torch.randn((m, k), generator=gen, device=device
                        ).to(torch.bfloat16)
        got = i4.int4_matmul(x, packed, scales)
        ref = i4.int4_matmul_reference(x, packed, scales)
        library = int4pack_mm(packed, scales)
        lib_got = library(x)
        torch.cuda.synchronize()
        ref_max = ref.float().abs().max().item()
        diff = (got.float() - ref.float()).abs().max().item()
        rel = diff / ref_max
        lib_rel = (lib_got.float() - ref.float()).abs().max().item() / ref_max
        finite = bool(torch.isfinite(got).all().item())
        w_bf16 = (i4.unpack_int4(packed).reshape(k // 64, 64, n).float()
                  * scales.float()).reshape(k, n).to(torch.bfloat16)
        bound_ms, bound_by = kernel_bound(m, k, n, peak)
        res = {
            "phase": "kernel", "kernel": "int4_matmul", "shape": [m, k, n],
            "max_rel_err": rel, "max_abs_err": diff, "finite": finite,
            "kernel_ms": timed_ms(lambda: i4.int4_matmul(x, packed, scales),
                                  flush),
            "plain_ms": timed_ms(
                lambda: i4.int4_matmul_reference(x, packed, scales), flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": timed_ms(lambda: library(x), flush),
            "library_max_rel_err": lib_rel,
            "library_call": "torch._weight_int4pack_mm",
            "bf16_matmul_ms": timed_ms(lambda: torch.matmul(x, w_bf16),
                                       flush),
            "bf16_matmul_note": "yardstick: torch.matmul on the dequantized "
                                "bf16 weight, 4x the weight bytes",
            "ok": finite and rel < KERNEL_TOL and lib_rel < KERNEL_TOL,
        }
        emit(res)
        results[(m, k, n)] = res
        if not res["ok"]:
            failed.append((m, k, n))
        del w, q, packed, scales, x, got, ref, w_bf16, library, lib_got
    if failed:
        raise RuntimeError(f"int4_matmul or the library call disagrees with "
                           f"the plain version (max_rel_err >= {KERNEL_TOL}) "
                           f"at {failed}")
    return results


def fill_random(model, gen) -> int:
    """Random weights, made and quantized per leaf on the card: every leaf
    N(0, 0.02^2), as ci/llama7b_decode.py makes them (norm scales and the
    bf16 embedding included); int4 kernels drawn in bf16 and quantized on
    the card.  Returns the bytes of the int4 layers (what a decode step
    streams)."""
    import torch

    from kubeflow_tpu_torch.models.quant import (
        Int4Linear,
        quantize_kernel_int4,
    )
    from kubeflow_tpu_torch.models.transformer import RMSNorm

    streamed = 0
    with torch.no_grad():
        emb = model.embed.embedding
        emb.copy_(torch.randn(emb.shape, generator=gen, device=emb.device)
                  * 0.02)
        for mod in model.modules():
            if isinstance(mod, RMSNorm):
                mod.scale.copy_(torch.randn(
                    mod.scale.shape, generator=gen,
                    device=mod.scale.device) * 0.02)
            if not isinstance(mod, Int4Linear):
                continue
            w = (torch.randn(mod.contract + mod.features, generator=gen,
                             device=mod.kernel_q4.device) * 0.02)
            q = quantize_kernel_int4(w.to(torch.bfloat16), len(mod.contract))
            mod.kernel_q4.copy_(q["kernel_q4"])
            mod.kernel_scale.copy_(q["kernel_scale"])
            streamed += (mod.kernel_q4.numel()
                         + mod.kernel_scale.numel() * 2)
    return streamed


def set_plain(model, plain: bool) -> None:
    from kubeflow_tpu_torch.models.quant import Int4Linear

    for mod in model.modules():
        if isinstance(mod, Int4Linear):
            mod.plain = plain


def timed_generate(cfg, model, prompt, new):
    """One greedy `generate` call, timed in its parts: CUDA events at its
    start, after its prefill and at its end, and the host's clock over
    the decode steps.  A forward hook marks the end of the model's first
    call (the prefill) and waits there for the card, so the decode steps
    start from an empty queue.  Returns (tokens, prefill ms, decode ms,
    host seconds to issue the decode steps)."""
    import torch

    from kubeflow_tpu_torch.models.generate import generate

    start, prefill_end, end = (torch.cuda.Event(enable_timing=True)
                               for _ in range(3))
    host = []

    def after_prefill(_module, _args, _out):
        if not host:
            prefill_end.record()
            torch.cuda.synchronize()
            host.append(time.perf_counter())

    handle = model.register_forward_hook(after_prefill)
    try:
        start.record()
        out = generate(cfg, model, prompt, new)
        host.append(time.perf_counter())
        end.record()
        end.synchronize()
    finally:
        handle.remove()
    return (out, start.elapsed_time(prefill_end),
            prefill_end.elapsed_time(end), host[1] - host[0])


def slice_phase(gen, device, device_name) -> dict:
    import torch

    from kubeflow_tpu_torch.models.configs import LLAMA2_7B
    from kubeflow_tpu_torch.models.generate import decode_config, generate
    from kubeflow_tpu_torch.models.transformer import Transformer
    from kubeflow_tpu_torch.ops import int4_matmul as i4
    from kubeflow_tpu_torch.runtime.roofline import decode_estimate

    batch, prompt_len, new = 16, 128, 128
    cfg = decode_config(LLAMA2_7B).with_(
        max_seq_len=prompt_len + new, weight_dtype="int4",
        param_dtype="bfloat16")
    t0 = time.perf_counter()
    model = Transformer(cfg, device=device)
    streamed = fill_random(model, gen)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    generate(cfg, model, prompt, 2)               # warm-up: both shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    i4.launches = 0
    out, prefill_ms, decode_ms, decode_host_s = timed_generate(
        cfg, model, prompt, new)
    launches = i4.launches
    peak_mem = torch.cuda.max_memory_allocated()
    expected = (4 * cfg.num_layers + 1) * new
    # the kernel sums in a fixed order, so a second run repeats every token
    deterministic = torch.equal(generate(cfg, model, prompt, new), out)
    decode_s = decode_ms / 1e3

    shape_ok = (tuple(out.shape) == (batch, prompt_len + new)
                and bool((out[:, :prompt_len] == prompt).all().item())
                and 0 <= int(out.min()) and int(out.max()) < cfg.vocab_size)

    # the same weights and prompt through the plain version
    with torch.inference_mode():
        logits_k = model(prompt, cache=model.new_cache(batch))
        set_plain(model, True)
        logits_p = model(prompt, cache=model.new_cache(batch))
        logits_rel = ((logits_k - logits_p).abs().max()
                      / logits_p.abs().max()).item()
        finite = bool(torch.isfinite(logits_k).all().item())
        del logits_k, logits_p
        out_p = generate(cfg, model, prompt, new)
        same = (out[:, prompt_len:] == out_p[:, prompt_len:]).float()
        agreement = same.mean().item()
        per_sequence = [round(v, 4) for v in same.mean(dim=1).tolist()]
        # per-token agreement with the kernel path's tokens as the context
        forced = model(out[:, :-1], cache=model.new_cache(batch))
        forced_agreement = (forced[:, prompt_len - 1:].argmax(-1)
                            == out[:, prompt_len:]).float().mean().item()
        del forced
        set_plain(model, False)

    est = decode_estimate(cfg, batch, device_name, param_bytes=streamed)
    res = {
        "phase": "slice", "model": "llama2-7b", "layers": cfg.num_layers,
        "weight_dtype": "int4", "batch": batch, "prompt_len": prompt_len,
        "new_tokens": new, "setup_s": setup_s,
        "prefill_s": prefill_ms / 1e3, "decode_s": decode_s,
        "decode_host_s": decode_host_s,
        "decode_tok_s": batch * (new - 1) / decode_s,
        "decode_step_ms": decode_ms / (new - 1),
        "peak_mem_gb": peak_mem / 1e9, "streamed_weight_gb": streamed / 1e9,
        "int4_launches": launches, "expected_launches": expected,
        "prefill_logits_max_rel_err": logits_rel, "logits_finite": finite,
        "greedy_agreement": agreement,
        "greedy_agreement_per_sequence": per_sequence,
        "teacher_forced_agreement": forced_agreement,
        "outputs_ok": shape_ok, "deterministic": deterministic,
        "roofline": est.to_dict(),
    }
    emit(res)
    if launches != expected:
        raise RuntimeError(f"int4_matmul launched {launches} times on the "
                           f"main path, expected {expected}")
    if not (shape_ok and finite and deterministic):
        raise RuntimeError("generate gave malformed or run-to-run varying "
                           "tokens, or non-finite logits")
    if logits_rel >= LOGITS_TOL or forced_agreement < MIN_FORCED_AGREEMENT:
        raise RuntimeError(
            f"kernel path and plain path disagree: prefill logits "
            f"max_rel_err {logits_rel} (limit {LOGITS_TOL}), teacher-forced "
            f"agreement {forced_agreement} (limit {MIN_FORCED_AGREEMENT})")
    return res


def main_path_totals(results: dict, launches: int) -> dict:
    """The kernel line: per-shape times weighted by the main path's
    launches (prefill M=2048 once per layer, decode M=16 127 times)."""
    counts = {}
    for name, (k, n) in LLAMA_LAYERS.items():
        per = 1 if name == "lm_head" else 32
        counts[(2048, k, n)] = per
        counts[(16, k, n)] = per * 127
    if sum(counts.values()) != launches:
        raise RuntimeError(f"main path launches {launches} do not match "
                           f"the per-shape counts {counts}")
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    by_bytes = 0.0
    for shape, count in counts.items():
        r = results[shape]
        total["ms"] += count * r["kernel_ms"]
        total["plain_ms"] += count * r["plain_ms"]
        total["library_ms"] += count * r["library_ms"]
        if r["bound_ms"] is None:
            total["bound_ms"] = None
        elif total["bound_ms"] is not None:
            total["bound_ms"] += count * r["bound_ms"]
            by_bytes += count * r["bound_ms"] * (r["bound_by"] == "bytes")
    bound_by = None if total["bound_ms"] is None else (
        "bytes" if by_bytes * 2 >= total["bound_ms"] else "operations")
    return {**total, "bound_by": bound_by}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "kubeflow_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port is not beside this script in {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from kubeflow_tpu_torch.ops import int4_matmul as i4
    from kubeflow_tpu_torch.runtime.roofline import GPU_PEAKS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(smi, flush=True)
    emit({"phase": "environment", "nvidia_smi": smi, "device": device_name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    lib, log = i4.build()
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "library": str(lib.relative_to(ROOT)),
          "build_s": build_s,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    gen = torch.Generator(device=device).manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=device)
    peak = GPU_PEAKS.get(device_name)
    results = kernel_phase(gen, device, peak, flush)
    del flush
    sl = slice_phase(gen, device, device_name)

    totals = main_path_totals(results, sl["int4_launches"])
    emit({"kernels": [{
        "name": "int4_matmul", "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "kubeflow_tpu/ops/int4_matmul.py:86",
        "launches": sl["int4_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in results.values()),
        "max_rel_err": max(r["max_rel_err"] for r in results.values()),
        **totals, "library_call": "torch._weight_int4pack_mm",
        "basis": "ms, plain_ms, bound_ms and library_ms sum the per-shape "
                 "medians over the main path's launches",
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
