#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kubeflow_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and the script exits
non-zero without its result line):

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; TF32 off, so fp32 products are full fp32;
2. build: compile csrc/int4_matmul.cu and csrc/flash_attention.cu with
   nvcc from this checkout, one nvcc each, at once; ptxas's registers and
   spills for each kernel, and the HGMMA (wgmma) instructions of each in
   `cuobjdump -sass`.  Every kernel (int4, flash forward, dK/dV and dQ)
   must show 0 bytes of spill stores, since a spill there also serialises
   its wgmma, and at least one HGMMA: all four run on the tensor cores;
3. kernel: the int4 dequant-matmul kernel against its plain version on the
   card at the four shapes of ci/int4_kernel_check.py, the ten shapes
   of Llama-2-7B serving (decode M=16 and prefill M=2048) and the five
   of speculative decoding's verify pass (M = 16 x (gamma + 1) = 80,
   from a generator of their own, kept out of the path totals), with
   max|got-ref| / max|ref| < 1e-2 (same rounding points, another
   summation order), and a second call repeats every bit; CUDA-event
   medians of the kernel, the plain version and, as a yardstick that
   reads 4x the weight bytes, torch.matmul on the dequantized bf16
   weight, each launch with a cold L2 cache.  The library figure is
   torch._weight_int4pack_mm, PyTorch's tensor-core int4 GEMM, on the
   same weights repacked once into its layout; it must agree with the
   plain version as the kernel must.  Only this script calls it.  Then
   three edge shapes the kernel's tiles must handle, drawn from a
   generator of their own and kept out of the path totals: one token
   (1, 4096, 4096), M, K and N each ragged against their tiles
   (17, 1600, 1552), and a ragged prefill tile (300, 4096, 4096);
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
   model one early flip changes the rest of a sequence, so it is no gate;
   speculative: the slice's model as the target of
   models/speculative.py, its first two layers (sharing the target's
   modules, no weights of their own) as the draft, batch 16, prompt 128,
   128 new tokens, gamma 4, greedy.  The int4 launches must be 129 (the
   target's prefill) + 9 (the draft's) + rounds x (4 x 9 + 129); the
   target's kernel path over the emitted sequence (teacher forced) must
   pick >= 0.95 of the emitted tokens as its argmax, and every other one
   within 2e-2 x max |logit| of its row's max; with the target as its
   own draft, every round its logits replay (a forward hook keeps them)
   must be one the run made, and every round cut short must have been
   cut at a near-tie: the rejected proposal within 2e-2 x max |logit| of
   the verify pass's argmax (the random model's logits are flat, and the
   draft's M = 16 and the verify pass's M = 80 round some near-ties
   apart, so its rounds exceed ceil(127 / 4) and are printed, not
   gated); sampling at temperature 0.8 with it must accept >= 0.9 x 3/4
   of the draft tokens.
   Speculative and plain `generate` tok/s (CUDA events), rounds and host
   syncs (torch's sync debug mode) are printed, not gated: a random
   2-layer draft agrees with the target about never;
5. flash: the three flash-attention kernels (forward, dK/dV, dQ) against
   their plain versions at the three shapes of ci/flash_numerics.py, three
   shapes the kernels' tiles must handle (head dim 64 with GQA; S = 320,
   which leaves half of the last 128-row tile past the end; causal=False)
   and the training step's (40, 2048, 12, 12, 128), N(0, 1) bf16 inputs
   and cotangent; each case's causal flag goes to the kernels, the plain
   chain and SDPA alike.  The plain backward starts from the plain
   forward's lse and di = rowsum(dO * plain O), never from the kernels'.
   Gates, for each of o, dq, dk and dv: max abs error <= 3e-2 forward and
   <= 6e-2 for the gradients (ci/flash_numerics.py's limits), max abs
   error / max |ref| <= 2e-2, and RMS error / RMS of the reference
   <= 1e-2, which holds the many late rows whose values are small; the
   lse within 1e-4; and a second backward repeats every bit.  The errors
   against F.scaled_dot_product_attention are printed; its forward and
   its backward (dq, dk and dv in one call, so it stands on the dK/dV
   entry only) are timed as the library yardstick (only this script
   calls it);
6. train: the BENCH_CHIP training step at full width and depth, batch 40
   x seq 2048, through setup_training and its train step (the entry points
   of `python -m kubeflow_tpu_torch.bench`), AdamW with a bf16 first
   moment.  One step must launch exactly 20 flash forwards (10 layers,
   each run again by the remat recompute), 10 dK/dV and 10 dQ; a fresh
   setup from the same seed repeats the first loss bit for bit; every
   loss is finite; at batch 8 the kernel path and the plain path
   (attention_impl="xla", the einsum reference) agree on the loss within
   1e-3 relative, on the global gradient norm within 2e-2 relative, and
   per parameter with gradient cosine >= 0.99; five SGD(0.05) steps on
   one repeated batch lower the loss.  Step time, tokens/s and MFU
   against the card's bf16 peak come from the bench's timed windows;
7. moe_train: the same for BENCH_MOE (4 experts, top-2, hybrid dispatch)
   at full width and depth, batch 16 x 2048: 20/10/10 flash launches a
   step, the first loss repeated bit for bit by a fresh setup (the
   gradients are not held to that: the combine gather's backward adds
   with atomics), every loss and aux finite with each step's load-balance
   loss, as a mean over the layers, in (0.9, E + 1) (the seven steps of
   the phase: the first, one after the timed windows, five SGD steps),
   kernel against plain path at batch
   4 with the same limits (router and experts included), five SGD steps
   lowering the loss.  For that comparison the plain path takes the
   kernel path's top-k picks (`SharedRouting`): top-k turns the two
   attention paths' rounding differences into tokens routed to other
   experts, each moving its whole term of the router's (and the
   norm's) gradient; the share of tokens the plain path would route
   elsewhere is printed and must stay <= 5% in every layer.  MFU by the
   activated experts' FLOPs;
8. moe_serve: BENCH_MOE from init_params, quantized to int8 (the router
   stays fp32), served by `generate` at batch 16, prompt 128, 64 new
   tokens: shape, vocabulary range and finite logits gated; printed: the
   teacher-forced argmax of the int8 and of the bf16 model against the
   emitted tokens (one pass over 191 tokens fills each expert's
   per-row capacity, int(1.0 x 191 x 2 / 4) = 95, and the prefill's 64
   drops other choices, where single-token steps drop nothing), and
   against each other.  The same weights at capacity factor E / k = 2,
   where no pass drops a choice, are served too: there the one pass
   over the emitted tokens must pick >= 0.8 of them;
9. mesh_train: the sharded training step (models/train.py on a mesh:
   FSDP2 over data and fsdp, the tensor and expert blocks, the mesh train
   step) on a world-1 NCCL process group and `make_mesh(MeshConfig())`,
   all six dims 1; nothing falls back to gloo or to the unsharded step.
   BENCH_CHIP at batch 40 through setup_training(..., mesh), AdamW with a
   bf16 first moment: one step must launch exactly 20/10/10 flash
   kernels, and the median of five steps after it is printed beside the
   train phase's step time (the cost of the FSDP2 wrapping at world size
   1); at batch 8 from the same seed the mesh path against the unsharded
   kernel path: loss within 1e-3 relative (bit-identity printed), global
   gradient norm within 2e-2, every parameter's gradient cosine >= 0.99;
   BENCH_MOE at batch 4: one mesh step with 20/10/10 flash launches and a
   loss within 1e-3 relative of the unsharded kernel path's.  The
   process group is destroyed at the end.

It prints one JSON line per kernel shape and per slice, then a "kernels"
line (each kernel's launches on its main path, and beside them the
speculative run's int4 launches, one MoE step's and one mesh step's flash
launches), the nvidia-smi line, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

KERNEL_TOL = 1e-2
LOGITS_TOL = 2e-2
MIN_FORCED_AGREEMENT = 0.95
FLASH_FWD_TOL, FLASH_GRAD_TOL = 3e-2, 6e-2   # ci/flash_numerics.py
# scaled by the reference: max error / max |ref|, RMS error / RMS ref
FLASH_MAX_REL_TOL, FLASH_RMS_REL_TOL = 2e-2, 1e-2
FLASH_LSE_TOL = 1e-4
TRAIN_LOSS_TOL, TRAIN_NORM_TOL, TRAIN_MIN_COSINE = 1e-3, 2e-2, 0.99
REPS = 25
PLAIN_REPS = 3      # the plain attention at full size moves tens of GB
SEED = 0

# (K, N) of the int4 layers of Llama-2-7B with fused projections
LLAMA_LAYERS = {"qkv": (4096, 12288), "out": (4096, 4096),
                "gate_up": (4096, 22016), "down": (11008, 4096),
                "lm_head": (4096, 32000)}
CHECK_SHAPES = [(16, 1536, 6144), (16, 6144, 1536), (16, 1536, 32000),
                (128, 1536, 1536)]   # ci/int4_kernel_check.py
# one token; M, K (K % 128 = 64) and N (not a multiple of 64) ragged
# against the tiles; a prefill whose last token tile is ragged
EDGE_SHAPES = [(1, 4096, 4096), (17, 1600, 1552), (300, 4096, 4096)]
DECODE_M, PREFILL_M = 16, 2048
GAMMA = 4                          # draft tokens per speculative round
VERIFY_M = DECODE_M * (GAMMA + 1)  # the target's verify pass: 80 tokens
SPEC_NEW = 128                     # tokens a speculative run emits
DRAFT_LAYERS = 2                   # the draft: the target's first layers
SPEC_MIN_FORCED = 0.95             # emitted tokens that are the argmax
SPEC_GAP_TOL = 2e-2                # the others: gap / max |logit| of row
SPEC_MIN_ACCEPT = 0.9              # self-draft accept rate over its cap
MOE_BATCH, MOE_COMPARE_BATCH = 16, 4
# top-k turns the two attention paths' rounding differences into tokens
# routed to other experts (up to 2.2% in a layer, PERF.md): the plain
# path takes the kernel path's picks, and the tokens it would have routed
# elsewhere are bounded
MAX_ROUTING_FLIPS = 0.05
MOE_SERVE_NEW = 64
# int8 MoE serving with no capacity drops, teacher forced: a bf16 near-tie
# may flip a routing or an argmax, but a wrong cache or dispatch agrees
# about never on a random model
MIN_NO_DROP_AGREEMENT = 0.8
# kernels that must show HGMMA instructions and no spill stores
TENSOR_CORE_KERNELS = ("int4_matmul_kernel", "flash_fwd_kernel",
                       "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")
# (batch, seq, heads, kv heads, head dim, causal): ci/flash_numerics.py's
# SHAPES, then head dim 64 with GQA, a sequence that ends half way into a
# 128-row tile, and the non-causal case; the BENCH_CHIP training step's
# shape (TRAIN_CASE) comes last
FLASH_SHAPES = [(2, 2048, 12, 12, 128, True), (2, 1024, 16, 4, 128, True),
                (2, 256, 4, 4, 128, True), (2, 1024, 8, 2, 64, True),
                (2, 320, 4, 4, 128, True), (2, 256, 4, 4, 128, False)]
TRAIN_SHAPE = (40, 2048, 12, 12, 128)
TRAIN_CASE = TRAIN_SHAPE + (True,)
TRAIN_BATCH, COMPARE_BATCH = 40, 8
FLASH_REPLACES = {
    "flash_fwd": "kubeflow_tpu/ops/attention.py:173 -> jax/experimental/"
                 "pallas/ops/tpu/flash_attention.py:758",
    "flash_bwd_dkv": "kubeflow_tpu/ops/attention.py:173 -> jax/experimental/"
                     "pallas/ops/tpu/flash_attention.py:1121",
    "flash_bwd_dq": "kubeflow_tpu/ops/attention.py:173 -> jax/experimental/"
                    "pallas/ops/tpu/flash_attention.py:1456",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def kernel_name(mangled: str):
    """"flash_fwd_kernel<128>" or "int4_matmul_kernel<16,1,8>" from a
    mangled name: the identifier that a length prefix announces and that
    ends in _kernel, with its int template arguments."""
    for run in re.finditer(r"\d+", mangled):
        for i in range(len(run[0])):
            n = int(run[0][i:])
            ident = mangled[run.end():run.end() + n]
            if len(ident) == n and ident.endswith("_kernel"):
                args = re.match(r"I((?:Li-?\d+E)+)E", mangled[run.end() + n:])
                if not args:
                    return ident
                return ident + "<" + ",".join(
                    re.findall(r"Li(-?\d+)E", args[1])) + ">"
    return None


def ptxas_by_kernel(log: str) -> dict:
    """ptxas -v's register and spill lines, keyed by kernel name; a
    kernel's "Used N registers" is its count at launch, before any
    setmaxnreg."""
    out, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = kernel_name(line.split("Function properties for")[1])
        elif name and ("spill" in line or "registers" in line):
            out.setdefault(name, []).append(
                line.replace("ptxas info    :", "").strip())
    return {key: "; ".join(lines) for key, lines in out.items()}


def hgmma_by_kernel(libraries) -> dict:
    """The HGMMA (wgmma) instructions of each kernel in the built
    libraries' SASS, from cuobjdump -sass, keyed by kernel name."""
    from kubeflow_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    counts, name = {}, None
    for lib in libraries:
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        for line in sass.splitlines():
            found = re.search(r"Function : (\S+)", line)
            if found:
                name = kernel_name(found[1])
                counts.setdefault(name, 0)
            elif name and "HGMMA" in line:
                counts[name] += 1
    return counts


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
    # inner K tiles of 16: 8 where K % 128 == 0 (every main-path shape),
    # fewer where K is only a multiple of 64
    tiled = torch._convert_weight_to_int4pack(
        ((q[:, 0::2] << 4) | q[:, 1::2]).to(torch.uint8),
        8 if k % 128 == 0 else 4)
    s = scales.reshape(k // GROUP, n)
    scale_zero = torch.stack([s, torch.zeros_like(s)], dim=-1).contiguous()
    return lambda x: torch._weight_int4pack_mm(x, tiled, GROUP, scale_zero)


def kernel_phase(gen, edge_gen, verify_gen, device, peak, flush) -> dict:
    """Kernel against plain version at every shape, the edge shapes drawn
    from `edge_gen` and the speculative verify pass's (M = 80) from
    `verify_gen`; returns per-shape results keyed by (m, k, n)."""
    import torch

    from kubeflow_tpu_torch.models.quant import quantize_kernel_int4
    from kubeflow_tpu_torch.ops import int4_matmul as i4

    shapes = [(gen, shape) for shape in CHECK_SHAPES + [
        (m, k, n) for m in (DECODE_M, PREFILL_M)
        for k, n in LLAMA_LAYERS.values()]]
    shapes += [(edge_gen, shape) for shape in EDGE_SHAPES]
    shapes += [(verify_gen, (VERIFY_M, k, n))
               for k, n in LLAMA_LAYERS.values()]
    results, failed = {}, []
    for draw, (m, k, n) in shapes:
        w = torch.randn((k, n), generator=draw, device=device) * 0.05
        q = quantize_kernel_int4(w.to(torch.bfloat16))
        packed, scales = q["kernel_q4"], q["kernel_scale"]
        x = torch.randn((m, k), generator=draw, device=device
                        ).to(torch.bfloat16)
        got = i4.int4_matmul(x, packed, scales)
        repeat = torch.equal(i4.int4_matmul(x, packed, scales), got)
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
            "second_call_same_bits": repeat,
            "plan": i4.plan(m, k, n, torch.cuda.get_device_properties(
                device).multi_processor_count)._asdict(),
            "edge_shape": (m, k, n) in EDGE_SHAPES,
            "verify_shape": m == VERIFY_M,
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
            "ok": (finite and repeat and rel < KERNEL_TOL
                   and lib_rel < KERNEL_TOL),
        }
        emit(res)
        results[(m, k, n)] = res
        if not res["ok"]:
            failed.append((m, k, n))
        del w, q, packed, scales, x, got, ref, w_bf16, library, lib_got
    if failed:
        raise RuntimeError(f"int4_matmul or the library call disagrees with "
                           f"the plain version (max_rel_err >= {KERNEL_TOL}) "
                           f"or a second call differs at {failed}")
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
    return res, model


def shared_draft(target, num_layers: int):
    """A draft of the target's first `num_layers` layers that shares the
    target's modules (embedding, those layers, final norm, head): it
    draws and holds no weights of its own."""
    import torch

    from kubeflow_tpu_torch.models.transformer import Transformer

    cfg = target.cfg.with_(num_layers=num_layers)
    draft = Transformer(cfg.with_(num_layers=0), device="meta")
    draft.cfg, draft.device = cfg, target.device
    draft.embed, draft.final_norm = target.embed, target.final_norm
    draft.layers = torch.nn.ModuleList(target.layers[:num_layers])
    draft.lm_head = target.lm_head
    return draft


def event_timed(fn):
    """(fn(), its CUDA-event milliseconds)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def count_syncs(fn):
    """(fn(), the host syncs it made, where): torch's sync debug mode warns
    at every operation that waits for the card; the warnings are counted
    by the file and line that raised them."""
    import collections
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in seen
        if "synchroniz" in str(w.message))
    return out, sum(where.values()), dict(where)


def self_draft_run(model, prompt, new: int):
    """The target as its own draft: (tokens, rounds, the logits of every
    forward call in order, kept by a forward hook)."""
    from kubeflow_tpu_torch.models.speculative import speculative_generate

    calls = []

    def keep(_module, _args, _kwargs, out):
        calls.append(out)

    handle = model.register_forward_hook(keep, with_kwargs=True)
    try:
        out, rounds = speculative_generate(model.cfg, model, model.cfg,
                                           model, prompt, new, gamma=GAMMA)
    finally:
        handle.remove()
    return out, rounds, calls


def self_draft_cuts(calls, rounds: int, prompt_len: int, new: int) -> dict:
    """Replays each round of `self_draft_run` from its logits (the draft's
    gamma proposals, the verify pass's greedy tokens, m the least agreeing
    prefix over the rows, capped at gamma - 1) and, for each round cut
    short (m < gamma - 1), the verify pass's gap between its argmax and
    the rejected proposal, over max |logit| of the row, in every row that
    cut it.  A draft that is the target disagrees with it only where the
    draft's single-token step and the verify pass round a near-tie
    apart."""
    body = calls[2:]              # after the target's and draft's prefills
    n, total = prompt_len + 1, prompt_len + new
    replayed, cut_rounds, gaps = 0, 0, []
    while n < total and body:
        steps, body = body[:GAMMA + 1], body[GAMMA + 1:]
        proposals = [s[:, -1].argmax(-1) for s in steps[:GAMMA]]
        verify = steps[GAMMA]                            # [B, gamma+1, V]
        greedy = verify.argmax(-1)
        first = [GAMMA] * verify.shape[0]
        for i in reversed(range(GAMMA)):
            for b in (greedy[:, i] != proposals[i]).nonzero()[:, 0].tolist():
                first[b] = i
        m = min(min(first), GAMMA - 1)
        if m < GAMMA - 1:
            cut_rounds += 1
            for b in (r for r, f in enumerate(first) if f == m):
                row = verify[b, m].float()
                gaps.append(((row.max() - row[proposals[m][b]])
                             / row.abs().max()).item())
        n, replayed = n + m + 1, replayed + 1
    return {"rounds": rounds, "replayed": replayed if not body else -1,
            "cut_rounds": cut_rounds, "gaps": gaps}


def speculative_phase(model, device) -> dict:
    """Greedy speculative decoding of the slice's int4 Llama-2-7B (the
    target) with a draft of its first two layers, at batch 16, prompt
    128, 128 new tokens, gamma 4."""
    import torch

    from kubeflow_tpu_torch.models.generate import generate
    from kubeflow_tpu_torch.models.speculative import (
        speculative_generate,
        speculative_sample,
    )
    from kubeflow_tpu_torch.ops import int4_matmul as i4

    cfg, vocab = model.cfg, model.cfg.vocab_size
    batch, prompt_len, new = DECODE_M, 128, SPEC_NEW
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    prompt = torch.randint(0, vocab, (batch, prompt_len), generator=gen,
                           device=device)
    draft = shared_draft(model, DRAFT_LAYERS)

    def spec():
        return speculative_generate(cfg, model, draft.cfg, draft, prompt,
                                    new, gamma=GAMMA)

    speculative_generate(cfg, model, draft.cfg, draft, prompt, 2 * GAMMA,
                         gamma=GAMMA)                      # warm-up
    torch.cuda.synchronize()
    # the main path: every int4 launch counted
    i4.launches = 0
    (out, rounds), spec_ms = event_timed(spec)
    launches = i4.launches
    target_launches = 4 * cfg.num_layers + 1
    draft_launches = 4 * DRAFT_LAYERS + 1
    expected = (target_launches + draft_launches
                + rounds * (GAMMA * draft_launches + target_launches))
    if launches != expected:
        raise RuntimeError(f"speculative decoding launched int4_matmul "
                           f"{launches} times, expected {expected} for "
                           f"{rounds} rounds")

    shape_ok = (tuple(out.shape) == (batch, prompt_len + new)
                and bool((out[:, :prompt_len] == prompt).all().item())
                and 0 <= int(out.min()) and int(out.max()) < vocab)
    # exactness, teacher forced: the target's kernel path over the emitted
    # sequence in one pass
    with torch.inference_mode():
        forced = model(out[:, :-1], cache=model.new_cache(batch))
        forced = forced[:, prompt_len - 1:].float()        # [B, N, V]
        emitted = out[:, prompt_len:]
        top = forced.max(dim=-1).values
        picked = forced.gather(-1, emitted[..., None])[..., 0]
        is_argmax = picked == top
        gap_rel = (top - picked) / forced.abs().max(dim=-1).values
        argmax_share = is_argmax.float().mean().item()
        worst_gap = gap_rel.max().item()
        del forced

    plain, plain_ms = event_timed(lambda: generate(cfg, model, prompt, new))
    same_as_plain = (plain[:, prompt_len:] == emitted).float().mean().item()
    del plain
    (self_out, self_rounds, calls), self_ms = event_timed(
        lambda: self_draft_run(model, prompt, new))
    ideal = math.ceil((new - 1) / GAMMA)
    cuts = self_draft_cuts(calls, self_rounds, prompt_len, new)
    del calls
    (s_out, s_rounds, s_rate), sample_ms = event_timed(
        lambda: speculative_sample(
            cfg, model, cfg, model, prompt, new, gamma=GAMMA,
            temperature=0.8,
            generator=torch.Generator(device=device).manual_seed(SEED + 5)))
    sample_ok = (tuple(s_out.shape) == (batch, prompt_len + new)
                 and 0 <= int(s_out.min()) and int(s_out.max()) < vocab)
    _, spec_syncs, spec_sync_sites = count_syncs(spec)
    _, plain_syncs, _ = count_syncs(lambda: generate(cfg, model, prompt,
                                                     new))
    tokens = batch * new
    res = {
        "phase": "speculative", "target": "llama2-7b int4",
        "draft": f"the target's first {DRAFT_LAYERS} layers, shared",
        "batch": batch, "prompt_len": prompt_len, "new_tokens": new,
        "gamma": GAMMA, "rounds": rounds, "ideal_rounds": ideal,
        "tokens_per_round": (new - 1) / rounds,
        # the last round may emit up to gamma - 1 tokens past the end
        "acceptance_from_rounds": (new - 1 - rounds) / (rounds * GAMMA),
        "int4_launches": launches, "expected_launches": expected,
        "speculative_ms": spec_ms, "speculative_tok_s": tokens / spec_ms * 1e3,
        "plain_ms": plain_ms, "plain_tok_s": tokens / plain_ms * 1e3,
        "host_syncs": spec_syncs, "host_sync_sites": spec_sync_sites,
        "plain_host_syncs": plain_syncs,
        "same_tokens_as_plain_generate": same_as_plain,
        "teacher_forced_argmax_share": argmax_share,
        "teacher_forced_max_gap_rel": worst_gap,
        "self_draft_rounds": self_rounds, "self_draft_ms": self_ms,
        "self_draft_same_tokens": (self_out == out).float().mean().item(),
        "self_draft_cut_rounds": cuts["cut_rounds"],
        "self_draft_cut_gaps_rel": cuts["gaps"],
        "self_draft_rounds_replayed": cuts["replayed"],
        "sample_rounds": s_rounds, "sample_accept_rate": s_rate,
        "sample_ms": sample_ms, "outputs_ok": shape_ok and sample_ok,
    }
    emit(res)
    if not (shape_ok and sample_ok):
        raise RuntimeError("speculative decoding gave malformed tokens")
    if argmax_share < SPEC_MIN_FORCED or worst_gap > SPEC_GAP_TOL:
        raise RuntimeError(
            f"speculative tokens are not the target's greedy choice: "
            f"argmax share {argmax_share} (limit {SPEC_MIN_FORCED}), worst "
            f"gap {worst_gap} of max |logit| (limit {SPEC_GAP_TOL})")
    if (cuts["replayed"] != cuts["rounds"]
            or max(cuts["gaps"], default=0.0) > SPEC_GAP_TOL):
        raise RuntimeError(
            f"the target as its own draft: {cuts['rounds']} rounds, "
            f"{cuts['replayed']} replayed from its logits; a round was cut "
            f"by a disagreement wider than a near-tie ({cuts['gaps']}, "
            f"limit {SPEC_GAP_TOL})")
    if s_rate < SPEC_MIN_ACCEPT * (GAMMA - 1) / GAMMA:
        raise RuntimeError(f"self-draft sampling accepted {s_rate} of the "
                           f"draft tokens")
    return res


def flash_bounds(shape, causal: bool, peak) -> dict:
    """Least time of each flash kernel at `shape`: its products (forward 2,
    dK/dV 4, dQ 3, each 2*B*H*S^2*D FLOPs, halved when causal) at the
    card's bf16 peak, or its bytes (each input read once, each output
    written once) at the memory rate, whichever is larger."""
    batch, seq, heads, kv_heads, dim = shape
    q_bytes = batch * seq * heads * dim * 2
    kv_bytes = batch * seq * kv_heads * dim * 2
    row_bytes = batch * heads * seq * 4          # lse or di, fp32
    product = 2.0 * batch * heads * seq * seq * dim / (2 if causal else 1)
    work = {
        "flash_fwd": (2 * product, 2 * q_bytes + 2 * kv_bytes + row_bytes),
        "flash_bwd_dkv": (4 * product,
                          2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
        "flash_bwd_dq": (3 * product,
                         3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        if peak is None:
            out[name] = (None, None)
            continue
        ops_ms = flops / (peak.bf16_tflops * 1e12) * 1e3
        bytes_ms = nbytes / (peak.hbm_gbps * 1e9) * 1e3
        out[name] = (max(ops_ms, bytes_ms),
                     "operations" if ops_ms >= bytes_ms else "bytes")
    return out


def _max_abs(got, ref) -> float:
    return (got.float() - ref.float()).abs().max().item()


def _errors(got, ref) -> dict:
    """Max abs error, and the error scaled by the reference: max error /
    max |ref|, and RMS error / RMS of ref."""
    diff = got.float() - ref.float()
    ref = ref.float()
    max_abs = diff.abs().max().item()
    return {"max_abs": max_abs, "max_rel": max_abs / ref.abs().max().item(),
            "rms_rel": (diff.norm() / ref.norm()).item()}


def flash_phase(gen, device, peak, flush) -> dict:
    """Each flash kernel against its plain version at every case; returns
    {(batch, seq, heads, kv heads, head dim, causal): {kernel name:
    result}}."""
    import torch
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import flash_attention as fa

    results, failed = {}, []
    for case in FLASH_SHAPES + [TRAIN_CASE]:
        *shape, causal = case
        shape = tuple(shape)
        batch, seq, heads, kv_heads, dim = shape
        scale = dim ** -0.5
        q = torch.randn((batch, seq, heads, dim), generator=gen,
                        device=device).to(torch.bfloat16)
        k, v = (torch.randn((batch, seq, kv_heads, dim), generator=gen,
                            device=device).to(torch.bfloat16)
                for _ in range(2))
        do = torch.randn((batch, seq, heads, dim), generator=gen,
                         device=device).to(torch.bfloat16)

        o, lse = fa.flash_forward(q, k, v, scale, causal)
        di = fa.row_dot(o, do)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, di, scale, causal)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, di, scale, causal)
        dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse, di, scale, causal)
        dq2 = fa.flash_bwd_dq(q, k, v, do, lse, di, scale, causal)
        torch.cuda.synchronize()
        repeat = (torch.equal(dq, dq2) and torch.equal(dk, dk2)
                  and torch.equal(dv, dv2))
        del dq2, dk2, dv2
        finite = all(bool(torch.isfinite(t).all().item())
                     for t in (o, lse, dq, dk, dv))

        # the plain chain end to end: its own lse and di feed its backward
        ro, rlse = fa.flash_forward_reference(q, k, v, scale, causal)
        rdi = fa.row_dot(ro, do)
        errs = {"o": _errors(o, ro)}
        lse_err = (lse - rlse).abs().max().item()
        del ro
        rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, do, rlse, rdi, scale,
                                              causal)
        errs.update(dk=_errors(dk, rdk), dv=_errors(dv, rdv))
        del rdk, rdv
        rdq = fa.flash_bwd_dq_reference(q, k, v, do, rlse, rdi, scale,
                                        causal)
        errs["dq"] = _errors(dq, rdq)
        del rdq, rlse, rdi
        outputs = {"flash_fwd": ("o",), "flash_bwd_dkv": ("dk", "dv"),
                   "flash_bwd_dq": ("dq",)}
        err = {name: {key: max(errs[t][key] for t in ts)
                      for key in ("max_abs", "max_rel", "rms_rel")}
               for name, ts in outputs.items()}

        # the library yardstick, in its [B, H, S, D] layout
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        sdpa = functools.partial(F.scaled_dot_product_attention,
                                 is_causal=causal,
                                 enable_gqa=kv_heads != heads)
        lo = sdpa(qt, kt, vt)
        lgrads = torch.autograd.grad(lo, (qt, kt, vt), do.transpose(1, 2),
                                     retain_graph=True)
        sdpa_err = {"o": _max_abs(lo.transpose(1, 2), o),
                    "dq": _max_abs(lgrads[0].transpose(1, 2), dq),
                    "dk": _max_abs(lgrads[1].transpose(1, 2), dk),
                    "dv": _max_abs(lgrads[2].transpose(1, 2), dv)}
        del lgrads
        with torch.no_grad():
            sdpa_fwd_ms = timed_ms(lambda: sdpa(qt, kt, vt), flush)
        sdpa_bwd_ms = timed_ms(lambda: torch.autograd.grad(
            lo, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), flush)
        del lo, qt, kt, vt

        times = {
            "flash_fwd": (
                timed_ms(lambda: fa.flash_forward(q, k, v, scale, causal),
                         flush),
                timed_ms(lambda: fa.flash_forward_reference(q, k, v, scale,
                                                            causal),
                         flush, PLAIN_REPS),
                sdpa_fwd_ms),
            "flash_bwd_dkv": (
                timed_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, di,
                                                  scale, causal), flush),
                timed_ms(lambda: fa.flash_bwd_dkv_reference(
                    q, k, v, do, lse, di, scale, causal), flush, PLAIN_REPS),
                sdpa_bwd_ms),
            # SDPA's backward is timed once, on the dK/dV entry
            "flash_bwd_dq": (
                timed_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, di,
                                                 scale, causal), flush),
                timed_ms(lambda: fa.flash_bwd_dq_reference(
                    q, k, v, do, lse, di, scale, causal), flush, PLAIN_REPS),
                None),
        }
        library_calls = {
            "flash_fwd": "F.scaled_dot_product_attention",
            "flash_bwd_dkv": "backward of F.scaled_dot_product_attention "
                             "(dq, dk and dv in one call)",
            "flash_bwd_dq": None,
        }
        limits = {"flash_fwd": FLASH_FWD_TOL, "flash_bwd_dkv": FLASH_GRAD_TOL,
                  "flash_bwd_dq": FLASH_GRAD_TOL}
        bounds = flash_bounds(shape, causal, peak)
        results[case] = {}
        for name, (ms, plain_ms, library_ms) in times.items():
            e = err[name]
            ok = (finite and repeat and e["max_abs"] <= limits[name]
                  and e["max_rel"] <= FLASH_MAX_REL_TOL
                  and e["rms_rel"] <= FLASH_RMS_REL_TOL)
            res = {
                "phase": "flash", "kernel": name, "shape": list(shape),
                "causal": causal,
                "max_abs_err": e["max_abs"], "limit": limits[name],
                "max_rel_err": e["max_rel"], "max_rel_limit":
                FLASH_MAX_REL_TOL, "rms_rel_err": e["rms_rel"],
                "rms_rel_limit": FLASH_RMS_REL_TOL,
                "errors": {t: errs[t] for t in outputs[name]},
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1], "library_ms": library_ms,
                "library_call": library_calls[name],
                "finite": finite, "second_run_same_bits": repeat,
            }
            if name == "flash_fwd":
                ok = ok and lse_err <= FLASH_LSE_TOL
                res.update(lse_max_abs_err=lse_err, lse_limit=FLASH_LSE_TOL)
            elif name == "flash_bwd_dkv":
                res["library_covers"] = ["flash_bwd_dkv", "flash_bwd_dq"]
            else:
                res["library_covered_by"] = "flash_bwd_dkv"
            res["sdpa_max_abs_err"] = {t: sdpa_err[t] for t in outputs[name]}
            res["ok"] = ok
            emit(res)
            results[case][name] = res
            if not ok:
                failed.append((case, name))
        del q, k, v, do, o, lse, di, dq, dk, dv
        torch.cuda.empty_cache()
    if failed:
        raise RuntimeError(f"flash kernels disagree with their plain "
                           f"versions, vary between runs or give non-finite "
                           f"values at {failed}")
    return results


def _batch(vocab: int, batch: int, seq: int, seed: int, device) -> dict:
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    inputs = torch.randint(0, vocab, (batch, seq), generator=gen,
                           device=device)
    return {"inputs": inputs, "targets": torch.roll(inputs, -1, dims=1)}


def _loss_and_grads(model, batch):
    import torch

    from kubeflow_tpu_torch.models import train

    params = [p for p in model.parameters() if p.requires_grad]
    loss = train.loss_fn(model, batch)
    return loss.detach(), torch.autograd.grad(loss, params)


def train_phase(device, device_name, flash_results, flush) -> dict:
    import torch

    from kubeflow_tpu_torch.models import train
    from kubeflow_tpu_torch.models.configs import BENCH_CHIP
    from kubeflow_tpu_torch.models.transformer import Transformer
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.runtime.roofline import mfu, train_estimate

    cfg, seq = BENCH_CHIP, BENCH_CHIP.max_seq_len
    data = _batch(cfg.vocab_size, TRAIN_BATCH, seq, SEED, device)

    def adamw_setup(optimizer=None):
        return train.setup_training(
            cfg, device=device, seed=SEED,
            optimizer=optimizer or train.default_optimizer(
                mu_dtype="bfloat16"))

    t0 = time.perf_counter()
    setup = adamw_setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # the main path: one step, every flash launch counted
    torch.cuda.reset_peak_memory_stats()
    for key in fa.launches:
        fa.launches[key] = 0
    t0 = time.perf_counter()
    state, metrics = setup.train_step(setup.state, data)
    first_loss = metrics["loss"].clone()
    losses = [first_loss.item()]
    first_step_s = time.perf_counter() - t0
    launches = dict(fa.launches)
    peak_mem = torch.cuda.max_memory_allocated()
    grad_norm0 = metrics["grad_norm"].item()

    # the same seed, a fresh setup: the first loss repeats bit for bit
    again = adamw_setup()
    _, metrics2 = again.train_step(again.state, data)
    same_bits = torch.equal(metrics2["loss"], first_loss)
    del again, metrics2

    # the bench's windows: 3 x 3 steps, the first after one warm-up step
    windows = [train.timed_steps(setup, data, num_steps=3,
                                 warmup=1 if w == 0 else 0)
               for w in range(3)]
    losses += [w["loss"] for w in windows]
    ranked = sorted(windows[1:], key=lambda r: r["tokens_per_s"])
    timed = ranked[len(ranked) // 2]
    est = train_estimate(cfg, TRAIN_BATCH, seq, device_name)
    achieved = mfu(timed["tokens_per_s"], cfg, seq, 1, device_name)

    # the chunked loss alone, forward and backward (fp32 logits)
    hidden = torch.randn((TRAIN_BATCH, seq, cfg.embed_dim), device=device
                         ).to(torch.bfloat16).requires_grad_()
    head = setup.model.lm_head.kernel
    ce_ms = timed_ms(lambda: torch.autograd.grad(
        train.chunked_cross_entropy(hidden, data["targets"], head,
                                    cfg.loss_chunks), (hidden, head)),
        flush, reps=3)
    del hidden

    # kernel path against the plain path, same weights and batch
    small = _batch(cfg.vocab_size, COMPARE_BATCH, seq, SEED + 1, device)
    model_k = setup.model
    loss_k, grads_k = _loss_and_grads(model_k, small)
    model_p = Transformer(cfg.with_(attention_impl="xla"), device)
    model_p.load_state_dict(model_k.state_dict())
    loss_p, grads_p = _loss_and_grads(model_p, small)
    del model_p
    norm_k = train.global_norm(grads_k).item()
    norm_p = train.global_norm(grads_p).item()
    names = [n for n, p in model_k.named_parameters() if p.requires_grad]
    cosines = {n: torch.nn.functional.cosine_similarity(
        a.flatten().float(), b.flatten().float(), dim=0).item()
        for n, a, b in zip(names, grads_k, grads_p)}
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    norm_rel = abs(norm_k - norm_p) / norm_p
    worst = min(cosines, key=cosines.get)
    del grads_k, grads_p, setup, state, model_k
    torch.cuda.empty_cache()

    # five SGD(0.05) steps on one repeated batch lower the loss
    sgd = adamw_setup(train.SGD(0.05))
    sgd_losses = []
    state = sgd.state
    for _ in range(5):
        state, m = sgd.train_step(state, small)
        sgd_losses.append(m["loss"])
    sgd_losses = [x.item() for x in sgd_losses]
    del sgd, state
    losses += sgd_losses + [loss_k.item(), loss_p.item()]

    main = flash_results[TRAIN_CASE]
    flash_ms = sum(main[name]["ms"] * launches[key] for name, key in
                   (("flash_fwd", "fwd"), ("flash_bwd_dkv", "dkv"),
                    ("flash_bwd_dq", "dq")))
    expected = {"fwd": 2 * cfg.num_layers, "dkv": cfg.num_layers,
                "dq": cfg.num_layers}
    finite = all(math.isfinite(x) for x in losses + [grad_norm0])
    res = {
        "phase": "train", "model": "bench-chip", "layers": cfg.num_layers,
        "batch": TRAIN_BATCH, "seq": seq, "attention_impl":
        cfg.attention_impl, "remat_policy": cfg.remat_policy,
        "setup_s": setup_s, "first_step_s": first_step_s,
        "first_loss": losses[0], "first_grad_norm": grad_norm0,
        "flash_launches": launches, "expected_launches": expected,
        "peak_mem_gb": peak_mem / 1e9, "same_loss_bits": same_bits,
        "step_time_s": timed["step_time_s"],
        "tokens_per_s": timed["tokens_per_s"],
        "window_step_time_s": [w["step_time_s"] for w in windows],
        "mfu": achieved, "step_floor_s": est.step_floor_s,
        "bound": est.bound, "flops_per_step": est.flops,
        "flash_ms_per_step": flash_ms,
        "flash_share": flash_ms / 1e3 / timed["step_time_s"],
        "chunked_ce_fwd_bwd_ms": ce_ms,
        "compare_batch": COMPARE_BATCH,
        "loss_kernel": loss_k.item(), "loss_plain": loss_p.item(),
        "loss_rel_err": loss_rel, "grad_norm_kernel": norm_k,
        "grad_norm_plain": norm_p, "grad_norm_rel_err": norm_rel,
        "min_grad_cosine": cosines[worst], "min_grad_cosine_param": worst,
        "sgd_losses": sgd_losses, "losses_finite": finite,
    }
    emit(res)
    if launches != expected:
        raise RuntimeError(f"one training step launched the flash kernels "
                           f"{launches} times, expected {expected}")
    if not (finite and same_bits):
        raise RuntimeError("a training loss was not finite, or a fresh "
                           "setup from the same seed gave another first "
                           "loss")
    if (loss_rel > TRAIN_LOSS_TOL or norm_rel > TRAIN_NORM_TOL
            or cosines[worst] < TRAIN_MIN_COSINE):
        raise RuntimeError(
            f"kernel path and plain path disagree: loss rel {loss_rel} "
            f"(limit {TRAIN_LOSS_TOL}), grad norm rel {norm_rel} (limit "
            f"{TRAIN_NORM_TOL}), gradient cosine of {worst} "
            f"{cosines[worst]} (limit {TRAIN_MIN_COSINE})")
    if not sgd_losses[-1] < sgd_losses[0]:
        raise RuntimeError(f"five SGD steps did not lower the loss: "
                           f"{sgd_losses}")
    return res


class SharedRouting:
    """While a model runs inside `forcing(model)`, each of its MoE layers
    takes the top-k experts this object holds for it (its gate values
    from its own router probabilities at those experts); a layer with
    none held keeps its own picks, and they are held.  So a second model
    routes every token as the first did, and `flips[i]` is the share of
    tokens whose own top-k set in layer i differs from the held one."""

    def __init__(self):
        self.chosen, self.flips = {}, {}

    @contextlib.contextmanager
    def forcing(self, model):
        import torch

        real_topk, current = torch.topk, [None]
        holding = not self.chosen      # the first model sets the picks

        def topk(probs, k, dim=-1):
            own = real_topk(probs, k, dim=dim)
            i = current[0]
            if i is None:
                return own
            # the same ops on every call: a remat recompute must save
            # what the forward saved
            held = self.chosen.setdefault(i, own.indices)
            flips = (own.indices.sort(-1).values != held.sort(-1).values
                     ).any(-1).float().mean()
            if not holding:
                self.flips.setdefault(i, flips.item())
            return probs.gather(dim, held), held

        def layer_forward(i, forward):
            def run(x):
                current[0] = i
                try:
                    return forward(x)
                finally:
                    current[0] = None
            return run

        for i, layer in enumerate(model.layers):
            layer.moe.forward = layer_forward(i, layer.moe.forward)
        torch.topk = topk
        try:
            yield
        finally:
            torch.topk = real_topk
            for layer in model.layers:
                del layer.moe.forward


def moe_train_phase(device, device_name) -> dict:
    """The BENCH_MOE training step at full width and depth, batch 16 x
    2048, through setup_training (AdamW, bf16 first moment)."""
    import torch

    from kubeflow_tpu_torch.models import train
    from kubeflow_tpu_torch.models.configs import BENCH_MOE
    from kubeflow_tpu_torch.models.transformer import Transformer
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.runtime.roofline import mfu, train_estimate

    cfg, seq = BENCH_MOE, BENCH_MOE.max_seq_len
    data = _batch(cfg.vocab_size, MOE_BATCH, seq, SEED + 6, device)

    def setup(optimizer=None):
        return train.setup_training(
            cfg, device=device, seed=SEED + 6,
            optimizer=optimizer or train.default_optimizer(
                mu_dtype="bfloat16"))

    t0 = time.perf_counter()
    run = setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # the main path: one step, every flash launch counted
    torch.cuda.reset_peak_memory_stats()
    for key in fa.launches:
        fa.launches[key] = 0
    state, metrics = run.train_step(run.state, data)
    first_loss = metrics["loss"].clone()
    launches = dict(fa.launches)
    peak_mem = torch.cuda.max_memory_allocated()
    firsts = {k: metrics[k].item() for k in ("loss", "ce_loss",
                                             "moe_aux_loss", "grad_norm")}
    again = setup()
    _, metrics2 = again.train_step(again.state, data)
    same_bits = torch.equal(metrics2["loss"], first_loss)
    del again, metrics2

    windows = [train.timed_steps(run, data, num_steps=3,
                                 warmup=1 if w == 0 else 0)
               for w in range(3)]
    ranked = sorted(windows[1:], key=lambda r: r["tokens_per_s"])
    timed = ranked[len(ranked) // 2]
    est = train_estimate(cfg, MOE_BATCH, seq, device_name)
    achieved = mfu(timed["tokens_per_s"], cfg, seq, 1, device_name)
    _, metrics = run.train_step(run.state, data)
    auxes = [firsts["moe_aux_loss"], metrics["moe_aux_loss"].item()]
    losses = [firsts["loss"], firsts["ce_loss"]] + [
        w["loss"] for w in windows] + [metrics["loss"].item()]

    small = _batch(cfg.vocab_size, MOE_COMPARE_BATCH, seq, SEED + 7, device)
    model_k = run.model
    model_p = Transformer(cfg.with_(attention_impl="xla"), device)
    model_p.load_state_dict(model_k.state_dict())
    # the plain path routes as the kernel path did (see SharedRouting)
    routing = SharedRouting()
    with routing.forcing(model_k):
        loss_k, grads_k = _loss_and_grads(model_k, small)
    with routing.forcing(model_p):
        loss_p, grads_p = _loss_and_grads(model_p, small)
    del model_p
    flips = [routing.flips[i] for i in range(cfg.num_layers)]
    norm_k = train.global_norm(grads_k).item()
    norm_p = train.global_norm(grads_p).item()
    names = [n for n, p in model_k.named_parameters() if p.requires_grad]
    cosines = {n: torch.nn.functional.cosine_similarity(
        a.flatten().float(), b.flatten().float(), dim=0).item()
        for n, a, b in zip(names, grads_k, grads_p)}
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    norm_rel = abs(norm_k - norm_p) / norm_p
    worst = min(cosines, key=cosines.get)
    del grads_k, grads_p, run, state, model_k
    torch.cuda.empty_cache()

    sgd = setup(train.SGD(0.05))
    sgd_losses, state = [], sgd.state
    for _ in range(5):
        state, m = sgd.train_step(state, small)
        sgd_losses.append(m["loss"])
        auxes.append(m["moe_aux_loss"])
    sgd_losses = [x.item() for x in sgd_losses]
    auxes = [float(a) for a in auxes]
    del sgd, state
    torch.cuda.empty_cache()
    losses += sgd_losses + [loss_k.item(), loss_p.item()]

    expected = {"fwd": 2 * cfg.num_layers, "dkv": cfg.num_layers,
                "dq": cfg.num_layers}
    finite = all(math.isfinite(x) for x in losses + auxes
                 + [firsts["grad_norm"]])
    # moe_aux_loss sums the layers' losses, each in (0.9, E + 1): so does
    # each step's mean over the layers
    layer_means = [a / cfg.num_layers for a in auxes]
    aux_ok = all(0.9 < a < cfg.moe_experts + 1 for a in layer_means)
    res = {
        "phase": "moe_train", "model": "bench-moe", "layers": cfg.num_layers,
        "experts": cfg.moe_experts, "top_k": cfg.moe_top_k,
        "dispatch": cfg.moe_dispatch, "batch": MOE_BATCH, "seq": seq,
        "setup_s": setup_s, "first_loss": firsts["loss"],
        "first_ce_loss": firsts["ce_loss"],
        "first_moe_aux_loss": firsts["moe_aux_loss"],
        "moe_aux_layer_mean_per_step": layer_means,
        "first_grad_norm": firsts["grad_norm"],
        "flash_launches": launches, "expected_launches": expected,
        "peak_mem_gb": peak_mem / 1e9, "same_loss_bits": same_bits,
        "step_time_s": timed["step_time_s"],
        "tokens_per_s": timed["tokens_per_s"],
        "window_step_time_s": [w["step_time_s"] for w in windows],
        "mfu_activated": achieved, "step_floor_s": est.step_floor_s,
        "bound": est.bound, "flops_per_step": est.flops,
        "compare_batch": MOE_COMPARE_BATCH,
        "loss_kernel": loss_k.item(), "loss_plain": loss_p.item(),
        "loss_rel_err": loss_rel, "grad_norm_kernel": norm_k,
        "grad_norm_plain": norm_p, "grad_norm_rel_err": norm_rel,
        "min_grad_cosine": cosines[worst], "min_grad_cosine_param": worst,
        "router_grad_cosines": [
            cosines[f"layers.{i}.moe.router.kernel"]
            for i in range(cfg.num_layers)],
        "routing_flip_share": flips,
        "sgd_losses": sgd_losses, "losses_finite": finite,
    }
    emit(res)
    if launches != expected:
        raise RuntimeError(f"one MoE training step launched the flash "
                           f"kernels {launches} times, expected {expected}")
    if not (finite and same_bits and aux_ok):
        raise RuntimeError("a MoE training loss was not finite, a fresh "
                           "setup gave another first loss, or a layer's "
                           "load-balance loss left (0.9, E + 1)")
    if (loss_rel > TRAIN_LOSS_TOL or norm_rel > TRAIN_NORM_TOL
            or cosines[worst] < TRAIN_MIN_COSINE
            or max(flips) > MAX_ROUTING_FLIPS):
        raise RuntimeError(
            f"MoE kernel path and plain path disagree: loss rel {loss_rel} "
            f"(limit {TRAIN_LOSS_TOL}), grad norm rel {norm_rel} (limit "
            f"{TRAIN_NORM_TOL}), gradient cosine of {worst} "
            f"{cosines[worst]} (limit {TRAIN_MIN_COSINE}), tokens the plain "
            f"path would route elsewhere {max(flips)} (limit "
            f"{MAX_ROUTING_FLIPS})")
    if not sgd_losses[-1] < sgd_losses[0]:
        raise RuntimeError(f"five SGD steps did not lower the MoE loss: "
                           f"{sgd_losses}")
    return res


def flax_tree(model) -> dict:
    """A port model's parameters in the reference's tree layout (what the
    quantizers and `generate` take): `layers.3.x` becomes `layer_3/x`."""
    tree = {}
    for name, tensor in model.state_dict().items():
        parts = name.split(".")
        if parts[0] == "layers":
            parts = [f"layer_{parts[1]}"] + parts[2:]
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = tensor
    return tree


def moe_serve_phase(device) -> dict:
    """BENCH_MOE quantized to int8 (experts per expert and output
    channel, the router kept fp32) served by `generate` at batch 16,
    prompt 128, 64 new tokens."""
    import torch

    from kubeflow_tpu_torch.models.configs import BENCH_MOE
    from kubeflow_tpu_torch.models.convert import params_from_flax
    from kubeflow_tpu_torch.models.generate import generate, prepare_decode
    from kubeflow_tpu_torch.models.quant import quantize_params
    from kubeflow_tpu_torch.models.transformer import Transformer, init_params

    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    cfg, vocab = BENCH_MOE, BENCH_MOE.vocab_size
    batch, prompt_len, new = DECODE_M, 128, MOE_SERVE_NEW
    full = Transformer(cfg, device)
    init_params(full, gen)
    int8_cfg, tree = prepare_decode(cfg.with_(weight_dtype="int8"),
                                    quantize_params(flax_tree(full)))
    model = params_from_flax(tree, int8_cfg, device)
    # the same weights at capacity factor E / k: a buffer holds a whole
    # row, so no pass drops a choice and the one pass over the emitted
    # sequence sees what the steps saw
    no_drop_cfg = int8_cfg.with_(
        moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    no_drop = params_from_flax(tree, no_drop_cfg, device)
    del tree
    prompt = torch.randint(0, vocab, (batch, prompt_len), generator=gen,
                           device=device)
    generate(int8_cfg, model, prompt, 2)                  # warm-up
    out, ms = event_timed(lambda: generate(int8_cfg, model, prompt, new))
    nd_out = generate(no_drop_cfg, no_drop, prompt, new)
    with torch.inference_mode():
        logits = model(out[:, :-1], cache=model.new_cache(batch))
        finite = bool(torch.isfinite(logits).all().item())
        int8_forced = logits[:, prompt_len - 1:].argmax(-1)
        del logits
        # the bf16 model (fp32 master weights) over the same tokens
        bf16 = full(out[:, :-1], cache=full.new_cache(batch))
        bf16_forced = bf16[:, prompt_len - 1:].argmax(-1)
        del bf16
        nd_logits = no_drop(nd_out[:, :-1], cache=no_drop.new_cache(batch))
        nd_agreement = (nd_logits[:, prompt_len - 1:].argmax(-1)
                        == nd_out[:, prompt_len:]).float().mean().item()
        del nd_logits
    emitted = out[:, prompt_len:]
    shape_ok = (tuple(out.shape) == (batch, prompt_len + new)
                and bool((out[:, :prompt_len] == prompt).all().item())
                and 0 <= int(out.min()) and int(out.max()) < vocab)
    res = {
        "phase": "moe_serve", "model": "bench-moe", "weight_dtype": "int8",
        "batch": batch, "prompt_len": prompt_len, "new_tokens": new,
        "generate_ms": ms, "tok_s": batch * new / ms * 1e3,
        "logits_finite": finite, "outputs_ok": shape_ok,
        "int8_teacher_forced_agreement":
            (int8_forced == emitted).float().mean().item(),
        "bf16_teacher_forced_agreement":
            (bf16_forced == emitted).float().mean().item(),
        "int8_vs_bf16_teacher_forced":
            (int8_forced == bf16_forced).float().mean().item(),
        "no_drop_capacity_factor": no_drop_cfg.moe_capacity_factor,
        "no_drop_teacher_forced_agreement": nd_agreement,
    }
    emit(res)
    del full, model, no_drop
    torch.cuda.empty_cache()
    if not (shape_ok and finite):
        raise RuntimeError("int8 MoE generate gave malformed tokens or "
                           "non-finite logits")
    if nd_agreement < MIN_NO_DROP_AGREEMENT:
        raise RuntimeError(
            f"int8 MoE generate without capacity drops: the one pass over "
            f"its tokens picks {nd_agreement} of them (limit "
            f"{MIN_NO_DROP_AGREEMENT})")
    return res


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def mesh_train_phase(device, smi: str, train_step_s) -> dict:
    """The sharded training step (setup_training with a mesh: FSDP2 over
    data and fsdp, tensor and expert blocks, the mesh train step) on a
    world-1 NCCL process group, all six mesh dims 1."""
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.models import train
    from kubeflow_tpu_torch.models.configs import BENCH_CHIP, BENCH_MOE
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    phase_t0 = time.perf_counter()
    cfg, seq = BENCH_CHIP, BENCH_CHIP.max_seq_len
    expected = {"fwd": 2 * cfg.num_layers, "dkv": cfg.num_layers,
                "dq": cfg.num_layers}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh(MeshConfig(), device="cuda")
        if dist.get_backend() != "nccl" or mesh.size() != 1:
            raise RuntimeError(f"expected a world-1 NCCL mesh, got "
                               f"{dist.get_backend()} of {mesh.size()}")
        data = _batch(cfg.vocab_size, TRAIN_BATCH, seq, SEED, device)
        t0 = time.perf_counter()
        run = train.setup_training(
            cfg, mesh, device=device, seed=SEED,
            optimizer=train.default_optimizer(mu_dtype="bfloat16"))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        for key in fa.launches:
            fa.launches[key] = 0
        state, metrics = run.train_step(run.state, data)
        launches = dict(fa.launches)
        first_loss = metrics["loss"].item()
        # the train phase's windows and pick: 3 x 3 steps, the first
        # after one warm-up step
        windows = [train.timed_steps(run, data, num_steps=3,
                                     warmup=1 if w == 0 else 0)
                   for w in range(3)]
        steps_s = [w["step_time_s"] for w in windows]
        ranked = sorted(windows[1:], key=lambda r: r["tokens_per_s"])
        step_s = ranked[len(ranked) // 2]["step_time_s"]
        del run, state, metrics
        torch.cuda.empty_cache()

        # mesh path against the unsharded kernel path, same seed and batch
        small = _batch(cfg.vocab_size, COMPARE_BATCH, seq, SEED + 1, device)
        sharded = train.setup_training(cfg, mesh, device=device, seed=SEED,
                                       optimizer=train.SGD(0.05))
        metrics_m, _, grads_m, norm_m = train.mesh_loss_and_grads(
            sharded.model, small)
        names = [n for n, p in sharded.model.named_parameters()
                 if p.requires_grad]
        del sharded
        single = train.setup_training(cfg, device=device, seed=SEED,
                                      optimizer=train.SGD(0.05))
        loss_s, grads_s = _loss_and_grads(single.model, small)
        norm_s = train.global_norm(grads_s).item()
        del single
        cosines = {n: torch.nn.functional.cosine_similarity(
            a.flatten().float(), b.flatten().float(), dim=0).item()
            for n, a, b in zip(names, grads_m, grads_s)}
        loss_m = metrics_m["loss"]
        loss_rel = abs(loss_m.item() - loss_s.item()) / abs(loss_s.item())
        norm_rel = abs(norm_m.item() - norm_s) / norm_s
        worst = min(cosines, key=cosines.get)
        same_bits = torch.equal(loss_m, loss_s)
        del grads_m, grads_s
        torch.cuda.empty_cache()

        # BENCH_MOE: one mesh step against the unsharded kernel path's loss
        moe_data = _batch(BENCH_MOE.vocab_size, MOE_COMPARE_BATCH, seq,
                          SEED + 7, device)
        moe = train.setup_training(BENCH_MOE, mesh, device=device,
                                   seed=SEED + 6, optimizer=train.SGD(0.05))
        for key in fa.launches:
            fa.launches[key] = 0
        _, moe_metrics = moe.train_step(moe.state, moe_data)
        moe_launches = dict(fa.launches)
        moe_loss_m = moe_metrics["loss"].item()
        del moe, moe_metrics
        moe_single = train.setup_training(BENCH_MOE, device=device,
                                          seed=SEED + 6,
                                          optimizer=train.SGD(0.05))
        with torch.no_grad():
            moe_loss_s = train.loss_fn(moe_single.model, moe_data).item()
        del moe_single
        torch.cuda.empty_cache()
        moe_rel = abs(moe_loss_m - moe_loss_s) / abs(moe_loss_s)
    finally:
        dist.destroy_process_group()
    res = {
        "phase": "mesh_train", "backend": "nccl", "world_size": 1,
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "model": "bench-chip", "batch": TRAIN_BATCH, "seq": seq,
        "setup_s": setup_s, "first_loss": first_loss,
        "flash_launches": launches, "expected_launches": expected,
        "step_time_s": step_s, "window_step_time_s": steps_s,
        "train_phase_step_time_s": train_step_s,
        "nvidia_smi": smi, "compare_batch": COMPARE_BATCH,
        "loss_mesh": loss_m.item(), "loss_single": loss_s.item(),
        "loss_rel_err": loss_rel, "loss_bit_identical": same_bits,
        "grad_norm_mesh": norm_m.item(), "grad_norm_single": norm_s,
        "grad_norm_rel_err": norm_rel, "min_grad_cosine": cosines[worst],
        "min_grad_cosine_param": worst,
        "moe_batch": MOE_COMPARE_BATCH, "moe_flash_launches": moe_launches,
        "moe_loss_mesh": moe_loss_m, "moe_loss_single": moe_loss_s,
        "moe_loss_rel_err": moe_rel,
        "phase_s": time.perf_counter() - phase_t0,
    }
    emit(res)
    if launches != expected or moe_launches != expected:
        raise RuntimeError(f"a mesh training step launched the flash "
                           f"kernels {launches} (MoE {moe_launches}) times, "
                           f"expected {expected}")
    if not all(math.isfinite(x) for x in steps_s + [first_loss]):
        raise RuntimeError("a mesh training loss or step time was not "
                           "finite")
    if (loss_rel > TRAIN_LOSS_TOL or norm_rel > TRAIN_NORM_TOL
            or cosines[worst] < TRAIN_MIN_COSINE
            or moe_rel > TRAIN_LOSS_TOL):
        raise RuntimeError(
            f"mesh path and unsharded kernel path disagree: loss rel "
            f"{loss_rel}, MoE loss rel {moe_rel} (limit {TRAIN_LOSS_TOL}), "
            f"grad norm rel {norm_rel} (limit {TRAIN_NORM_TOL}), gradient "
            f"cosine of {worst} {cosines[worst]} (limit "
            f"{TRAIN_MIN_COSINE})")
    return res


def flash_kernel_lines(flash_results, launches: dict,
                       moe_launches: dict, mesh_launches: dict) -> list:
    """The kernels line's flash entries: the training-shape medians times
    the main path's launches per step; beside them the launches of one
    BENCH_MOE step and of one sharded (mesh) BENCH_CHIP step."""
    entries = []
    main = flash_results[TRAIN_CASE]
    for name, key in (("flash_fwd", "fwd"), ("flash_bwd_dkv", "dkv"),
                      ("flash_bwd_dq", "dq")):
        r, n = main[name], launches[key]
        entries.append({
            "name": name, "route": "cuda",
            "source": "kubeflow_tpu_torch/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES[name], "launches": n,
            "max_abs_err": max(flash_results[case][name]["max_abs_err"]
                               for case in flash_results),
            "ms": r["ms"] * n, "plain_ms": r["plain_ms"] * n,
            "bound_ms": None if r["bound_ms"] is None else r["bound_ms"] * n,
            "bound_by": r["bound_by"],
            "library_ms": (None if r["library_ms"] is None
                           else r["library_ms"] * n),
            "library_call": r["library_call"],
            **{key: r[key] for key in ("library_covers", "library_covered_by")
               if key in r},
            "moe_step_launches": moe_launches[key],
            "mesh_step_launches": mesh_launches[key],
            "ms_per_launch": r["ms"], "shape": list(TRAIN_SHAPE),
            "basis": "per-launch medians at the training shape times one "
                     "training step's launches",
        })
    return entries


def weighted_totals(results: dict, counts: dict) -> dict:
    """Per-shape medians times each shape's launches, summed: kernel,
    plain version, bound, library and the bf16-matmul yardstick."""
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
             "bf16_matmul_ms": 0.0}
    by_bytes = 0.0
    for shape, count in counts.items():
        r = results[shape]
        total["ms"] += count * r["kernel_ms"]
        total["plain_ms"] += count * r["plain_ms"]
        total["library_ms"] += count * r["library_ms"]
        total["bf16_matmul_ms"] += count * r["bf16_matmul_ms"]
        if r["bound_ms"] is None:
            total["bound_ms"] = None
        elif total["bound_ms"] is not None:
            total["bound_ms"] += count * r["bound_ms"]
            by_bytes += count * r["bound_ms"] * (r["bound_by"] == "bytes")
    bound_by = None if total["bound_ms"] is None else (
        "bytes" if by_bytes * 2 >= total["bound_ms"] else "operations")
    return {**total, "bound_by": bound_by}


def main_path_totals(results: dict, launches: int) -> dict:
    """The kernel line: per-shape times weighted by the main path's
    launches (prefill M=2048 once per layer, decode M=16 127 times), and
    the same for one decode step and one prefill."""
    step, prefill = {}, {}
    for name, (k, n) in LLAMA_LAYERS.items():
        per = 1 if name == "lm_head" else 32
        prefill[(PREFILL_M, k, n)] = per
        step[(DECODE_M, k, n)] = per
    counts = {**prefill, **{shape: 127 * c for shape, c in step.items()}}
    if sum(counts.values()) != launches:
        raise RuntimeError(f"main path launches {launches} do not match "
                           f"the per-shape counts {counts}")
    total = weighted_totals(results, counts)
    bf16_ms = total.pop("bf16_matmul_ms")
    # one speculative round: gamma steps of the two-layer draft at M=16,
    # then the target's verify pass at M=80
    spec_round = {}
    for name, (k, n) in LLAMA_LAYERS.items():
        draft = 1 if name == "lm_head" else DRAFT_LAYERS
        spec_round[(DECODE_M, k, n)] = GAMMA * draft
        spec_round[(VERIFY_M, k, n)] = 1 if name == "lm_head" else 32
    return {**total, "bf16_matmul_ms_path": bf16_ms,
            "decode_step": weighted_totals(results, step),
            "prefill": weighted_totals(results, prefill),
            "speculative_round": {
                **weighted_totals(results, spec_round),
                "launches": sum(spec_round.values())}}


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
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops import flash_attention as fa
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
    built = _build.build_all([i4.SOURCE, fa.SOURCE])
    build_s = time.perf_counter() - t0
    ptxas = ptxas_by_kernel("\n".join(log for _, log in built))
    hgmma = hgmma_by_kernel([lib for lib, _ in built])
    emit({"phase": "build", "build_s": build_s,
          "libraries": [str(lib.relative_to(ROOT)) for lib, _ in built],
          "ptxas": ptxas, "hgmma": hgmma})
    ours = [name for name in ptxas if name.startswith(TENSOR_CORE_KERNELS)]
    missing = [k for k in TENSOR_CORE_KERNELS
               if not any(name.startswith(k) for name in ours)]
    spilled = [name for name in ours if re.search(
        r"\b(\d+) bytes spill stores", ptxas[name])[1] != "0"]
    no_tensor_cores = [name for name in ours if not hgmma.get(name)]
    if missing or spilled or no_tensor_cores:
        raise RuntimeError(f"kernels missing from ptxas's report {missing}, "
                           f"spilling {spilled} or without HGMMA "
                           f"{no_tensor_cores}")

    gen = torch.Generator(device=device).manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=device)
    peak = GPU_PEAKS.get(device_name)
    # the edge shapes draw from their own generator, so the slice draws
    # the same weights from gen as before
    results = kernel_phase(
        gen, torch.Generator(device=device).manual_seed(SEED + 2),
        torch.Generator(device=device).manual_seed(SEED + 3), device,
        peak, flush)
    # its own generator, so the slice draws the same weights as before
    flash_results = flash_phase(
        torch.Generator(device=device).manual_seed(SEED + 1), device, peak,
        flush)
    sl, model = slice_phase(gen, device, device_name)
    sp = speculative_phase(model, device)
    del model
    torch.cuda.empty_cache()
    tr = train_phase(device, device_name, flash_results, flush)
    del flush
    mt = moe_train_phase(device, device_name)
    moe_serve_phase(device)
    mesh = mesh_train_phase(device, smi, tr["step_time_s"])

    totals = main_path_totals(results, sl["int4_launches"])
    emit({"kernels": [{
        "name": "int4_matmul", "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "kubeflow_tpu/ops/int4_matmul.py:87",
        "launches": sl["int4_launches"],
        "speculative_launches": sp["int4_launches"],
        "speculative_rounds": sp["rounds"],
        "max_abs_err": max(r["max_abs_err"] for r in results.values()),
        "max_rel_err": max(r["max_rel_err"] for r in results.values()),
        **totals, "library_call": "torch._weight_int4pack_mm",
        "basis": "ms, plain_ms, bound_ms and library_ms sum the per-shape "
                 "medians over the main path's launches; decode_step, "
                 "prefill and speculative_round over one decode step's, "
                 "one prefill's and one speculative round's",
    }] + flash_kernel_lines(flash_results, tr["flash_launches"],
                            mt["flash_launches"],
                            mesh["flash_launches"])})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
