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
   `cuobjdump -sass`.  Every kernel (int4, flash forward, dK/dV and dQ,
   the flash ones at head dims 64, 128 and 256) must show 0 bytes of
   spill stores, since a spill there also serialises its wgmma, and at
   least one HGMMA: all four run on the tensor cores;
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
   (17, 1600, 1552), and a ragged prefill tile (300, 4096, 4096); and,
   from a generator of their own, the fused layers of the decode bench's
   BENCH_CHIP and of Llama-2-13B at M = 16 and 2048 (the 13B run's and
   `bench --decode`'s decode steps and prefills), and from another one
   rank's shards of the 7B layers at tensor 2 (TP2_LAYERS) at the same
   M, each held as above;
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
   The single-token steps replay one captured CUDA graph (models/
   generate.py GraphedStep), and the wrappers' counts are credited per
   replay; the eager loop (`cuda_graph=False`) must give the graph's
   tokens bit for bit, and its decode steps are timed beside the
   graph's; a 10-step call is profiled for the graphed step's device
   time by kind (`decode_profile`);
   speculative: the slice's model as the target of
   models/speculative.py, its first two layers (sharing the target's
   modules, no weights of their own) as the draft, batch 16, prompt 128,
   128 new tokens, gamma 4, greedy, each round replaying one captured
   CUDA graph (models/speculative.py GraphedRound).  The same call on the
   eager loop (`cuda_graph=False`) must give the same tokens bit for bit
   in as many rounds, and so must the sampled self-draft run below; a
   16-token graphed call is profiled for the card's busy, idle and int4
   time per replay (`graphed_rounds_profile`).  The int4 launches must be
   129 (the target's prefill) + 9 (the draft's) + rounds x (4 x 9 + 129),
   credited per replay; the
   target's kernel path over the emitted sequence (teacher forced) must
   pick >= 0.95 of the emitted tokens as its argmax, and every other one
   within 2e-2 x max |logit| of its row's max; with the target as its
   own draft, on the eager loop (a forward hook fires at every call
   only there), every round its logits replay (the hook keeps them)
   must be one the run made, and every round cut short must have been
   cut at a near-tie: the rejected proposal within 2e-2 x max |logit| of
   the verify pass's argmax (the random model's logits are flat, and the
   draft's M = 16 and the verify pass's M = 80 round some near-ties
   apart, so its rounds exceed ceil(127 / 4) and are printed, not
   gated); sampling at temperature 0.8 with it must accept >= 0.9 x 3/4
   of the draft tokens.
   Speculative and plain `generate` tok/s (CUDA events) and rounds are
   printed, not gated (a random 2-layer draft agrees with the target
   about never), and the host syncs (torch's sync debug mode) of a
   short call of each, 8 new tokens, apart from the timed runs, per
   round for the speculative one;
   tp_decode: `generate(mesh=)`, tensor-parallel decode, of the slice's
   model at batch 16, prompt 128.  (a) On a world-1 NCCL mesh, graphed
   (the step with its logits all-gather captured), 128 new tokens: bit
   for bit the single-device graphed `generate`'s tokens, exactly 129 int4
   launches a step credited per replay.  (b) At tensor 2, two processes
   on the one card over gloo (eager: a gloo collective cannot be
   captured), each converting the same weights into its blocks, 8 new
   tokens: both ranks' tokens equal, exactly 129 int4 launches a step a
   rank at the five shard shapes, and >= 0.95 of the tokens the
   single-device model's teacher-forced argmax, every other within 2e-2 x
   max |logit| of its row's max.  Times are printed as two processes
   time-sharing one card, not a multi-GPU speed;
5. flash: the three flash-attention kernels (forward, dK/dV, dQ) against
   their plain versions at the three shapes of ci/flash_numerics.py, three
   shapes the kernels' tiles must handle (head dim 64 with GQA; S = 320,
   which leaves half of the last 128-row tile past the end; causal=False)
   and the training step's (40, 2048, 12, 12, 128); from a generator of
   their own, the long-context modes' sequences at batch 1,
   (1, 4096, 12, 12, 128) and (1, 8192, 12, 12, 128); then, from another,
   head dim 256 (GEMMA_7B's) at 16 heads and 2048, with GQA, at S = 320
   and non-causal, and the Gemma training step's (2, 8192, 16, 16, 256).
   Every case is compared and timed at its whole batch.  N(0, 1) bf16
   inputs and cotangent; each case's
   causal flag goes to the kernels, the plain chain and SDPA alike.  The
   plain backward starts from the plain forward's lse and
   di = rowsum(dO * plain O), never from the kernels'.
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
   gemma_train: GEMMA_7B at full width (3072 wide, 16 x 256 heads, MLP
   24576, vocabulary 256128 tied, softcap 30, attention_impl "auto"),
   depth cut to 8 layers (the whole model's weights, gradients and AdamW
   state are ~119 GB), 32 loss chunks, batch 2 x 8192, AdamW with a bf16
   first moment: one step must launch exactly 16 flash forwards (8
   layers, again in the remat recompute), 8 dK/dV and 8 dQ, all at head
   dim 256; a fresh setup repeats the first loss bit for bit; at batch 1
   the kernel path against the plain path with the train phase's gates;
   three SGD(0.05) steps lower the loss.  Step time, tokens/s, MFU, peak
   memory, the chunked loss's time alone and the profiled step's device
   time by kind (flash, fp32 GEMMs, other GEMMs, the rest) are printed;
   long_context: one step of each of the bench's long-context modes
   (BENCH_CHIP at 20 x 4096 and at 8 x 8192): exactly 20/10/10 flash
   launches and a finite loss each;
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
   process group is destroyed at the end;
10. pipeline_train: BENCH_CHIP at full width and depth in 2 pipeline
   stages of 5 layers (parallel/pipeline.py), under GPipe and under 1F1B.
   The machine has one card, so first two processes ask NCCL for an
   all-reduce on it and what it says is printed; the stages then run as
   two processes on the one card over a gloo process group, whose
   stage-to-stage sends go through pinned host memory (the transport is
   printed); compute, the flash kernels and the optimizer stay on the
   card.  At batch 8 from the same seed, 4 microbatches, against the
   unsharded kernel path: loss within 1e-3 relative, global gradient
   norm within 2e-2, every parameter's gradient cosine >= 0.99, and the
   flash launches of both stages summed exactly 4 x 20/10/10.  Each
   stage's peak memory (torch.cuda.max_memory_allocated) at 8
   microbatches is printed, of the schedule alone (the stage's forwards
   and backwards) and of the whole step (with the gradients'
   all-reduces and norm); stage 0's schedule peak under 1F1B must be
   below its under GPipe.  The step times are printed as what they are,
   two stages time-sharing one card;
11. notebook_train: the in-notebook runtime (runtime/data.py, telemetry.py,
   checkpoint.py) driving BENCH_CHIP at full width and depth, batch 8,
   AdamW (warmup 2, bf16 first moment), over a corpus of seeded
   ascending token runs.  Run A: 12 steps through input_pipeline
   (prefetch 2, pinned copies on a side stream) with a TelemetryAgent,
   one boundary a step after the host read of the loss.  Run B, the
   same seed: the cull request file appears before step 6's
   checkpoint_on_cull hook, which saves through the local backend and
   acknowledges; the loop exits and the pipeline closes.  A truncated
   copy of the checkpoint as step 7 and a leftover temp file are
   planted; a fresh setup from another seed restores (step 6, both
   deleted) and runs the pipeline's batches 7-12.  Then one dcp save
   and restore of the mesh setup on a world-1 NCCL group: a fresh mesh
   setup resumes it for 2 steps against the uninterrupted mesh run.
   Last, `python -m kubeflow_tpu_torch.examples.train_llm` as a
   subprocess must print RESULT: OK.  Gates: exactly 20/10/10 flash
   launches every step of runs A and B; every batch a step takes equals
   its TokenBatches batch bit for bit (compared on the step's stream,
   before it); the hook fires at step 6 only and the ack exists; the
   resumed losses and final parameters equal run A's steps 7-12 bit for
   bit, and the dcp round's too; the telemetry summary round-trips
   through annotation_payload/parse_annotation with a float mfu; run
   A's loss falls.  Printed: checkpoint bytes, save and restore seconds
   and GB/s, run A's median step time against the same setup's
   resident-batch timed_steps step time (the loader's cost), the
   telemetry summary.

12. llama13b: kubeflow_tpu_torch/examples/llama13b_decode.py, Llama-2-13B at
   full width and depth, int4, its weights made and quantized leaf by leaf
   on the card (models/quant.py fill_random), batch 16, prompt 128, 128
   new tokens: the example's record (tok/s against the int4 + KV
   roofline, peak memory), exactly (4 x 40 + 1) x 128 int4 launches a
   call, a profiled call's graphed step by kind, and the kernel path
   against the plain path with the slice phase's gates (prefill logits
   < 2e-2, teacher forced >= 0.95);
13. decode_bench: `python -m kubeflow_tpu_torch.bench --decode` in bf16,
   int8 and int4 (BENCH_CHIP, batch 16, prompt 128, 256 new tokens):
   each bench line, exactly (4 x 10 + 1) x 256 int4 launches a call in
   int4 and none in bf16 and int8, the bench's graphed warm-up call's
   greedy tokens against the eager loop's bit for bit (the eager call
   timed beside the bench's), and in bf16 a sampled call under the
   graph (in range);
14. speculative_demo: kubeflow_tpu_torch/examples/speculative_demo.py,
   the BENCH_CHIP-shaped target (vocabulary 1024) and its 2-layer draft
   trained 150 steps each on the affine stream (exactly 20/10/10 and
   4/2/2 flash launches a step), then graphed plain against graphed
   speculative greedy decode at batch 4, prompt 64, 256 new tokens,
   gamma 4: the
   speculative phase's teacher-forced token gates; rounds against the
   ideal 64 and the speedup (one timed call each) printed; then its
   --sample sweep (gamma 2, 4, 6 at T 0.8, one timed call each) on the
   same pair, acceptance and rounds in range;
15. vit: `python -m kubeflow_tpu_torch.bench --vit 5` (ViT-B/16, batch
   256): images/s and MFU, every window's loss finite and falling, no
   kernel launched (196 tokens take the einsum attention);
16. entry: kubeflow_tpu_torch/entry.py entry() (LLAMA2_350M, (2, 512)
   ones): exactly 24 flash forward launches (head dim 64) and nothing
   else, and the logits of the ones and of random tokens against the
   einsum path's: cross-entropy within 1e-3 relative, cosine >= 0.99;
17. serve_model: `python -m kubeflow_tpu_torch.examples.serve_model` on
   the card (TINY trained 5 steps, graphed plain decode, int8 decode,
   greedy speculative equal to plain, speculative sampling): rc 0 and
   RESULT: OK.

It prints one JSON line per kernel shape and per slice, then a "kernels"
line (each kernel's launches on its main path, and beside them the
graphed speculative run's int4 launches, the tensor-parallel decode's
(world-1, and per rank at tensor 2), one MoE step's, one mesh step's, one
pipelined step's of each schedule, one long-context step's and one
runtime-loop step's, one entry() forward's and the demo's training's flash
launches, and the decode bench's and the 13B run's int4 launches; the
head-dim-256 flash kernels as entries of their own,
*_d256, on the Gemma step), the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import functools
import io
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
# (K, N) of the int4 layers of the decode bench's BENCH_CHIP and of
# Llama-2-13B, fused, each at its decode step's and its prefill's M
BENCH_LAYERS = {"qkv": (1536, 4608), "out": (1536, 1536),
                "gate_up": (1536, 12288), "down": (6144, 1536),
                "lm_head": (1536, 32000)}
LLAMA13B_LAYERS = {"qkv": (5120, 15360), "out": (5120, 5120),
                   "gate_up": (5120, 27648), "down": (13824, 5120),
                   "lm_head": (5120, 32000)}
# (K, N) of one rank's int4 shards of Llama-2-7B at tensor 2: qkv, gate_up
# and the head cut over N, out and down over K
TP2_LAYERS = {"qkv": (4096, 6144), "out": (2048, 4096),
              "gate_up": (4096, 11008), "down": (5504, 4096),
              "lm_head": (4096, 16000)}
DECODE_M, PREFILL_M = 16, 2048
GAMMA = 4                          # draft tokens per speculative round
VERIFY_M = DECODE_M * (GAMMA + 1)  # the target's verify pass: 80 tokens
SPEC_NEW = 128                     # tokens a speculative run emits
DRAFT_LAYERS = 2                   # the draft: the target's first layers
SPEC_MIN_FORCED = 0.95             # emitted tokens that are the argmax
SPEC_GAP_TOL = 2e-2                # the others: gap / max |logit| of row
SPEC_MIN_ACCEPT = 0.9              # self-draft accept rate over its cap
SPEC_PROFILED_NEW = 16             # new tokens of the profiled graphed call
PROFILED_STEPS = 10                # decode steps under torch.profiler
DECODE_BENCH_NEW = 256             # bench --decode: new tokens a call
VIT_STEPS = 5                      # bench --vit: steps a window
DEMO_STEPS = 150                   # the speculative demo's training steps
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
# entry()'s forward (LLAMA2_350M on (2, 512)) and the speculative demo's
# training step (batch 16 x 512), from a generator of their own
FLASH_ENTRY_DEMO_SHAPES = [(2, 512, 16, 16, 64, True),
                           (16, 512, 12, 12, 128, True)]
TRAIN_SHAPE = (40, 2048, 12, 12, 128)
TRAIN_CASE = TRAIN_SHAPE + (True,)
TRAIN_BATCH, COMPARE_BATCH = 40, 8
# the long-context modes' attention (BENCH_CHIP at seq 4096 and 8192), at
# batch 1, from a generator of their own
FLASH_LONG_SHAPES = [(1, 4096, 12, 12, 128, True),
                     (1, 8192, 12, 12, 128, True)]
# head dim 256 (GEMMA_7B), from a generator of their own: 16 heads at 2048,
# GQA, half a 128-row tile past the end, non-causal; then the Gemma
# training step's attention (GEMMA_CASE) at its batch 2
FLASH_D256_SHAPES = [(2, 2048, 16, 16, 256, True), (2, 1024, 16, 8, 256, True),
                     (2, 320, 4, 4, 256, True), (2, 256, 4, 4, 256, False)]
GEMMA_SHAPE = (2, 8192, 16, 16, 256)
GEMMA_CASE = GEMMA_SHAPE + (True,)
GEMMA_LAYERS, GEMMA_LOSS_CHUNKS = 8, 32   # depth cut to fit one card
GEMMA_COMPARE_BATCH = 1
GEMMA_SGD_STEPS = 3
# pipeline_train: BENCH_CHIP's 10 layers in 2 stages of 5, one process a
# stage on the one card; gates at batch COMPARE_BATCH and PIPE_MICRO
# microbatches, peak memory at PIPE_MEMORY_MICRO
PIPE_STAGES, PIPE_MICRO, PIPE_MEMORY_MICRO = 2, 4, 8
PIPE_TIMED_STEPS = 3
PIPE_TIMEOUT_S = 420
# tp_decode: tensor 2 as two processes on the one card, TP_NEW new tokens
TP_RANKS, TP_NEW, TP_TIMEOUT_S = 2, 8, 300
# notebook_train: BENCH_CHIP at batch 8 through the runtime, 12 steps, the
# cull request before step 6's hook; the corpus is NB_RUNS seeded runs
NB_BATCH, NB_STEPS, NB_CULL_STEP, NB_RUNS = 8, 12, 6, 16384
NB_EXAMPLE_TIMEOUT_S = 240
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


def kernel_phase(gen, edge_gen, verify_gen, path_gen, shard_gen, device,
                 peak, flush) -> dict:
    """Kernel against plain version at every shape, the edge shapes drawn
    from `edge_gen`, the speculative verify pass's (M = 80) from
    `verify_gen`, the decode bench's and the 13B run's layers at their
    decode and prefill M from `path_gen`, and the tensor-2 shards of the
    7B layers at the same M from `shard_gen`; returns per-shape results
    keyed by (m, k, n)."""
    import torch

    from kubeflow_tpu_torch.models.quant import quantize_kernel_int4
    from kubeflow_tpu_torch.ops import int4_matmul as i4

    shapes = [(gen, shape) for shape in CHECK_SHAPES + [
        (m, k, n) for m in (DECODE_M, PREFILL_M)
        for k, n in LLAMA_LAYERS.values()]]
    shapes += [(edge_gen, shape) for shape in EDGE_SHAPES]
    shapes += [(verify_gen, (VERIFY_M, k, n))
               for k, n in LLAMA_LAYERS.values()]
    seen = {shape for _, shape in shapes}
    shapes += [(path_gen, (m, k, n)) for layers in (BENCH_LAYERS,
                                                    LLAMA13B_LAYERS)
               for m in (DECODE_M, PREFILL_M) for k, n in layers.values()
               if (m, k, n) not in seen]
    seen = {shape for _, shape in shapes}
    shapes += [(shard_gen, (m, k, n)) for m in (DECODE_M, PREFILL_M)
               for k, n in TP2_LAYERS.values() if (m, k, n) not in seen]
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
            "layer_of": [name for name, layers in (
                ("llama2-7b", LLAMA_LAYERS), ("bench-chip", BENCH_LAYERS),
                ("llama2-13b", LLAMA13B_LAYERS),
                ("llama2-7b tensor-2 shard", TP2_LAYERS)) if (k, n) in
                layers.values() and m in (DECODE_M, PREFILL_M, VERIFY_M)],
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


def set_plain(model, plain: bool) -> None:
    from kubeflow_tpu_torch.models.quant import Int4Linear

    for mod in model.modules():
        if isinstance(mod, Int4Linear):
            mod.plain = plain


def timed_generate(cfg, model, prompt, new, cuda_graph: bool = True):
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
        out = generate(cfg, model, prompt, new, cuda_graph=cuda_graph)
        host.append(time.perf_counter())
        end.record()
        end.synchronize()
    finally:
        handle.remove()
    return (out, start.elapsed_time(prefill_end),
            prefill_end.elapsed_time(end), host[1] - host[0])


def decode_profile(cfg, model, prompt, steps: int = PROFILED_STEPS,
                   top: int = 8) -> dict:
    """The graphed decode step's device time per step, from torch.profiler:
    the kernels of a greedy `generate` call of `steps` + 1 new tokens
    (`steps` decode steps: the graph's warm-up step and its replays)
    less those of a call that only prefills (`max_new_tokens` 1), over
    `steps`; by kind (the int4 kernel; cuBLAS GEMMs, the attention
    einsums' among them; softmax; the rest: casts, copies, norms, rope,
    the cache writes) and the kernels that took the most.
    The launch counts are put back as they were, so neither call enters
    a path total."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models.generate import generate
    from kubeflow_tpu_torch.ops import launch_counts

    def kernels(tokens: int) -> dict:
        """{kernel: (ms, launches)} of one call, summed from the profiler's
        raw device events: its per-operator tree (key_averages) takes
        seconds to build over a call's host operations."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            generate(cfg, model, prompt, tokens)
            torch.cuda.synchronize()
        found = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                ms, count = found.get(e.name(), (0.0, 0))
                found[e.name()] = (ms + e.duration_ns() / 1e6, count + 1)
        return found

    before = launch_counts.snapshot()
    full, prefill = kernels(steps + 1), kernels(1)
    launch_counts.restore(before)
    per_step = {}
    for name, (ms, count) in full.items():
        pre_ms, pre_count = prefill.get(name, (0.0, 0))
        if count > pre_count:
            per_step[name] = ((ms - pre_ms) / steps,
                              (count - pre_count) / steps)
    split = {"int4": 0.0, "gemm": 0.0, "softmax": 0.0, "rest": 0.0}
    for name, (ms, _) in per_step.items():
        low = name.lower()
        kind = ("int4" if "int4_matmul" in low else
                "gemm" if any(w in low for w in ("gemm", "nvjet", "xmma"))
                else "softmax" if "softmax" in low else "rest")
        split[kind] += ms
    ranked = sorted(per_step.items(), key=lambda kv: kv[1][0], reverse=True)
    return {"steps": steps, "device_ms_per_step": sum(split.values()),
            "by_kind": split,
            "top": [{"name": name[:100], "ms_per_step": ms,
                     "launches_per_step": count}
                    for name, (ms, count) in ranked[:top]]}


def slice_phase(gen, device, device_name) -> dict:
    import torch

    from kubeflow_tpu_torch.models.configs import LLAMA2_7B
    from kubeflow_tpu_torch.models.generate import decode_config, generate
    from kubeflow_tpu_torch.models.quant import fill_random
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
    profile = decode_profile(cfg, model, prompt)
    decode_s = decode_ms / 1e3
    # the eager loop: the same steps, each launched from Python
    eager, _, eager_ms, eager_host_s = timed_generate(
        cfg, model, prompt, new, cuda_graph=False)
    graph_equals_eager = torch.equal(eager, out)
    del eager

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
        "eager_decode_s": eager_ms / 1e3, "eager_decode_host_s": eager_host_s,
        "eager_decode_step_ms": eager_ms / (new - 1),
        "graph_speedup": eager_ms / decode_ms,
        "graph_equals_eager": graph_equals_eager,
        "graph_step_profile": profile,
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
    if not (shape_ok and finite and deterministic and graph_equals_eager):
        raise RuntimeError("generate gave malformed or run-to-run varying "
                           "tokens, non-finite logits, or its graph other "
                           "tokens than its eager loop")
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
    """The target as its own draft, on the eager loop (a forward hook
    fires at every call there; under a graph only at its capture):
    (tokens, rounds, the logits of every forward call in order)."""
    from kubeflow_tpu_torch.models.speculative import speculative_generate

    calls = []

    def keep(_module, _args, _kwargs, out):
        calls.append(out)

    handle = model.register_forward_hook(keep, with_kwargs=True)
    try:
        out, rounds = speculative_generate(model.cfg, model, model.cfg,
                                           model, prompt, new, gamma=GAMMA,
                                           cuda_graph=False)
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


def graphed_rounds_profile(fn) -> dict:
    """The card's time over the replays of a graphed speculative call
    fn(), from torch.profiler's raw events: from the first kernel after
    the first cudaGraphLaunch to the last kernel, the span, the busy time
    (the union of the device's kernels, copies and sets), the idle time
    (span less busy: what the host read and the Python between replays
    leave the card), and the int4 kernel's time, each per replay.  The
    launch counts are put back as they were."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.ops import launch_counts

    before = launch_counts.snapshot()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launch_counts.restore(before)
    events = prof.profiler.kineto_results.events()
    replays = sorted(e.start_ns() for e in events
                     if "cudaGraphLaunch" in e.name())
    if not replays:
        raise RuntimeError("no cudaGraphLaunch in the profile of a graphed "
                           "speculative call")
    work = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in events if e.device_type() == DeviceType.CUDA
                  and e.start_ns() >= replays[0])
    busy, (lo, hi, _) = 0, work[0]
    for start, end, _ in work[1:]:
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
    busy += hi - lo
    span = max(end for _, end, _ in work) - work[0][0]
    int4 = sum(end - start for start, end, name in work
               if "int4_matmul" in name)
    n = len(replays)
    return {"replays": n, "span_ms_per_replay": span / n / 1e6,
            "busy_ms_per_replay": busy / n / 1e6,
            "idle_ms_per_replay": (span - busy) / n / 1e6,
            "int4_ms_per_replay": int4 / n / 1e6,
            "int4_share_of_busy": int4 / busy}


def speculative_phase(model, device) -> dict:
    """Greedy speculative decoding of the slice's int4 Llama-2-7B (the
    target) with a draft of its first two layers, at batch 16, prompt
    128, 128 new tokens, gamma 4, its rounds replaying one captured CUDA
    graph, then the same call on the eager loop."""
    import torch

    from kubeflow_tpu_torch.models.generate import generate
    from kubeflow_tpu_torch.models.speculative import (
        speculative_generate,
        speculative_sample,
        teacher_forced_gaps,
    )
    from kubeflow_tpu_torch.ops import int4_matmul as i4

    cfg, vocab = model.cfg, model.cfg.vocab_size
    batch, prompt_len, new = DECODE_M, 128, SPEC_NEW
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    prompt = torch.randint(0, vocab, (batch, prompt_len), generator=gen,
                           device=device)
    draft = shared_draft(model, DRAFT_LAYERS)

    def spec(tokens: int = new, cuda_graph: bool = True):
        return speculative_generate(cfg, model, draft.cfg, draft, prompt,
                                    tokens, gamma=GAMMA,
                                    cuda_graph=cuda_graph)

    # the warm-up, a short call, counts the host syncs of its rounds
    (_, sync_rounds), spec_syncs, spec_sync_sites = count_syncs(
        lambda: spec(2 * GAMMA))
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

    # the same call with every round launched from Python
    (eager, eager_rounds), eager_ms = event_timed(
        lambda: spec(cuda_graph=False))
    graph_equals_eager = torch.equal(eager, out) and eager_rounds == rounds
    del eager
    rounds_profile = graphed_rounds_profile(lambda: spec(SPEC_PROFILED_NEW))
    # the same short call unprofiled: the main call's time past it over
    # its rounds past its rounds is a round's wall time without CUPTI's
    # tracing of every graph node
    (_, short_rounds), short_ms = event_timed(lambda: spec(SPEC_PROFILED_NEW))
    round_ms = (spec_ms - short_ms) / (rounds - short_rounds)
    rounds_profile.update(
        unprofiled_round_ms=round_ms,
        unprofiled_idle_ms_per_round=round_ms
        - rounds_profile["busy_ms_per_replay"])
    shape_ok = (tuple(out.shape) == (batch, prompt_len + new)
                and bool((out[:, :prompt_len] == prompt).all().item())
                and 0 <= int(out.min()) and int(out.max()) < vocab)
    # exactness, teacher forced: the target's kernel path over the emitted
    # sequence in one pass
    forced = teacher_forced_gaps(model, out, prompt_len)
    argmax_share, worst_gap = forced["argmax_share"], forced["max_gap_rel"]
    emitted = out[:, prompt_len:]

    plain, plain_ms = event_timed(lambda: generate(cfg, model, prompt, new))
    same_as_plain = (plain[:, prompt_len:] == emitted).float().mean().item()
    del plain
    (self_out, self_rounds, calls), self_ms = event_timed(
        lambda: self_draft_run(model, prompt, new))
    ideal = math.ceil((new - 1) / GAMMA)
    cuts = self_draft_cuts(calls, self_rounds, prompt_len, new)
    del calls
    def sample(cuda_graph: bool):
        return speculative_sample(
            cfg, model, cfg, model, prompt, new, gamma=GAMMA,
            temperature=0.8,
            generator=torch.Generator(device=device).manual_seed(SEED + 5),
            cuda_graph=cuda_graph)

    (s_out, s_rounds, s_rate), sample_ms = event_timed(lambda: sample(True))
    (es_out, es_rounds, es_rate), sample_eager_ms = event_timed(
        lambda: sample(False))
    sample_graph_equals_eager = (torch.equal(es_out, s_out)
                                 and (es_rounds, es_rate) == (s_rounds,
                                                              s_rate))
    del es_out
    sample_ok = (tuple(s_out.shape) == (batch, prompt_len + new)
                 and 0 <= int(s_out.min()) and int(s_out.max()) < vocab)
    _, plain_syncs, _ = count_syncs(lambda: generate(cfg, model, prompt,
                                                     2 * GAMMA))
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
        "eager_ms": eager_ms, "eager_tok_s": tokens / eager_ms * 1e3,
        "eager_rounds": eager_rounds, "graph_speedup": eager_ms / spec_ms,
        "graph_equals_eager": graph_equals_eager,
        "graphed_rounds_profile": rounds_profile,
        "plain_ms": plain_ms, "plain_tok_s": tokens / plain_ms * 1e3,
        # of the short calls: 2 x gamma new tokens each
        "host_syncs": spec_syncs, "host_sync_rounds": sync_rounds,
        "host_syncs_per_round": spec_syncs / sync_rounds,
        "host_sync_sites": spec_sync_sites, "plain_host_syncs": plain_syncs,
        "same_tokens_as_plain_generate": same_as_plain,
        "teacher_forced_argmax_share": argmax_share,
        "teacher_forced_max_gap_rel": worst_gap,
        "self_draft_rounds": self_rounds, "self_draft_ms": self_ms,
        "self_draft_same_tokens": (self_out == out).float().mean().item(),
        "self_draft_cut_rounds": cuts["cut_rounds"],
        "self_draft_cut_gaps_rel": cuts["gaps"],
        "self_draft_rounds_replayed": cuts["replayed"],
        "sample_rounds": s_rounds, "sample_accept_rate": s_rate,
        "sample_ms": sample_ms, "sample_eager_ms": sample_eager_ms,
        "sample_graph_equals_eager": sample_graph_equals_eager,
        "outputs_ok": shape_ok and sample_ok,
    }
    emit(res)
    if not (shape_ok and sample_ok):
        raise RuntimeError("speculative decoding gave malformed tokens")
    if not (graph_equals_eager and sample_graph_equals_eager):
        raise RuntimeError(
            f"the graphed speculative loop and the eager one disagree: "
            f"greedy tokens equal {graph_equals_eager} (rounds {rounds} "
            f"and {eager_rounds}), sampled {sample_graph_equals_eager} "
            f"(rounds {s_rounds} and {es_rounds})")
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


def _cpu_tree(node):
    """A param tree with its leaves copied to the host."""
    if isinstance(node, dict):
        return {k: _cpu_tree(v) for k, v in node.items()}
    return node.cpu()


def _int4_shapes(model) -> list:
    """(K, N) of every int4 layer's kernel as the model holds it."""
    from kubeflow_tpu_torch.models.quant import Int4Linear

    return sorted({(2 * m.kernel_q4.shape[0], m.kernel_q4.shape[1])
                   for m in model.modules() if isinstance(m, Int4Linear)})


def _tp_decode_rank(tree_path: str, cfg, prompt, new: int) -> list:
    """One rank of tensor-parallel decode of the 7B int4 model on card 0,
    in a gloo world of TP_RANKS processes: this rank's blocks of the tree
    at `tree_path`, `generate(mesh=)` (eager: gloo cannot be captured),
    its tokens, int4 launches and layer shapes.  Every rank's report."""
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.models.convert import params_from_flax
    from kubeflow_tpu_torch.models.generate import generate
    from kubeflow_tpu_torch.ops import int4_matmul as i4
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    mesh = make_mesh(MeshConfig(tensor=TP_RANKS), device="cuda")
    tree = torch.load(tree_path, mmap=True, weights_only=True)
    t0 = time.perf_counter()
    model = params_from_flax(tree, cfg, device, mesh)
    del tree
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    i4.launches = 0
    dist.barrier()
    t0 = time.perf_counter()
    out = generate(cfg, model, prompt.to(device), new, mesh=mesh)
    torch.cuda.synchronize()
    mine = {"rank": mesh.get_local_rank("tensor"),
            "backend": dist.get_backend(), "tokens": out.cpu(),
            "int4_launches": i4.launches, "int4_shapes": _int4_shapes(model),
            "load_s": load_s, "generate_s": time.perf_counter() - t0,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    reports = [None] * dist.get_world_size()
    dist.all_gather_object(reports, mine)
    return sorted(reports, key=lambda r: r["rank"])


def tp_decode_phase(model, device, smi: str) -> dict:
    """Tensor-parallel decode (`generate(mesh=)`) of the slice's int4
    Llama-2-7B at batch 16, prompt 128.  (a) A world-1 NCCL mesh: the
    step with its logits all-gather captured as a CUDA graph, held bit
    for bit to single-device graphed `generate` on the same weights, 128
    new tokens, 129 int4 launches a step credited per replay.  (b)
    Tensor 2 as two processes on the one card over gloo (eager), 8 new
    tokens, each rank on its blocks of the same weights: both ranks' tokens
    equal, 129 int4 launches a step a rank at the shard shapes
    (TP2_LAYERS), and the single-device model's teacher-forced gate of
    the speculative phase over them."""
    import tempfile

    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch import dryrun
    from kubeflow_tpu_torch.models.convert import flax_tree, params_from_flax
    from kubeflow_tpu_torch.models.generate import generate
    from kubeflow_tpu_torch.models.speculative import teacher_forced_gaps
    from kubeflow_tpu_torch.ops import int4_matmul as i4
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    phase_t0 = time.perf_counter()
    cfg, batch, prompt_len = model.cfg, DECODE_M, 128
    per_step = 4 * cfg.num_layers + 1
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=device)
    new = SPEC_NEW
    single, single_ms = event_timed(lambda: generate(cfg, model, prompt, new))
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh(MeshConfig(), device="cuda")
        tp_model = params_from_flax(flax_tree(model), cfg, device, mesh)
        backend = dist.get_backend(mesh.get_group("tensor"))
        # the first collective brings up the NCCL communicator
        generate(cfg, tp_model, prompt, 2, mesh=mesh)
        i4.launches = 0
        world1, world1_ms = event_timed(
            lambda: generate(cfg, tp_model, prompt, new, mesh=mesh))
        world1_launches = i4.launches
        world1_equal = torch.equal(world1, single)
        del tp_model, world1
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "llama7b_int4.pt")
        torch.save(_cpu_tree(flax_tree(model)), path)
        t0 = time.perf_counter()
        reports = dryrun.launch(TP_RANKS, _tp_decode_rank,
                                (path, cfg, prompt.cpu(), TP_NEW),
                                timeout=TP_TIMEOUT_S)
        tp2_s = time.perf_counter() - t0
    tokens = reports[0]["tokens"].to(device)
    ranks_equal = all(torch.equal(r["tokens"], reports[0]["tokens"])
                      for r in reports)
    forced = teacher_forced_gaps(model, tokens, prompt_len)
    tp2_single = generate(cfg, model, prompt, TP_NEW)
    want_shapes = sorted(TP2_LAYERS.values())
    res = {
        "phase": "tp_decode", "model": "llama2-7b int4", "batch": batch,
        "prompt_len": prompt_len,
        "world1": {"backend": backend, "new_tokens": new,
                   "tokens_equal_single_device": world1_equal,
                   "int4_launches": world1_launches,
                   "expected_launches": per_step * new,
                   "ms": world1_ms, "single_device_ms": single_ms,
                   "tok_s": batch * new / world1_ms * 1e3,
                   "single_device_tok_s": batch * new / single_ms * 1e3},
        "tensor2": {"ranks": TP_RANKS, "backend": reports[0]["backend"],
                    "new_tokens": TP_NEW, "ranks_equal": ranks_equal,
                    "int4_launches_per_rank": [r["int4_launches"]
                                               for r in reports],
                    "expected_launches_per_rank": per_step * TP_NEW,
                    "int4_shapes": reports[0]["int4_shapes"],
                    "expected_shapes": want_shapes,
                    "teacher_forced_argmax_share": forced["argmax_share"],
                    "teacher_forced_max_gap_rel": forced["max_gap_rel"],
                    "same_tokens_as_single_device": (
                        tokens == tp2_single).float().mean().item(),
                    "load_s": [r["load_s"] for r in reports],
                    "generate_s": [r["generate_s"] for r in reports],
                    "peak_mem_gb": [r["peak_mem_gb"] for r in reports],
                    "launch_s": tp2_s},
        "timing_note": "tensor 2 is two processes time-sharing one card "
                       "over gloo and host memory: not a multi-GPU speed",
        "nvidia_smi": smi, "phase_s": time.perf_counter() - phase_t0,
    }
    emit(res)
    bad = []
    if backend != "nccl" or not world1_equal:
        bad.append(f"world-1 mesh on {backend}: tokens equal to single-"
                   f"device graphed generate {world1_equal}")
    if world1_launches != per_step * new:
        bad.append(f"world-1 mesh launched int4 {world1_launches} times, "
                   f"expected {per_step * new}")
    if not ranks_equal:
        bad.append("the tensor-2 ranks hold different tokens")
    for r in reports:
        if r["int4_launches"] != per_step * TP_NEW or \
                r["int4_shapes"] != want_shapes:
            bad.append(f"tensor-2 rank {r['rank']} launched int4 "
                       f"{r['int4_launches']} times (expected "
                       f"{per_step * TP_NEW}) at {r['int4_shapes']} "
                       f"(expected {want_shapes})")
    if (forced["argmax_share"] < SPEC_MIN_FORCED
            or forced["max_gap_rel"] > SPEC_GAP_TOL):
        bad.append(f"tensor-2 tokens are not the single-device model's "
                   f"greedy choice: argmax share {forced['argmax_share']} "
                   f"(limit {SPEC_MIN_FORCED}), worst gap "
                   f"{forced['max_gap_rel']} (limit {SPEC_GAP_TOL})")
    if bad:
        raise RuntimeError("tp_decode: " + "; ".join(bad))
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


def flash_phase(gen, long_gen, d256_gen, path_gen, device, peak,
                flush) -> dict:
    """Each flash kernel against its plain version at every case, the
    long-context cases drawn from `long_gen`, the head-dim-256 cases
    from `d256_gen`, and entry()'s and the demo's from `path_gen`;
    returns {(batch, seq, heads, kv heads, head dim,
    causal): {kernel name: result}}."""
    import torch
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import flash_attention as fa

    results, failed = {}, []
    cases = [(gen, case) for case in FLASH_SHAPES + [TRAIN_CASE]]
    cases += [(long_gen, case) for case in FLASH_LONG_SHAPES]
    cases += [(d256_gen, case) for case in FLASH_D256_SHAPES + [GEMMA_CASE]]
    cases += [(path_gen, case) for case in FLASH_ENTRY_DEMO_SHAPES]
    for draw, case in cases:
        *shape, causal = case
        shape = tuple(shape)
        batch, seq, heads, kv_heads, dim = shape
        scale = dim ** -0.5
        q = torch.randn((batch, seq, heads, dim), generator=draw,
                        device=device).to(torch.bfloat16)
        k, v = (torch.randn((batch, seq, kv_heads, dim), generator=draw,
                            device=device).to(torch.bfloat16)
                for _ in range(2))
        do = torch.randn((batch, seq, heads, dim), generator=draw,
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
        sdpa = functools.partial(F.scaled_dot_product_attention,
                                 is_causal=causal,
                                 enable_gqa=kv_heads != heads)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
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


def kernel_vs_plain(model, batch, device) -> dict:
    """`model` (the kernel path) against a copy of its weights on the plain
    path (attention_impl="xla", the einsum reference) on `batch`: both
    losses and global gradient norms, and each parameter's gradient
    cosine.  While the plain path runs, the kernel path's fp32 gradients
    and `model` itself wait on the host, so the card holds one copy of
    the weights and one set of gradients (GEMMA_7B's are 12 GB each)."""
    import torch

    from kubeflow_tpu_torch.models import train
    from kubeflow_tpu_torch.models.transformer import Transformer

    loss_k, grads_k = _loss_and_grads(model, batch)
    norm_k = train.global_norm(grads_k).item()
    grads_k = [g.cpu() for g in grads_k]
    model_p = Transformer(model.cfg.with_(attention_impl="xla"), device)
    model_p.load_state_dict(model.state_dict())
    model.cpu()
    torch.cuda.empty_cache()
    loss_p, grads_p = _loss_and_grads(model_p, batch)
    del model_p
    norm_p = train.global_norm(grads_p).item()
    model.to(device)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    cosines = {n: torch.nn.functional.cosine_similarity(
        a.to(device).flatten().float(), b.flatten().float(), dim=0).item()
        for n, a, b in zip(names, grads_k, grads_p)}
    del grads_k, grads_p
    torch.cuda.empty_cache()
    loss_k, loss_p = loss_k.item(), loss_p.item()
    worst = min(cosines, key=cosines.get)
    return {"loss_kernel": loss_k, "loss_plain": loss_p,
            "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
            "grad_norm_kernel": norm_k, "grad_norm_plain": norm_p,
            "grad_norm_rel_err": abs(norm_k - norm_p) / norm_p,
            "min_grad_cosine": cosines[worst],
            "min_grad_cosine_param": worst}


def check_kernel_vs_plain(cmp: dict, what: str) -> None:
    """The training phases' gates on `kernel_vs_plain`'s result."""
    if (cmp["loss_rel_err"] > TRAIN_LOSS_TOL
            or cmp["grad_norm_rel_err"] > TRAIN_NORM_TOL
            or cmp["min_grad_cosine"] < TRAIN_MIN_COSINE):
        raise RuntimeError(
            f"{what}: kernel path and plain path disagree: loss rel "
            f"{cmp['loss_rel_err']} (limit {TRAIN_LOSS_TOL}), grad norm rel "
            f"{cmp['grad_norm_rel_err']} (limit {TRAIN_NORM_TOL}), gradient "
            f"cosine of {cmp['min_grad_cosine_param']} "
            f"{cmp['min_grad_cosine']} (limit {TRAIN_MIN_COSINE})")


def train_phase(device, device_name, flash_results, flush) -> dict:
    import torch

    from kubeflow_tpu_torch.models import train
    from kubeflow_tpu_torch.models.configs import BENCH_CHIP
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
    cmp = kernel_vs_plain(setup.model, small, device)
    del setup, state
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
    losses += sgd_losses + [cmp["loss_kernel"], cmp["loss_plain"]]

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
        "compare_batch": COMPARE_BATCH, **cmp,
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
    check_kernel_vs_plain(cmp, "BENCH_CHIP")
    if not sgd_losses[-1] < sgd_losses[0]:
        raise RuntimeError(f"five SGD steps did not lower the loss: "
                           f"{sgd_losses}")
    return res


def profile_split(profile: dict) -> dict:
    """Device ms of a profiled step (`bench.profile_step` with every
    kernel) by kind: the flash kernels, the fp32 GEMMs (the chunked
    loss's logits and their two gradients: cuBLAS names them sgemm or
    f32f32), the other GEMMs (bf16: the layers), and the rest."""
    split = {"flash": 0.0, "fp32_gemm": 0.0, "other_gemm": 0.0, "rest": 0.0}
    for k in profile["kernels"]:
        name = k["name"].lower()
        if "flash_" in name:
            split["flash"] += k["ms"]
        elif "gemm" in name or "nvjet" in name:
            fp32 = "sgemm" in name or "f32f32" in name
            split["fp32_gemm" if fp32 else "other_gemm"] += k["ms"]
        else:
            split["rest"] += k["ms"]
    total = sum(split.values())
    return {**split, "shares": {key: ms / total for key, ms in split.items()}}


def gemma_train_phase(device, device_name, smi: str, flash_results,
                      flush) -> dict:
    """GEMMA_7B at full width (head dim 256, tied embeddings, softcap 30),
    depth cut to GEMMA_LAYERS, 32 loss chunks, batch 2 x 8192, through
    setup_training and its train step, AdamW with a bf16 first moment;
    attention_impl "auto" takes the head-dim-256 flash kernels."""
    import torch

    from kubeflow_tpu_torch import bench
    from kubeflow_tpu_torch.models import train
    from kubeflow_tpu_torch.models.configs import GEMMA_7B
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.runtime.roofline import mfu, train_estimate

    phase_t0 = time.perf_counter()
    cfg = GEMMA_7B.with_(num_layers=GEMMA_LAYERS,
                         loss_chunks=GEMMA_LOSS_CHUNKS)
    batch, seq = GEMMA_SHAPE[0], cfg.max_seq_len
    seed = SEED + 11
    data = _batch(cfg.vocab_size, batch, seq, seed, device)

    def setup(optimizer=None):
        return train.setup_training(
            cfg, device=device, seed=seed,
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
    t0 = time.perf_counter()
    state, metrics = run.train_step(run.state, data)
    first_loss = metrics["loss"].clone()
    losses = [first_loss.item()]
    first_step_s = time.perf_counter() - t0
    launches = dict(fa.launches)
    grad_norm0 = metrics["grad_norm"].item()

    # 3 windows of 2 steps, the first after one warm-up step; then one
    # step under the profiler
    windows = [train.timed_steps(run, data, num_steps=2,
                                 warmup=1 if w == 0 else 0)
               for w in range(3)]
    losses += [w["loss"] for w in windows]
    peak_mem = torch.cuda.max_memory_allocated()
    ranked = sorted(windows[1:], key=lambda r: r["tokens_per_s"])
    timed = ranked[len(ranked) // 2]
    est = train_estimate(cfg, batch, seq, device_name)
    achieved = mfu(timed["tokens_per_s"], cfg, seq, 1, device_name)
    profile = bench.profile_step(run, data, top=100_000)
    split = profile_split(profile)
    del run, state, metrics
    torch.cuda.empty_cache()

    # the same seed, a fresh setup: the first loss repeats bit for bit
    again = setup()
    _, metrics2 = again.train_step(again.state, data)
    same_bits = torch.equal(metrics2["loss"], first_loss)
    del again, metrics2
    torch.cuda.empty_cache()

    # the chunked loss alone, forward and backward (fp32 logits over the
    # 256128-token vocabulary, softcapped)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    hidden = torch.randn((batch, seq, cfg.embed_dim), generator=gen,
                         device=device).to(torch.bfloat16).requires_grad_()
    head = (torch.randn((cfg.embed_dim, cfg.vocab_size), generator=gen,
                        device=device) * 0.02).requires_grad_()
    ce_ms = timed_ms(lambda: torch.autograd.grad(
        train.chunked_cross_entropy(hidden, data["targets"], head,
                                    cfg.loss_chunks, cfg.logits_softcap),
        (hidden, head)), flush, reps=3)
    del hidden, head
    torch.cuda.empty_cache()

    # kernel path against the plain path at batch 1 (the plain path's
    # [1, 16, 8192, 8192] fp32 scores), then SGD(0.05) steps on that batch
    # lower the loss
    small = _batch(cfg.vocab_size, GEMMA_COMPARE_BATCH, seq, seed + 2,
                   device)
    sgd = setup(train.SGD(0.05))
    cmp = kernel_vs_plain(sgd.model, small, device)
    sgd_losses, state = [], sgd.state
    for _ in range(GEMMA_SGD_STEPS):
        state, m = sgd.train_step(state, small)
        sgd_losses.append(m["loss"])
    sgd_losses = [x.item() for x in sgd_losses]
    del sgd, state
    torch.cuda.empty_cache()
    losses += sgd_losses + [cmp["loss_kernel"], cmp["loss_plain"]]

    main = flash_results[GEMMA_CASE]
    flash_ms = sum(main[name]["ms"] * launches[key] for name, key in
                   (("flash_fwd", "fwd"), ("flash_bwd_dkv", "dkv"),
                    ("flash_bwd_dq", "dq")))
    expected = {"fwd": 2 * cfg.num_layers, "dkv": cfg.num_layers,
                "dq": cfg.num_layers}
    finite = all(math.isfinite(x) for x in losses + [grad_norm0])
    res = {
        "phase": "gemma_train", "model": "gemma-7b", "nvidia_smi": smi,
        "layers": cfg.num_layers, "head_dim": cfg.head_dim,
        "vocab": cfg.vocab_size, "batch": batch, "seq": seq,
        "loss_chunks": cfg.loss_chunks, "attention_impl":
        cfg.attention_impl, "remat_policy": cfg.remat_policy,
        "params": cfg.num_params, "setup_s": setup_s,
        "first_step_s": first_step_s, "first_loss": losses[0],
        "first_grad_norm": grad_norm0, "flash_launches": launches,
        "expected_launches": expected, "peak_mem_gb": peak_mem / 1e9,
        "same_loss_bits": same_bits, "step_time_s": timed["step_time_s"],
        "tokens_per_s": timed["tokens_per_s"],
        "window_step_time_s": [w["step_time_s"] for w in windows],
        "mfu": achieved, "step_floor_s": est.step_floor_s,
        "bound": est.bound, "flops_per_step": est.flops,
        "flash_ms_per_step": flash_ms,
        "flash_share": flash_ms / 1e3 / timed["step_time_s"],
        "chunked_ce_fwd_bwd_ms": ce_ms,
        "chunked_ce_share": ce_ms / 1e3 / timed["step_time_s"],
        "profile": {"wall_ms": profile["wall_ms"],
                    "device_ms": profile["device_ms"],
                    "idle_share": profile["idle_share"], "split_ms": split,
                    "top": profile["kernels"][:15]},
        "compare_batch": GEMMA_COMPARE_BATCH, **cmp,
        "sgd_losses": sgd_losses, "losses_finite": finite,
        "phase_s": time.perf_counter() - phase_t0,
    }
    emit(res)
    if launches != expected:
        raise RuntimeError(f"one Gemma training step launched the flash "
                           f"kernels {launches} times, expected {expected}")
    if not (finite and same_bits):
        raise RuntimeError("a Gemma training loss was not finite, or a fresh "
                           "setup from the same seed gave another first "
                           "loss")
    check_kernel_vs_plain(cmp, "GEMMA_7B")
    if not sgd_losses[-1] < sgd_losses[0]:
        raise RuntimeError(f"{GEMMA_SGD_STEPS} SGD steps did not lower the "
                           f"Gemma loss: {sgd_losses}")
    return res


def long_context_phase(device) -> dict:
    """One training step of each of the bench's long-context modes
    (BENCH_CHIP at 20 x 4096 and 8 x 8192, AdamW with a bf16 first
    moment): exactly 20/10/10 flash launches and a finite loss each; a
    second step is timed, for the record only."""
    import torch

    from kubeflow_tpu_torch import bench
    from kubeflow_tpu_torch.models import train
    from kubeflow_tpu_torch.ops import flash_attention as fa

    results = {}
    for i, long_context in enumerate(sorted(bench.LONG_CONTEXT)):
        cfg, batch, seq = bench.workload(long_context=long_context)
        data = _batch(cfg.vocab_size, batch, seq, SEED + 13 + i, device)
        run = train.setup_training(
            cfg, device=device, seed=SEED,
            optimizer=train.default_optimizer(mu_dtype="bfloat16"))
        for key in fa.launches:
            fa.launches[key] = 0
        state, metrics = run.train_step(run.state, data)
        loss = metrics["loss"].item()
        launches = dict(fa.launches)
        t0 = time.perf_counter()
        state, metrics = run.train_step(state, data)
        metrics["loss"].item()
        step_s = time.perf_counter() - t0
        del run, state, metrics
        torch.cuda.empty_cache()
        expected = {"fwd": 2 * cfg.num_layers, "dkv": cfg.num_layers,
                    "dq": cfg.num_layers}
        res = {"phase": "long_context", "model": "bench-chip",
               "batch": batch, "seq": seq, "flash_launches": launches,
               "expected_launches": expected, "first_loss": loss,
               "second_step_s": step_s}
        emit(res)
        if launches != expected or not math.isfinite(loss):
            raise RuntimeError(f"the long-context step at seq {seq} launched "
                               f"{launches} (expected {expected}) or gave a "
                               f"non-finite loss {loss}")
        results[seq] = res
    return results


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


def moe_serve_phase(device) -> dict:
    """BENCH_MOE quantized to int8 (experts per expert and output
    channel, the router kept fp32) served by `generate` at batch 16,
    prompt 128, 64 new tokens."""
    import torch

    from kubeflow_tpu_torch.models.configs import BENCH_MOE
    from kubeflow_tpu_torch.models.convert import flax_tree, params_from_flax
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


def decode_bench_phase(device, smi: str) -> dict:
    """`python -m kubeflow_tpu_torch.bench --decode` in bf16, int8 and int4
    (BENCH_CHIP at batch 16, prompt 128, 256 new tokens): each mode's
    bench line through `bench.run_decode`, its kernel launches counted
    (int4: (4 x 10 + 1) x 256 a `generate` call, the warm-up's included,
    credited by the graph's replays; bf16 and int8 none), and the bench's
    graphed warm-up call against the eager loop on the same model and
    prompt, greedy tokens bit for bit.  For bf16 also one sampled call
    (T 0.8, top-k 50, seeded generator) under the graph: in range."""
    import torch

    from kubeflow_tpu_torch import bench
    from kubeflow_tpu_torch.models.configs import BENCH_CHIP
    from kubeflow_tpu_torch.models.generate import generate
    from kubeflow_tpu_torch.ops import launch_counts

    per_call = (4 * BENCH_CHIP.num_layers + 1) * DECODE_BENCH_NEW
    out = {}
    for quant in ("", "int8", "int4"):
        launch_counts.restore({k: 0 for k in launch_counts.snapshot()})
        record, (cfg, model, prompt, graphed) = bench.run_decode(
            ["--decode"] + ([f"--{quant}"] if quant else []))
        launches = launch_counts.snapshot()
        calls = record["detail"]["timed_calls"] + 1
        expected = {k: 0 for k in launches}
        if quant == "int4":
            expected["int4_matmul"] = calls * per_call
        new = record["detail"]["new_tokens"]
        eager, eager_ms = event_timed(lambda: generate(
            cfg, model, prompt, new, cuda_graph=False))
        same = torch.equal(graphed, eager)
        sampled = {}
        if not quant:
            draw = generate(cfg, model, prompt, new, temperature=0.8,
                            top_k=50, generator=torch.Generator(
                                device=device).manual_seed(SEED + 22))
            sampled = {"sampled_in_range": bool(
                0 <= int(draw.min()) and int(draw.max()) < cfg.vocab_size)}
        del model, graphed, eager
        torch.cuda.empty_cache()
        batch = record["detail"]["batch"]
        res = {"phase": "decode_bench", "mode": quant or "bf16",
               "metric": record["metric"], "tok_s": record["value"],
               "roofline_fraction": record["roofline_fraction"],
               "vs_baseline": record["vs_baseline"],
               "hbm_roofline_tok_s": record["detail"]["hbm_roofline_tok_s"],
               # one eager call, its prefill included, as the bench's
               "eager_tok_s": batch * new / eager_ms * 1e3,
               "generate_calls": calls, "launches": launches,
               "expected_launches": expected,
               "graph_equals_eager": same, **sampled, "record": record,
               "nvidia_smi": smi}
        emit(res)
        out[quant or "bf16"] = res
        if launches != expected:
            raise RuntimeError(f"decode bench {res['mode']}: launches "
                               f"{launches}, expected {expected}")
        if not same or sampled.get("sampled_in_range") is False:
            raise RuntimeError(f"decode bench {res['mode']}: the graph's "
                               f"greedy tokens differ from the eager loop's, "
                               f"or sampled tokens are out of range")
    return out


def vit_phase(device, smi: str) -> dict:
    """`python -m kubeflow_tpu_torch.bench --vit`: ViT-B/16 at batch 256,
    AdamW as optax.adamw(1e-4), a warm-up step and the best of 3 windows
    of VIT_STEPS steps; images/s and MFU printed, every window's loss
    finite and the last below the first.  The path runs no hand-written
    kernel (196 tokens take the einsum attention), so the flash counts
    must stay 0."""
    from kubeflow_tpu_torch import bench
    from kubeflow_tpu_torch.ops import launch_counts

    launch_counts.restore({k: 0 for k in launch_counts.snapshot()})
    record = bench.main_vit(["--vit", str(VIT_STEPS)])
    launches = launch_counts.snapshot()
    losses = record["detail"]["window_losses"]
    res = {"phase": "vit", "metric": record["metric"],
           "mfu": record["value"],
           "images_per_s": record["detail"]["images_per_s"],
           "window_losses": losses, "launches": launches,
           "nvidia_smi": smi}
    emit(res)
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
            and not any(launches.values())):
        raise RuntimeError(f"ViT bench: losses {losses} not finite or not "
                           f"falling, or kernels launched {launches}")
    return res


def llama13b_phase(device, smi: str) -> dict:
    """kubeflow_tpu_torch/examples/llama13b_decode.py: Llama-2-13B at full
    width and depth, int4, batch 16, prompt 128, 128 new tokens.  Its
    record (a warm-up call and 3 timed, all through the int4 kernel:
    (4 x 40 + 1) x 128 launches each, credited by replay), then on the
    same model a profiled 10-step call (`decode_profile`) and the kernel path
    against the plain path: prefill logits within the slice phase's 2e-2
    and >= 0.95 of the kernel path's tokens picked by the plain path
    teacher forced."""
    import torch

    from kubeflow_tpu_torch.examples import llama13b_decode as ex
    from kubeflow_tpu_torch.models.generate import generate
    from kubeflow_tpu_torch.ops import int4_matmul as i4

    t0 = time.perf_counter()
    cfg, model, streamed = ex.build(device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    i4.launches = 0
    record = ex.measure(cfg, model)
    launches = i4.launches
    expected = (ex.TIMED_CALLS + 1) * (4 * cfg.num_layers + 1) * ex.NEW
    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    prompt = torch.randint(0, cfg.vocab_size, (ex.BATCH, ex.PROMPT),
                           generator=gen, device=device)
    out = generate(cfg, model, prompt, ex.NEW)
    profile = decode_profile(cfg, model, prompt)
    with torch.inference_mode():
        logits_k = model(prompt, cache=model.new_cache(ex.BATCH))
        set_plain(model, True)
        logits_p = model(prompt, cache=model.new_cache(ex.BATCH))
        logits_rel = ((logits_k - logits_p).abs().max()
                      / logits_p.abs().max()).item()
        finite = bool(torch.isfinite(logits_k).all().item())
        del logits_k, logits_p
        forced = model(out[:, :-1], cache=model.new_cache(ex.BATCH))
        forced_agreement = (forced[:, ex.PROMPT - 1:].argmax(-1)
                            == out[:, ex.PROMPT:]).float().mean().item()
        del forced
        set_plain(model, False)
    del model
    torch.cuda.empty_cache()
    res = {"phase": "llama13b", "record": record, "setup_s": setup_s,
           "streamed_int4_gb": streamed / 1e9, "int4_launches": launches,
           "expected_launches": expected, "graph_step_profile": profile,
           "prefill_logits_max_rel_err": logits_rel,
           "logits_finite": finite,
           "teacher_forced_agreement": forced_agreement,
           "nvidia_smi": smi}
    emit(res)
    if launches != expected:
        raise RuntimeError(f"13B decode launched int4_matmul {launches} "
                           f"times, expected {expected}")
    if (not finite or logits_rel >= LOGITS_TOL
            or forced_agreement < MIN_FORCED_AGREEMENT):
        raise RuntimeError(
            f"13B: kernel path and plain path disagree: prefill logits "
            f"max_rel_err {logits_rel} (limit {LOGITS_TOL}), teacher-forced "
            f"agreement {forced_agreement} (limit {MIN_FORCED_AGREEMENT})")
    return res


def speculative_demo_phase(device, smi: str) -> dict:
    """kubeflow_tpu_torch/examples/speculative_demo.py: the BENCH_CHIP-shaped
    target and its 2-layer draft trained DEMO_STEPS steps each on the
    affine stream, on the flash kernels (exactly 20/10/10 launches a
    target step and 4/2/2 a draft step); then greedy plain (graphed)
    against speculative decode at batch 4, prompt 64, 256 new tokens,
    gamma 4: the speculative phase's token gates on the speculative
    tokens, teacher forced; rounds against the ideal 64 and the speedup
    (one timed call of each after its warm-up) printed.  Then the demo's
    --sample sweep on the same pair (graphed
    sampled `generate` against `speculative_sample` at T 0.8, gamma 2, 4
    and 6), each timed once after its warm-up: every acceptance rate
    within [0, (gamma - 1) / gamma] and the rounds at least
    ceil(255 / gamma); speedups printed."""
    from kubeflow_tpu_torch.examples import speculative_demo as ex
    from kubeflow_tpu_torch.ops import flash_attention as fa

    for key in fa.launches:
        fa.launches[key] = 0
    pair = ex.train_pair(DEMO_STEPS, device)
    trained = dict(fa.launches)
    # a step of the 10-layer target 20/10/10 (the remat recompute runs the
    # forward again), of the 2-layer draft 4/2/2
    expected = {"fwd": DEMO_STEPS * (20 + 4), "dkv": DEMO_STEPS * (10 + 2),
                "dq": DEMO_STEPS * (10 + 2)}
    greedy = ex.greedy(*pair, DEMO_STEPS, timed=1)
    detail = greedy["detail"]
    sampled = ex.sample(*pair, DEMO_STEPS, timed=1)
    bad_sweep = {g: r for g, r in sampled["detail"]["per_gamma"].items()
                 if not (0.0 <= r["accept_rate"] <= (g - 1) / g
                         and r["rounds_for_256"] >= math.ceil(
                             (ex.NEW - 1) / g))}
    res = {"phase": "speculative_demo", "greedy": greedy, "sample": sampled,
           "train_flash_launches": trained,
           "expected_train_flash_launches": expected, "nvidia_smi": smi}
    emit(res)
    if trained != expected:
        raise RuntimeError(f"demo training launched {trained} flash "
                           f"kernels, expected {expected}")
    if bad_sweep:
        raise RuntimeError(f"demo --sample: acceptance or rounds out of "
                           f"their range at {bad_sweep}")
    if (detail["teacher_forced_argmax_share"] < SPEC_MIN_FORCED
            or detail["teacher_forced_max_gap_rel"] > SPEC_GAP_TOL):
        raise RuntimeError(
            f"demo: speculative tokens are not the target's greedy choice: "
            f"argmax share {detail['teacher_forced_argmax_share']} (limit "
            f"{SPEC_MIN_FORCED}), worst gap "
            f"{detail['teacher_forced_max_gap_rel']} (limit {SPEC_GAP_TOL})")
    return res


def entry_phase(device, smi: str) -> dict:
    """kubeflow_tpu_torch/entry.py:entry(): LLAMA2_350M at max_seq_len 512
    on (2, 512) tokens of ones; its forward must launch the flash forward
    exactly 24 times (one a layer, head dim 64) and nothing else, and its
    logits (and those of random tokens) must match the einsum path's
    (attention_impl "xla", the same weights): cross-entropy against the
    next tokens within the train phase's 1e-3 relative and logits cosine
    >= 0.99."""
    import torch
    import torch.nn.functional as F

    from kubeflow_tpu_torch.entry import entry
    from kubeflow_tpu_torch.models.transformer import Transformer
    from kubeflow_tpu_torch.ops import flash_attention as fa

    forward, (model, tokens) = entry()
    forward(model, tokens)                                # warm-up
    for key in fa.launches:
        fa.launches[key] = 0
    (logits, ms) = event_timed(lambda: forward(model, tokens))
    launches = dict(fa.launches)
    plain = Transformer(model.cfg.with_(attention_impl="xla"), device)
    plain.load_state_dict(model.state_dict())
    gen = torch.Generator(device=device).manual_seed(SEED + 40)
    randoms = torch.randint(0, model.cfg.vocab_size, tokens.shape,
                            generator=gen, device=device)
    compare = {}
    for name, toks in (("ones", tokens), ("random", randoms)):
        got = logits if name == "ones" else forward(model, toks)
        want = forward(plain, toks)
        ce = [F.cross_entropy(x[:, :-1].flatten(0, 1), toks[:, 1:].flatten())
              .item() for x in (got, want)]
        compare[name] = {
            "loss_rel_err": abs(ce[0] - ce[1]) / abs(ce[1]),
            "logits_cosine": F.cosine_similarity(
                got.flatten(), want.flatten(), dim=0).item(),
            "max_abs_err": (got - want).abs().max().item(),
            "finite": bool(torch.isfinite(got).all().item())}
    del model, plain, logits
    torch.cuda.empty_cache()
    expected = {"fwd": 24, "dkv": 0, "dq": 0}
    res = {"phase": "entry", "model": "llama2-350m", "shape": [2, 512],
           "forward_ms": ms, "flash_launches": launches,
           "expected_flash_launches": expected, "vs_einsum": compare,
           "nvidia_smi": smi}
    emit(res)
    if launches != expected:
        raise RuntimeError(f"entry() launched {launches} flash kernels, "
                           f"expected {expected}")
    bad = {k: v for k, v in compare.items()
           if not (v["finite"] and v["loss_rel_err"] <= TRAIN_LOSS_TOL
                   and v["logits_cosine"] >= TRAIN_MIN_COSINE)}
    if bad:
        raise RuntimeError(f"entry(): flash path against the einsum path "
                           f"{bad} (limits: loss {TRAIN_LOSS_TOL} relative, "
                           f"cosine {TRAIN_MIN_COSINE})")
    return res


def serve_model_phase(smi: str) -> dict:
    """`python -m kubeflow_tpu_torch.examples.serve_model` on the card:
    TINY trained 5 steps, then plain decode (graphed), int8 decode
    (token agreement > 0.8), greedy speculative equal to plain greedy,
    and speculative sampling; the example must return 0 and print
    RESULT: OK last."""
    from kubeflow_tpu_torch.examples import serve_model

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve_model.main([])
    lines = out.getvalue().strip().splitlines()
    res = {"phase": "serve_model", "rc": rc, "lines": lines,
           "nvidia_smi": smi}
    emit(res)
    if rc != 0 or not lines or lines[-1] != "RESULT: OK":
        raise RuntimeError(f"serve_model on the card: rc {rc}, last line "
                           f"{lines[-1:]}")
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


def _nccl_probe_rank(rank: int, port: int, queue) -> None:
    """One of two ranks on card 0: an NCCL all-reduce, and what came of
    it.  The process ends without tearing NCCL down."""
    import os

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    try:
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=2)
        t = torch.ones(1, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        said = f"ran: the all-reduce gave {t.item()}"
    except Exception as exc:  # what NCCL says is what the probe records
        said = f"{type(exc).__name__}: {exc}"
    queue.put((rank, said))
    queue.close()
    queue.join_thread()
    os._exit(0)


def nccl_probe() -> dict:
    """Whether NCCL takes two ranks on the one card: {rank: what it
    said}, "no answer" from a rank that neither failed nor finished in
    180 s."""
    import multiprocessing
    import queue as queues

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_nccl_probe_rank, args=(rank, port, results))
             for rank in range(2)]
    for p in procs:
        p.start()
    said = {}
    deadline = time.monotonic() + 180
    try:
        while len(said) < 2 and time.monotonic() < deadline:
            try:
                rank, text = results.get(timeout=max(
                    0.1, deadline - time.monotonic()))
            except queues.Empty:
                break
            said[rank] = text
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return {rank: said.get(rank, "no answer") for rank in range(2)}


def _pipeline_rank(reference_path: str, batch: dict) -> list:
    """One pipeline stage of BENCH_CHIP on card 0, in a gloo world of
    PIPE_STAGES processes: per schedule, the kernel-path gradients against
    the unsharded ones at `reference_path`, the flash launches, step
    times and, at PIPE_MEMORY_MICRO microbatches, the peak memory of the
    schedule alone and of the whole step.  Every rank's report, ordered
    by stage."""
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.models import train
    from kubeflow_tpu_torch.models.configs import BENCH_CHIP
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.parallel import pipeline
    from kubeflow_tpu_torch.parallel.mesh import (
        MeshConfig,
        axis_group,
        make_mesh,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    mesh = make_mesh(MeshConfig(pipeline=PIPE_STAGES), device="cuda")
    stage = mesh.get_local_rank("pipeline")
    want = torch.load(reference_path, mmap=True, weights_only=True)
    batch = {k: v.to(device) for k, v in batch.items()}
    mine = {"stage": stage, "backend": dist.get_backend(),
            "transport": pipeline.transport(axis_group(mesh, "pipeline"),
                                            device)}
    for schedule in train.SCHEDULES:
        run = train.setup_training(
            BENCH_CHIP, mesh, device=device, seed=SEED,
            optimizer=train.SGD(0.05), pipeline_microbatches=PIPE_MICRO,
            pipeline_schedule=schedule)
        names = [n for n, p in run.model.named_parameters()
                 if p.requires_grad]
        for key in fa.launches:
            fa.launches[key] = 0
        metrics, _, grads, norm = train.mesh_loss_and_grads(
            run.model, batch, PIPE_MICRO, schedule)
        launches = dict(fa.launches)
        cosines = {n: torch.nn.functional.cosine_similarity(
            g.flatten().float(), want[n].to(device).flatten(), dim=0).item()
            for n, g in zip(names, grads)}
        del grads
        steps_s = []
        for _ in range(PIPE_TIMED_STEPS + 1):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            _, step_metrics = run.train_step(run.state, batch)
            float(step_metrics["loss"])
            torch.cuda.synchronize()
            steps_s.append(time.perf_counter() - t0)
        # the schedule's peak (forward and backward of the stage), then
        # the whole step's (with the gradients' all-reduces and norm)
        peaks = []
        for whole_step in (False, True):
            torch.cuda.empty_cache()
            dist.barrier()
            torch.cuda.reset_peak_memory_stats()
            if whole_step:
                train.mesh_loss_and_grads(run.model, batch,
                                          PIPE_MEMORY_MICRO, schedule)
            else:
                train.pipeline_backward(run.model, batch, PIPE_MEMORY_MICRO,
                                        schedule)
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
            run.model.zero_grad(set_to_none=True)
        del run
        torch.cuda.empty_cache()
        mine[schedule] = {
            "loss": metrics["loss"].item(), "grad_norm": norm.item(),
            "cosines": cosines, "flash_launches": launches,
            "step_times_s": steps_s[1:], "first_step_s": steps_s[0],
            "schedule_peak_bytes": peaks[0], "step_peak_bytes": peaks[1]}
    reports = [None] * dist.get_world_size()
    dist.all_gather_object(reports, mine)
    return sorted(reports, key=lambda r: r["stage"])


def pipeline_train_phase(device, smi: str) -> dict:
    """BENCH_CHIP at full width and depth in PIPE_STAGES pipeline stages
    under GPipe and 1F1B: one process a stage on the one card, over
    gloo, held to the unsharded kernel path."""
    import tempfile

    import torch

    from kubeflow_tpu_torch import dryrun
    from kubeflow_tpu_torch.models import train
    from kubeflow_tpu_torch.models.configs import BENCH_CHIP

    phase_t0 = time.perf_counter()
    cfg, seq = BENCH_CHIP, BENCH_CHIP.max_seq_len
    nccl = nccl_probe()
    per_step = {"fwd": 2 * cfg.num_layers, "dkv": cfg.num_layers,
                "dq": cfg.num_layers}
    expected = {k: PIPE_MICRO * n for k, n in per_step.items()}
    small = _batch(cfg.vocab_size, COMPARE_BATCH, seq, SEED + 1, device)
    single = train.setup_training(cfg, device=device, seed=SEED,
                                  optimizer=train.SGD(0.05))
    names = [n for n, p in single.model.named_parameters()
             if p.requires_grad]
    loss_s, grads_s = _loss_and_grads(single.model, small)
    loss_s, norm_s = loss_s.item(), train.global_norm(grads_s).item()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "single_grads.pt")
        torch.save({n: g.float().cpu() for n, g in zip(names, grads_s)},
                   path)
        del single, grads_s
        torch.cuda.empty_cache()
        reports = dryrun.launch(
            PIPE_STAGES, _pipeline_rank,
            (path, {k: v.cpu() for k, v in small.items()}),
            timeout=PIPE_TIMEOUT_S)
    schedules = {}
    for schedule in train.SCHEDULES:
        runs = [r[schedule] for r in reports]
        cosines = {}
        for r in runs:
            cosines.update(r["cosines"])
        worst = min(cosines, key=cosines.get)
        launches = {k: sum(r["flash_launches"][k] for r in runs)
                    for k in expected}
        loss_p, norm_p = runs[-1]["loss"], runs[-1]["grad_norm"]
        schedules[schedule] = {
            "loss_pipeline": loss_p, "loss_single": loss_s,
            "loss_rel_err": abs(loss_p - loss_s) / abs(loss_s),
            "loss_by_stage": [r["loss"] for r in runs],
            "grad_norm_pipeline": norm_p, "grad_norm_single": norm_s,
            "grad_norm_rel_err": abs(norm_p - norm_s) / norm_s,
            "params_compared": len(cosines),
            "min_grad_cosine": cosines[worst],
            "min_grad_cosine_param": worst,
            "flash_launches": launches, "expected_launches": expected,
            "flash_launches_by_stage": [r["flash_launches"] for r in runs],
            "schedule_peak_bytes_by_stage": [r["schedule_peak_bytes"]
                                             for r in runs],
            "step_peak_bytes_by_stage": [r["step_peak_bytes"]
                                         for r in runs],
            "step_time_s_by_stage": [statistics.median(r["step_times_s"])
                                     for r in runs],
            "first_step_s_by_stage": [r["first_step_s"] for r in runs],
        }
    res = {
        "phase": "pipeline_train", "model": "bench-chip",
        "layers": cfg.num_layers, "stages": PIPE_STAGES,
        "layers_per_stage": cfg.num_layers // PIPE_STAGES,
        "backend": reports[0]["backend"],
        "transport": reports[0]["transport"],
        "nccl_two_ranks_one_card": nccl, "batch": COMPARE_BATCH, "seq": seq,
        "microbatches": PIPE_MICRO,
        "memory_microbatches": PIPE_MEMORY_MICRO,
        "schedules": schedules, "nvidia_smi": smi,
        "timing_note": "two stage processes time-sharing one card over "
                       "gloo and host memory: not a multi-GPU speed",
        "phase_s": time.perf_counter() - phase_t0,
    }
    emit(res)
    bad = []
    for schedule, r in schedules.items():
        if r["params_compared"] != len(names):
            bad.append(f"{schedule}: {r['params_compared']} of "
                       f"{len(names)} parameters compared")
        if r["flash_launches"] != expected:
            bad.append(f"{schedule} launched the flash kernels "
                       f"{r['flash_launches']} times, expected {expected}")
        if (r["loss_rel_err"] > TRAIN_LOSS_TOL
                or r["grad_norm_rel_err"] > TRAIN_NORM_TOL
                or r["min_grad_cosine"] < TRAIN_MIN_COSINE):
            bad.append(
                f"{schedule} and the unsharded kernel path disagree: loss "
                f"rel {r['loss_rel_err']} (limit {TRAIN_LOSS_TOL}), grad "
                f"norm rel {r['grad_norm_rel_err']} (limit "
                f"{TRAIN_NORM_TOL}), gradient cosine of "
                f"{r['min_grad_cosine_param']} {r['min_grad_cosine']} "
                f"(limit {TRAIN_MIN_COSINE})")
        if not all(math.isfinite(x) for x in r["step_time_s_by_stage"]
                   + r["loss_by_stage"]):
            bad.append(f"{schedule}: a loss or step time was not finite")
    gpipe_peak = schedules["gpipe"]["schedule_peak_bytes_by_stage"][0]
    f1b_peak = schedules["1f1b"]["schedule_peak_bytes_by_stage"][0]
    if not f1b_peak < gpipe_peak:
        bad.append(f"stage 0's 1F1B schedule peak {f1b_peak} B is not "
                   f"below its GPipe peak {gpipe_peak} B")
    if bad:
        raise RuntimeError("pipeline_train: " + "; ".join(bad))
    return res


def _corpus(vocab: int, seed: int):
    """Seeded ascending token runs (the example's corpus), so the loss can
    fall: NB_RUNS runs of 16 tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    starts = rng.integers(0, vocab - 64, size=NB_RUNS)
    return np.concatenate([np.arange(s, s + 16) % vocab for s in starts])


def _nb_steps(setup, pipe, want: list, hook=None, before_hook=None,
              agent=None) -> dict:
    """Drive `setup` over `pipe` as a notebook loop does: each step's flash
    launches (counts reset before it), whether the batch the step takes
    equals `want`'s numpy batch (compared on the step's stream, before
    it), the loss read on the host, then the agent's boundary and
    `hook(step, train_state_dict)`; stops when the hook fires."""
    import numpy as np
    import torch

    from kubeflow_tpu_torch.models import train
    from kubeflow_tpu_torch.ops import flash_attention as fa

    device = next(setup.model.parameters()).device
    expect = [{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in b.items()} for b in want]
    state, out = setup.state, {"losses": [], "launches": [], "same": [],
                               "hook": []}
    if agent is not None:
        agent.step_boundary()
    for ref, batch in zip(expect, pipe):
        same = torch.stack([(batch[k] == ref[k]).all() for k in ref]).all()
        for key in fa.launches:
            fa.launches[key] = 0
        state, metrics = setup.train_step(state, batch)
        out["launches"].append(dict(fa.launches))
        out["losses"].append(metrics["loss"].item())
        out["same"].append(same)
        if agent is not None:
            agent.step_boundary()
        if hook is not None:
            if before_hook is not None:
                before_hook(state.step)
            t0 = time.perf_counter()
            fired = hook(state.step, train.train_state_dict(state))
            out["hook"].append(fired)
            if fired:
                out["hook_s"] = time.perf_counter() - t0
                break
    out["same"] = bool(torch.stack(out["same"]).all().item())
    return out


def notebook_train_phase(device, device_name, smi: str) -> dict:
    """BENCH_CHIP at full width and depth, batch 8, through the in-notebook
    runtime (input_pipeline, TelemetryAgent, checkpoint_on_cull,
    CheckpointManager, the dcp backend on a world-1 NCCL mesh) and the
    example as a subprocess; see the module docstring."""
    import itertools
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.models import train
    from kubeflow_tpu_torch.models.configs import BENCH_CHIP
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from kubeflow_tpu_torch.runtime import checkpoint as ckpt
    from kubeflow_tpu_torch.runtime.data import TokenBatches, input_pipeline
    from kubeflow_tpu_torch.runtime.telemetry import (
        TelemetryAgent,
        annotation_payload,
        parse_annotation,
    )

    phase_t0 = time.perf_counter()
    cfg, seq = BENCH_CHIP, BENCH_CHIP.max_seq_len
    expected = {"fwd": 2 * cfg.num_layers, "dkv": cfg.num_layers,
                "dq": cfg.num_layers}
    tokens = _corpus(cfg.vocab_size, SEED + 20)
    want = list(itertools.islice(TokenBatches(tokens, NB_BATCH, seq,
                                              seed=SEED), NB_STEPS))

    def setup(seed, mesh=None):
        return train.setup_training(
            cfg, mesh, device=device, seed=seed,
            optimizer=train.default_optimizer(warmup_steps=2,
                                              mu_dtype="bfloat16"))

    def pipeline():
        return input_pipeline(tokens, NB_BATCH, seq, seed=SEED, prefetch=2,
                              device=device)

    def clone_params(s):
        return {n: train.local_tensor(p).detach().clone()
                for n, p in s.model.named_parameters()}

    # run A: 12 steps through the pipeline with a telemetry agent
    run_a = setup(SEED)
    agent = TelemetryAgent(config=cfg, batch=NB_BATCH, seq_len=seq,
                           num_chips=1, accelerator=device_name,
                           worker="chip-smoke")
    pipe = pipeline()
    a = _nb_steps(run_a, pipe, want, agent=agent)
    pipe.close()
    final_a = clone_params(run_a)
    summary = agent.summary()
    round_trip = parse_annotation(annotation_payload(summary))
    a_step_s = statistics.median(s["step_time_s"]
                                 for s in agent.samples()[1:])
    # the same setup on one resident batch: the loader's cost is the gap
    resident = {k: v.clone() for k, v in _batch(cfg.vocab_size, NB_BATCH,
                                                 seq, SEED + 21,
                                                 device).items()}
    resident_s = train.timed_steps(run_a, resident, num_steps=3,
                                   warmup=1)["step_time_s"]
    del run_a, resident
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        free_gb = shutil.disk_usage(tmp).free / 1e9
        # run B: the same seed; the request file appears before step 6's
        # hook, which saves through the local backend and acknowledges
        signals = tmp / "podinfo"
        signals.mkdir()
        local = ckpt.CheckpointManager(str(tmp / "local"), backend="local")
        hook = ckpt.checkpoint_on_cull(local,
                                       ckpt.CullSignalWatcher(str(signals)))

        def cull_request(step):
            if step == NB_CULL_STEP:
                (signals / ckpt.REQUEST_FILE).write_text("true")

        run_b = setup(SEED)
        pipe = pipeline()
        b = _nb_steps(run_b, pipe, want, hook=hook, before_hook=cull_request)
        pipe.close()
        acked = (signals / ckpt.ACK_FILE).exists()
        path = local._step_path(NB_CULL_STEP)
        ckpt_bytes = path.stat().st_size
        del run_b
        torch.cuda.empty_cache()

        # a torn newer step and a leftover temp file: the restore must
        # return step 6 and delete both
        torn = local._step_path(NB_CULL_STEP + 1)
        with open(path, "rb") as src, open(torn, "wb") as dst:
            dst.write(src.read(min(64 << 20, ckpt_bytes // 2)))
        leftover = local.directory / f".tmp-step_{NB_CULL_STEP + 2}.ckpt-1"
        leftover.write_bytes(b"partial")
        latest_before = local.latest_step()

        # resume: a fresh setup from another seed restores step 6 and runs
        # the pipeline's batches 7-12
        resumed = setup(SEED + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        manager = ckpt.CheckpointManager(str(tmp / "local"),
                                         backend="local")
        restored = manager.restore(train.train_state_dict(resumed.state))
        train.load_train_state(resumed.state, restored)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del restored
        torn_gone = not torn.exists() and not leftover.exists()
        restored_step = resumed.state.step
        pipe = pipeline()
        r = _nb_steps(resumed, itertools.islice(pipe, NB_CULL_STEP, None),
                      want[NB_CULL_STEP:])
        pipe.close()
        final_r = clone_params(resumed)
        params_equal = all(torch.equal(final_a[n], final_r[n])
                           for n in final_a)
        del resumed, final_a, final_r
        shutil.rmtree(tmp / "local")
        torch.cuda.empty_cache()

        # dcp: one save and restore of the mesh setup at world size 1 on
        # NCCL; a fresh mesh setup resumes it for 2 steps against the
        # uninterrupted mesh run
        dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                                f"{_free_port()}", rank=0, world_size=1)
        try:
            mesh = make_mesh(MeshConfig(), device="cuda")
            sharded = setup(SEED, mesh)
            dcp_batches = [{k: torch.from_numpy(v).to(device)
                            for k, v in w.items()} for w in want[:4]]
            for batch in dcp_batches[:2]:
                sharded.train_step(sharded.state, batch)
            manager_dcp = ckpt.CheckpointManager(str(tmp / "dcp"),
                                                 backend="dcp")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            manager_dcp.save(2, train.train_state_dict(sharded.state))
            dcp_save_s = time.perf_counter() - t0
            dcp_bytes = sum(f.stat().st_size for f in
                            (tmp / "dcp").rglob("*") if f.is_file())
            straight = [sharded.train_step(sharded.state, batch)[1]["loss"]
                        .item() for batch in dcp_batches[2:]]
            final_m = clone_params(sharded)
            del sharded
            torch.cuda.empty_cache()
            fresh = setup(SEED + 1, mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            like = train.train_state_dict(fresh.state)
            manager_dcp.restore(like)
            train.load_train_state(fresh.state, like)
            torch.cuda.synchronize()
            dcp_restore_s = time.perf_counter() - t0
            dcp_step = fresh.state.step
            again = [fresh.train_step(fresh.state, batch)[1]["loss"].item()
                     for batch in dcp_batches[2:]]
            final_f = clone_params(fresh)
            dcp_params_equal = all(torch.equal(final_m[n], final_f[n])
                                   for n in final_m)
            del fresh, final_m, final_f, like, dcp_batches
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()

    # the example, as a user runs it
    t0 = time.perf_counter()
    example = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.examples.train_llm"],
        cwd=ROOT, capture_output=True, text=True, timeout=NB_EXAMPLE_TIMEOUT_S)
    example_s = time.perf_counter() - t0
    example_ok = (example.returncode == 0
                  and "RESULT: OK" in example.stdout.splitlines())

    gb = ckpt_bytes / 1e9
    b_launches = b["launches"]
    res = {
        "phase": "notebook_train", "model": "bench-chip",
        "layers": cfg.num_layers, "batch": NB_BATCH, "seq": seq,
        "steps": NB_STEPS, "cull_step": NB_CULL_STEP, "nvidia_smi": smi,
        "flash_launches_per_step": a["launches"][0],
        "expected_launches": expected,
        "batches_bit_equal": {"run_a": a["same"], "run_b": b["same"],
                              "resumed": r["same"]},
        "losses_run_a": a["losses"], "losses_run_b": b["losses"],
        "losses_resumed": r["losses"],
        "resume_losses_bit_identical": r["losses"] == a["losses"][
            NB_CULL_STEP:],
        "resume_params_bit_identical": params_equal,
        "restored_step": restored_step,
        "hook_fired": b["hook"], "ack_written": acked,
        "torn_latest_before_restore": latest_before,
        "torn_and_temp_deleted": torn_gone,
        "checkpoint_bytes": ckpt_bytes, "checkpoint_gb": gb,
        "save_s": b.get("hook_s"),
        "save_gb_s": gb / b["hook_s"] if b.get("hook_s") else None,
        "restore_s": restore_s, "restore_gb_s": gb / restore_s,
        "tmp_free_gb": free_gb,
        "run_a_step_s": a_step_s, "resident_step_s": resident_s,
        "loader_cost_s": a_step_s - resident_s,
        "run_a_step_times_s": [s["step_time_s"] for s in agent.samples()],
        "telemetry_summary": summary,
        "telemetry_round_trip": round_trip == summary,
        "dcp_bytes": dcp_bytes,
        "dcp_save_s": dcp_save_s, "dcp_restore_s": dcp_restore_s,
        "dcp_restored_step": dcp_step,
        "dcp_losses_straight": straight, "dcp_losses_resumed": again,
        "dcp_params_bit_identical": dcp_params_equal,
        "example_returncode": example.returncode, "example_s": example_s,
        "example_tail": example.stdout.splitlines()[-4:],
        "phase_s": time.perf_counter() - phase_t0,
    }
    emit(res)
    print(f"notebook_train: checkpoint {ckpt_bytes} bytes ({gb:.3f} GB), "
          f"save {res['save_s']:.3f} s ({res['save_gb_s']:.3f} GB/s), "
          f"restore {restore_s:.3f} s ({res['restore_gb_s']:.3f} GB/s); "
          f"run A {a_step_s:.4f} s a step against {resident_s:.4f} s on a "
          f"resident batch; {smi}", flush=True)
    print(f"notebook_train telemetry: {annotation_payload(summary)}",
          flush=True)
    if not example_ok:
        raise RuntimeError(f"the example failed ({example.returncode}):\n"
                           f"{example.stdout[-2000:]}{example.stderr[-4000:]}")
    bad_launches = [i for i, n in enumerate(a["launches"] + b_launches)
                    if n != expected]
    if (bad_launches or len(a["launches"]) != NB_STEPS
            or len(b_launches) != NB_CULL_STEP):
        raise RuntimeError(f"runs A and B: steps {bad_launches} launched "
                           f"the flash kernels other than {expected} times, "
                           f"or a run took another number of steps")
    if not (a["same"] and b["same"] and r["same"]):
        raise RuntimeError("a device batch differs from its TokenBatches "
                           "batch")
    if not (b["hook"] == [False] * (NB_CULL_STEP - 1) + [True] and acked
            and restored_step == NB_CULL_STEP):
        raise RuntimeError(f"the cull hook fired {b['hook']}, ack "
                           f"{acked}, restored step {restored_step}")
    if not (latest_before == NB_CULL_STEP + 1 and torn_gone):
        raise RuntimeError("the torn step or the temp file survived the "
                           "restore")
    if not (res["resume_losses_bit_identical"] and params_equal):
        raise RuntimeError("the resumed run differs from the uninterrupted "
                           "one")
    if not (straight == again and dcp_params_equal and dcp_step == 2):
        raise RuntimeError("the dcp round did not resume bit for bit")
    if not (res["telemetry_round_trip"] and isinstance(summary["mfu"], float)
            and all(math.isfinite(x) for x in a["losses"])
            and a["losses"][-1] < a["losses"][0]):
        raise RuntimeError(f"telemetry or losses wrong: {summary}, "
                           f"{a['losses']}")
    return res


def flash_kernel_lines(flash_results, launches: dict, moe_launches: dict,
                       mesh_launches: dict, gemma_launches: dict,
                       long_context: dict, pipeline_steps: dict,
                       runtime_loop_launches: dict, entry_launches: dict,
                       demo_launches: dict) -> list:
    """The kernels line's flash entries.  Head dims 64 and 128: the
    training-shape medians times the BENCH_CHIP step's launches, and beside
    them the launches of one BENCH_MOE step, one sharded (mesh) BENCH_CHIP
    step, one pipelined step of each schedule (both stages), one step
    of each long-context mode, one step of the runtime loop
    (notebook_train), one entry() forward (head dim 64) and the speculative
    demo's training (both models, every step).  Head dim 256 (entries named
    *_d256): the Gemma-shape medians times the Gemma step's launches."""
    entries = []
    for name, key in (("flash_fwd", "fwd"), ("flash_bwd_dkv", "dkv"),
                      ("flash_bwd_dq", "dq")):
        for d256 in (False, True):
            case = GEMMA_CASE if d256 else TRAIN_CASE
            r = flash_results[case][name]
            n = (gemma_launches if d256 else launches)[key]
            entry = {
                "name": name + ("_d256" if d256 else ""), "route": "cuda",
                "source": "kubeflow_tpu_torch/csrc/flash_attention.cu",
                "replaces": FLASH_REPLACES[name], "launches": n,
                "max_abs_err": max(
                    flash_results[c][name]["max_abs_err"]
                    for c in flash_results if (c[4] == 256) == d256),
                "ms": r["ms"] * n, "plain_ms": r["plain_ms"] * n,
                "bound_ms": (None if r["bound_ms"] is None
                             else r["bound_ms"] * n),
                "bound_by": r["bound_by"],
                "library_ms": (None if r["library_ms"] is None
                               else r["library_ms"] * n),
                "library_call": r["library_call"],
                **{k: r[k] for k in ("library_covers", "library_covered_by")
                   if k in r},
                "ms_per_launch": r["ms"], "shape": list(case[:5]),
            }
            if d256:
                entry.update(
                    head_dim=256, main_path="gemma_train",
                    basis="per-launch medians at the Gemma training shape "
                          "times one gemma_train step's launches")
            else:
                entry.update(
                    head_dim=[64, 128], main_path="train",
                    moe_step_launches=moe_launches[key],
                    mesh_step_launches=mesh_launches[key],
                    pipeline_step_launches={
                        schedule: res["flash_launches"][key]
                        for schedule, res in pipeline_steps.items()},
                    long_context_step_launches={
                        str(seq): res["flash_launches"][key]
                        for seq, res in long_context.items()},
                    runtime_loop_step_launches=runtime_loop_launches[key],
                    entry_forward_launches=entry_launches[key],
                    speculative_demo_train_launches=demo_launches[key],
                    basis="per-launch medians at the training shape times "
                          "one training step's launches")
            entries.append(entry)
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

    times = {"build": build_s}

    def timed(name, fn, *args):
        """fn(*args), its wall seconds kept under `name`."""
        t = time.perf_counter()
        out = fn(*args)
        times[name] = time.perf_counter() - t
        return out

    gen = torch.Generator(device=device).manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=device)
    peak = GPU_PEAKS.get(device_name)
    # the edge shapes draw from their own generator, so the slice draws
    # the same weights from gen as before
    results = timed(
        "kernel", kernel_phase,
        gen, torch.Generator(device=device).manual_seed(SEED + 2),
        torch.Generator(device=device).manual_seed(SEED + 3),
        torch.Generator(device=device).manual_seed(SEED + 16),
        torch.Generator(device=device).manual_seed(SEED + 18), device,
        peak, flush)
    # its own generators, so the slice draws the same weights as before
    flash_results = timed(
        "flash", flash_phase,
        torch.Generator(device=device).manual_seed(SEED + 1),
        torch.Generator(device=device).manual_seed(SEED + 15),
        torch.Generator(device=device).manual_seed(SEED + 10),
        torch.Generator(device=device).manual_seed(SEED + 17), device, peak,
        flush)
    sl, model = timed("slice", slice_phase, gen, device, device_name)
    sp = timed("speculative", speculative_phase, model, device)
    tp = timed("tp_decode", tp_decode_phase, model, device, smi)
    del model
    torch.cuda.empty_cache()
    l13 = timed("llama13b", llama13b_phase, device, smi)
    db = timed("decode_bench", decode_bench_phase, device, smi)
    tr = timed("train", train_phase, device, device_name, flash_results,
               flush)
    gemma = timed("gemma_train", gemma_train_phase, device, device_name,
                  smi, flash_results, flush)
    del flush
    long_context = timed("long_context", long_context_phase, device)
    mt = timed("moe_train", moe_train_phase, device, device_name)
    timed("moe_serve", moe_serve_phase, device)
    mesh = timed("mesh_train", mesh_train_phase, device, smi,
                 tr["step_time_s"])
    pipe = timed("pipeline_train", pipeline_train_phase, device, smi)
    notebook = timed("notebook_train", notebook_train_phase, device,
                     device_name, smi)
    demo = timed("speculative_demo", speculative_demo_phase, device, smi)
    timed("vit", vit_phase, device, smi)
    ent = timed("entry", entry_phase, device, smi)
    timed("serve_model", serve_model_phase, smi)
    emit({"phase_seconds": times, "since_start_s": time.perf_counter() - t0})

    totals = main_path_totals(results, sl["int4_launches"])
    emit({"kernels": [{
        "name": "int4_matmul", "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "kubeflow_tpu/ops/int4_matmul.py:87",
        "launches": sl["int4_launches"],
        "speculative_launches": sp["int4_launches"],
        "speculative_graphed_launches": sp["int4_launches"],
        "speculative_rounds": sp["rounds"],
        "tp_decode_world1_launches": tp["world1"]["int4_launches"],
        "tp_decode_tensor2_launches_per_rank":
            tp["tensor2"]["int4_launches_per_rank"],
        "decode_bench_int4_launches": db["int4"]["launches"]["int4_matmul"],
        "decode_bench_int4_calls": db["int4"]["generate_calls"],
        "llama13b_launches": l13["int4_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in results.values()),
        "max_rel_err": max(r["max_rel_err"] for r in results.values()),
        **totals, "library_call": "torch._weight_int4pack_mm",
        "basis": "ms, plain_ms, bound_ms and library_ms sum the per-shape "
                 "medians over the main path's launches; decode_step, "
                 "prefill and speculative_round over one decode step's, "
                 "one prefill's and one speculative round's",
    }] + flash_kernel_lines(flash_results, tr["flash_launches"],
                            mt["flash_launches"], mesh["flash_launches"],
                            gemma["flash_launches"], long_context,
                            pipe["schedules"],
                            notebook["flash_launches_per_step"],
                            ent["flash_launches"],
                            demo["train_flash_launches"])})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
