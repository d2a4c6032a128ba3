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
   over the emitted tokens must pick >= 0.8 of them.  The int8 model
   also decodes through `generate(mesh=)` on a world-1 NCCL mesh (the
   tree converted on the mesh, the step captured with its collectives),
   TP_NEW new tokens, bit-equal to its single-device `generate`;
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
   The machine has one card, so two processes ask NCCL for an
   all-reduce on it and what it says is printed (they start before the
   build and are collected after it, so their start-up overlaps nvcc and
   no other phase runs beside them); the stages then run as
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
   ascending token runs, in the pod the port's controller makes for this
   card (`NotebookController`): `kubeflow_tpu_torch.main.build_manager`
   (the notebook controller, the gang scheduler with its tenancy layer
   and the culler, on a FakeClock, the Jupyter kernel reported idle)
   over the in-memory cluster, one node in node pool card-pool labelled
   by gpu/device_plugin.py's label_gpu_node with this card's accelerator
   (gpu/topology.py) and torch.cuda.device_count() nvidia.com/gpu, and
   a Notebook CR with spec.gpu {that accelerator, 1}, spec.priority low,
   notebooks.opendatahub.io/inject-auth "true" and a checkpoint store.
   The manager runs the ODH plane too (odh/: the mutating and validating
   webhooks in the apiserver's admission chain, the ODH reconciler, the
   TLS profile watcher), with its controller namespace set here, and the
   CR's namespace holds an odh-trusted-ca-bundle ConfigMap of one PEM.
   The webhook stamps the reconciliation lock on create; the ODH
   reconciler makes the notebook's HTTPRoute in the controller namespace
   (to the kube-rbac-proxy Service on :8443), the ReferenceGrant, the
   ServiceAccount (whose pull secret the fake cluster mints), the
   ClusterRoleBinding, the proxy's Service and ConfigMap, the three
   NetworkPolicies (the notebook's, the proxy's, the GPU workers') and
   the workbench-trusted-ca-bundle from the PEM, and lifts the lock.
   Gates: the lock stamped, then lifted before the StatefulSet asks for
   a pod; each object there and owned as the reference owns it (the
   namespaced ones by the CR; the route, the grant, the binding and the
   bundle by none); the pod's kube-rbac-proxy sidecar and
   ServiceAccount; and, the bundle being built in the reconcile that
   lifted the lock, the webhook's restart blocking holding it back from
   the first pod (update-pending names its env).  The scheduler places
   the gang on the card's pool as a bypass claim (unmanaged capacity)
   before its StatefulSet asks for a pod.  Gates: the Notebook update
   carrying the placement intent before the first StatefulSet event of
   1 replica on the apiserver's stream, the
   StatefulSet's nodeSelector naming the pool,
   notebook_warmpool_hits_total{bypass} 1, one StatefulSet of 1
   replica, one pod bound to the node, nvidia.com/gpu 1 used of the
   node's count, "1" in the pod's requests and limits, the table's peak
   GPU_PEAKS', sliceHealth Unhealthy until the pod is marked running
   and Healthy after.  The
   main container's env is resolved as the kubelet would from the pod
   the cluster made (its pod-index label among it; the master's DNS name
   as 127.0.0.1, its rendered port 29500 as a free one, each volume
   mount a directory under the phase's temporary directory), and the
   resources, nodeSelector and env names are printed.  Run A: 12 steps
   through input_pipeline (prefetch 2, pinned copies on a side stream)
   with a TelemetryAgent, one boundary a step after the host read of
   the loss.  Run B, the same seed: before step 6's checkpoint_on_cull
   hook the FakeClock passes the idle limit and the culler stops the
   notebook (gates: the stop annotation, one culling, replicas 0, the
   pod deleted, sliceHealth Stopped, the placement released); the
   deleted pod's rendered preStop
   command runs as a subprocess with its resolved env, as the kubelet
   runs it, and writes its request into the signal directory; the hook
   saves through the local backend and acknowledges, the loop exits and
   the pipeline closes, and the preStop command must exit 0 on the ack
   (its wait from request to ack printed).  The cull's stop let the
   pending update through: removing the stop annotation makes the
   controller recreate the pod, with the same resolved env, preStop
   command and node and now the CA bundle (gates: its volume, mount and
   env, each of SSL_CERT_FILE and its siblings resolved to a file whose
   bytes are the bundle's, no update-pending left), Healthy once
   running; the example's torchrun launch below gets that env; the
   controller's reconciles and wall ms by stage are printed and emitted
   under "controller", and one `odh` line prints the ODH objects made,
   the lock's order, the restarted pod's sidecar and CA bundle, the
   replicated pods' and the promoted Services' selectors, each
   controller's reconciles and the ODH webhooks' admissions with their
   wall ms, and the card's name and power limit (emitted under "odh").
   A truncated copy of the
   checkpoint as step 7 and a leftover temp file are planted; a fresh
   setup from another seed restores (step 6, both deleted) and runs the
   pipeline's batches 7-12.  Then three drills on the same pod, the
   kernel reported busy: the self-healing engine's two and a
   preemption.  Drill 1, a voluntary
   migration: a run from run A's seed takes steps 1-4, its serialized
   train state is the gang's session payload, and the migrate annotation
   (drain) makes the engine take a final snapshot into the CR's store,
   write the restore intent into status.sessionState before the pod
   delete (read off the apiserver's event stream), stamp the
   StatefulSet's CHECKPOINT_RESTORE_* env and delete the pod, which the
   cluster recreates on the card's node with the restore stamp; the
   recreated pod's resolved env gives restore_instructions, and
   CheckpointSidecar.restore_payload loads the snapshot into a setup
   from another seed (state bit-equal to the snapshot's), which runs
   steps 5-8 (state bit-equal to run A's at step 8, the AdamW count and
   b1_mu among it).  Drill 2, a dead card: the kubelet fails the pod
   (GPUUnhealthy), the gang answers no final snapshot, and once the
   backoff the first migration armed runs out on the FakeClock the
   engine migrates with drill 1's snapshot; the same setup restores it
   again and runs steps 5-10 (state bit-equal to run A's at step 10).
   Drill 3, a preemption: the live state after step 10 is the gang's
   session payload, and a second CR of the same shape at priority high
   arrives.  The card is the cluster's only GPU and no warm pool is
   configured (cold provisioning an hour of FakeClock away), so the
   scheduler admits it, reserves a cold provision and asks the
   preemption engine, which takes exactly one final snapshot of the
   gang into the CR's store, commits the Pending record to TenantQuota
   before the pod delete, persists the restore intent (trigger
   preempt) and the queued stamp (reason preempted), tears the gang
   down and closes the record (Done); the beneficiary is placed on the
   card, its pod marked running, and it holds the card 60 s of
   FakeClock while the victim reads Queued.  Then it stops: its claim
   drains, the victim is placed again before its StatefulSet exists,
   the StatefulSet carries the restore env and the recreated pod the
   restore stamp; CheckpointSidecar.restore_payload loads the snapshot
   into a setup from a third seed (state bit-equal to run A's at step
   10, the AdamW count and b1_mu among it), which runs steps 11-12
   (parameters bit-equal to run A's).  Gates: losses equal run A's and
   20/10/10 flash launches every step; the restored bytes' digest the
   pod's stamp; one final snapshot before the preemption and one more
   by it; notebook_preemptions_total{evicted,low} 1; no attempt
   charged for the eviction;
   notebook_migrations_total {drain,migrated}, {drain,restored},
   {failure,migrated}, {failure,restored} and {preempt,restored} 1
   each, no fallback;
   notebook_slice_restarts_total{migrate} 1 after drill 1 and 2 after
   drill 2; two attempts charged and no RecoveryExhausted.  Drill 4, the
   promotion (`promotion_drill`): the phase's CR stops, a second GPU
   node joins in its own pool, and a CR of two replicas of the same
   one-card gang (spec.replication {2, antiAffine}) is placed, replica 0
   on the card's node in card-pool and replica 1, by the anti-affinity,
   on the second node; the CR carries inject-auth, and both replicas'
   pods carry the sidecar and the CA bundle from their first start.
   The base is drill 3's bytes, put with writer
   epoch 1 beside the rest of drill 3; two delta records (steps 11 and
   12: the step, the batch's index, the bits of run A's loss) follow
   with epoch 1 and the expected sequence, before the failure.  The
   fake cluster stamps the followers at the chain head; replica 1's
   runtime (this process) replays the chain through a FollowerReplica,
   its digest the chain head's.  Replica 0's card dies: the engine
   records the promotion (promoting) before the flip, raises the
   store's fence to 2 and names replica 1 (epoch 2, primary 1,
   promoted); a zombie write at epoch 1 raises StaleWriterError;
   notebook_promotions_total{promoted} and
   notebook_replication_fenced_writes_total read 1; the plain Service
   and the kube-rbac-proxy Service both select replica 1's gang; no
   migration is charged, nothing to the promoted gang, and the demoted
   gang rejoins as a follower (one pod-failed restart and one attempt
   of gang 0, its failed pod the only one deleted), which the proxy
   Service's write brings forward from the next resync.  The promoted
   runtime restores the
   base part of its verified state into a setup from a fourth seed and
   replays the records on the card: each loss bit-equal to its record's,
   20/10/10 flash launches a step, the final parameters bit-equal to
   run A's.  Put, catch-up, restore and replay seconds and the engine's
   reconciles and wall ms are printed;
   notebook_disruption_recovery_seconds observed once (its FakeClock
   seconds, simulated, printed); the migrate annotation cleared.  The
   cull before it charges no attempt, and the unstopped pod carries no
   restore stamp.  Printed and emitted under "recovery": the snapshot's
   bytes, the serialize and store seconds and GB/s, each restore's
   seconds, the engine's reconciles and wall ms per drill, the
   preemption's serialize, store and restore seconds, the scheduler's
   and engine's own ms and its FakeClock (simulated) queue wait, the
   drills' wall seconds by part, the largest resident set sampled after
   each part and each load, and the process's peak before and after.
   Then one dcp save and restore of the mesh setup on a world-1 NCCL
   group: a fresh mesh setup resumes it for 2 steps against the
   uninterrupted mesh run.  Beside the drills and that round (started
   before the drills, collected after the round), side by side, two
   launches of the example, no
   flag: `python -m torch.distributed.run -m
   kubeflow_tpu_torch.examples.train_llm` with the rendered PET_* env,
   its group formed by distributed_init under torchrun, and the bare
   `python -m kubeflow_tpu_torch.examples.train_llm`, its group formed by
   the example's one-rank fallback; each must print `devices: 1 x <this
   card>` and RESULT: OK.  Gates: exactly 20/10/10 flash
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
   The observability plane runs in the same manager (`build_manager`
   attaches the SLO engine, the data-plane rollup, the lifecycle and
   metering ledgers, the TSDB and the diagnosis engine; its CoreConfig
   sets DATAPLANE_MFU_TARGET 0.5, SLO_FLEET_MFU 0.9 and the continuous
   profiler at 100 ms), with the tracing clock on the manager's FakeClock
   so that span times and the ledgers' are one timeline.  Once the pod
   runs, run A's TelemetryAgent publishes its summary through
   `publish_fn` onto the pod's telemetry annotation (an update through
   the API server, as the worker's sidecar makes it), and one scrape
   follows.  Gates: notebook_dataplane_tokens_per_second, _mfu_ratio and
   _step_time_seconds for the CR equal the summary's tokens_per_s, mfu
   and step_time_s exactly; notebook_dataplane_straggler 0 (one worker is
   below min_workers); notebook_dataplane_mfu_checks_total moved by one
   under "low" if the MFU is below the target, else "ok"; after the cull
   deletes the pod, the next scrape reads 0 for the three gauges and the
   namespace has accrued chip-seconds (FakeClock) in "ready" only.
   Scrapes follow the unstop, each drill's ready and the promotion.  At
   the phase's end: the CR's first start finalized in the lifecycle
   ledger and its conservation, and the metering ledger's, without a
   violation over the whole phase (restarts, migrations, preemption and
   promotion excursions included); the SLO verdicts hold every objective
   of `default_objectives`, fleet_mfu among them, whose bad count is the
   "low" count; `explain` of the replicated CR ranks "primary_failover"
   first with a score of at least 10; the TSDB holds one raw point per
   scrape, its promotions_delta summing to 1 and its
   criticalpath_violations and metering_violations 0; the profiler's
   notebook_profiler_overhead_ratio below 0.05; and the engines' own
   wall time (the scrapes, the evaluations and the profiler's sampling)
   under 2 s.  One `observability` line prints the three gauges beside
   the summary, the top lifecycle stages with their FakeClock
   (simulated) seconds, the namespace's chip-seconds by bucket, the SLO
   verdicts, the first cause of each explained CR, the profiler's
   overhead and top (controller, phase) buckets, the engines' wall ms
   and the card's name and power limit (emitted under "observability").

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
   graph (in range); two timed calls a mode (the bench's own default is
   three);
   tools: the compute tools (kubeflow_tpu_torch/tools/) at their
   smallest real settings, in this process: decode_profile's HBM read
   probe (the best of 4 fp32-accumulated sums over 4 GiB of bf16), the
   three bodies of kv_cache_probe over the BENCH_CHIP decode cache (10
   layers x K, V of [16, 12, 384, 128] bf16) at TOOLS_KV_ITERS
   iterations, each one captured CUDA graph, and one decode_ablate
   window: batch 32 on decode_bench's bf16 model, its step against the
   bench's bf16 step as the baseline.  Gates: every number finite and
   positive; the probe at most 105% of the card's spec rate; each body's
   moved bytes and the ablation's streamed bytes at most 105% of the
   probed rate a second;
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
   RESULT: OK;
18. wire: the real-cluster backend, in a process of its own that starts
   before gemma_train and is collected after it (`wire_step`): a CA and
   a serving pair minted (kube/certs.py), a fresh ApiServer and
   FakeCluster served over TLS by KubeApiWireServer with its audit log
   and the conversion webhook, its node labelled for this card, and
   `python -m kubeflow_tpu_torch.main --kubeconfig ...
   --enable-leader-election` as a separate process whose ODH webhooks
   the ApiServer calls over HTTPS.  notebook_train's CR, made through a
   KubeClient at kubeflow.org/v1beta1, must come back converted, locked
   by the mutating webhook and unlocked by the leader's merge patch, and
   its StatefulSet, pod, Services and ODH objects must equal what
   `build_manager` renders in process from the same CR.  Then, through
   the KubeClient: a stop annotation by merge patch removes the pod; two
   apply managers conflict with a 409 and one forces; a strategic merge
   patch of the StatefulSet's container by name; a JSON patch; a fault
   plan drops the watch streams and resets the history, the manager's
   informers relist through 410 Gone and the un-stop converges; the
   store's audit log holds each verb.  The ten conformance fixtures
   replay against a second TLS wire server, each as its `expect` says.
   The manager's schema hook (api/validation.py, served at
   /notebook-crd-schema) refuses a CR with no containers sent over TLS,
   with the reference's message.  SIGINT stops the manager within 2 s
   with the lease released.  Then, in the same process, the shard step
   (`shard_step`, FakeClock time, no card memory): `build_sharded_fleet`
   of SHARD_COUNT replicas with SLO_SHARD_HANDOFF_P99_S set and an SLO
   engine attached settles this card's CR (`spec.gpu {this card, 1}`, no
   node for it yet) and a dozen CPU notebooks over four namespaces, each
   key claimed by exactly its ring owner; the replica owning the card's
   CR is killed and sub-lease steps age its lease out: the handoff record
   completes with a duration, a survivor adopts the CR, a write through
   the killed replica's FencedApi raises StaleEpochError and is counted
   (`notebook_shard_fenced_writes_total` 1), the card's node arrives and
   the adopter takes the gang to Healthy with the lifecycle ledger's
   handoff_wait above 0, the scrape holds the four notebook_shard_*
   families and the shard_handoff objective is evaluated and met, and no
   two replicas reconciled one key at once; the killed replica rejoins,
   each key has one owner again, one ops/diagnose bundle per replica
   goes through JSON and `merge_records`/`merge_overlaps` find attempts
   and no overlap; the card CR's StatefulSet, pod and Services equal
   those one Manager running the same controllers renders; and
   `python -m kubeflow_tpu_torch.main --serve-api 0`, started beside
   it, serves the port's Notebook CRD at /openapi/v2 with `spec.gpu`
   {accelerator, count}.  Its `shard` line prints the step's seconds, the
   handoff's FakeClock seconds, the fenced writes, the overlaps and the
   bundles' bytes.  Then the fleet step (`fleet_step`): the port's
   convergence benchmark (kubeflow_tpu_torch/loadtest/convergence.py)
   runs 200 gangs of this card's own shape (`spec.gpu {this card, 1}`)
   on one worker and again on eight, held to the `gang` section of
   loadtest/budgets/apiserver_call_budget.json: budget met, the two
   final states identical, zero writes from a converged fleet, zero
   conservation violations; then 200 CPU notebooks over a 3-shard fleet
   with a kill and a rejoin (zero cross-process overlaps, zero
   data-plane writes at steady state, zero conservation violations);
   then the conformance profile without its fixtures (`python -m
   kubeflow_tpu_torch.conformance`'s `run_profile`: the goldens equal,
   and every behaviour check passes against a manager booted with
   `--serve-api 0 --fake-gpu-nodes 4` under USE_ISTIO).  Its `fleet`
   line prints each part's seconds.  Then the soak step (`soak_step`):
   the seven lanes of `python -m kubeflow_tpu_torch.chaos` (the twin of
   ci/chaos_soak.sh: the random fault soak, self-healing recovery with
   its exhaustion case, checkpoint migration, preemption, the fleet SLO
   soak, the sharded fleet's kill and rejoin, and replica failover) on
   gangs of this card's accelerator, at the script's seed, rounds, 8
   workers and the strict sanitizer, but the preemption, fleet SLO and
   failover lanes, which are not steady on eight workers, on one
   (SOAK_ONE_WORKER), every soak's assertions held (a SoakFailure fails
   the run).  Its `soak` line prints per lane its workers and the
   rounds, seconds, kills, promotions, fenced writes, restarts, the
   attempt at which the exhaustion case exhausted, the alerts fired and
   resolved, and the seed.

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

import base64
import contextlib
import functools
import io
import json
import math
import os
import re
import signal
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
DECODE_BENCH_STEPS = 8             # bench --decode steps: 8 // 4 timed calls
TOOLS_KV_ITERS = 32                # kv_cache_probe: iterations a graph
TOOLS_MAX_SHARE = 1.05             # a rate's cap against its bandwidth
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
# the tensor-2 ranks decode the 7B's first TP2_DEPTH layers (every shard
# shape is a layer's, so each is met at any depth)
TP2_DEPTH = 8
# notebook_train: BENCH_CHIP at batch 8 through the runtime, 12 steps, the
# cull request before step 6's hook; the corpus is NB_RUNS seeded runs
NB_BATCH, NB_STEPS, NB_CULL_STEP, NB_RUNS = 8, 12, 6, 16384
NB_EXAMPLE_TIMEOUT_S = 240
# the CR the port's controller turns into the phase's pod, the node of
# this card, and the idle minutes after which its culler stops it
NB_NAME, NB_NAMESPACE, NB_NODE = "chip-smoke", "smoke", "card-0"
NB_CULL_IDLE_MIN = 5
# the recovery drills: the drain migration snapshots the state after step
# NB_MIGRATE_STEP, and the card dies after step NB_FAIL_STEP of the run
# restored from it
NB_MIGRATE_STEP, NB_FAIL_STEP = 4, 8
# the card's node pool (unmanaged capacity: the scheduler's first
# placement there is a bypass claim), and the preemption drill: a
# high-priority CR of the same shape arrives after step NB_PREEMPT_STEP of
# the run the dead-card drill restored, and holds the card NB_BEN_HOLD_S
# of FakeClock time before it stops
NB_POOL = "card-pool"
NB_BENEFICIARY = "chip-smoke-high"
NB_PREEMPT_STEP, NB_BEN_HOLD_S = 10, 60.0
# the promotion drill: a CR of two replicas of the same one-card gang,
# anti-affine, replica 1 on a second GPU node in its own node pool; the
# promoted replica restores into a setup from a fourth seed
NB_REP, NB_STANDBY_POOL = "chip-smoke-rep", "standby-pool"
# the observability plane: the data plane's MFU target and the fleet-MFU
# objective's good share, the continuous profiler's sampling interval,
# and the gates on its overhead and on the engines' wall time
NB_MFU_TARGET, NB_SLO_FLEET_MFU = 0.5, 0.9
NB_PROFILER_INTERVAL_MS, NB_PROFILER_MAX_OVERHEAD = 100.0, 0.05
NB_ENGINES_MAX_S = 2.0
# the ODH plane: the controller's (central) namespace, where the
# notebooks' HTTPRoutes live, and the one PEM of the phase's namespace's
# odh-trusted-ca-bundle ConfigMap (structurally valid: a DER SEQUENCE in
# base64, as the reference's tests make one)
NB_ODH_NAMESPACE = "opendatahub"
NB_CA_PEM = ("-----BEGIN CERTIFICATE-----\n" + base64.b64encode(
    b"\x30\x82\x01\x0a" + b"chip-smoke".ljust(32, b"\x00")).decode()
    + "\n-----END CERTIFICATE-----")
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
    mangled name: the innermost identifier that a length prefix announces
    and that ends in _kernel, with its int template arguments.  Innermost,
    because a kernel in an anonymous namespace sits behind the namespace's
    name, whose hex id changes from build to build and can end in digits
    that announce a longer identifier ending at the same place."""
    found = None
    for run in re.finditer(r"\d+", mangled):
        for i in range(len(run[0])):
            n = int(run[0][i:])
            ident = mangled[run.end():run.end() + n]
            if len(ident) == n and ident.endswith("_kernel"):
                found = run.end(), ident
                break
    if found is None:
        return None
    end, ident = found[0] + len(found[1]), found[1]
    args = re.match(r"I((?:Li-?\d+E)+)E", mangled[end:])
    if not args:
        return ident
    return ident + "<" + ",".join(re.findall(r"Li(-?\d+)E", args[1])) + ">"


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
    tokens, each rank on its blocks of the same weights cut to their
    first TP2_DEPTH layers (`shared_draft`): both ranks' tokens equal,
    4 x TP2_DEPTH + 1 int4 launches a step a rank at the shard shapes
    (TP2_LAYERS), and the cut single-device model's teacher-forced gate
    of the speculative phase over them."""
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

    cut = shared_draft(model, TP2_DEPTH)
    cut_step = 4 * TP2_DEPTH + 1
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "llama7b_int4.pt")
        torch.save(_cpu_tree(flax_tree(cut)), path)
        t0 = time.perf_counter()
        reports = dryrun.launch(TP_RANKS, _tp_decode_rank,
                                (path, cut.cfg, prompt.cpu(), TP_NEW),
                                timeout=TP_TIMEOUT_S)
        tp2_s = time.perf_counter() - t0
    tokens = reports[0]["tokens"].to(device)
    ranks_equal = all(torch.equal(r["tokens"], reports[0]["tokens"])
                      for r in reports)
    forced = teacher_forced_gaps(cut, tokens, prompt_len)
    tp2_single = generate(cut.cfg, cut, prompt, TP_NEW)
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
                    "layers": TP2_DEPTH,
                    "new_tokens": TP_NEW, "ranks_equal": ranks_equal,
                    "int4_launches_per_rank": [r["int4_launches"]
                                               for r in reports],
                    "expected_launches_per_rank": cut_step * TP_NEW,
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
        if r["int4_launches"] != cut_step * TP_NEW or \
                r["int4_shapes"] != want_shapes:
            bad.append(f"tensor-2 rank {r['rank']} launched int4 "
                       f"{r['int4_launches']} times (expected "
                       f"{cut_step * TP_NEW}) at {r['int4_shapes']} "
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


def moe_mesh_decode(cfg, tree, model, prompt, device) -> dict:
    """The int8 MoE model through `generate(mesh=)` on a world-1 NCCL
    mesh (built from `tree` on the mesh, the step captured with its
    collectives), TP_NEW new tokens, against single-device `generate` of
    `model`: the tokens must be equal bit for bit."""
    import torch
    import torch.distributed as dist

    from kubeflow_tpu_torch.models.convert import params_from_flax
    from kubeflow_tpu_torch.models.generate import generate
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    t0 = time.perf_counter()
    single = generate(cfg, model, prompt, TP_NEW)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh(MeshConfig(), device="cuda")
        mesh_model = params_from_flax(tree, cfg, device, mesh)
        backend = dist.get_backend(mesh.get_group("tensor"))
        tokens = generate(cfg, mesh_model, prompt, TP_NEW, mesh=mesh)
        equal = torch.equal(tokens, single)
        del mesh_model, tokens
    finally:
        dist.destroy_process_group()
    return {"backend": backend, "new_tokens": TP_NEW,
            "tokens_equal_single_device": equal,
            "s": time.perf_counter() - t0}


def moe_serve_phase(device) -> dict:
    """BENCH_MOE quantized to int8 (experts per expert and output
    channel, the router kept fp32) served by `generate` at batch 16,
    prompt 128, 64 new tokens; and the same model through
    `generate(mesh=)` on a world-1 NCCL mesh (`moe_mesh_decode`)."""
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
    prompt = torch.randint(0, vocab, (batch, prompt_len), generator=gen,
                           device=device)
    on_mesh = moe_mesh_decode(int8_cfg, tree, model, prompt, device)
    del tree
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
        "world1_mesh": on_mesh,
    }
    emit(res)
    del full, model, no_drop
    torch.cuda.empty_cache()
    if on_mesh["backend"] != "nccl" or \
            not on_mesh["tokens_equal_single_device"]:
        raise RuntimeError(
            f"int8 MoE generate(mesh=) on a world-1 {on_mesh['backend']} "
            f"mesh: tokens equal to single-device generate "
            f"{on_mesh['tokens_equal_single_device']}")
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
    (T 0.8, top-k 50, seeded generator) under the graph: in range.  Each
    mode takes DECODE_BENCH_STEPS // 4 timed calls.  The bf16 (decode
    config, model) stays under "model" for the tools phase."""
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
            ["--decode", str(DECODE_BENCH_STEPS)]
            + ([f"--{quant}"] if quant else []))
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
            out["model"] = (cfg, model)      # the tools phase's ablation
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


def tools_phase(device, smi: str, db: dict) -> dict:
    """The compute tools at their smallest real settings: the HBM read
    probe (tools/decode_profile.py), kv_cache_probe's three bodies at
    TOOLS_KV_ITERS iterations a graph, and decode_ablate's batch-32
    window on decode_bench's bf16 model (`db["model"]`, freed here)
    against the bench's bf16 step.  Gates: finite positive numbers, the
    probe within 105% of the spec rate, every moved or streamed rate
    within 105% of the probe's."""
    import torch

    from kubeflow_tpu_torch.runtime.roofline import GPU_PEAKS
    from kubeflow_tpu_torch.tools import (
        decode_ablate,
        decode_profile,
        kv_cache_probe,
    )

    name = torch.cuda.get_device_name(0)
    cfg, model = db.pop("model")
    bench = db["bf16"]["record"]["detail"]
    batch, prompt_len, new = (bench["batch"], bench["prompt_len"],
                              bench["new_tokens"])
    t0 = time.perf_counter()
    hbm = decode_profile.measure_hbm_read_gbps(device)
    probe_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kv = kv_cache_probe.probe(kv_cache_probe.SHAPE, TOOLS_KV_ITERS, hbm,
                              device, name, smi)
    kv_s = time.perf_counter() - t0
    w, kv_bytes = decode_ablate.streamed_bytes(cfg, batch)
    baseline = {"step_ms": batch / db["bf16"]["tok_s"] * 1e3,
                "weight_mb": w / 1e6, "kv_mb": kv_bytes / 1e6}
    t0 = time.perf_counter()
    ablation = decode_ablate.time_cfg(
        "batch x2", cfg, 2 * batch, prompt_len, new, hbm, device, name, smi,
        windows=1, baseline=baseline, model=model)
    ablate_s = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    spec = GPU_PEAKS[name].hbm_gbps
    res = {"phase": "tools", "hbm_read_gbps": hbm, "spec_gbps": spec,
           "hbm_share_of_spec": hbm / spec,
           "kv_probe": {x["measurement"]: {
               k: x[k] for k in ("ms_per_iter", "cache_equiv_gbps",
                                 "moved_gbps", "moved_share_of_hbm")}
               for x in kv if x["measurement"] != "ideal"},
           "ablation": {k: ablation[k] for k in (
               "batch", "tok_s", "step_ms", "effective_gbps", "delta_ms",
               "removed_ms")},
           "baseline_step_ms": baseline["step_ms"],
           "seconds": {"probe": probe_s, "kv_probe": kv_s,
                       "ablation": ablate_s},
           "nvidia_smi": smi}
    emit(res)
    numbers = [hbm, ablation["tok_s"], ablation["step_ms"],
               ablation["effective_gbps"]] + [
        x[k] for x in kv if x["measurement"] != "ideal"
        for k in ("ms_per_iter", "moved_gbps")]
    if not all(math.isfinite(x) and x > 0 for x in numbers):
        raise RuntimeError(f"tools: a number is not finite and positive: "
                           f"{numbers}")
    rates = {f"kv {x['measurement']}": x["moved_gbps"] for x in kv
             if x["measurement"] != "ideal"}
    rates["ablation"] = ablation["effective_gbps"]
    over = {k: v for k, v in rates.items() if v > TOOLS_MAX_SHARE * hbm}
    if hbm > TOOLS_MAX_SHARE * spec or over:
        raise RuntimeError(f"tools: the probe's {hbm} GB/s against the "
                           f"spec's {spec}, or rates above "
                           f"{TOOLS_MAX_SHARE} x the probe: {over}")
    return res


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


def start_nccl_probe() -> dict:
    """Start the probe of whether NCCL takes two ranks on the one card:
    two spawned ranks, which `finish_nccl_probe` collects.  `main` starts
    it before the kernel build and collects it after, so its two
    interpreters start while nvcc runs and the card is idle."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_nccl_probe_rank, args=(rank, port, results))
             for rank in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    return {"procs": procs, "results": results, "t0": t0,
            "deadline": time.monotonic() + 180}


def finish_nccl_probe(started: dict) -> dict:
    """The probe's answer: {rank: what it said}, "no answer" from a rank
    that neither failed nor finished within 180 s of its start; and the
    probe's wall seconds, and how many of them were left to wait for
    here."""
    import queue as queues

    procs, results = started["procs"], started["results"]
    deadline = started["deadline"]
    said = {}
    wait_t0 = time.perf_counter()
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
    now = time.perf_counter()
    return {"said": {rank: said.get(rank, "no answer") for rank in range(2)},
            "wall_s": now - started["t0"], "waited_s": now - wait_t0}


WIRE_LEASE = "kubeflow-tpu-notebook-controller"
WIRE_TOKEN = "wire-smoke-token"
WIRE_TIMEOUT_S = 150
# kinds the in-process render and the manager over the wire must make alike
WIRE_RENDERED = ("StatefulSet", "Pod", "Service", "HTTPRoute",
                 "ReferenceGrant", "NetworkPolicy", "ServiceAccount",
                 "ConfigMap", "Secret", "ClusterRoleBinding")
# what a write or another process's clock stamps: uids (owner uids too),
# resourceVersions, times and field-manager records
WIRE_VOLATILE = {"uid", "resourceVersion", "creationTimestamp",
                 "deletionTimestamp", "managedFields", "generation",
                 "startedAt", "finishedAt", "lastTransitionTime"}


def _wire_normalized(node, volatile=WIRE_VOLATILE):
    if isinstance(node, dict):
        return {k: _wire_normalized(v, volatile) for k, v in node.items()
                if k not in volatile}
    if isinstance(node, list):
        return [_wire_normalized(v, volatile) for v in node]
    return node


def _wire_objects(api) -> dict:
    """The rendered kinds' objects in `api` with the volatile stamps
    dropped, by "kind namespace/name"."""
    with api.fault_exempt():
        return {f"{kind} {obj.namespace}/{obj.name}":
                _wire_normalized(obj.to_dict())
                for kind in WIRE_RENDERED for obj in api.list(kind)}


def _wire_wait(what: str, predicate, timeout_s: float = 30.0,
               step_s: float = 0.05):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(step_s)
    raise RuntimeError(f"wire: timed out after {timeout_s} s waiting for "
                       f"{what}")


def _wire_fixtures(bundle, result: dict) -> None:
    """The ten conformance transcripts against a fresh TLS wire server:
    {name: "pass" | the failure} into `result`."""
    from kubeflow_tpu_torch.kube import ApiServer
    from kubeflow_tpu_torch.kube.fixtures import (
        FixtureFailure,
        FixtureRunner,
        load_fixtures,
    )
    from kubeflow_tpu_torch.kube.wire import KubeApiWireServer

    t0 = time.perf_counter()
    srv = KubeApiWireServer(ApiServer(), ssl_context=bundle.server_ssl_context(),
                            token=WIRE_TOKEN).start()
    try:
        runner = FixtureRunner(srv.url, token=WIRE_TOKEN,
                               ssl_context=bundle.client_ssl_context())
        for fixture in load_fixtures():
            try:
                runner.run(fixture)
                result[fixture["name"]] = "pass"
            except FixtureFailure as err:
                result[fixture["name"]] = f"fail: {err}"
    finally:
        srv.stop()
    result["_seconds"] = time.perf_counter() - t0


def wire_step(device_name: str, gpus: int, tmp: Path) -> dict:
    """The real-cluster backend on this card's CR (see the module
    docstring, phase 18).  Runs in a process of its own: it imports no
    torch and leaves no tracing clock, logging config or env behind."""
    import socket
    import threading
    import urllib.request

    from kubeflow_tpu_torch.api.types import GPUSpec, Notebook
    from kubeflow_tpu_torch.api.types import convert_notebook_dict
    from kubeflow_tpu_torch.core import constants as K
    from kubeflow_tpu_torch.gpu import topology
    from kubeflow_tpu_torch.gpu.device_plugin import label_gpu_node
    from kubeflow_tpu_torch.kube import (
        ApiError,
        ApiServer,
        ConflictError,
        FakeCluster,
        FaultPlan,
        FaultRule,
        KubeObject,
        ObjectMeta,
    )
    from kubeflow_tpu_torch.kube.certs import mint_serving_cert
    from kubeflow_tpu_torch.kube.client import KubeClient, RestConfig
    from kubeflow_tpu_torch.kube.resources import ResourceInfo, Scheme
    from kubeflow_tpu_torch.kube.wire import KubeApiWireServer
    from kubeflow_tpu_torch.main import build_manager
    from kubeflow_tpu_torch.odh import constants as O
    from kubeflow_tpu_torch.odh.webhook_server import (
        RemoteAdmissionHook,
        RemoteConverter,
    )
    from kubeflow_tpu_torch.utils.clock import FakeClock
    from kubeflow_tpu_torch.utils.config import CoreConfig, OdhConfig

    t0 = time.perf_counter()
    res: dict = {}
    accelerator = topology.accelerator_from_device_name(device_name)
    bundle = mint_serving_cert()
    cert_dir = tmp / "certs"
    bundle.write(str(cert_dir))
    fixtures: dict = {}
    replay = threading.Thread(target=_wire_fixtures, args=(bundle, fixtures),
                              name="wire-fixtures")
    replay.start()

    def free_port() -> int:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    # the cluster: one node for this card, served over TLS
    knobs = {"CHECKPOINT_STORE_URI": f"file://{tmp / 'store'}",
             "K8S_NAMESPACE": NB_ODH_NAMESPACE}
    api = ApiServer()
    cluster = FakeCluster(api)
    cluster.add_node(NB_NODE, labels={K.GKE_NODEPOOL_LABEL: NB_POOL},
                     allocatable={"cpu": "8", "memory": "96Gi"})
    label_gpu_node(api, NB_NODE, gpus=gpus, accelerator=accelerator)
    webhook_port = free_port()
    webhook_url = f"https://127.0.0.1:{webhook_port}"
    audit_path = tmp / "wire-audit.jsonl"
    srv = KubeApiWireServer(
        api, token=WIRE_TOKEN, ssl_context=bundle.server_ssl_context(),
        converter=RemoteConverter(webhook_url, ca_pem=bundle.ca_cert_pem),
        audit_log=str(audit_path)).start()
    kubeconfig = tmp / "kubeconfig"
    kubeconfig.write_text(json.dumps({
        "apiVersion": "v1", "kind": "Config", "current-context": "card",
        "contexts": [{"name": "card", "context": {"cluster": "card",
                                                  "user": "card"}}],
        "clusters": [{"name": "card", "cluster": {
            "server": srv.url,
            "certificate-authority": str(cert_dir / "ca.crt")}}],
        "users": [{"name": "card", "user": {"token": WIRE_TOKEN}}]}))
    env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR", "LANG")
           if k in os.environ}
    env.update(knobs, PYTHONPATH=str(ROOT))
    log = open(tmp / "manager.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.main",
         "--kubeconfig", str(kubeconfig), "--enable-leader-election",
         "--leader-election-namespace", "default",
         "--webhook-port", str(webhook_port), "--cert-dir", str(cert_dir),
         "--metrics-addr", "0", "--run-seconds", str(WIRE_TIMEOUT_S)],
        cwd=str(ROOT), env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        # the in-process render of the same CR while the manager boots:
        # build_manager as NotebookController builds it, on a FakeClock
        core_cfg, odh_cfg = CoreConfig.from_env(knobs), OdhConfig.from_env(knobs)
        mgr, ref_api, ref_cluster, _ = build_manager(
            core_cfg, clock=FakeClock(), odh_cfg=odh_cfg)
        ref_cluster.add_node(NB_NODE, labels={K.GKE_NODEPOOL_LABEL: NB_POOL},
                             allocatable={"cpu": "8", "memory": "96Gi"})
        label_gpu_node(ref_api, NB_NODE, gpus=gpus, accelerator=accelerator)

        def ca_bundle() -> KubeObject:
            return KubeObject(
                api_version="v1", kind="ConfigMap",
                metadata=ObjectMeta(name=O.ODH_TRUSTED_CA_BUNDLE_CONFIGMAP,
                                    namespace=NB_NAMESPACE),
                body={"data": {O.TRUSTED_CA_BUNDLE_FILE: NB_CA_PEM}})

        def notebook(version: str) -> KubeObject:
            d = Notebook.new(
                NB_NAME, NB_NAMESPACE, gpu=GPUSpec(accelerator, 1),
                priority="low",
                annotations={O.ANNOTATION_INJECT_AUTH: "true"}).obj
            return KubeObject.from_dict(convert_notebook_dict(
                d, f"kubeflow.org/{version}"))

        ref_api.create(ca_bundle())
        ref_api.create(notebook("v1"))
        for _ in range(4):
            mgr.enqueue_all()
            mgr.run_until_idle()
        want = _wire_objects(ref_api)
        res["render_s"] = time.perf_counter() - t0

        # the leader, its webhooks over HTTPS, then the CR at v1beta1
        lease = _wire_wait("the lease holder", lambda: (api.try_get(
            "Lease", "default", WIRE_LEASE) or None), 60)
        holder = lease.body["spec"]["holderIdentity"]
        if not holder.endswith(f"-{proc.pid}"):
            raise RuntimeError(f"wire: lease held by {holder!r}, not the "
                               f"manager (pid {proc.pid})")
        ctx = bundle.client_ssl_context()

        def webhook_ready():
            try:
                with urllib.request.urlopen(f"{webhook_url}/readyz",
                                            context=ctx, timeout=2) as r:
                    return r.status == 200
            except OSError:
                return False

        _wire_wait("the manager's webhook server", webhook_ready, 30)
        api.register_admission(RemoteAdmissionHook(
            webhook_url, "/mutate-notebook-v1", mutating=True,
            ca_pem=bundle.ca_cert_pem).as_hook())
        api.register_admission(RemoteAdmissionHook(
            webhook_url, "/validate-notebook-v1", mutating=False,
            ca_pem=bundle.ca_cert_pem, operations=("UPDATE",)).as_hook())
        config = RestConfig(server=srv.url, token=WIRE_TOKEN,
                            ca_file=str(cert_dir / "ca.crt"))
        client = KubeClient(config)
        beta = Scheme()
        beta.register(ResourceInfo("Notebook", "kubeflow.org", "v1beta1",
                                   "notebooks"))
        beta_client = KubeClient(config, scheme=beta)
        client.create(ca_bundle())
        created = beta_client.create(notebook("v1beta1"))
        stored = api.get("Notebook", NB_NAMESPACE, NB_NAME)
        lock = created.annotations.get(K.STOP_ANNOTATION)
        if created.api_version != "kubeflow.org/v1beta1" \
                or stored.api_version != "kubeflow.org/v1" \
                or lock != "odh-notebook-controller-lock":
            raise RuntimeError(
                f"wire: the CR came back at {created.api_version}, stored at "
                f"{stored.api_version}, lock {lock!r}")

        def unlocked():
            nb = api.get("Notebook", NB_NAMESPACE, NB_NAME)
            return K.STOP_ANNOTATION not in nb.metadata.annotations

        def pod_running():
            pod = api.try_get("Pod", NB_NAMESPACE, f"{NB_NAME}-0")
            return pod is not None and (pod.body.get("status") or {}).get(
                "phase") == "Running"

        _wire_wait("the lock lifted", unlocked)
        lifts = [r for r in api.audit_log(verb="patch", kind="Notebook")
                 if r.ok and r.name == NB_NAME]
        if not lifts:
            raise RuntimeError("wire: the lock came off without a patch")
        _wire_wait("the pod Running", pod_running)
        res["reconciled_s"] = time.perf_counter() - t0

        def settled():
            got = _wire_objects(api)
            return got if got == want else None

        try:
            _wire_wait("the render to settle", settled, 20)
        except RuntimeError:
            got = _wire_objects(api)
            diff = sorted(k for k in set(got) | set(want)
                          if got.get(k) != want.get(k))
            raise RuntimeError(f"wire: objects differ from the in-process "
                               f"render: {diff[:8]}; over the wire "
                               f"{[got.get(k) for k in diff[:1]]}, in "
                               f"process {[want.get(k) for k in diff[:1]]}")
        pod = api.get("Pod", NB_NAMESPACE, f"{NB_NAME}-0")
        node = api.get("Node", "", NB_NODE)
        limits = [c["resources"]["limits"].get("nvidia.com/gpu")
                  for c in pod.spec["containers"]
                  if "nvidia.com/gpu" in (c.get("resources") or {}).get(
                      "limits", {})]
        res["rendered"] = {"objects": len(want), "pod_gpu_limits": limits,
                           "node_gpus": node.status["allocatable"].get(
                               "nvidia.com/gpu"),
                           "containers": [c["name"] for c in
                                          pod.spec["containers"]]}
        if limits != ["1"] or res["rendered"]["node_gpus"] != str(gpus):
            raise RuntimeError(f"wire: nvidia.com/gpu limits {limits}, node "
                               f"{res['rendered']['node_gpus']} (want 1 and "
                               f"{gpus})")

        # the verbs over the wire
        client.merge_patch("Notebook", NB_NAMESPACE, NB_NAME, {
            "metadata": {"annotations": {
                K.STOP_ANNOTATION: "2026-01-01T00:00:00Z"}}})
        _wire_wait("the stopped pod gone", lambda: api.try_get(
            "Pod", NB_NAMESPACE, f"{NB_NAME}-0") is None)
        applied = {"apiVersion": "v1", "kind": "ConfigMap",
                   "metadata": {"name": "wire-apply",
                                "namespace": NB_NAMESPACE},
                   "data": {"owner": "alice"}}
        client.apply(KubeObject.from_dict(applied), field_manager="alice")
        applied["data"]["owner"] = "bob"
        try:
            client.apply(KubeObject.from_dict(applied), field_manager="bob")
            raise RuntimeError("wire: a contested apply did not conflict")
        except ConflictError as err:
            res["apply_conflict"] = str(err)
        forced = client.apply(KubeObject.from_dict(applied),
                              field_manager="bob", force=True)
        managers = sorted(e["manager"] for e in
                          forced.metadata.managed_fields)
        if forced.body["data"]["owner"] != "bob":
            raise RuntimeError("wire: the forced apply did not land")
        sts = client.strategic_merge_patch("StatefulSet", NB_NAMESPACE,
                                           NB_NAME, {"spec": {"template": {
                                               "spec": {"containers": [{
                                                   "name": NB_NAME,
                                                   "env": [{"name": "WIRE_SMP",
                                                            "value": "1"}]}]}}}})
        (main_c,) = [c for c in sts.spec["template"]["spec"]["containers"]
                     if c["name"] == NB_NAME]
        env_names = [e["name"] for e in main_c.get("env", [])]
        if "WIRE_SMP" not in env_names or len(env_names) < 2:
            raise RuntimeError(f"wire: the strategic merge patch gave env "
                               f"{env_names}")
        patched = client.json_patch("Notebook", NB_NAMESPACE, NB_NAME, [
            {"op": "add", "path": "/metadata/labels/wire-json-patch",
             "value": "yes"}])
        if patched.metadata.labels.get("wire-json-patch") != "yes":
            raise RuntimeError("wire: the JSON patch did not land")

        # a fault plan drops every watch stream and resets the history at
        # the un-stop patch; a write just before it leaves the informers'
        # resume versions behind the compaction, so they relist on 410
        plan = FaultPlan([FaultRule(verbs=("patch",), kinds=("Notebook",),
                                    drop_watch=True, reset_watch_history=True,
                                    name="wire-relist")])
        marks_before = audit_path.read_text().count('"code": 410')
        client.merge_patch("ConfigMap", NB_NAMESPACE, "wire-apply",
                           {"metadata": {"labels": {"tick": "1"}}})
        api.install_fault_plan(plan)
        client.merge_patch("Notebook", NB_NAMESPACE, NB_NAME, {
            "metadata": {"annotations": {K.STOP_ANNOTATION: None}}})
        api.clear_fault_plan()
        _wire_wait("the un-stopped pod Running after the relist",
                   pod_running)
        gone = [json.loads(line) for line in audit_path.read_text()
                .splitlines() if '"code": 410' in line]
        if len(plan.log) != 1 or len(gone) <= marks_before:
            raise RuntimeError(f"wire: plan log {plan.log}, 410 answers "
                               f"{len(gone)} (before {marks_before})")
        res["relist"] = {"faults": [r.action for r in plan.log],
                         "watch_410": len(gone) - marks_before,
                         "paths": sorted({g["path"].split("?")[0]
                                          for g in gone})}
        wanted = {("create", "Notebook"), ("create", "ConfigMap"),
                  ("patch", "Notebook"), ("patch", "ConfigMap"),
                  ("patch", "StatefulSet")}
        audited = {(r.verb, r.kind) for r in api.audit_log()}
        refused = [r for r in api.audit_log(verb="patch", kind="ConfigMap")
                   if not r.ok]
        if not wanted <= audited or len(refused) != 1:
            raise RuntimeError(f"wire: the audit log lacks "
                               f"{sorted(wanted - audited)} or holds "
                               f"{len(refused)} refused applies")
        res["audit"] = {"records": len(api.audit_log()),
                        "verbs": sorted(f"{v} {k}" for v, k in audited),
                        "apply_managers": managers,
                        "requests": len(audit_path.read_text().splitlines())}

        # the schema hook over HTTPS: the manager serves it at
        # /notebook-crd-schema, and a CR with no containers sent through
        # the KubeClient is refused with the reference's message
        api.register_admission(RemoteAdmissionHook(
            webhook_url, "/notebook-crd-schema", mutating=False,
            ca_pem=bundle.ca_cert_pem).as_hook())
        bare = KubeObject.from_dict(Notebook.new(
            f"{NB_NAME}-bare", NB_NAMESPACE, gpu=GPUSpec(accelerator, 1),
            pod_spec={"containers": []}).obj)
        try:
            client.create(bare)
            raise RuntimeError("wire: a CR with no containers was admitted")
        except ApiError as err:
            if SCHEMA_NO_CONTAINERS not in str(err):
                raise RuntimeError(f"wire: the CR with no containers was "
                                   f"refused with {err}") from None
            res["schema_refusal"] = str(err)
    finally:
        t_stop = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        try:
            code = proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            code = proc.wait()
        res["exit_s"] = time.perf_counter() - t_stop
        res["exit_code"] = code
        log.close()
        replay.join()
        srv.stop()
    released = api.get("Lease", "default", WIRE_LEASE)
    if code != 0 or res["exit_s"] > 2.0 or \
            released.body["spec"].get("holderIdentity"):
        raise RuntimeError(f"wire: the manager exited {code} after "
                           f"{res['exit_s']:.2f} s, lease held by "
                           f"{released.body['spec'].get('holderIdentity')!r}")
    res["fixtures_s"] = fixtures.pop("_seconds", None)
    failed = {k: v for k, v in fixtures.items() if v != "pass"}
    if len(fixtures) != 10 or failed:
        raise RuntimeError(f"wire: fixtures {len(fixtures)}, failed {failed}")
    res["fixtures"] = sorted(fixtures)
    res["step_s"] = time.perf_counter() - t0
    return res


# the shard step: SHARD_COUNT replicas of the control plane, a dozen CPU
# notebooks over four namespaces beside this card's CR, and sub-lease
# steps of FakeClock time (survivors renew, the dead lease ages out)
SHARD_COUNT = 3
SHARD_NAMESPACES = ("team-0", "team-1", "team-2", "team-3")
SHARD_NOTEBOOKS = 12
SHARD_STEP_S, SHARD_EXPIRY_STEPS = 8.0, 3
SHARD_HANDOFF_P99_S = 30.0
SHARD_FAMILIES = ("notebook_shard_keys_owned", "notebook_shard_epoch",
                  "notebook_shard_fenced_writes_total",
                  "notebook_shard_handoff_duration_seconds")
# the reference's refusal of a CR with no containers
# (kubeflow_tpu/api/types.py:Notebook.validate, through its schema hook)
SCHEMA_NO_CONTAINERS = ("invalid Notebook: spec.template.spec.containers "
                        "must be non-empty")
# what differs between two stores' renders of one CR beyond the wire
# step's volatile stamps: the pod IPs the fake cluster hands out in turn
SHARD_VOLATILE = WIRE_VOLATILE | {"podIP", "podIPs", "hostIP"}
SHARD_RENDERED = ("StatefulSet", "Pod", "Service")


def _shard_render(api, namespace: str, name: str) -> dict:
    """The card CR's StatefulSet, pods and Services in `api`, stamps
    dropped, by "kind name"."""
    with api.fault_exempt():
        return {f"{kind} {obj.name}": _wire_normalized(obj.to_dict(),
                                                       SHARD_VOLATILE)
                for kind in SHARD_RENDERED
                for obj in api.list(kind, namespace=namespace)
                if obj.name == name or obj.name.startswith(f"{name}-")}


def _serve_api_openapi() -> dict:
    """`python -m kubeflow_tpu_torch.main --serve-api 0` as a process of
    its own: the Notebook model its /openapi/v2 serves (the port's CRD,
    seeded at startup) and the seconds to the answer."""
    import urllib.request

    t0 = time.perf_counter()
    env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR", "LANG")
           if k in os.environ}
    env["PYTHONPATH"] = str(ROOT)
    # the process exits after --run-seconds, so the read of its output
    # ends by then
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.main", "--serve-api", "0",
         "--metrics-addr", "0", "--webhook-port", "-1",
         "--run-seconds", "60"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        url = next((line.strip().split("=", 1)[1] for line in proc.stdout
                    if line.startswith("WIRE_API=")), "")
        if not url:
            raise RuntimeError("shard: the --serve-api manager printed no "
                               "WIRE_API line")
        with urllib.request.urlopen(url + "/openapi/v2", timeout=10) as r:
            doc = json.loads(r.read())
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    spec = doc["definitions"]["kubeflow.org.v1.Notebook"]["properties"][
        "spec"].get("properties") or {}
    return {"spec_fields": sorted(spec),
            "gpu_fields": sorted((spec.get("gpu") or {}).get("properties")
                                 or {}),
            "seconds": time.perf_counter() - t0}


def shard_step(device_name: str, gpus: int) -> dict:
    """The sharded control plane on this card's CR (see the module
    docstring, phase 18's shard step).  Runs in the wire step's process,
    after it: no card memory, FakeClock time."""
    import threading

    from kubeflow_tpu_torch.api.types import GPUSpec, Notebook
    from kubeflow_tpu_torch.core.culling_controller import setup_culling
    from kubeflow_tpu_torch.core.metrics import NotebookMetrics
    from kubeflow_tpu_torch.core.notebook_controller import (
        setup_core_controllers,
    )
    from kubeflow_tpu_torch.gpu import topology
    from kubeflow_tpu_torch.gpu.device_plugin import label_gpu_node
    from kubeflow_tpu_torch.kube import (
        ApiServer,
        FakeCluster,
        KubeObject,
        Manager,
        StaleEpochError,
    )
    from kubeflow_tpu_torch.main import build_sharded_fleet
    from kubeflow_tpu_torch.ops.diagnose import (
        collect_local,
        merge_overlaps,
        merge_records,
    )
    from kubeflow_tpu_torch.utils import tracing
    from kubeflow_tpu_torch.utils.clock import FakeClock
    from kubeflow_tpu_torch.utils.config import CoreConfig
    from kubeflow_tpu_torch.utils.slo import SLOEngine, default_objectives

    t0 = time.perf_counter()
    openapi: dict = {}

    def read_openapi():
        try:
            openapi.update(_serve_api_openapi())
        except Exception as err:  # noqa: BLE001 — gated below
            openapi["error"] = repr(err)

    served = threading.Thread(target=read_openapi, name="shard-openapi")
    served.start()
    accelerator = topology.accelerator_from_device_name(device_name)
    card = Notebook.new(NB_NAME, NB_NAMESPACE,
                        gpu=GPUSpec(accelerator, 1)).obj
    cfg = CoreConfig.from_env({
        "SHARD_COUNT": str(SHARD_COUNT),
        "SLO_SHARD_HANDOFF_P99_S": str(SHARD_HANDOFF_P99_S)})
    clock = FakeClock()
    tracing.set_clock(clock)
    res: dict = {}
    try:
        fleet, api, cluster, metrics = build_sharded_fleet(cfg, clock=clock)
        engine = SLOEngine(default_objectives(cfg), [metrics.registry],
                           clock=clock)
        metrics.attach_slo(engine)
        cluster.add_node("cpu-node",
                         allocatable={"cpu": "64", "memory": "256Gi"})
        keys = [(SHARD_NAMESPACES[i % len(SHARD_NAMESPACES)], f"nb-{i}")
                for i in range(SHARD_NOTEBOOKS)] + [(NB_NAMESPACE, NB_NAME)]
        for ns, name in keys[:-1]:
            api.create(KubeObject.from_dict(Notebook.new(name, ns).obj))
        # no node for the card yet: its gang waits, not ready, while its
        # owner dies, so its ledger holds the handoff
        api.create(KubeObject.from_dict(card))

        def one_owner() -> dict:
            owners = {}
            for ns, name in keys:
                claimants = [sid for sid, r in fleet.replicas.items()
                             if r.alive and r.owns_key(ns, name)]
                if claimants != [fleet.owner_of(ns, name)]:
                    raise RuntimeError(f"shard: {ns}/{name} claimed by "
                                       f"{claimants}, ring owner "
                                       f"{fleet.owner_of(ns, name)}")
                owners[claimants[0]] = owners.get(claimants[0], 0) + 1
            return owners

        fleet.settle()
        res["owners"] = one_owner()
        metrics.scrape()

        # kill the card CR's owner; sub-lease steps age its lease out
        owner = fleet.owner_of(NB_NAMESPACE, NB_NAME)
        killed = fleet.replicas[owner]
        epoch = fleet.shard_snapshot()["epoch"]
        fleet.kill(owner)
        for _ in range(SHARD_EXPIRY_STEPS):
            clock.advance(SHARD_STEP_S)
            fleet.settle()
        snap = fleet.shard_snapshot()
        last = snap["lastHandoff"] or {}
        adopter = fleet.owner_of(NB_NAMESPACE, NB_NAME)
        if owner in snap["members"] or snap["handoff"] is not None \
                or last.get("epoch") != snap["epoch"] \
                or last.get("durationSeconds") is None \
                or snap["epoch"] <= epoch:
            raise RuntimeError(f"shard: the handoff after killing {owner} "
                               f"did not complete: {snap}")
        if adopter == owner or not fleet.replicas[adopter].alive or \
                not fleet.replicas[adopter].owns_key(NB_NAMESPACE, NB_NAME):
            raise RuntimeError(f"shard: {adopter} did not adopt the card's "
                               f"CR from {owner}")
        res["handoff"] = {"killed": owner, "adopter": adopter,
                          "epoch": snap["epoch"],
                          "fakeclock_s": last["durationSeconds"]}
        res["owners_after_kill"] = one_owner()
        # a zombie write through the killed replica's fenced client
        zombie = api.get("Notebook", NB_NAMESPACE, NB_NAME)
        zombie.metadata.annotations["chip-smoke/zombie"] = owner
        try:
            killed.fenced.update(zombie)
            raise RuntimeError("shard: a zombie write landed")
        except StaleEpochError:
            pass
        if killed.fenced.rejected_total != 1 or "chip-smoke/zombie" in \
                api.get("Notebook", NB_NAMESPACE,
                        NB_NAME).metadata.annotations:
            raise RuntimeError(f"shard: fenced writes "
                               f"{killed.fenced.rejected_total}, want 1")
        # the card's node: the adopter takes the gang to Healthy
        cluster.add_node(NB_NODE, allocatable={"cpu": "8", "memory": "96Gi"})
        label_gpu_node(api, NB_NODE, gpus=gpus, accelerator=accelerator)
        fleet.settle()
        health = api.get("Notebook", NB_NAMESPACE, NB_NAME).body.get(
            "status", {}).get("sliceHealth")
        overlaps = fleet.cross_process_overlaps()
        entry = metrics.lifecycle.latest_entry(NB_NAMESPACE, NB_NAME) or {}
        handoff_wait = (entry.get("stages") or {}).get("handoff_wait", 0.0)
        scrape = metrics.scrape()
        verdict = engine.verdicts().get("shard_handoff")
        fenced = f'notebook_shard_fenced_writes_total{{shard="{owner}"}} 1'
        if health != "Healthy" or overlaps or not handoff_wait > 0 \
                or not all(f"# TYPE {f} " in scrape
                           for f in SHARD_FAMILIES) \
                or fenced not in scrape or verdict is None \
                or not verdict["events"] >= 1 or not verdict["met"]:
            raise RuntimeError(
                f"shard: health {health}, overlaps {len(overlaps)}, "
                f"handoff_wait {handoff_wait}, families "
                f"{[f for f in SHARD_FAMILIES if f not in scrape]}, "
                f"fenced line {fenced in scrape}, verdict {verdict}")
        res.update(handoff_wait_s=handoff_wait, shard_handoff=verdict,
                   fenced_writes=killed.fenced.rejected_total)

        # rejoin, settle, one diagnose bundle per replica
        fleet.rejoin(owner)
        fleet.settle()
        snap = fleet.shard_snapshot()
        if snap["members"] != sorted(fleet.replicas) or snap["handoff"]:
            raise RuntimeError(f"shard: the rejoin did not settle: {snap}")
        res["owners_after_rejoin"] = one_owner()
        texts = [json.dumps(collect_local(r.manager, env={}), default=str)
                 for r in fleet.replicas.values()]
        bundles = [json.loads(t) for t in texts]
        records = merge_records(bundles)
        bundle_overlaps = merge_overlaps(bundles)
        overlaps = fleet.cross_process_overlaps()
        if not records or bundle_overlaps or overlaps:
            raise RuntimeError(f"shard: {len(records)} merged attempts, "
                               f"{len(bundle_overlaps)} overlapping pairs "
                               f"in the bundles, {len(overlaps)} in process")
        res.update(bundle_bytes=[len(t) for t in texts],
                   merged_attempts=len(records),
                   overlaps=len(bundle_overlaps) + len(overlaps))

        # the single-manager render of the same CR: one Manager running
        # the controllers every replica runs, on a store of its own
        ref_clock = FakeClock()
        ref_api = ApiServer()
        ref_cluster = FakeCluster(ref_api)
        mgr = Manager(ref_api, clock=ref_clock)
        ref_metrics = NotebookMetrics(ref_api, manager=mgr)
        setup_core_controllers(mgr, cfg, ref_metrics, provisioner=ref_cluster)
        setup_culling(mgr, cfg, metrics=ref_metrics)
        ref_cluster.add_node(NB_NODE,
                             allocatable={"cpu": "8", "memory": "96Gi"})
        label_gpu_node(ref_api, NB_NODE, gpus=gpus, accelerator=accelerator)
        ref_api.create(KubeObject.from_dict(card))
        mgr.run_until_idle()
        want = _shard_render(ref_api, NB_NAMESPACE, NB_NAME)
        got = _shard_render(api, NB_NAMESPACE, NB_NAME)
        if got != want or not want:
            diff = sorted(k for k in set(got) | set(want)
                          if got.get(k) != want.get(k))
            raise RuntimeError(f"shard: the fleet's render differs from "
                               f"one manager's: {diff}")
        res["rendered"] = sorted(want)
    finally:
        tracing.set_clock(None)
        served.join()
    if "error" in openapi or "gpu" not in openapi.get("spec_fields", ()) \
            or not {"accelerator", "count"} <= set(openapi["gpu_fields"]):
        raise RuntimeError(f"shard: --serve-api's /openapi: {openapi}")
    res["openapi"] = openapi
    res["step_s"] = time.perf_counter() - t0
    return res


# the fleet step: this many gangs of the card's own shape, compared
# against the same fleet on this many workers, and this many CPU
# notebooks over this many shards
FLEET_COUNT, FLEET_COMPARE_WORKERS = 200, 8
FLEET_SHARDED_COUNT, FLEET_SHARDS = 200, 3


def fleet_step(device_name: str) -> dict:
    """The port's fleet load generators and conformance profile (see the
    module docstring, phase 18's fleet step).  Runs in the wire step's
    process, after the shard step: FakeClock fleets and one manager
    process, no card memory."""
    from kubeflow_tpu_torch.conformance.__main__ import run_profile
    from kubeflow_tpu_torch.gpu import topology
    from kubeflow_tpu_torch.loadtest import convergence

    t0 = time.perf_counter()
    gpu = f"{topology.accelerator_from_device_name(device_name)}:1"
    budget_path = (ROOT / "kubeflow_tpu_torch" / "loadtest" / "budgets"
                   / "apiserver_call_budget.json")
    budget = json.loads(budget_path.read_text())
    # the benchmark and the profile print their critical-path tables and PASS lines; keep
    # them off this script's output and show their tail on a failure
    log = io.StringIO()
    with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        t = time.perf_counter()
        fleet, failures = convergence.run_fleet_gated(
            FLEET_COUNT, 1, gpu, FLEET_COMPARE_WORKERS, budget)
        fleet_s = time.perf_counter() - t
        t = time.perf_counter()
        sharded = convergence.run_sharded_fleet(FLEET_SHARDED_COUNT,
                                                FLEET_SHARDS)
        sharded_s = time.perf_counter() - t
        t = time.perf_counter()
        profile = run_profile(fixtures=False)
        profile_s = time.perf_counter() - t
    tail = log.getvalue().splitlines()[-30:]
    problems = [f"budget: {f}" for f in failures]
    if not fleet["compare"]["state_identical"]:
        problems.append("1-worker and 8-worker states differ")
    if fleet["steady_write_verbs"] != 0:
        problems.append(f"steady writes {fleet['steady_write_verbs']}")
    if fleet["criticalpath"]["conservation"]["violations"] or \
            fleet["tenants"]["conservation"]["violations"]:
        problems.append("fleet conservation violations")
    if sharded["cross_process_overlaps"] or \
            sharded["steady_data_plane_writes"] or \
            sharded["criticalpath"]["conservation"]["violations"]:
        problems.append("sharded fleet: overlaps, steady writes or "
                        "conservation violations")
    if not (profile["ok"] and profile["goldens"] and profile["behavior"] == [
            "cpu_lifecycle", "served_versions", "gpu_topology",
            "istio_routing"]):
        problems.append(f"conformance: {profile}")
    if problems:
        raise RuntimeError("fleet step: " + "; ".join(problems)
                           + "\n" + "\n".join(tail))
    return {
        "gpu": gpu, "count": FLEET_COUNT,
        "budget": str(budget_path.relative_to(ROOT)),
        "budget_ok": fleet["budget_ok"],
        "state_identical": fleet["compare"]["state_identical"],
        "compare_workers": FLEET_COMPARE_WORKERS,
        "steady_write_verbs": fleet["steady_write_verbs"],
        "reconciles_per_notebook": fleet["reconciles_per_notebook"],
        "writes_per_notebook": fleet["writes_per_notebook"],
        "wall_s": fleet["wall_s"], "compare_wall_s": fleet["compare"]["wall_s"],
        "p99_event_to_reconcile_s": fleet["p99_event_to_reconcile_s"],
        "conservation_violations":
            fleet["criticalpath"]["conservation"]["violations"]
            + fleet["tenants"]["conservation"]["violations"],
        "sharded": {k: sharded[k] for k in (
            "count", "shards", "epoch", "killed_shard", "keys_owned",
            "cross_process_overlaps", "steady_data_plane_writes",
            "fenced_rejections", "wall_s", "handoff_wall_s",
            "p99_event_to_reconcile_s", "binding_stage")},
        "sharded_conservation_violations":
            sharded["criticalpath"]["conservation"]["violations"],
        "conformance": {k: profile[k] for k in (
            "goldens", "behavior", "ok", "seconds")},
        "fleet_s": fleet_s, "sharded_s": sharded_s,
        "conformance_s": profile_s, "step_s": time.perf_counter() - t0,
    }


# what the soak line prints of each lane's counts
SOAK_KEYS = ("kills", "promotions", "fenced_writes", "restarts",
             "exhausted_at", "alerts_fired", "alerts_resolved")
# lanes the step runs on one worker, not on eight: with one FakeClock
# shared by every worker, their assertions depend on how the workers'
# threads interleave, in the reference's lanes too (ROADMAP.md §3): the
# fleet SLO soak's lagged attempt is not always the slowest
# (tests/test_chaos.py:1625, :1627), a preemption victim's pods can
# outlive the resume (:1024, :1026), and a failover round's baseline can
# miss Healthy within its bounded drive (:1268)
SOAK_ONE_WORKER = ("preemption", "fleet_slo", "failover")


def soak_step(device_name: str) -> dict:
    """The seeded chaos soaks' seven lanes (see the module docstring,
    phase 18's soak step).  Runs in the wire step's process, after the
    fleet step: FakeClock soaks on this card's gangs, no card memory.
    Raises the first SoakFailure."""
    import logging

    from kubeflow_tpu_torch.chaos import __main__ as chaos
    from kubeflow_tpu_torch.chaos import soaks
    from kubeflow_tpu_torch.gpu import topology

    t0 = time.perf_counter()
    accelerator = topology.accelerator_from_device_name(device_name)
    # the script's defaults, whatever this process's environment holds
    cfg = chaos.settings({})
    stack = soaks.port_stack(accelerator)
    # the injected faults log every failed attempt; keep them off stderr
    log = logging.getLogger("kubeflow_tpu_torch")
    level = log.level
    log.setLevel(logging.CRITICAL)
    lanes = {}
    try:
        for lane in chaos.LANES:
            res = chaos.run_lane(lane, dict(cfg, workers=1)
                                 if lane in SOAK_ONE_WORKER else cfg, stack)
            lanes[lane] = {"rounds": res["rounds"],
                           "seconds": res["seconds"],
                           "workers": res["workers"],
                           **{k: res["counts"].get(k) for k in SOAK_KEYS}}
    finally:
        log.setLevel(level)
    return {"accelerator": accelerator, "seed": cfg["seed"],
            "workers": cfg["workers"], "strict": cfg["strict"],
            "one_worker": list(SOAK_ONE_WORKER), "lanes": lanes,
            "step_s": time.perf_counter() - t0}


def _wire_step_process(device_name: str, gpus: int, queue) -> None:
    """wire_step, then shard_step, fleet_step and soak_step, in a spawned
    process: ("ok", the wire step's result with the shard step's under
    "shard", the fleet step's under "fleet" and the soak step's under
    "soak") or ("error", traceback) on `queue`."""
    import tempfile
    import traceback

    sys.path.insert(0, str(ROOT))
    try:
        with tempfile.TemporaryDirectory(prefix="wire-step-") as tmp:
            res = wire_step(device_name, gpus, Path(tmp))
        res["shard"] = shard_step(device_name, gpus)
        res["fleet"] = fleet_step(device_name)
        res["soak"] = soak_step(device_name)
        queue.put(("ok", res))
    except BaseException:
        queue.put(("error", traceback.format_exc()))
    queue.close()
    queue.join_thread()


def start_wire_step(device_name: str, gpus: int) -> dict:
    """Start the wire step in a spawned process; `finish_wire_step`
    collects it.  `main` starts it before gemma_train, whose steps are
    seconds of card time, so the step's host work overlaps them."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=_wire_step_process,
                       args=(device_name, gpus, results))
    t0 = time.perf_counter()
    proc.start()
    return {"proc": proc, "results": results, "t0": t0}


def finish_wire_step(started: dict) -> dict:
    """The step's result, with its wall seconds and the seconds left to
    wait for here; raises if it failed or gave no answer in
    WIRE_TIMEOUT_S."""
    import queue as queues

    proc, results = started["proc"], started["results"]
    wait_t0 = time.perf_counter()
    try:
        status, payload = results.get(timeout=max(
            1.0, WIRE_TIMEOUT_S - (wait_t0 - started["t0"])))
    except queues.Empty:
        status, payload = "error", f"no answer within {WIRE_TIMEOUT_S} s"
    finally:
        proc.join(timeout=30)
        if proc.is_alive():
            proc.kill()
            proc.join()
    if status != "ok":
        raise RuntimeError(f"wire step failed:\n{payload}")
    now = time.perf_counter()
    payload.update(wall_s=now - started["t0"], waited_s=now - wait_t0)
    return payload


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


def pipeline_train_phase(device, smi: str, nccl: dict) -> dict:
    """BENCH_CHIP at full width and depth in PIPE_STAGES pipeline stages
    under GPipe and 1F1B: one process a stage on the one card, over
    gloo, held to the unsharded kernel path.  `nccl` is what the NCCL
    probe said of two ranks on the one card (`finish_nccl_probe`)."""
    import tempfile

    import torch

    from kubeflow_tpu_torch import dryrun
    from kubeflow_tpu_torch.models import train
    from kubeflow_tpu_torch.models.configs import BENCH_CHIP

    phase_t0 = time.perf_counter()
    cfg, seq = BENCH_CHIP, BENCH_CHIP.max_seq_len
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
        "nccl_two_ranks_one_card": nccl["said"],
        "nccl_probe_s": {"wall": nccl["wall_s"],
                         "waited_after_build": nccl["waited_s"]},
        "batch": COMPARE_BATCH, "seq": seq,
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


class NotebookController:
    """The port's control plane standing up the phase's pod on this card:
    `kubeflow_tpu_torch.main.build_manager` (the notebook controller and
    the culler, on a FakeClock, with FakeJupyterState reporting one idle
    kernel) over the in-memory cluster, one node for this card labelled
    by `gpu/device_plugin.py:label_gpu_node` (its accelerator from
    `gpu/topology.py`, `nvidia.com/gpu` from torch.cuda.device_count()),
    and a Notebook CR with spec.gpu {that accelerator, 1} and a
    checkpoint store.  Self-healing is on, as by default: the reconciler
    opens the store at the CR's CHECKPOINT_STORE_URI, which the fake
    cluster answers final-snapshot requests into.  The cluster does not
    start containers by itself: `start()` and `ready()` mark the pod
    running once its env is resolved.  `stream` keeps the apiserver's
    events in order (the gang's restore intent, its StatefulSet's restore
    env and replicas, the reconciliation lock, the pod creates and
    deletes), and `cost` each stage's reconciles and wall ms of controller
    work.  The ODH plane runs in the same manager (`OdhConfig` set
    here, so that the run reads no env): the CR carries inject-auth, the
    namespace an odh-trusted-ca-bundle ConfigMap, and `timing` counts
    each controller's reconciles and wall ms and the ODH webhooks'
    admissions and wall ms.  So does the observability plane, with the
    tracing clock on the manager's FakeClock and the profiler sampling:
    `scrape` is one /metrics scrape (the engines evaluate in it) and
    `obs` their wall ms; `observability` gates them at the phase's end
    and `close` stops the profiler."""

    def __init__(self, device_name: str, tmp: Path):
        import torch

        from kubeflow_tpu_torch.api.types import GPUSpec, Notebook
        from kubeflow_tpu_torch.core import constants as K
        from kubeflow_tpu_torch.core.jupyter import FakeJupyterState
        from kubeflow_tpu_torch.gpu import topology
        from kubeflow_tpu_torch.gpu.device_plugin import label_gpu_node
        from kubeflow_tpu_torch.kube import KubeObject, ObjectMeta
        from kubeflow_tpu_torch.main import build_manager
        from kubeflow_tpu_torch.odh import constants as O
        from kubeflow_tpu_torch.utils import tracing
        from kubeflow_tpu_torch.utils.clock import FakeClock
        from kubeflow_tpu_torch.utils.config import CoreConfig, OdhConfig

        self.tmp = tmp
        self.obs = {"scrapes": 0, "scrape_ms": 0.0, "eval_ms": 0.0,
                    "hooks": {}, "verbs": [0, 0.0]}
        # spans on the manager's FakeClock: the lifecycle ledger partitions
        # the event->ready windows of both on one timeline
        self.clock = FakeClock()
        tracing.set_clock(self.clock)
        self.cost = {"reconciles": 0, "wall_ms": 0.0, "stages": {}}
        self.timing: dict = {}
        self.odh: dict = {}
        self.deleted = []
        self.stream = []
        self.accelerator = topology.accelerator_from_device_name(device_name)
        self.gpus = torch.cuda.device_count()
        self.device_name = device_name
        with self.stage("setup"):
            self.jupyter = FakeJupyterState()
            self.jupyter.set_kernels(NB_NAMESPACE, NB_NAME, [{
                "id": "k1", "name": "python3", "execution_state": "idle",
                "last_activity": "2023-01-01T00:00:00Z", "connections": 0}])
            # the gang scheduler on, cold provisioning an hour of
            # FakeClock away: the card is the only capacity there is
            self.cfg = CoreConfig(
                enable_culling=True, cull_idle_time_min=NB_CULL_IDLE_MIN,
                idleness_check_period_min=1,
                checkpoint_store_uri=f"file://{tmp / 'store'}",
                enable_slice_scheduler=True, warmpool_provision_s=3600.0,
                dataplane_mfu_target=NB_MFU_TARGET,
                slo_fleet_mfu=NB_SLO_FLEET_MFU,
                enable_continuous_profiler=True,
                profiler_interval_ms=NB_PROFILER_INTERVAL_MS)
            self.mgr, self.api, self.cluster, self.metrics = build_manager(
                self.cfg, clock=self.clock, jupyter=self.jupyter,
                odh_cfg=OdhConfig(controller_namespace=NB_ODH_NAMESPACE))
            self._time_controllers()
            self._time_engines()
            self.cluster.auto_ready = False
            self.cluster.add_node(NB_NODE,
                                  labels={K.GKE_NODEPOOL_LABEL: NB_POOL},
                                  allocatable={"cpu": "8",
                                               "memory": "96Gi"})
            label_gpu_node(self.api, NB_NODE, gpus=self.gpus,
                           accelerator=self.accelerator)
            self.api.watch(self._on_event, kinds=[
                "Notebook", "StatefulSet", "Pod", K.TENANTQUOTA_KIND])
            self.api.create(KubeObject(
                api_version="v1", kind="ConfigMap",
                metadata=ObjectMeta(name=O.ODH_TRUSTED_CA_BUNDLE_CONFIGMAP,
                                    namespace=NB_NAMESPACE),
                body={"data": {O.TRUSTED_CA_BUNDLE_FILE: NB_CA_PEM}}))
            self.api.create(KubeObject.from_dict(Notebook.new(
                NB_NAME, NB_NAMESPACE, gpu=GPUSpec(self.accelerator, 1),
                priority="low",
                annotations={O.ANNOTATION_INJECT_AUTH: "true"}).obj))
            self.run()
            # the culler wakes on Notebook events only, and its look at
            # the new CR came before the gang gate let the pod exist (the
            # reference's culler waits the same way): a resync of the
            # culler, as a manager's periodic one, lets it see the pod
            self.mgr.enqueue_all("culling")
            self.run()

    def _time_controllers(self) -> None:
        """Count each controller's reconciles and wall ms, and the two ODH
        webhooks' admissions and wall ms (an admission inside a
        reconcile's write counts in both), as they run."""
        def timed(key, fn):
            @functools.wraps(fn)
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    count = self.timing.setdefault(key, [0, 0.0])
                    count[0] += 1
                    count[1] += (time.perf_counter() - t0) * 1e3
            return call

        for reg in self.mgr._registrations:
            reg.reconciler.reconcile = timed(reg.name,
                                             reg.reconciler.reconcile)
        for hook in self.api._mutating + self.api._validating:
            if hook.name in ("mutate-notebook-v1", "validate-notebook-v1"):
                hook.handler = timed("odh-webhooks", hook.handler)

    def _time_engines(self) -> None:
        """Count the engines' per-attempt and per-dispatch hooks, calls
        and wall ms under each observer's name, and the store's client-verb
        accounting (entering and leaving its scope around every get, list
        and write, the read itself left out), as they run."""
        def timed(key, fn):
            @functools.wraps(fn)
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    count = self.obs["hooks"].setdefault(key, [0, 0.0])
                    count[0] += 1
                    count[1] += (time.perf_counter() - t0) * 1e3
            return call

        mgr = self.mgr
        for key, engine, name in (
                ("slo", mgr.slo_engine, "observe_attempt"),
                ("lifecycle", mgr.lifecycle, "observe_attempt"),
                ("metering", mgr.metering, "observe_attempt"),
                ("metering_dispatch", mgr.metering, "observe_dispatch"),
                ("diagnosis", mgr.diagnosis, "observe_attempt")):
            setattr(engine, name, timed(key, getattr(engine, name)))
        scope, verbs = self.api._fault_scope, self.obs["verbs"]

        @contextlib.contextmanager
        def timed_scope(*args):
            t0 = time.perf_counter()
            inner = scope(*args)
            directives = inner.__enter__()
            verbs[1] += (time.perf_counter() - t0) * 1e3
            exc = (None, None, None)
            try:
                yield directives
            except BaseException:
                exc = sys.exc_info()
                raise
            finally:
                t0 = time.perf_counter()
                inner.__exit__(*exc)
                verbs[0] += 1
                verbs[1] += (time.perf_counter() - t0) * 1e3
        self.api._fault_scope = timed_scope

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        before = self.cost["reconciles"]
        try:
            yield
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            self.cost["wall_ms"] += ms
            self.cost["stages"][name] = {
                "reconciles": self.cost["reconciles"] - before, "wall_ms": ms}

    def _on_event(self, ev) -> None:
        from kubeflow_tpu_torch.core import constants as K
        from kubeflow_tpu_torch.odh import constants as O

        obj = ev.obj
        if obj.kind == "Notebook":
            ann = obj.metadata.annotations
            self.stream.append(("lock", obj.name, ann.get(K.STOP_ANNOTATION)
                                == O.RECONCILIATION_LOCK_VALUE))
            if obj.name == NB_REP:
                rep = (obj.body.get("status") or {}).get("replication") \
                    or {}
                self.stream.append((
                    "replication", rep.get("epoch"), rep.get("primary"),
                    (rep.get("promotion") or {}).get("phase")))
            if obj.name == NB_NAME:
                entry = (obj.body.get("status", {}).get("sessionState")
                         or {}).get("0") or {}
                self.stream.append(("intent", entry.get("phase"),
                                    entry.get("restoreGeneration")))
            self.stream.append(("placement", obj.name,
                                K.ANNOTATION_PLACEMENT in ann,
                                K.ANNOTATION_QUEUED in ann))
        elif obj.kind == "StatefulSet":
            env = {e["name"]: e.get("value") for e in
                   obj.spec["template"]["spec"]["containers"][0]["env"]}
            self.stream.append(
                ("sts", env.get(K.ENV_CHECKPOINT_RESTORE_GENERATION),
                 obj.name, ev.type.value, obj.spec.get("replicas")))
        elif obj.kind == K.TENANTQUOTA_KIND:
            # the phase of the write-ahead record naming this CR victim
            st = obj.body.get("status") or {}
            key = f"{NB_NAMESPACE}/{NB_NAME}"
            rec = (st.get("preemptions") or {}).get(key) or next(
                (r for r in reversed(st.get("recentPreemptions") or [])
                 if r.get("victim") == key), {})
            self.stream.append(("record", rec.get("phase")))
        elif ev.type.value == "DELETED":
            self.deleted.append(obj)
            self.stream.append(("deleted", obj.name, obj.metadata.uid))
        elif obj.kind == "Pod" and ev.type.value == "ADDED":
            self.stream.append(("pod", obj.name))

    def run(self, advance_s: float = 0.0) -> None:
        self.cost["reconciles"] += self.mgr.advance(advance_s) \
            if advance_s else self.mgr.run_until_idle()

    def pod(self):
        return self.api.try_get("Pod", NB_NAMESPACE, f"{NB_NAME}-0")

    def scrape(self) -> None:
        """One /metrics scrape: the data-plane rollup, the metering ledger,
        the SLO engine, the TSDB and the diagnosis engine evaluate in it,
        in the reference's order.  A scrape that raises fails the run."""
        t0 = time.perf_counter()
        self.metrics.scrape()
        self.obs["scrape_ms"] += (time.perf_counter() - t0) * 1e3
        self.obs["scrapes"] += 1

    def evaluate(self, fn, *args):
        """An engine's read, its wall ms counted."""
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.obs["eval_ms"] += (time.perf_counter() - t0) * 1e3

    def publish(self, summary: dict) -> None:
        """A TelemetryAgent's `publish_fn`, as the worker's sidecar
        pushes it: the summary onto the card's pod's telemetry
        annotation, an update through the API server."""
        from kubeflow_tpu_torch.runtime.telemetry import (
            TELEMETRY_ANNOTATION,
            annotation_payload,
        )

        pod = self.pod()
        pod.metadata.annotations[TELEMETRY_ANNOTATION] = \
            annotation_payload(summary)
        self.api.update(pod)
        self.obs["published"] = summary

    def dataplane(self) -> dict:
        """The CR's four data-plane gauges."""
        reg = self.metrics.registry
        return {k: reg.get(f"notebook_dataplane_{k}").value(NB_NAMESPACE,
                                                            NB_NAME)
                for k in ("tokens_per_second", "mfu_ratio",
                          "step_time_seconds", "straggler")}

    def mfu_checks(self) -> dict:
        checks = self.metrics.registry.get(
            "notebook_dataplane_mfu_checks_total")
        return {r: checks.value(r) for r in ("low", "ok")}

    def telemetry(self, agent) -> dict:
        """The card's MFU reaches the controller: `agent` (run A's)
        publishes its summary onto the running pod through `publish`, and
        one scrape rolls it up.  Gates: the three gauges equal the
        summary's numbers exactly, the straggler gauge reads 0 (one
        worker is below min_workers) and the MFU verdict counter moved by
        one under its verdict against DATAPLANE_MFU_TARGET."""
        self.scrape()  # the metering ledger opens the gang's meter
        before = self.mfu_checks()
        agent.publish_fn = self.publish
        agent.publish_now()
        self.scrape()
        summary = self.obs["published"]
        got = self.dataplane()
        after = self.mfu_checks()
        verdict = "low" if summary["mfu"] < self.cfg.dataplane_mfu_target \
            else "ok"
        moved = {r: after[r] - before[r] for r in after}
        out = {"gauges": got, "verdict": verdict, "checks_moved": moved}
        self.obs["telemetry"] = out
        want = {"tokens_per_second": summary["tokens_per_s"],
                "mfu_ratio": summary["mfu"],
                "step_time_seconds": summary["step_time_s"],
                "straggler": 0.0}
        if got != want or moved != {r: float(r == verdict)
                                    for r in ("low", "ok")}:
            raise RuntimeError(f"observability: the gauges {got} against "
                               f"the summary's {want}, MFU checks moved "
                               f"{moved} for verdict {verdict}")
        return out

    def status(self) -> dict:
        return self.api.get("Notebook", NB_NAMESPACE, NB_NAME).status

    def resolve(self, pod) -> dict:
        """`pod`'s main container (the one named after its notebook, as
        the ODH webhook finds it) env resolved as the kubelet would from
        the pod object itself (its pod-index label among them): the
        master's DNS name as 127.0.0.1, its rendered port 29500 as a free
        one (29500 may be taken on this host), each volume mount a
        directory under the phase's temporary directory, holding the
        files of a ConfigMap volume's ConfigMap (the CA bundle's among
        them), and a path under a mount mapped into its directory."""
        from kubeflow_tpu_torch.core import constants as K
        from kubeflow_tpu_torch.gpu import env as gpuenv

        headless = self.api.get("Service", NB_NAMESPACE,
                                gpuenv.headless_service_name(NB_NAME))
        name = pod.metadata.labels[K.NOTEBOOK_NAME_LABEL]
        main = next(c for c in pod.spec["containers"]
                    if c["name"] == name)
        env = gpuenv.resolve_env(main["env"], {
            "name": pod.name, "namespace": pod.namespace,
            "labels": pod.metadata.labels,
            "annotations": pod.metadata.annotations})
        volumes = {v["name"]: v for v in pod.spec.get("volumes") or []}
        mounts = {m["mountPath"]: self.tmp / "pod" / m["name"]
                  for m in main["volumeMounts"]}
        for m in main["volumeMounts"]:
            path = mounts[m["mountPath"]]
            path.mkdir(parents=True, exist_ok=True)
            source = (volumes.get(m["name"]) or {}).get("configMap")
            cm = source and self.api.try_get("ConfigMap", pod.namespace,
                                             source["name"])
            if cm:
                data = cm.body.get("data") or {}
                items = source.get("items") or [
                    {"key": k, "path": k} for k in data]
                for item in items:
                    (path / item["path"]).write_text(data[item["key"]])

        def mapped(value: str) -> str:
            for mount, path in mounts.items():
                if value == mount or value.startswith(mount + "/"):
                    return str(path) + value[len(mount):]
            return value
        env = {k: mapped(v) for k, v in env.items()}
        rendered_port = env["PET_MASTER_PORT"]
        env.update(PET_MASTER_ADDR="127.0.0.1",
                   PET_MASTER_PORT=str(_free_port()))
        return {"accelerator": self.accelerator,
                "resources": main["resources"],
                "headless_ports": headless.spec["ports"],
                "node_selector": pod.spec["nodeSelector"],
                "node": pod.spec.get("nodeName"),
                "env_names": [e["name"] for e in main["env"]],
                "pre_stop": main["lifecycle"]["preStop"]["exec"]["command"],
                "rendered_master_port": rendered_port,
                "signal_dir": Path(env[K.ENV_CHECKPOINT_SIGNAL_DIR]),
                "podinfo": mounts[K.PODINFO_MOUNT], "env": env}

    def start(self) -> dict:
        """The pod the controller made, its env resolved, then started;
        the gates of the render and of the placement."""
        from kubeflow_tpu_torch.core import constants as K
        from kubeflow_tpu_torch.gpu import topology
        from kubeflow_tpu_torch.runtime.roofline import GPU_PEAKS

        sets = self.api.list("StatefulSet", namespace=NB_NAMESPACE)
        pod = self.pod()
        bad = []
        if [(s.name, s.spec["replicas"]) for s in sets] != [(NB_NAME, 1)]:
            bad.append(f"StatefulSets {[(s.name, s.spec['replicas']) for s in sets]}")
        if pod is None:
            raise RuntimeError("controller: no pod " + "; ".join(bad))
        rendered = self.resolve(pod)
        env, main = rendered["env"], pod.spec["containers"][0]
        health_before = self.status().get("sliceHealth")
        with self.stage("start"):
            self.cluster.mark_running(NB_NAMESPACE, pod.name)
            self.run()
        node = self.api.get("Node", "", NB_NODE)
        used = self.cluster.node_used(NB_NODE).get(K.GPU_RESOURCE)
        allocatable = node.status["allocatable"].get(K.GPU_RESOURCE)
        row = topology.ACCELERATORS[self.accelerator]
        peak = GPU_PEAKS.get(self.device_name)
        gpus = {kind: main["resources"][kind].get(K.GPU_RESOURCE)
                for kind in ("requests", "limits")}
        # the gang scheduler placed the gang before its StatefulSet asked
        # for a pod: the intent's Notebook update precedes the first
        # StatefulSet event of 1 replica on the apiserver's stream (the
        # reconciliation lock renders it at 0 replicas first)
        placed_at = next((i for i, e in enumerate(self.stream)
                          if e[:3] == ("placement", NB_NAME, True)), None)
        sts_at = next((i for i, e in enumerate(self.stream)
                       if e[0] == "sts" and e[4]), None)
        intent = json.loads(self.api.get(
            "Notebook", NB_NAMESPACE, NB_NAME).metadata.annotations.get(
                K.ANNOTATION_PLACEMENT, "{}"))
        claims = {r: self.metrics.warmpool_hits.value(r)
                  for r in ("hit", "miss", "bypass")}
        print(f"controller: pod {pod.name} on {rendered['node']} "
              f"({node.metadata.labels}), nvidia.com/gpu {used:g} used of "
              f"{allocatable}; resources {main['resources']}; nodeSelector "
              f"{rendered['node_selector']}; env {rendered['env_names']}; "
              f"sliceHealth {health_before} -> "
              f"{self.status().get('sliceHealth')}; placement intent "
              f"{intent} at event {placed_at}, first StatefulSet event "
              f"{sts_at}; warm-pool claims {claims}", flush=True)
        if placed_at is None or sts_at is None or not placed_at < sts_at \
                or intent.get("slices", {}).get("0", {}).get("nodes") \
                != [NB_NODE]:
            bad.append(f"placement intent {intent} at event {placed_at}, "
                       f"first StatefulSet event {sts_at}")
        if rendered["node_selector"].get(K.GKE_NODEPOOL_LABEL) != NB_POOL:
            bad.append(f"nodeSelector {rendered['node_selector']} names "
                       f"no pool {NB_POOL}")
        if claims != {"hit": 0.0, "miss": 0.0, "bypass": 1.0}:
            bad.append(f"warm-pool claims {claims}")
        if gpus != {"requests": "1", "limits": "1"}:
            bad.append(f"nvidia.com/gpu {gpus}")
        if peak is None or row.bf16_peak_tflops != peak.bf16_tflops \
                or row.hbm_gbps != peak.hbm_gbps:
            bad.append(f"the table's {self.accelerator} peak {row} is not "
                       f"GPU_PEAKS' {peak}")
        if (env["PET_NNODES"], env["PET_NPROC_PER_NODE"],
                env["PET_NODE_RANK"], rendered["rendered_master_port"]) \
                != ("1", "1", "0", "29500"):
            bad.append(f"env {env}, rendered PET_MASTER_PORT "
                       f"{rendered['rendered_master_port']}")
        if (rendered["node"], used, allocatable) != (NB_NODE, 1,
                                                     str(self.gpus)):
            bad.append(f"pod on {rendered['node']}, nvidia.com/gpu {used} "
                       f"used of {allocatable}")
        if node.metadata.labels.get(K.GKE_GPU_ACCELERATOR_LABEL) \
                != row.gke_label:
            bad.append(f"node labels {node.metadata.labels}")
        if (health_before, self.status().get("sliceHealth")) != \
                ("Unhealthy", "Healthy"):
            bad.append(f"sliceHealth {health_before} -> "
                       f"{self.status().get('sliceHealth')}")
        if bad:
            raise RuntimeError("controller: " + "; ".join(bad))
        self.odh["admitted"] = self._odh_admitted(pod)
        self.generation = self.api.get(
            "Notebook", NB_NAMESPACE, NB_NAME).metadata.generation
        return rendered

    def _odh_objects(self, name: str) -> dict:
        """The ODH plane's objects of the CR `name`, each with its owner
        (the kind and name of its controller reference, or None), and
        the kube-rbac-proxy Service's selector."""
        from kubeflow_tpu_torch.odh import constants as O

        nb = self.api.get("Notebook", NB_NAMESPACE, name)

        def owner(obj):
            if obj is None:
                return "missing"
            ref = obj.metadata.controller_owner()
            if ref is None:
                return None
            return (ref.kind, ref.name, ref.uid == nb.metadata.uid)

        wanted = {
            ("HTTPRoute", NB_ODH_NAMESPACE, f"nb-{NB_NAMESPACE}-{name}"),
            ("ReferenceGrant", NB_NAMESPACE, O.REFERENCEGRANT_NAME),
            ("ClusterRoleBinding", "",
             f"{name}-rbac-{NB_NAMESPACE}-auth-delegator"),
            ("ServiceAccount", NB_NAMESPACE, name),
            ("Service", NB_NAMESPACE, name + O.KUBE_RBAC_PROXY_SERVICE_SUFFIX),
            ("ConfigMap", NB_NAMESPACE, name + O.KUBE_RBAC_PROXY_CONFIG_SUFFIX),
            ("ConfigMap", NB_NAMESPACE,
             O.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP),
            ("NetworkPolicy", NB_NAMESPACE, f"{name}-ctrl-np"),
            ("NetworkPolicy", NB_NAMESPACE,
             name + O.KUBE_RBAC_PROXY_NETWORK_POLICY_SUFFIX),
            ("NetworkPolicy", NB_NAMESPACE, f"{name}-gpu-workers-np")}
        out = {f"{kind}/{n}": owner(self.api.try_get(kind, ns, n))
               for kind, ns, n in sorted(wanted)}
        route = self.api.try_get("HTTPRoute", NB_ODH_NAMESPACE,
                                 f"nb-{NB_NAMESPACE}-{name}")
        proxy = self.api.try_get("Service", NB_NAMESPACE,
                                 name + O.KUBE_RBAC_PROXY_SERVICE_SUFFIX)
        return {"owners": out,
                "backend": route and route.spec["rules"][0]["backendRefs"][0],
                "proxy_selector": proxy and proxy.spec["selector"],
                "finalizers": list(nb.metadata.finalizers)}

    def _odh_pod(self, pod) -> dict:
        """What the ODH webhook put into `pod`: the kube-rbac-proxy
        sidecar, the ServiceAccount, and the CA bundle's volume, mount
        and env, resolved."""
        from kubeflow_tpu_torch.odh import constants as O

        containers = {c["name"]: c for c in pod.spec["containers"]}
        main = containers[pod.metadata.labels["notebook-name"]]
        sidecar = containers.get(O.KUBE_RBAC_PROXY_CONTAINER_NAME) or {}
        volumes = {v["name"]: v for v in pod.spec.get("volumes") or []}
        env = self.resolve(pod)["env"]
        files = {k: Path(env[k]) for k in O.CA_BUNDLE_ENV_VARS if k in env}
        bundle = self.api.get(
            "ConfigMap", NB_NAMESPACE, O.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP
        ).body["data"][O.TRUSTED_CA_BUNDLE_FILE]
        return {
            "containers": sorted(containers),
            "sidecar_ports": [p["containerPort"]
                              for p in sidecar.get("ports") or []],
            "service_account": pod.spec.get("serviceAccountName"),
            "ca_volume": (volumes.get(O.TRUSTED_CA_BUNDLE_VOLUME) or {}).get(
                "configMap", {}).get("name"),
            "ca_mount": [m["mountPath"] for m in main["volumeMounts"]
                         if m["name"] == O.TRUSTED_CA_BUNDLE_VOLUME],
            "ca_env": sorted(files),
            "ca_files_equal_bundle": bool(files) and all(
                f.is_file() and f.read_text() == bundle
                for f in files.values()),
            "bundle_is_the_pem": bundle == NB_CA_PEM}

    def _odh_admitted(self, pod) -> dict:
        """The ODH plane's gates on the CR's first pod: the lock stamped
        on create and lifted before the StatefulSet asked for a pod; the
        sidecar; the route to the proxy on :8443, the ReferenceGrant, the
        ClusterRoleBinding and the three NetworkPolicies, owned as the
        reference owns them; the CA bundle built from the namespace's
        PEM in the reconcile that lifted the lock, and so held back from
        this pod by the webhook's restart blocking (update-pending),
        until a restart lets it through."""
        from kubeflow_tpu_torch.odh import constants as O

        def first(pred):
            return next((i for i, e in enumerate(self.stream) if pred(e)),
                        None)

        order = {
            "lock_stamped": first(lambda e: e == ("lock", NB_NAME, True)),
            "lock_lifted": first(lambda e: e == ("lock", NB_NAME, False)),
            "statefulset_of_1": first(lambda e: e[0] == "sts"
                                      and e[2] == NB_NAME and e[4]),
            "pod": first(lambda e: e == ("pod", f"{NB_NAME}-0"))}
        nb = self.api.get("Notebook", NB_NAMESPACE, NB_NAME)
        out = {"order": order, **self._odh_objects(NB_NAME),
               "pod": self._odh_pod(pod),
               "update_pending": nb.metadata.annotations.get(
                   O.ANNOTATION_UPDATE_PENDING, "")}
        bad = []
        # (the fake cluster makes the pod inside the StatefulSet's write,
        # so the pod's event may reach the stream before the write's)
        if None in order.values() or not (
                order["lock_stamped"] < order["lock_lifted"]
                < min(order["statefulset_of_1"], order["pod"])) \
                or O.STOP_ANNOTATION in nb.metadata.annotations:
            bad.append(f"the lock's order {order}")
        cr = ("Notebook", NB_NAME, True)
        want_owners = {
            f"ClusterRoleBinding/{NB_NAME}-rbac-{NB_NAMESPACE}-"
            f"auth-delegator": None,
            f"ConfigMap/{NB_NAME}{O.KUBE_RBAC_PROXY_CONFIG_SUFFIX}": cr,
            f"ConfigMap/{O.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP}": None,
            f"HTTPRoute/nb-{NB_NAMESPACE}-{NB_NAME}": None,
            f"NetworkPolicy/{NB_NAME}-ctrl-np": cr,
            f"NetworkPolicy/{NB_NAME}-gpu-workers-np": cr,
            f"NetworkPolicy/{NB_NAME}{O.KUBE_RBAC_PROXY_NETWORK_POLICY_SUFFIX}":
                cr,
            f"ReferenceGrant/{O.REFERENCEGRANT_NAME}": None,
            f"Service/{NB_NAME}{O.KUBE_RBAC_PROXY_SERVICE_SUFFIX}": cr,
            f"ServiceAccount/{NB_NAME}": cr}
        if out["owners"] != want_owners:
            bad.append(f"objects and owners {out['owners']}")
        if out["backend"] != {"name": NB_NAME
                              + O.KUBE_RBAC_PROXY_SERVICE_SUFFIX,
                              "namespace": NB_NAMESPACE,
                              "port": O.KUBE_RBAC_PROXY_PORT}:
            bad.append(f"the HTTPRoute's backend {out['backend']}")
        if sorted(out["finalizers"]) != sorted([
                O.HTTPROUTE_FINALIZER, O.REFERENCEGRANT_FINALIZER,
                O.KUBE_RBAC_PROXY_FINALIZER]):
            bad.append(f"finalizers {out['finalizers']}")
        odh_pod = out["pod"]
        if (odh_pod["containers"], odh_pod["sidecar_ports"],
                odh_pod["service_account"]) != (
                sorted([NB_NAME, O.KUBE_RBAC_PROXY_CONTAINER_NAME]),
                [O.KUBE_RBAC_PROXY_PORT], NB_NAME):
            bad.append(f"the pod's sidecar {odh_pod}")
        if odh_pod["ca_volume"] or odh_pod["ca_env"] \
                or not odh_pod["bundle_is_the_pem"] \
                or "PIP_CERT" not in out["update_pending"]:
            bad.append(f"the CA bundle on the first pod {odh_pod}, "
                       f"update-pending {out['update_pending']!r}")
        print(f"odh admitted: lock stamped at event "
              f"{order['lock_stamped']}, lifted at {order['lock_lifted']}, "
              f"StatefulSet of 1 replica at {order['statefulset_of_1']}, "
              f"pod at {order['pod']}; objects {out['owners']}; route "
              f"backend {out['backend']}; pod {odh_pod}; update-pending "
              f"{out['update_pending'][:80]!r}", flush=True)
        if bad:
            raise RuntimeError("odh: " + "; ".join(bad))
        return out

    def cull(self) -> dict:
        """Time passes beyond the idle limit with the kernel idle: the
        culler stops the notebook, and the notebook controller takes the
        gang down.  Returns the deleted pod, resolved (its preStop
        command is what the kubelet runs)."""
        from kubeflow_tpu_torch.core import constants as K

        # the gang runs one FakeClock second first, and a scrape then
        # lets the metering ledger accrue that interval in "ready" (a
        # meter that leaves the census is closed without its last one)
        with self.stage("idle"):
            self.run(advance_s=1.0)
        self.scrape()
        with self.stage("cull"):
            self.run(advance_s=(NB_CULL_IDLE_MIN + 1) * 60 - 1.0)
        annotations = self.api.get("Notebook", NB_NAMESPACE,
                                   NB_NAME).metadata.annotations
        sts = self.api.get("StatefulSet", NB_NAMESPACE, NB_NAME)
        # the cull is not a disruption: no recovery attempt is charged
        charged = (self.status().get("sliceRecovery"),
                   sum(self.metrics.slice_restarts.collect().values()))
        culled = (K.STOP_ANNOTATION in annotations,
                  self.metrics.culling.value(NB_NAMESPACE, NB_NAME),
                  sts.spec["replicas"], self.pod() is None,
                  [p.name for p in self.deleted],
                  self.status().get("sliceHealth"), charged)
        print(f"controller: culled after {NB_CULL_IDLE_MIN + 1} idle "
              f"minutes: stop annotation, cullings, replicas, pod gone, "
              f"pods deleted, sliceHealth, (sliceRecovery, gang restarts) "
              f"{culled}", flush=True)
        if culled != (True, 1.0, 0, True, [f"{NB_NAME}-0"], "Stopped",
                      (None, 0)):
            raise RuntimeError(f"controller: the cull gave {culled}")
        # the stopped gang's claim went back and its intent retired, so
        # that the unstop places it afresh
        if K.ANNOTATION_PLACEMENT in annotations or \
                self.metrics.schedule_attempts.value("released") != 1:
            raise RuntimeError("controller: the culled gang's placement "
                               "was not released")
        # the pod and its telemetry are gone: the next scrape zeroes the
        # gauges and closes the meter, which accrued in "ready" only
        self.scrape()
        gauges = self.dataplane()
        row = self.mgr.metering.tenant_table().get(NB_NAMESPACE) or {}
        chip_s = row.get("chip_seconds") or {}
        self.obs["after_cull"] = {"gauges": gauges, "chip_seconds": chip_s}
        if any(gauges.values()) or set(chip_s) != {"ready"} \
                or not chip_s["ready"] > 0:
            raise RuntimeError(f"observability: after the cull the gauges "
                               f"{gauges}, the namespace's chip-seconds "
                               f"{chip_s}")
        return self.resolve(self.deleted[-1])

    def unstop(self, before: dict) -> dict:
        """Remove the stop annotation: the controller recreates the pod,
        which must get the same rendered env and checkpoint contract, and
        now the CA bundle, which the cull's stop let through."""
        from kubeflow_tpu_torch.core import constants as K
        from kubeflow_tpu_torch.odh import constants as O

        with self.stage("unstop"):
            nb = self.api.get("Notebook", NB_NAMESPACE, NB_NAME)
            nb.metadata.annotations.pop(K.STOP_ANNOTATION)
            self.api.update(nb)
            self.run()
            pod = self.pod()
            if pod is not None:
                self.cluster.mark_running(NB_NAMESPACE, pod.name)
                self.run()
        if pod is None:
            raise RuntimeError("controller: no pod after the unstop")
        self.scrape()
        after = self.resolve(pod)
        same = {k: after[k] == before[k]
                for k in ("pre_stop", "node", "resources")}
        # the env but the master port, which each resolve maps afresh, and
        # the CA bundle's, which the restart added
        fresh = {"PET_MASTER_PORT", *O.CA_BUNDLE_ENV_VARS}
        same["env_names"] = [n for n in after["env_names"]
                             if n not in fresh] == \
            [n for n in before["env_names"] if n not in fresh]
        same["env"] = {k: v for k, v in after["env"].items()
                       if k not in fresh} == \
            {k: v for k, v in before["env"].items() if k not in fresh}
        # an unstopped notebook restores nothing: no restore stamp
        same["no_restore_stamp"] = not any(
            k in pod.metadata.annotations
            for k in (K.ANNOTATION_RESTORED_GENERATION,
                      K.ANNOTATION_RESTORED_DIGEST))
        health = self.status().get("sliceHealth")
        print(f"controller: recreated {pod.name} on {after['node']}, "
              f"same as before {same}, sliceHealth {health}", flush=True)
        if not all(same.values()) or health != "Healthy":
            raise RuntimeError(f"controller: the recreated pod differs "
                               f"{same}, or its health is {health}")
        # the pending update went through at the cull's stop: the
        # recreated pod carries the CA bundle, its env naming files whose
        # bytes are the bundle's
        odh_pod = self._odh_pod(pod)
        pending = self.api.get("Notebook", NB_NAMESPACE, NB_NAME
                               ).metadata.annotations.get(
                                   O.ANNOTATION_UPDATE_PENDING)
        self.odh["restarted"] = {"pod": odh_pod, "update_pending": pending}
        print(f"odh restarted: pod {odh_pod}, update-pending {pending!r}",
              flush=True)
        if (odh_pod["ca_volume"], odh_pod["ca_mount"], odh_pod["ca_env"],
                odh_pod["ca_files_equal_bundle"],
                odh_pod["sidecar_ports"], pending) != (
                O.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP,
                [O.TRUSTED_CA_MOUNT_PATH], sorted(O.CA_BUNDLE_ENV_VARS),
                True, [O.KUBE_RBAC_PROXY_PORT], None):
            raise RuntimeError(f"odh: the recreated pod {odh_pod}, "
                               f"update-pending {pending!r}")
        return after

    def busy(self) -> None:
        """The kernel runs the training loop: busy, so the culler leaves
        the notebook alone while the drills move the FakeClock."""
        self.jupyter.set_kernels(NB_NAMESPACE, NB_NAME, [{
            "id": "k1", "name": "python3", "execution_state": "busy",
            "last_activity": "2023-01-01T00:00:00Z", "connections": 1}])

    def store(self):
        """The CR's session store, opened at its CHECKPOINT_STORE_URI as a
        pod's sidecar opens it."""
        from kubeflow_tpu_torch.core.sessionstate import open_store

        return open_store(self.cfg.checkpoint_store_uri)

    def _recreated(self, start: int, before, trigger: str) -> dict:
        """The gates of a migration the engine just ran: the restore
        intent in status.sessionState before the StatefulSet's restore env
        before the pod delete (the apiserver's event stream), the pod
        recreated on the card's node with its GPU, and the restore stamp
        of the snapshot the intent names."""
        from kubeflow_tpu_torch.core import constants as K

        pod, status = self.pod(), self.status()
        intent = (status.get("sessionState") or {}).get("0") or {}
        gen = intent.get("restoreGeneration")
        stream = self.stream[start:]

        def first(pred):
            return next((i for i, e in enumerate(stream) if pred(e)), None)

        # the intent lands before the pod delete, and the StatefulSet
        # names the intent's generation when the pod goes
        order = [first(lambda e: e[:3] == ("intent", "migrating", gen)),
                 first(lambda e: e == ("deleted", before.name,
                                       before.metadata.uid))]
        sts_at_delete = None if order[1] is None else next(
            (e[1] for e in reversed(stream[:order[1]]) if e[0] == "sts"),
            None)
        sts = self.api.get("StatefulSet", NB_NAMESPACE, NB_NAME)
        env = {e["name"]: e.get("value") for e in
               sts.spec["template"]["spec"]["containers"][0]["env"]}
        snap = self.store().info(NB_NAMESPACE, NB_NAME, 0, gen) \
            if gen is not None else None
        ann = pod.metadata.annotations if pod is not None else {}
        out = {
            "trigger": trigger, "generation": gen,
            "intent": intent.get("phase"), "order": order,
            "sts_generation_at_delete": sts_at_delete,
            "restore_env": [env.get(K.ENV_CHECKPOINT_RESTORE_URI),
                            env.get(K.ENV_CHECKPOINT_RESTORE_GENERATION)],
            "recreated": pod is not None
            and pod.metadata.uid != before.metadata.uid,
            "node": pod.spec.get("nodeName") if pod is not None else None,
            "gpus_used": self.cluster.node_used(NB_NODE).get(K.GPU_RESOURCE),
            "stamp": [ann.get(K.ANNOTATION_RESTORED_GENERATION),
                      ann.get(K.ANNOTATION_RESTORED_DIGEST)],
            "snapshot": None if snap is None else {
                "generation": snap.generation, "trigger": snap.trigger,
                "digest": snap.digest, "size": snap.size},
            "recovery": status.get("sliceRecovery"),
            "migrate_annotation": K.ANNOTATION_MIGRATE in self.api.get(
                "Notebook", NB_NAMESPACE, NB_NAME).metadata.annotations,
        }
        bad = []
        if None in order or order != sorted(order) or \
                sts_at_delete != str(gen):
            bad.append(f"intent and pod delete at {order} of the event "
                       f"stream, the StatefulSet's generation then "
                       f"{sts_at_delete}")
        if snap is None or out["stamp"] != [str(gen), snap.digest]:
            bad.append(f"stamp {out['stamp']} against {out['snapshot']}")
        if out["restore_env"] != [intent.get("restoreUri"), str(gen)]:
            bad.append(f"StatefulSet restore env {out['restore_env']}")
        if not out["recreated"] or (out["node"], out["gpus_used"]) != \
                (NB_NODE, 1):
            bad.append(f"pod recreated {out['recreated']} on "
                       f"{out['node']}, nvidia.com/gpu {out['gpus_used']}")
        if intent.get("phase") != "migrating" or \
                intent.get("trigger") != trigger or out["migrate_annotation"]:
            bad.append(f"intent {intent}, migrate annotation "
                       f"{out['migrate_annotation']}")
        if bad:
            raise RuntimeError(f"controller: the {trigger} migration: "
                               + "; ".join(bad))
        return out

    def migrate(self, payload: bytes) -> dict:
        """Drill 1: the gang's state is `payload`; the migrate annotation
        (drain) makes the engine take a final snapshot, write the intent,
        stamp the StatefulSet and delete the pod, which the cluster
        recreates with the restore env and stamp."""
        from kubeflow_tpu_torch.core import constants as K

        self.cluster.set_session_payload(NB_NAMESPACE, NB_NAME, payload)
        before, start = self.pod(), len(self.stream)
        with self.stage("migrate"):
            nb = self.api.get("Notebook", NB_NAMESPACE, NB_NAME)
            nb.metadata.annotations[K.ANNOTATION_MIGRATE] = "drain"
            self.api.update(nb)
            self.run()
        return self._recreated(start, before, "drain")

    def kill_card(self) -> dict:
        """Drill 2: the card falls off the bus (the kubelet fails the pod,
        GPUUnhealthy).  The gang cannot flush, so the engine migrates with
        the freshest stored snapshot once the backoff its last migration
        armed has run out on the FakeClock."""
        before, start = self.pod(), len(self.stream)
        with self.stage("dead_card"):
            self.cluster.fail_pod(NB_NAMESPACE, before.name, "GPUUnhealthy")
            # the engine's own store, whose handler is the cluster's
            final = self.cluster.session_store.request_final_snapshot(
                NB_NAMESPACE, NB_NAME, 0)
            self.run()
            self.run(advance_s=self.cfg.recovery_backoff_base_s)
        out = self._recreated(start, before, "failure")
        out["final_snapshot_of_dead_card"] = final
        state = (out["recovery"] or {}).get("0") or {}
        if final is not None or state.get("reason") != "pod-failed" \
                or not state.get("disruptedAt"):
            raise RuntimeError(f"controller: the dead card answered a "
                               f"final snapshot {final}, or the engine "
                               f"recorded {state}")
        return out

    def ready(self, trigger: str) -> dict:
        """The restored pod's containers run: the engine closes the
        migration (MigrationComplete, sessionState restored)."""
        from kubeflow_tpu_torch.core import constants as K

        with self.stage(f"ready_{trigger}"):
            self.cluster.mark_running(NB_NAMESPACE, self.pod().name)
            self.run()
        self.scrape()
        status = self.status()
        complete = sum(
            e.body.get("count", 1) for e in self.api.list(
                "Event", namespace=NB_NAMESPACE)
            if e.body.get("reason") == "MigrationComplete")
        out = {"health": status.get("sliceHealth"),
               "intent": ((status.get("sessionState") or {}).get("0")
                          or {}).get("phase"),
               "migration_complete_events": complete,
               "restored": self.metrics.migrations.value(trigger, "restored"),
               "migrate_annotation": K.ANNOTATION_MIGRATE in self.api.get(
                   "Notebook", NB_NAMESPACE, NB_NAME).metadata.annotations}
        if (out["health"], out["intent"], out["restored"],
                out["migrate_annotation"]) != ("Healthy", "restored", 1.0,
                                               False):
            raise RuntimeError(f"controller: after the {trigger} restore "
                               f"{out}")
        return out


    def observability(self, smi: str) -> dict:
        """The phase's end, read through the engines: the lifecycle and
        metering ledgers conserve, the SLO verdicts cover every default
        objective, explain names the promotion, the TSDB kept every
        scrape, and the profiler and the engines stayed cheap.  Prints
        the `observability` line; raises on a failed gate."""
        from kubeflow_tpu_torch.utils.slo import default_objectives

        mgr, bad = self.mgr, []
        ledger, metering, engine = mgr.lifecycle, mgr.metering, \
            mgr.slo_engine
        first = self.evaluate(ledger.entry, NB_NAMESPACE, NB_NAME,
                              self.generation)
        cons = self.evaluate(ledger.conservation)
        ranking = self.evaluate(ledger.ranking)
        mcons = self.evaluate(metering.conservation)
        chip_s = (self.evaluate(metering.tenant_table).get(NB_NAMESPACE)
                  or {}).get("chip_seconds")
        verdicts = self.evaluate(engine.verdicts)
        fleet_mfu = next(o for o in engine.objectives
                         if o.name == "fleet_mfu")
        good, bad_mfu = self.evaluate(engine._totals, fleet_mfu)
        checks = self.mfu_checks()
        explained = {name: self.evaluate(mgr.diagnosis.explain,
                                         NB_NAMESPACE, name)
                     for name in (NB_NAME, NB_REP)}
        causes = {name: (ex["candidates"][0]["cause"],
                         ex["candidates"][0]["score"])
                  for name, ex in explained.items()}
        tsdb = mgr.tsdb
        series = {name: [v for _, v in tsdb.query(name)["points"]]
                  for name in ("promotions_delta", "criticalpath_violations",
                               "metering_violations")}
        profiler = mgr.profiler
        overhead = profiler.overhead_ratio()
        profile = profiler.snapshot()
        top = list(profile["by_controller_phase"].items())[:4]
        hook_ms = sum(ms for _, ms in self.obs["hooks"].values())
        verb_ms = self.obs["verbs"][1]
        engines_s = (self.obs["scrape_ms"] + self.obs["eval_ms"] + hook_ms
                     + verb_ms) / 1e3 + profiler._busy_s
        if not (first or {}).get("finalized"):
            bad.append(f"the CR's first start {first}")
        if cons["violations"] or mcons["violations"]:
            bad.append(f"conservation: lifecycle {cons}, metering {mcons}")
        if set(verdicts) != {o.name for o in default_objectives(self.cfg)} \
                or "fleet_mfu" not in verdicts \
                or (good, bad_mfu) != (checks["ok"], checks["low"]):
            bad.append(f"SLO verdicts {sorted(verdicts)}, fleet_mfu good "
                       f"{good} and bad {bad_mfu} against the checks "
                       f"{checks}")
        if causes[NB_REP][0] != "primary_failover" or \
                causes[NB_REP][1] < 10:
            bad.append(f"explain of {NB_REP}: {explained[NB_REP]}")
        if any(len(v) != self.obs["scrapes"] for v in series.values()) or \
                sum(series["promotions_delta"]) != 1 or \
                any(series["criticalpath_violations"]) or \
                any(series["metering_violations"]):
            bad.append(f"TSDB series {series} over {self.obs['scrapes']} "
                       f"scrapes")
        if not overhead < NB_PROFILER_MAX_OVERHEAD:
            bad.append(f"profiler overhead {overhead}")
        if mgr.observer_errors:
            bad.append(f"observers raised {mgr.observer_errors}")
        if not engines_s < NB_ENGINES_MAX_S:
            bad.append(f"the engines took {engines_s:.3f} s")
        published, tel = self.obs["published"], self.obs["telemetry"]
        out = {
            "gauges": tel["gauges"], "after_cull": self.obs["after_cull"],
            "summary": {k: published[k] for k in
                        ("tokens_per_s", "mfu", "step_time_s")},
            "mfu_verdict": tel["verdict"], "mfu_checks": checks,
            "first_start": first, "lifecycle_conservation": cons,
            # FakeClock seconds: simulated, not measured
            "fakeclock_stages": {r["stage"]: r["total_s"]
                                 for r in ranking[:5]},
            "metering_conservation": mcons,
            "fakeclock_chip_seconds": chip_s,
            "slo_verdicts": verdicts,
            "first_causes": causes,
            "tsdb_points": {k: len(v) for k, v in series.items()},
            "profiler_overhead_ratio": overhead,
            "profiler_passes": profiler.passes,
            "profiler_top": dict(top),
            "scrapes": self.obs["scrapes"],
            "scrape_ms": self.obs["scrape_ms"],
            "eval_ms": self.obs["eval_ms"],
            "profiler_ms": profiler._busy_s * 1e3,
            "hooks": {k: {"calls": n, "ms": ms}
                      for k, (n, ms) in self.obs["hooks"].items()},
            "hook_ms": hook_ms,
            "verb_accounting": {"calls": self.obs["verbs"][0],
                                "ms": verb_ms},
            "observer_errors": dict(mgr.observer_errors),
            "engines_s": engines_s, "nvidia_smi": smi,
        }
        g, sm = tel["gauges"], out["summary"]
        print(f"observability: data plane tokens/s "
              f"{g['tokens_per_second']}, MFU {g['mfu_ratio']}, step time "
              f"{g['step_time_seconds']} s, straggler {g['straggler']} "
              f"(the agent's summary: tokens_per_s {sm['tokens_per_s']}, "
              f"mfu {sm['mfu']}, step_time_s {sm['step_time_s']}; MFU "
              f"check {tel['verdict']} against {self.cfg.dataplane_mfu_target}"
              f"), after the cull {self.obs['after_cull']['gauges']}; "
              f"lifecycle top stages (FakeClock, simulated s) "
              f"{out['fakeclock_stages']}, conservation {cons['finalized']} "
              f"finalized, {cons['violations']} violations; namespace "
              f"{NB_NAMESPACE} chip-seconds by bucket (FakeClock) {chip_s}, "
              f"metering conservation {mcons['checked']} checked, "
              f"{mcons['violations']} violations; SLO verdicts "
              f"{ {k: v['met'] for k, v in verdicts.items()} }; first "
              f"causes {causes}; profiler overhead {overhead:.5f} over "
              f"{profiler.passes} passes, top (controller/phase, samples) "
              f"{top}; engines' wall ms: {self.obs['scrapes']} scrapes "
              f"{self.obs['scrape_ms']:.2f}, evaluations "
              f"{self.obs['eval_ms']:.2f}, profiler sampling "
              f"{profiler._busy_s * 1e3:.2f}, per-attempt and dispatch "
              f"hooks {hook_ms:.2f} "
              f"({ {k: round(ms, 2) for k, (_, ms) in self.obs['hooks'].items()} }"
              f"), the store's verb accounting {verb_ms:.2f} over "
              f"{self.obs['verbs'][0]} calls, {engines_s:.3f} s in all; "
              f"observer errors {mgr.observer_errors}; {smi}", flush=True)
        if bad:
            raise RuntimeError("observability: " + "; ".join(bad))
        return out

    def close(self) -> None:
        """Stop the profiler's sampler and give the tracing clock back."""
        from kubeflow_tpu_torch.utils import tracing

        if self.mgr.profiler is not None:
            self.mgr.profiler.stop()
        tracing.set_clock(None)

    def _attempts(self) -> list:
        return ((self.status().get("sliceRecovery") or {}).get("0")
                or {}).get("attempts", [])

    def _finals(self) -> list:
        return [snap.generation for snap in self.store().snapshots(
            NB_NAMESPACE, NB_NAME, 0) if snap.trigger == "final"]

    def _events(self, reason: str) -> int:
        return sum(e.body.get("count", 1) for e in self.api.list(
            "Event", namespace=NB_NAMESPACE)
            if e.body.get("reason") == reason)

    def preempt(self, payload: bytes) -> dict:
        """Drill 3, the eviction: the gang's live state is `payload`, and
        a CR of the same shape at priority high arrives.  The card is the
        cluster's only GPU and no warm pool is configured, so the
        scheduler admits it, reserves a cold provision and asks the
        preemption engine, which takes a final snapshot of this gang
        (the fake cluster's handler writes the payload into the CR's
        store), commits the Pending record to TenantQuota, persists the
        restore intent and the queued stamp, tears the gang down and
        closes the record; the beneficiary is placed on the card.  The
        store's request is timed, so the engine's own work is the
        stage's wall time less it."""
        from kubeflow_tpu_torch.api.types import GPUSpec, Notebook
        from kubeflow_tpu_torch.core import constants as K
        from kubeflow_tpu_torch.kube import KubeObject

        self.cluster.set_session_payload(NB_NAMESPACE, NB_NAME, payload)
        store = self.cluster.session_store
        finals_before, attempts_before = self._finals(), self._attempts()
        before, start = self.pod(), len(self.stream)
        calls, inner = [], store.request_final_snapshot

        def timed(*args):
            t0 = time.perf_counter()
            snap = inner(*args)
            calls.append({"args": list(args), "s": time.perf_counter() - t0,
                          "generation": getattr(snap, "generation", None)})
            return snap

        store.request_final_snapshot = timed
        try:
            with self.stage("preempt"):
                self.api.create(KubeObject.from_dict(Notebook.new(
                    NB_BENEFICIARY, NB_NAMESPACE,
                    gpu=GPUSpec(self.accelerator, 1),
                    priority="high").obj))
                self.run()
        finally:
            del store.request_final_snapshot
        victim = self.api.get("Notebook", NB_NAMESPACE, NB_NAME)
        ben = self.api.get("Notebook", NB_NAMESPACE, NB_BENEFICIARY)
        queued = json.loads(victim.metadata.annotations.get(
            K.ANNOTATION_QUEUED, "{}"))
        intent = (victim.status.get("sessionState") or {}).get("0") or {}
        new_finals = [g for g in self._finals() if g not in finals_before]
        snap = store.info(NB_NAMESPACE, NB_NAME, 0, new_finals[0]) \
            if len(new_finals) == 1 else None
        stream = self.stream[start:]

        def first(entry):
            return next((i for i, e in enumerate(stream) if e == entry),
                        None)

        order = [first(("record", "Pending")),
                 first(("deleted", before.name, before.metadata.uid)),
                 first(("record", "Done"))]
        ben_pod = self.api.try_get("Pod", NB_NAMESPACE,
                                   f"{NB_BENEFICIARY}-0")
        quota = self.api.get(K.TENANTQUOTA_KIND, "",
                             K.TENANTQUOTA_NAME).status
        stage = self.cost["stages"]["preempt"]
        store_s = sum(c["s"] for c in calls)
        out = {
            "final_snapshot_requests": calls, "final_snapshots": new_finals,
            "snapshot": None if snap is None else {
                "generation": snap.generation, "digest": snap.digest,
                "size": snap.size},
            "store_s": store_s,
            "engine_ms": stage["wall_ms"] - store_s * 1e3,
            "reconciles": stage["reconciles"],
            "record_pending_delete_done_at": order,
            "records_left": quota.get("preemptions") or {},
            "recent": [(r.get("victim"), r.get("phase"))
                       for r in quota.get("recentPreemptions") or []],
            "victim": {
                "placement": K.ANNOTATION_PLACEMENT
                in victim.metadata.annotations, "queued": queued,
                "health": victim.status.get("sliceHealth"),
                "intent": {k: intent.get(k) for k in (
                    "phase", "trigger", "restoreGeneration", "digest")},
                "statefulset": self.api.try_get(
                    "StatefulSet", NB_NAMESPACE, NB_NAME) is not None,
                "pod": self.pod() is not None},
            "beneficiary": {
                "placement": json.loads(ben.metadata.annotations.get(
                    K.ANNOTATION_PLACEMENT, "{}")),
                "node": ben_pod.spec.get("nodeName") if ben_pod else None},
            "preemptions": {f"{r},{p}": self.metrics.preemptions.value(r, p)
                            for r, p in (("evicted", "low"),
                                         ("no-victim", "high"))},
            "events": {r: self._events(r) for r in (
                "NotebookPreempted", "PreemptionIssued")},
            "attempts": [len(attempts_before), len(self._attempts())],
        }
        bad = []
        if len(calls) != 1 or calls[0]["args"] != [NB_NAMESPACE, NB_NAME, 0] \
                or snap is None or new_finals != [calls[0]["generation"]]:
            bad.append(f"final snapshots {calls}, new in the store "
                       f"{new_finals}")
        if None in order or order != sorted(order) or out["records_left"] \
                or out["recent"][-1:] != [(f"{NB_NAMESPACE}/{NB_NAME}",
                                           "Done")]:
            bad.append(f"the record Pending, the pod delete and Done at "
                       f"{order} of the event stream, records left "
                       f"{out['records_left']}, recent {out['recent']}")
        want_victim = {
            "placement": False, "queued": {
                "beneficiary": f"{NB_NAMESPACE}/{NB_BENEFICIARY}",
                "priority": "low", "reason": "preempted",
                "since": queued.get("since")},
            "health": "Queued", "intent": {
                "phase": "migrating", "trigger": "preempt",
                "restoreGeneration": snap and snap.generation,
                "digest": snap and snap.digest},
            "statefulset": False, "pod": False}
        if out["victim"] != want_victim:
            bad.append(f"victim {out['victim']}")
        ben_gang = out["beneficiary"]["placement"].get("slices", {}).get(
            "0", {})
        if (ben_gang.get("pool"), ben_gang.get("nodes"),
                out["beneficiary"]["node"]) != (NB_POOL, [NB_NODE],
                                                NB_NODE):
            bad.append(f"beneficiary {out['beneficiary']}")
        if out["preemptions"] != {"evicted,low": 1.0, "no-victim,high": 0.0} \
                or out["events"] != {"NotebookPreempted": 1,
                                     "PreemptionIssued": 1} \
                or out["attempts"][0] != out["attempts"][1]:
            bad.append(f"preemptions {out['preemptions']}, events "
                       f"{out['events']}, attempts {out['attempts']}")
        if bad:
            raise RuntimeError("controller: the preemption: "
                               + "; ".join(bad))
        return out

    def hold_beneficiary(self) -> dict:
        """The beneficiary's pod runs and holds the card NB_BEN_HOLD_S of
        FakeClock time; the victim stays queued, fenced until the
        beneficiary placed and then out of capacity."""
        from kubeflow_tpu_torch.core import constants as K

        with self.stage("beneficiary"):
            self.cluster.mark_running(NB_NAMESPACE, f"{NB_BENEFICIARY}-0")
            self.run()
            self.run(advance_s=NB_BEN_HOLD_S)
        ben = self.api.get("Notebook", NB_NAMESPACE, NB_BENEFICIARY)
        out = {"beneficiary": ben.status.get("sliceHealth"),
               "victim": self.status().get("sliceHealth"),
               "victim_placed": K.ANNOTATION_PLACEMENT in self.api.get(
                   "Notebook", NB_NAMESPACE, NB_NAME).metadata.annotations,
               "gpus_used": self.cluster.node_used(NB_NODE).get(
                   K.GPU_RESOURCE)}
        if out != {"beneficiary": "Healthy", "victim": "Queued",
                   "victim_placed": False, "gpus_used": 1}:
            raise RuntimeError(f"controller: while the beneficiary holds "
                               f"the card {out}")
        return out

    def stop_beneficiary(self) -> dict:
        """The beneficiary stops: its gang goes and its claim drains, and
        the victim, woken by the pool, is placed on the card again before
        its StatefulSet exists; the StatefulSet carries the restore env of
        the record's snapshot and the recreated pod its stamp."""
        from kubeflow_tpu_torch.core import constants as K

        start = len(self.stream)
        with self.stage("beneficiary_stop"):
            ben = self.api.get("Notebook", NB_NAMESPACE, NB_BENEFICIARY)
            ben.metadata.annotations[K.STOP_ANNOTATION] = "true"
            self.api.update(ben)
            self.run()
        stream = self.stream[start:]
        placed_at = next((i for i, e in enumerate(stream)
                          if e[:3] == ("placement", NB_NAME, True)), None)
        sts_at = next((i for i, e in enumerate(stream)
                       if e[0] == "sts" and e[2] == NB_NAME), None)
        nb = self.api.get("Notebook", NB_NAMESPACE, NB_NAME)
        intent = (nb.status.get("sessionState") or {}).get("0") or {}
        gen = intent.get("restoreGeneration")
        snap = self.store().info(NB_NAMESPACE, NB_NAME, 0, gen) \
            if gen is not None else None
        sts = self.api.get("StatefulSet", NB_NAMESPACE, NB_NAME)
        env = {e["name"]: e.get("value") for e in
               sts.spec["template"]["spec"]["containers"][0]["env"]}
        pod = self.pod()
        ann = pod.metadata.annotations if pod is not None else {}
        waits = self.metrics.queue_wait_seconds
        out = {
            "placed_before_statefulset": [placed_at, sts_at],
            "queued": K.ANNOTATION_QUEUED in nb.metadata.annotations,
            "restore_env": [env.get(K.ENV_CHECKPOINT_RESTORE_URI),
                            env.get(K.ENV_CHECKPOINT_RESTORE_GENERATION)],
            "node": pod.spec.get("nodeName") if pod is not None else None,
            "gpus_used": self.cluster.node_used(NB_NODE).get(
                K.GPU_RESOURCE),
            "stamp": [ann.get(K.ANNOTATION_RESTORED_GENERATION),
                      ann.get(K.ANNOTATION_RESTORED_DIGEST)],
            "beneficiary": self.api.get(
                "Notebook", NB_NAMESPACE, NB_BENEFICIARY).status.get(
                    "sliceHealth"),
            # FakeClock seconds: simulated, not measured
            "fakeclock_queue_wait_s": waits.sum_value("low"),
            "placements_low": waits.count_value("low"),
            "claims": {r: self.metrics.warmpool_hits.value(r)
                       for r in ("hit", "miss", "bypass")},
        }
        bad = []
        if None in (placed_at, sts_at) or not placed_at < sts_at \
                or out["queued"]:
            bad.append(f"placement and StatefulSet at {[placed_at, sts_at]} "
                       f"of the event stream, queued {out['queued']}")
        if snap is None or intent.get("phase") != "migrating" or \
                out["restore_env"] != [intent.get("restoreUri"), str(gen)] \
                or out["stamp"] != [str(gen), snap.digest]:
            bad.append(f"intent {intent}, restore env {out['restore_env']}, "
                       f"stamp {out['stamp']}")
        if (out["node"], out["gpus_used"], out["beneficiary"]) != \
                (NB_NODE, 1, "Stopped"):
            bad.append(f"the victim's pod on {out['node']}, nvidia.com/gpu "
                       f"{out['gpus_used']}, the beneficiary "
                       f"{out['beneficiary']}")
        if bad:
            raise RuntimeError("controller: the victim's return: "
                               + "; ".join(bad))
        return out


    def replicate(self) -> dict:
        """The promotion drill's CR.  The phase's CR stops (its run is
        done) and frees the card; a second GPU node joins in its own pool
        (the fake device plugin's `add_gpu_nodes`); the CR NB_REP
        arrives with spec.replication {replicas: 2, antiAffine: true} and
        the same one-card gang, and both pods' containers run.  Replica
        0 must be placed on the card's node in NB_POOL and replica 1, by
        the anti-affinity, on the second node."""
        from kubeflow_tpu_torch.api.types import (
            GPUSpec,
            Notebook,
            ReplicationSpec,
        )
        from kubeflow_tpu_torch.core import constants as K
        from kubeflow_tpu_torch.kube import KubeObject
        from kubeflow_tpu_torch.odh import constants as O

        with self.stage("replicate"):
            nb = self.api.get("Notebook", NB_NAMESPACE, NB_NAME)
            nb.metadata.annotations[K.STOP_ANNOTATION] = "true"
            self.api.update(nb)
            self.run()
            (standby,) = self.cluster.add_gpu_nodes(
                self.accelerator, 1, 1, name_prefix="standby",
                pool=NB_STANDBY_POOL)
            self.jupyter.set_kernels(NB_NAMESPACE, NB_REP, [{
                "id": "k2", "name": "python3", "execution_state": "busy",
                "last_activity": "2023-01-01T00:00:00Z", "connections": 1}])
            self.api.create(KubeObject.from_dict(Notebook.new(
                NB_REP, NB_NAMESPACE, gpu=GPUSpec(self.accelerator, 1),
                replication=ReplicationSpec(2, anti_affine=True),
                annotations={O.ANNOTATION_INJECT_AUTH: "true"}).obj))
            self.run()
            for pod in (f"{NB_REP}-0", f"{NB_REP}-r1-0"):
                self.cluster.mark_running(NB_NAMESPACE, pod)
            self.run()
        nb = self.api.get("Notebook", NB_NAMESPACE, NB_REP)
        placement = json.loads(nb.metadata.annotations.get(
            K.ANNOTATION_PLACEMENT, "{}"))
        nodes = {}
        for pod in (f"{NB_REP}-0", f"{NB_REP}-r1-0"):
            obj = self.api.try_get("Pod", NB_NAMESPACE, pod)
            nodes[pod] = obj.spec.get("nodeName") if obj else None
        out = {"placement": placement.get("slices"), "nodes": nodes,
               "health": nb.status.get("sliceHealth"),
               "replication": nb.status.get("replication"),
               "standby_node": standby.name,
               "stopped": self.status().get("sliceHealth")}
        want = {"placement": {
                    "0": {"pool": NB_POOL, "nodes": [NB_NODE]},
                    "1": {"pool": NB_STANDBY_POOL, "nodes": [standby.name]}},
                "nodes": {f"{NB_REP}-0": NB_NODE,
                          f"{NB_REP}-r1-0": standby.name},
                "health": "Healthy", "stopped": "Stopped"}
        if {k: out[k] for k in want} != want or \
                (out["replication"] or {}).get("epoch") != 1 or \
                (out["replication"] or {}).get("primary") != 0:
            raise RuntimeError(f"controller: the replicated CR {out}")
        # the CA bundle existed when this CR was created: both replicas'
        # pods carry it from their first start, with the sidecar
        pods = {name: self._odh_pod(self.api.get("Pod", NB_NAMESPACE, name))
                for name in (f"{NB_REP}-0", f"{NB_REP}-r1-0")}
        self.odh["replicated"] = {"pods": pods,
                                  **self._odh_objects(NB_REP)}
        for name, odh_pod in pods.items():
            if (odh_pod["ca_volume"], odh_pod["ca_files_equal_bundle"],
                    odh_pod["sidecar_ports"]) != (
                    O.WORKBENCH_TRUSTED_CA_BUNDLE_CONFIGMAP, True,
                    [O.KUBE_RBAC_PROXY_PORT]):
                raise RuntimeError(f"odh: the replicated pod {name} "
                                   f"{odh_pod}")
        if self.odh["replicated"]["proxy_selector"] != {
                K.STATEFULSET_LABEL: NB_REP}:
            raise RuntimeError(f"odh: the replicated CR's proxy selects "
                               f"{self.odh['replicated']['proxy_selector']}")
        return out

    def catch_up(self) -> dict:
        """The follower runtimes' catch-up: the fake cluster stamps the
        replica-labelled pods with the chain head (lag 0), and the engine
        records the follower's freshness in status.replication."""
        with self.stage("catch_up"):
            stamped = self.cluster.sync_followers(NB_NAMESPACE, NB_REP,
                                                  lag=0)
            self.mgr.enqueue_all("notebook")
            self.run()
        rep = self.api.get("Notebook", NB_NAMESPACE, NB_REP).status.get(
            "replication") or {}
        return {"stamped": stamped,
                "follower": (rep.get("followers") or {}).get("1")}

    def promote(self) -> dict:
        """Replica 0's card dies (`fail_pod`, GPUUnhealthy, as the dead
        card drill's): the engine elects replica 1, commits the
        write-ahead record, raises the store's fence and flips the
        primary.  Then a zombie write from replica 0 at epoch 1 must be
        refused.  The ODH reconciler moves the kube-rbac-proxy Service to
        the new primary, and that owned Service's write runs the notebook
        controller at once: the gangs' roles are rendered anew and the
        demoted gang rejoins as a follower, one restart of gang 0 and
        nothing charged to the promoted gang (without the ODH plane the
        rejoin waited for the next resync)."""
        from kubeflow_tpu_torch.core import constants as K
        from kubeflow_tpu_torch.core.sessionstate import StaleWriterError

        store = self.cluster.session_store
        restarts = dict(self.metrics.slice_restarts.collect())
        migrations = dict(self.metrics.migrations.collect())
        start, deleted = len(self.stream), len(self.deleted)
        with self.stage("promote"):
            self.cluster.fail_pod(NB_NAMESPACE, f"{NB_REP}-0",
                                  "GPUUnhealthy")
            self.run()
        self.scrape()
        try:
            store.append_delta(NB_NAMESPACE, NB_REP, 0, b"zombie",
                               writer_epoch=1)
            zombie = "accepted"
        except StaleWriterError as err:
            zombie = f"refused: {err}"
        nb = self.api.get("Notebook", NB_NAMESPACE, NB_REP)
        rep = nb.status.get("replication") or {}
        stream = [e for e in self.stream[start:] if e[0] == "replication"]
        order = [next((i for i, e in enumerate(stream)
                       if e == ("replication", 2, 0, "promoting")), None),
                 next((i for i, e in enumerate(stream)
                       if e == ("replication", 2, 1, "promoted")), None)]
        recovery = nb.status.get("sliceRecovery") or {}
        ns = NB_NAMESPACE
        out = {
            "epoch": rep.get("epoch"), "primary": rep.get("primary"),
            "promotion": rep.get("promotion"),
            "promoting_then_promoted_at": order,
            "fence": store.fence_epoch(ns, NB_REP),
            "zombie": zombie,
            "promoted": self.metrics.promotions.value(ns, "promoted"),
            "no_candidate": self.metrics.promotions.value(
                ns, "no-candidate"),
            "fenced_writes": self.metrics.replication_fenced_writes.value(
                ns),
            # FakeClock seconds: simulated, not measured
            "fakeclock_promotion_s":
                self.metrics.promotion_duration_seconds.sum_value(ns),
            "attempts": {g: len(st.get("attempts") or [])
                         for g, st in recovery.items()},
            "restarts_added": {
                reason: n - restarts.get((ns, reason), 0.0)
                for (_, reason), n in
                self.metrics.slice_restarts.collect().items()
                if n != restarts.get((ns, reason), 0.0)},
            "pods_deleted": [o.name for o in self.deleted[deleted:]],
            "migrations_unchanged":
                dict(self.metrics.migrations.collect()) == migrations,
            "follower_deleted": [o.name for o in self.deleted
                                 if o.name.startswith(f"{NB_REP}-r1")],
        }
        bad = []
        if (out["epoch"], out["primary"],
                (out["promotion"] or {}).get("phase"),
                (out["promotion"] or {}).get("to")) != (2, 1, "promoted", 1):
            bad.append(f"status.replication {rep}")
        if None in order or not order[0] < order[1]:
            bad.append(f"the record promoting and the flip at {order} of "
                       f"the event stream")
        if out["fence"] != 2 or not zombie.startswith("refused"):
            bad.append(f"fence {out['fence']}, zombie write {zombie}")
        if (out["promoted"], out["no_candidate"], out["fenced_writes"]) \
                != (1.0, 0.0, 1.0):
            bad.append(f"promotions {out['promoted']} (no candidate "
                       f"{out['no_candidate']}), fenced writes "
                       f"{out['fenced_writes']}")
        if out["attempts"] != {"0": 1} \
                or out["restarts_added"] != {"pod-failed": 1.0} \
                or out["pods_deleted"] != [f"{NB_REP}-0"] \
                or not out["migrations_unchanged"] \
                or out["follower_deleted"]:
            bad.append(f"attempts {out['attempts']}, restarts added "
                       f"{out['restarts_added']}, pods deleted "
                       f"{out['pods_deleted']}, migrations unchanged "
                       f"{out['migrations_unchanged']}, follower pods "
                       f"deleted {out['follower_deleted']}")
        # the routing follows the primary: the plain Service and, with
        # auth, the kube-rbac-proxy Service the HTTPRoute sends to
        selectors = {svc: self.api.get("Service", NB_NAMESPACE, svc).spec[
                         "selector"].get(K.STATEFULSET_LABEL)
                     for svc in (NB_REP, NB_REP + "-kube-rbac-proxy")}
        out["selectors"] = selectors
        self.odh["promoted"] = selectors
        print(f"odh promoted: Service selectors {selectors}", flush=True)
        if set(selectors.values()) != {f"{NB_REP}-r1"}:
            bad.append(f"the Services after the promotion select "
                       f"{selectors}")
        if bad:
            raise RuntimeError("controller: the promotion: "
                               + "; ".join(bad))
        return out


class _BytesView(io.RawIOBase):
    """The first `end` bytes of a bytes object as a read-only file, with
    no copy of them: what torch.load reads a payload's prefix through."""

    def __init__(self, data: bytes, end: int):
        self._view, self._pos = memoryview(data)[:end], 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def readinto(self, buf) -> int:
        n = max(min(len(buf), len(self._view) - self._pos), 0)
        buf[:n] = self._view[self._pos:self._pos + n]
        self._pos += n
        return n

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        base = {io.SEEK_SET: 0, io.SEEK_CUR: self._pos,
                io.SEEK_END: len(self._view)}[whence]
        self._pos = base + offset
        return self._pos

    def tell(self) -> int:
        return self._pos


def _state_bytes(state) -> bytes:
    """The train state serialized as one payload (torch.save of
    `train_state_dict`), what the gang's session snapshot holds."""
    import torch

    from kubeflow_tpu_torch.models import train

    buf = io.BytesIO()
    torch.save(train.train_state_dict(state), buf)
    return buf.getvalue()


def _clone_state(state_dict: dict) -> dict:
    """A copy of a `train_state_dict` (parameters, AdamW moments, count,
    b1_mu, step) that later steps do not change."""
    opt = state_dict["optimizer"]
    return {"model": {n: t.clone() for n, t in state_dict["model"].items()},
            "optimizer": {**opt, "mu": {n: t.clone()
                                        for n, t in opt["mu"].items()},
                          "nu": {n: t.clone() for n, t in opt["nu"].items()}},
            "step": state_dict["step"]}


def _states_equal(a: dict, b: dict) -> bool:
    """Two train state dicts bit for bit: every parameter and moment, the
    AdamW count and b1_mu, and the step."""
    import torch

    oa, ob = a["optimizer"], b["optimizer"]
    return (a["step"] == b["step"] and oa["count"] == ob["count"]
            and oa["b1_mu"] == ob["b1_mu"]
            and all(torch.equal(a["model"][n], b["model"][n])
                    for n in a["model"])
            and all(torch.equal(oa[k][n], ob[k][n])
                    for k in ("mu", "nu") for n in oa[k]))


def _rss():
    """This process's resident set now, in bytes (/proc/self/statm); None
    where /proc does not say."""
    try:
        pages = int(Path("/proc/self/statm").read_text().split()[1])
    except (OSError, IndexError, ValueError):
        return None
    return pages * os.sysconf("SC_PAGE_SIZE")


def boot_restore(controller, target, device) -> dict:
    """The recreated pod's boot path on this card: its env resolved as the
    kubelet would, `restore_instructions(env)`, the payload fetched
    through `CheckpointSidecar.restore_payload` from the store the env
    names, and loaded into `target`.  The payload's digest is computed on
    another thread while it loads (hashlib releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from kubeflow_tpu_torch.core.sessionstate import payload_digest
    from kubeflow_tpu_torch.models import train
    from kubeflow_tpu_torch.runtime import checkpoint as ckpt

    env = controller.resolve(controller.pod())["env"]
    instruction = ckpt.restore_instructions(env)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sidecar = ckpt.CheckpointSidecar.from_env(NB_NAMESPACE, NB_NAME, 0,
                                              env=env)
    payload = sidecar.restore_payload(env)
    fetch_s = time.perf_counter() - t0
    with ThreadPoolExecutor(1) as pool:
        digest = pool.submit(payload_digest, payload)
        train.load_train_state(target.state, torch.load(
            io.BytesIO(payload), map_location=device, weights_only=True))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        digest = digest.result()
    return {"generation": instruction.generation, "bytes": len(payload),
            "digest": digest, "fetch_s": fetch_s, "restore_s": restore_s,
            "rss_bytes": _rss()}


def start_chain(controller, payload: bytes, a: dict) -> dict:
    """The promotion drill's host work, on a thread beside the rest of
    drill 3 (file writes and hashing release the GIL): the primary of
    NB_REP puts `payload`, run A's state after step NB_PREEMPT_STEP, as
    the base with writer epoch 1 and appends one record a step for the
    steps after it (the step, the batch's index into the phase's batches
    and the bits of run A's loss) with epoch 1 and the expected
    sequence, through the CR's store; then replica 1's runtime replays
    the chain through a FollowerReplica of the store its pod opens,
    verifying each digest.  Each part's seconds are kept."""
    from concurrent.futures import ThreadPoolExecutor

    from kubeflow_tpu_torch.core.sessionstate import FollowerReplica

    store, ns = controller.cluster.session_store, NB_NAMESPACE

    def chain():
        t0 = time.perf_counter()
        base = store.put(ns, NB_REP, 0, payload, writer_epoch=1)
        t1 = time.perf_counter()
        records = [json.dumps({"step": i + 1, "batch": i,
                               "loss": a["losses"][i].hex()}).encode()
                   for i in range(NB_PREEMPT_STEP, NB_STEPS)]
        deltas = [store.append_delta(ns, NB_REP, 0, rec, expected_seq=n + 1,
                                     writer_epoch=1)
                  for n, rec in enumerate(records)]
        t2 = time.perf_counter()
        head = store.chain_head(ns, NB_REP, 0)
        follower = FollowerReplica(controller.store(), ns, NB_REP, 0)
        steps = follower.catch_up()
        t3 = time.perf_counter()
        return {"base": base, "records": records, "deltas": deltas,
                "head": head, "follower": follower, "steps": steps,
                "put_s": t1 - t0, "append_s": t2 - t1,
                "catch_up_s": t3 - t2}

    pool = ThreadPoolExecutor(1)
    return {"pool": pool, "future": pool.submit(chain)}


def promotion_drill(controller, setup, pipeline, want, final_a, expected,
                    device, chain) -> dict:
    """The replicated tier on the phase's card.  The CR NB_REP's two
    replicas are placed anti-affine (`NotebookController.replicate`).
    `start_chain`'s thread wrote the chain (the base, run A's state after
    step NB_PREEMPT_STEP from drill 3's bytes, and a record a step after
    it) and replayed it as replica 1's runtime; the fake cluster stamps
    the replicas' pods at the chain head.  Replica 0's card dies and the
    engine promotes replica 1; the promoted runtime restores the base
    part of its verified state into a setup from a fourth seed and
    replays the records on the card, each loss bit-equal to the
    record's and the final parameters to run A's."""
    import itertools

    import torch

    from kubeflow_tpu_torch.models import train

    ns, store = NB_NAMESPACE, controller.cluster.session_store
    placed = controller.replicate()
    # the promoted runtime's setup, from a fourth seed, while the chain's
    # thread finishes
    target = setup(SEED + 4)
    t0 = time.perf_counter()
    written = chain["future"].result()
    chain["pool"].shutdown()
    wait_s = time.perf_counter() - t0
    base, records, deltas = (written["base"], written["records"],
                             written["deltas"])
    head, follower, steps = (written["head"], written["follower"],
                             written["steps"])
    caught = controller.catch_up()
    promoted = controller.promote()

    # the promoted runtime: the base part of its verified state into a
    # setup from a fourth seed, then the records replayed on the card
    state = follower.state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train.load_train_state(target.state, torch.load(
        _BytesView(state, base.size), map_location=device,
        weights_only=True))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    offset, replayed = base.size, []
    for d in store.deltas(ns, NB_REP, 0):
        replayed.append(json.loads(state[offset:offset + d.size]))
        offset += d.size
    del state
    first = replayed[0]["batch"]
    t0 = time.perf_counter()
    pipe = pipeline()
    run = _nb_steps(target, itertools.islice(pipe, first, None),
                    [want[r["batch"]] for r in replayed])
    pipe.close()
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    final_equal = all(torch.equal(final_a[n], train.local_tensor(t))
                      for n, t in target.model.named_parameters())
    del target
    torch.cuda.empty_cache()
    out = {
        "placed": placed, "base": {"generation": base.generation,
                                   "size": base.size, "digest": base.digest},
        "records": [json.loads(r) for r in records],
        "deltas": [{"seq": d.seq, "size": d.size, "digest": d.digest}
                   for d in deltas],
        "head_before_failure": list(head),
        "head_after": list(store.chain_head(ns, NB_REP, 0)),
        "catch_up": caught, "follower_steps": steps,
        "follower": {"generation": follower.base_generation,
                     "seq": follower.seq, "digest": follower.digest},
        "promote": promoted, "replayed": replayed,
        "replayed_losses": [x.hex() for x in run["losses"]],
        "replayed_launches": run["launches"], "batches_equal": run["same"],
        "final_params_bit_identical": final_equal,
        "put_s": written["put_s"], "append_s": written["append_s"],
        "catch_up_s": written["catch_up_s"], "chain_wait_s": wait_s,
        "restore_s": restore_s, "replay_s": replay_s,
        "engine": {stage: controller.cost["stages"][stage] for stage in
                   ("replicate", "catch_up", "promote")},
    }
    print(f"notebook_train promotion: base {base.size} bytes put in "
          f"{written['put_s']:.3f} s, {len(records)} records appended in "
          f"{written['append_s'] * 1e3:.2f} ms, the follower's catch-up "
          f"(read and hash) {written['catch_up_s']:.3f} s, on a thread "
          f"beside drill 3 ({wait_s:.3f} s waited for); restore "
          f"{restore_s:.3f} s, replay of {len(replayed)} steps "
          f"{replay_s:.3f} s; engine " + "; ".join(
              f"{stage} {c['reconciles']} reconciles {c['wall_ms']:.2f} ms"
              for stage, c in out["engine"].items())
          + f"; FakeClock (simulated) promotion "
          f"{promoted['fakeclock_promotion_s']:.1f} s", flush=True)
    bad = []
    want_head = [base.generation, len(records), deltas[-1].digest]
    stamp = {"generation": base.generation, "seq": len(records),
             "digest": deltas[-1].digest}
    if out["head_before_failure"] != want_head or \
            out["head_after"] != want_head or \
            (caught["follower"] or {}).get("slices", {}).get("0") != stamp \
            or not (caught["follower"] or {}).get("ready"):
        bad.append(f"chain head {out['head_before_failure']} before the "
                   f"failure and {out['head_after']} after, the "
                   f"follower's record {caught['follower']}")
    if out["follower"] != stamp or steps != 1 + len(records):
        bad.append(f"the follower replayed to {out['follower']} in {steps} "
                   f"steps, the head is {stamp}")
    if [r["loss"] for r in replayed] != [r["loss"] for r in out["records"]] \
            or out["replayed_losses"] != [r["loss"] for r in replayed] \
            or not run["same"] or any(n != expected
                                      for n in run["launches"]):
        bad.append(f"replayed losses {out['replayed_losses']} against the "
                   f"records' {[r['loss'] for r in replayed]}, batches "
                   f"equal {run['same']}, launches {run['launches']}")
    if not final_equal:
        bad.append("the replayed run's final parameters differ from run A's")
    if bad:
        raise RuntimeError("notebook_train promotion: " + "; ".join(bad))
    return out


def recovery_drills(controller, setup, pipeline, want, a, state_a_fail,
                    state_a_preempt, final_a, expected, device,
                    smi) -> dict:
    """The self-healing engine's two drills and the preemption drill on
    the phase's pod, at BENCH_CHIP's full width and depth (see the module
    docstring): a drain migration of the state after step
    NB_MIGRATE_STEP, restored into a setup from another seed, then a dead
    card after step NB_FAIL_STEP, restored from the same snapshot into the
    same setup, which trains on to step NB_PREEMPT_STEP; there a
    high-priority CR preempts the gang, and once it stops the gang
    returns and restores into a setup from a third seed, which trains the
    last steps.  `a` is run A's record, `state_a_fail` and
    `state_a_preempt` its states after steps NB_FAIL_STEP and
    NB_PREEMPT_STEP, and `final_a` its final parameters."""
    import itertools
    import resource

    import torch

    from kubeflow_tpu_torch.models import train

    k, m, p = NB_MIGRATE_STEP, NB_FAIL_STEP, NB_PREEMPT_STEP
    peak_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    wall, mark, rss = {}, [time.perf_counter()], [_rss()]

    def part(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        wall[name] = wall.get(name, 0.0) + now - mark[0]
        mark[0] = now
        rss.append(_rss())

    controller.busy()

    # drill 1: a run from run A's seed takes steps 1..k; its serialized
    # train state is the session payload the final snapshot captures
    source = setup(SEED)
    part("setups")
    pipe = pipeline()
    pre = _nb_steps(source, pipe, want[:k])
    pipe.close()
    part("steps")
    payload = _state_bytes(source.state)
    part("serialize")
    serialize_s = wall["serialize"]
    size = len(payload)
    drain = controller.migrate(payload)
    del payload
    part("migrate")
    store_s = controller.cost["stages"]["migrate"]["wall_ms"] / 1e3
    target = setup(SEED + 2)
    part("setups")
    boot1 = boot_restore(controller, target, device)
    part("restores")
    restored_equal = _states_equal(train.train_state_dict(target.state),
                                   train.train_state_dict(source.state))
    del source
    torch.cuda.empty_cache()
    ready1 = controller.ready("drain")
    part("compare and ready")
    ready1["slice_restarts"] = {r: v for (_, r), v in
                                controller.metrics.slice_restarts.collect()
                                .items()}
    if ready1["slice_restarts"] != {"migrate": 1.0}:
        raise RuntimeError(f"notebook_train recovery: the drain migration "
                           f"counted {ready1['slice_restarts']}")
    pipe = pipeline()
    mid = _nb_steps(target, itertools.islice(pipe, k, None), want[k:m])
    pipe.close()
    part("steps")
    at_fail_equal = _states_equal(train.train_state_dict(target.state),
                                  state_a_fail)

    # drill 2: the card dies; the same snapshot is restored into the same
    # setup, which runs steps k+1..p again
    dead = controller.kill_card()
    part("compare and ready")
    boot2 = boot_restore(controller, target, device)
    part("restores")
    ready2 = controller.ready("failure")
    part("compare and ready")
    pipe = pipeline()
    again = _nb_steps(target, itertools.islice(pipe, k, None), want[k:p])
    pipe.close()
    part("steps")
    at_preempt_equal = _states_equal(train.train_state_dict(target.state),
                                     state_a_preempt)
    finals = controller._finals()

    # drill 3: a high-priority CR of the same shape preempts the gang at
    # step p; its live state is the payload of the engine's final
    # snapshot, and the pod it ran in is gone with it
    payload = _state_bytes(target.state)
    part("serialize")
    preempt_serialize_s = wall["serialize"] - serialize_s
    del target
    torch.cuda.empty_cache()
    evicted = controller.preempt(payload)
    part("preempt")
    held = controller.hold_beneficiary()
    back = controller.stop_beneficiary()
    # the promotion drill's base is these bytes: its chain is written and
    # replayed beside the rest of drill 3, which no longer reads the
    # engine's store
    chain = start_chain(controller, payload, a)
    del payload
    part("compare and ready")
    # the returned gang's pod restores into a setup from a third seed
    resumed = setup(SEED + 3)
    part("setups")
    boot3 = boot_restore(controller, resumed, device)
    part("restores")
    preempt_restored_equal = _states_equal(
        train.train_state_dict(resumed.state), state_a_preempt)
    ready3 = controller.ready("preempt")
    part("compare and ready")
    pipe = pipeline()
    after = _nb_steps(resumed, itertools.islice(pipe, p, None), want[p:])
    pipe.close()
    part("steps")
    final_equal = all(torch.equal(final_a[n], train.local_tensor(t))
                      for n, t in resumed.model.named_parameters())
    del resumed
    controller.cluster.set_session_payload(NB_NAMESPACE, NB_NAME, b"")
    torch.cuda.empty_cache()
    part("compare and ready")

    metrics = controller.metrics
    status = controller.status()
    attempts = ((status.get("sliceRecovery") or {}).get("0")
                or {}).get("attempts", [])
    exhausted = [c for c in status.get("conditions") or []
                 if c.get("type") == "RecoveryExhausted"]
    counted = {
        "migrations": {f"{t},{r}": metrics.migrations.value(t, r)
                       for t in ("drain", "failure")
                       for r in ("migrated", "restored",
                                 "fallback-restart")},
        "slice_restarts": {r: v for (_, r), v in
                           metrics.slice_restarts.collect().items()},
        "checkpoint_snapshots_final": metrics.checkpoint_snapshots.value(
            NB_NAMESPACE, "final"),
        "recovery_observations":
            metrics.disruption_recovery_seconds.count_value(NB_NAMESPACE),
        "fakeclock_recovery_s":
            metrics.disruption_recovery_seconds.sum_value(NB_NAMESPACE),
    }
    # drill 4, the promotion, on a replicated CR (the phase's CR stops
    # first, so the counts above are read before it)
    promotion = promotion_drill(controller, setup, pipeline, want, final_a,
                                expected, device, chain)
    part("promote")
    peak_after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    rss += [boot1["rss_bytes"], boot2["rss_bytes"], boot3["rss_bytes"]]
    rss_max = max((r for r in rss if r is not None), default=None)
    gb = size / 1e9
    out = {
        "migrate_step": k, "fail_step": m, "snapshot_bytes": size,
        "serialize_s": serialize_s, "store_s": store_s,
        "serialize_store_s": serialize_s + store_s,
        "serialize_store_gb_s": gb / (serialize_s + store_s),
        "restore_s": [boot1["restore_s"], boot2["restore_s"]],
        "fetch_s": [boot1["fetch_s"], boot2["fetch_s"]],
        "restore_gb_s": [gb / boot1["restore_s"], gb / boot2["restore_s"]],
        "process_peak_rss_bytes": [peak_before, peak_after],
        "max_sampled_rss_bytes": rss_max, "wall_s": wall,
        "drills_s": sum(wall.values()),
        "drills": {"drain": {**drain, "boot": boot1, "ready": ready1},
                   "failure": {**dead, "boot": boot2, "ready": ready2},
                   "preempt": {**evicted, "held": held, "back": back,
                               "boot": boot3, "ready": ready3},
                   "promote": promotion},
        "engine": {stage: controller.cost["stages"][stage] for stage in
                   ("migrate", "ready_drain", "dead_card", "ready_failure",
                    "preempt", "beneficiary", "beneficiary_stop",
                    "ready_preempt", "replicate", "catch_up", "promote")},
        "preempt_step": p, "preempt_serialize_s": preempt_serialize_s,
        "preempt_store_s": evicted["store_s"],
        "preempt_restore_s": boot3["restore_s"],
        "preempt_engine_ms": evicted["engine_ms"],
        "fakeclock_queue_wait_s": back["fakeclock_queue_wait_s"],
        "final_snapshots": finals, "attempts": len(attempts),
        "recovery_exhausted": bool(exhausted), **counted,
        "losses_before_migrate": pre["losses"],
        "losses_after_migrate": mid["losses"],
        "losses_after_dead_card": again["losses"],
        "losses_after_preemption": after["losses"],
        "restored_state_bit_identical": restored_equal,
        "state_at_fail_step_bit_identical": at_fail_equal,
        "state_at_preempt_step_bit_identical": at_preempt_equal,
        "preempt_restored_state_bit_identical": preempt_restored_equal,
        "final_params_bit_identical": final_equal,
        "nvidia_smi": smi,
    }
    print(f"notebook_train recovery: snapshot {size} bytes ({gb:.3f} GB), "
          f"serialize {serialize_s:.3f} s + store {store_s:.3f} s "
          f"({out['serialize_store_gb_s']:.3f} GB/s); restores "
          f"{boot1['restore_s']:.3f} s and {boot2['restore_s']:.3f} s; "
          f"engine " + "; ".join(
              f"{stage} {c['reconciles']} reconciles {c['wall_ms']:.2f} ms"
              for stage, c in out["engine"].items())
          + f"; FakeClock (simulated) recovery "
          f"{counted['fakeclock_recovery_s']:.1f} s; preemption at step "
          f"{p}: serialize {preempt_serialize_s:.3f} s, store "
          f"{evicted['store_s']:.3f} s, restore {boot3['restore_s']:.3f} "
          f"s, the scheduler's and engine's own work "
          f"{evicted['engine_ms']:.2f} ms in {evicted['reconciles']} "
          f"reconciles, FakeClock (simulated) queue wait "
          f"{back['fakeclock_queue_wait_s']:.1f} s; RSS at most "
          + (f"{rss_max / 2**30:.2f} GiB" if rss_max is not None
             else "not measured")
          + f" where sampled (after each part and each load), the "
          f"process's peak {peak_before / 2**30:.2f} -> "
          f"{peak_after / 2**30:.2f} GiB; {out['drills_s']:.2f} s in "
          f"all: " + ", ".join(
              f"{name} {s:.2f}" for name, s in wall.items())
          + f" s; {smi}", flush=True)

    bad = []
    runs = {"before the migration": (pre, a["losses"][:k]),
            "after the migration": (mid, a["losses"][k:m]),
            "after the dead card": (again, a["losses"][k:p]),
            "after the preemption": (after, a["losses"][p:])}
    for what, (run, losses) in runs.items():
        if run["losses"] != losses or not run["same"] or any(
                n != expected for n in run["launches"]):
            bad.append(f"the run {what}: losses {run['losses']} against "
                       f"run A's {losses}, batches equal {run['same']}, "
                       f"launches {run['launches']}")
    if not (restored_equal and at_fail_equal and at_preempt_equal
            and preempt_restored_equal and final_equal):
        bad.append(f"restored state equal {restored_equal}, at step {m} "
                   f"{at_fail_equal}, at step {p} {at_preempt_equal}, "
                   f"restored after the preemption "
                   f"{preempt_restored_equal}, final parameters "
                   f"{final_equal}")
    preempted = {"generation": evicted["snapshot"]["generation"],
                 "stamp": back["stamp"]}
    for boot, drill, nbytes in ((boot1, drain, size), (boot2, dead, size),
                                (boot3, preempted,
                                 evicted["snapshot"]["size"])):
        if [str(boot["generation"]), boot["digest"]] != drill["stamp"] or \
                boot["bytes"] != nbytes:
            bad.append(f"restored generation {boot['generation']}, digest "
                       f"{boot['digest']}, {boot['bytes']} bytes against "
                       f"the pod's stamp {drill['stamp']}, {nbytes} bytes")
    if finals != [drain["generation"]] or \
            dead["generation"] != drain["generation"] or \
            controller._finals() != finals + [preempted["generation"]]:
        bad.append(f"final snapshots {finals} before the preemption, "
                   f"{controller._finals()} after it, migrations restored "
                   f"{drain['generation']} and {dead['generation']}")
    want_counts = {"drain,migrated": 1.0, "drain,restored": 1.0,
                   "drain,fallback-restart": 0.0, "failure,migrated": 1.0,
                   "failure,restored": 1.0, "failure,fallback-restart": 0.0}
    if counted["migrations"] != want_counts or \
            counted["slice_restarts"] != {"migrate": 2.0} or \
            counted["checkpoint_snapshots_final"] != 1.0 or \
            counted["recovery_observations"] != 1 or len(attempts) != 2 \
            or exhausted or ready2["migration_complete_events"] != 2:
        bad.append(f"counted {counted}, {len(attempts)} attempts, "
                   f"RecoveryExhausted {exhausted}, MigrationComplete "
                   f"{ready2['migration_complete_events']}")
    if bad:
        raise RuntimeError("notebook_train recovery: " + "; ".join(bad))
    return out


def start_pre_stop(rendered: dict) -> dict:
    """Start the rendered preStop command with the pod's resolved env (the
    pod's interpreter is the one running this script) and wait for its
    request file: a pod's loop meets the request at a later step, this
    one waits so that the cull stays at its step."""
    from kubeflow_tpu_torch.runtime import checkpoint as ckpt

    command = rendered["pre_stop"]
    command = [sys.executable if command[0] == "python" else command[0]] \
        + command[1:]
    t0 = time.perf_counter()
    proc = subprocess.Popen(command, cwd=ROOT,
                            env={**os.environ, **rendered["env"]},
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    request = rendered["signal_dir"] / ckpt.REQUEST_FILE
    while not request.exists():
        if proc.poll() is not None or time.perf_counter() - t0 > 60:
            proc.kill()
            out, err = proc.communicate()
            raise RuntimeError(f"the preStop command {command} wrote no "
                               f"request (rc {proc.returncode}): {out}"
                               f"{err[-2000:]}")
        time.sleep(0.005)
    return {"proc": proc, "command": command, "t0": t0,
            "startup_s": time.perf_counter() - t0}


def finish_pre_stop(started: dict) -> dict:
    """Wait for the preStop command; it must exit 0 on the ack and print
    its wait from request to ack."""
    proc = started["proc"]
    try:
        out, err = proc.communicate(timeout=60)
    finally:
        proc.kill()
    wall_s = time.perf_counter() - started["t0"]
    lines = [json.loads(line) for line in out.splitlines()
             if line.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"the preStop command {started['command']} "
                           f"exited {proc.returncode}: {out}{err[-2000:]}")
    return {"rc": proc.returncode, "wait_s": lines[-1]["wait_s"],
            "wall_s": wall_s}


def start_examples(rendered: dict, device_name: str) -> dict:
    """Launch the example side by side as a user runs it: in the pod,
    torchrun with no flag, its world from the rendered PET_* env and the
    CA bundle's env (SSL_CERT_FILE and its siblings) naming the bundle's
    file; on one card, a bare launch, its group from the example's
    one-rank fallback.  One thread a launch waits for it, so that each
    one's seconds end at its own exit."""
    from concurrent.futures import ThreadPoolExecutor

    from kubeflow_tpu_torch.odh import constants as O

    rendezvous = {k: v for k, v in rendered["env"].items()
                  if k.startswith(("PET_", "GPU_"))}
    ca = {k: rendered["env"][k] for k in O.CA_BUNDLE_ENV_VARS
          if k in rendered["env"]}
    module = ["-m", "kubeflow_tpu_torch.examples.train_llm"]
    launches = {
        "torchrun": ([sys.executable, "-m", "torch.distributed.run"]
                     + module, {**os.environ, **rendezvous, **ca},
                     "distributed_init under torchrun"),
        "bare": ([sys.executable] + module, dict(os.environ),
                 "the one-rank fallback")}
    t0 = time.perf_counter()
    procs = {key: subprocess.Popen(command, cwd=ROOT, env=env,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
             for key, (command, env, _) in launches.items()}

    def finish(key):
        out, err = procs[key].communicate(timeout=NB_EXAMPLE_TIMEOUT_S)
        return out, err, time.perf_counter() - t0

    pool = ThreadPoolExecutor(len(procs))
    return {"launches": launches, "procs": procs, "pool": pool,
            "rendezvous": rendezvous, "device_name": device_name,
            "waits": {key: pool.submit(finish, key) for key in procs}}


def finish_examples(started: dict, abort: bool = False) -> dict:
    """Each launch's return code, seconds from the launch to its exit,
    output and whether it passed; with `abort`, the launches are killed
    first.  Every launch is stopped on return."""
    procs, launches = started["procs"], started["launches"]
    examples = {}
    try:
        if abort:
            for proc in procs.values():
                proc.kill()
        for key, wait in started["waits"].items():
            out, err, seconds = wait.result()
            lines = out.splitlines()
            examples[key] = {
                "returncode": procs[key].returncode, "s": seconds,
                "tail": lines[-4:], "stdout": out, "stderr": err,
                "ok": (procs[key].returncode == 0
                       and "RESULT: OK" in lines
                       and f"devices: 1 x {started['device_name']}"
                       in lines
                       and any(line.endswith(f"formed by "
                                             f"{launches[key][2]}")
                               for line in lines))}
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
        started["pool"].shutdown()
    return examples


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

    # run A: 12 steps through the pipeline with a telemetry agent; its
    # states after steps NB_FAIL_STEP and NB_PREEMPT_STEP are kept for the
    # recovery and preemption drills
    run_a = setup(SEED)
    agent = TelemetryAgent(config=cfg, batch=NB_BATCH, seq_len=seq,
                           num_chips=1, accelerator=device_name,
                           worker="chip-smoke")
    state_a_fail, state_a_preempt = {}, {}

    def keep_fail_step(step, state):
        if step == NB_FAIL_STEP:
            state_a_fail.update(_clone_state(state))
        if step == NB_PREEMPT_STEP:
            state_a_preempt.update(_clone_state(state))
        return False

    pipe = pipeline()
    a = _nb_steps(run_a, pipe, want, hook=keep_fail_step, agent=agent)
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
        t0 = time.perf_counter()
        controller = NotebookController(device_name, tmp)
        rendered = controller.start()
        render_s = time.perf_counter() - t0
        controller.telemetry(agent)
        signals = rendered["signal_dir"]
        # run B: the same seed; before step 6's hook the culler stops the
        # idle notebook, the controller deletes its pod, and that pod's
        # rendered preStop command runs, as the kubelet runs it on the
        # delete, and writes its request; the hook saves through the local
        # backend and acknowledges, and the preStop command exits on the
        # ack
        local = ckpt.CheckpointManager(str(tmp / "local"), backend="local")
        hook = ckpt.checkpoint_on_cull(local, ckpt.CullSignalWatcher(
            str(rendered["podinfo"]), hook_dir=str(signals)))
        pre_stop, culled = {}, {}

        def cull_request(step):
            if step == NB_CULL_STEP:
                culled.update(controller.cull())
                pre_stop.update(start_pre_stop(culled))

        run_b = setup(SEED)
        pipe = pipeline()
        try:
            b = _nb_steps(run_b, pipe, want, hook=hook,
                          before_hook=cull_request)
        finally:
            pipe.close()
            if pre_stop:
                pre_stop.update(finish_pre_stop(pre_stop))
        if not pre_stop:
            raise RuntimeError(f"run B ended before step {NB_CULL_STEP}")
        print(f"notebook_train preStop: {' '.join(rendered['pre_stop'])} "
              f"exited {pre_stop['rc']}, request to ack "
              f"{pre_stop['wait_s']:.3f} s (the save "
              f"{b.get('hook_s', float('nan')):.3f} s), start to request "
              f"{pre_stop['startup_s']:.3f} s; {smi}", flush=True)
        acked = (signals / ckpt.ACK_FILE).exists()
        # the deleted pod was the one the loop ran in; removing the stop
        # annotation makes the controller recreate it, and the resume
        # below runs in that pod
        if (culled["pre_stop"], culled["signal_dir"]) != \
                (rendered["pre_stop"], signals):
            raise RuntimeError(f"the culled pod's preStop {culled} is not "
                               f"the started one's {rendered}")
        # the pod recreated on the unstop, with the CA bundle the cull's
        # restart let through: the examples launch with its env
        restarted = controller.unstop(rendered)
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
        del resumed, final_r
        shutil.rmtree(tmp / "local")
        torch.cuda.empty_cache()

        # the example's two launches start here and run beside the
        # drills and the dcp round, which need neither of them (a TINY
        # model: their time is the interpreters' and the launchers')
        started = start_examples(restarted, device_name)

        # the self-healing engine's drills on the same pod, a drain
        # migration and a dead card, then the preemption drill
        try:
            recovery = recovery_drills(controller, setup, pipeline, want, a,
                                       state_a_fail, state_a_preempt,
                                       final_a, expected, device, smi)
            observability = controller.observability(smi)
        except BaseException:
            finish_examples(started, abort=True)
            raise
        finally:
            controller.close()
        del state_a_fail, state_a_preempt, final_a
        torch.cuda.empty_cache()

        # dcp: one save and restore of the mesh setup at world size 1 on
        # NCCL; a fresh mesh setup resumes it for 2 steps against the
        # uninterrupted mesh run
        try:
            dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                                    f"{_free_port()}", rank=0, world_size=1)
        except BaseException:
            finish_examples(started, abort=True)
            raise
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
        except BaseException:
            finish_examples(started, abort=True)
            raise
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    examples = finish_examples(started)
    launches, rendezvous = started["launches"], started["rendezvous"]

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
        "examples": {key: {k: v for k, v in ex.items()
                           if k not in ("stdout", "stderr")}
                     for key, ex in examples.items()},
        "example_launchers": {key: " ".join(["python"] + command[1:])
                              for key, (command, _, _) in launches.items()},
        "example_env": rendezvous,
        "render": {k: v for k, v in rendered.items()
                   if k not in ("env", "signal_dir", "podinfo")},
        "render_s": render_s,
        "controller": {**controller.cost, "nvidia_smi": smi},
        "odh": {**controller.odh, "timing": controller.timing,
                "nvidia_smi": smi},
        "recovery": recovery,
        "observability": observability,
        "pre_stop_returncode": pre_stop["rc"],
        "pre_stop_wait_s": pre_stop["wait_s"],
        "pre_stop_startup_s": pre_stop["startup_s"],
        "pre_stop_wall_s": pre_stop["wall_s"],
        "phase_s": time.perf_counter() - phase_t0,
    }
    timing = {k: [n, round(ms, 3)] for k, (n, ms) in
              sorted(controller.timing.items())}
    odh = controller.odh
    objects = sorted(k for k, v in odh["admitted"]["owners"].items()
                     if v != "missing")
    replicas = {k: (v["ca_volume"], v["sidecar_ports"])
                for k, v in odh["replicated"]["pods"].items()}
    print(f"odh: objects made {objects}; lock stamped, lifted, StatefulSet "
          f"of 1 replica, pod at events "
          f"{list(odh['admitted']['order'].values())}; card pod after the "
          f"restart {odh['restarted']['pod']}; replicated pods' CA volume "
          f"and sidecar ports {replicas}; promoted Service selectors "
          f"{odh['promoted']}; [reconciles or admissions, wall ms] by "
          f"controller {timing}; {smi}", flush=True)
    print("notebook_train controller: " + "; ".join(
        f"{stage} {c['reconciles']} reconciles, {c['wall_ms']:.2f} ms"
        for stage, c in controller.cost["stages"].items())
        + f"; in all {controller.cost['reconciles']} reconciles, "
        f"{controller.cost['wall_ms']:.2f} ms; {smi}", flush=True)
    emit(res)
    print(f"notebook_train: checkpoint {ckpt_bytes} bytes ({gb:.3f} GB), "
          f"save {res['save_s']:.3f} s ({res['save_gb_s']:.3f} GB/s), "
          f"restore {restore_s:.3f} s ({res['restore_gb_s']:.3f} GB/s); "
          f"run A {a_step_s:.4f} s a step against {resident_s:.4f} s on a "
          f"resident batch; {smi}", flush=True)
    print(f"notebook_train telemetry: {annotation_payload(summary)}",
          flush=True)
    print("notebook_train examples, side by side: " + "; ".join(
        f"{res['example_launchers'][key]} {ex['s']:.2f} s, "
        f"rc {ex['returncode']}" for key, ex in examples.items())
        + f"; {smi}", flush=True)
    for key, ex in examples.items():
        if not ex["ok"]:
            raise RuntimeError(f"the {key} launch of the example failed "
                               f"({ex['returncode']}):\n"
                               f"{ex['stdout'][-2000:]}"
                               f"{ex['stderr'][-4000:]}")
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

    # the NCCL probe's two interpreters start while nvcc builds; the
    # kernel phase waits for their answer, so no probe runs beside it
    probe = start_nccl_probe()
    t0 = time.perf_counter()
    built = _build.build_all([i4.SOURCE, fa.SOURCE])
    build_s = time.perf_counter() - t0
    nccl = finish_nccl_probe(probe)
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
    timed("tools", tools_phase, device, smi, db)
    tr = timed("train", train_phase, device, device_name, flash_results,
               flush)
    # the wire step's processes run beside gemma_train's device-bound steps
    wire_started = start_wire_step(device_name, torch.cuda.device_count())
    gemma = timed("gemma_train", gemma_train_phase, device, device_name,
                  smi, flash_results, flush)
    wire = timed("wire", finish_wire_step, wire_started)
    shard = wire.pop("shard")
    fleet = wire.pop("fleet")
    soak = wire.pop("soak")
    emit({"phase": "wire", "nvidia_smi": smi, **wire})
    emit({"step": "shard", "nvidia_smi": smi, **shard})
    emit({"step": "fleet", "nvidia_smi": smi, **fleet})
    emit({"step": "soak", "nvidia_smi": smi, **soak})
    del flush
    long_context = timed("long_context", long_context_phase, device)
    mt = timed("moe_train", moe_train_phase, device, device_name)
    timed("moe_serve", moe_serve_phase, device)
    mesh = timed("mesh_train", mesh_train_phase, device, smi,
                 tr["step_time_s"])
    pipe = timed("pipeline_train", pipeline_train_phase, device, smi, nccl)
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
