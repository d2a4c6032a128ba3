"""Multi-process dry run of the sharded training step: the port of
__graft_entry__.py:dryrun_multichip.

    python -m kubeflow_tpu_torch.dryrun [N]      # N processes, default 8

runs the sharded step on N gloo processes on the CPU, one rank each,
over the reference's meshes, and checks each for correctness, not just
that it runs: one SGD(0.05) step on a llama-family proxy (GQA 8/4 heads
of 16, gated MLP, rope, remat; 4 layers, embed 128, MLP 256, vocab 512,
seq 1024, fp32) must give a loss in (0, 20) within 1e-3 of a
single-process step on the same batch, and every parameter within rtol =
atol = 1e-4 of it, after an update that moved.  Under SGD the parameter
delta is proportional to the gradient, so the allclose is a gradient
check: a wrong sharding, a missing all-reduce, a broken ring step or a
misrouted microbatch changes the update and fails it.

Meshes (the reference's selection at N devices): dense fsdp x sequence x
tensor; two slices of data parallelism with sequence x tensor inside;
pipeline 2 x sequence x tensor under GPipe and under 1F1B; MoE (4
experts, top-2, capacity 2.0) expert x tensor x data, expert x sequence
x tensor and expert 2 x pipeline 2 x tensor under GPipe (all but the
first N a multiple of 8).  The pipeline meshes take the reference's
microbatch counts (`microbatches`).  It prints one `ok` line per mesh.

The per-rank workers live here, so spawned processes import this package
and nothing else.  `sharded_step` is also what the tests run on their
own meshes, from this proxy's weights or from converted ones, and
`tensor_decode` runs tensor-parallel greedy decode (`generate(mesh=)`)
on a tensor mesh of the launch's ranks.
"""

from __future__ import annotations

import multiprocessing.connection
import os
import sys
import tempfile
import time
from typing import Optional

import torch

from .models.configs import TransformerConfig
from .parallel.mesh import MESH_AXES, MeshConfig

LR = 0.05
LOSS_TOL = 1e-3
PARAM_RTOL = PARAM_ATOL = 1e-4
DATA_SEED = 17
SEQ = 1024
MOE = {"moe_experts": 4, "moe_top_k": 2, "moe_capacity_factor": 2.0}


def proxy_config(seq: int = SEQ, moe: bool = False) -> TransformerConfig:
    """The reference dry run's proxy: structurally the flagship (GQA,
    gated MLP, rope, remat), fp32 so the allclose tolerance is
    meaningful."""
    cfg = TransformerConfig(vocab_size=512, num_layers=4, embed_dim=128,
                            num_heads=8, num_kv_heads=4, head_dim=16,
                            mlp_dim=256, max_seq_len=seq, dtype="float32",
                            param_dtype="float32")
    return cfg.with_(**MOE) if moe else cfg


def dryrun_meshes(n: int) -> tuple[list, list, int]:
    """(dense meshes, MoE meshes, batch) at n devices, as the reference
    picks them: tensor 2 when n is even, sequence 2 when n % 4 == 0, the
    rest to the largest power of two of fsdp that divides it; the batch
    rounds 8 up to a multiple of the data*fsdp group.  Each mesh is a
    (MeshConfig, pipeline schedule) pair."""
    tensor = 2 if n % 2 == 0 else 1
    sequence = 2 if n % 4 == 0 else 1
    group = max(1, n // (tensor * sequence))
    fsdp = 1
    while fsdp * 2 <= 128 and group % (fsdp * 2) == 0:
        fsdp *= 2
    dense = [MeshConfig(data=-1, fsdp=fsdp, sequence=sequence,
                        tensor=tensor)]
    if n % 8 == 0 and (n // (max(1, fsdp // 2) * sequence * tensor)) % 2 == 0:
        dense.append(MeshConfig(data=-1, fsdp=max(1, fsdp // 2),
                                sequence=sequence, tensor=tensor,
                                num_slices=2))
    dense = [(m, "gpipe") for m in dense]
    moe = []
    if n % 8 == 0:
        staged = MeshConfig(data=-1, sequence=sequence, tensor=tensor,
                            pipeline=2)
        dense += [(staged, "gpipe"), (staged, "1f1b")]
        moe += [(MeshConfig(data=-1, tensor=tensor, expert=2), "gpipe"),
                (MeshConfig(data=-1, sequence=sequence, tensor=tensor,
                            expert=2), "gpipe"),
                (MeshConfig(data=-1, tensor=tensor, expert=2, pipeline=2),
                 "gpipe")]
    batch = group * max(1, -(-8 // group))
    return dense, moe, batch


def microbatches(resolved: MeshConfig, schedule: str, batch: int) -> int:
    """The reference dry run's microbatch count on a resolved mesh (0
    without a pipeline): each microbatch divides by data*fsdp, and under
    1F1B each rank's share of one holds at least two rows."""
    if resolved.pipeline <= 1:
        return 0
    group = max(1, resolved.data * resolved.fsdp)
    if schedule == "1f1b":
        return max(2, batch // (2 * group))
    return max(2, batch // group)


def make_batch(vocab: int, batch: int, seq: int,
               seed: int = DATA_SEED) -> dict:
    """Seeded token ids [batch, seq] and their next-token targets."""
    gen = torch.Generator().manual_seed(seed)
    inputs = torch.randint(0, vocab, (batch, seq), generator=gen)
    return {"inputs": inputs, "targets": torch.roll(inputs, -1, dims=1)}


def _setup(cfg: TransformerConfig, mesh, state_dict: Optional[dict],
           schedule: str = "gpipe", micro: int = 0):
    """(model, train_step, state) for one SGD(LR) step: setup_training's
    weights from seed 0, or `state_dict`'s full tensors (a pipeline
    stage loads those of its own layers)."""
    from .models import train
    from .models.transformer import Transformer

    if state_dict is None:
        setup = train.setup_training(cfg, mesh, device="cpu",
                                     optimizer=train.SGD(LR),
                                     pipeline_microbatches=micro,
                                     pipeline_schedule=schedule)
        return setup.model, setup.train_step, setup.state
    model = Transformer(cfg, "cpu", mesh)
    model.load_state_dict({k: state_dict[k] for k in model.state_dict()},
                          strict=True)
    if mesh is not None:
        train.parallelize(model, mesh)
    optimizer = train.SGD(LR)
    return (model, train.make_train_step(model, optimizer, micro, schedule),
            train.TrainState(model, optimizer))


def reference_step(cfg: TransformerConfig, batch: dict,
                   state_dict: Optional[dict] = None) -> dict:
    """One single-process SGD(LR) step: {"loss", "params" (full tensors
    after the step, by name), "moved" (the largest change of any
    parameter)}."""
    model, step, state = _setup(cfg, None, state_dict)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, metrics = step(state, batch)
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    moved = max(float((after[n] - before[n]).abs().max()) for n in after)
    return {"loss": float(metrics["loss"]), "params": after, "moved": moved}


def sharded_step(cfg: TransformerConfig, mesh_config: MeshConfig,
                 batch: dict, reference: dict,
                 state_dict: Optional[dict] = None, schedule: str = "gpipe",
                 micro: int = 0) -> dict:
    """One sharded SGD(LR) step on `mesh_config` over the default process
    group, held to `reference` (see `reference_step`): every rank compares
    its shards with the same blocks of the reference's parameters (a
    pipeline stage, its own layers').  A pipeline mesh runs `schedule`
    with `micro` microbatches (0: the default).  Returns, alike on every
    rank, the mesh, the loss, the reference's, the global gradient norm,
    the largest parameter error and the names of parameters outside rtol
    = atol = 1e-4 (or held by no rank)."""
    import torch.distributed as dist

    from .models.train import local_tensor
    from .parallel.mesh import make_mesh
    from .parallel.sharding import local_shard

    mesh = make_mesh(mesh_config, device="cpu")
    model, step, state = _setup(cfg, mesh, state_dict, schedule, micro)
    _, metrics = step(state, batch)
    mine = {}
    with torch.no_grad():
        for name, param in model.named_parameters():
            want = local_shard(reference["params"][name],
                               model.param_specs[name], mesh)
            err = (local_tensor(param) - want).abs()
            mine[name] = (float(err.max()), float(
                (err - PARAM_ATOL - PARAM_RTOL * want.abs()).max()))
    # pipeline stages hold different layers: merge the ranks' reports
    reports = [None] * dist.get_world_size()
    dist.all_gather_object(reports, mine)
    worst: dict = {}
    for report in reports:
        for name, (err, excess) in report.items():
            old = worst.get(name, (0.0, float("-inf")))
            worst[name] = (max(old[0], err), max(old[1], excess))
    resolved = mesh_config.resolved(dist.get_world_size())
    return {
        "mesh": dict(zip(MESH_AXES, resolved.shape)),
        "slices": resolved.num_slices, "schedule": schedule,
        "microbatches": micro,
        "loss": float(metrics["loss"]), "ref_loss": reference["loss"],
        "grad_norm": float(metrics["grad_norm"]),
        "moved": reference["moved"],
        "max_param_err": max(err for err, _ in worst.values()),
        "mismatches": [f"{n}: {err:.2e}" for n, (err, excess) in
                       sorted(worst.items()) if excess > 0]
        + [f"{n}: held by no rank"
           for n in sorted(set(reference["params"]) - set(worst))],
    }


def failures(result: dict) -> list:
    """The dry run's gates on one `sharded_step` result."""
    bad = []
    if not result["moved"] > 0.0:
        bad.append("the single-process update is zero: the allclose would "
                   "be vacuous")
    if not 0.0 < result["loss"] < 20.0:
        bad.append(f"implausible loss {result['loss']}")
    if not abs(result["loss"] - result["ref_loss"]) < LOSS_TOL:
        bad.append(f"sharded loss {result['loss']:.6f} != single-process "
                   f"{result['ref_loss']:.6f}")
    if result["mismatches"]:
        bad.append(f"parameters diverge: {result['mismatches'][:5]}")
    return bad


def run_meshes(cfg: TransformerConfig, meshes: list, batch: dict,
               reference: dict) -> list:
    """Rank worker: `sharded_step` on each (mesh, schedule) in turn, with
    the reference's microbatch count."""
    import torch.distributed as dist

    rows, world = batch["inputs"].shape[0], dist.get_world_size()
    return [sharded_step(cfg, m, batch, reference, schedule=schedule,
                         micro=microbatches(m.resolved(world), schedule,
                                            rows))
            for m, schedule in meshes]


def tensor_decode(cases: list, prompt: torch.Tensor, new_tokens: int
                  ) -> list:
    """One rank of tensor-parallel greedy decode on the CPU, at a tensor
    degree of the world size: for each (cfg, tree) of `cases` (a
    training config and a reference-layout tree), the decode model
    converted into this rank's blocks, its prefill logits of `prompt`
    gathered over "tensor" and `generate(mesh=)`'s tokens.  Returns, per
    case, {"logits": [B, P, V], "tokens": every rank's tokens}."""
    import torch.distributed as dist

    from .models.convert import params_from_flax
    from .models.generate import (
        full_logits,
        generate,
        prepare_decode,
        vocab_group,
    )
    from .parallel.mesh import make_mesh

    world = dist.get_world_size()
    mesh = make_mesh(MeshConfig(tensor=world), device="cpu")
    results = []
    for cfg, tree in cases:
        cfg, tree = prepare_decode(cfg, tree)
        model = params_from_flax(tree, cfg, "cpu", mesh)
        with torch.inference_mode():
            logits = full_logits(model(prompt, cache=model.new_cache(
                prompt.shape[0])), vocab_group(model))
        tokens = generate(cfg, model, prompt, new_tokens, mesh=mesh,
                          device="cpu")
        every = [None] * world
        dist.all_gather_object(every, tokens)
        results.append({"logits": logits, "tokens": every})
    return results


def _rank_main(rank: int, world: int, init: str, out: str, target,
               args: tuple) -> None:
    import warnings

    import torch.distributed as dist

    # FSDP2 warns that the model returns a view (its logits' reshape):
    # nothing here writes into a model output in place
    warnings.filterwarnings("ignore", message=".*returned a view tensor")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        result = target(*args)
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


def launch(world: int, target, args: tuple = (), timeout: float = 900.0):
    """Run `target(*args)` on `world` spawned gloo CPU processes (one
    thread each, rendezvous through a file in a fresh temporary
    directory) and return rank 0's result.  A rank that fails or a run
    past `timeout` seconds stops every rank and raises."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.pt")
        procs = [ctx.Process(target=_rank_main, args=(
            rank, world, f"file://{os.path.join(tmp, 'rendezvous')}", out,
            target, args)) for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            pending = list(procs)
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world} ranks ran past {timeout} s")
                multiprocessing.connection.wait(
                    [p.sentinel for p in pending], timeout=left)
                for p in [p for p in pending if not p.is_alive()]:
                    pending.remove(p)
                    if p.exitcode != 0:
                        raise RuntimeError(
                            f"rank {procs.index(p)} exited with "
                            f"{p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        return torch.load(out, weights_only=False)


def main(n: int) -> int:
    t0 = time.perf_counter()
    dense, moe, batch_size = dryrun_meshes(n)
    data = make_batch(512, batch_size, SEQ)
    failed = False
    for label, cfg, meshes in (("dense", proxy_config(), dense),
                               ("moe", proxy_config(moe=True), moe)):
        if not meshes:
            continue
        reference = reference_step(cfg, data)
        for result in launch(n, run_meshes, (cfg, meshes, data, reference)):
            bad = failures(result)
            failed |= bool(bad)
            mesh = {k: v for k, v in result["mesh"].items()}
            status = "FAILED " + "; ".join(bad) if bad else "ok"
            staged = (f" schedule={result['schedule']} microbatches="
                      f"{result['microbatches']}"
                      if result["mesh"]["pipeline"] > 1 else "")
            print(f"dryrun_multichip {status} [{label}]: mesh={mesh} "
                  f"slices={result['slices']}{staged} devices={n} seq={SEQ} "
                  f"loss={result['loss']:.4f} ref_loss="
                  f"{result['ref_loss']:.4f} max_param_err="
                  f"{result['max_param_err']:.2e} (ring attention: "
                  f"{result['mesh']['sequence'] > 1}; param-update allclose "
                  f"vs single-process: {'fail' if bad else 'pass'})",
                  flush=True)
    print(f"dryrun_multichip wall time on the CPU: "
          f"{time.perf_counter() - t0:.1f} s ({n} gloo processes)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 8))
