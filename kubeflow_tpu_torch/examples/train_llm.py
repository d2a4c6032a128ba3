"""End-to-end in-notebook LLM workflow: data -> sharded training -> decode.

The port's twin of examples/train_llm.py, the whole runtime surface in
one script:

  1. `distributed_init()` consumes the controller's env injection: under
     `torchrun` it forms the gang's NCCL world, one rank per GPU, from
     the pod's PET_* env alone; a bare single-host launch starts nothing
     there, and the script starts a one-rank NCCL group on the card;
  2. `input_pipeline` streams rank-sharded, prefetched LM batches;
  3. `setup_training(TINY, mesh)` runs the sharded step over a mesh
     with every populated axis;
  4. a `TelemetryAgent` records one step boundary per synced step;
  5. `generate` decodes from the trained weights, gathered whole.

    torchrun -m kubeflow_tpu_torch.examples.train_llm          # a GPU pod
    python -m kubeflow_tpu_torch.examples.train_llm            # one card
    python -m kubeflow_tpu_torch.examples.train_llm --cpu 8    # 8 gloo CPU
                                                               # processes

`--cpu N` runs N gloo processes on the CPU (kubeflow_tpu_torch/dryrun.py
`launch`) on the reference's mesh for N devices: data x fsdp 2 x tensor
2 at N = 8.  Prints RESULT: OK when every stage behaves, and exits
non-zero otherwise.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

STEPS = 40
GLOBAL_BATCH, SEQ_LEN = 16, 64
# the card the port targets: a CPU run's agent computes MFU against its
# peak, which is no device number, so a CPU run does not print it
CPU_RUN_ACCELERATOR = "NVIDIA H100 80GB HBM3"


def corpus(vocab: int) -> np.ndarray:
    """A toy corpus with learnable structure: ascending token runs."""
    rng = np.random.default_rng(0)
    starts = rng.integers(0, vocab - 64, size=4000)
    return np.concatenate([np.arange(s, s + 16) % vocab for s in starts])


def run(device: str = "cuda") -> dict:
    """One rank's workflow inside the default process group; raises if a
    stage misbehaves."""
    import torch
    import torch.distributed as dist

    from ..models.configs import TINY
    from ..models.generate import generate
    from ..models.train import setup_training, train_state_dict
    from ..models.transformer import Transformer
    from ..parallel.mesh import MeshConfig, make_mesh
    from ..runtime.data import input_pipeline
    from ..runtime.telemetry import TelemetryAgent

    n, rank = dist.get_world_size(), dist.get_rank()
    say = print if rank == 0 else (lambda *a, **k: None)
    on_card = torch.device(device).type == "cuda"
    name = torch.cuda.get_device_name() if on_card else "cpu"
    say(f"devices: {n} x {name}", flush=True)
    mesh = make_mesh(MeshConfig(data=-1, fsdp=2 if n % 4 == 0 else 1,
                                tensor=2 if n % 2 == 0 else 1),
                     device=torch.device(device).type)
    say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}", flush=True)
    setup = setup_training(TINY, mesh, device=device)

    pipe = input_pipeline(corpus(TINY.vocab_size), global_batch=GLOBAL_BATCH,
                          seq_len=SEQ_LEN, mesh=mesh, prefetch=2,
                          device=device)
    # the data-plane telemetry contract: one step_boundary() per synced
    # step (after the host read of the loss); on a provisioned worker the
    # summary publishes into the pod's telemetry annotation
    agent = TelemetryAgent(config=TINY, batch=GLOBAL_BATCH, seq_len=SEQ_LEN,
                           num_chips=n, accelerator="" if on_card
                           else CPU_RUN_ACCELERATOR)
    state, first_loss, last_loss = setup.state, None, None
    agent.step_boundary()
    for step, batch in enumerate(pipe):
        state, metrics = setup.train_step(state, batch)
        loss = float(metrics["loss"])
        agent.step_boundary()
        first_loss = first_loss if first_loss is not None else loss
        last_loss = loss
        if step % 10 == 0:
            say(f"step {step:3d}  loss {loss:.4f}", flush=True)
        if step >= STEPS:
            pipe.close()
            break
    if not last_loss < first_loss:
        raise RuntimeError(f"the loss did not fall: {first_loss} -> "
                           f"{last_loss}")
    summary = agent.summary()
    mfu = (f"mfu {summary['mfu']:.4f}, {summary['bound']}-bound" if on_card
           else "mfu not measured on the CPU")
    say(f"trained: loss {first_loss:.4f} -> {last_loss:.4f}  "
        f"({summary['tokens_per_s']:.0f} tok/s, {mfu})", flush=True)

    # the trained weights, gathered whole (a collective on every rank)
    with torch.no_grad():
        full = {k: v.full_tensor()
                for k, v in train_state_dict(state)["model"].items()}
    model = Transformer(TINY, device)
    model.load_state_dict(full, strict=True)
    prompt = np.stack([np.arange(10, 15), np.arange(100, 105)])
    out = generate(TINY, model, prompt, max_new_tokens=8)
    say("decoded:", out.tolist(), flush=True)
    if tuple(out.shape) != (2, 13):
        raise RuntimeError(f"decoded shape {tuple(out.shape)}, expected "
                           f"(2, 13)")
    return {"first_loss": first_loss, "last_loss": last_loss,
            "steps": summary["steps"], "decoded": out.tolist()}


def _cpu_rank() -> dict:
    return run("cpu")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", type=int, default=0, metavar="N",
                        help="run on N gloo CPU processes instead of the "
                             "card")
    args = parser.parse_args(argv)
    if args.cpu:
        from ..dryrun import launch

        launch(args.cpu, _cpu_rank, timeout=600)
    else:
        import socket

        import torch
        import torch.distributed as dist

        from ..runtime.init import distributed_init

        if not torch.cuda.is_available():
            print("train_llm: no CUDA card (pass --cpu N to run on the CPU)",
                  file=sys.stderr)
            return 2
        identity = distributed_init(device="cuda")
        formed = dist.is_initialized()
        if not formed:
            # a bare launch on a single host: distributed_init starts
            # nothing, and the mesh needs a process group, so this script
            # starts one rank
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            dist.init_process_group("nccl", rank=0, world_size=1,
                                    init_method=f"tcp://localhost:{port}")
        rank = dist.get_rank()
        if rank == 0:
            how = ("distributed_init under torchrun" if identity.torchrun
                   else "distributed_init" if formed
                   else "the one-rank fallback")
            print(f"process group: {dist.get_world_size()} rank(s), "
                  f"{dist.get_backend()}, formed by {how}", flush=True)
        try:
            run("cuda")
        finally:
            dist.destroy_process_group()
        if rank != 0:
            return 0
    print("RESULT: OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
