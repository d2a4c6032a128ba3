"""End-to-end in-notebook serving workflow: train -> quantize -> decode.

The port's twin of examples/serve_model.py, what a workbench user runs
to serve a model they just trained:

  1. train TINY a few steps (a stand-in for a real checkpoint);
  2. plain KV-cache decode (`generate`: fused projections; on the card
     the single-token steps replay one captured CUDA graph);
  3. int8 weight-streaming decode (`fuse_decode_params`, then
     `quantize_params`: fuse first, so the scales stay per projection),
     its tokens checked against the plain decode's;
  4. greedy speculative decoding with the model as its own draft, equal
     to plain greedy decode (the port has no staged KV writes, so its
     plain decode is the reference's unstaged run);
  5. temperature sampling through the rejection-sampling speculative
     mode.

    python -m kubeflow_tpu_torch.examples.serve_model          # the card
    python -m kubeflow_tpu_torch.examples.serve_model --cpu    # the CPU

Prints RESULT: OK when every stage behaves, and exits non-zero otherwise.
"""

from __future__ import annotations

import argparse
import sys

TRAIN_STEPS, BATCH, SEQ = 5, 4, 64
PROMPT, NEW = 16, 12
MIN_INT8_AGREEMENT = 0.8


def run(device: str) -> None:
    import torch

    from ..models.configs import TINY
    from ..models.convert import flax_tree
    from ..models.generate import (
        decode_config,
        fuse_decode_params,
        generate,
    )
    from ..models.quant import quantize_params
    from ..models.speculative import speculative_generate, speculative_sample
    from ..models.train import default_optimizer, setup_training

    cfg = TINY
    setup = setup_training(cfg, device=device,
                           optimizer=default_optimizer(learning_rate=1e-3))
    gen = torch.Generator(device=device).manual_seed(0)
    inputs = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen,
                           device=device)
    data = {"inputs": inputs, "targets": torch.roll(inputs, -1, dims=1)}
    state = setup.state
    for _ in range(TRAIN_STEPS):
        state, metrics = setup.train_step(state, data)
    print(f"trained {TRAIN_STEPS} steps: loss {float(metrics['loss']):.3f}",
          flush=True)
    params = flax_tree(setup.model)

    prompt = inputs[:, :PROMPT]
    out = generate(cfg, params, prompt, max_new_tokens=NEW, device=device)
    if tuple(out.shape) != (BATCH, PROMPT + NEW):
        raise RuntimeError(f"decoded shape {tuple(out.shape)}")
    print("plain decode:", out[0, PROMPT:].tolist(), flush=True)

    # int8: fuse FIRST (per-projection scales), then quantize
    dcfg = decode_config(cfg)
    qparams = quantize_params(fuse_decode_params(params))
    qout = generate(dcfg.with_(weight_dtype="int8"), qparams, prompt,
                    max_new_tokens=NEW, device=device)
    agree = (out == qout).float().mean().item()
    print(f"int8 decode: token agreement vs plain = {agree:.2f}", flush=True)
    if not agree > MIN_INT8_AGREEMENT:
        raise RuntimeError(f"int8 decode agrees on {agree} of the tokens "
                           f"(limit {MIN_INT8_AGREEMENT})")

    spec_out, rounds = speculative_generate(cfg, params, cfg, params, prompt,
                                            NEW, gamma=4, device=device)
    if not torch.equal(spec_out, out):
        raise RuntimeError("speculative output differs from plain greedy")
    print(f"speculative (self-draft): exact in {rounds} rounds", flush=True)

    samp, steps, rate = speculative_sample(
        cfg, params, cfg, params, prompt, NEW, gamma=4, temperature=0.8,
        generator=torch.Generator(device=device).manual_seed(7),
        device=device)
    if tuple(samp.shape) != (BATCH, PROMPT + NEW):
        raise RuntimeError(f"sampled shape {tuple(samp.shape)}")
    print(f"sampled decode: accept_rate {rate:.2f} in {steps} rounds",
          flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card")
    args = parser.parse_args(argv)
    if not args.cpu:
        import torch

        if not torch.cuda.is_available():
            print("serve_model: no CUDA card (pass --cpu to run on the CPU)",
                  file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
    run("cpu" if args.cpu else "cuda")
    print("RESULT: OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
