"""End-to-end speculative decoding: train a target and a draft, then time
plain against speculative decode.  The twin of ci/speculative_demo.py.

Speculative decoding pays only where the draft agrees with the target,
which random weights never do, so both are trained on the same learnable
stream: x_{t+1} = (a x_t + c) mod 1024 with each row's a from {3, 5, 7}
and c from {1, 11, 29}.  The target is BENCH_CHIP-shaped (10 layers,
width 1536, 12 heads of 128) at vocabulary 1024 and max_seq_len 2048,
the draft the same with 2 layers; each trains for `train_steps` steps
(default 150) at batch 16 x 512 through `setup_training`, on the
hand-written flash kernels on the card.

Greedy (default): plain `generate` against `speculative_generate` at
batch 4, prompt 64, 256 new tokens, gamma 4: the best of 3 calls each on
a fresh prompt, the rounds against the ideal ceil(255 / 4) = 64, and the
speedup.  The plain path's single-token steps replay a captured CUDA
graph, and so do the speculative rounds (models/speculative.py
`GraphedRound`), with one host read of the frontier a round.  The
speculative tokens are held to the target's own greedy choice,
teacher forced (models/speculative.py `teacher_forced_gaps`): the share
that are its argmax and the widest gap of the others.

--sample: temperature 0.8, plain sampled `generate` against
`speculative_sample` at gamma 2, 4 and 6, each with its acceptance rate
and rounds.

    python -m kubeflow_tpu_torch.examples.speculative_demo [train_steps]
    python -m kubeflow_tpu_torch.examples.speculative_demo --sample [steps]

Prints one JSON line.
"""

from __future__ import annotations

import json
import math
import sys
import time

import numpy as np

VOCAB, SEQ = 1024, 512
TRAIN_BATCH, TRAIN_STEPS = 16, 150
BATCH, PROMPT, NEW, GAMMA = 4, 64, 256, 4
TEMPERATURE, SAMPLE_GAMMAS = 0.8, (2, 4, 6)


def stream_batch(seed: int, batch: int, seq: int = SEQ) -> dict:
    """{"inputs", "targets"} [batch, seq] int64 numpy arrays of the affine
    stream, rows drawn from a generator seeded `seed`."""
    rng = np.random.default_rng(seed)
    a = rng.choice([3, 5, 7], size=(batch, 1))
    c = rng.choice([1, 11, 29], size=(batch, 1))
    x = np.empty((batch, seq + 1), dtype=np.int64)
    x[:, :1] = rng.integers(0, VOCAB, size=(batch, 1))
    for t in range(seq):
        x[:, t + 1:t + 2] = (a * x[:, t:t + 1] + c) % VOCAB
    return {"inputs": x[:, :seq], "targets": x[:, 1:]}


def configs():
    """(target config, draft config)."""
    from ..models.configs import BENCH_CHIP

    target = BENCH_CHIP.with_(vocab_size=VOCAB, max_seq_len=2048,
                              loss_chunks=16)
    return target, target.with_(num_layers=2)


def train(cfg, steps: int, device, seed: int = 0):
    """(model, last loss): `cfg` trained `steps` steps at TRAIN_BATCH x SEQ
    by AdamW at 1e-3 after 20 warm-up steps."""
    import torch

    from ..models.train import default_optimizer, setup_training

    setup = setup_training(
        cfg, device=device, seed=seed,
        optimizer=default_optimizer(learning_rate=1e-3, warmup_steps=20,
                                    total_steps=max(steps, 21)))
    state = setup.state
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in
                 stream_batch(seed * 100_000 + i, TRAIN_BATCH).items()}
        state, metrics = setup.train_step(state, batch)
    return setup.model, float(metrics["loss"])


def train_pair(steps: int, device="cuda"):
    target_cfg, draft_cfg = configs()
    target, t_loss = train(target_cfg, steps, device)
    draft, d_loss = train(draft_cfg, steps, device, seed=1)
    print(f"trained: target loss {t_loss:.3f}, draft loss {d_loss:.3f}",
          file=sys.stderr, flush=True)
    return target, t_loss, draft, d_loss


def prompt(seed: int, device):
    import torch

    return torch.from_numpy(
        stream_batch(seed, BATCH)["inputs"][:, :PROMPT]).to(device)


def best_of(fn, device, n: int = 3) -> float:
    """Tokens/s of the fastest of `n` calls fn(prompt), each on a fresh
    prompt."""
    import torch

    best = math.inf
    for i in range(n):
        p = prompt(100 + i, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(p, i)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return BATCH * NEW / best


def greedy(target, t_loss: float, draft, d_loss: float, steps: int,
           timed: int = 3) -> dict:
    """The greedy record of a trained pair (`train_pair`'s four values,
    `steps` the training steps they took): the best of `timed` calls of
    each decode after one warm-up call of each."""
    from ..models.generate import generate
    from ..models.speculative import speculative_generate, teacher_forced_gaps

    tc, dc, device = target.cfg, draft.cfg, target.device
    p = prompt(42, device)
    plain = generate(tc, target, p, NEW)                   # warm-up
    out, rounds = speculative_generate(tc, target, dc, draft, p, NEW,
                                       gamma=GAMMA)
    forced = teacher_forced_gaps(target, out, PROMPT)
    plain_tps = best_of(lambda q, i: generate(tc, target, q, NEW), device,
                        timed)
    spec_tps = best_of(lambda q, i: speculative_generate(
        tc, target, dc, draft, q, NEW, gamma=GAMMA), device, timed)
    return {
        "metric": "speculative_speedup_h100",
        "value": round(spec_tps / plain_tps, 3),
        "unit": "x",
        "vs_baseline": round(spec_tps / plain_tps, 3),
        "detail": {
            "plain_tok_s": round(plain_tps, 1),
            "speculative_tok_s": round(spec_tps, 1),
            "rounds_for_256": rounds,
            "ideal_rounds": -(-(NEW - 1) // GAMMA),
            "gamma": GAMMA,
            "same_tokens_as_plain": (out == plain).float().mean().item(),
            "teacher_forced_argmax_share": forced["argmax_share"],
            "teacher_forced_max_gap_rel": forced["max_gap_rel"],
            "train_steps": steps,
            "target_loss": round(t_loss, 3),
            "draft_loss": round(d_loss, 3),
        },
    }


def sample(target, t_loss: float, draft, d_loss: float, steps: int,
           gammas=SAMPLE_GAMMAS, timed: int = 3) -> dict:
    """The sampling record of a trained pair at each of `gammas`."""
    import torch

    from ..models.generate import generate
    from ..models.speculative import speculative_sample

    tc, dc, device = target.cfg, draft.cfg, target.device

    def gen(seed: int):
        return torch.Generator(device=device).manual_seed(seed)

    def plain(q, i):
        return generate(tc, target, q, NEW, temperature=TEMPERATURE,
                        generator=gen(i))

    warm = prompt(42, device)
    plain(warm, 0)
    plain_tps = best_of(plain, device, timed)
    per_gamma, best_tps, best_gamma = {}, 0.0, 0
    for gamma in gammas:
        def spec(q, i, gamma=gamma):
            return speculative_sample(tc, target, dc, draft, q, NEW,
                                      gamma=gamma, temperature=TEMPERATURE,
                                      generator=gen(i))

        _, rounds, rate = spec(warm, 0)
        tps = best_of(spec, device, timed)
        per_gamma[gamma] = {"tok_s": round(tps, 1),
                            "accept_rate": round(rate, 3),
                            "rounds_for_256": rounds}
        if tps > best_tps:
            best_tps, best_gamma = tps, gamma
    return {
        "metric": "speculative_sampling_speedup_h100",
        "value": round(best_tps / plain_tps, 3),
        "unit": "x",
        "vs_baseline": round(best_tps / plain_tps, 3),
        "detail": {
            "plain_sampled_tok_s": round(plain_tps, 1),
            "temperature": TEMPERATURE,
            "best_gamma": best_gamma,
            "per_gamma": per_gamma,
            "train_steps": steps,
            "target_loss": round(t_loss, 3),
            "draft_loss": round(d_loss, 3),
        },
    }


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else list(argv)
    if not torch.cuda.is_available():
        print("speculative_demo: no CUDA card", file=sys.stderr)
        return 2
    sampling = "--sample" in argv
    numeric = [a for a in argv if a.isdigit()]
    steps = int(numeric[0]) if numeric else TRAIN_STEPS
    pair = train_pair(steps)
    result = sample(*pair, steps) if sampling else greedy(*pair, steps)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
