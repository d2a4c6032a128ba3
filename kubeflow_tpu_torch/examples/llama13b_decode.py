"""13B-class int4 decode on one card: the twin of ci/llama13b_decode.py.

Llama-2-13B at full width and depth (40 layers, width 5120, MLP 13824),
its weights made leaf by leaf on the card and each int4-quantized there
(models/quant.py `fill_random`: no bf16 copy of the 26 GB model is ever
held), served by `generate` through the hand-written int4 kernel at
batch 16, prompt 128, 128 new tokens, greedy; the single-token steps
replay one captured CUDA graph.  The int4 kernel runs at this model's
widths: K 5120 and 13824, N 15360 (fused qkv), 27648 (fused gate/up),
5120 and 32000.

    python -m kubeflow_tpu_torch.examples.llama13b_decode [batch] [new]

Prints one JSON line: tokens/s (the best of 3 calls, each on a fresh
seeded prompt, after one warm-up call) against the int4 + KV roofline
(the streamed int4 bytes and the whole static KV cache read once a step
at the card's memory rate) and the peak memory.
"""

from __future__ import annotations

import json
import sys
import time

BATCH, PROMPT, NEW = 16, 128, 128
SEED = 0
TIMED_CALLS = 3


def config(prompt_len: int = PROMPT, new_tokens: int = NEW):
    """The decode config: Llama-2-13B, fused projections, int4 weights,
    bf16 embedding and norms, max_seq_len prompt + new."""
    from ..models.configs import LLAMA2_13B
    from ..models.generate import decode_config

    return decode_config(LLAMA2_13B).with_(
        max_seq_len=prompt_len + new_tokens, weight_dtype="int4",
        param_dtype="bfloat16")


def build(device="cuda", prompt_len: int = PROMPT, new_tokens: int = NEW,
          seed: int = SEED):
    """(cfg, model, streamed int4 bytes): the model with random weights
    made and quantized on `device`, from a generator seeded `seed`."""
    import torch

    from ..models.quant import fill_random
    from ..models.transformer import Transformer

    cfg = config(prompt_len, new_tokens)
    model = Transformer(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    streamed = fill_random(model, gen)
    return cfg, model, streamed


def roofline_tok_s(weight_bytes: float, kv_bytes: float, batch: int,
                   hbm_gbps: float) -> float:
    """Tokens/s if a step did nothing but read the streamed weights and
    the KV cache once at `hbm_gbps`."""
    return hbm_gbps * 1e9 / (weight_bytes + kv_bytes) * batch


def measure(cfg, model, batch: int = BATCH,
            new_tokens: int = NEW) -> dict:
    """The JSON record of `model` (from `build`) on its card: one warm-up
    `generate`, then the best of 3 timed calls (TIMED_CALLS)."""
    import torch

    from ..models.convert import flax_tree
    from ..models.generate import generate
    from ..models.quant import quantized_bytes
    from ..runtime.roofline import GPU_PEAKS, decode_kv_bytes

    device = model.device
    tree = flax_tree(model)
    w_bytes = quantized_bytes(tree)         # streamed (embed lookup excluded)
    resident_bytes = quantized_bytes(tree, exclude=())
    del tree
    kv_bytes = decode_kv_bytes(cfg, batch)

    def prompt(seed: int) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed(seed)
        return torch.randint(0, cfg.vocab_size, (batch, PROMPT),
                             generator=gen, device=device)

    generate(cfg, model, prompt(0), new_tokens)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    best = 0.0
    for i in range(TIMED_CALLS):
        p = prompt(100 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(cfg, model, p, new_tokens)
        torch.cuda.synchronize()
        best = max(best, batch * new_tokens / (time.perf_counter() - t0))
    if tuple(out.shape) != (batch, PROMPT + new_tokens):
        raise RuntimeError(f"generate returned {tuple(out.shape)}")
    name = torch.cuda.get_device_name(device)
    peak = GPU_PEAKS.get(name)
    roofline = (None if peak is None
                else roofline_tok_s(w_bytes, kv_bytes, batch, peak.hbm_gbps))
    return {
        "metric": "decode_tok_s_h100_llama13b_int4",
        "value": round(best, 1),
        "unit": "tokens/s",
        "vs_baseline": None if roofline is None else round(best / roofline,
                                                           4),
        "detail": {
            "model": "llama2-13b-arch", "batch": batch,
            "prompt_len": PROMPT, "new_tokens": new_tokens,
            "weight_gb": round(resident_bytes / 2**30, 2),
            "streamed_weight_gb": round(w_bytes / 2**30, 2),
            "kv_cache_gb": round(kv_bytes / 2**30, 2),
            "bf16_equiv_gb": round(cfg.num_params * 2 / 2**30, 1),
            "hbm_roofline_tok_s": (None if roofline is None
                                   else round(roofline, 1)),
            "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 2**30,
                                 2),
            "device": name,
        },
    }


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else list(argv)
    if not torch.cuda.is_available():
        print("llama13b_decode: no CUDA card", file=sys.stderr)
        return 2
    batch = int(argv[0]) if len(argv) > 0 else BATCH
    new_tokens = int(argv[1]) if len(argv) > 1 else NEW
    cfg, model, _ = build("cuda", PROMPT, new_tokens)
    print(json.dumps(measure(cfg, model, batch, new_tokens)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
