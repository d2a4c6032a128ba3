"""Llama-2-7B decode in int8 on one card.

The twin of ci/llama7b_decode.py: `decode_config(LLAMA2_7B)` with int8
weights (models/quant.py, per-output-channel scales; about 6.7 GB of
int8 kernels where bf16 takes 13.5 GB), batch 4, prompt 128 and 128 new
tokens by default, the single-token steps replayed as one CUDA graph.

The weights are random (decode throughput does not depend on their
values): each leaf of the decode layout is drawn on the host from a
seeded numpy generator (normal x 0.02, the init scale) in bf16, the
tree is quantized on the host, and only the int8 tree goes to the card.
The reference's int8 layer is an XLA dot, so no kernel is ported here:
each `Int8Linear` makes a bf16 copy of its kernel on every call
(`Int8Linear.forward`), and the tool times that copy alone, over every
int8 layer once, as `dequant_ms_per_step`.

It prints one JSON line: tokens/s (the best of 3 event-timed calls after
a warm-up), its fraction of the int8 + KV memory roofline at the spec
sheet's HBM rate (`vs_baseline`, `runtime/roofline.py:GPU_PEAKS`) and at
the rate tools/decode_profile.py's probe measures first.

    python -m kubeflow_tpu_torch.tools.llama7b_decode [batch] [new_tokens]
                                                      [--cpu]

--cpu runs TINY at batch 2, prompt 8, 8 new tokens: a smoke run whose
numbers measure no card.
"""

from __future__ import annotations

import sys
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from ..models.configs import LLAMA2_7B, TINY
from ..models.convert import flax_tree, params_from_flax
from ..models.generate import decode_config
from ..models.quant import Int8Linear, quantize_params, quantized_bytes
from ..models.transformer import Transformer
from ..runtime.roofline import GPU_PEAKS, decode_kv_bytes
from .common import emit, run_device, window_ms
from .decode_profile import PROBE_ELEMENTS, best_tok_s, measure_hbm_read_gbps

TOOL = "llama7b_decode"
PROMPT = 128


def host_random_params(cfg, seed: int = 0) -> dict:
    """The decode layout's tree for `cfg` (shapes from a model on the meta
    device), every leaf drawn on the host from one seeded numpy generator
    as normal x 0.02 and stored in bf16: one leaf's fp32 at a time."""
    rng = np.random.default_rng(seed)

    def materialize(node):
        if isinstance(node, Mapping):
            return {k: materialize(v) for k, v in node.items()}
        arr = rng.standard_normal(tuple(node.shape), dtype=np.float32)
        arr *= 0.02
        return torch.from_numpy(arr).to(torch.bfloat16)

    shapes = Transformer(cfg.with_(weight_dtype=""), "meta")
    return materialize(flax_tree(shapes))


def dequant_ms(model, device) -> float:
    """Milliseconds of every Int8Linear's per-call bf16 copy of its
    kernel (the expression of `Int8Linear.forward`), once each: what one
    decode step spends on it."""
    layers = [m for m in model.modules() if isinstance(m, Int8Linear)]

    def copies():
        for m in layers:
            m.kernel_q.to(m.dtype) * m.kernel_scale.to(m.dtype)

    copies()
    return window_ms(copies, device)[1]


def main(argv: Optional[list] = None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    device, name, smi = run_device(TOOL, argv)
    on_cpu = device.type == "cpu"
    numeric = [int(a) for a in argv if a.isdigit()]
    batch = numeric[0] if numeric else (2 if on_cpu else 4)
    new = numeric[1] if len(numeric) > 1 else (8 if on_cpu else 128)
    prompt_len = 8 if on_cpu else PROMPT
    hbm = measure_hbm_read_gbps(device, n=2**20 if on_cpu
                                else PROBE_ELEMENTS)
    cfg = decode_config(TINY if on_cpu else LLAMA2_7B).with_(
        max_seq_len=prompt_len + new, param_dtype="bfloat16",
        weight_dtype="int8")

    tree = quantize_params(host_random_params(cfg))
    model = params_from_flax(tree, cfg, device)
    with torch.inference_mode():
        dequant = dequant_ms(model, device)
    best = best_tok_s(cfg, model, batch, prompt_len, new, device)

    w_bytes = quantized_bytes(tree)                 # the embedding is a lookup
    resident = quantized_bytes(tree, exclude=())
    kv = decode_kv_bytes(cfg, batch)
    peak = GPU_PEAKS.get(name)

    def roofline(gbps):
        return None if gbps is None else gbps * 1e9 / (w_bytes + kv) * batch

    spec = roofline(None if peak is None else peak.hbm_gbps)
    measured = roofline(hbm)
    card = "cpu" if on_cpu else "h100"     # a CPU run measures no card
    return emit(TOOL, "decode", name, smi,
                metric=f"decode_tok_s_{card}_llama7b_int8",
                value=best, unit="tokens/s",
                vs_baseline=None if spec is None else best / spec,
                detail={
                    "model": "tiny-cpu" if on_cpu else "llama2-7b-arch",
                    "batch": batch, "prompt_len": prompt_len,
                    "new_tokens": new, "cuda_graph": not on_cpu,
                    "weight_gb": resident / 2**30,
                    "streamed_weight_gb": w_bytes / 2**30,
                    "kv_gb": kv / 2**30,
                    "hbm_roofline_tok_s": spec,
                    "measured_hbm_gbps": hbm,
                    "measured_roofline_tok_s": measured,
                    "vs_measured": best / measured,
                    "step_ms": batch / best * 1e3,
                    "dequant_ms_per_step": dequant,
                    "peak_memory_gb": (torch.cuda.max_memory_allocated(
                        device) / 2**30 if not on_cpu else None),
                })


if __name__ == "__main__":
    main()
