"""KV-cache mechanics probe: does the decode step's cache write stay in
place, and how fast does the decode attention read the cache?

The twin of ci/kv_cache_probe.py.  Three bodies over the cache shapes of
`decode_config(BENCH_CHIP)` at batch 16 and max_seq_len 384 (10 layers
x K, V of [16, 12, 384, 128] bf16, 377 MB in all), each run for 255
iterations inside ONE captured CUDA graph (launch overhead out of the
way, as the reference's one jit):

  update-only   `index_copy_` of a one-token slab into every buffer at a
                device position (models/transformer.py's cache write): in
                place it moves the slabs only.
  read-only     `ops/attention.py:decode_attention` over every layer's K
                and V (no write): the read path, its fp32 copies of the
                cache included.
  read+update   both: the decode step's cache mechanics.

Each body's line gives its ms an iteration, `cache_equiv_gbps` (the whole
cache's bytes once over that time, the reference's figure) and
`moved_gbps` (the bytes the body must move: the slabs written, the cache
read, or both), each against the HBM read bandwidth measured first
(tools/decode_profile.py's probe).

    python -m kubeflow_tpu_torch.tools.kv_cache_probe [--cpu]

--cpu runs 2 layers of [2, 2, 16, 8] for 4 iterations eagerly: a smoke
run whose numbers measure no card.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from ..models.generate import warm_up
from ..ops.attention import decode_attention
from .common import emit, run_device, window_ms
from .decode_profile import PROBE_ELEMENTS, measure_hbm_read_gbps

TOOL = "kv_cache_probe"
# layers, batch, kv heads, max_seq_len, head dim
SHAPE = (10, 16, 12, 384, 128)
CPU_SHAPE = (2, 2, 2, 16, 8)
ITERS = 255


def cache_bytes(shape: tuple) -> int:
    """Every layer's K and V, bf16."""
    layers, b, kvh, s, d = shape
    return layers * 2 * b * kvh * s * d * 2


def slab_bytes(shape: tuple) -> int:
    """One token's K and V slabs over every layer, bf16."""
    layers, b, kvh, _, d = shape
    return layers * 2 * b * kvh * d * 2


def bodies(shape: tuple, device: torch.device) -> dict:
    """name -> (body(caches, pos, acc), the bytes it must move)."""
    _, b, kvh, s, d = shape
    slab = torch.ones((b, kvh, 1, d), dtype=torch.bfloat16, device=device)
    q = torch.ones((b, 1, kvh, d), dtype=torch.bfloat16, device=device)

    def update_only(caches, pos, acc):
        for c in caches:
            c.index_copy_(2, pos.view(1), slab)

    def read_only(caches, pos, acc):
        for k, v in zip(caches[0::2], caches[1::2]):
            acc += decode_attention(q, k, v, pos).sum(dtype=torch.float32)

    def read_update(caches, pos, acc):
        update_only(caches, pos, acc)
        read_only(caches, pos, acc)

    cache, slabs = cache_bytes(shape), slab_bytes(shape)
    return {"update-only": (update_only, slabs),
            "read-only": (read_only, cache),
            "read+update": (read_update, cache + slabs)}


def time_body(body, shape: tuple, iters: int, device: torch.device,
              windows: int = 3) -> float:
    """Milliseconds an iteration: the best of `windows` runs of `iters`
    iterations, captured as one CUDA graph on a card."""
    layers, b, kvh, s, d = shape
    caches = [torch.zeros((b, kvh, s, d), dtype=torch.bfloat16,
                          device=device) for _ in range(2 * layers)]
    pos = torch.zeros((), dtype=torch.int64, device=device)
    acc = torch.zeros((), dtype=torch.float32, device=device)

    def loop():
        pos.zero_()
        for _ in range(iters):
            body(caches, pos, acc)
            pos.add_(1).clamp_(max=s - 1)

    run = loop
    if device.type == "cuda":
        warm_up(loop, device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            loop()
        run = graph.replay
    run()
    best = min(window_ms(run, device)[1] for _ in range(windows))
    if not torch.isfinite(acc):
        raise RuntimeError("kv_cache_probe: the read path summed to "
                           f"{float(acc)}")
    return best / iters


def probe(shape: tuple, iters: int, hbm_gbps: float,
          device: torch.device, device_name: str,
          smi: Optional[str]) -> list:
    """The three bodies' lines and the ideal read-once line."""
    lines = []
    cache = cache_bytes(shape)
    for name, (body, moved) in bodies(shape, device).items():
        ms = time_body(body, shape, iters, device)
        lines.append(emit(
            TOOL, name, device_name, smi, shape=list(shape), iters=iters,
            ms_per_iter=ms, cache_mb=cache / 1e6,
            cache_equiv_gbps=cache / (ms / 1e3) / 1e9,
            moved_mb=moved / 1e6, moved_gbps=moved / (ms / 1e3) / 1e9,
            moved_share_of_hbm=moved / (ms / 1e3) / 1e9 / hbm_gbps,
            hbm_gbps=hbm_gbps))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    lines.append(emit(TOOL, "ideal", device_name, smi, shape=list(shape),
                      ms_per_iter=cache / (hbm_gbps * 1e9) * 1e3,
                      hbm_gbps=hbm_gbps))
    return lines


def main(argv: Optional[list] = None) -> list:
    argv = sys.argv[1:] if argv is None else list(argv)
    device, name, smi = run_device(TOOL, argv)
    on_cpu = device.type == "cpu"
    hbm = measure_hbm_read_gbps(device, n=2**20 if on_cpu
                                else PROBE_ELEMENTS)
    return probe(CPU_SHAPE if on_cpu else SHAPE, 4 if on_cpu else ITERS,
                 hbm, device, name, smi)


if __name__ == "__main__":
    main()
