"""The port's compile-check entry: a forward step on the flagship decoder
family, the twin of `__graft_entry__.py:entry`.

    fn, args = entry()
    logits = fn(*args)

`LLAMA2_350M` (24 layers of 16 x 64 heads, width 1024) at max_seq_len
512, weights drawn by `init_params` from a generator seeded 0, on `(2,
512)` tokens of ones.  On the card the forward's attention takes the
hand-written flash forward kernel at head dim 64, one launch a layer;
on the CPU it takes the einsum path.
"""

from __future__ import annotations

import torch

from .models.configs import LLAMA2_350M
from .models.transformer import Transformer, init_params

CONFIG = LLAMA2_350M.with_(max_seq_len=512)


def entry(device="cuda"):
    """(forward, (model, tokens)): `forward(model, tokens)` gives the
    logits [2, 512, 32000] fp32, without gradients.  The model (`CONFIG`)
    and the tokens live on `device`."""
    model = Transformer(CONFIG, device=device)
    init_params(model, torch.Generator(device=device).manual_seed(0))
    tokens = torch.ones((2, 512), dtype=torch.int64, device=device)

    def forward(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return model(tokens)

    return forward, (model, tokens)


__all__ = ["CONFIG", "entry"]
