"""Small stand-ins for the cells' shapes and mixes, for CPU runs."""

from __future__ import annotations

import dataclasses

from benchmark.shapes import load_shape


def shape(config: str, logit_scale: bool = False, **kw):
    """`config`'s Shape cut to a CPU test's size (same assumed settings).
    With `logit_scale` the weights' scale grows so that the logits keep
    the cell's scale (init_std x sqrt(hidden) held), which the serving
    limit, in logits, needs."""
    s = load_shape(config)
    small = dict(vocab=256, layers=2, dim=128, heads=2, kv_heads=1,
                 head_dim=64, mlp=256)
    if logit_scale:
        small["init_std"] = s.init_std * (s.dim / 128) ** 0.5
    if s.moe:
        small.update(experts=4)
    small.update(kw)
    return dataclasses.replace(s, name=s.name + "-tiny", **small)


TRAIN_MIX = {"kind": "train", "batch": 2, "seq": 128}
CHAT_MIX = {"kind": "generate", "batch": 2, "prompt_lens": [8, 12],
            "new_tokens": 6, "max_seq_len": 32}


# Limits at this size, for the fault tests: set from this size's sound
# and control readings on the CPU (seeds 2147483651-653, both training
# cells: sound at most loss 6.3e-5, grad 1.7e-3, change 1.2e-3; the fp8
# control at least 1.7e-4, 7.1e-3, 1.9e-3), as the cells' own limits are
# set from theirs on the card.  Serving keeps the
# cell's limit: with `logit_scale` its logits have the cell's scale.
TRAIN_LIMITS = {"loss_rel": 1.5e-4, "grad_gap": 8e-3, "change_gap": 1.5e-3}
