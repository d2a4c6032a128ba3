"""Served tokens against the float32 reference.

`decode_weights` makes the served model's weights again from the seed,
in bf16 as served, and works the int4 layers out again with the frozen
quantizer: every dense kernel (q, k, v, out, gate, up, down, the head)
dequantized to fp32; the embedding and the norm scales as their bf16
values.  `gaps` runs the reference once over each row's prompt and
served tokens and returns, at each served position, how far the served
token's logit lies below the reference's best there; with `pick` it
reads instead the gap of the token that `pick`'s logits put first (the
control's).
"""

from __future__ import annotations

import math

import torch

from .. import weights as W
from ..shapes import Shape
from . import model
from .int4 import dequantized
from .precision import EXACT

_FLAT_IN = {"out": 2}   # groups whose contract spans two dims


def decode_weights(shape: Shape, seed: int, device) -> dict:
    """{group: fp32 per-layer list or tensor} of the served int4 model."""
    out = {}
    for name in W.groups(shape):
        group = W.make(shape, name, seed, torch.bfloat16, device)
        keys = W.layer_slices(shape, name)
        if name in W.NORMS or name == "embed":
            tensors = [W.leaf(group, k).float() for k in keys]
        else:
            tensors = []
            for k in keys:
                kernel = W.leaf(group, k)
                n_in = _FLAT_IN.get(name, 1)
                flat = kernel.reshape(math.prod(kernel.shape[:n_in]), -1)
                tensors.append(dequantized(flat).reshape(kernel.shape))
        out[name] = tensors if "/" in keys[0] else tensors[0]
        del group
    return out


def gaps(w: dict, rows: list, shape: Shape, prec=EXACT) -> list:
    """rows: [(tokens [T] int64, first served index)] -> for each row a
    [served] tensor: the reference's best logit less the served token's,
    at every position that produced a served token."""
    out = []
    for tokens, first in rows:
        lg = model.logits(w, tokens[None].to(w["head"].device), shape,
                          prec)[0]
        pred = lg[first - 1:tokens.shape[0] - 1]
        served = tokens[first:].to(pred.device)
        out.append(pred.max(-1).values - pred.gather(-1, served[:, None])[:, 0])
    return out


def pick_gaps(w: dict, rows: list, shape: Shape, prec) -> list:
    """The control's reading: at each served position of each row, the
    reference's best logit less the reference's logit of the token that
    the `prec` forward puts first."""
    out = []
    for tokens, first in rows:
        t = tokens[None].to(w["head"].device)
        ref = model.logits(w, t, shape)[0][first - 1:tokens.shape[0] - 1]
        low = model.logits(w, t, shape, prec)[0][first - 1:tokens.shape[0] - 1]
        chosen = low.argmax(-1)
        out.append(ref.max(-1).values - ref.gather(-1, chosen[:, None])[:, 0])
    return out


__all__ = ["decode_weights", "gaps", "pick_gaps"]
