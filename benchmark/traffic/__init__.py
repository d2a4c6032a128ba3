"""The one traffic generator: it reads a mix's parameters from
`traffic/<name>.json` and draws the inputs from the run's seed.

Two kinds of mix:

- "train": a training feed.  Every step takes a fresh [batch, seq + 1]
  block of token ids drawn on the device (uniform over the vocabulary);
  inputs are its first seq columns, targets the last seq.  Every row of
  every step differs.
- "generate": one client in a closed loop of `generate` calls.  Each
  call is `batch` prompts of one length (token ids uniform over the
  vocabulary) with `new_tokens` greedy tokens;
  the lengths cycle through `prompt_lens`, each cycle in an order drawn
  from the seed, so every seed sends the same sizes in another order.

A mix is data only: a new mix of either kind is a new JSON file.
"""

from __future__ import annotations

import random

import torch

from ..shapes import ROOT, load_json
from ..weights import group_seed


# The keys each kind reads.  Any other key is refused, so that a mix
# cannot state a setting (more clients, sampling, another token
# distribution) that the generator does not run.
KEYS = {"train": {"kind", "batch", "seq", "why"},
        "generate": {"kind", "batch", "prompt_lens", "new_tokens",
                     "max_seq_len", "why"}}


def load(name: str) -> dict:
    mix = load_json(ROOT / "traffic" / f"{name}.json")
    kind = mix.get("kind")
    if kind not in KEYS:
        raise ValueError(f"traffic {name}: unknown kind {kind!r}")
    unread = sorted(set(mix) - KEYS[kind])
    if unread:
        raise ValueError(f"traffic {name}: the {kind} generator reads no "
                         f"{unread}")
    return mix


class TrainFeed:
    """Token blocks for the training steps, in step order."""

    def __init__(self, mix: dict, vocab: int, seed: int, device):
        self.batch, self.seq, self.vocab = mix["batch"], mix["seq"], vocab
        self.gen = torch.Generator(device=device).manual_seed(
            group_seed(seed, "train-data"))
        self.device = device

    def next(self) -> dict:
        block = torch.randint(0, self.vocab, (self.batch, self.seq + 1),
                              generator=self.gen, device=self.device)
        return {"inputs": block[:, :-1], "targets": block[:, 1:]}

    @property
    def tokens(self) -> int:
        return self.batch * self.seq


class PromptFeed:
    """Prompts of the closed loop, one [batch, P] block a call."""

    def __init__(self, mix: dict, vocab: int, seed: int, device):
        self.mix, self.vocab, self.device = mix, vocab, device
        self.batch, self.new_tokens = mix["batch"], mix["new_tokens"]
        self.order = random.Random(group_seed(seed, "prompt-order"))
        self.gen = torch.Generator(device=device).manual_seed(
            group_seed(seed, "prompt-data"))
        self.pending: list = []

    def next_length(self) -> int:
        if not self.pending:
            self.pending = list(self.mix["prompt_lens"])
            self.order.shuffle(self.pending)
        return self.pending.pop(0)

    def next(self) -> torch.Tensor:
        return self.prompt(self.next_length())

    def prompt(self, length: int) -> torch.Tensor:
        return torch.randint(0, self.vocab, (self.batch, length),
                             generator=self.gen, device=self.device)


__all__ = ["KEYS", "PromptFeed", "TrainFeed", "load"]
