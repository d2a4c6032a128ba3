"""The numbers that decide `correct`, each beside its limit.

Training (program against the reference, over the same first steps):
- `loss_rel`: the largest |loss - reference loss| / |reference loss|;
- `grad_gap`: over the leaves, the largest gap between the program's and
  the reference's norm of the first gradient as the optimizer gets it,
  over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
- `change_gap`: the same for the norm of the parameters' change over the
  steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (their change is round-off);
- `grad_gap_median`, `change_gap_median`: the median leaf's gaps, steady
  from seed to seed where a few leaves carry round-off's noise.
Serving:
- `served_gap`: the widest gap by which a served token's reference logit
  lies below the reference's best at its position.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def leaf_gaps(program: dict, reference: dict, keep=None) -> dict:
    """{leaf: |p - r| / max(r, median r)}; a leaf the program lacks reads
    as infinitely far."""
    keys = [k for k in reference if keep is None or k in keep]
    median = statistics.median(reference[k] for k in keys)
    return {k: abs(program[k] - reference[k]) / max(reference[k], median)
            if k in program else float("inf") for k in keys}


def leaf_gap(program: dict, reference: dict, keep=None) -> float:
    """The worst leaf's gap."""
    return max(leaf_gaps(program, reference, keep).values())


def worst_leaves(program: dict, reference: dict, keep=None, n=4) -> list:
    """[(leaf, gap)] of the `n` widest gaps: where a number comes from."""
    gaps = leaf_gaps(program, reference, keep)
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:n]


def moving_leaves(ref_grad: dict) -> set:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    median = statistics.median(ref_grad.values())
    return {k for k, v in ref_grad.items() if v >= 1e-3 * median}


def train_numbers(program, reference) -> dict:
    """{number: value} of program readings against reference readings
    (`reference.adamw.Readings` both)."""
    losses = [abs(p - r) / abs(r)
              for p, r in zip(program.losses, reference.losses)]
    if len(program.losses) != len(reference.losses):
        losses.append(float("inf"))
    moving = moving_leaves(reference.grad)
    grad = leaf_gaps(program.grad, reference.grad)
    change = leaf_gaps(program.change, reference.change, moving)
    return {
        "loss_rel": max(losses),
        "grad_gap": max(grad.values()),
        "change_gap": max(change.values()),
        "grad_gap_median": statistics.median(grad.values()),
        "change_gap_median": statistics.median(change.values()),
    }


def judged(numbers: dict, limits: dict) -> list:
    """[Check] of every number that has a limit."""
    return [Check(k, float(numbers[k]), float(limits[k]))
            for k in limits if k in numbers]


__all__ = ["Check", "judged", "leaf_gap", "leaf_gaps", "moving_leaves",
           "train_numbers", "worst_leaves"]
