"""Seconds from the process's start to the first measured unit:
imports, building the model, the seeded weights, the kernels' build or
load, warming the cell's shapes and its first training steps; the time
spent taking the check's readings is left out."""


def read(run):
    return run.setup_s
