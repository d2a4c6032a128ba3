"""Parallelism: the device mesh, the logical-axis sharding rules that bind
the model to it, and the differentiable collectives of the sharded step.

Exports are lazy (PEP 562): importing this package imports no submodule
(parallel/mesh.py and sharding.py import torch.distributed only inside
their functions).  The reference's `constrain` and `logical_sharding`
have no counterpart: they place a jax array under a NamedSharding, where
the port cuts each parameter to its block once (`local_shard`, DTensor
placements) and runs its collectives explicitly (parallel/collectives.py).
"""

import importlib

_LAZY = {
    "MESH_AXES": ".mesh",
    "MeshConfig": ".mesh",
    "make_mesh": ".mesh",
    "mesh_for_slice": ".mesh",
    "DEFAULT_RULES": ".sharding",
    "logical_to_spec": ".sharding",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod = importlib.import_module(target, __name__)
    value = getattr(mod, name)
    globals()[name] = value  # cache: resolve each export once
    return value
