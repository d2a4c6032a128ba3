"""Logical-axis sharding rules: the port of
kubeflow_tpu/parallel/sharding.py.

Parameters and activations carry *logical* axis names ("batch", "embed",
"mlp", ...); the rule table binds them to the mesh axes of
parallel/mesh.py, so sharding lives in one table.  `logical_to_spec`
resolves names to mesh axes with the reference's first-come-first-served
claiming, and returns what a jax PartitionSpec holds: for each tensor
dim None, one mesh axis, or a tuple of them (outermost first).
`spec_placements` turns such a spec into DTensor placements, one per mesh
dim, and `local_shard` cuts this rank's block out of a full tensor with
DTensor's own split.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .mesh import MESH_AXES, mesh_sizes

# logical name -> mesh axis (or tuple of axes); None = replicated
DEFAULT_RULES: tuple[tuple[str, object], ...] = (
    ("layers", None),                # stacked-layer axis (pipeline stages)
    ("batch", ("data", "fsdp")),     # activation batch over all DP-ish axes
    ("seq", "sequence"),             # activation sequence (context parallel)
    ("embed", "fsdp"),               # parameter embed dim (ZeRO-3)
    ("heads", "tensor"),             # attention heads (Megatron)
    ("kv", None),                    # per-head dim stays local
    ("mlp", "tensor"),               # MLP hidden (Megatron)
    ("vocab", "tensor"),             # embedding/logits vocab dim
    ("norm", None),
)


def rules_for_mesh(mesh) -> tuple[tuple[str, object], ...]:
    """DEFAULT_RULES specialized to the mesh's populated axes (`mesh` a
    DeviceMesh or a resolved MeshConfig):

    - a populated "pipeline" axis shards the stacked "layers" axis;
    - the "expert" logical axis (the MoE expert stack and its token
      buffers) shards over the mesh's "expert" axis when it is populated;
    - everything else is DEFAULT_RULES."""
    sizes = mesh_sizes(mesh)
    rules = [(name, ax) for name, ax in DEFAULT_RULES if name != "layers"]
    if sizes.get("pipeline", 1) > 1:
        rules.insert(0, ("layers", "pipeline"))
    else:
        rules.insert(0, ("layers", None))
    rules.append(("expert", "expert" if sizes.get("expert", 1) > 1
                  else None))
    return tuple(rules)


def rules_dict(
    rules: Optional[Sequence[tuple[str, object]]] = None,
) -> dict[str, object]:
    return dict(rules if rules is not None else DEFAULT_RULES)


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    rules: Optional[Sequence[tuple[str, object]]] = None,
) -> tuple:
    """("batch", "seq", "embed") -> (("data", "fsdp"), "sequence", None).

    A mesh axis may shard only one dimension; later logical axes skip
    mesh axes already claimed by earlier ones (flax's first-come-first-
    served resolution), so "embed" -> "fsdp" yields None here because
    "batch" already took fsdp."""
    table = rules_dict(rules)
    used: set[str] = set()
    entries = []
    for axis in logical_axes:
        mapped = table.get(axis) if axis is not None else None
        if mapped is None:
            entries.append(None)
            continue
        axes = mapped if isinstance(mapped, tuple) else (mapped,)
        free = tuple(a for a in axes if a not in used)
        used.update(free)
        if not free:
            entries.append(None)
        elif len(free) == 1:
            entries.append(free[0])
        else:
            entries.append(free)
    return tuple(entries)


def spec_axes(entry) -> tuple:
    """One spec entry -> the mesh axes it names, outermost first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_placements(spec: Sequence, only: Sequence[str] = MESH_AXES
                    ) -> tuple:
    """A spec -> DTensor placements over the MESH_AXES dims: Shard(d) on
    each mesh dim that shards tensor dim d, Replicate() on the rest.  A
    tensor dim split by several mesh dims is split outermost first, as a
    PartitionSpec splits it.  Mesh axes outside `only` count as
    replicated."""
    from torch.distributed.tensor import Replicate, Shard

    placements = [Replicate()] * len(MESH_AXES)
    for dim, entry in enumerate(spec):
        for axis in spec_axes(entry):
            if axis in only:
                placements[MESH_AXES.index(axis)] = Shard(dim)
    return tuple(placements)


def local_shard(tensor, spec: Sequence, mesh, only: Sequence[str] = MESH_AXES):
    """This rank's block of a full `tensor` that every rank holds alike:
    DTensor's split under `spec_placements(spec, only)`, with nothing
    sent between ranks."""
    from torch.distributed.tensor import distribute_tensor

    for dim, entry in enumerate(spec):
        ways = 1
        for axis in spec_axes(entry):
            ways *= mesh_sizes(mesh)[axis] if axis in only else 1
        if tensor.shape[dim] % ways:
            raise ValueError(f"dim {dim} of size {tensor.shape[dim]} does "
                             f"not split {ways} ways over {entry}")
    return distribute_tensor(tensor, mesh, spec_placements(spec, only),
                             src_data_rank=None).to_local()


__all__ = ["DEFAULT_RULES", "local_shard", "logical_to_spec", "rules_dict",
           "rules_for_mesh", "spec_axes", "spec_placements"]
