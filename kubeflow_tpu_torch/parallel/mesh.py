"""Device-mesh construction for training: the port of
kubeflow_tpu/parallel/mesh.py.

The six axes keep the reference's names and order (outermost first):
  data     - batch data parallelism (across slices and within one)
  fsdp     - parameter, gradient and optimizer-state sharding (FSDP2)
  sequence - sequence parallelism (ops/ring_attention.py)
  tensor   - tensor (Megatron) parallelism of heads, MLP and vocabulary
  pipeline - pipeline stages (not ported yet: a degree > 1 is refused by
             the train step)
  expert   - MoE expert parallelism (models/moe.py)

`make_mesh` is `init_device_mesh` over the default process group with
these dim names.  Ranks fill the mesh row-major, so with num_slices > 1
the data dim is slice-major, the layout the reference builds on CPU
devices; a rank here is one process, one card on "cuda".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

MESH_AXES = ("data", "fsdp", "sequence", "tensor", "pipeline", "expert")


@dataclass(frozen=True)
class MeshConfig:
    """Parallelism degrees; -1 in `data` means "absorb remaining devices"."""

    data: int = -1
    fsdp: int = 1
    sequence: int = 1
    tensor: int = 1
    num_slices: int = 1  # >1: the data dim spans slices, slice-major
    pipeline: int = 1
    expert: int = 1

    def resolved(self, num_devices: int) -> "MeshConfig":
        fixed = (self.fsdp * self.sequence * self.tensor
                 * self.pipeline * self.expert)
        data = self.data
        if data == -1:
            if num_devices % fixed != 0:
                raise ValueError(
                    f"{num_devices} devices not divisible by "
                    f"fsdp*sequence*tensor*pipeline*expert={fixed}"
                )
            data = num_devices // fixed
        if data * fixed != num_devices:
            raise ValueError(
                f"mesh {data}x{self.fsdp}x{self.sequence}x{self.tensor}"
                f"x{self.pipeline}x{self.expert} != {num_devices} devices"
            )
        return MeshConfig(data, self.fsdp, self.sequence, self.tensor,
                          self.num_slices, self.pipeline, self.expert)

    @property
    def shape(self) -> tuple[int, int, int, int, int, int]:
        return (self.data, self.fsdp, self.sequence, self.tensor,
                self.pipeline, self.expert)


def check_slices(config: MeshConfig) -> MeshConfig:
    """A resolved config whose data dim splits evenly into its slices."""
    if config.num_slices > 1 and config.data % config.num_slices != 0:
        raise ValueError(
            f"data={config.data} not divisible by "
            f"num_slices={config.num_slices}")
    return config


def make_mesh(config: Optional[MeshConfig] = None, device: str = "cuda"):
    """The training DeviceMesh over every rank of the default process
    group (which must be initialized: runtime.init.distributed_init, or
    init_process_group), dims named MESH_AXES."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: "
                           "call runtime.init.distributed_init first")
    config = check_slices(
        (config or MeshConfig()).resolved(dist.get_world_size()))
    return init_device_mesh(device, config.shape, mesh_dim_names=MESH_AXES)


def mesh_for_slice(num_devices: int, num_slices: int = 1, tensor: int = 1,
                   sequence: int = 1, fsdp: Optional[int] = None,
                   device: str = "cuda"):
    """Convenience: fill fsdp with whatever data parallelism doesn't take.
    Default policy (fsdp=None): all non-tensor/sequence devices go to fsdp
    within a slice and data across slices."""
    per_slice = num_devices // num_slices
    if fsdp is None:
        fsdp = per_slice // (tensor * sequence)
    cfg = MeshConfig(data=-1, fsdp=fsdp, sequence=sequence, tensor=tensor,
                     num_slices=num_slices)
    return make_mesh(cfg, device)


def num_devices_of(mesh) -> int:
    return mesh.size()


def mesh_sizes(mesh) -> dict:
    """{axis: degree} of a DeviceMesh or a resolved MeshConfig."""
    if isinstance(mesh, MeshConfig):
        return dict(zip(MESH_AXES, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, name: str) -> int:
    """The degree of one axis; 1 without a mesh."""
    return 1 if mesh is None else mesh_sizes(mesh).get(name, 1)


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate along one axis; 0 without a mesh."""
    return 0 if axis_size(mesh, name) == 1 else mesh.get_local_rank(name)


def axis_group(mesh, name: str):
    """The process group of one axis, None where there is nothing to
    communicate (no mesh, or a degree of 1)."""
    return None if axis_size(mesh, name) == 1 else mesh.get_group(name)


__all__ = ["MESH_AXES", "MeshConfig", "axis_group", "axis_rank",
           "axis_size", "check_slices", "make_mesh", "mesh_for_slice",
           "mesh_sizes", "num_devices_of"]
