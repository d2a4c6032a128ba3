"""GPU gang math: accelerator type + GPU count -> gang shape.

The port of kubeflow_tpu/tpu/topology.py.  A `spec.gpu` block
`{accelerator, count}` determines how many hosts a gang spans, how many
GPUs each host exposes through the `nvidia.com/gpu` device plugin, and
which GKE node label (`cloud.google.com/gke-accelerator`) the pods must
target.  A GPU host has no ICI topology to name, so a count takes the
place of the TPU's topology string: up to one host's maximum the gang is
one host; above it, whole hosts of `gpus_per_host` each.

One table: `runtime/roofline.py:GPU_PEAKS` is derived from `ACCELERATORS`
(keyed by the name `torch.cuda.get_device_name()` reports), so a peak is
written once.  Every number below is a vendor data-sheet figure (dense
bf16 tensor-core rate without sparsity, HBM bandwidth, memory size) for
the GKE machine family's part; none is measured.
"""

from __future__ import annotations

from dataclasses import dataclass


class TopologyError(ValueError):
    pass


@dataclass(frozen=True)
class Accelerator:
    name: str                 # user-facing: "h100-80gb"
    gke_label: str            # cloud.google.com/gke-accelerator value
    device_name: str          # torch.cuda.get_device_name()
    gpus_per_host: int        # GPUs per host in multi-host gangs
    max_single_host_gpus: int
    memory_gb: int            # device memory per GPU, as the sheet names it
    bf16_peak_tflops: float   # per-GPU dense peak, for MFU math
    hbm_gbps: float           # per-GPU memory bandwidth, for decode math


ACCELERATORS: dict[str, Accelerator] = {
    # NVIDIA H100 Tensor Core GPU data sheet, H100 SXM column (GKE A3
    # machines: 8 per host)
    "h100-80gb": Accelerator("h100-80gb", "nvidia-h100-80gb",
                             "NVIDIA H100 80GB HBM3", 8, 8, 80, 989.0,
                             3350.0),
    # NVIDIA H200 Tensor Core GPU data sheet, H200 SXM column (GKE A3
    # Ultra: 8 per host)
    "h200-141gb": Accelerator("h200-141gb", "nvidia-h200-141gb",
                              "NVIDIA H200", 8, 8, 141, 989.0, 4800.0),
    # NVIDIA A100 Tensor Core GPU data sheet, A100 80GB SXM column (GKE
    # A2 Ultra: up to 8 per host)
    "a100-80gb": Accelerator("a100-80gb", "nvidia-a100-80gb",
                             "NVIDIA A100-SXM4-80GB", 8, 8, 80, 312.0,
                             2039.0),
}


@dataclass(frozen=True)
class GpuShape:
    """Resolved shape of one GPU gang."""

    accelerator: Accelerator
    gpus: int
    num_hosts: int
    gpus_per_host: int

    @property
    def bf16_peak_tflops(self) -> float:
        return self.gpus * self.accelerator.bf16_peak_tflops


def accelerator_from_device_name(device_name: str) -> str:
    """Map `torch.cuda.get_device_name()` ("NVIDIA H100 80GB HBM3", ...) to
    the user-facing accelerator key.  Unlike the reference's
    `accelerator_from_device_kind`, an unknown card raises instead of
    defaulting: the port never guesses a peak."""
    for key, acc in ACCELERATORS.items():
        if acc.device_name.lower() == device_name.strip().lower():
            return key
    raise TopologyError(
        f"unknown GPU {device_name!r}; known: "
        f"{sorted(a.device_name for a in ACCELERATORS.values())}")


def resolve(accelerator: str, count: int) -> GpuShape:
    """Resolve {accelerator, count} to GPUs/hosts/GPUs-per-host."""
    acc = ACCELERATORS.get(accelerator)
    if acc is None:
        raise TopologyError(
            f"unknown accelerator {accelerator!r}; supported: "
            f"{sorted(ACCELERATORS)}"
        )
    if count < 1:
        raise TopologyError(f"{accelerator}: count {count} must be >= 1")
    if count <= acc.max_single_host_gpus:
        num_hosts, per_host = 1, count
    else:
        if count % acc.gpus_per_host != 0:
            raise TopologyError(
                f"{accelerator} count {count}: more than one host's "
                f"{acc.max_single_host_gpus} GPUs must be a multiple of "
                f"{acc.gpus_per_host} GPUs/host"
            )
        num_hosts, per_host = count // acc.gpus_per_host, acc.gpus_per_host
    return GpuShape(accelerator=acc, gpus=count, num_hosts=num_hosts,
                    gpus_per_host=per_host)


__all__ = ["ACCELERATORS", "Accelerator", "GpuShape", "TopologyError",
           "accelerator_from_device_name", "resolve"]
