"""In-notebook distributed bootstrap: `distributed_init()`.

The port of kubeflow_tpu/runtime/init.py.  It reads the env the
controller injects into every worker (TPU_WORKER_ID from the pod-index
downward API, TPU_WORKER_HOSTNAMES ordered by ordinal, the coordinator
address pinned to slice-0 worker-0, MEGASCALE_* for multi-slice) and
starts `torch.distributed` with the rank, world size and rendezvous
address that identity gives: NCCL on "cuda", gloo on "cpu".  A single
host is a no-op beyond parsing, as in the reference.  `WorkerIdentity`
and `parse_worker_env` are the reference's, copied unchanged.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Optional


@dataclass(frozen=True)
class WorkerIdentity:
    """Parsed coordination env of this worker."""

    worker_id: int
    hosts_per_slice: int
    slice_id: int
    num_slices: int
    coordinator_address: str
    hostnames: tuple[str, ...]

    @property
    def process_id(self) -> int:
        # global process ids are slice-major, matching the hostname ordering
        # the controller generates (tpu/env.py worker_hostnames)
        return self.slice_id * self.hosts_per_slice + self.worker_id

    @property
    def num_processes(self) -> int:
        return self.hosts_per_slice * self.num_slices

    @property
    def is_multihost(self) -> bool:
        return self.num_processes > 1


def parse_worker_env(env: Optional[Mapping[str, str]] = None) -> WorkerIdentity:
    env = env if env is not None else os.environ
    hostnames = tuple(
        h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h
    )
    hosts_per_slice = int(
        env.get("TPU_HOSTS_PER_SLICE") or len(hostnames) or 1
    )
    worker_id = int(env.get("TPU_WORKER_ID", 0) or 0)
    return WorkerIdentity(
        worker_id=worker_id,
        hosts_per_slice=hosts_per_slice,
        slice_id=int(env.get("MEGASCALE_SLICE_ID", 0) or 0),
        num_slices=int(env.get("MEGASCALE_NUM_SLICES", 1) or 1),
        coordinator_address=env.get(
            "JAX_COORDINATOR_ADDRESS", env.get("COORDINATOR_ADDRESS", "")
        ),
        hostnames=hostnames,
    )


def distributed_init(env: Optional[Mapping[str, str]] = None,
                     device: str = "cuda") -> WorkerIdentity:
    """Start the default process group from the injected env.

    Single-host (or CPU-notebook) pods are a no-op beyond parsing;
    multi-host slices block in `init_process_group` until every worker
    has reached the coordinator's TCP store (the gang-startup rendezvous
    the headless Service's publishNotReadyAddresses makes resolvable).
    The backend is NCCL on "cuda" and gloo only on "cpu"."""
    identity = parse_worker_env(env)
    if identity.is_multihost and identity.coordinator_address:
        import torch.distributed as dist

        dist.init_process_group(
            "nccl" if device == "cuda" else "gloo",
            init_method=f"tcp://{identity.coordinator_address}",
            world_size=identity.num_processes,
            rank=identity.process_id,
        )
    return identity


def local_chip_count() -> int:
    import torch

    return torch.cuda.device_count()


__all__ = ["WorkerIdentity", "distributed_init", "local_chip_count",
           "parse_worker_env"]
