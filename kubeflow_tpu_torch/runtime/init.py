"""In-notebook distributed bootstrap: `distributed_init()`.

The port of kubeflow_tpu/runtime/init.py.  It reads the env the
controller injects into every worker and starts `torch.distributed` with
one rank per GPU: NCCL on "cuda", gloo on "cpu".  Two forms of that env
parse into one `WorkerIdentity`:

- the TPU form (tpu/env.py in the reference: TPU_WORKER_ID from the
  pod-index downward API, TPU_WORKER_HOSTNAMES ordered by ordinal, the
  coordinator address pinned to slice-0 worker-0, MEGASCALE_* for
  multi-slice), parsed exactly as the reference parses it: one process a
  host;
- the GPU form (gpu/env.py: PET_NNODES, PET_NPROC_PER_NODE, PET_NODE_RANK,
  PET_MASTER_ADDR/PORT, GPU_WORKER_HOSTNAMES), which `torchrun` reads for
  its flags, and the per-process names torchrun sets for each worker
  (RANK, LOCAL_RANK, WORLD_SIZE, LOCAL_WORLD_SIZE, GROUP_RANK,
  MASTER_ADDR, MASTER_PORT).

A process id is node rank x processes per host + local rank, so a 2-host
x 4-GPU gang is a world of 8, as the reference's `jax.devices()` shows
the whole slice.  A pod with several GPUs needs one process per GPU:
without LOCAL_RANK it is refused, never run on one GPU.  A single host
without torchrun is a no-op beyond parsing, as in the reference.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Optional

from ..core.constants import TORCH_RENDEZVOUS_PORT


@dataclass(frozen=True)
class WorkerIdentity:
    """Parsed coordination env of this worker."""

    worker_id: int
    hosts_per_slice: int
    slice_id: int
    num_slices: int
    coordinator_address: str
    hostnames: tuple[str, ...]
    local_rank: int = 0
    procs_per_host: int = 1
    torchrun: bool = False   # started by torchrun (its WORLD_SIZE is set)

    @property
    def node_rank(self) -> int:
        # global host ids are slice-major, matching the hostname ordering
        # the controller generates (tpu/env.py worker_hostnames)
        return self.slice_id * self.hosts_per_slice + self.worker_id

    @property
    def process_id(self) -> int:
        return self.node_rank * self.procs_per_host + self.local_rank

    @property
    def num_processes(self) -> int:
        return self.hosts_per_slice * self.num_slices * self.procs_per_host

    @property
    def is_multihost(self) -> bool:
        return self.num_processes > 1


def _int(env: Mapping[str, str], *names: str, default: int = 0) -> int:
    """The first of `names` set to a non-empty value, as an int."""
    for name in names:
        if env.get(name):
            return int(env[name])
    return default


def _parse_gpu_env(env: Mapping[str, str]) -> WorkerIdentity:
    hostnames = tuple(
        h for h in env.get("GPU_WORKER_HOSTNAMES", "").split(",") if h
    )
    procs = _int(env, "LOCAL_WORLD_SIZE", "PET_NPROC_PER_NODE", default=1)
    if "WORLD_SIZE" in env and not env.get("PET_NNODES"):
        hosts = max(1, int(env["WORLD_SIZE"]) // procs)
    else:
        hosts = _int(env, "PET_NNODES", default=len(hostnames) or 1)
    if "LOCAL_RANK" not in env and procs > 1:
        raise ValueError(
            f"this pod has {procs} GPUs (PET_NPROC_PER_NODE) but the process "
            "has no LOCAL_RANK: start it with torchrun (`torchrun script.py` "
            "reads the pod's PET_* env), which runs one process per GPU")
    if env.get("MASTER_ADDR"):
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '')}"
    elif env.get("PET_MASTER_ADDR"):
        port = env.get("PET_MASTER_PORT") or TORCH_RENDEZVOUS_PORT
        coordinator = f"{env['PET_MASTER_ADDR']}:{port}"
    else:
        coordinator = ""
    identity = WorkerIdentity(
        worker_id=_int(env, "GROUP_RANK", "PET_NODE_RANK"),
        hosts_per_slice=hosts,
        slice_id=0,
        num_slices=1,
        coordinator_address=coordinator,
        hostnames=hostnames,
        local_rank=_int(env, "LOCAL_RANK"),
        procs_per_host=procs,
        torchrun="WORLD_SIZE" in env,
    )
    for name, value in (("RANK", identity.process_id),
                        ("WORLD_SIZE", identity.num_processes)):
        if env.get(name) and int(env[name]) != value:
            raise ValueError(f"{name}={env[name]} disagrees with the gang's "
                             f"env, which gives {value}")
    return identity


def parse_worker_env(env: Optional[Mapping[str, str]] = None) -> WorkerIdentity:
    env = env if env is not None else os.environ
    if "PET_NNODES" in env or "WORLD_SIZE" in env:
        return _parse_gpu_env(env)
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

    The rendezvous address is the one `env` gives (under torchrun its
    MASTER_ADDR/PORT, where torchrun's agent serves its store).  Under
    torchrun the group starts even at world size 1, so one card runs the
    code a multi-GPU gang runs; whether a rank joins the agent's store
    or rank 0 serves one is torch's own read of the
    TORCHELASTIC_USE_AGENT_STORE that torchrun sets in each worker's
    environment.  Without torchrun, a single process on a single host is
    a no-op beyond parsing; multi-host gangs block in `init_process_group`
    until every worker has reached the coordinator's TCP store (the
    gang-startup rendezvous the headless Service's
    publishNotReadyAddresses makes resolvable).  On "cuda" the process
    takes GPU `local_rank` before NCCL starts; the backend is gloo only
    on "cpu"."""
    identity = parse_worker_env(env)
    if identity.torchrun and not identity.coordinator_address:
        raise ValueError("torchrun's WORLD_SIZE is set but no MASTER_ADDR "
                         "or PET_MASTER_ADDR names the rendezvous")
    if identity.torchrun or (identity.is_multihost
                             and identity.coordinator_address):
        import torch.distributed as dist

        if device == "cuda":
            import torch

            torch.cuda.set_device(identity.local_rank)
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
