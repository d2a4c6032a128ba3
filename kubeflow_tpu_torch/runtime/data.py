"""Input pipeline: rank-sharded loading and device prefetch.

The port of kubeflow_tpu/runtime/data.py.  Three stages, composed by
`input_pipeline`:

- `TokenBatches` yields deterministic LM batches from a token array, as
  numpy: seeded per-epoch shuffling, each rank taking only its rows of
  the global batch, targets = inputs shifted.  A rank's index is its
  coordinate over the mesh's batch dims ("data" x "fsdp", data
  outermost) and the count their size; ranks that differ only in
  "sequence", "tensor", "pipeline" or "expert" load the same rows.
  Without a mesh it is the rank and the world size of the default
  process group (0 and 1 without one);
- `DevicePrefetcher` stages up to `depth` batches ahead from a
  background thread.  On "cuda" its transfer (`to_device`) copies
  pinned host tensors to the card with non_blocking=True on a side
  stream; the batch is handed over on the consumer's stream, which waits
  for the copy's event, and each tensor records that stream so the
  caching allocator keeps its block until the step has read it;
- `ShardedBatcher` assembles the GLOBAL [B, S] batch that the port's
  mesh step takes (it cuts its own block, models/train.py:shard_batch)
  from the ranks' rows, in rank order, by one all-gather over the batch
  dims' group (gloo on the CPU, NCCL on the card): the counterpart of
  `jax.make_array_from_process_local_data`.  It runs in the consumer's
  thread, after the prefetcher, because the step's own collectives run
  there: NCCL kernels of two threads can interleave in another order on
  each rank and deadlock.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..parallel.mesh import axis_rank, axis_size


def batch_rank(mesh=None) -> tuple[int, int]:
    """(this rank's index, count) over the batch dims: see module
    docstring."""
    import torch.distributed as dist

    if mesh is None:
        if not dist.is_initialized():
            return 0, 1
        return dist.get_rank(), dist.get_world_size()
    return (axis_rank(mesh, "data") * axis_size(mesh, "fsdp")
            + axis_rank(mesh, "fsdp"),
            axis_size(mesh, "data") * axis_size(mesh, "fsdp"))


class TokenBatches:
    """Deterministic rank-sharded LM batches from a flat token array.

    Each epoch draws `global_batch` non-overlapping sequence windows in a
    seeded shuffle; this rank materializes ONLY rows
    [process_index * per_rank, (process_index + 1) * per_rank).
    `process_index`/`process_count` default to `batch_rank(mesh)`."""

    def __init__(self, tokens: np.ndarray, global_batch: int, seq_len: int,
                 seed: int = 0, num_epochs: Optional[int] = None,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None, mesh=None) -> None:
        self.tokens = np.asarray(tokens)
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        self.num_epochs = num_epochs
        index, count = batch_rank(mesh)
        self.process_index = (process_index if process_index is not None
                              else index)
        self.process_count = (process_count if process_count is not None
                              else count)
        if global_batch % self.process_count != 0:
            raise ValueError(
                f"global_batch {global_batch} not divisible by "
                f"{self.process_count} processes")
        self.windows = (len(self.tokens) - 1) // seq_len
        if self.windows < global_batch:
            raise ValueError(
                f"dataset has {self.windows} windows of {seq_len}; "
                f"need >= {global_batch}")

    def __iter__(self) -> Iterator[dict]:
        per_host = self.global_batch // self.process_count
        lo = self.process_index * per_host
        epoch = 0
        while self.num_epochs is None or epoch < self.num_epochs:
            order = np.random.default_rng(
                (self.seed, epoch)).permutation(self.windows)
            for start in range(0, self.windows - self.global_batch + 1,
                               self.global_batch):
                mine = order[start + lo:start + lo + per_host]
                rows = np.stack([
                    self.tokens[w * self.seq_len:
                                w * self.seq_len + self.seq_len + 1]
                    for w in mine
                ])
                yield {"inputs": rows[:, :-1].astype(np.int32),
                       "targets": rows[:, 1:].astype(np.int32)}
            epoch += 1


class _Staged:
    """A batch whose copy to the card was enqueued on a side stream."""

    def __init__(self, batch: dict, event, host: dict) -> None:
        self.batch, self.event = batch, event
        self.host = host  # the pinned sources, held until the hand-over

    def consume(self) -> dict:
        stream = torch.cuda.current_stream(
            next(iter(self.batch.values())).device)
        stream.wait_event(self.event)
        for t in self.batch.values():
            t.record_stream(stream)
        self.host = None
        return self.batch


def to_device(device) -> Callable[[dict], object]:
    """The prefetcher's transfer: numpy {"inputs", "targets"} -> tensors
    on `device`.  On "cuda": pinned host copies, then non_blocking
    copies on a side stream (pageable memory would make them
    synchronous), handed over by `_Staged.consume`; on "cpu" the tensors
    share the numpy buffers."""
    device = torch.device(device)
    if device.type != "cuda":
        return lambda batch: {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in batch.items()}
    side = torch.cuda.Stream(device)

    def transfer(batch: dict) -> _Staged:
        host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for k, v in batch.items()}
        with torch.cuda.stream(side):
            moved = {k: v.to(device, non_blocking=True)
                     for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(side)
        return _Staged(moved, event, host)

    return transfer


class DevicePrefetcher:
    """Stage up to `depth` batches ahead from a background thread.

    `transfer` runs in the thread (see `to_device`).  Iteration ends when
    the source ends; a loader error is raised to the consumer; `close()`
    tears the thread down early (e.g. on notebook interrupt)."""

    _DONE = object()

    def __init__(self, source, depth: int = 2,
                 transfer: Optional[Callable] = None) -> None:
        self.source = source
        self.transfer = transfer
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="data-prefetch")
        self._thread.start()

    def _loop(self) -> None:
        try:
            for batch in self.source:
                if self.transfer is not None:
                    batch = self.transfer(batch)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except Exception as err:  # surface loader errors to the consumer
            self._q.put(err)
            return
        self._q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration from None
        if item is self._DONE:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        if isinstance(item, _Staged):
            return item.consume()
        return item

    def close(self) -> None:
        self._stop.set()
        # drain so a blocked producer can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)


def batch_group(mesh=None):
    """The process group over the batch dims holding this rank, its ranks
    in batch-rank order (see `batch_rank`); None where it has one rank.
    Collective: every rank of the default group must call it."""
    import torch.distributed as dist

    if not dist.is_initialized() or batch_rank(mesh)[1] == 1:
        return None
    if mesh is None:
        return dist.new_group()
    ranks = mesh.mesh  # [data, fsdp, sequence, tensor, pipeline, expert]
    rows = ranks.permute(*range(2, ranks.dim()), 0, 1).reshape(
        -1, ranks.shape[0] * ranks.shape[1])
    group, _ = dist.new_subgroups_by_enumeration(rows.tolist())
    return group


class ShardedBatcher:
    """Each rank's rows -> the global batch on every rank of the batch
    group, rows in batch-rank order (see module docstring)."""

    def __init__(self, source, mesh=None) -> None:
        self.source = source
        self.group = batch_group(mesh)

    def __iter__(self) -> Iterator[dict]:
        import torch.distributed as dist

        for batch in self.source:
            if self.group is None:
                yield batch
                continue
            keys = list(batch)
            mine = torch.stack([batch[k] for k in keys])  # [keys, rows, S]
            parts = [torch.empty_like(mine) for _ in
                     range(dist.get_world_size(self.group))]
            dist.all_gather(parts, mine, group=self.group)
            whole = torch.cat(parts, dim=1)
            yield {k: whole[i] for i, k in enumerate(keys)}

    def close(self) -> None:
        """Stop the prefetcher behind this batcher (see
        `DevicePrefetcher.close`)."""
        close = getattr(self.source, "close", None)
        if close is not None:
            close()


def input_pipeline(tokens: np.ndarray, global_batch: int, seq_len: int,
                   mesh=None, seed: int = 0,
                   num_epochs: Optional[int] = None, prefetch: int = 2,
                   device="cuda") -> ShardedBatcher:
    """tokens -> prefetched global {"inputs", "targets"} [B, S] int32
    batches on `device`, every rank of a batch group holding the same."""
    host = TokenBatches(tokens, global_batch, seq_len, seed=seed,
                        num_epochs=num_epochs, mesh=mesh)
    staged = DevicePrefetcher(host, depth=prefetch,
                              transfer=to_device(device))
    return ShardedBatcher(staged, mesh)


__all__ = ["DevicePrefetcher", "ShardedBatcher",
           "TokenBatches", "batch_group", "batch_rank", "input_pipeline",
           "to_device"]
