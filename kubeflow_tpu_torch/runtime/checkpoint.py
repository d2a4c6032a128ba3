"""Checkpoint/restore hooks with cull-signal and session-store integration.

The port of kubeflow_tpu/runtime/checkpoint.py, over torch state dicts
(models/train.py:train_state_dict).  It keeps the reference's file names
and its signal contract with the culling controller:

  controller writes  <signal dir>/checkpoint-requested  (the downward-API
  file, /etc/podinfo in a pod)  ->  the per-step hook saves and writes
  checkpoint-complete  ->  the controller proceeds to cull

The controller holds the cull until the acknowledgement or until one
idleness period runs out, so a loop without the hook loses its state.

The pod's pre-stop hook uses the same contract: `python -m
kubeflow_tpu_torch.runtime.checkpoint --pre-stop` (`main`, rendered by
core/workload.py) writes the request into the writable signal directory
CHECKPOINT_SIGNAL_DIR (an emptyDir: /etc/podinfo is read-only), waits
for the loop's checkpoint-complete there and exits 0, or exits 1 after
its timeout: the renderer passes `--timeout`, a margin below the pod's
termination grace period, which bounds the last save; without it the
hook waits PRE_STOP_TIMEOUT_S, below the default 30 s period.  The
watcher polls both directories and acknowledges where a request is
pending, and nowhere when none is (the hook gave up).
The reference renders the same hook for its own module, which has no
`__main__`: there `python -m` runs the module's top level, saves nothing
and exits 0.  This module imports torch only inside the functions that
need it, so the hook starts without it.

- `CheckpointManager`, keyed by step, has two backends:
  - "local", one process: `torch.save` of the state moved to the CPU,
    written temp file -> fsync -> atomic rename -> fsync(dir), old steps
    GC'd; `restore` walks the steps newest first, skipping and deleting
    any that is torn or corrupt (a truncated `torch.save` file raises
    RuntimeError from the zip reader), and returns tensors on the
    devices and dtypes of `state_like`;
  - "dcp", the counterpart of the reference's orbax backend:
    `torch.distributed.checkpoint` of a mesh setup's sharded state (its
    DTensors), collective on every rank, each writing its own shards,
    into a temporary directory renamed to the step's once complete.
  "auto" is "dcp" when a process group of world size > 1 is up, else
  "local".
- `CullSignalWatcher` / `checkpoint_on_cull`: the per-step hook.
- `CheckpointSidecar`, `restore_instructions`: the pod side of the
  session-state contract (core/sessionstate.py): periodic snapshots
  every CHECKPOINT_INTERVAL_S into CHECKPOINT_STORE_URI, a forced
  snapshot and acknowledgement when the cull signal fires, and the
  restore of the generation the migrate verb stamps into
  CHECKPOINT_RESTORE_URI/_GENERATION.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import TYPE_CHECKING, Any, Callable, Mapping, Optional

if TYPE_CHECKING:
    import torch

DEFAULT_SIGNAL_DIR = "/etc/podinfo"
# the pre-stop hook's wait for the ack when no --timeout is given: below
# the pod's default 30 s termination grace period, which also bounds the
# save
PRE_STOP_TIMEOUT_S = 25.0
_PRE_STOP_POLL_S = 0.05
REQUEST_FILE = "checkpoint-requested"
ACK_FILE = "checkpoint-complete"

# the sidecar contract env (mirrors the controller's ENV_CHECKPOINT_*)
ENV_STORE_URI = "CHECKPOINT_STORE_URI"
ENV_INTERVAL_S = "CHECKPOINT_INTERVAL_S"
ENV_RESTORE_URI = "CHECKPOINT_RESTORE_URI"
ENV_RESTORE_GENERATION = "CHECKPOINT_RESTORE_GENERATION"
ENV_SIGNAL_DIR = "CHECKPOINT_SIGNAL_DIR"

_STEP_PREFIX = "step_"
_STEP_SUFFIX = ".ckpt"
_DCP_SUFFIX = ".dcp"
_TMP_PREFIX = ".tmp-"
BACKENDS = ("auto", "local", "dcp")


def _map(fn, tree: Any) -> Any:
    """`fn` on every tensor of a nest of dicts, lists and tuples."""
    import torch

    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().to("cpu", copy=True)


def _to_host(tree: Any) -> Any:
    """Every tensor -> a CPU copy (a DTensor whole) before `torch.save`:
    a local checkpoint must not capture device buffers."""
    return _map(_host_copy, tree)


def _like(state_like: Any, stored: Any) -> Any:
    """Re-materialize restored leaves on the devices, dtypes and
    placements of `state_like` (the orbax StandardRestore analog); a
    structure that differs raises."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    if state_like is None:
        return stored
    if isinstance(state_like, DTensor):
        full = stored.to(state_like.device, state_like.dtype)
        return distribute_tensor(full, state_like.device_mesh,
                                 state_like.placements, src_data_rank=None)
    if isinstance(state_like, torch.Tensor):
        if tuple(stored.shape) != tuple(state_like.shape):
            raise ValueError(f"stored shape {tuple(stored.shape)} is not "
                             f"{tuple(state_like.shape)}")
        return stored.to(state_like.device, state_like.dtype)
    if isinstance(state_like, Mapping):
        if set(state_like) != set(stored):
            raise KeyError(f"stored keys differ: "
                           f"{sorted(set(state_like) ^ set(stored))}")
        return {k: _like(v, stored[k]) for k, v in state_like.items()}
    if isinstance(state_like, (list, tuple)):
        return type(state_like)(_like(a, b) for a, b in
                                zip(state_like, stored, strict=True))
    return stored


def _fsync_dir(path: Path) -> None:
    dirfd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


class CheckpointManager:
    """Save/restore of a state dict keyed by step; see module docstring.

    backend="dcp" is collective: every rank calls the constructor, `save`
    and `restore` together."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 backend: str = "auto"):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        self.directory = Path(directory)
        self.max_to_keep = max_to_keep
        if backend == "auto":
            backend = "dcp" if _world()[1] > 1 else "local"
        self.backend = backend
        self.suffix = _DCP_SUFFIX if backend == "dcp" else _STEP_SUFFIX
        self.rank = _world()[0]
        if backend == "local" or self.rank == 0:
            self.directory.mkdir(parents=True, exist_ok=True)
            self._gc_partials()
        self._barrier()

    def _barrier(self) -> None:
        if self.backend == "dcp" and _world()[1] > 1:
            import torch.distributed as dist

            dist.barrier()

    # -- shared bookkeeping ----------------------------------------------------
    def _step_path(self, step: int) -> Path:
        return self.directory / f"{_STEP_PREFIX}{step}{self.suffix}"

    def _steps(self) -> list[int]:
        steps = []
        for p in self.directory.glob(f"{_STEP_PREFIX}*{self.suffix}"):
            raw = p.name[len(_STEP_PREFIX):-len(self.suffix)]
            if raw.isdigit():
                steps.append(int(raw))
        return sorted(steps)

    def _remove(self, path: Path) -> None:
        try:
            if path.is_dir():
                shutil.rmtree(path)
            else:
                path.unlink()
        except OSError:
            pass

    def _gc_partials(self) -> None:
        """Temp files under the checkpoint dir are saves that never reached
        their atomic rename (killed mid-save): dead weight, never visible
        as checkpoints — reclaim them."""
        for tmp in self.directory.glob(f"{_TMP_PREFIX}*"):
            self._remove(tmp)

    def _commit(self, tmp: Path, step: int) -> None:
        # the atomic commit point: a crash before this line leaves only
        # the tmp file (GC'd later), a crash after it a complete step
        os.replace(tmp, self._step_path(step))
        _fsync_dir(self.directory)
        for stale in self._steps()[:-self.max_to_keep]:
            self._remove(self._step_path(stale))

    # -- local backend ---------------------------------------------------------
    def _local_save(self, step: int, state: Any) -> None:
        import torch

        final = self._step_path(step)
        tmp = self.directory / f"{_TMP_PREFIX}{final.name}-{os.getpid()}"
        with open(tmp, "wb") as f:
            torch.save(_to_host(state), f)
            f.flush()
            os.fsync(f.fileno())
        self._commit(tmp, step)

    def _local_restore(self, state_like: Any, step: Optional[int]) -> Any:
        import torch

        self._gc_partials()
        candidates = [step] if step is not None else \
            list(reversed(self._steps()))
        for s in candidates:
            path = self._step_path(s)
            try:
                stored = torch.load(path, map_location="cpu",
                                    weights_only=True)
            except (OSError, EOFError, RuntimeError, pickle.UnpicklingError,
                    ValueError):
                # torn or corrupt step (a truncated zip raises
                # RuntimeError): GC it and fall back to the next-older
                # checkpoint instead of failing the boot
                self._remove(path)
                continue
            return _like(state_like, stored)
        return None

    # -- dcp backend -----------------------------------------------------------
    def _dcp_save(self, step: int, state: Any) -> None:
        import torch.distributed.checkpoint as dcp

        tmp = self.directory / f"{_TMP_PREFIX}{self._step_path(step).name}"
        # dcp.save returns on every rank once the coordinator has written
        # the metadata, the last file of a complete checkpoint
        dcp.save(state, checkpoint_id=str(tmp))
        if self.rank == 0:
            self._commit(tmp, step)
        self._barrier()

    def _dcp_restore(self, state_like: Any, step: Optional[int]) -> Any:
        import torch.distributed.checkpoint as dcp

        if state_like is None:
            raise ValueError("the dcp backend restores into state_like")
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        dcp.load(state_like, checkpoint_id=str(self._step_path(step)))
        return state_like

    # -- shared surface --------------------------------------------------------
    def save(self, step: int, state: Any, wait: bool = False) -> None:
        """Save `state` as `step`; both backends return once it is on
        disk (`wait` is the reference's argument and changes nothing)."""
        if self.backend == "dcp":
            self._dcp_save(step, state)
        else:
            self._local_save(step, state)

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """The newest step (or `step`) laid out like `state_like`; None
        when there is none.  "dcp" loads into `state_like` in place."""
        if self.backend == "dcp":
            return self._dcp_restore(state_like, step)
        return self._local_restore(state_like, step)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        pass


class CullSignalWatcher:
    """Watches for a checkpoint request: the controller's
    checkpoint-before-cull (`signal_dir`) or the pre-stop hook's
    (`hook_dir`, CHECKPOINT_SIGNAL_DIR by default; none when unset).

    `check()` is cheap enough for a per-step call; `acknowledge()` writes
    the completion marker the culling controller's checkpoint gate, or the
    hook, polls for, into each directory whose request is still pending:
    none when the request went meanwhile (a hook that gave up removes
    its own, and /etc/podinfo is read-only in a pod)."""

    def __init__(self, signal_dir: str = DEFAULT_SIGNAL_DIR,
                 time_fn: Callable[[], float] = time.time,
                 hook_dir: Optional[str] = None):
        self.signal_dir = Path(signal_dir)
        self.time_fn = time_fn
        hook_dir = hook_dir if hook_dir is not None \
            else os.environ.get(ENV_SIGNAL_DIR, "")
        self.dirs = [self.signal_dir] + ([Path(hook_dir)] if hook_dir
                                         else [])

    @staticmethod
    def _requested(directory: Path) -> bool:
        req = directory / REQUEST_FILE
        try:
            return req.exists() and req.read_text().strip() not in ("", "false")
        except OSError:
            return False

    def check(self) -> bool:
        return any(self._requested(d) for d in self.dirs)

    def acknowledge(self) -> None:
        for directory in self.dirs:
            if self._requested(directory):
                (directory / ACK_FILE).write_text(str(self.time_fn()))


def checkpoint_on_cull(
    manager: CheckpointManager,
    watcher: Optional[CullSignalWatcher] = None,
) -> Callable[[int, Any], bool]:
    """Returns a per-step hook: `hook(step, state)` saves synchronously and
    acknowledges when a cull is pending; returns True when it fired so the
    training loop can drain/exit cleanly."""
    watcher = watcher or CullSignalWatcher()
    fired = threading.Event()

    def hook(step: int, state: Any) -> bool:
        if fired.is_set() or not watcher.check():
            return False
        manager.save(step, state, wait=True)
        watcher.acknowledge()
        fired.set()
        return True

    return hook


# -- session-state sidecar (the pod side of the migrate contract) --------------
@dataclass(frozen=True)
class RestoreInstruction:
    """What a recreated pod of a migrated slice must restore: stamped into
    the pod env by the recovery engine (CHECKPOINT_RESTORE_*)."""

    uri: str
    generation: int


def restore_instructions(
        env: Optional[Mapping[str, str]] = None) -> Optional[RestoreInstruction]:
    env = env if env is not None else os.environ
    uri = env.get(ENV_RESTORE_URI, "").strip()
    raw = env.get(ENV_RESTORE_GENERATION, "").strip()
    if not uri or not raw:
        return None
    try:
        return RestoreInstruction(uri=uri, generation=int(raw))
    except ValueError:
        return None


class CheckpointSidecar:
    """Periodic + pre-stop/cull session snapshots into the session-state
    store (core/sessionstate.py), addressed by notebook identity.

    Drive `maybe_snapshot(payload_fn)` from the training/serving loop: it
    snapshots when the periodic interval elapsed, and immediately (plus
    acknowledges) when the cull signal file appears.  `payload_fn`
    returns the serialized session bytes only when actually needed."""

    def __init__(self, store, namespace: str, notebook: str, slice_id: int,
                 interval_s: float = 300.0,
                 watcher: Optional[CullSignalWatcher] = None,
                 time_fn: Callable[[], float] = time.time):
        self.store = store
        self.namespace = namespace
        self.notebook = notebook
        self.slice_id = slice_id
        self.interval_s = interval_s
        self.watcher = watcher
        self.time_fn = time_fn
        self._last_snapshot: Optional[float] = None
        self._cull_acked = False

    @classmethod
    def from_env(cls, namespace: str, notebook: str, slice_id: int,
                 env: Optional[Mapping[str, str]] = None,
                 watcher: Optional[CullSignalWatcher] = None,
                 time_fn: Callable[[], float] = time.time
                 ) -> Optional["CheckpointSidecar"]:
        """Build from the rendered sidecar contract; None when the
        controller did not configure a store (contract absent)."""
        env = env if env is not None else os.environ
        uri = env.get(ENV_STORE_URI, "").strip()
        if not uri:
            return None
        try:
            interval = float(env.get(ENV_INTERVAL_S, "") or 300.0)
        except ValueError:
            interval = 300.0
        from ..core.sessionstate import open_store

        return cls(open_store(uri), namespace, notebook, slice_id,
                   interval_s=interval, watcher=watcher, time_fn=time_fn)

    def maybe_snapshot(self, payload_fn: Callable[[], bytes]):
        """Returns the SnapshotInfo written this call, or None."""
        now = self.time_fn()
        if self.watcher is not None and not self._cull_acked \
                and self.watcher.check():
            info = self.store.put(self.namespace, self.notebook,
                                  self.slice_id, payload_fn(),
                                  trigger="cull")
            self.watcher.acknowledge()
            self._cull_acked = True
            self._last_snapshot = now
            return info
        if self._last_snapshot is not None and \
                now - self._last_snapshot < self.interval_s:
            return None
        info = self.store.put(self.namespace, self.notebook, self.slice_id,
                              payload_fn(), trigger="periodic")
        self._last_snapshot = now
        return info

    def snapshot_now(self, payload: bytes, trigger: str = "pre-stop"):
        """The pre-stop hook path: one last flush before the pod dies."""
        self._last_snapshot = self.time_fn()
        return self.store.put(self.namespace, self.notebook, self.slice_id,
                              payload, trigger=trigger)

    def restore_payload(
            self, env: Optional[Mapping[str, str]] = None) -> Optional[bytes]:
        """The boot path of a migrated pod: fetch the stamped generation's
        payload (None -> cold start)."""
        instr = restore_instructions(env)
        if instr is None:
            return None
        return self.store.payload(self.namespace, self.notebook,
                                  self.slice_id, instr.generation)


# -- the pre-stop hook ----------------------------------------------------------
def pre_stop(signal_dir: str,
             timeout_s: float = PRE_STOP_TIMEOUT_S) -> Optional[float]:
    """Request a checkpoint in `signal_dir` and wait for the training
    loop's acknowledgement: the seconds from the request to the ack, or
    None after `timeout_s`.  A stale ack is removed first, so only an
    answer to this request counts; the request is removed on return."""
    directory = Path(signal_dir)
    directory.mkdir(parents=True, exist_ok=True)
    request, ack = directory / REQUEST_FILE, directory / ACK_FILE
    ack.unlink(missing_ok=True)
    t0 = time.monotonic()
    request.write_text(f"pre-stop {time.time()}")
    try:
        while not ack.exists():
            if time.monotonic() - t0 >= timeout_s:
                return None
            time.sleep(_PRE_STOP_POLL_S)
        return time.monotonic() - t0
    finally:
        request.unlink(missing_ok=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="the pod's pre-stop hook: request one last checkpoint "
                    "from the training loop and wait for its ack")
    parser.add_argument("--pre-stop", action="store_true", required=True,
                        help="request a checkpoint and wait for the ack")
    parser.add_argument("--signal-dir",
                        default=os.environ.get(ENV_SIGNAL_DIR, ""),
                        help=f"writable signal directory (default: "
                             f"${ENV_SIGNAL_DIR})")
    parser.add_argument("--timeout", type=float, default=PRE_STOP_TIMEOUT_S,
                        help="seconds to wait for the ack (rendered below "
                             "the pod's termination grace period)")
    args = parser.parse_args(argv)
    if not args.signal_dir:
        print(f"pre-stop: no signal directory: set {ENV_SIGNAL_DIR} or "
              f"pass --signal-dir", file=sys.stderr)
        return 2
    waited = pre_stop(args.signal_dir, args.timeout)
    if waited is None:
        print(f"pre-stop: no checkpoint ack in {args.signal_dir} within "
              f"{args.timeout:g} s", file=sys.stderr)
        return 1
    print(json.dumps({"pre_stop": "acknowledged", "wait_s": waited}),
          flush=True)
    return 0


__all__ = ["ACK_FILE", "BACKENDS", "CheckpointManager", "CheckpointSidecar",
           "CullSignalWatcher", "DEFAULT_SIGNAL_DIR", "PRE_STOP_TIMEOUT_S",
           "REQUEST_FILE", "RestoreInstruction", "checkpoint_on_cull",
           "main", "pre_stop", "restore_instructions"]


if __name__ == "__main__":
    sys.exit(main())
