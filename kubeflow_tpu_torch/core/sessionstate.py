"""Session-state store: the port of kubeflow_tpu/core/sessionstate.py.

The pod's checkpoint sidecar (runtime/checkpoint.py) writes periodic,
pre-stop and cull snapshots of the session payload into a store keyed
by (namespace, notebook, slice); the controller's recovery engine
(core/selfheal.py) reads the same store to decide whether a disrupted
gang can be migrated, and asks the gang for a final snapshot through
`request_final_snapshot`, which the registered handler answers (the
in-pod sidecar in production, the fake cluster in tests) with the fresh
`SnapshotInfo`, or None when the gang is unreachable.  A GPU gang is
slice 0.  So `DirSessionStore`
writes the reference's on-disk layout byte for byte:
`<root>/<ns>/<notebook>/slice-<id>/gen-<G>.bin` (payload) and
`gen-<G>.json` (metadata, the commit marker), each written tmp file ->
fsync -> atomic rename -> fsync(dir), the marker last, so a sidecar
killed mid-save leaves an orphan that reads as "no snapshot" and is
GC'd on the next scan.

Copied: `SnapshotInfo`, `SessionStateStore.put` / `latest` / `info` /
`payload`, the final-snapshot handler, `InMemorySessionStore`,
`DirSessionStore` and `open_store`; `put` hashes the payload beside its
write, where the reference hashes it first.  The replicated tier (delta chains,
write fences, compaction, follower replicas) waits for `ROADMAP.md`
queue 1 item 14.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

from ..utils.clock import Clock

# snapshot triggers, a bounded set (they label
# notebook_checkpoint_snapshots_total{trigger})
TRIGGER_PERIODIC = "periodic"
TRIGGER_FINAL = "final"

DEFAULT_MAX_TO_KEEP = 5

FinalSnapshotHandler = Callable[[str, str, int], Optional["SnapshotInfo"]]


@dataclass(frozen=True)
class SnapshotInfo:
    """Metadata of one stored slice checkpoint.  `digest` fingerprints the
    payload."""

    namespace: str
    notebook: str
    slice_id: int
    generation: int
    saved_at: float
    digest: str
    trigger: str
    uri: str
    size: int


def payload_digest(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()[:16]


class SessionStateStore:
    """Backend-agnostic snapshot inventory keyed by
    (namespace, notebook, slice_id), generations monotonic per key."""

    def __init__(self, clock: Optional[Clock] = None,
                 max_to_keep: int = DEFAULT_MAX_TO_KEEP) -> None:
        self.clock = clock or Clock()
        self.max_to_keep = max_to_keep
        self._lock = threading.RLock()
        self._final_handler: Optional[FinalSnapshotHandler] = None

    @property
    def uri(self) -> str:
        raise NotImplementedError

    def snapshot_uri(self, namespace: str, notebook: str, slice_id: int,
                     generation: int) -> str:
        return (f"{self.uri}/{namespace}/{notebook}/slice-{slice_id}/"
                f"gen-{generation}")

    def put(self, namespace: str, notebook: str, slice_id: int,
            payload: bytes, trigger: str = TRIGGER_PERIODIC) -> SnapshotInfo:
        with self._lock:
            latest = self.latest(namespace, notebook, slice_id)
            generation = (latest.generation + 1) if latest else 1
            # the digest is computed beside the payload's write (hashlib
            # and file writes release the GIL), so a large snapshot pays
            # for one pass over its bytes, not two in a row
            with ThreadPoolExecutor(1) as pool:
                digest = pool.submit(payload_digest, payload)
                self._write_payload(namespace, notebook, slice_id,
                                    generation, payload)
                info = SnapshotInfo(
                    namespace=namespace,
                    notebook=notebook,
                    slice_id=slice_id,
                    generation=generation,
                    saved_at=self.clock.now(),
                    digest=digest.result(),
                    trigger=trigger,
                    uri=self.snapshot_uri(namespace, notebook, slice_id,
                                          generation),
                    size=len(payload),
                )
            self._store(info, payload)
            self._prune(namespace, notebook, slice_id)
            return info

    def snapshots(self, namespace: str, notebook: str,
                  slice_id: int) -> list[SnapshotInfo]:
        raise NotImplementedError

    def latest(self, namespace: str, notebook: str,
               slice_id: int) -> Optional[SnapshotInfo]:
        snaps = self.snapshots(namespace, notebook, slice_id)
        return snaps[-1] if snaps else None

    def info(self, namespace: str, notebook: str, slice_id: int,
             generation: int) -> Optional[SnapshotInfo]:
        return next((s for s in self.snapshots(namespace, notebook, slice_id)
                     if s.generation == generation), None)

    def payload(self, namespace: str, notebook: str, slice_id: int,
                generation: Optional[int] = None) -> Optional[bytes]:
        raise NotImplementedError

    # -- the control plane's "flush now" hook ----------------------------------
    def set_final_snapshot_handler(
            self, handler: Optional[FinalSnapshotHandler]) -> None:
        """Register the data-plane responder (the in-pod sidecar; in tests,
        FakeCluster).  One handler: the store is per fleet, and the
        handler fans out to the addressed gang itself."""
        self._final_handler = handler

    def request_final_snapshot(self, namespace: str, notebook: str,
                               slice_id: int) -> Optional[SnapshotInfo]:
        """Ask the gang to snapshot now (the pre-migration flush).  Returns
        the fresh SnapshotInfo, or None when no handler is wired or the
        gang is unreachable or failed to snapshot."""
        handler = self._final_handler
        if handler is None:
            return None
        try:
            return handler(namespace, notebook, slice_id)
        except Exception:  # noqa: BLE001 — an unreachable gang is a
            return None    # normal outcome, not an engine error

    def _write_payload(self, namespace: str, notebook: str, slice_id: int,
                       generation: int, payload: bytes) -> None:
        """Write the payload ahead of its commit, where the backend keeps
        it apart from the metadata; `_store` then commits."""

    def _store(self, info: SnapshotInfo, payload: bytes) -> None:
        raise NotImplementedError

    def _prune(self, namespace: str, notebook: str, slice_id: int) -> None:
        raise NotImplementedError


class InMemorySessionStore(SessionStateStore):
    """Dict-backed store for unit tests and single-process drills."""

    def __init__(self, clock: Optional[Clock] = None,
                 max_to_keep: int = DEFAULT_MAX_TO_KEEP) -> None:
        super().__init__(clock=clock, max_to_keep=max_to_keep)
        self._data: dict[tuple[str, str, int],
                         list[tuple[SnapshotInfo, bytes]]] = {}

    @property
    def uri(self) -> str:
        return "mem://session-state"

    def snapshots(self, namespace: str, notebook: str,
                  slice_id: int) -> list[SnapshotInfo]:
        with self._lock:
            return [info for info, _ in
                    self._data.get((namespace, notebook, slice_id), [])]

    def payload(self, namespace: str, notebook: str, slice_id: int,
                generation: Optional[int] = None) -> Optional[bytes]:
        with self._lock:
            entries = self._data.get((namespace, notebook, slice_id), [])
            if not entries:
                return None
            if generation is None:
                return entries[-1][1]
            return next((p for info, p in entries
                         if info.generation == generation), None)

    def _store(self, info: SnapshotInfo, payload: bytes) -> None:
        key = (info.namespace, info.notebook, info.slice_id)
        self._data.setdefault(key, []).append((info, bytes(payload)))

    def _prune(self, namespace: str, notebook: str, slice_id: int) -> None:
        key = (namespace, notebook, slice_id)
        entries = self._data.get(key, [])
        if len(entries) > self.max_to_keep:
            self._data[key] = entries[-self.max_to_keep:]


class DirSessionStore(SessionStateStore):
    """Directory-backed store with torn-write safety; the layout is in
    the module docstring."""

    def __init__(self, root: str, clock: Optional[Clock] = None,
                 max_to_keep: int = DEFAULT_MAX_TO_KEEP) -> None:
        super().__init__(clock=clock, max_to_keep=max_to_keep)
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    @property
    def uri(self) -> str:
        return f"file://{self.root}"

    def _slice_dir(self, namespace: str, notebook: str,
                   slice_id: int) -> Path:
        return self.root / namespace / notebook / f"slice-{slice_id}"

    def snapshots(self, namespace: str, notebook: str,
                  slice_id: int) -> list[SnapshotInfo]:
        d = self._slice_dir(namespace, notebook, slice_id)
        if not d.is_dir():
            return []
        with self._lock:
            out = []
            for meta_path in sorted(d.glob("gen-*.json")):
                info = self._load_meta(meta_path)
                if info is not None:
                    out.append(info)
            self._gc_orphans(d, {s.generation for s in out})
            return sorted(out, key=lambda s: s.generation)

    def _load_meta(self, meta_path: Path) -> Optional[SnapshotInfo]:
        try:
            meta = json.loads(meta_path.read_text())
            info = SnapshotInfo(**meta)
        except (OSError, ValueError, TypeError):
            # torn/corrupt commit marker: GC both halves
            meta_path.unlink(missing_ok=True)
            meta_path.with_suffix(".bin").unlink(missing_ok=True)
            return None
        if not meta_path.with_suffix(".bin").exists():
            meta_path.unlink(missing_ok=True)
            return None
        return info

    def _gc_orphans(self, d: Path, committed: set[int]) -> None:
        """Drop payloads that never got their commit marker (a save killed
        between the payload write and the metadata rename) and any stray
        tmp files from interrupted writers."""
        for tmp in d.glob(".tmp-*"):
            tmp.unlink(missing_ok=True)
        for bin_path in d.glob("gen-*.bin"):
            try:
                gen = int(bin_path.stem.split("-", 1)[1])
            except ValueError:
                bin_path.unlink(missing_ok=True)
                continue
            if gen not in committed:
                bin_path.unlink(missing_ok=True)

    def payload(self, namespace: str, notebook: str, slice_id: int,
                generation: Optional[int] = None) -> Optional[bytes]:
        with self._lock:
            if generation is None:
                latest = self.latest(namespace, notebook, slice_id)
                if latest is None:
                    return None
                generation = latest.generation
            p = self._slice_dir(namespace, notebook,
                                slice_id) / f"gen-{generation}.bin"
            try:
                return p.read_bytes()
            except OSError:
                return None

    def _write_payload(self, namespace: str, notebook: str, slice_id: int,
                       generation: int, payload: bytes) -> None:
        d = self._slice_dir(namespace, notebook, slice_id)
        d.mkdir(parents=True, exist_ok=True)
        _atomic_write(d / f"gen-{generation}.bin", payload)

    def _store(self, info: SnapshotInfo, payload: bytes) -> None:
        d = self._slice_dir(info.namespace, info.notebook, info.slice_id)
        meta = {
            "namespace": info.namespace,
            "notebook": info.notebook,
            "slice_id": info.slice_id,
            "generation": info.generation,
            "saved_at": info.saved_at,
            "digest": info.digest,
            "trigger": info.trigger,
            "uri": info.uri,
            "size": info.size,
        }
        # the commit marker lands LAST: its atomic rename is the point of
        # no return, and everything before it is invisible to readers
        _atomic_write(d / f"gen-{info.generation}.json",
                      json.dumps(meta).encode())

    def _prune(self, namespace: str, notebook: str, slice_id: int) -> None:
        snaps = self.snapshots(namespace, notebook, slice_id)
        for stale in snaps[:-self.max_to_keep] if self.max_to_keep else []:
            d = self._slice_dir(namespace, notebook, slice_id)
            (d / f"gen-{stale.generation}.json").unlink(missing_ok=True)
            (d / f"gen-{stale.generation}.bin").unlink(missing_ok=True)


def _atomic_write(final: Path, data: bytes) -> None:
    """tmp file in the target dir -> write -> fsync -> atomic rename ->
    fsync(dir): a crash at any point leaves either the old state or the
    new state, never a torn file under the final name."""
    tmp = final.parent / f".tmp-{final.name}-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    dirfd = os.open(final.parent, os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def open_store(uri: str, clock: Optional[Clock] = None,
               max_to_keep: int = DEFAULT_MAX_TO_KEEP) -> SessionStateStore:
    """URI -> store: `mem://...` (fresh in-memory instance), `file://<path>`
    or a bare filesystem path (dir-backed)."""
    if uri.startswith("mem://"):
        return InMemorySessionStore(clock=clock, max_to_keep=max_to_keep)
    if uri.startswith("file://"):
        uri = uri[len("file://"):]
    return DirSessionStore(uri, clock=clock, max_to_keep=max_to_keep)


__all__ = ["DirSessionStore", "FinalSnapshotHandler", "InMemorySessionStore",
           "SessionStateStore", "SnapshotInfo", "TRIGGER_FINAL",
           "TRIGGER_PERIODIC", "open_store", "payload_digest"]
