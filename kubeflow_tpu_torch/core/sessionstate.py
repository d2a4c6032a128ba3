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

The replicated tier (`spec.replication`): on top of the base snapshots
the store keeps per-slice delta chains, an ordered, append-only stream
of opaque byte deltas anchored to a base generation; the state is the
base payload followed by each delta in order.  Every delta records the
digest of that materialized state, so `compact` folds a chain into a
fresh base only after the replayed bytes hash to the chain head, and a
`FollowerReplica` replays the stream verifying each digest.  Writes
carry an optional writer epoch checked against a per-notebook fence
(`fence`): once the promote verb raises it, a demoted primary's write
raises `StaleWriterError` instead of landing.  Delta files sit beside
the snapshots as `delta-<base>-<seq>.bin/.json`, under the same commit
discipline.

Copied from the reference: `SnapshotInfo`, `DeltaInfo`, the two errors,
`SessionStateStore` with `put`, `latest`, `info`, `payload`, the fence,
`append_delta`, `compact`, `deltas`, `delta_payload`, `materialize` and
`chain_head`, the final-snapshot handler, `InMemorySessionStore`,
`DirSessionStore`, `FollowerReplica` and `open_store`, with the same
bytes, digests and layout.  Where the reference hashes a payload before
writing it, `put` hashes it beside its write; and the store keeps the
running hash of the chain it last wrote, so an append hashes its delta
instead of re-reading and re-hashing the whole state, as the reference
does (the digests are the same).  `FollowerReplica` keeps its own
running hash the same way.
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
TRIGGER_PRE_STOP = "pre-stop"
TRIGGER_FINAL = "final"
TRIGGER_CULL = "cull"
TRIGGER_COMPACT = "compact"

DEFAULT_MAX_TO_KEEP = 5

FinalSnapshotHandler = Callable[[str, str, int], Optional["SnapshotInfo"]]


class DeltaChainError(Exception):
    """A delta append or replay broke the chain's contract: no base, an
    out-of-order sequence, or a replayed digest that does not match the
    recorded chain head (the write or compaction is refused, never
    applied half-way)."""


class StaleWriterError(Exception):
    """A write carried an epoch below the notebook's fence: the writer was
    demoted and must not ack state (core/selfheal.py's promote verb)."""


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


@dataclass(frozen=True)
class DeltaInfo:
    """Metadata of one incremental state delta.  `digest` fingerprints the
    materialized state after it (the base payload and every delta through
    `seq`), the anchor that compaction and follower catch-up verify;
    `delta_digest` fingerprints the delta's own bytes."""

    namespace: str
    notebook: str
    slice_id: int
    base_generation: int
    seq: int
    saved_at: float
    digest: str
    delta_digest: str
    uri: str
    size: int


def payload_digest(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()[:16]


def _hex16(hasher) -> str:
    """A running sha256's digest as `payload_digest` gives it."""
    return hasher.hexdigest()[:16]


class SessionStateStore:
    """Backend-agnostic snapshot inventory keyed by
    (namespace, notebook, slice_id), generations monotonic per key."""

    def __init__(self, clock: Optional[Clock] = None,
                 max_to_keep: int = DEFAULT_MAX_TO_KEEP) -> None:
        self.clock = clock or Clock()
        self.max_to_keep = max_to_keep
        self._lock = threading.RLock()
        self._final_handler: Optional[FinalSnapshotHandler] = None
        # the per-notebook write fence of the replicated tier: a write
        # carrying an epoch below it is rejected.  Runtime state: the
        # durable epoch is the CR's (status.replication), and the promote
        # verb re-fences when it resumes.
        self._fences: dict[tuple[str, str], int] = {}
        self.fenced_rejections: dict[tuple[str, str], int] = {}
        # observer (ns, nb) -> None of every rejection; the controller
        # counts them into notebook_replication_fenced_writes_total
        self.on_fenced_write: Optional[Callable[[str, str], None]] = None
        # (ns, nb, slice) -> (base generation, head seq, running sha256 of
        # the materialized state) of the chain this store last wrote
        self._heads: dict[tuple[str, str, int], tuple[int, int, object]] = {}

    @property
    def uri(self) -> str:
        raise NotImplementedError

    def snapshot_uri(self, namespace: str, notebook: str, slice_id: int,
                     generation: int) -> str:
        return (f"{self.uri}/{namespace}/{notebook}/slice-{slice_id}/"
                f"gen-{generation}")

    def delta_uri(self, namespace: str, notebook: str, slice_id: int,
                  base_generation: int, seq: int) -> str:
        return (f"{self.uri}/{namespace}/{notebook}/slice-{slice_id}/"
                f"delta-{base_generation}-{seq}")

    # -- the write fence (replicated tier) -------------------------------------
    def fence(self, namespace: str, notebook: str, epoch: int) -> int:
        """Raise the notebook's write fence to `epoch`, a monotonic max (an
        older epoch is a no-op, so a resumed promotion may re-fence).
        Returns the fence in force."""
        with self._lock:
            key = (namespace, notebook)
            cur = self._fences.get(key, 0)
            if epoch > cur:
                self._fences[key] = epoch
                cur = epoch
            return cur

    def fence_epoch(self, namespace: str, notebook: str) -> int:
        with self._lock:
            return self._fences.get((namespace, notebook), 0)

    def _check_fence(self, namespace: str, notebook: str,
                     writer_epoch: Optional[int]) -> None:
        """Caller holds the lock.  `writer_epoch=None` (a writer outside
        the replicated tier) always passes; a fenced write is counted,
        observed and raised."""
        if writer_epoch is None:
            return
        key = (namespace, notebook)
        if writer_epoch < self._fences.get(key, 0):
            self.fenced_rejections[key] = \
                self.fenced_rejections.get(key, 0) + 1
            cb = self.on_fenced_write
            if cb is not None:
                try:
                    cb(namespace, notebook)
                except Exception:  # noqa: BLE001 — an observer must not
                    pass           # turn a correct rejection into a crash
            raise StaleWriterError(
                f"write to {namespace}/{notebook} with epoch "
                f"{writer_epoch} below fence "
                f"{self._fences.get(key, 0)}: writer was demoted")

    # -- writes ----------------------------------------------------------------
    def put(self, namespace: str, notebook: str, slice_id: int,
            payload: bytes, trigger: str = TRIGGER_PERIODIC,
            writer_epoch: Optional[int] = None) -> SnapshotInfo:
        with self._lock:
            self._check_fence(namespace, notebook, writer_epoch)
            latest = self.latest(namespace, notebook, slice_id)
            generation = (latest.generation + 1) if latest else 1
            # the digest is computed beside the payload's write (hashlib
            # and file writes release the GIL), so a large snapshot pays
            # for one pass over its bytes, not two in a row
            with ThreadPoolExecutor(1) as pool:
                hashed = pool.submit(hashlib.sha256, payload)
                self._write_payload(namespace, notebook, slice_id,
                                    generation, payload)
                hasher = hashed.result()
                info = SnapshotInfo(
                    namespace=namespace,
                    notebook=notebook,
                    slice_id=slice_id,
                    generation=generation,
                    saved_at=self.clock.now(),
                    digest=_hex16(hasher),
                    trigger=trigger,
                    uri=self.snapshot_uri(namespace, notebook, slice_id,
                                          generation),
                    size=len(payload),
                )
            self._store(info, payload)
            self._heads[(namespace, notebook, slice_id)] = (
                generation, 0, hasher)
            self._prune(namespace, notebook, slice_id)
            kept = {s.generation
                    for s in self.snapshots(namespace, notebook, slice_id)}
            self._prune_deltas(namespace, notebook, slice_id, kept)
            return info

    def append_delta(self, namespace: str, notebook: str, slice_id: int,
                     delta: bytes, expected_seq: Optional[int] = None,
                     writer_epoch: Optional[int] = None) -> DeltaInfo:
        """Append one incremental state delta to the chain anchored at the
        latest base snapshot.  The chain is strictly ordered:
        `expected_seq`, when given, must name the next slot or the append
        is refused, so a primary that raced a compaction or replays a
        duplicate cannot corrupt the log."""
        with self._lock:
            self._check_fence(namespace, notebook, writer_epoch)
            base = self.latest(namespace, notebook, slice_id)
            if base is None:
                raise DeltaChainError(
                    f"no base snapshot for {namespace}/{notebook}/"
                    f"slice-{slice_id}: delta chains anchor to a base")
            chain = self.deltas(namespace, notebook, slice_id)
            next_seq = (chain[-1].seq + 1) if chain else 1
            if expected_seq is not None and expected_seq != next_seq:
                raise DeltaChainError(
                    f"out-of-order delta for {namespace}/{notebook}/"
                    f"slice-{slice_id}: expected_seq={expected_seq}, "
                    f"chain head wants {next_seq}")
            hasher = self._head_hasher(namespace, notebook, slice_id,
                                       base.generation, next_seq - 1)
            hasher.update(delta)
            info = DeltaInfo(
                namespace=namespace,
                notebook=notebook,
                slice_id=slice_id,
                base_generation=base.generation,
                seq=next_seq,
                saved_at=self.clock.now(),
                digest=_hex16(hasher),
                delta_digest=payload_digest(delta),
                uri=self.delta_uri(namespace, notebook, slice_id,
                                   base.generation, next_seq),
                size=len(delta),
            )
            self._store_delta(info, delta)
            self._heads[(namespace, notebook, slice_id)] = (
                base.generation, next_seq, hasher)
            return info

    def _head_hasher(self, namespace: str, notebook: str, slice_id: int,
                     base_generation: int, seq: int):
        """A copy of the running sha256 of the state at (base, seq): the
        one this store kept when it wrote that head, else a hash of the
        materialized state (another writer's chain)."""
        kept = self._heads.get((namespace, notebook, slice_id))
        if kept is not None and kept[:2] == (base_generation, seq):
            return kept[2].copy()
        return hashlib.sha256(
            self.materialize(namespace, notebook, slice_id) or b"")

    def compact(self, namespace: str, notebook: str, slice_id: int,
                trigger: str = TRIGGER_COMPACT,
                writer_epoch: Optional[int] = None) -> Optional[SnapshotInfo]:
        """Fold the current delta chain into a fresh base generation,
        digest-verified: the replayed bytes must hash to the chain head's
        recorded digest, or the compaction is refused and the chain left
        as it is.  An empty chain is a no-op (returns the current
        base)."""
        with self._lock:
            self._check_fence(namespace, notebook, writer_epoch)
            base = self.latest(namespace, notebook, slice_id)
            if base is None:
                return None
            chain = self.deltas(namespace, notebook, slice_id)
            if not chain:
                return base
            state = self.materialize(namespace, notebook, slice_id)
            if state is None or payload_digest(state) != chain[-1].digest:
                raise DeltaChainError(
                    f"compaction digest mismatch for {namespace}/"
                    f"{notebook}/slice-{slice_id}: replayed "
                    f"{payload_digest(state or b'')} != recorded "
                    f"{chain[-1].digest}; chain left untouched")
            return self.put(namespace, notebook, slice_id, state,
                            trigger=trigger, writer_epoch=writer_epoch)

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

    def deltas(self, namespace: str, notebook: str, slice_id: int,
               base_generation: Optional[int] = None) -> list[DeltaInfo]:
        """The ordered delta chain anchored at `base_generation` (default:
        the latest base snapshot's; empty when there is no base)."""
        with self._lock:
            if base_generation is None:
                base = self.latest(namespace, notebook, slice_id)
                if base is None:
                    return []
                base_generation = base.generation
            chain = [d for d, _ in
                     self._delta_entries(namespace, notebook, slice_id)
                     if d.base_generation == base_generation]
            return sorted(chain, key=lambda d: d.seq)

    def delta_payload(self, namespace: str, notebook: str, slice_id: int,
                      base_generation: int, seq: int) -> Optional[bytes]:
        with self._lock:
            return next(
                (p for d, p in
                 self._delta_entries(namespace, notebook, slice_id)
                 if d.base_generation == base_generation and d.seq == seq),
                None)

    def materialize(self, namespace: str, notebook: str, slice_id: int,
                    upto_seq: Optional[int] = None) -> Optional[bytes]:
        """The latest base payload followed by its delta chain (through
        `upto_seq` when given): the current session state."""
        with self._lock:
            base = self.latest(namespace, notebook, slice_id)
            if base is None:
                return None
            state = self.payload(namespace, notebook, slice_id,
                                 generation=base.generation)
            if state is None:
                return None
            for d in self.deltas(namespace, notebook, slice_id):
                if upto_seq is not None and d.seq > upto_seq:
                    break
                chunk = self.delta_payload(namespace, notebook, slice_id,
                                           d.base_generation, d.seq)
                if chunk is None:
                    break
                state = state + chunk
            return state

    def chain_head(self, namespace: str, notebook: str,
                   slice_id: int) -> Optional[tuple[int, int, str]]:
        """(base_generation, head_seq, head_digest) of the current chain,
        the freshness mark that follower catch-up and the promote verb
        compare against; None when there is no base snapshot."""
        with self._lock:
            base = self.latest(namespace, notebook, slice_id)
            if base is None:
                return None
            chain = self.deltas(namespace, notebook, slice_id)
            if not chain:
                return (base.generation, 0, base.digest)
            return (base.generation, chain[-1].seq, chain[-1].digest)

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

    def _store_delta(self, info: DeltaInfo, delta: bytes) -> None:
        raise NotImplementedError

    def _delta_entries(self, namespace: str, notebook: str,
                       slice_id: int) -> list[tuple[DeltaInfo, bytes]]:
        raise NotImplementedError

    def _prune_deltas(self, namespace: str, notebook: str, slice_id: int,
                      keep_bases: set[int]) -> None:
        """Drop the delta chains whose base generation was pruned (a chain
        without its base can never be replayed)."""
        raise NotImplementedError


class InMemorySessionStore(SessionStateStore):
    """Dict-backed store for unit tests and single-process drills."""

    def __init__(self, clock: Optional[Clock] = None,
                 max_to_keep: int = DEFAULT_MAX_TO_KEEP) -> None:
        super().__init__(clock=clock, max_to_keep=max_to_keep)
        self._data: dict[tuple[str, str, int],
                         list[tuple[SnapshotInfo, bytes]]] = {}
        self._delta_data: dict[tuple[str, str, int],
                               list[tuple[DeltaInfo, bytes]]] = {}

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

    def _store_delta(self, info: DeltaInfo, delta: bytes) -> None:
        key = (info.namespace, info.notebook, info.slice_id)
        self._delta_data.setdefault(key, []).append((info, bytes(delta)))

    def _delta_entries(self, namespace: str, notebook: str,
                       slice_id: int) -> list[tuple[DeltaInfo, bytes]]:
        with self._lock:
            return list(self._delta_data.get((namespace, notebook,
                                              slice_id), []))

    def _prune_deltas(self, namespace: str, notebook: str, slice_id: int,
                      keep_bases: set[int]) -> None:
        key = (namespace, notebook, slice_id)
        entries = self._delta_data.get(key)
        if entries:
            self._delta_data[key] = [
                (d, p) for d, p in entries
                if d.base_generation in keep_bases]


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

    # delta chains live beside the base snapshots as
    # `delta-<base>-<seq>.bin/.json`, a name the snapshot globs (`gen-*`)
    # never match, so the snapshots' orphan GC cannot take a committed
    # delta.  The commit discipline is _store's: the payload first, the
    # metadata marker renamed into place last.
    def _store_delta(self, info: DeltaInfo, delta: bytes) -> None:
        d = self._slice_dir(info.namespace, info.notebook, info.slice_id)
        d.mkdir(parents=True, exist_ok=True)
        stem = f"delta-{info.base_generation}-{info.seq}"
        _atomic_write(d / f"{stem}.bin", delta)
        meta = {
            "namespace": info.namespace,
            "notebook": info.notebook,
            "slice_id": info.slice_id,
            "base_generation": info.base_generation,
            "seq": info.seq,
            "saved_at": info.saved_at,
            "digest": info.digest,
            "delta_digest": info.delta_digest,
            "uri": info.uri,
            "size": info.size,
        }
        _atomic_write(d / f"{stem}.json", json.dumps(meta).encode())

    def _delta_entries(self, namespace: str, notebook: str,
                       slice_id: int) -> list[tuple[DeltaInfo, bytes]]:
        d = self._slice_dir(namespace, notebook, slice_id)
        if not d.is_dir():
            return []
        with self._lock:
            out = []
            committed: set[tuple[int, int]] = set()
            for meta_path in sorted(d.glob("delta-*.json")):
                try:
                    info = DeltaInfo(**json.loads(meta_path.read_text()))
                except (OSError, ValueError, TypeError):
                    # a torn or corrupt commit marker: GC both halves
                    meta_path.unlink(missing_ok=True)
                    meta_path.with_suffix(".bin").unlink(missing_ok=True)
                    continue
                try:
                    payload = meta_path.with_suffix(".bin").read_bytes()
                except OSError:
                    meta_path.unlink(missing_ok=True)
                    continue
                committed.add((info.base_generation, info.seq))
                out.append((info, payload))
            for bin_path in d.glob("delta-*.bin"):
                parts = bin_path.stem.split("-")
                try:
                    key = (int(parts[1]), int(parts[2]))
                except (IndexError, ValueError):
                    bin_path.unlink(missing_ok=True)
                    continue
                if key not in committed:
                    bin_path.unlink(missing_ok=True)
            return sorted(out,
                          key=lambda e: (e[0].base_generation, e[0].seq))

    def _prune_deltas(self, namespace: str, notebook: str, slice_id: int,
                      keep_bases: set[int]) -> None:
        d = self._slice_dir(namespace, notebook, slice_id)
        if not d.is_dir():
            return
        for meta_path in d.glob("delta-*.json"):
            try:
                base = int(meta_path.stem.split("-")[1])
            except (IndexError, ValueError):
                continue
            if base not in keep_bases:
                meta_path.unlink(missing_ok=True)
                meta_path.with_suffix(".bin").unlink(missing_ok=True)


class FollowerReplica:
    """A follower's catch-up cursor over one slice's base and delta
    stream.

    The cursor tracks (base_generation, seq) and replays forward on each
    `catch_up()`: when the store's latest base generation moved (a fresh
    snapshot, or a compaction that folded the chain), the follower loads
    that base in full, so catch-up works from any base, then applies the
    missing deltas in order, verifying each recorded digest of the
    materialized state.  A gap in the chain (a delta pruned under the
    cursor) stops the replay at the last verified state.  The cursor
    keeps the running sha256 of its state, so each delta costs a hash of
    its own bytes.

    In production this loop runs in the follower pod's runtime; in tests
    the fake cluster drives one cursor per follower replica and stamps
    its freshness onto the follower pods
    (ANNOTATION_REPLICA_GENERATION/SEQ/DIGEST) for the promote verb."""

    def __init__(self, store: SessionStateStore, namespace: str,
                 notebook: str, slice_id: int = 0) -> None:
        self.store = store
        self.namespace = namespace
        self.notebook = notebook
        self.slice_id = slice_id
        self.base_generation = 0
        self.seq = 0
        self.state: Optional[bytes] = None
        self.applied_total = 0
        self._hasher = None

    def catch_up(self) -> int:
        """Apply everything new; returns the replay steps taken (a base
        load counts as one)."""
        applied = 0
        with self.store._lock:
            latest = self.store.latest(self.namespace, self.notebook,
                                       self.slice_id)
            if latest is None:
                return 0
            if latest.generation != self.base_generation:
                payload = self.store.payload(
                    self.namespace, self.notebook, self.slice_id,
                    generation=latest.generation)
                if payload is None:
                    return 0
                self.state = payload
                self._hasher = hashlib.sha256(payload)
                self.base_generation = latest.generation
                self.seq = 0
                applied += 1
            chunks = []
            try:
                for d in self.store.deltas(
                        self.namespace, self.notebook, self.slice_id,
                        base_generation=self.base_generation):
                    if d.seq <= self.seq:
                        continue
                    if d.seq != self.seq + 1:
                        break  # a gap in the chain: stop where verified
                    chunk = self.store.delta_payload(
                        self.namespace, self.notebook, self.slice_id,
                        d.base_generation, d.seq)
                    if chunk is None:
                        break
                    hasher = self._hasher.copy()
                    hasher.update(chunk)
                    if _hex16(hasher) != d.digest:
                        raise DeltaChainError(
                            f"follower replay digest mismatch at "
                            f"{self.namespace}/{self.notebook}/slice-"
                            f"{self.slice_id} delta {d.base_generation}-"
                            f"{d.seq}")
                    self._hasher = hasher
                    chunks.append(chunk)
                    self.seq = d.seq
                    applied += 1
            finally:
                if chunks:
                    # one copy of the state for the deltas this call applied
                    self.state = b"".join([self.state or b""] + chunks)
        self.applied_total += applied
        return applied

    @property
    def digest(self) -> str:
        return _hex16(self._hasher) if self.state is not None else ""

    def lag(self) -> int:
        """Replay steps between this cursor and the chain head (0: caught
        up; a stale base counts the whole chain behind the new base)."""
        head = self.store.chain_head(self.namespace, self.notebook,
                                     self.slice_id)
        if head is None:
            return 0
        head_gen, head_seq, _ = head
        if head_gen != self.base_generation:
            return 1 + head_seq
        return max(head_seq - self.seq, 0)

    def caught_up(self, max_lag: int = 0) -> bool:
        return self.lag() <= max_lag


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


__all__ = ["DeltaChainError", "DeltaInfo", "DirSessionStore",
           "FinalSnapshotHandler", "FollowerReplica", "InMemorySessionStore",
           "SessionStateStore", "SnapshotInfo", "StaleWriterError",
           "TRIGGER_COMPACT", "TRIGGER_CULL", "TRIGGER_FINAL",
           "TRIGGER_PERIODIC", "TRIGGER_PRE_STOP", "open_store",
           "payload_digest"]
