"""The promotion drill's delta-chain work on the host, timed with the
session store's running sha256 and with a full re-hash of the state.

    python -m kubeflow_tpu_torch.bench_chain [--gb GB] [--records N]

chip_smoke.py's promotion drill puts run A's train state (4.758 GB at
BENCH_CHIP) as the base of a delta chain, appends one record a step, and
has a FollowerReplica of a second store on the same directory replay the
chain, all on a thread beside the rest of drill 3.  The store and the
follower keep the running sha256 of the state, so an append and a
replayed delta hash only the delta's bytes.  This script times that work
twice, on one random payload of `--gb` GB (default 4.758) and `--records`
records of the drill's size (default 2), each time in a fresh temporary
directory:
- "running": the store and the follower as they are;
- "rehash": before each append the store forgets its running hash, so
  it hashes the materialized state in full (its path for a chain that
  another store wrote, and the reference's only path), and the follower
  hashes its whole state after each delta and once more for its digest
  (the reference's replay).
It prints one JSON line per mode with the seconds of the put, the
appends and the catch-up, then one line with the extra seconds of
"rehash" over "running" for the appends and the catch-up.  Host work
only: it needs no card.
"""

from __future__ import annotations

import argparse
import gc
import json
import tempfile
import time

import numpy as np

from .core.sessionstate import (
    DeltaChainError,
    DirSessionStore,
    FollowerReplica,
    payload_digest,
)

NS, NB = "bench", "chain"


def rehash_catch_up(store: DirSessionStore) -> str:
    """The reference's follower replay of the latest base's chain: each
    delta joined onto the state and the whole state hashed against the
    delta's recorded digest; returns the state's digest, hashed again."""
    base = store.latest(NS, NB, 0)
    state = store.payload(NS, NB, 0, generation=base.generation)
    for d in store.deltas(NS, NB, 0, base_generation=base.generation):
        state = state + store.delta_payload(NS, NB, 0, d.base_generation,
                                            d.seq)
        if payload_digest(state) != d.digest:
            raise DeltaChainError(f"digest mismatch at delta {d.seq}")
    return payload_digest(state)


def run(payload: bytes, records: list, mode: str) -> dict:
    """One drill's chain work in `mode` ("running" or "rehash")."""
    with tempfile.TemporaryDirectory() as root:
        store = DirSessionStore(root)
        t0 = time.perf_counter()
        store.put(NS, NB, 0, payload, writer_epoch=1)
        t1 = time.perf_counter()
        for n, rec in enumerate(records):
            if mode == "rehash":
                store._heads.clear()
            store.append_delta(NS, NB, 0, rec, expected_seq=n + 1,
                               writer_epoch=1)
        t2 = time.perf_counter()
        _, _, head = store.chain_head(NS, NB, 0)
        if mode == "rehash":
            digest = rehash_catch_up(DirSessionStore(root))
        else:
            follower = FollowerReplica(DirSessionStore(root), NS, NB, 0)
            follower.catch_up()
            digest = follower.digest
        t3 = time.perf_counter()
        if digest != head:
            raise DeltaChainError(f"{mode}: replayed digest {digest} is not "
                                  f"the chain head's {head}")
        gc.collect()
        return {"mode": mode, "bytes": len(payload), "records": len(records),
                "put_s": t1 - t0, "append_s": t2 - t1, "catch_up_s": t3 - t2}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gb", type=float, default=4.758)
    p.add_argument("--records", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    payload = np.random.default_rng(args.seed).bytes(int(args.gb * 1e9))
    # a record of the drill's size: its step, batch and the loss's bits
    records = [json.dumps({"step": 11 + i, "batch": 10 + i,
                           "loss": float(i).hex()}).encode()
               for i in range(args.records)]
    out = {m: run(payload, records, m) for m in ("running", "rehash")}
    for line in out.values():
        print(json.dumps(line))
    print(json.dumps({
        "extra_append_s": out["rehash"]["append_s"]
        - out["running"]["append_s"],
        "extra_catch_up_s": out["rehash"]["catch_up_s"]
        - out["running"]["catch_up_s"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
