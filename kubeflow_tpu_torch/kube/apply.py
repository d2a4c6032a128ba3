"""Server-side apply: field ownership via managedFields (fieldsV1).

The port's copy of kubeflow_tpu/kube/apply.py.

The apiserver's structured-merge-diff library implements apply in full
generality; this is the principled subset an envtest analog needs
(docs/wire_compat.md documents the edges):

  - every apply records EXACTLY the applied field set for its manager in
    `metadata.managedFields` (fieldsV1: `f:<field>` keys, `k:{...}` keyed
    list items with a `.` membership marker, atomic lists as leaves);
  - a field another APPLY manager owns conflicts (409) unless the applied
    value is identical (co-ownership) or `force=true` steals it;
  - fields a manager applied before but dropped from its config are
    PRUNED from the object — apply is declarative, not additive;
  - keyed lists merge per `strategicmerge.MERGE_KEYS`, so two managers
    can own different containers (or different fields of one container);
  - plain updates/patches do not participate in ownership (the real
    apiserver attributes them to an `Update` operation entry; this subset
    only arbitrates between apply managers).

Reference context: the reference's controllers use create/update/patch
(SURVEY.md §2), but kubectl >=1.22 defaults `kubectl apply` to
server-side on conflict-prone paths and GitOps tooling applies CRs with
field managers — a wire server claiming apiserver fidelity must arbitrate
them.
"""

from __future__ import annotations

import copy
import json
from typing import Iterator, Optional

from .strategicmerge import MERGE_KEYS

# metadata keys the server owns; never part of an applied field set
_SERVER_META = frozenset({
    "uid", "resourceVersion", "generation", "creationTimestamp",
    "deletionTimestamp", "managedFields", "selfLink",
})


class ApplyConflict(Exception):
    """Another field manager owns one of the applied fields."""

    def __init__(self, clashes: list[tuple[str, tuple]]):
        self.clashes = clashes  # (manager, fieldsV1 leaf path)
        details = "; ".join(
            f"{_pretty(path)} (owned by {mgr})" for mgr, path in clashes)
        super().__init__(f"conflict with other field managers: {details}")


def sanitize_applied(applied: dict) -> dict:
    """Strip server-managed fields from an applied config — clients that
    read-modify-apply send uid/resourceVersion/managedFields back, and
    none of those may be applied (status goes through its subresource)."""
    out = copy.deepcopy(applied)
    meta = out.get("metadata")
    if isinstance(meta, dict):
        for key in _SERVER_META:
            meta.pop(key, None)
    out.pop("status", None)
    return out


def _merge_key_for(field_name: str, items: list) -> Optional[str]:
    candidates = MERGE_KEYS.get(field_name)
    if not candidates:
        return None
    dict_items = [x for x in items if isinstance(x, dict)]
    if not dict_items or len(dict_items) != len(items):
        return None
    for cand in candidates:
        if all(cand in x for x in dict_items):
            return cand
    return None


def field_set(obj: dict) -> dict:
    """fieldsV1 tree of an applied config.  apiVersion/kind and
    server-managed metadata are excluded (the server owns them).  An
    applied EMPTY map claims nothing — `spec: {}` must neither conflict
    with other managers' spec fields nor own the subtree atomically."""
    out: dict = {}
    for key, val in obj.items():
        if key in ("apiVersion", "kind", "status"):
            continue
        if key == "metadata" and isinstance(val, dict):
            meta = {k: v for k, v in val.items() if k not in _SERVER_META
                    and k not in ("name", "namespace")}
            _fs_add(out, "metadata", meta, None)
            continue
        _fs_add(out, key, val, key)
    return out


def _fs_add(out: dict, key: str, val, field_name: Optional[str]) -> None:
    sub = _fs_value(val, field_name)
    if isinstance(val, dict) and not sub:
        return  # empty maps (transitively) claim nothing
    out[f"f:{key}"] = sub


def _fs_value(val, field_name: Optional[str]) -> dict:
    if isinstance(val, dict):
        out: dict = {}
        for k, v in val.items():
            _fs_add(out, k, v, k)
        return out
    if isinstance(val, list):
        key = _merge_key_for(field_name or "", val)
        if key is None:
            return {}  # atomic list: owned wholesale
        out = {}
        for item in val:
            tok = "k:" + json.dumps({key: item[key]}, sort_keys=True,
                                    separators=(",", ":"))
            entry: dict = {}
            for k, v in item.items():
                _fs_add(entry, k, v, k)
            entry["."] = {}
            out[tok] = entry
        return out
    return {}  # scalar leaf


def leaf_paths(fs: dict, prefix: tuple = ()) -> Iterator[tuple]:
    """Ownable leaves of a fieldsV1 tree.  A `k:` item's `.` marker is a
    leaf (item membership); empty dicts are value leaves.  Tolerates
    malformed trees (clients can write arbitrary managedFields through
    plain create/update): non-dict nodes are leaves."""
    for key, sub in fs.items():
        if not isinstance(key, str):
            continue
        path = prefix + (key,)
        if not isinstance(sub, dict) or not sub:
            yield path
        else:
            yield from leaf_paths(sub, path)


def _contains_path(fs: dict, path: tuple) -> bool:
    cur = fs
    for tok in path:
        if not isinstance(cur, dict) or tok not in cur:
            return False
        cur = cur[tok]
    return True


def _value_at(obj: dict, path: tuple):
    """Object value addressed by a fieldsV1 leaf path; _MISSING if absent."""
    cur: object = obj
    for tok in path:
        if tok == ".":
            continue  # membership marker: the item itself
        if tok.startswith("f:"):
            if not isinstance(cur, dict):
                return _MISSING
            if tok[2:] not in cur:
                return _MISSING
            cur = cur[tok[2:]]
        elif tok.startswith("k:"):
            if not isinstance(cur, list):
                return _MISSING
            want = json.loads(tok[2:])
            for item in cur:
                if isinstance(item, dict) and all(
                        item.get(k) == v for k, v in want.items()):
                    cur = item
                    break
            else:
                return _MISSING
        else:  # pragma: no cover — unknown token kind
            return _MISSING
    return cur


class _Missing:
    pass


_MISSING = _Missing()


def find_conflicts(
    applied: dict, applied_fs: dict, current: dict,
    others: list[tuple[str, dict]],
) -> list[tuple[str, tuple]]:
    """(manager, leaf path) for every applied leaf another manager owns
    with a DIFFERENT current value — equal values co-own, no conflict."""
    clashes: list[tuple[str, tuple]] = []
    for path in leaf_paths(applied_fs):
        if path[-1] == ".":
            # item MEMBERSHIP always co-owns: two managers applying
            # disjoint field subsets of the same container must compose,
            # not 409 (conflicts arise only on actual value leaves)
            continue
        desired = _value_at(applied, path)
        have = _value_at(current, path)
        if desired is not _MISSING and have is not _MISSING \
                and desired == have:
            continue
        for manager, fs in others:
            if _contains_path(fs, path):
                clashes.append((manager, path))
    return clashes


def _pretty(path: tuple) -> str:
    return ".".join(t[2:] if t.startswith(("f:", "k:")) else t
                    for t in path if t != ".")


def prune(obj: dict, old_fs: dict, new_fs: dict,
          others: list[tuple[str, dict]]) -> dict:
    """Remove leaves this manager owned before but no longer applies —
    unless another manager also owns them (co-ownership keeps them).

    Item-membership markers (`.`) are processed FIRST: dropping an item
    removes the whole list element (provided nobody else owns anything
    under it) — field-by-field pruning first would strip the merge key
    and strand an unidentifiable empty item."""
    out = copy.deepcopy(obj)
    ordered = sorted(leaf_paths(old_fs),
                     key=lambda p: 0 if p[-1] == "." else 1)
    for path in ordered:
        if _contains_path(new_fs, path):
            continue
        if path[-1] == ".":
            item = path[:-1]
            if _contains_path(new_fs, item) or any(
                    _contains_path(fs, item) for _, fs in others):
                continue  # someone still owns (part of) the item
            _remove_at(out, item)
            continue
        if any(_contains_path(fs, path) for _, fs in others):
            continue
        _remove_at(out, path)
    return out


def _remove_at(obj, path: tuple) -> None:
    if not path:
        return
    *parents, last = path
    # walk to the parent (mirrors _value_at but keeps the reference)
    cur: object = obj
    for tok in parents:
        if tok == ".":
            continue
        if tok.startswith("f:"):
            if not isinstance(cur, dict) or tok[2:] not in cur:
                return
            cur = cur[tok[2:]]
        elif tok.startswith("k:"):
            if not isinstance(cur, list):
                return
            want = json.loads(tok[2:])
            for item in cur:
                if isinstance(item, dict) and all(
                        item.get(k) == v for k, v in want.items()):
                    cur = item
                    break
            else:
                return
    if last == ".":
        return  # membership markers are pruned via their item fields
    if last.startswith("f:") and isinstance(cur, dict):
        cur.pop(last[2:], None)
    elif last.startswith("k:") and isinstance(cur, list):
        want = json.loads(last[2:])
        cur[:] = [x for x in cur if not (
            isinstance(x, dict)
            and all(x.get(k) == v for k, v in want.items()))]


def merge_applied(current: dict, applied: dict) -> dict:
    """Overlay the applied config onto the (already pruned) object —
    structural merge with keyed-list item merge; atomic lists and scalars
    replace."""
    out = copy.deepcopy(current)
    _merge_into(out, applied, None)
    return out


def _merge_into(out: dict, applied: dict, _field: Optional[str]) -> None:
    for key, val in applied.items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            _merge_into(out[key], val, key)
        elif isinstance(val, list) and isinstance(out.get(key), list):
            mk = _merge_key_for(key, val)
            if mk is None:
                out[key] = copy.deepcopy(val)
                continue
            for item in val:
                for i, existing in enumerate(out[key]):
                    if isinstance(existing, dict) \
                            and existing.get(mk) == item[mk]:
                        merged = copy.deepcopy(existing)
                        _merge_into(merged, item, key)
                        out[key][i] = merged
                        break
                else:
                    out[key].append(copy.deepcopy(item))
        else:
            out[key] = copy.deepcopy(val)


def drop_empty_structures(obj, fs_root: dict, path: tuple = ()):  # noqa: ANN001
    """After pruning, empty dicts nobody owns disappear (the apiserver's
    structured-merge-diff does the same cleanup) — including maps emptied
    INSIDE keyed-list items (resources.limits pruned out of a container)."""
    if isinstance(obj, dict):
        for key in list(obj):
            child = obj[key]
            drop_empty_structures(child, fs_root, path + (f"f:{key}",))
            if isinstance(child, (dict, list)) and not child \
                    and not _contains_path(fs_root, path + (f"f:{key}",)):
                del obj[key]
    elif isinstance(obj, list):
        field_name = path[-1][2:] if path and path[-1].startswith("f:") else ""
        mk = _merge_key_for(field_name, obj)
        if mk is None:
            return  # atomic list: contents owned wholesale, not walked
        for item in obj:
            tok = "k:" + json.dumps({mk: item[mk]}, sort_keys=True,
                                    separators=(",", ":"))
            drop_empty_structures(item, fs_root, path + (tok,))


def apply_update(
    current: dict, applied: dict, manager: str, api_version: str,
    force: bool = False, now: str = "",
) -> dict:
    """One server-side apply step: conflict-check, prune, merge, and
    rewrite this manager's managedFields entry.  Returns the new object
    dict; raises ApplyConflict.  `applied` must be pre-sanitized
    (sanitize_applied) — ApiServer.apply does this once, outside its
    retry loop."""
    applied_fs = field_set(applied)
    meta = current.get("metadata") or {}
    entries = [e for e in (meta.get("managedFields") or [])
               if isinstance(e, dict)]  # non-dict junk from plain writes
    mine_entry: Optional[dict] = None
    mine_old: dict = {}
    others: list[tuple[str, dict]] = []
    for e in entries:
        if e.get("operation") != "Apply":
            continue
        fs = e.get("fieldsV1")
        if not isinstance(fs, dict):
            fs = {}  # malformed tree written via plain update: ignore
        if e.get("manager") == manager:
            mine_entry, mine_old = e, fs
        else:
            others.append((e.get("manager", "?"), fs))

    clashes = find_conflicts(applied, applied_fs, current, others)
    if clashes:
        if not force:
            raise ApplyConflict(clashes)
        # forced: stolen fields leave the losers' sets
        for _, path in clashes:
            for _, fs in others:
                _remove_fs_path(fs, path)

    pruned = prune(current, mine_old, applied_fs, others)
    out = merge_applied(pruned, applied)
    # everyone's ownership forest, for the cleanup walk
    forest: dict = {}
    for _, fs in others:
        _fs_union(forest, fs)
    _fs_union(forest, applied_fs)
    drop_empty_structures(out, forest)

    new_meta = out.setdefault("metadata", {})
    if mine_entry is not None and mine_entry.get("fieldsV1") == applied_fs:
        # unchanged field set: keep the old timestamp so an identical
        # re-apply is a byte-identical object — the store's no-op
        # suppression then skips the RV bump, and a GitOps loop
        # re-applying on a timer doesn't wake every watcher each pass
        now = mine_entry.get("time", now)
    new_entry = {
        "manager": manager,
        "operation": "Apply",
        "apiVersion": api_version,
        "fieldsType": "FieldsV1",
        "fieldsV1": applied_fs,
        **({"time": now} if now else {}),
    }
    # replace IN PLACE: filter-then-append would permute entry order, so
    # two managers alternating identical re-applies would never produce a
    # byte-identical object and would bump the RV forever
    kept: list[dict] = []
    for e in entries:
        if e is mine_entry:
            kept.append(new_entry)
        elif e.get("operation") == "Apply" and not e.get("fieldsV1"):
            continue  # emptied by a forced steal: drop the husk
        else:
            kept.append(e)
    if mine_entry is None:
        kept.append(new_entry)
    new_meta["managedFields"] = kept
    return out


def _remove_fs_path(fs: dict, path: tuple) -> None:
    if not path:
        return
    if len(path) == 1:
        fs.pop(path[0], None)
        return
    child = fs.get(path[0])
    if isinstance(child, dict):
        _remove_fs_path(child, path[1:])
        if not child:
            fs.pop(path[0], None)


def _fs_union(dst: dict, src: dict) -> None:
    for key, val in src.items():
        if key in dst and isinstance(dst[key], dict) and isinstance(val, dict):
            _fs_union(dst[key], val)
        else:
            dst[key] = copy.deepcopy(val)


__all__ = ["apply_update", "field_set", "leaf_paths", "ApplyConflict"]
