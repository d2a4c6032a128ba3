"""Strategic merge patch (application/strategic-merge-patch+json).

The port's copy of kubeflow_tpu/kube/strategicmerge.py.

Kubernetes' strategic merge differs from RFC 7386 in one load-bearing way:
lists of objects whose Go type carries a `patchMergeKey` tag are merged
BY KEY (containers by name, volumeMounts by mountPath, ...) instead of
replaced wholesale, and patches can carry directives (`$patch: delete`,
`$patch: replace`, `$deleteFromPrimitiveList/...`, `$retainKeys`).  The
apiserver reads the merge keys from struct tags (k8s.io/api/core/v1/
types.go); a dynamic server has no structs, so we pin the well-known keys
the workload API actually uses — the same table kubectl's openapi-less
fallback hardcodes.

Reference context: the reference's controllers send merge patches
(odh notebook_controller.go:516-523) but kubectl apply against the CRD
sends strategic-merge for core types; serving it faithfully keeps the
wire server honest as an envtest analog (docs/wire_compat.md).
"""

from __future__ import annotations

import copy
from typing import Any

# field name -> candidate merge keys, tried in order; first key present on
# every object item wins.  Candidates resolve same-named fields with
# different keys (Container.ports keys on containerPort, ServiceSpec.ports
# on port).  Mirrors the patchMergeKey struct tags in k8s.io/api.
MERGE_KEYS: dict[str, tuple[str, ...]] = {
    "containers": ("name",),
    "initContainers": ("name",),
    "ephemeralContainers": ("name",),
    "env": ("name",),
    "ports": ("containerPort", "port"),
    "volumeMounts": ("mountPath",),
    "volumeDevices": ("devicePath",),
    "volumes": ("name",),
    "imagePullSecrets": ("name",),
    "hostAliases": ("ip",),
    "topologySpreadConstraints": ("topologyKey",),
    "readinessGates": ("conditionType",),
    "conditions": ("type",),
    "secrets": ("name",),          # ServiceAccount.secrets
    "ownerReferences": ("uid",),   # ObjectMeta.ownerReferences
}

# primitive lists with patchStrategy=merge: patch items UNION into the base
# list (ObjectMeta.finalizers); everything else replaces atomically
PRIMITIVE_MERGE_FIELDS = frozenset({"finalizers"})

_DELETE_PRIMITIVE = "$deleteFromPrimitiveList/"
_SET_ORDER = "$setElementOrder/"


def strategic_merge(base: dict, patch: dict) -> dict:
    """Apply `patch` to `base` with strategic-merge semantics.  Neither
    input is mutated (the one deep copy happens here; the recursive helpers
    build in place).  `$setElementOrder` directives are accepted and
    ignored (ordering hints only — the merged content is unaffected)."""
    return _merge_map(copy.deepcopy(base), patch)


def _is_directive(key: str) -> bool:
    return (key in ("$patch", "$retainKeys")
            or key.startswith(_DELETE_PRIMITIVE)
            or key.startswith(_SET_ORDER))


def _is_pure_directive(item: Any) -> bool:
    return (isinstance(item, dict) and bool(item)
            and all(_is_directive(k) for k in item))


def _clean(val: Any) -> Any:
    """Deep-copy with every $-directive stripped — directives drive the
    merge; they must never be persisted (the apiserver strips them too)."""
    if isinstance(val, dict):
        return {k: _clean(v) for k, v in val.items() if not _is_directive(k)}
    if isinstance(val, list):
        return [_clean(x) for x in val if not _is_pure_directive(x)]
    return copy.deepcopy(val)


def _merge_map(out: dict, patch: dict) -> dict:
    """Merge `patch` into `out` IN PLACE (out is owned by the caller's one
    deep copy) and return it."""
    if patch.get("$patch") == "replace":
        return _clean(patch)
    if patch.get("$patch") == "delete":
        return {}
    for key, val in patch.items():
        if _is_directive(key):
            continue  # directive passes run after field merges
        if val is None or (isinstance(val, dict)
                           and val.get("$patch") == "delete"):
            out.pop(key, None)
        elif isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = _merge_map(out[key], val)
        elif isinstance(val, list) and key in MERGE_KEYS:
            cur = out.get(key)
            out[key] = _merge_list(cur if isinstance(cur, list) else [],
                                   val, MERGE_KEYS[key])
        elif (isinstance(val, list) and key in PRIMITIVE_MERGE_FIELDS
              and isinstance(out.get(key), list)):
            out[key] = out[key] + [x for x in val if x not in out[key]]
        else:
            out[key] = _clean(val)
    # deletions LAST, independent of JSON key order — kubectl emits
    # additions and $deleteFromPrimitiveList for the same field in one patch
    for key, val in patch.items():
        if key.startswith(_DELETE_PRIMITIVE):
            field = key[len(_DELETE_PRIMITIVE):]
            cur = out.get(field)
            if isinstance(cur, list) and isinstance(val, list):
                out[field] = [x for x in cur if x not in val]
    # $retainKeys (patchStrategy=retainKeys): after the merge, the map keeps
    # only the listed keys — kubectl uses it to clear one-of fields
    retain = patch.get("$retainKeys")
    if isinstance(retain, list):
        for key in [k for k in out if k not in retain]:
            out.pop(key)
    return out


def _pick_key(base: list, patch: list, candidates: tuple[str, ...]):
    """First candidate key present on every dict item (pure-directive items
    like {"$patch": "replace"} don't vote); None -> the list is treated
    atomically.  If the BASE items agree on a merge key but a patch item
    omits it, the patch is malformed — raise rather than silently degrade
    to whole-list replace (the apiserver answers 'does not contain declared
    merge key')."""
    if any(not isinstance(x, dict) for x in list(base) + list(patch)):
        return None
    voting = [x for x in list(base) + list(patch) if not _is_pure_directive(x)]
    if not voting:
        return None
    for cand in candidates:
        if all(cand in x for x in voting):
            return cand
    base_voting = [x for x in base if not _is_pure_directive(x)]
    for cand in candidates:
        if base_voting and all(cand in x for x in base_voting):
            raise ValueError(
                f"strategic merge patch list item does not contain the "
                f"declared merge key {cand!r}")
    return None


def _merge_list(out: list, patch: list, candidates: tuple[str, ...]) -> list:
    """Merge `patch` into `out` IN PLACE (caller owns the copy); returns
    the merged list."""
    # an {"$patch": "replace"} item means: the patch list (minus the
    # directive) replaces the base list entirely
    if any(isinstance(x, dict) and x.get("$patch") == "replace" for x in patch):
        return _clean([x for x in patch
                       if not (isinstance(x, dict)
                               and x.get("$patch") == "replace")])
    key = _pick_key(out, patch, candidates)
    if key is None:
        return _clean(patch)
    for item in patch:
        if _is_pure_directive(item):
            if item.get("$patch") == "delete":
                out.clear()  # a key-less delete directive clears the list
            continue  # other pure directives never become items
        if not isinstance(item, dict) or key not in item:
            out.append(_clean(item))
            continue
        if item.get("$patch") == "delete":
            out[:] = [x for x in out
                      if not (isinstance(x, dict) and x.get(key) == item[key])]
            continue
        for i, existing in enumerate(out):
            if isinstance(existing, dict) and existing.get(key) == item[key]:
                out[i] = _merge_map(existing, item)
                break
        else:
            out.append(_clean(item))
    return out
