"""RFC 6902 JSON Patch: diff generation and application.

The port's copy of kubeflow_tpu/kube/jsonpatch.py.

AdmissionReview mutating responses carry a JSONPatch from the webhook back
to the apiserver (controller-runtime's admission.PatchResponseFromRaw, used
at odh notebook_mutating_webhook.go:515, computes exactly this diff).  The
generator emits minimal add/remove/replace ops between two JSON documents;
the applier is used by the wire-protocol apiserver to apply a remote
webhook's patch before storing the object.
"""

from __future__ import annotations

import copy
from typing import Any


def _escape(token: str) -> str:
    return token.replace("~", "~0").replace("/", "~1")


def _unescape(token: str) -> str:
    return token.replace("~1", "/").replace("~0", "~")


def diff(old: Any, new: Any, path: str = "") -> list[dict]:
    """Minimal JSON Patch transforming `old` into `new`."""
    if type(old) is not type(new):
        return [{"op": "replace" if path else "add", "path": path or "",
                 "value": copy.deepcopy(new)}] if old != new else []
    if isinstance(old, dict):
        ops: list[dict] = []
        for key in old:
            sub = f"{path}/{_escape(str(key))}"
            if key not in new:
                ops.append({"op": "remove", "path": sub})
            else:
                ops.extend(diff(old[key], new[key], sub))
        for key in new:
            if key not in old:
                ops.append({"op": "add", "path": f"{path}/{_escape(str(key))}",
                            "value": copy.deepcopy(new[key])})
        return ops
    if isinstance(old, list):
        if old == new:
            return []
        # element-wise for the common prefix, then add/remove the tail —
        # simple and correct (not minimal for reorders, which is fine)
        ops = []
        for i in range(min(len(old), len(new))):
            ops.extend(diff(old[i], new[i], f"{path}/{i}"))
        for i in range(len(old) - 1, len(new) - 1, -1):
            ops.append({"op": "remove", "path": f"{path}/{i}"})
        for i in range(len(old), len(new)):
            ops.append({"op": "add", "path": f"{path}/-",
                        "value": copy.deepcopy(new[i])})
        return ops
    if old != new:
        return [{"op": "replace", "path": path, "value": copy.deepcopy(new)}]
    return []


class PatchTestFailed(ValueError):
    """An RFC 6902 `test` op did not match — the apiserver surfaces this as
    an Invalid (422) response."""


def _resolve(doc: Any, tokens: list[str]) -> Any:
    cur = doc
    for t in tokens:
        cur = cur[int(t)] if isinstance(cur, list) else cur[t]
    return cur


def apply_patch(doc: Any, ops: list[dict]) -> Any:
    doc = copy.deepcopy(doc)
    for op in ops:
        tokens = [_unescape(t) for t in op["path"].split("/")[1:]]
        doc = _apply_one(doc, op, tokens)
    return doc


def _apply_one(doc: Any, op: dict, tokens: list[str]) -> Any:
    kind = op["op"]
    if kind == "test":
        try:
            actual = _resolve(doc, tokens)
        except (KeyError, IndexError, TypeError):
            raise PatchTestFailed(f"test path {op['path']!r} missing") from None
        if actual != op.get("value"):
            raise PatchTestFailed(
                f"test failed at {op['path']!r}: {actual!r} != "
                f"{op.get('value')!r}")
        return doc
    if kind in ("move", "copy"):
        src = [_unescape(t) for t in op["from"].split("/")[1:]]
        value = copy.deepcopy(_resolve(doc, src))
        if kind == "move":
            doc = _apply_one(doc, {"op": "remove", "path": op["from"]}, src)
        return _apply_one(doc, {"op": "add", "path": op["path"],
                                "value": value}, tokens)
    if not tokens:  # whole-document op
        if kind in ("add", "replace"):
            return copy.deepcopy(op["value"])
        raise ValueError(f"cannot {kind} whole document")
    parent = _resolve(doc, tokens[:-1])
    last = tokens[-1]
    if isinstance(parent, list):
        if kind == "add":
            idx = len(parent) if last == "-" else int(last)
            parent.insert(idx, copy.deepcopy(op["value"]))
        elif kind == "remove":
            del parent[int(last)]
        elif kind == "replace":
            parent[int(last)] = copy.deepcopy(op["value"])
        else:
            raise ValueError(f"unsupported op {kind}")
    else:
        if kind in ("add", "replace"):
            parent[last] = copy.deepcopy(op["value"])
        elif kind == "remove":
            parent.pop(last, None)
        else:
            raise ValueError(f"unsupported op {kind}")
    return doc


__all__ = ["diff", "apply_patch", "PatchTestFailed"]
