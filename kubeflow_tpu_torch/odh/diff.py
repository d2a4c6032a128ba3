"""First-difference reporting for the restart-blocking webhook path.

The port's copy of kubeflow_tpu/odh/diff.py, the port of
FirstDifferenceReporter + getStructDiff
(notebook_mutating_webhook.go:601-646): compare two nested structures and
render only the FIRST difference as a one-line human-readable string — enough
for the `update-pending` annotation without dumping the whole diff.
"""

from __future__ import annotations

from typing import Any, Optional


def _fmt(value: Any) -> str:
    if value is _MISSING:
        return "<absent>"
    return repr(value)


class _Missing:
    def __repr__(self) -> str:  # pragma: no cover
        return "<absent>"


_MISSING = _Missing()


def _walk(a: Any, b: Any, path: str) -> Optional[str]:
    if a is _MISSING or b is _MISSING or type(a) is not type(b):
        if a == b:
            return None
        return f"{path or '.'}: {_fmt(a)} != {_fmt(b)}"
    if isinstance(a, dict):
        for key in sorted(set(a) | set(b), key=str):
            found = _walk(
                a.get(key, _MISSING), b.get(key, _MISSING), f"{path}.{key}"
            )
            if found:
                return found
        return None
    if isinstance(a, list):
        for i in range(max(len(a), len(b))):
            found = _walk(
                a[i] if i < len(a) else _MISSING,
                b[i] if i < len(b) else _MISSING,
                f"{path}[{i}]",
            )
            if found:
                return found
        return None
    if a != b:
        return f"{path or '.'}: {_fmt(a)} != {_fmt(b)}"
    return None


def first_difference(a: Any, b: Any) -> str:
    """One-line description of the first difference, or the reference's
    fallback string when the walk fails (getStructDiff :632-646)."""
    try:
        found = _walk(a, b, "")
        return found or ""
    except Exception:
        return "failed to compute the reason for why there is a pending restart"
