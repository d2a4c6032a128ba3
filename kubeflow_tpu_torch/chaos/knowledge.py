"""The chaos knowledge model of the GPU workbench stack.

`knowledge/workbenches.yaml` in this package: what the controllers manage,
which webhooks sit in the write path, the steady state a chaos run must
restore and the declared fault drills.  It is read from the package's own
directory, never from the working directory or the reference's tree."""

from __future__ import annotations

from pathlib import Path

import yaml

PATH = Path(__file__).resolve().parent / "knowledge" / "workbenches.yaml"


def load() -> dict:
    """The parsed model."""
    return yaml.safe_load(PATH.read_text())


__all__ = ["PATH", "load"]
