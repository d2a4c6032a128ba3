"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each `csrc/*.cu` file has a plain C interface and becomes one shared
library in `build/kernels/`, named after its source and a digest of the
source, the headers it may include (`csrc/*.cuh`) and the flags, so an
edited source or header builds anew and an unchanged one is reused.  A
failed build raises; nothing falls back.  `build_all` compiles several
sources at once, one nvcc process each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def build(source: Path) -> tuple[Path, str]:
    """Compile `source` into build/kernels/ unless a library of the same
    source is there; returns (library path, compiler output)."""
    text = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    lib = BUILD_DIR / f"{source.stem}-{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    return lib, proc.stdout + proc.stderr


def build_all(sources) -> list[tuple[Path, str]]:
    """Build every source at once, one nvcc each; results in order."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return list(pool.map(build, sources))


@functools.cache
def load(source: Path) -> ctypes.CDLL:
    """The library of `source`, built at first use."""
    path, _ = build(source)
    return ctypes.CDLL(str(path))


__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build", "build_all", "load"]
