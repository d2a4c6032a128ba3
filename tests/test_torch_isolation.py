"""The PyTorch port stands alone: neither its package nor chip_smoke.py
imports JAX, flax, optax or the reference package, in the source or at
run time."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "kubeflow_tpu"}
# modules the two tests must reach, among all the others they walk: the
# serving entry points, the small models and the compile-check entry
EXPECTED = {"bench", "entry", "examples.llama13b_decode",
            "examples.serve_model", "examples.speculative_demo",
            "examples.train_llm", "models.generate", "models.mlp",
            "models.vit", "ops.launch_counts"}


def _port_sources() -> list:
    return sorted((ROOT / "kubeflow_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_import_no_reference():
    sources = _port_sources()
    assert len(sources) > 10
    names = {".".join(p.relative_to(ROOT / "kubeflow_tpu_torch")
                      .with_suffix("").parts) for p in sources[:-1]}
    assert EXPECTED <= names, sorted(EXPECTED - names)
    for path in sources:
        bad = _imported_roots(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_every_port_module_loads_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import kubeflow_tpu_torch as pkg\n"
        "walked = []\n"
        "for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "    walked.append(info.name[len(pkg.__name__) + 1:])\n"
        f"roots = {sorted(FORBIDDEN)!r}\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in roots))\n"
        "print(' '.join(walked))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded, walked = proc.stdout.strip().splitlines()
    assert loaded == "[]", proc.stdout
    assert EXPECTED <= set(walked.split()), sorted(EXPECTED
                                                   - set(walked.split()))
