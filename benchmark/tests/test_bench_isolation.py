"""A benchmark run loads neither JAX nor the JAX package, and the
reference loads nothing of the port: shown by a CPU rehearsal of the
harness in a fresh process, its modules' top-level names compared
whole, and by the reference's sources."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "kubeflow_tpu"}

REHEARSAL = """
import json, sys
from benchmark import run
from benchmark.tests import tiny
run.main(["--workload", "mistral-7b.train-4k", "--seed", "2147483649",
          "--seconds", "0.5", "--trace", "1"], device="cpu",
          shape=tiny.shape("mistral-7b-pp2"), mix=tiny.TRAIN_MIX)
run.main(["--workload", "mistral-7b.int4-chat", "--seed", "2147483650",
          "--seconds", "0.5", "--trace", "0"], device="cpu",
          shape=tiny.shape("mistral-7b"), mix=tiny.CHAT_MIX)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_rehearsed_run_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", REHEARSAL], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[")]
    roots = set(json.loads(lines[-1]))
    assert "kubeflow_tpu_torch" in roots      # the port did run
    assert not roots & FORBIDDEN, roots & FORBIDDEN


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((ROOT / "benchmark" / "reference").glob("*.py"))
    files += [ROOT / "benchmark" / n for n in ("shapes.py", "weights.py")]
    assert files
    for path in files:
        names = _imports(path)
        assert not names & (FORBIDDEN | {"kubeflow_tpu_torch"}), path
        # relative imports stay inside the benchmark's plain modules
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.module not in ("runners", "run", "calibrate"), \
                    path


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    monkeypatch.setitem(sys.modules, "kubeflow_tpu_torch_like", object())
    assert not {"jaxtyping_like", "kubeflow_tpu_torch_like"} & set(
        run.loaded_forbidden())
    monkeypatch.setitem(sys.modules, "flax.core", object())
    assert "flax" in run.loaded_forbidden()
