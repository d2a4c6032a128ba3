"""The PyTorch port stands alone: neither its package nor chip_smoke.py
imports JAX, flax, optax, the reference package or the reference's `ci/`
tools, in the source or at
run time.  Its subpackages export the reference's names lazily: every
name resolves, and importing a subpackage imports none of its
modules."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "kubeflow_tpu", "ci"}
# modules the two tests must reach, among all the others they walk: the
# serving entry points, the small models, the compile-check entry, the
# GPU side of the controller contract, the controller itself, its
# observability plane, its real-cluster backend, the sharded fleet, the
# deploy manifests, the schema hook, the diagnose bundle, the
# interleave checker, the canonical end-to-end script, the compute
# tools, the fleet load drivers and the chaos soaks
EXPECTED = {"bench", "entry", "examples.llama13b_decode",
            "examples.serve_model", "examples.speculative_demo",
            "examples.train_llm", "models.generate", "models.mlp",
            "models.vit", "ops.launch_counts", "gpu.topology", "gpu.env",
            "api.types", "core.constants", "core.workload", "odh.network",
            "main", "kube.cluster", "kube.controller",
            "core.notebook_controller", "core.culling_controller",
            "core.selfheal", "core.sessionstate", "gpu.device_plugin",
            "core.scheduler", "core.preemption", "odh.controller",
            "odh.webhook", "odh.tls_profile", "core.telemetry",
            "utils.tsdb", "utils.logging", "utils.slo", "utils.lifecycle",
            "utils.metering", "utils.diagnosis", "utils.profiler",
            "kube.jsonpatch", "kube.strategicmerge", "kube.apply",
            "kube.faults", "kube.resources", "kube.wire", "kube.client",
            "kube.certs", "kube.leader", "kube.fixtures",
            "odh.webhook_server", "examples.run_real_cluster", "kube.shard",
            "deploy.manifests", "api.validation", "ops.diagnose",
            "testing.interleave", "examples.run_stack",
            "tools.decode_profile", "tools.kv_cache_probe",
            "tools.decode_ablate", "tools.llama7b_decode", "tools.mfu_sweep",
            "tools.longctx_sweep", "loadtest.convergence",
            "loadtest.start_notebooks", "conformance.goldens",
            "conformance.behavior", "conformance.metrics",
            "conformance.manager", "conformance.__main__",
            "chaos.knowledge", "chaos.soaks", "chaos.__main__"}


def _port_sources() -> list:
    return sorted((ROOT / "kubeflow_tpu_torch").rglob("*.py")) \
        + [ROOT / "bench_controller.py", ROOT / "chip_smoke.py"]


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
    package = ROOT / "kubeflow_tpu_torch"
    names = {".".join(p.relative_to(package).with_suffix("").parts)
             for p in sources if p.is_relative_to(package)}
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


# the control plane: none of these may import torch, directly or through
# another module, so the controller's pod needs no GPU stack
CONTROL_PLANE = ("main", "kube", "common.reconcilehelper",
                 "core.notebook_controller", "core.culling_controller",
                 "core.metrics", "core.selfheal", "core.sessionstate",
                 "core.scheduler", "core.preemption", "gpu.device_plugin",
                 "utils.config", "odh", "odh.auth", "odh.ca_bundle",
                 "odh.constants", "odh.controller", "odh.diff", "odh.dspa",
                 "odh.feast", "odh.gateway", "odh.mlflow", "odh.network",
                 "odh.notebook", "odh.oauth", "odh.rbac", "odh.routing",
                 "odh.runtime_images", "odh.tls_profile", "odh.webhook",
                 "core.telemetry", "utils.tsdb", "utils.logging", "utils.slo",
                 "utils.lifecycle", "utils.metering", "utils.diagnosis",
                 "utils.profiler", "kube.jsonpatch", "kube.strategicmerge",
                 "kube.apply", "kube.faults", "kube.resources", "kube.wire",
                 "kube.client", "kube.certs", "kube.leader", "kube.fixtures",
                 "odh.webhook_server", "examples.run_real_cluster",
                 "kube.shard", "deploy.manifests", "api.validation",
                 "ops.diagnose", "testing.interleave", "examples.run_stack",
                 "loadtest.convergence", "loadtest.start_notebooks",
                 "conformance.goldens", "conformance.behavior",
                 "conformance.metrics", "conformance.manager",
                 "conformance.__main__", "chaos", "chaos.knowledge",
                 "chaos.soaks", "chaos.__main__")
# the fleet load generators, the conformance profile and the chaos soaks:
# no torch, and (as everywhere in the port) nothing of the reference or JAX
DRIVERS = tuple(m for m in CONTROL_PLANE
                if m.split(".")[0] in ("loadtest", "conformance", "chaos"))


def test_control_plane_imports_no_torch():
    code = "".join(f"import kubeflow_tpu_torch.{m}\n" for m in CONTROL_PLANE)
    code += ("import sys\n"
             "print(sorted(n for n in sys.modules "
             "if n.split('.')[0] == 'torch'))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_load_and_conformance_modules_import_neither_torch_nor_the_reference():
    code = "".join(f"import kubeflow_tpu_torch.{m}\n" for m in DRIVERS)
    code += ("import sys\n"
             f"roots = {sorted(FORBIDDEN | {'torch'})!r}\n"
             "print(sorted(n for n in sys.modules "
             "if n.split('.')[0] in roots))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout
    assert len(DRIVERS) == 11


def test_chaos_knowledge_reads_only_the_package(monkeypatch):
    """The knowledge model is read from the port's own package, whatever
    the working directory: no path outside kubeflow_tpu_torch/ is
    opened."""
    import builtins
    import io
    import pathlib

    from kubeflow_tpu_torch.chaos import knowledge

    opened = []
    real_open, real_io_open = builtins.open, io.open

    def spy(real):
        def opener(file, *args, **kwargs):
            opened.append(pathlib.Path(file).resolve())
            return real(file, *args, **kwargs)
        return opener

    monkeypatch.setattr(builtins, "open", spy(real_open))
    monkeypatch.setattr(io, "open", spy(real_io_open))
    monkeypatch.chdir(ROOT / "chaos")
    model = knowledge.load()
    assert model["steady_state"][1]["applies_to"] == "gpu"
    assert opened, "the model was read without opening a file"
    package = ROOT / "kubeflow_tpu_torch"
    assert all(p.is_relative_to(package) for p in opened), opened


# the reference's package exports (kubeflow_tpu/{models,ops,parallel}/
# __init__.py) that the port has, and the presets it adds
EXPORTS = {
    "models": {"GEMMA_7B", "LLAMA2_7B", "LLAMA2_350M", "MLP", "PRESETS",
               "TINY", "Transformer", "TransformerConfig", "VIT_B16",
               "VIT_TINY", "ViT", "ViTConfig", "LLAMA2_13B", "BENCH_CHIP",
               "BENCH_MOE"},
    "ops": {"attention", "flash_attention", "ring_attention",
            "xla_attention"},
    "parallel": {"DEFAULT_RULES", "MESH_AXES", "MeshConfig",
                 "logical_to_spec", "make_mesh", "mesh_for_slice"},
}


def test_package_exports_resolve():
    import importlib
    import types

    for sub, names in EXPORTS.items():
        pkg = importlib.import_module(f"kubeflow_tpu_torch.{sub}")
        assert set(pkg.__all__) == names, sub
        for name in names:
            assert getattr(pkg, name) is not None, (sub, name)
    from kubeflow_tpu_torch.models import MLP, PRESETS, TINY, Transformer, ViT
    from kubeflow_tpu_torch.models.mlp import MLP as MnistMLP
    from kubeflow_tpu_torch.models.transformer import Transformer as Decoder
    from kubeflow_tpu_torch.ops import attention, flash_attention
    from kubeflow_tpu_torch.ops import ring_attention
    from kubeflow_tpu_torch.parallel import make_mesh

    assert Transformer is Decoder and MLP is MnistMLP
    assert PRESETS["tiny"] is TINY and callable(ViT) and callable(make_mesh)
    # three name submodules too: each is the module, and calling it calls
    # its function of that name, the reference's export
    q = torch.randn((1, 8, 2, 16), generator=torch.Generator().manual_seed(0))
    for mod in (attention, flash_attention, ring_attention):
        assert isinstance(mod, types.ModuleType) and callable(mod)
    assert flash_attention.launches is not None
    assert torch.equal(attention(q, q, q, impl="xla"),
                       attention.attention(q, q, q, impl="xla"))
    assert torch.equal(flash_attention(q, q, q),
                       flash_attention.flash_attention(q, q, q))


def test_package_exports_are_lazy():
    """Importing a subpackage imports none of its modules (not
    models.train, the heaviest); the first name asked for imports its
    module only."""
    code = (
        "import sys\n"
        "import kubeflow_tpu_torch.models, kubeflow_tpu_torch.ops\n"
        "import kubeflow_tpu_torch.parallel\n"
        "subs = ('models', 'ops', 'parallel')\n"
        "def loaded():\n"
        "    return sorted(n for n in sys.modules if n.count('.') == 2\n"
        "                  and n.split('.')[1] in subs\n"
        "                  and n.startswith('kubeflow_tpu_torch.'))\n"
        "print(loaded())\n"
        "from kubeflow_tpu_torch.models import TINY\n"
        "print(loaded())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    before, after = proc.stdout.strip().splitlines()
    assert before == "[]", before
    assert after == "['kubeflow_tpu_torch.models.configs']", after
