"""The port's end-to-end stack script against the reference's.

examples/run_stack.py (run unedited, through runpy) drives the
reference's whole control plane: a `spec.tpu` v5e 4x4 slice of 4 hosts
with auth, Healthy, stopped, resumed and deleted.  Its twin,
`kubeflow_tpu_torch/examples/run_stack.py`, does the same with a
`spec.gpu` gang of 4 hosts x 8 H100s.  Both wait in wall time on their
threaded managers (a few seconds each).

The two scripts' step lines (`== ...`, `  ok: ...` and `ALL OK`) must be
equal once the reference's "v5e-4x4 notebook" reads "h100-80gb 4x8 gang"
and its "slice" reads "gang"; the HTTPRoute lines equal; and the worker
env equal once the reference's TPU keys are mapped to the port's
torchrun (PET_*) and GPU_* counterparts: the same hosts, host count and
coordinator host, the device's own accelerator, count per host and
rendezvous port."""

from __future__ import annotations

import ast
import contextlib
import io
import runpy
from pathlib import Path

from kubeflow_tpu_torch.examples import run_stack
from kubeflow_tpu_torch.gpu import env as gpuenv

REFERENCE = Path(__file__).resolve().parent.parent / "examples" / \
    "run_stack.py"

# the reference's device words, read as the port's
WORDS = (("v5e-4x4 notebook", "h100-80gb 4x8 gang"), ("slice", "gang"))

# the reference's worker-env key -> the port's
KEYS = {
    "NB_PREFIX": "NB_PREFIX",
    "TPU_WORKER_HOSTNAMES": "GPU_WORKER_HOSTNAMES",
    "TPU_ACCELERATOR_TYPE": "GPU_ACCELERATOR_TYPE",
    "TPU_HOSTS_PER_SLICE": "PET_NNODES",
    "TPU_CHIPS_PER_HOST_BOUNDS": "PET_NPROC_PER_NODE",
    "JAX_COORDINATOR_ADDRESS": "PET_MASTER_ADDR",
    "COORDINATOR_ADDRESS": "PET_MASTER_ADDR",
}
# no counterpart: a GPU gang has no chip topology, and torchrun takes
# the rendezvous port apart from its host
UNMAPPED_REF, UNMAPPED_PORT = {"TPU_TOPOLOGY"}, {"PET_MASTER_PORT"}


def _stdout(fn) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def _steps(lines: list) -> list:
    return [line for line in lines
            if line.startswith(("==", "  ok:", "ALL OK"))]


def _line(lines: list, prefix: str) -> str:
    (line,) = [x for x in lines if x.startswith(prefix)]
    return line[len(prefix):]


def test_run_stack_matches_the_reference():
    ref = _stdout(lambda: runpy.run_path(str(REFERENCE),
                                         run_name="__main__"))
    ours = _stdout(run_stack.main)

    mapped = []
    for line in _steps(ref):
        for word, port_word in WORDS:
            line = line.replace(word, port_word)
        mapped.append(line)
    assert _steps(ours) == mapped
    assert ours[-1] == ref[-1] == "ALL OK"
    assert _line(ours, "  route: ") == _line(ref, "  route: ")

    ref_env = ast.literal_eval(_line(ref, "  worker env: "))
    env = ast.literal_eval(_line(ours, "  worker env: "))
    assert set(env) == {KEYS[k] for k in ref_env
                        if k not in UNMAPPED_REF} | UNMAPPED_PORT
    assert set(ref_env) == set(KEYS) | UNMAPPED_REF
    for key in ("NB_PREFIX", "TPU_WORKER_HOSTNAMES", "TPU_HOSTS_PER_SLICE"):
        assert env[KEYS[key]] == ref_env[key], key
    for key in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS"):
        assert env[KEYS[key]] == ref_env[key].rsplit(":", 1)[0], key
    assert ref_env["TPU_HOSTS_PER_SLICE"] == str(run_stack.HOSTS)
    assert env["GPU_ACCELERATOR_TYPE"] == "h100-80gb"
    assert env["PET_NPROC_PER_NODE"] == str(run_stack.GPUS_PER_HOST)
    assert env["PET_MASTER_PORT"] == str(gpuenv.TORCH_RENDEZVOUS_PORT)
