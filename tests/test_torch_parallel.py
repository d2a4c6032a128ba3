"""The port's sharded training on several gloo CPU processes.

Pure Python first: the mesh config, the logical rule table and the
worker-env parser, each mirroring the reference's tests with its expected
values written out.  Then one module-scoped spawn of 4 gloo processes
(one thread each) runs a battery whose cases are the parametrised tests
below: ring attention forward and backward against `xla_attention`, the
expert-parallel MoE layer against one process (outputs and every
gradient), one SGD(0.05) step on eight meshes against one process with
the dry run's gates, and three AdamW steps on fsdp 2 x tensor 2.  The
references are computed in this process and handed to the ranks; the
ranks import this module and the port, nothing else."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch import dryrun
from kubeflow_tpu_torch.models import train
from kubeflow_tpu_torch.models.configs import TINY
from kubeflow_tpu_torch.parallel.mesh import (
    MESH_AXES,
    MeshConfig,
    check_slices,
    make_mesh,
)
from kubeflow_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    logical_to_spec,
    rules_for_mesh,
)
from kubeflow_tpu_torch.runtime.init import (
    distributed_init,
    parse_worker_env,
)

WORLD = 4
SEQ = 256
RING_TOL = MOE_TOL = 1e-5


# -- pure Python --------------------------------------------------------------


def test_mesh_config_resolves_data_axis():
    cfg = MeshConfig(data=-1, fsdp=2, sequence=1, tensor=2).resolved(8)
    assert dict(zip(MESH_AXES, cfg.shape)) == {
        "data": 2, "fsdp": 2, "sequence": 1, "tensor": 2, "pipeline": 1,
        "expert": 1}


@pytest.mark.parametrize("cfg,devices,message", [
    (MeshConfig(data=3, fsdp=3), 8, "mesh 3x3x1x1x1x1 != 8 devices"),
    (MeshConfig(fsdp=3), 8, "8 devices not divisible by "
                            "fsdp*sequence*tensor*pipeline*expert=3"),
])
def test_mesh_config_rejects_bad_factorization(cfg, devices, message):
    with pytest.raises(ValueError, match=message.replace("*", r"\*")):
        cfg.resolved(devices)


def test_slices_must_divide_the_data_axis():
    ok = check_slices(MeshConfig(data=4, fsdp=2, num_slices=2).resolved(8))
    assert ok.shape == (4, 2, 1, 1, 1, 1)
    with pytest.raises(ValueError, match="data=2 not divisible by "
                                         "num_slices=3"):
        check_slices(MeshConfig(tensor=2, num_slices=3).resolved(4))


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="default process group"):
        make_mesh(MeshConfig(), device="cpu")


def test_logical_rules():
    # "embed" maps to fsdp, but batch already claimed it -> None
    assert logical_to_spec(("batch", "seq", "embed")) == (
        ("data", "fsdp"), "sequence", None)
    # parameter case: no batch dim, embed keeps fsdp
    assert logical_to_spec(("embed", "mlp")) == ("fsdp", "tensor")
    assert logical_to_spec(("vocab", "embed")) == ("tensor", "fsdp")
    assert logical_to_spec(("heads", "kv", "embed")) == (
        "tensor", None, "fsdp")


def test_rules_for_mesh_populates_pipeline_and_expert():
    plain = rules_for_mesh(MeshConfig(tensor=2).resolved(4))
    assert dict(plain)["layers"] is None and dict(plain)["expert"] is None
    assert [r for r in plain if r[0] not in ("layers", "expert")] == [
        r for r in DEFAULT_RULES if r[0] != "layers"]
    moe = rules_for_mesh(MeshConfig(tensor=2, expert=2).resolved(4))
    assert dict(moe)["expert"] == "expert"
    assert logical_to_spec(("expert", "embed", "mlp"), moe) == (
        "expert", "fsdp", "tensor")
    staged = rules_for_mesh(MeshConfig(pipeline=2).resolved(4))
    assert staged[0] == ("layers", "pipeline")


def test_norm_scales_shard_over_fsdp_on_dim_0():
    rules = rules_for_mesh(MeshConfig(fsdp=2).resolved(2))
    assert train.param_spec(("norm",), rules) == ("fsdp",)
    assert train.param_spec(("embed", None), rules) == ("fsdp", None)


def test_worker_env_roundtrip():
    """The env the controller renders for worker 2 of slice 1 of a
    2-slice, 4-host-per-slice gang parses into rank 6 of 8, with the
    coordinator on slice 0's worker 0 (the reference's
    tests/test_runtime.py case, its env written out)."""
    hosts = [f"nb-slice-{s}-{w}.nb-workers" for s in range(2)
             for w in range(4)]
    env = {"TPU_WORKER_HOSTNAMES": ",".join(hosts),
           "TPU_HOSTS_PER_SLICE": "4", "TPU_WORKER_ID": "2",
           "MEGASCALE_SLICE_ID": "1", "MEGASCALE_NUM_SLICES": "2",
           "JAX_COORDINATOR_ADDRESS": "nb-slice-0-0.nb-workers:8471"}
    identity = parse_worker_env(env)
    assert identity.hosts_per_slice == 4
    assert identity.num_slices == 2
    assert identity.slice_id == 1
    assert identity.process_id == 1 * 4 + 2
    assert identity.num_processes == 8
    assert identity.coordinator_address == "nb-slice-0-0.nb-workers:8471"
    assert identity.hostnames[6].startswith("nb-slice-1-2.")


def test_single_host_is_noop():
    identity = distributed_init({"TPU_WORKER_HOSTNAMES": "only-one"},
                                device="cpu")
    assert not identity.is_multihost
    assert not torch.distributed.is_initialized()


def test_pipeline_degree_is_refused():
    with pytest.raises(NotImplementedError, match="pipeline"):
        train.setup_training(TINY, MeshConfig(pipeline=2).resolved(2),
                             device="cpu")


# -- the battery on 4 gloo processes -----------------------------------------


RING_CASES = {"ring_sp4": MeshConfig(sequence=4),
              "ring_sp2_tp2": MeshConfig(sequence=2, tensor=2)}
MOE_LAYER_CASES = {f"moe_{d}_{name}": (d, m) for d in ("einsum", "hybrid",
                                                       "sort")
                   for name, m in (("ep2_data2", MeshConfig(expert=2)),
                                   ("ep2_tp2", MeshConfig(tensor=2,
                                                          expert=2)),
                                   ("ep2_sp2", MeshConfig(sequence=2,
                                                          expert=2)))}
STEP_CASES = {
    "fsdp4": (False, MeshConfig(fsdp=4)),
    "fsdp2_tp2": (False, MeshConfig(fsdp=2, tensor=2)),
    "sp2_tp2": (False, MeshConfig(sequence=2, tensor=2)),
    "fsdp2_sp2": (False, MeshConfig(fsdp=2, sequence=2)),
    "slices2_data2_tp2": (False, MeshConfig(tensor=2, num_slices=2)),
    "moe_ep2_tp2": (True, MeshConfig(tensor=2, expert=2)),
    "moe_ep2_sp2": (True, MeshConfig(sequence=2, expert=2)),
    "moe_ep2_data2": (True, MeshConfig(expert=2)),
}
ADAMW_MESH = MeshConfig(fsdp=2, tensor=2)


def _ring_case(mesh_config: MeshConfig) -> float:
    """Largest error of the ring's output and of dq, dk, dv against
    xla_attention on the full tensors (GQA 4/2 heads, fp32)."""
    from kubeflow_tpu_torch.ops.attention import attention, xla_attention
    from kubeflow_tpu_torch.parallel.mesh import axis_group
    from kubeflow_tpu_torch.parallel.sharding import local_shard

    mesh = make_mesh(mesh_config, device="cpu")
    rs = np.random.RandomState(3)
    b, s, h, kvh, d = 2, 32, 4, 2, 16
    full = [torch.tensor(rs.standard_normal(shape).astype(np.float32),
                         requires_grad=True)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d))]
    dout = torch.tensor(rs.standard_normal((b, s, h, d)).astype(np.float32))
    ref = xla_attention(*full, causal=True)
    ref.backward(dout)
    spec = (None, "sequence", "tensor", None)
    local = [local_shard(t.detach(), spec, mesh).clone().requires_grad_()
             for t in full]
    positions = local_shard(torch.arange(s).expand(b, s), (None, "sequence"),
                            mesh).contiguous()
    out = attention(*local, causal=True, impl="ring", positions=positions,
                    group=axis_group(mesh, "sequence"))
    out.backward(local_shard(dout, spec, mesh).contiguous())
    errs = [(out - local_shard(ref.detach(), spec, mesh)).abs().max()]
    errs += [(t.grad - local_shard(f.grad, spec, mesh)).abs().max()
             for t, f in zip(local, full)]
    return float(torch.stack(errs).max())


def _moe_layer_case(dispatch: str, mesh_config: MeshConfig) -> float:
    """Largest error of the expert-parallel MoE layer's output, aux loss,
    input gradient and every parameter gradient against one process.
    Each rank takes its rows (over data) and sequence block of the batch;
    its loss is its share of sum(out * dout) + 3 aux, and the parameter
    gradients are summed over the ranks that hold other tokens."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.models.moe import MoEMLP
    from kubeflow_tpu_torch.models.transformer import init_params
    from kubeflow_tpu_torch.parallel.mesh import axis_group
    from kubeflow_tpu_torch.parallel.sharding import local_shard

    cfg = TINY.with_(moe_experts=4, moe_top_k=2, moe_capacity_factor=1.0,
                     moe_dispatch=dispatch)
    mesh = make_mesh(mesh_config, device="cpu")
    token_groups = [g for g in (axis_group(mesh, a) for a in
                                ("data", "fsdp", "sequence")) if g]
    shares = 1
    for g in token_groups:
        shares *= dist.get_world_size(g)
    rs = np.random.RandomState(5)
    x = torch.tensor(rs.standard_normal((4, 16, cfg.embed_dim)
                                        ).astype(np.float32))
    dout = torch.tensor(rs.standard_normal(x.shape).astype(np.float32))
    rows = (("data", "fsdp"), "sequence", None)
    layers = []
    for layer_mesh in (None, mesh):
        layer = MoEMLP(cfg, "cpu", layer_mesh)
        init_params(layer, torch.Generator().manual_seed(0))
        layers.append(layer)
    specs = train.shard_parameters(layers[1], mesh)
    results = []
    for layer, xin, d, n in (
            (layers[0], x, dout, 1),
            (layers[1], local_shard(x, rows, mesh), local_shard(dout, rows,
                                                                mesh),
             shares)):
        xin = xin.clone().requires_grad_()
        out, aux = layer(xin)
        ((out * d).sum() + 3.0 * aux / n).backward()
        grads = {name: p.grad for name, p in layer.named_parameters()}
        if layer is layers[1]:
            for g in grads.values():
                for group in token_groups:
                    dist.all_reduce(g, group=group)
        results.append((out.detach(), aux.detach(), xin.grad, grads))
    (o1, a1, g1, p1), (o2, a2, g2, p2) = results
    errs = [(local_shard(o1, rows, mesh) - o2).abs().max(), (a1 - a2).abs(),
            (local_shard(g1, rows, mesh) - g2).abs().max()]
    errs += [(local_shard(p1[n], spec, mesh, ("tensor", "expert"))
              - p2[n]).abs().max() for n, spec in specs.items()]
    return float(torch.stack(errs).max())


def _adamw_case() -> dict:
    """Three AdamW steps at fsdp 2 x tensor 2 on the proxy: the losses,
    and whether every moment has its parameter's local shape."""
    cfg = dryrun.proxy_config(SEQ)
    mesh = make_mesh(ADAMW_MESH, device="cpu")
    opt = train.AdamW(lambda count: 1e-2, weight_decay=0.0)
    setup = train.setup_training(cfg, mesh, device="cpu", optimizer=opt)
    batch = dryrun.make_batch(cfg.vocab_size, 8, SEQ)
    losses = []
    for _ in range(3):
        _, metrics = setup.train_step(setup.state, batch)
        losses.append(float(metrics["loss"]))
    local = [train.local_tensor(p) for p in setup.model.parameters()]
    return {"losses": losses,
            "shapes_match": all(m.shape == p.shape and v.shape == p.shape
                                for m, v, p in zip(opt.mu, opt.nu, local)),
            "moment_elems": sum(m.numel() for m in opt.mu),
            "full_elems": cfg.num_params}


def _battery(references: dict) -> dict:
    """Rank worker: every case, each result alike on all ranks."""
    import torch.distributed as dist

    out = {}
    for name, m in RING_CASES.items():
        out[name] = _ring_case(m)
    for name, (dispatch, m) in MOE_LAYER_CASES.items():
        out[name] = _moe_layer_case(dispatch, m)
    for name, (moe, m) in STEP_CASES.items():
        cfg = dryrun.proxy_config(SEQ, moe)
        out[name] = dryrun.sharded_step(cfg, m, references["batch"],
                                        references["moe" if moe else "dense"])
    out["adamw"] = _adamw_case()
    # the float cases' worst over the ranks
    keys = [k for k, v in out.items() if isinstance(v, float)]
    worst = torch.tensor([out[k] for k in keys])
    dist.all_reduce(worst, dist.ReduceOp.MAX)
    out.update(zip(keys, worst.tolist()))
    return out


@pytest.fixture(scope="module")
def battery() -> dict:
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        batch = dryrun.make_batch(512, 8, SEQ)
        references = {"batch": batch}
        for label, moe in (("dense", False), ("moe", True)):
            references[label] = dryrun.reference_step(
                dryrun.proxy_config(SEQ, moe), batch)
    finally:
        torch.set_num_threads(threads)
    return dryrun.launch(WORLD, _battery, (references,), timeout=600)


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_attention_matches_xla_attention(battery, case):
    assert battery[case] <= RING_TOL


@pytest.mark.parametrize("case", sorted(MOE_LAYER_CASES))
def test_expert_parallel_moe_layer_matches_one_process(battery, case):
    assert battery[case] <= MOE_TOL


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_sgd_step_matches_one_process(battery, case):
    result = battery[case]
    want = STEP_CASES[case][1].resolved(WORLD)
    assert result["mesh"] == dict(zip(MESH_AXES, want.shape))
    assert dryrun.failures(result) == [], result


def test_adamw_steps_lower_the_loss_on_sharded_moments(battery):
    result = battery["adamw"]
    losses = result["losses"]
    assert losses[2] < losses[1] < losses[0], losses
    assert result["shapes_match"]
    # fsdp 2 x tensor 2 splits every parameter but the norm scales 4
    # ways, and those 2 ways
    assert result["moment_elems"] < result["full_elems"] / 3


@pytest.mark.slow
def test_dryrun_passes_its_four_meshes_on_eight_processes():
    """`python -m kubeflow_tpu_torch.dryrun 8`: 8 gloo processes, seq 1024,
    the dense fsdp x sequence x tensor and two-slice meshes and the MoE
    expert x tensor x data and expert x sequence x tensor meshes."""
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run([sys.executable, "-m", "kubeflow_tpu_torch.dryrun",
                           "8"], cwd=Path(__file__).resolve().parent.parent,
                          capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ok = [line for line in proc.stdout.splitlines()
          if line.startswith("dryrun_multichip ok")]
    assert len(ok) == 4, proc.stdout
