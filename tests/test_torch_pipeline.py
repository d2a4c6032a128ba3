"""The port's pipeline engine (kubeflow_tpu_torch/parallel/pipeline.py)
and pipelined train step against the reference's, on the CPU.

In this process: one stage falling back to the plain loop, against the
reference's `gpipe` on the forced 8-device CPU mesh, and the engines'
ValueErrors.  Then one module-scoped spawn of 4 gloo processes (one
thread each) runs every multi-rank case, whose results the parametrised
tests below read:

- the toy tanh stack of tests/test_pipeline.py at pipeline 4 (8 layers,
  two a stage, 4 microbatches): the port's `gpipe` output and gradients
  against the reference's `gpipe` on data 2 x pipeline 4, and its
  `pipeline_1f1b` (loss, layer and input gradients) against the
  reference's `pipeline_1f1b`, its head gradient against the reference
  GPipe's;
- the stash: at pipeline 4 and 16 microbatches each stage's most held
  microbatch graphs, M under GPipe and at most S under 1F1B;
- one SGD(0.05) step of TINY (fp32, batch 8 x 64, 4 microbatches) from
  the reference's initial weights converted by the port's converter,
  held to the reference's pipelined `setup_training` step on the same
  mesh with the same schedule: loss within 1e-4, grad norm within 1e-4
  relative and every parameter within rtol = atol = 1e-4, after an
  update that moved.  Cases: pipeline 2 under GPipe and under 1F1B
  (data 2), 1F1B MoE (4 experts, top-2, capacity 2.0), pipeline 2 x
  tensor 2 under 1F1B, and 1F1B with tied embeddings.
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import configs as jconfigs
from kubeflow_tpu.models import train as jtrain
from kubeflow_tpu.parallel import pipeline as jpipeline
from kubeflow_tpu.parallel.mesh import MeshConfig as JMeshConfig
from kubeflow_tpu.parallel.mesh import make_mesh as jmake_mesh
from kubeflow_tpu_torch import dryrun
from kubeflow_tpu_torch.models import configs, train
from kubeflow_tpu_torch.models.convert import state_dict_from_flax
from kubeflow_tpu_torch.parallel import pipeline
from kubeflow_tpu_torch.parallel.mesh import MeshConfig

WORLD = 4
LOSS_TOL = PARAM_TOL = 1e-4
TOY_LAYERS, TOY_DIM, TOY_BATCH, TOY_MICRO = 8, 16, 8, 4
STASH_MICRO = 16
BATCH, SEQ, MICRO = 8, 64, 4
MOE = {"moe_experts": 4, "moe_top_k": 2, "moe_capacity_factor": 2.0}

# name: (config overrides, pipeline, tensor, schedule)
STEP_CASES = {
    "pp2_gpipe": ({}, 2, 1, "gpipe"),
    "pp2_1f1b": ({}, 2, 1, "1f1b"),
    "pp2_1f1b_moe": (MOE, 2, 1, "1f1b"),
    "pp2_tp2_1f1b": ({}, 2, 2, "1f1b"),
    "pp2_1f1b_tied": ({"tie_embeddings": True}, 2, 1, "1f1b"),
}


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(nn.unbox(tree)))


def _toy_inputs():
    rs = np.random.RandomState(0)
    weights = (rs.standard_normal((TOY_LAYERS, TOY_DIM, TOY_DIM))
               * 0.3).astype(np.float32)
    x = rs.standard_normal((TOY_BATCH, TOY_DIM)).astype(np.float32)
    targets = rs.standard_normal((TOY_BATCH, TOY_DIM)).astype(np.float32)
    head = (rs.standard_normal((TOY_DIM, TOY_DIM)) * 0.3).astype(np.float32)
    return weights, x, targets, head


def _tanh_layer(w, x):
    return jnp.tanh(x @ w)


def _torch_stage(weights):
    def stage(x):
        for w in weights:
            x = torch.tanh(x @ w)
        return x
    return stage


# -- in this process ----------------------------------------------------------


def test_single_stage_falls_back_to_the_plain_loop():
    """One stage: the whole batch through the stage at once, output and
    gradients of sum(out^2) as the reference's single-stage gpipe."""
    weights, x, _, _ = _toy_inputs()
    weights, x = weights[:4, :8, :8], x[:4, :8]
    mesh = jmake_mesh(JMeshConfig(data=8))
    want = jpipeline.gpipe(_tanh_layer, jnp.asarray(weights),
                           jnp.asarray(x), mesh, 2)
    want_grad = jax.grad(lambda p: jnp.sum(jpipeline.gpipe(
        _tanh_layer, p, jnp.asarray(x), mesh, 2) ** 2))(jnp.asarray(weights))
    local = [torch.tensor(w, requires_grad=True) for w in weights]
    run = pipeline.gpipe(_torch_stage(local), torch.tensor(x),
                         MeshConfig(data=8).resolved(8), 2)
    np.testing.assert_allclose(run.out.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    dx = run.backward((run.out ** 2).sum())
    assert dx.shape == x.shape
    got = np.stack([w.grad.numpy() for w in local])
    np.testing.assert_allclose(got, np.asarray(want_grad), atol=1e-5)
    assert pipeline.stash["peak"] == 1


def test_engines_reject_what_the_reference_rejects():
    staged = MeshConfig(pipeline=4).resolved(4)
    with pytest.raises(ValueError, match="6 layers not divisible by 4 "
                                         "stages"):
        pipeline.stage_layers(6, 4, 0)
    with pytest.raises(ValueError, match="batch 3 not divisible by 2 "
                                         "microbatches"):
        pipeline.gpipe(lambda x: x, torch.ones(3, 4), staged, 2)
    with pytest.raises(ValueError, match="pipeline axis"):
        pipeline.pipeline_1f1b(lambda x: x, lambda y, t: y.sum(),
                               torch.ones(4, 4), torch.ones(4, 4),
                               MeshConfig(data=8).resolved(8), 2)
    with pytest.raises(ValueError, match="batch 3 not divisible"):
        pipeline.pipeline_1f1b(lambda x: x, lambda y, t: y.sum(),
                               torch.ones(3, 4), torch.ones(3, 4), staged, 2)
    with pytest.raises(ValueError, match="unknown pipeline schedule"):
        train.setup_training(configs.TINY, device="cpu",
                             pipeline_schedule="interleaved")


# -- the battery on 4 gloo processes -----------------------------------------


def _toy_case(weights, x, targets, head) -> dict:
    """The toy stack at pipeline 4 on this rank's stage: gpipe's output
    (last stage) and gradients of sum(out^2); 1F1B's loss and gradients
    of mean((y head - t)^2); the stash peaks at 16 microbatches."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(MeshConfig(pipeline=4), device="cpu")
    stage = mesh.get_local_rank("pipeline")
    ids = pipeline.stage_layers(TOY_LAYERS, 4, stage)

    def fresh():
        return [torch.tensor(weights[i], requires_grad=True) for i in ids]

    local = fresh()
    run = pipeline.gpipe(_torch_stage(local), torch.tensor(x), mesh,
                         TOY_MICRO)
    dx = run.backward((run.out ** 2).sum() if run.out is not None else None)
    mine = {"stage": stage, "ids": list(ids),
            "gpipe_out": None if run.out is None else run.out.detach(),
            "gpipe_grads": [w.grad for w in local], "gpipe_dx": dx}
    local, h = fresh(), torch.tensor(head, requires_grad=True)

    def head_loss(y, t):
        return ((y @ h - t) ** 2).mean()

    loss, _, layer_grads, head_grads, dx = pipeline.pipeline_1f1b(
        _torch_stage(local), head_loss, torch.tensor(x),
        torch.tensor(targets), mesh, TOY_MICRO, stage_params=local,
        head_params=[h])
    mine.update(f1b_loss=float(loss), f1b_grads=layer_grads,
                f1b_head=head_grads[0], f1b_dx=dx)
    big_x = torch.tensor(np.tile(x, (2, 1)))
    big_t = torch.tensor(np.tile(targets, (2, 1)))
    run = pipeline.gpipe(_torch_stage(fresh()), big_x, mesh, STASH_MICRO)
    mine["stash_gpipe"] = pipeline.stash["peak"]
    run.backward(None if run.out is None else run.out.sum())
    h = torch.tensor(head, requires_grad=True)
    pipeline.pipeline_1f1b(_torch_stage(fresh()), head_loss, big_x, big_t,
                           mesh, STASH_MICRO)
    mine["stash_1f1b"] = pipeline.stash["peak"]
    reports = [None] * dist.get_world_size()
    dist.all_gather_object(reports, mine)
    return sorted(reports, key=lambda r: r["stage"])


def _battery(toy: tuple, steps: dict) -> dict:
    """Rank worker: every case, each result alike on all ranks."""
    out = {"toy": _toy_case(*toy)}
    for name, (overrides, pp, tp, schedule) in STEP_CASES.items():
        ref = steps[name]
        out[name] = dryrun.sharded_step(
            configs.TINY.with_(**overrides),
            MeshConfig(pipeline=pp, tensor=tp), ref["batch"], ref["reference"],
            ref["before"], schedule=schedule, micro=MICRO)
    return out


def _reference_step(name: str) -> dict:
    """The reference's pipelined setup_training step of one case on 4 of
    the 8 CPU devices (the port's mesh), SGD(0.05)."""
    overrides, pp, tp, schedule = STEP_CASES[name]
    jcfg = jconfigs.TINY.with_(**overrides)
    rs = np.random.RandomState(3)
    inputs = rs.randint(0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    batch = {"inputs": inputs, "targets": np.roll(inputs, -1, axis=1)}
    mesh = jmake_mesh(JMeshConfig(data=-1, pipeline=pp, tensor=tp),
                      devices=jax.devices()[:WORLD])
    setup = jtrain.setup_training(
        jcfg, mesh, batch_shape=(BATCH, SEQ), optimizer=optax.sgd(0.05),
        pipeline_microbatches=MICRO, pipeline_schedule=schedule)
    before = state_dict_from_flax(_np(setup.state.params))
    state, metrics = setup.train_step(setup.state,
                                      jax.tree.map(jnp.asarray, batch))
    after = state_dict_from_flax(_np(state.params))
    return {"batch": {k: torch.tensor(v).long() for k, v in batch.items()},
            "before": before,
            "reference": {"loss": float(metrics["loss"]), "params": after,
                          "moved": max(float((after[n] - before[n]
                                              ).abs().max())
                                       for n in after)},
            "grad_norm": float(metrics["grad_norm"])}


def _reference_toy(weights, x, targets, head) -> dict:
    mesh = jmake_mesh(JMeshConfig(data=2, pipeline=4))
    stacked = jnp.asarray(weights)

    def run(p):
        return jpipeline.gpipe(_tanh_layer, p, jnp.asarray(x), mesh,
                               TOY_MICRO)

    def head_loss(hp, y, t):
        return jnp.mean((y @ hp - t) ** 2)

    loss, _, dstack, _, dx = jax.jit(
        lambda p, hp: jpipeline.pipeline_1f1b(
            _tanh_layer, p, head_loss, hp, jnp.asarray(x),
            jnp.asarray(targets), mesh, TOY_MICRO))(stacked,
                                                    jnp.asarray(head))
    # the reference's pipeline_1f1b overcounts its head gradient from 3
    # stages on (its vjp already sums the head cotangent over the
    # pipeline, and each stage backing up on the last stage's tick adds
    # it again: up to 0.065 off here; loss, layer gradients and dx are
    # right), so the head gradient is held to its GPipe's
    dhead = jax.jit(jax.grad(lambda hp: head_loss(
        hp, run(stacked), jnp.asarray(targets))))(jnp.asarray(head))
    return {"gpipe_out": np.asarray(jax.jit(run)(stacked)),
            "gpipe_grad": np.asarray(jax.jit(jax.grad(
                lambda p: jnp.sum(run(p) ** 2)))(stacked)),
            "f1b_loss": float(loss), "f1b_grad": np.asarray(dstack),
            "f1b_head": np.asarray(dhead), "f1b_dx": np.asarray(dx)}


@pytest.fixture(scope="module")
def references() -> dict:
    toy = _toy_inputs()
    return {"toy_inputs": toy, "toy": _reference_toy(*toy),
            "steps": {name: _reference_step(name) for name in STEP_CASES}}


@pytest.fixture(scope="module")
def battery(references) -> dict:
    steps = {name: {k: v for k, v in ref.items() if k != "grad_norm"}
             for name, ref in references["steps"].items()}
    return dryrun.launch(WORLD, _battery, (references["toy_inputs"], steps),
                         timeout=600)


def test_gpipe_forward_and_grad_match_reference(battery, references):
    want = references["toy"]
    reports = battery["toy"]
    np.testing.assert_allclose(reports[-1]["gpipe_out"].numpy(),
                               want["gpipe_out"], atol=1e-5)
    assert all(r["gpipe_out"] is None for r in reports[:-1])
    for r in reports:
        got = np.stack([g.numpy() for g in r["gpipe_grads"]])
        np.testing.assert_allclose(got, want["gpipe_grad"][r["ids"]],
                                   atol=1e-4)
    assert reports[0]["gpipe_dx"].shape == (TOY_BATCH, TOY_DIM)
    assert all(r["gpipe_dx"] is None for r in reports[1:])


def test_1f1b_loss_and_grads_match_reference(battery, references):
    want = references["toy"]
    reports = battery["toy"]
    for r in reports:
        np.testing.assert_allclose(r["f1b_loss"], want["f1b_loss"],
                                   rtol=1e-5)
        got = np.stack([g.numpy() for g in r["f1b_grads"]])
        np.testing.assert_allclose(got, want["f1b_grad"][r["ids"]],
                                   atol=1e-5)
    np.testing.assert_allclose(reports[-1]["f1b_head"].numpy(),
                               want["f1b_head"], atol=1e-5)
    assert all(r["f1b_head"] is None for r in reports[:-1])
    np.testing.assert_allclose(reports[0]["f1b_dx"].numpy(), want["f1b_dx"],
                               atol=1e-5)


def test_1f1b_stash_is_capped_at_the_stage_count(battery):
    """pipeline 4, 16 microbatches: GPipe holds all 16 microbatch graphs
    on every stage, 1F1B at most 4 (S - s on stage s)."""
    reports = battery["toy"]
    assert [r["stash_gpipe"] for r in reports] == [STASH_MICRO] * 4
    assert [r["stash_1f1b"] for r in reports] == [4, 3, 2, 1]


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_pipelined_step_matches_reference(battery, references, case):
    result = battery[case]
    want = references["steps"][case]
    overrides, pp, tp, schedule = STEP_CASES[case]
    assert result["mesh"]["pipeline"] == pp
    assert result["mesh"]["tensor"] == tp
    assert result["mesh"]["data"] == WORLD // (pp * tp)
    assert result["schedule"] == schedule
    # the dry run's gates but its plausible-loss band: TINY's tied N(0, 1)
    # embedding starts at a cross-entropy of 43.6
    assert result["moved"] > 0.0
    assert result["mismatches"] == [], result
    assert abs(result["loss"] - result["ref_loss"]) < LOSS_TOL, result
    np.testing.assert_allclose(result["grad_norm"], want["grad_norm"],
                               rtol=LOSS_TOL)
    assert result["max_param_err"] <= PARAM_TOL
