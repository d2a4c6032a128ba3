"""The port's training slice against the reference package, on the CPU.

The same numpy inputs go through the reference's losses, optax optimizer
and train step and through the port's: losses and their gradients,
the warmup-cosine schedule, AdamW (with a bf16 first moment, clipping
on and off) and one SGD train step on a TINY tree converted with
params_from_flax, once against the reference's "xla" path under remat
and once against its Pallas flash kernels in TPU interpret mode (which
does not run under remat).  Then the port alone: the remat policies
change no number, init_params draws flax's distributions, the roofline
counts match, and the bench prints its JSON line."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
from math import prod

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kubeflow_tpu.models import configs as jconfigs
from kubeflow_tpu.models import train as jtrain
from kubeflow_tpu.parallel.mesh import MeshConfig, make_mesh
from kubeflow_tpu.runtime import roofline as jroofline
from kubeflow_tpu_torch import bench, dryrun
from kubeflow_tpu_torch.models import configs, train
from kubeflow_tpu_torch.models.convert import (
    params_from_flax,
    state_dict_from_flax,
    to_tensor,
)
from kubeflow_tpu_torch.models.transformer import (
    DenseGeneral,
    Transformer,
    init_params,
)
from kubeflow_tpu_torch.runtime import roofline

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs several CPU workers at once,
    and more threads only oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(nn.unbox(tree)))


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# -- losses -------------------------------------------------------------------


def test_cross_entropy_loss_and_grad():
    rs = np.random.RandomState(0)
    logits = rs.standard_normal((2, 8, 32)).astype(np.float32) * 3
    targets = rs.randint(0, 32, (2, 8)).astype(np.int32)
    want, want_g = jax.value_and_grad(jtrain.cross_entropy_loss)(
        jnp.asarray(logits), jnp.asarray(targets))
    t = torch.tensor(logits, requires_grad=True)
    got = train.cross_entropy_loss(t, torch.tensor(targets))
    (got_g,) = torch.autograd.grad(got, t)
    _close(got, want)
    _close(got_g, want_g)


@pytest.mark.parametrize("tied,softcap", [(False, 0.0), (True, 0.0),
                                          (False, 30.0)])
def test_chunked_cross_entropy_and_grads(tied, softcap):
    """Values and gradients (hidden and head kernel) in 4 chunks; tied
    means the kernel is the embedding's transpose."""
    rs = np.random.RandomState(1)
    batch, seq, dim, vocab = 2, 16, 24, 40
    hidden = rs.standard_normal((batch, seq, dim)).astype(np.float32)
    targets = rs.randint(0, vocab, (batch, seq)).astype(np.int32)
    table = rs.standard_normal((vocab, dim)).astype(np.float32) * 2

    def jloss(h, w):
        kernel = w.T if tied else w.reshape(dim, vocab)
        return jtrain.chunked_cross_entropy(h, jnp.asarray(targets), kernel,
                                            4, softcap)

    w_np = table if tied else table.reshape(dim, vocab)
    want, (want_h, want_w) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(w_np))
    h = torch.tensor(hidden, requires_grad=True)
    w = torch.tensor(w_np, requires_grad=True)
    kernel = w.T if tied else w
    got = train.chunked_cross_entropy(h, torch.tensor(targets), kernel, 4,
                                      softcap)
    got_h, got_w = torch.autograd.grad(got, (h, w))
    _close(got, want)
    _close(got_h, want_h)
    _close(got_w, want_w)


def test_chunked_cross_entropy_keeps_bf16_logits_exact():
    """bf16 hidden: the logits are the bf16 operands' products summed in
    fp32, never rounded to bf16 (the reference's preferred fp32)."""
    rs = np.random.RandomState(2)
    hidden = jnp.asarray(rs.standard_normal((1, 8, 16)), jnp.bfloat16)
    kernel = rs.standard_normal((16, 24)).astype(np.float32)
    targets = rs.randint(0, 24, (1, 8)).astype(np.int32)
    want = jtrain.chunked_cross_entropy(hidden, jnp.asarray(targets),
                                        jnp.asarray(kernel), 2)
    got = train.chunked_cross_entropy(to_tensor(np.asarray(hidden)),
                                      torch.tensor(targets),
                                      torch.tensor(kernel), 2)
    _close(got, want)


# -- optimizer ----------------------------------------------------------------


def test_schedule_matches_optax():
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 50)
    got = train.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 50)
    for step in range(0, 60):
        # optax evaluates in fp32, the port in Python floats
        np.testing.assert_allclose(got(step), float(want(step)), rtol=TOL,
                                   atol=1e-12)
    assert got(0) == 0.0


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_adamw_three_steps_match_default_optimizer(mu_dtype, grad_scale):
    """Three steps on the same numpy grads; grad_scale 10 makes the global
    norm exceed 1.0 (clipping on), 0.01 keeps it below (off).  Warmup of
    2 steps from 0, so step 0 has lr 0 and the later ones do not."""
    rs = np.random.RandomState(3)
    shapes = {"a": (8, 6), "b": (6,), "c": (3, 4, 5)}
    params = {k: rs.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rs.standard_normal(s) * grad_scale).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=20,
              mu_dtype=mu_dtype)
    tx = jtrain.default_optimizer(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    opt = train.default_optimizer(**kw)
    names = sorted(shapes)
    tp = [torch.tensor(params[k]) for k in names]
    opt.init(tp)
    for g in grads:
        tg = [torch.tensor(g[k]) for k in names]
        norm = train.global_norm(tg)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)),
                                   rtol=1e-6)
        assert (float(norm) > 1.0) == (grad_scale > 1.0)
        opt.step(tp, tg, norm)
    for k, p in zip(names, tp):
        _close(p, jp[k])
    assert opt.mu[0].dtype == (torch.bfloat16 if mu_dtype else torch.float32)
    for k, mu in zip(names, opt.mu):
        _close(mu, opt_state[1][0].mu[k])


# -- one train step against the reference -------------------------------------


def _batch(cfg, batch: int, seq: int, seed: int):
    rs = np.random.RandomState(seed)
    inputs = rs.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return {"inputs": inputs, "targets": np.roll(inputs, -1, axis=1)}


def _reference_step(cfg, batch: dict):
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    setup = jtrain.setup_training(cfg, mesh, optimizer=optax.sgd(0.05),
                                  batch_shape=batch["inputs"].shape)
    params0 = _np(setup.state.params)
    jbatch = jax.tree.map(jnp.asarray, batch)
    new_state, metrics = setup.train_step(setup.state, jbatch)
    return (params0, _np(new_state.params), float(metrics["loss"]),
            float(metrics["grad_norm"]))


def _port_step(cfg, params0, batch: dict):
    model = params_from_flax(params0, cfg, device="cpu")
    opt = train.SGD(0.05)
    state = train.TrainState(model, opt)
    step = train.make_train_step(model, opt)
    tbatch = {k: torch.tensor(v).long() for k, v in batch.items()}
    state, metrics = step(state, tbatch)
    assert metrics["step"] == 0 and state.step == 1
    return model, float(metrics["loss"]), float(metrics["grad_norm"])


@pytest.mark.parametrize("impl,remat", [("xla", True), ("flash", False)])
def test_sgd_train_step_matches_reference(impl, remat):
    """TINY (2 layers, GQA 4/2, fp32), batch 2 x 128, SGD 0.05: loss, grad
    norm and every updated parameter within 1e-5.  "flash" runs the
    reference's Pallas kernels in TPU interpret mode, with remat off
    (interpret mode does not run under remat), and the port's plain
    flash versions."""
    jcfg = jconfigs.TINY.with_(attention_impl=impl, remat=remat)
    cfg = configs.TINY.with_(attention_impl=impl, remat=remat)
    batch = _batch(cfg, 2, 128, seed=5)
    ctx = (pltpu.force_tpu_interpret_mode() if impl == "flash"
           else contextlib.nullcontext())
    with ctx:
        params0, params1, loss, grad_norm = _reference_step(jcfg, batch)
    model, got_loss, got_norm = _port_step(cfg, params0, batch)
    np.testing.assert_allclose(got_loss, loss, rtol=TOL)
    np.testing.assert_allclose(got_norm, grad_norm, rtol=TOL)
    want = state_dict_from_flax(params1)
    got = model.state_dict()
    assert set(got) == set(want)
    before = state_dict_from_flax(params0)
    moved = 0.0
    for name, tensor in got.items():
        _close(tensor, want[name].numpy())
        moved = max(moved, float((want[name] - before[name]).abs().max()))
    assert moved > 0.0


def test_sharded_step_on_four_processes_matches_reference():
    """The dry run's proxy at seq 256 (4 layers, GQA 8/4 heads of 16, fp32,
    remat), batch 8: the reference's setup_training step on one device
    (optax.sgd(0.05)) against the port's step on 4 gloo processes at
    sequence 2 x tensor 2 (ring attention, vocab-parallel loss), started
    from the reference's initial params converted by the port's
    converter: loss within 1e-3 and every parameter within rtol = atol =
    1e-4 of the reference's step, after an update that moved."""
    cfg = dryrun.proxy_config(256)
    jcfg = jconfigs.TransformerConfig(**dataclasses.asdict(cfg))
    batch = _batch(cfg, 8, cfg.max_seq_len, seed=17)
    params0, params1, loss, _ = _reference_step(jcfg, batch)
    before = state_dict_from_flax(params0)
    after = state_dict_from_flax(params1)
    reference = {"loss": loss, "params": after, "moved": max(
        float((after[n] - before[n]).abs().max()) for n in after)}
    tbatch = {k: torch.tensor(v).long() for k, v in batch.items()}
    result = dryrun.launch(4, dryrun.sharded_step, (
        cfg, MeshConfig(sequence=2, tensor=2), tbatch, reference, before),
        timeout=600)
    assert result["mesh"]["sequence"] == result["mesh"]["tensor"] == 2
    assert dryrun.failures(result) == [], result


def test_remat_policies_change_no_number():
    """One step under each remat policy from the same weights gives the
    same loss and gradients (the port's twin of tests/test_compute.py's
    check); the flash path on the CPU runs its plain versions."""
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 256, (2, 64), generator=gen)
    batch = {"inputs": tokens, "targets": torch.roll(tokens, -1, dims=1)}
    base = Transformer(configs.TINY, device="cpu")
    init_params(base, torch.Generator().manual_seed(1))
    results = {}
    for policy in ("nothing", "dots", "attn", "none"):
        cfg = configs.TINY.with_(remat_policy=policy, attention_impl="flash")
        model = Transformer(cfg, device="cpu")
        model.load_state_dict(base.state_dict())
        loss = train.cross_entropy_loss(model(batch["inputs"]),
                                        batch["targets"])
        grads = torch.autograd.grad(loss, list(model.parameters()))
        results[policy] = (loss, grads)
    ref_loss, ref_grads = results["nothing"]
    for policy, (loss, grads) in results.items():
        torch.testing.assert_close(loss, ref_loss, rtol=1e-6, atol=1e-6)
        for got, want in zip(grads, ref_grads):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("policy,forwards", [("nothing", 4), ("attn", 2),
                                             ("none", 2)])
def test_attn_policy_skips_the_flash_forward_in_the_recompute(
        monkeypatch, policy, forwards):
    """Under "nothing" each layer's flash forward runs again in the
    backward; "attn" keeps its outputs, as "none" keeps everything."""
    from kubeflow_tpu_torch.ops import flash_attention as fa

    calls = []
    real = fa.flash_forward_reference

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_forward_reference", counted)
    cfg = configs.TINY.with_(remat_policy=policy, attention_impl="flash")
    model = Transformer(cfg, device="cpu")
    init_params(model, torch.Generator().manual_seed(2))
    tokens = torch.randint(0, 256, (1, 64),
                           generator=torch.Generator().manual_seed(3))
    loss = model(tokens).float().logsumexp(-1).mean()
    torch.autograd.grad(loss, list(model.parameters()))
    assert len(calls) == forwards


# -- init, roofline, bench ----------------------------------------------------


def test_init_params_draws_flax_distributions():
    """Per-leaf std and the 2-sigma truncation of lecun_normal (fan_in the
    product of the contract dims), N(0, 1) embedding, unit norm scales:
    the port's draw against the reference's init of the same config."""
    cfg = configs.TINY.with_(embed_dim=128, mlp_dim=256, vocab_size=512)
    jcfg = jconfigs.TINY.with_(embed_dim=128, mlp_dim=256, vocab_size=512)
    ref = state_dict_from_flax(_np(jtrain.Transformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))["params"]))
    model = Transformer(cfg, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    fan_in = {f"{name}.kernel": prod(mod.contract)
              for name, mod in model.named_modules()
              if isinstance(mod, DenseGeneral)}
    got = model.state_dict()
    assert set(got) == set(ref)
    for name, tensor in got.items():
        want = ref[name].float()
        if name.endswith("scale"):
            assert torch.equal(tensor, torch.ones_like(tensor))
            assert torch.equal(want, torch.ones_like(want))
            continue
        for t in (tensor, want):
            assert abs(t.mean().item()) < 0.15 * want.std().item()
        np.testing.assert_allclose(tensor.std().item(), want.std().item(),
                                   rtol=0.1)
        if name in fan_in:
            # the truncation: nothing beyond 2 sigma of the untruncated
            # normal, sigma = sqrt(1 / fan_in) / 0.8796...
            bound = 2 * fan_in[name] ** -0.5 / 0.87962566103423978
            assert tensor.abs().max().item() <= bound * (1 + 1e-6)
            assert want.abs().max().item() <= bound * (1 + 1e-6)


@pytest.mark.parametrize("name", ["TINY", "BENCH_CHIP", "LLAMA2_7B"])
def test_roofline_counts_match_reference(name):
    cfg, jcfg = getattr(configs, name), getattr(jconfigs, name)
    for batch, seq in ((4, 128), (40, 2048)):
        assert cfg.flops_per_token(seq) == jcfg.flops_per_token(seq)
        assert roofline.train_step_flops(cfg, batch, seq) == \
            jroofline.train_step_flops(jcfg, batch, seq)
        assert roofline.train_step_hbm_bytes(cfg, batch, seq) == \
            jroofline.train_step_hbm_bytes(jcfg, batch, seq)
    assert cfg == configs.TransformerConfig(**{
        f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})


def test_mfu_uses_the_cards_own_peak():
    cfg = configs.BENCH_CHIP
    card = "NVIDIA H100 80GB HBM3"
    tok_s = 81920 / 0.5
    want = tok_s * cfg.flops_per_token(2048) / 989e12
    assert train.mfu(tok_s, cfg, 2048, 1, card) == pytest.approx(want)
    assert train.mfu(tok_s, cfg, 2048, 1, "some other card") is None
    est = roofline.train_estimate(cfg, 40, 2048, card)
    assert est.compute_floor_s == pytest.approx(
        40 * 2048 * cfg.flops_per_token(2048) / 989e12)
    assert roofline.train_estimate(cfg, 40, 2048, "cpu"
                                   ).roofline_fraction(1.0) is None


def test_bench_cpu_prints_one_json_line():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        record = bench.main(["--cpu", "2"])
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == record
    assert set(record) == {"metric", "value", "unit", "vs_baseline",
                           "roofline_fraction", "bound", "detail"}
    assert record["metric"] == "train_mfu_h100"
    assert record["value"] is None   # a CPU run measures no card
    detail = record["detail"]
    for key in ("tokens_per_s", "step_time_s", "final_loss", "estimator",
                "window_tokens_per_s", "device"):
        assert key in detail
    assert np.isfinite(detail["final_loss"]) and detail["tokens_per_s"] > 0
