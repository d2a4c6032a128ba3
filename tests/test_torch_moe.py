"""The port's Mixture-of-Experts against the reference package, on the CPU.

MOE_TINY (TINY with 4 experts, top-2, capacity 2.0, fp32) on both sides,
with the reference's flax params converted by the port's converter: the
load-balance loss, the MoE layer's output, aux loss and gradients in all
three dispatch modes (with and without capacity drops), the Transformer's
logits and aux from stacked and unrolled trees, three train steps, the
converter and the int8 quantizer, and greedy int8 generation; then the port alone: identical
experts equal one dense FFN, init_params draws flax's distributions, int4
with experts is refused, and `bench --moe --cpu` prints its line."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import configs as jconfigs
from kubeflow_tpu.models import moe as jmoe
from kubeflow_tpu.models import quant as jquant
from kubeflow_tpu.models import train as jtrain
from kubeflow_tpu.models.generate import generate as jgenerate
from kubeflow_tpu.models.generate import prepare_decode as jprepare_decode
from kubeflow_tpu.models.transformer import Transformer as JTransformer
from kubeflow_tpu.parallel.mesh import MeshConfig, make_mesh
from kubeflow_tpu_torch import bench, dryrun
from kubeflow_tpu_torch.models import configs, moe, quant, train
from kubeflow_tpu_torch.models.convert import (
    params_from_flax,
    state_dict_from_flax,
    to_tensor,
)
from kubeflow_tpu_torch.models.generate import generate, unroll_params
from kubeflow_tpu_torch.models.transformer import Transformer, init_params

TOL = 1e-5
GRAD_TOL = 1e-4
MOE = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=2.0)
JMOE_TINY = jconfigs.TINY.with_(**MOE)
MOE_TINY = configs.TINY.with_(**MOE)
DISPATCH = ["einsum", "hybrid", "sort"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs several CPU workers at once."""
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


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy().view(np.uint8).ravel()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).ravel()


def _x(seq: int = 16, seed: int = 1) -> np.ndarray:
    return np.random.RandomState(seed).standard_normal(
        (2, seq, MOE_TINY.embed_dim)).astype(np.float32)


def _layer(dispatch: str, cf: float, x: np.ndarray):
    """(reference MoEMLP, its params, the port's MoEMLP loaded with them)."""
    jcfg = JMOE_TINY.with_(moe_dispatch=dispatch, moe_capacity_factor=cf)
    jmod = jmoe.MoEMLP(jcfg)
    params = _np(jmod.init(jax.random.PRNGKey(0), x)["params"])
    layer = moe.MoEMLP(MOE_TINY.with_(moe_dispatch=dispatch,
                                      moe_capacity_factor=cf), device="cpu")
    layer.load_state_dict(state_dict_from_flax(params), strict=True)
    return jmod, params, layer


def _tree(cfg, seed: int = 0) -> dict:
    """The reference Transformer's stacked param tree for `cfg`."""
    return _np(JTransformer(cfg).init(jax.random.PRNGKey(seed),
                                      jnp.ones((1, 8), jnp.int32))["params"])


@pytest.fixture(scope="module")
def moe_tree() -> dict:
    """MOE_TINY's stacked fp32 tree (the reference's init)."""
    return _tree(JMOE_TINY)


@pytest.fixture(scope="module")
def int8_tree(moe_tree) -> dict:
    """moe_tree through the reference's quantize_params."""
    return _np(jquant.quantize_params(moe_tree))


# -- config -------------------------------------------------------------------


def test_bench_moe_config_matches_reference():
    assert dataclasses.asdict(configs.BENCH_MOE) == \
        dataclasses.asdict(jconfigs.BENCH_MOE)
    assert configs.PRESETS["bench-moe"] == configs.BENCH_MOE
    for seq in (128, 2048):
        assert configs.BENCH_MOE.flops_per_token(seq) == \
            jconfigs.BENCH_MOE.flops_per_token(seq)
    assert configs.BENCH_MOE.num_params == jconfigs.BENCH_MOE.num_params


# -- the layer ----------------------------------------------------------------


def test_load_balance_loss_matches_reference():
    rs = np.random.RandomState(0)
    probs = rs.dirichlet(np.ones(4), size=(2, 16)).astype(np.float32)
    mask = np.eye(4, dtype=np.float32)[rs.randint(0, 4, (2, 16))]
    want = jmoe.load_balance_loss(jnp.asarray(probs), jnp.asarray(mask))
    got = moe.load_balance_loss(torch.from_numpy(probs),
                                torch.from_numpy(mask))
    _close(got, want)
    uniform = torch.full((128, 4), 0.25)
    spread = moe.one_hot(torch.arange(128) % 4, 4, torch.float32)
    assert moe.load_balance_loss(uniform, spread).item() == \
        pytest.approx(1.0, rel=1e-6)
    collapsed = moe.one_hot(torch.zeros(128, dtype=torch.int64), 4,
                            torch.float32)
    peaky = torch.cat([torch.full((128, 1), 0.97),
                       torch.full((128, 3), 0.01)], dim=-1)
    assert moe.load_balance_loss(peaky, collapsed).item() > 2.0


@pytest.mark.parametrize("cf", [2.0, 0.1])
@pytest.mark.parametrize("dispatch", DISPATCH)
def test_moe_layer_matches_reference(dispatch, cf):
    """Output and aux within 1e-5; at capacity 0.1 choices are dropped,
    and some token gets no expert output at all."""
    x = _x(seq=32)
    jmod, params, layer = _layer(dispatch, cf, x)
    want, want_aux = jmod.apply({"params": params}, x)
    with torch.no_grad():
        got, aux = layer(torch.from_numpy(x))
    _close(got, want)
    _close(aux, want_aux)
    if cf < 1.0:
        assert got.norm(dim=-1).min().item() == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("dispatch,cf", [("einsum", 2.0), ("hybrid", 2.0),
                                         ("sort", 2.0), ("hybrid", 0.1)])
def test_moe_layer_grads_match_reference(dispatch, cf):
    """d(sum(out^2) + aux) by the router and expert kernels and by x
    against jax.grad, within 1e-4."""
    x = _x()
    jmod, params, layer = _layer(dispatch, cf, x)

    def jloss(p, xs):
        out, aux = jmod.apply({"params": p}, xs)
        return jnp.sum(out ** 2) + aux

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(params, x)
    xt = torch.tensor(x, requires_grad=True)
    out, aux = layer(xt)
    names = [n for n, _ in layer.named_parameters()]
    grads = torch.autograd.grad(torch.sum(out ** 2) + aux,
                                [xt] + list(layer.parameters()))
    _close(grads[0], want_x, GRAD_TOL)
    want = state_dict_from_flax(_np(want_p))
    assert set(names) == set(want) == {
        "router.kernel", "experts.gate.kernel", "experts.up.kernel",
        "experts.down.kernel"}
    for name, g in zip(names, grads[1:]):
        assert g.abs().max().item() > 0.0, name
        _close(g, want[name].numpy(), GRAD_TOL)


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_identical_experts_equal_one_dense_ffn(dispatch):
    """Every expert expert 0 and no drops: the combine weights sum to 1
    per token, so the layer is expert 0's gated MLP."""
    cfg = MOE_TINY.with_(moe_capacity_factor=8.0, moe_dispatch=dispatch)
    layer = moe.MoEMLP(cfg, device="cpu")
    _fill_random(layer, seed=3)
    with torch.no_grad():
        for mod in (layer.experts.gate, layer.experts.up,
                    layer.experts.down):
            mod.kernel.copy_(mod.kernel[:1].expand_as(mod.kernel))
        x = torch.from_numpy(_x(seed=4))
        got, _ = layer(x)
        gate, up, down = (m.kernel[0] for m in (
            layer.experts.gate, layer.experts.up, layer.experts.down))
        want = (torch.nn.functional.silu(x @ gate) * (x @ up)) @ down
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def _fill_random(layer: torch.nn.Module, seed: int) -> None:
    """Fill a lone layer's kernels with N(0, 0.1^2) from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)


# -- the model ----------------------------------------------------------------


@pytest.mark.parametrize("layout", ["stacked", "unrolled"])
@pytest.mark.parametrize("dispatch", ["einsum", "hybrid"])
def test_transformer_logits_and_aux_match(layout, dispatch, moe_tree):
    jcfg = JMOE_TINY.with_(moe_dispatch=dispatch)
    tree = moe_tree
    tokens = np.random.RandomState(2).randint(0, 256, (2, 12))
    want, want_aux = JTransformer(jcfg).apply({"params": tree}, tokens,
                                              return_aux=True)
    if layout == "unrolled":
        tree = unroll_params(tree)
    model = params_from_flax(tree, MOE_TINY.with_(moe_dispatch=dispatch),
                             device="cpu")
    with torch.no_grad():
        got, aux = model(torch.from_numpy(tokens), return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    _close(aux, want_aux)
    assert 0.9 * MOE_TINY.num_layers < aux.item() < \
        (MOE_TINY.moe_experts + 1) * MOE_TINY.num_layers


@pytest.mark.parametrize("loss_chunks", [0, 4])
def test_three_train_steps_match_reference(loss_chunks):
    """SGD(0.05), three batches of 2 x 64: loss, ce_loss and moe_aux_loss
    of every step and every parameter after the third within 1e-5."""
    jcfg = JMOE_TINY.with_(loss_chunks=loss_chunks)
    cfg = MOE_TINY.with_(loss_chunks=loss_chunks)
    rs = np.random.RandomState(5)
    batches = []
    for _ in range(3):
        inputs = rs.randint(0, 256, (2, 64)).astype(np.int32)
        batches.append({"inputs": inputs,
                        "targets": np.roll(inputs, -1, axis=1)})
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    setup = jtrain.setup_training(jcfg, mesh, optimizer=optax.sgd(0.05),
                                  batch_shape=(2, 64))
    params0 = _np(setup.state.params)
    state, want = setup.state, []
    for batch in batches:
        state, metrics = setup.train_step(
            state, jax.tree.map(jnp.asarray, batch))
        want.append({k: float(metrics[k])
                     for k in ("loss", "ce_loss", "moe_aux_loss")})
    params3 = state_dict_from_flax(_np(state.params))

    model = params_from_flax(params0, cfg, device="cpu")
    opt = train.SGD(0.05)
    step = train.make_train_step(model, opt)
    tstate = train.TrainState(model, opt)
    for batch, w in zip(batches, want):
        tstate, metrics = step(tstate, {k: torch.tensor(v).long()
                                        for k, v in batch.items()})
        for key, value in w.items():
            np.testing.assert_allclose(float(metrics[key]), value, rtol=TOL)
        np.testing.assert_allclose(
            float(metrics["loss"]),
            float(metrics["ce_loss"])
            + cfg.moe_aux_weight * float(metrics["moe_aux_loss"]),
            rtol=1e-6)
    got = model.state_dict()
    assert set(got) == set(params3)
    for name, tensor in got.items():
        _close(tensor, params3[name].numpy())


def test_expert_parallel_step_on_four_processes_matches_reference():
    """The dry run's MoE proxy (4 experts, top-2, capacity 2.0) at seq 256,
    batch 8: the reference's setup_training step on one device
    (optax.sgd(0.05)) against the port's step on 4 gloo processes at
    expert 2 x tensor 2, from the reference's converted initial params:
    loss within 1e-3, every parameter within rtol = atol = 1e-4."""
    cfg = dryrun.proxy_config(256, moe=True)
    jcfg = jconfigs.TransformerConfig(**dataclasses.asdict(cfg))
    rs = np.random.RandomState(17)
    inputs = rs.randint(0, cfg.vocab_size, (8, 256)).astype(np.int32)
    batch = {"inputs": inputs, "targets": np.roll(inputs, -1, axis=1)}
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    setup = jtrain.setup_training(jcfg, mesh, optimizer=optax.sgd(0.05),
                                  batch_shape=(8, 256))
    before = state_dict_from_flax(_np(setup.state.params))
    state, metrics = setup.train_step(setup.state,
                                      jax.tree.map(jnp.asarray, batch))
    after = state_dict_from_flax(_np(state.params))
    reference = {"loss": float(metrics["loss"]), "params": after,
                 "moved": max(float((after[n] - before[n]).abs().max())
                              for n in after)}
    result = dryrun.launch(4, dryrun.sharded_step, (
        cfg, MeshConfig(tensor=2, expert=2),
        {k: torch.tensor(v).long() for k, v in batch.items()}, reference,
        before), timeout=600)
    assert result["mesh"]["expert"] == result["mesh"]["tensor"] == 2
    assert dryrun.failures(result) == [], result


# -- conversion, quantization, serving ----------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["stacked", "unrolled"])
def test_converter_loads_moe_trees(dtype, layout, moe_tree, int8_tree):
    """Every parameter of the port's model holds the flax leaf's bytes:
    fp32 and bf16 trees (param_dtype) and the int8 tree of quantize_params
    (per-expert, per-output-channel scales [E, 1, M])."""
    cfg, tree = MOE_TINY, moe_tree
    if dtype == "bfloat16":
        cfg = cfg.with_(param_dtype="bfloat16")
        tree = _tree(JMOE_TINY.with_(param_dtype="bfloat16"))
    elif dtype == "int8":
        cfg, tree = cfg.with_(weight_dtype="int8"), int8_tree
        assert tree["layers"]["moe"]["experts"]["gate"]["kernel_scale"] \
            .shape == (2, 4, 1, 128)
    if layout == "unrolled":
        tree = unroll_params(tree)
    state = params_from_flax(tree, cfg, device="cpu").state_dict()
    want = state_dict_from_flax(tree)
    assert set(state) == set(want)
    assert "layers.1.moe.experts.down." + (
        "kernel_q" if dtype == "int8" else "kernel") in state
    assert state["layers.0.moe.router.kernel"].dtype == torch.float32
    for name, value in state.items():
        assert value.shape == want[name].shape, name
        np.testing.assert_array_equal(_bits(value), _bits(want[name]),
                                      err_msg=name)


def test_int8_quantized_moe_tree_bytes_identical(moe_tree, int8_tree):
    want = int8_tree
    got = quant.quantize_params(jax.tree.map(to_tensor, moe_tree))
    want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got_flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(want_flat) == len(got_flat)
    for path, leaf in want_flat:
        np.testing.assert_array_equal(_bits(got_flat[path]), _bits(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    # the router stays fp32, as the reference skips it
    assert "kernel" in got["layers"]["moe"]["router"]


def test_greedy_int8_moe_generate_tokens_equal(moe_tree):
    """The reference's decode flow (attention fused, the experts stacked
    as they are), quantized after fusing: the same greedy tokens."""
    _, fused = jprepare_decode(JMOE_TINY, moe_tree)
    fused = _np(fused)
    assert "qkv" in fused["layer_0"]["attn"] and "moe" in fused["layer_0"]
    tree = _np(jquant.quantize_params(fused))
    prompt = np.random.RandomState(4).randint(0, 256, (2, 5))
    want = jgenerate(JMOE_TINY.with_(weight_dtype="int8"), tree,
                     jnp.asarray(prompt), max_new_tokens=8)
    got = generate(MOE_TINY.with_(weight_dtype="int8"), tree, prompt,
                   max_new_tokens=8, device="cpu")
    assert got.shape == (2, 13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int4_with_experts_is_refused(moe_tree):
    with pytest.raises(ValueError, match="int4"):
        Transformer(MOE_TINY.with_(weight_dtype="int4"), device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        quant.quantize_params_int4(jax.tree.map(to_tensor, moe_tree))


# -- the port alone -----------------------------------------------------------


def test_init_params_draws_flax_distributions_for_moe():
    """The router's lecun_normal over fan_in D, each expert's over D
    (gate, up) or M (down), against the reference's init."""
    kw = dict(embed_dim=128, moe_mlp_dim=256, vocab_size=512)
    ref = state_dict_from_flax(_tree(JMOE_TINY.with_(**kw)))
    model = Transformer(MOE_TINY.with_(**kw), device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    got = model.state_dict()
    assert set(got) == set(ref)
    fan_in = {"router": 128, "gate": 128, "up": 128, "down": 256}
    for name, tensor in got.items():
        if ".moe." not in name:
            continue
        want = ref[name].float()
        assert tensor.dtype == torch.float32
        np.testing.assert_allclose(tensor.std().item(), want.std().item(),
                                   rtol=0.1)
        fan = fan_in[name.split(".")[-2]]
        bound = 2 * fan ** -0.5 / 0.87962566103423978
        assert tensor.abs().max().item() <= bound * (1 + 1e-6)
        assert want.abs().max().item() <= bound * (1 + 1e-6)
        np.testing.assert_allclose(tensor.std().item(), fan ** -0.5,
                                   rtol=0.1)


def test_bench_moe_cpu_prints_one_json_line():
    """--cpu runs TINY whatever the mode, as the reference's CPU backend
    does, so the metric keeps the dense name."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        record = bench.main(["--cpu", "--moe", "1"])
    lines = out.getvalue().strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == record
    assert record["metric"] == "train_mfu_h100"
    assert record["detail"]["model"] == "tiny-cpu"
    assert record["value"] is None
