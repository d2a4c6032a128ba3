"""The plain reference against the port's plain paths, on the CPU at
small sizes, in float32 so that the two agree to round-off."""

import dataclasses

import torch

from benchmark import weights as W
from benchmark.reference import adamw, decode, int4, model
from benchmark.runners import decode as decode_runner
from benchmark.runners import train as train_runner
from benchmark.tests import tiny
from benchmark.traffic import TrainFeed


def _port(shape, mix, **cfg):
    from kubeflow_tpu_torch.models.train import (
        default_optimizer,
        setup_training,
    )

    opt = shape.assumed["optimizer"]
    config = train_runner.port_config(shape, mix).with_(
        dtype="float32", **cfg)
    setup = setup_training(config, device="cpu", optimizer=default_optimizer(
        learning_rate=opt["learning_rate"], warmup_steps=opt["warmup_steps"],
        total_steps=opt["total_steps"], weight_decay=opt["weight_decay"],
        max_grad_norm=opt["max_grad_norm"], mu_dtype=opt["mu_dtype"]))
    params = dict(setup.model.named_parameters())
    with torch.no_grad():
        for name in W.groups(shape):
            group = W.make(shape, name, 5, device="cpu")
            for key in W.layer_slices(shape, name):
                params[train_runner.port_name(shape, key)].copy_(
                    W.leaf(group, key))
    return setup


def _loss_and_grads(shape, mix, **cfg):
    from kubeflow_tpu_torch.models.train import loss_fn

    setup = _port(shape, mix, **cfg)
    batch = TrainFeed(mix, shape.vocab, 5, "cpu").next()
    loss = loss_fn(setup.model, batch)
    named = dict(setup.model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    grads = dict(zip(named, grads))

    params = adamw.leaves(shape, 5, "cpu")
    w = adamw.stacked(params, shape)
    ref = model.loss(w, batch["inputs"], batch["targets"], shape)
    keys = list(params)
    ref_grads = dict(zip(keys, torch.autograd.grad(ref, [params[k]
                                                         for k in keys])))
    return loss, ref, {k: (grads[train_runner.port_name(shape, k)],
                           ref_grads[k]) for k in keys}


def test_dense_loss_and_gradients_match_the_port():
    shape = tiny.shape("mistral-7b-pp2")
    loss, ref, grads = _loss_and_grads(shape, tiny.TRAIN_MIX,
                                       attention_impl="xla")
    assert abs(float(loss.detach()) - float(ref.detach())) \
        < 1e-5 * abs(float(ref.detach()))
    for key, (g, r) in grads.items():
        assert torch.allclose(g, r, rtol=1e-4, atol=1e-7), key


def test_moe_loss_and_gradients_match_the_port_with_drops():
    # capacity 1.0 with 4 experts drops choices: the rule is exercised
    shape = dataclasses.replace(tiny.shape("mixtral-8x7b-l2"),
                                capacity_factor=1.0)
    loss, ref, grads = _loss_and_grads(shape, tiny.TRAIN_MIX,
                                       attention_impl="xla",
                                       moe_capacity_factor=1.0)
    assert abs(float(loss.detach()) - float(ref.detach())) \
        < 1e-5 * abs(float(ref.detach()))
    for key, (g, r) in grads.items():
        assert torch.allclose(g, r, rtol=1e-3, atol=1e-6), key


def test_three_adamw_steps_match_the_port():
    shape = tiny.shape("mistral-7b-pp2")
    mix = tiny.TRAIN_MIX
    opt = dict(shape.assumed["optimizer"], warmup_steps=2)
    shape = dataclasses.replace(shape, assumed=dict(shape.assumed,
                                                    optimizer=opt))
    setup = _port(shape, mix, attention_impl="xla")
    feed = TrainFeed(mix, shape.vocab, 5, "cpu")
    batches = [feed.next() for _ in range(3)]
    start = {n: p.detach().clone()
             for n, p in setup.model.named_parameters()}
    losses = []
    for b in batches:
        _, metrics = setup.train_step(setup.state, b)
        losses.append(float(metrics["loss"]))
    ref = adamw.train(shape, opt, batches, 5, "cpu")
    assert max(abs(a - b) / b for a, b in zip(losses, ref.losses)) < 1e-5
    for key, change in ref.change.items():
        name = train_runner.port_name(shape, key)
        got = float(torch.linalg.vector_norm(
            dict(setup.model.named_parameters())[name].detach()
            - start[name]))
        assert abs(got - change) <= 1e-3 * change + 1e-9, key


def test_frozen_int4_matches_the_quantizer():
    from kubeflow_tpu_torch.models.quant import quantize_kernel_int4
    from kubeflow_tpu_torch.ops.int4_matmul import unpack_int4

    gen = torch.Generator().manual_seed(0)
    kernel = (torch.randn(256, 48, generator=gen) * 0.02).to(torch.bfloat16)
    q = quantize_kernel_int4(kernel)
    ints = unpack_int4(q["kernel_q4"]).float().reshape(4, 64, 48)
    port = (ints * q["kernel_scale"].float()).reshape(256, 48)
    assert torch.equal(int4.dequantized(kernel), port)


def test_decode_reference_agrees_with_the_port_int4_path():
    from kubeflow_tpu_torch.models.convert import params_from_flax
    from kubeflow_tpu_torch.models.generate import generate
    from kubeflow_tpu_torch.models.quant import quantize_params_int4

    shape = tiny.shape("mistral-7b")
    mix = tiny.CHAT_MIX
    cfg = decode_runner.port_config(shape, mix).with_(dtype="float32")
    tree = quantize_params_int4(decode_runner.decode_tree(shape, 9, "cpu"))
    port = params_from_flax(tree, cfg, "cpu")
    prompt = torch.randint(0, shape.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    out = generate(cfg, port, prompt, 6, device="cpu")
    w = decode.decode_weights(shape, 9, "cpu")
    gaps = decode.gaps(w, [(out[0], 8), (out[1], 8)], shape)
    # the fp32 port path serves the reference's own argmax, to round-off
    assert max(float(g.max()) for g in gaps) < 1e-4


def test_the_fp8_control_rounds_every_operand_of_both_passes():
    """FP8.mm: e4m3 operands forward; both backward products take the
    saved e4m3 operands and the gradient rounded to e5m2."""
    from benchmark.reference.precision import EXACT, FP8, rounded

    gen = torch.Generator().manual_seed(3)
    a = torch.randn(32, 48, generator=gen, requires_grad=True)
    b = torch.randn(48, 16, generator=gen, requires_grad=True)
    dy = torch.randn(32, 16, generator=gen)
    e4, e5 = torch.float8_e4m3fn, torch.float8_e5m2
    y = FP8.mm(a, b)
    assert torch.equal(y, rounded(a.detach(), e4) @ rounded(b.detach(), e4))
    ga, gb = torch.autograd.grad(y, (a, b), dy)
    g8 = rounded(dy, e5)
    assert not torch.equal(g8, dy)
    assert torch.allclose(ga, g8 @ rounded(b.detach(), e4).T)
    assert torch.allclose(gb, rounded(a.detach(), e4).T @ g8)
    ga32, gb32 = torch.autograd.grad(EXACT.mm(a, b), (a, b), dy)
    assert torch.equal(ga32, dy @ b.detach().T)
    assert torch.equal(gb32, a.detach().T @ dy)
