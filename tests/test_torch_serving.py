"""The port's serving and small-model entry points on the CPU, with no
reference package: `python -m kubeflow_tpu_torch.bench --decode` and
`--vit`, the serving example, the MNIST loop, the speculative demo's
data stream, the launch accounting a CUDA graph's replays rely on, and
the tensor-parallel decode mesh's refusals.
(The parity tests against the reference are in test_torch_decode.py and
test_torch_train.py; the graph itself runs only on the card, in
chip_smoke.py.)"""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch import bench
from kubeflow_tpu_torch.models.configs import BENCH_MOE, TINY
from kubeflow_tpu_torch.models.generate import capturable
from kubeflow_tpu_torch.ops import flash_attention, int4_matmul, launch_counts


def _run(fn, argv) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(argv)
    return result, out.getvalue().strip().splitlines()


@pytest.mark.parametrize("quant", ["", "--int8", "--int4"])
def test_bench_decode_cpu_prints_one_json_line(quant):
    """TINY at batch 2, prompt 8, 16 new tokens; int4 is off on the CPU
    (as in the reference), so --int4 measures bf16 under its own name."""
    argv = ["--decode", "--cpu"] + ([quant] if quant else [])
    record, lines = _run(bench.main_decode, argv)
    assert len(lines) == 1 and json.loads(lines[0]) == record
    assert record["metric"] == ("decode_tok_s_h100_int8" if quant == "--int8"
                                else "decode_tok_s_h100")
    assert record["value"] > 0
    assert record["vs_baseline"] is None      # a CPU run measures no card
    detail = record["detail"]
    assert (detail["batch"], detail["prompt_len"], detail["new_tokens"]) == \
        (2, 8, 16)
    assert detail["model"] == "tiny-cpu" and not detail["cuda_graph"]
    assert detail["roofline_weight_mb"] > 0 and detail["roofline_kv_mb"] >= 0


def test_bench_run_decode_returns_its_warm_up_call():
    """`run_decode` is `--decode` without the print: the record, and the
    model, prompt and tokens of its warm-up call, which a second call on
    the same model and prompt repeats."""
    from kubeflow_tpu_torch.models.generate import generate

    record, (cfg, model, prompt, tokens) = bench.run_decode(
        ["--decode", "--cpu"])
    assert record["metric"] == "decode_tok_s_h100"
    assert tuple(prompt.shape) == (2, 8) and tuple(tokens.shape) == (2, 24)
    assert torch.equal(tokens[:, :8], prompt)
    assert torch.equal(generate(cfg, model, prompt, 16), tokens)


def test_counter_buffers_are_the_ones_a_launch_uses(monkeypatch):
    """A captured graph keeps `counter_buffers()`; they are the split-K
    counters the next launch takes, and a larger grid replaces them."""
    monkeypatch.setattr(int4_matmul, "_COUNTERS", {})
    cpu = torch.device("cpu")
    first = int4_matmul._counters(cpu, 10)
    assert [b is first for b in int4_matmul.counter_buffers()] == [True]
    assert int4_matmul._counters(cpu, 4096) is first
    second = int4_matmul._counters(cpu, 5000)
    assert second is not first and second.numel() == 5000
    assert [b is second for b in int4_matmul.counter_buffers()] == [True]


def test_bench_vit_cpu_prints_one_json_line():
    record, lines = _run(bench.main_vit, ["--vit", "2", "--cpu"])
    assert len(lines) == 1 and json.loads(lines[0]) == record
    assert record["metric"] == "train_mfu_h100_vit_b16"
    assert record["value"] is None
    detail = record["detail"]
    assert detail["model"] == "vit-tiny-cpu" and detail["batch"] == 4
    assert np.isfinite(detail["final_loss"]) and detail["images_per_s"] > 0


def test_serve_model_example_on_cpu():
    from kubeflow_tpu_torch.examples import serve_model

    rc, lines = _run(serve_model.main, ["--cpu"])
    assert rc == 0 and lines[-1] == "RESULT: OK"
    assert any(line.startswith("speculative (self-draft): exact")
               for line in lines)


def test_train_mnist_steps_lowers_the_loss():
    from kubeflow_tpu_torch.models.mlp import train_mnist_steps

    out = train_mnist_steps(num_steps=20, batch=64, device="cpu")
    assert set(out) == {"first_loss", "last_loss"}
    assert out["last_loss"] < out["first_loss"] / 2


def test_speculative_demo_stream_is_affine():
    from kubeflow_tpu_torch.examples import speculative_demo as demo

    batch = demo.stream_batch(3, 8, seq=32)
    x, y = batch["inputs"], batch["targets"]
    assert x.shape == y.shape == (8, 32)
    np.testing.assert_array_equal(x[:, 1:], y[:, :-1])
    for row_x, row_y in zip(x, y):
        fits = [(a, c) for a in (3, 5, 7) for c in (1, 11, 29)
                if np.array_equal((a * row_x + c) % demo.VOCAB, row_y)]
        assert len(fits) == 1
    np.testing.assert_array_equal(demo.stream_batch(3, 8, seq=32)["inputs"],
                                  x)


def test_launch_counts_credit_and_restore():
    """A graph's runner takes back what its capture counted and credits
    it per replay: snapshot, since, restore and credit over every
    kernel's count."""
    before = launch_counts.snapshot()
    try:
        int4_matmul.launches += 3
        flash_attention.launches["fwd"] += 2
        delta = launch_counts.since(before)
        assert delta == {**{k: 0 for k in before}, "int4_matmul": 3,
                         "flash_fwd": 2}
        launch_counts.restore(before)
        assert launch_counts.snapshot() == before
        launch_counts.credit(delta, 5)
        assert launch_counts.since(before) == {
            k: 5 * v for k, v in delta.items()}
    finally:
        launch_counts.restore(before)


def test_only_the_sort_dispatch_decodes_eagerly():
    assert capturable(TINY) and capturable(BENCH_MOE)
    assert not capturable(BENCH_MOE.with_(moe_dispatch="sort"))


def test_generate_on_cpu_takes_the_eager_loop():
    """On a CPU device `generate` runs its steps eagerly whatever
    `cuda_graph` says, and the two calls agree."""
    from kubeflow_tpu_torch.models.generate import decode_config, generate
    from kubeflow_tpu_torch.models.transformer import Transformer, init_params

    cfg = decode_config(TINY)
    model = Transformer(cfg, device="cpu")
    init_params(model, torch.Generator().manual_seed(0))
    prompt = torch.randint(0, 256, (2, 6), generator=torch.Generator()
                           .manual_seed(1))
    a = generate(cfg, model, prompt, 10)
    b = generate(cfg, model, prompt, 10, cuda_graph=False)
    assert torch.equal(a, b) and tuple(a.shape) == (2, 16)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("axis", ["data", "fsdp", "sequence", "pipeline",
                                  "expert"])
def test_decode_mesh_builds_on_every_axis(axis, moe):
    """A decode model builds on a mesh with any axis populated beside
    "tensor", dense and MoE: `check_decode_mesh` takes the mesh, and on a
    pipeline mesh the model holds every layer (decode replicates that
    axis)."""
    from kubeflow_tpu_torch.models.generate import decode_config
    from kubeflow_tpu_torch.models.transformer import (
        Transformer,
        check_decode_mesh,
    )
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig

    cfg = decode_config(TINY.with_(moe_experts=4, moe_top_k=2) if moe
                        else TINY)
    mesh = MeshConfig(**{"data": 1, "tensor": 2, axis: 2}).resolved(4)
    check_decode_mesh(cfg, mesh)
    model = Transformer(cfg, device="meta", mesh=mesh)
    assert list(model.layer_ids) == list(range(cfg.num_layers))


def test_decode_mesh_refuses_int4_shards_outside_the_kernel():
    """out's K = 4 heads x 32 = 128 splits 4 ways into 32 rows, not a
    multiple of the kernel's 64-row scale group."""
    from kubeflow_tpu_torch.models.generate import decode_config
    from kubeflow_tpu_torch.models.transformer import check_decode_mesh
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig

    cfg = decode_config(TINY).with_(weight_dtype="int4", embed_dim=128,
                                    num_kv_heads=4, head_dim=32, mlp_dim=512)
    mesh = MeshConfig(tensor=4).resolved(4)
    with pytest.raises(ValueError, match="out K/4 = 32"):
        check_decode_mesh(cfg, mesh)
    check_decode_mesh(cfg, MeshConfig(tensor=2).resolved(2))


def test_decode_mesh_refuses_kv_heads_it_cannot_split():
    from kubeflow_tpu_torch.models.generate import decode_config
    from kubeflow_tpu_torch.models.transformer import Transformer
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig

    with pytest.raises(ValueError, match="num_kv_heads"):
        Transformer(decode_config(TINY), device="cpu",
                    mesh=MeshConfig(tensor=4).resolved(4))


def test_llama7b_int4_shards_at_tensor_2():
    """The int4 Llama-2-7B decode layout at tensor 2 meets the kernel's
    contract, and its layers' shards are qkv N 6144, gate_up N 11008 and
    the head N 16000 at K 4096, out K 2048 and down K 5504 at N 4096."""
    from kubeflow_tpu_torch.models.configs import LLAMA2_7B
    from kubeflow_tpu_torch.models.generate import decode_config
    from kubeflow_tpu_torch.models.quant import Int4Linear
    from kubeflow_tpu_torch.models.transformer import (
        Transformer,
        check_decode_mesh,
    )
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig

    cfg = decode_config(LLAMA2_7B).with_(weight_dtype="int4")
    check_decode_mesh(cfg, MeshConfig(tensor=2).resolved(2))
    model = Transformer(cfg.with_(num_layers=1), device="meta")
    cuts = {}
    for name, mod in model.named_modules():
        if isinstance(mod, Int4Linear):
            k, n = 2 * mod.kernel_q4.shape[0], mod.kernel_q4.shape[1]
            rows, cols = mod.kernel_q4.logical_axes
            cut = "tensor" if cols in ("heads", "mlp", "vocab") else None
            cuts[name.split(".")[-1]] = ((k // 2, n) if rows in (
                "heads", "mlp") else (k, n // 2), cut)
    assert cuts == {"qkv": ((4096, 6144), "tensor"),
                    "out": ((2048, 4096), None),
                    "gate_up": ((4096, 11008), "tensor"),
                    "down": ((5504, 4096), None),
                    "lm_head": ((4096, 16000), "tensor")}
