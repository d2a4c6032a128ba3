"""The port's serving slice against the reference package, on the CPU.

One numpy-filled param tree (TINY widened to 256/512 so every contract dim
divides int4's 128) goes to both packages in fp32, as a full-precision,
an int8 and an int4 tree: the logits of the plain forward and of the
prefill agree within 1e-4, and greedy generation gives the same tokens as
the reference's default (fused, staged) decode.  The single-token step
on its fixed buffers (a device-tensor fill index, `DecodeStep`), run
eagerly, gives the reference `generate`'s greedy tokens with
`unroll_layers` True and False; a rewind moves both copies of the fill
index.  The decode bench's, the 13B example's and the speculative
demo's configs and roofline bytes match the reference scripts'
arithmetic.  Tensor-parallel decode (`generate(mesh=)`) runs on two gloo
processes at tensor 2 for the fused full-precision and int4 trees: the
reference `generate`'s greedy tokens exactly, the gathered prefill
logits within 1e-5, the same tokens on both ranks."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import quant as jquant
from kubeflow_tpu.models.configs import LLAMA2_7B as JLLAMA2_7B
from kubeflow_tpu.models.configs import TINY as JTINY
from kubeflow_tpu.models.generate import decode_config as jdecode_config
from kubeflow_tpu.models.generate import generate as jgenerate
from kubeflow_tpu.models.generate import prepare_decode as jprepare_decode
from kubeflow_tpu.models.generate import sample_token as jsample_token
from kubeflow_tpu.models.transformer import Transformer as JTransformer
from kubeflow_tpu.ops import attention as jattention
from kubeflow_tpu.runtime import roofline as jroofline
from kubeflow_tpu_torch import dryrun
from kubeflow_tpu_torch.models import quant
from kubeflow_tpu_torch.models.configs import LLAMA2_7B, TINY
from kubeflow_tpu_torch.models.convert import params_from_flax, to_tensor
from kubeflow_tpu_torch.models.generate import (
    DecodeStep,
    decode_config,
    generate,
    prepare_decode,
    sample_token,
    unroll_params,
)
from kubeflow_tpu_torch.models.speculative import rewind
from kubeflow_tpu_torch.ops import attention
from kubeflow_tpu_torch.runtime import roofline


def _cfg(port: bool, **kw):
    base = TINY if port else JTINY
    return base.with_(embed_dim=256, mlp_dim=512, num_heads=4,
                      num_kv_heads=2, head_dim=64, **kw)


def _random_tree(cfg, seed: int) -> dict:
    """The reference Transformer's param tree for `cfg`, filled from numpy:
    kernels N(0, 0.05^2), embedding N(0, 1), norm scales 1 + N(0, 0.1^2)."""
    import flax.linen as nn

    abstract = nn.unbox(jax.eval_shape(
        lambda: JTransformer(cfg).init(jax.random.PRNGKey(0),
                                       jnp.ones((1, 8), jnp.int32))))["params"]
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            v = 1.0 + 0.1 * rs.standard_normal(leaf.shape)
        elif "embedding" in name:
            v = rs.standard_normal(leaf.shape)
        else:
            v = 0.05 * rs.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, abstract)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def stacked_tree():
    """scan_layers=True training tree (stacked `layers`)."""
    return _random_tree(_cfg(False), seed=0)


@pytest.fixture(scope="module")
def trees(stacked_tree):
    """name -> (weight_dtype, decode-layout reference tree): the
    full-precision tree fused by prepare_decode, int8 and int4 trees
    quantized after fusing, and an int4 tree of the unfused layout."""
    _, fused = jprepare_decode(_cfg(False), stacked_tree)
    fused = _np(fused)
    return {
        "full": ("", fused),
        "int8": ("int8", _np(jquant.quantize_params(fused))),
        "int4": ("int4", _np(jquant.quantize_params_int4(fused))),
        "int4-unfused": ("int4",
                         _np(jquant.quantize_params_int4(stacked_tree))),
    }


def _decode_cfgs(name, trees):
    wd, tree = trees[name]
    fused = "qkv" in tree["layer_0"]["attn"]
    jcfg = jdecode_config(_cfg(False, weight_dtype=wd)).with_(
        fused_projections=fused)
    cfg = decode_config(_cfg(True, weight_dtype=wd)).with_(
        fused_projections=fused)
    return jcfg, cfg, tree


TREES = ["full", "int8", "int4", "int4-unfused"]


def test_configs_match_reference():
    for port, ref in [(TINY, JTINY), (LLAMA2_7B, JLLAMA2_7B)]:
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert dataclasses.asdict(decode_config(port)) == \
            dataclasses.asdict(jdecode_config(ref))
        assert port.num_params == ref.num_params


def _bits(a) -> np.ndarray:
    """Raw bytes of a numpy/ml_dtypes array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy().view(np.uint8).ravel()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).ravel()


def _flax_leaf(tree, name: str):
    """The flax leaf behind a port parameter name (layers.3.x -> layer_3)."""
    parts = name.split(".")
    if parts[0] == "layers":
        parts = [f"layer_{parts[1]}"] + parts[2:]
    for key in parts:
        tree = tree[key]
    return tree


def test_converter_round_trip(stacked_tree, trees):
    """The stacked tree and its layer_i unrolling load into the same port
    model, and every parameter of the int8/int4 models comes back with the
    flax leaf's dtype and bytes."""
    stacked = params_from_flax(stacked_tree, _cfg(True), device="cpu")
    unrolled = params_from_flax(unroll_params(stacked_tree), _cfg(True),
                                device="cpu")
    for (name, a), (_, b) in zip(stacked.state_dict().items(),
                                 unrolled.state_dict().items()):
        assert torch.equal(a, b), name
        np.testing.assert_array_equal(
            a.numpy(), _flax_leaf(unroll_params(stacked_tree), name))
    for name in ("int8", "int4"):
        _, pcfg, tree = _decode_cfgs(name, trees)
        state = params_from_flax(tree, pcfg, device="cpu").state_dict()
        assert len(state) == len(jax.tree.leaves(tree))
        for key, value in state.items():
            leaf = _flax_leaf(tree, key)
            assert value.shape == leaf.shape, key
            np.testing.assert_array_equal(_bits(value), _bits(leaf),
                                          err_msg=key)


@pytest.mark.parametrize("quantizer", ["quantize_params",
                                       "quantize_params_int4"])
def test_quantized_trees_bytes_identical(quantizer, stacked_tree):
    """The stacked training tree through both packages' quantizers: every
    leaf byte-identical, and the same streamed and resident bytes."""
    want = _np(getattr(jquant, quantizer)(stacked_tree))
    got = getattr(quant, quantizer)(jax.tree.map(to_tensor, stacked_tree))
    want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    got_flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(want_flat) == len(got_flat)
    for path, leaf in want_flat:
        np.testing.assert_array_equal(_bits(got_flat[path]), _bits(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    assert quant.quantized_bytes(got) == jquant.quantized_bytes(want)
    assert quant.quantized_bytes(got, exclude=()) == \
        jquant.quantized_bytes(want, exclude=())


def test_bf16_leaves_convert_exactly():
    a = np.random.RandomState(1).standard_normal((3, 5)).astype(np.float32)
    b = np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
    t = to_tensor(b)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), b.astype(np.float32))


def test_forward_logits_match(stacked_tree):
    """Non-decode forward (xla attention, stacked tree) in fp32."""
    tokens = np.random.RandomState(2).randint(0, 256, (2, 12))
    want = JTransformer(_cfg(False)).apply({"params": stacked_tree}, tokens)
    model = params_from_flax(stacked_tree, _cfg(True), device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def _run_both(jcfg, cfg, tree, calls):
    """Feed the same token chunks through the reference's cache (staged
    when jcfg says so) and the port's in-place cache; yield both logits."""
    jmodel = JTransformer(jcfg)
    japply = jax.jit(lambda v, t, p: jmodel.apply(
        v, t, return_aux=True, decode=True, positions=p, mutable=["cache"]))
    model = params_from_flax(tree, cfg, device="cpu")
    cache = model.new_cache(calls[0].shape[0])
    jvars, pos = {"params": tree}, 0
    for toks in calls:
        positions = np.broadcast_to(np.arange(pos, pos + toks.shape[1]),
                                    toks.shape)
        (want, _), mutated = japply(jvars, toks, positions)
        jvars = {"params": tree, **mutated}
        with torch.no_grad():
            got = model(torch.from_numpy(toks),
                        positions=torch.from_numpy(positions.copy()),
                        cache=cache)
        pos += toks.shape[1]
        assert cache.index == pos
        yield got.numpy(), np.asarray(want)


@pytest.mark.parametrize("name", TREES)
def test_prefill_logits_match(name, trees):
    jcfg, cfg, tree = _decode_cfgs(name, trees)
    prompt = np.random.RandomState(3).randint(0, 256, (2, 6))
    for got, want in _run_both(jcfg, cfg, tree, [prompt]):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_chunked_decode_matches_staged_cache(trees):
    """Prefill of 5 tokens, a single-token step, then a 3-token call at
    cur=6: the reference flushes its 8-row stage around the multi-token
    call; the port's in-place cache must hold the same logical rows."""
    jcfg, cfg, tree = _decode_cfgs("int4", trees)
    assert jcfg.staged_kv
    rs = np.random.RandomState(9)
    calls = [rs.randint(0, 256, (2, n)) for n in (5, 1, 3)]
    for got, want in _run_both(jcfg, cfg, tree, calls):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", TREES)
def test_greedy_generate_tokens_equal(name, trees):
    wd, tree = trees[name]
    prompt = np.random.RandomState(4).randint(0, 256, (2, 5))
    want = jgenerate(_cfg(False, weight_dtype=wd), tree, jnp.asarray(prompt),
                     max_new_tokens=8)
    got = generate(_cfg(True, weight_dtype=wd), tree, prompt,
                   max_new_tokens=8, device="cpu")
    assert got.shape == (2, 13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


TP_TREES = ["full", "int4"]
TP_NEW = 8


@pytest.fixture(scope="module")
def tensor_parallel(trees):
    """One launch of two gloo processes (tensor 2) decoding both fused
    trees: the prompt and, per tree, the gathered prefill logits and
    every rank's tokens."""
    prompt = np.random.RandomState(21).randint(0, 256, (2, 6))
    cases = [(_cfg(True, weight_dtype=trees[n][0]),
              jax.tree.map(to_tensor, trees[n][1])) for n in TP_TREES]
    results = dryrun.launch(2, dryrun.tensor_decode,
                            (cases, torch.from_numpy(prompt), TP_NEW),
                            timeout=300)
    return prompt, dict(zip(TP_TREES, results))


@pytest.mark.parametrize("name", TP_TREES)
def test_tensor_parallel_generate_matches_reference(name, trees,
                                                    tensor_parallel):
    """At tensor 2 (heads, kv heads, MLP and vocabulary split, the fused
    qkv and int4 gate_up regrouped per rank), the reference `generate`'s
    greedy tokens exactly on both ranks, and the prefill logits gathered
    over "tensor" within 1e-5 of the reference's."""
    prompt, results = tensor_parallel
    wd, tree = trees[name]
    jcfg, _, _ = _decode_cfgs(name, trees)
    want = jgenerate(_cfg(False, weight_dtype=wd), tree, jnp.asarray(prompt),
                     max_new_tokens=TP_NEW)
    (want_logits, _), _ = JTransformer(jcfg).apply(
        {"params": tree}, jnp.asarray(prompt), return_aux=True, decode=True,
        mutable=["cache"])
    got = results[name]
    first, second = got["tokens"]
    assert first.shape == (2, 6 + TP_NEW)
    assert torch.equal(first, second)
    np.testing.assert_array_equal(first.numpy(), np.asarray(want))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want_logits),
                               atol=1e-5, rtol=0)


def test_prepare_decode_matches_reference(stacked_tree):
    jcfg, jtree = jprepare_decode(_cfg(False), stacked_tree)
    tree = {k: v for k, v in stacked_tree.items()}
    cfg, ptree = prepare_decode(_cfg(True), tree)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert jax.tree.structure(ptree) == jax.tree.structure(_np(jtree))
    for a, b in zip(jax.tree.leaves(ptree), jax.tree.leaves(_np(jtree))):
        np.testing.assert_array_equal(a, b)


def test_decode_attention_matches():
    rs = np.random.RandomState(5)
    q = rs.standard_normal((2, 3, 4, 16)).astype(np.float32)
    kc = rs.standard_normal((2, 2, 10, 16)).astype(np.float32)
    vc = rs.standard_normal((2, 2, 10, 16)).astype(np.float32)
    want = jattention.decode_attention(q, kc, vc, q_offset=4)
    got = attention.decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                                     q_offset=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    k = rs.standard_normal((2, 6, 2, 16)).astype(np.float32)
    v = rs.standard_normal((2, 6, 2, 16)).astype(np.float32)
    q6 = rs.standard_normal((2, 6, 4, 16)).astype(np.float32)
    want = jattention.xla_attention(q6, k, v, causal=True)
    got = attention.xla_attention(*map(torch.from_numpy, (q6, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_top_k_samples_stay_in_top_k():
    logits = np.random.RandomState(6).standard_normal((4, 50)) \
        .astype(np.float32)
    top = np.argsort(logits, axis=-1)[:, -5:]
    gen = torch.Generator().manual_seed(0)
    seen = [set() for _ in range(4)]
    for i in range(200):
        got = sample_token(torch.from_numpy(logits), gen, 1.0, top_k=5)
        want = jsample_token(jnp.asarray(logits), jax.random.PRNGKey(i),
                             1.0, top_k=5) if i < 20 else None
        for b in range(4):
            assert int(got[b]) in top[b]
            seen[b].add(int(got[b]))
            if want is not None:
                assert int(want[b]) in top[b]
    assert all(s == set(t) for s, t in zip(seen, top))
    # greedy: temperature 0 is the argmax on both sides
    np.testing.assert_array_equal(
        sample_token(torch.from_numpy(logits), gen, 0.0).numpy(),
        np.asarray(jsample_token(jnp.asarray(logits), None, 0.0)))


def test_sampled_generate_stays_in_vocab(trees):
    _, tree = trees["full"]
    prompt = np.random.RandomState(7).randint(0, 256, (2, 5))
    gen = torch.Generator().manual_seed(1)
    out = generate(_cfg(True), tree, prompt, max_new_tokens=6,
                   temperature=0.8, top_k=3, generator=gen, device="cpu")
    assert out.shape == (2, 11)
    np.testing.assert_array_equal(out[:, :5].numpy(), prompt)
    assert int(out.min()) >= 0 and int(out.max()) < 256


def test_decode_roofline_matches_reference():
    cfg = decode_config(LLAMA2_7B).with_(max_seq_len=256, weight_dtype="int4")
    jcfg = jdecode_config(JLLAMA2_7B).with_(max_seq_len=256,
                                           weight_dtype="int4")
    assert roofline.decode_weight_stream_bytes(cfg) == \
        jroofline.decode_weight_stream_bytes(jcfg)
    assert roofline.decode_kv_bytes(cfg, 16) == \
        jroofline.decode_kv_bytes(jcfg, 16)
    assert roofline.decode_step_flops(cfg, 16) == \
        jroofline.decode_step_flops(jcfg, 16)
    est = roofline.decode_estimate(cfg, 16, "NVIDIA H100 80GB HBM3")
    want = jroofline.decode_estimate(jcfg, 16)
    assert est.hbm_bytes == want.hbm_bytes and est.flops == want.flops
    assert est.bound == "memory"
    assert est.memory_floor_s == pytest.approx(est.hbm_bytes / 3.35e12)
    unknown = roofline.decode_estimate(cfg, 16, "some other card")
    assert unknown.step_floor_s is None and unknown.bound is None
    assert unknown.to_dict()["tokens_per_s_ceiling"] is None


def test_quantized_layers_pick_the_plain_version_on_cpu(trees):
    """The int4 model on CPU tensors runs the plain version; the layer's
    `plain` switch gives the same result."""
    _, cfg, tree = _decode_cfgs("int4", trees)
    model = params_from_flax(tree, cfg, device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(8).randint(0, 256, (1, 4)))
    with torch.no_grad():
        a = model(tokens)
        for mod in model.modules():
            if isinstance(mod, quant.Int4Linear):
                mod.plain = True
        b = model(tokens)
    assert torch.equal(a, b)


@pytest.mark.parametrize("unroll", [True, False])
def test_decode_step_matches_reference_generate(unroll, stacked_tree):
    """Prefill, then `DecodeStep` called eagerly on its fixed buffers
    (last token, device fill index, output tokens): the reference
    `generate`'s greedy tokens, exactly, for the unrolled (fused) and the
    scanned (unfused) decode layout; `generate` gives the same."""
    from kubeflow_tpu_torch.models.convert import params_from_flax

    prompt = np.random.RandomState(11).randint(0, 256, (2, 5))
    new = 9
    want = np.asarray(jgenerate(_cfg(False), stacked_tree,
                                jnp.asarray(prompt), max_new_tokens=new,
                                unroll_layers=unroll))
    cfg, tree = prepare_decode(_cfg(True), stacked_tree,
                               unroll_layers=unroll)
    assert cfg.fused_projections == unroll
    model = params_from_flax(tree, cfg, device="cpu")
    with torch.inference_mode():
        cache = model.new_cache(2)
        tokens = torch.zeros((2, 5 + new), dtype=torch.int64)
        tokens[:, :5] = torch.from_numpy(prompt)
        tokens[:, 5] = model(tokens[:, :5], cache=cache)[:, -1].argmax(-1)
        step = DecodeStep(model, cache, tokens)
        for i in range(new - 1):
            step()
            assert cache.index == 6 + i and int(cache.pos) == 6 + i
    np.testing.assert_array_equal(tokens.numpy(), want)
    got = generate(_cfg(True), stacked_tree, prompt, max_new_tokens=new,
                   unroll_layers=unroll, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_rewind_after_tensor_position_write(trees):
    """A prefill of 5 tokens, a rewind to 3 (both the device index and its
    host mirror), and one token written at tensor position 3: the same
    logits as a fresh cache fed the first 3 tokens and that one, within
    1e-5, and row 3 of every layer's cache holds the new token's keys."""
    _, cfg, tree = _decode_cfgs("full", trees)
    model = params_from_flax(tree, cfg, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(12).randint(0, 256,
                                                              (2, 5)))
    x = torch.tensor([[7], [9]])
    with torch.inference_mode():
        cache = model.new_cache(2)
        model(toks, cache=cache)
        stale = cache.k[0][:, :, 3].clone()
        rewind(cache, 3)
        assert cache.index == 3 and int(cache.pos) == 3
        got = model(x, positions=cache.pos.expand(2, 1), cache=cache)
        assert cache.index == 4 and int(cache.pos) == 4
        fresh = model.new_cache(2)
        want = model(torch.cat([toks[:, :3], x], dim=1), cache=fresh)
        assert not torch.equal(cache.k[0][:, :, 3], stale)
        for i in range(cfg.num_layers):
            torch.testing.assert_close(cache.k[i][:, :, :4],
                                       fresh.k[i][:, :, :4],
                                       atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[:, -1].numpy(), want[:, -1].numpy(),
                               atol=1e-5, rtol=0)


def test_decode_attention_takes_a_tensor_offset():
    """q_offset as a 0-dim int64 tensor (the cache's fill index) gives
    the reference's output, as the int does."""
    rs = np.random.RandomState(13)
    q = rs.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rs.standard_normal((2, 2, 10, 16)).astype(np.float32)
    vc = rs.standard_normal((2, 2, 10, 16)).astype(np.float32)
    want = jattention.decode_attention(q, kc, vc, q_offset=6)
    got = attention.decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                                     q_offset=torch.tensor(6))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_decode_bench_config_and_roofline_match_reference():
    """bench --decode's model (`decode_config(BENCH_CHIP)`, max_seq_len
    384) and its roofline: the bf16 and int4 trees' streamed bytes (the
    embedding excluded), the KV bytes and the step's bytes, as the
    reference bench computes them, on a TINY-width tree of the same
    layout (the full tree is 0.47 B parameters)."""
    from kubeflow_tpu.models.configs import BENCH_CHIP as JBENCH
    from kubeflow_tpu_torch.models.configs import BENCH_CHIP

    cfg = decode_config(BENCH_CHIP).with_(max_seq_len=384)
    jcfg = jdecode_config(JBENCH).with_(max_seq_len=384)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert roofline.decode_kv_bytes(cfg, 16) == \
        jroofline.decode_kv_bytes(jcfg, 16)
    _, fused = jprepare_decode(_cfg(False), _random_tree(_cfg(False), 14))
    bf16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), fused)
    ported = jax.tree.map(lambda a: to_tensor(np.asarray(a)), _np(bf16))
    for jtree, tree in ((bf16, ported),
                        (jquant.quantize_params_int4(bf16),
                         quant.quantize_params_int4(ported))):
        want = jquant.quantized_bytes(jtree, exclude=("embed",))
        assert quant.quantized_bytes(tree, exclude=("embed",)) == want
        est = roofline.decode_estimate(cfg, 16, "NVIDIA H100 80GB HBM3",
                                       param_bytes=want)
        jest = jroofline.decode_estimate(jcfg, 16, param_bytes=want)
        assert est.hbm_bytes == jest.hbm_bytes


def test_llama13b_and_demo_configs_match_reference_scripts():
    """The 13B example's decode config and int4 + KV roofline, and the
    speculative demo's target and draft, as ci/llama13b_decode.py and
    ci/speculative_demo.py build them.  The 13B int4 bytes come from the
    port's model on the meta device against the reference's quantizer
    arithmetic over its decode tree's shapes (K/2 x N packed bytes and
    K/64 x N bf16 scales a kernel, norms as stored, the embedding
    excluded)."""
    from kubeflow_tpu.models.configs import BENCH_CHIP as JBENCH
    from kubeflow_tpu.models.configs import LLAMA2_13B as J13B
    from kubeflow_tpu_torch.examples import llama13b_decode, speculative_demo
    from kubeflow_tpu_torch.models.convert import flax_tree
    from kubeflow_tpu_torch.models.transformer import Transformer

    cfg = llama13b_decode.config()
    jcfg = jdecode_config(J13B).with_(max_seq_len=256, weight_dtype="int4")
    assert dataclasses.asdict(cfg) == {**dataclasses.asdict(jcfg),
                                       "param_dtype": "bfloat16"}
    abstract = jax.eval_shape(lambda: JTransformer(
        jdecode_config(J13B).with_(max_seq_len=256)).init(
            jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32)))["params"]

    def int4_bytes(node, name=""):
        if name == "embed":
            return 0
        if "kernel" in node:
            k = node["kernel"]
            k = k.value if hasattr(k, "value") else k
            contract = 2 if name == "out" else 1
            n_in = int(np.prod(k.shape[:contract]))
            n_out = int(np.prod(k.shape[contract:]))
            return n_in // 2 * n_out + n_in // 64 * n_out * 2
        if "scale" in node:
            return int(np.prod(node["scale"].value.shape
                               if hasattr(node["scale"], "value")
                               else node["scale"].shape)) * 4
        return sum(int4_bytes(v, k) for k, v in node.items())

    model = Transformer(cfg, device="meta")
    tree = flax_tree(model)
    norms = sum(v.numel() for k, v in model.state_dict().items()
                if k.endswith("scale") and "norm" in k)
    # the port stores norm scales in fp32 as the reference does
    assert quant.quantized_bytes(tree) == int4_bytes(abstract)
    assert norms == cfg.embed_dim * (2 * cfg.num_layers + 1)
    w, kv = quant.quantized_bytes(tree), roofline.decode_kv_bytes(cfg, 16)
    want_kv = (2 * 16 * jcfg.max_seq_len * jcfg.num_kv_heads
               * jcfg.head_dim * 2 * jcfg.num_layers)
    assert kv == want_kv
    assert llama13b_decode.roofline_tok_s(w, kv, 16, 3350.0) == \
        pytest.approx(3350.0 * 1e9 / (w + kv) * 16)
    target, draft = speculative_demo.configs()
    jtarget = JBENCH.with_(vocab_size=1024, max_seq_len=2048, loss_chunks=16)
    assert dataclasses.asdict(target) == dataclasses.asdict(jtarget)
    assert dataclasses.asdict(draft) == dataclasses.asdict(
        jtarget.with_(num_layers=2))
