"""The port's serving slice against the reference package, on the CPU.

One numpy-filled param tree (TINY widened to 256/512 so every contract dim
divides int4's 128) goes to both packages in fp32, as a full-precision,
an int8 and an int4 tree: the logits of the plain forward and of the
prefill agree within 1e-4, and greedy generation gives the same tokens as
the reference's default (fused, staged) decode."""

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
from kubeflow_tpu_torch.models import quant
from kubeflow_tpu_torch.models.configs import LLAMA2_7B, TINY
from kubeflow_tpu_torch.models.convert import params_from_flax, to_tensor
from kubeflow_tpu_torch.models.generate import (
    decode_config,
    generate,
    prepare_decode,
    sample_token,
    unroll_params,
)
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
