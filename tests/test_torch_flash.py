"""The port's flash attention against the reference package.

The same numpy inputs go through the JAX functions and the port's plain
versions of the Hopper kernels (the CUDA kernels themselves run only on a
card, in chip_smoke.py):

- against the Pallas TPU flash kernels, forward and both backward kernels,
  run in TPU interpret mode, in bf16, at ci/flash_numerics.py's limits
  (3e-2 forward, 6e-2 gradients: the same rounding points summed in
  another order);
- against xla_attention and its vjp in fp32, at 1e-5 (the same function);
- FlashAttention through torch.autograd.gradcheck in float64;
- the attention() dispatch rules of the port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kubeflow_tpu.models.configs import TINY
from kubeflow_tpu.ops.attention import flash_attention as jax_flash
from kubeflow_tpu.ops.attention import xla_attention as jax_xla
from kubeflow_tpu_torch.models.convert import to_tensor
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.ops.attention import attention, xla_attention

FWD_TOL, GRAD_TOL = 3e-2, 6e-2   # ci/flash_numerics.py


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs several CPU workers at once,
    and more threads only oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _inputs(shape, seed: int, dtype):
    batch, seq, heads, kv_heads, dim = shape
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((batch, seq, heads, dim))
    k = rs.standard_normal((batch, seq, kv_heads, dim))
    v = rs.standard_normal((batch, seq, kv_heads, dim))
    g = rs.standard_normal((batch, seq, heads, dim))
    return [jnp.asarray(x, dtype) for x in (q, k, v, g)]


def _max_err(got: torch.Tensor, want) -> float:
    return float(np.max(np.abs(got.float().numpy()
                               - np.asarray(want, np.float32))))


@pytest.mark.parametrize("shape,causal", [
    pytest.param((1, 256, 2, 1, 128), True, id="shape0"),
    pytest.param((1, 256, 4, 4, 64), True, id="shape1"),
    pytest.param((1, 256, 2, 1, 128), False, id="noncausal"),
    pytest.param((1, 256, 4, 2, 64), True, id="d64-gqa"),
    pytest.param((1, 256, 4, 4, 64), False, id="d64-noncausal"),
])
def test_plain_versions_match_interpreted_pallas_kernels(shape, causal):
    """bf16: the plain forward and backward against the Pallas forward,
    dK/dV and dQ kernels (jax.vjp of the reference's flash_attention),
    causal or not, head dim 128 or 64, with and without GQA: the plain
    versions are what the CUDA kernels are held to on the card."""
    q, k, v, g = _inputs(shape, seed=shape[2], dtype=jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(
            lambda a, b, c: jax_flash(a, b, c, causal=causal), q, k, v)
        grads = vjp(g)
    tq, tk, tv, tg = (to_tensor(np.asarray(x)) for x in (q, k, v, g))
    scale = shape[-1] ** -0.5
    o, lse = fa.flash_forward_reference(tq, tk, tv, scale, causal)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert lse.shape == (shape[0], shape[2], shape[1])
    assert _max_err(o, out) <= FWD_TOL
    dq, dk, dv = fa.flash_backward_reference(tq, tk, tv, o, lse, tg, scale,
                                             causal)
    for got, want in zip((dq, dk, dv), grads):
        assert got.dtype == torch.bfloat16
        assert tuple(got.shape) == want.shape
        assert _max_err(got, want) <= GRAD_TOL


@pytest.mark.parametrize("seq", [64, 128, 192, 320])
def test_plain_versions_match_xla_attention_fp32(seq):
    """fp32 at TINY's widths (4 query heads, 2 kv heads, head dim 16): the
    same function as xla_attention and its vjp, to 1e-5; 64, 192 and 320
    are lengths the kernels' 128-row tiles cover with half a tile past the
    end (in the dQ kernel the second consumer of that block has no row)."""
    shape = (2, seq, TINY.num_heads, TINY.num_kv_heads, TINY.head_dim)
    q, k, v, g = _inputs(shape, seed=seq, dtype=jnp.float32)
    out, vjp = jax.vjp(lambda a, b, c: jax_xla(a, b, c, causal=True),
                       q, k, v)
    grads = vjp(g)
    tq, tk, tv, tg = (to_tensor(np.asarray(x)) for x in (q, k, v, g))
    scale = TINY.head_dim ** -0.5
    o, lse = fa.flash_forward_reference(tq, tk, tv, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), rtol=1e-5,
                               atol=1e-5)
    for got, want in zip(fa.flash_backward_reference(tq, tk, tv, o, lse, tg,
                                                     scale), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_autograd_function_matches_xla_attention_fp32():
    """flash_attention's autograd (the custom op forward, the plain
    backward) gives xla_attention's output and gradients."""
    shape = (1, 64, 4, 2, 16)
    q, k, v, g = (to_tensor(np.asarray(x)).requires_grad_()
                  for x in _inputs(shape, seed=3, dtype=jnp.float32))
    o = fa.flash_attention(q, k, v)
    grads = torch.autograd.grad(o, (q, k, v), g)
    o_x = xla_attention(q, k, v, causal=True)
    grads_x = torch.autograd.grad(o_x, (q, k, v), g)
    torch.testing.assert_close(o, o_x, rtol=1e-5, atol=1e-5)
    for got, want in zip(grads, grads_x):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_gradcheck_float64(causal):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 16, 2, 8), generator=gen, dtype=torch.float64)
    k = torch.randn((1, 16, 1, 8), generator=gen, dtype=torch.float64)
    v = torch.randn((1, 16, 1, 8), generator=gen, dtype=torch.float64)
    inputs = tuple(t.requires_grad_() for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, causal=causal), inputs)


class TestDispatch:
    def _qkv(self, seq=128, dim=16):
        gen = torch.Generator().manual_seed(1)
        return [torch.randn((1, seq, 2, dim), generator=gen)
                for _ in range(3)]

    def test_auto_on_cpu_is_xla(self, monkeypatch):
        calls = []
        monkeypatch.setattr(fa, "flash_forward_reference",
                            lambda *a, **k: calls.append(1))
        q, k, v = self._qkv()
        out = attention(q, k, v, impl="auto")
        assert not calls
        torch.testing.assert_close(out, xla_attention(q, k, v))

    def test_flash_on_cpu_is_the_plain_version(self, monkeypatch):
        calls = []
        real = fa.flash_forward_reference

        def counted(*args, **kwargs):
            calls.append(1)
            return real(*args, **kwargs)

        monkeypatch.setattr(fa, "flash_forward_reference", counted)
        # a shape the kernels would refuse (head dim 16, seq 96) is fine
        # for the plain version
        q, k, v = self._qkv(seq=96)
        out = attention(q, k, v, impl="flash")
        assert calls == [1]
        torch.testing.assert_close(out, xla_attention(q, k, v), rtol=1e-5,
                                   atol=1e-5)

    def test_ring_raises_and_unknown_impl_raises(self):
        q, k, v = self._qkv()
        # on one rank (no sequence group) the ring is exact attention over
        # the whole sequence; a q_offset, which the ring does not take,
        # raises, as does an unknown impl
        torch.testing.assert_close(attention(q, k, v, impl="ring"),
                                   xla_attention(q, k, v), rtol=1e-5,
                                   atol=1e-5)
        with pytest.raises(ValueError):
            attention(q, k, v, impl="ring", q_offset=4)
        with pytest.raises(ValueError):
            attention(q, k, v, impl="pallas")

    def test_flash_refuses_q_offset(self):
        q, k, v = self._qkv()
        with pytest.raises(ValueError):
            attention(q, k, v, impl="flash", q_offset=4)

    @pytest.mark.parametrize("shape,reason", [
        ((1, 100, 2, 2, 128), "multiple of 64"),
        ((1, 128, 2, 2, 96), "head dim"),
        ((1, 128, 3, 2, 128), "kv heads"),
        ((1, 320, 2, 2, 128), None),
    ])
    def test_kernel_shape_rules(self, shape, reason):
        """What the CUDA kernels refuse, checked before any launch.  The
        sequence need only be a multiple of 64: at 320 the forward's and
        dK/dV's last 128-row tile runs half past the end, and is taken."""
        batch, seq, heads, kv_heads, dim = shape
        q = torch.zeros((batch, seq, heads, dim), dtype=torch.bfloat16)
        k = torch.zeros((batch, seq, kv_heads, dim), dtype=torch.bfloat16)
        if reason is None:
            assert fa.unsupported(q, k, k) is None
            return
        assert reason in fa.unsupported(q, k, k)
        with pytest.raises(ValueError, match=reason):
            fa.flash_forward(q, k, k, 1.0)

    def test_kernel_takes_the_main_path_shape(self):
        q = torch.zeros((1, 2048, 12, 128), dtype=torch.bfloat16)
        assert fa.unsupported(q, q, q) is None
        assert fa.unsupported(q.float(), q, q) is not None
