"""The port's int4/int8 layers and quantizers against the reference package.

The same numpy inputs (numpy.random.RandomState) go through the JAX
function and its port: the plain version of the int4 dequant-matmul
against the reference's CPU fallback (fp32, 1e-5) and against the Pallas
kernel itself run in TPU interpret mode (bf16, 1e-2 relative: the same
rounding points summed in another order); the quantizers byte for byte.
The CUDA kernel itself runs only on a card (chip_smoke.py); its tile and
split planner and its contract checks are plain Python and are held
here."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kubeflow_tpu.models import quant as jquant
from kubeflow_tpu.ops.int4_matmul import int4_matmul as pallas_int4_matmul
from kubeflow_tpu.ops.int4_matmul import supported
from kubeflow_tpu_torch.models import quant
from kubeflow_tpu_torch.models.convert import to_tensor
from kubeflow_tpu_torch.ops import int4_matmul as i4
from kubeflow_tpu_torch.ops.int4_matmul import (
    int4_matmul,
    int4_matmul_reference,
    plan,
)

# (M, K, N) of the Llama-2-7B int4 layers at decode and prefill, then the
# kernel's edge shapes (chip_smoke.py's EDGE_SHAPES)
LLAMA_SHAPES = [(m, k, n) for m in (16, 2048)
                for k, n in ((4096, 12288), (4096, 4096), (4096, 22016),
                             (11008, 4096), (4096, 32000))]
EDGE_SHAPES = [(1, 4096, 4096), (17, 1600, 1552), (300, 4096, 4096)]
# the fused int4 layers of `bench --decode`'s BENCH_CHIP and of
# Llama-2-13B at decode and prefill (chip_smoke.py's BENCH_LAYERS and
# LLAMA13B_LAYERS)
PATH_SHAPES = [(m, k, n) for m in (16, 2048)
               for k, n in ((1536, 4608), (1536, 1536), (1536, 12288),
                            (6144, 1536), (1536, 32000), (5120, 15360),
                            (5120, 5120), (5120, 27648), (13824, 5120),
                            (5120, 32000))]


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _torch(tree):
    return jax.tree.map(to_tensor, tree)


def _bits(a) -> np.ndarray:
    """Raw bytes of a numpy/ml_dtypes array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy().view(np.uint8).ravel()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).ravel()


def _packed(k_dim: int, n: int, seed: int):
    rs = np.random.RandomState(seed)
    kernel = (rs.standard_normal((k_dim, n)) * 0.05).astype(np.float32)
    return _np(jquant._quantize_kernel_int4(kernel))


def _rel_err(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


class TestPlainVersion:
    @pytest.mark.parametrize("m,k_dim,n", [(3, 256, 96), (16, 512, 128),
                                           (5, 128, 40)])
    def test_fp32_matches_reference_fallback(self, m, k_dim, n):
        """fp32 x: the plain version is the reference's CPU fallback."""
        pk = _packed(k_dim, n, seed=m)
        x = np.random.RandomState(7).standard_normal((m, k_dim)) \
            .astype(np.float32)
        want = jquant.Int4DenseGeneral(n, dtype=jnp.float32).apply(
            {"params": pk}, x)
        got = int4_matmul_reference(torch.from_numpy(x),
                                    to_tensor(pk["kernel_q4"]),
                                    to_tensor(pk["kernel_scale"]))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("m,k_dim,n", [(16, 512, 384), (32, 256, 128),
                                           (48, 384, 256)])
    def test_bf16_matches_interpreted_pallas_kernel(self, m, k_dim, n):
        """bf16 x: the plain version keeps the TPU kernel's rounding
        points; the kernel runs in TPU interpret mode on the CPU."""
        assert supported(m, k_dim, n, quant.INT4_GROUP)
        pk = _packed(k_dim, n, seed=k_dim)
        x = np.random.RandomState(m).standard_normal((m, k_dim)) \
            .astype(np.float32)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        with pltpu.force_tpu_interpret_mode():
            want = pallas_int4_matmul(xb, pk["kernel_q4"], pk["kernel_scale"],
                                      group=quant.INT4_GROUP)
        xt = to_tensor(np.asarray(xb))
        got = int4_matmul_reference(xt, to_tensor(pk["kernel_q4"]),
                                    to_tensor(pk["kernel_scale"]))
        assert got.dtype == torch.bfloat16 and got.shape == (m, n)
        want = np.asarray(want, np.float32)
        got32 = got.float().numpy()
        assert _rel_err(got32, want) < 1e-2
        # the products are the same bf16 values summed in fp32, so the two
        # differ only where the sums' order moves a bf16 rounding: at most
        # one bf16 unit in the last place, and almost never
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
        assert np.all(np.abs(got32 - want) <= ulp)
        assert np.mean(got32 == want) >= 0.99
        # on a CPU tensor the wrapper is the plain version, bit for bit
        wrapped = int4_matmul(xt, to_tensor(pk["kernel_q4"]),
                              to_tensor(pk["kernel_scale"]))
        assert torch.equal(wrapped, got)

    def test_wrapper_rejects_bad_shapes(self):
        pk = _torch(_packed(128, 32, seed=0))
        with pytest.raises(ValueError):
            int4_matmul(torch.zeros(2, 64), pk["kernel_q4"],
                        pk["kernel_scale"])
        with pytest.raises(TypeError):
            int4_matmul(torch.zeros(2, 128), pk["kernel_q4"].to(torch.int32),
                        pk["kernel_scale"])
        with pytest.raises(ValueError):
            int4_matmul(torch.zeros(2, 128), pk["kernel_q4"],
                        pk["kernel_scale"][:1])


    @pytest.mark.parametrize("m,k_dim,n", EDGE_SHAPES)
    def test_fp32_matches_reference_at_the_kernels_edge_shapes(self, m, k_dim,
                                                               n):
        """One token, M/K/N ragged against the kernel's tiles, a ragged
        prefill tile: the Pallas kernel does not take these (supported()
        is False), so the reference is the package's XLA path in fp32.
        The tolerance allows for fp32 sums of up to 4096 products taken in
        another order."""
        assert not supported(m, k_dim, n, quant.INT4_GROUP)
        pk = _packed(k_dim, n, seed=n)
        x = np.random.RandomState(m).standard_normal((m, k_dim)) \
            .astype(np.float32)
        if k_dim % (2 * quant.INT4_GROUP) == 0:
            want = jquant.Int4DenseGeneral(n, dtype=jnp.float32).apply(
                {"params": pk}, x)
        else:   # the layer wants K % 128 == 0; the kernel K % 64 == 0
            want = _xla_int4(x, pk["kernel_q4"], pk["kernel_scale"])
        got = int4_matmul(torch.from_numpy(x), to_tensor(pk["kernel_q4"]),
                          to_tensor(pk["kernel_scale"]))
        assert got.shape == (m, n)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def _xla_int4(x, packed, scales):
    """The XLA path of Int4DenseGeneral.__call__
    (kubeflow_tpu/models/quant.py:239-266) in fp32, for a contract size the
    layer's constructor refuses: x_even @ lo + x_odd @ hi, each half
    scaled by its group's scales."""
    k_half, n = packed.shape
    lo = jax.lax.shift_right_arithmetic(
        jax.lax.shift_left(packed, jnp.int8(4)), jnp.int8(4))
    hi = jax.lax.shift_right_arithmetic(packed, jnp.int8(4))
    sc = jnp.asarray(scales).astype(jnp.float32).reshape(-1, 1, n)

    def dequant(part):
        g = part.astype(jnp.float32).reshape(-1, quant.INT4_GROUP // 2, n)
        return (g * sc).reshape(k_half, n)

    return x[:, 0::2] @ dequant(lo) + x[:, 1::2] @ dequant(hi)


def _groups_of(p, groups: int) -> list:
    """The scale groups each split covers, in split order."""
    return [list(range(s * p.groups_per_split,
                       min(groups, (s + 1) * p.groups_per_split)))
            for s in range(p.splits)]


class TestPlan:
    """The kernel's tile and split-K planner, a pure function of (M, K, N,
    SM count)."""

    @pytest.mark.parametrize("sms", [1, 78, 114, 132, 264])
    @pytest.mark.parametrize("m,k_dim,n", LLAMA_SHAPES + EDGE_SHAPES + [
        (16, 1536, 6144), (16, 6144, 1536), (16, 1536, 32000),
        (128, 1536, 1536), (64, 64, 16)] + PATH_SHAPES)
    def test_every_group_is_covered_exactly_once(self, m, k_dim, n, sms):
        p = plan(m, k_dim, n, sms)
        groups = k_dim // i4.GROUP
        covered = _groups_of(p, groups)
        assert all(covered), "no split may be empty"
        flat = [g for run in covered for g in run]
        assert flat == list(range(groups))
        assert p.bm in i4.TOKEN_TILES and p.consumers in (1, 2)
        assert m <= p.bm or p.bm == i4.TOKEN_TILES[-1]
        assert plan(m, k_dim, n, sms) == p   # the same inputs, one plan

    def test_decode_layers_split_and_prefill_does_not(self):
        """On 132 SMs every Llama-2-7B decode layer but the LM head has
        fewer output tiles than the card holds blocks, so K is split;
        prefill's tiles fill the card alone."""
        for m, k_dim, n in LLAMA_SHAPES:
            p = plan(m, k_dim, n, 132)
            if m == 2048 or n == 32000:
                assert p.splits == 1
            else:
                assert p.splits > 1
                tiles = math.ceil(n / (p.consumers * i4.WG_COLS))
                assert tiles * p.splits >= 132

    def test_token_tile(self):
        assert [plan(m, 4096, 4096, 132).bm for m in (1, 16, 17, 64, 65,
                                                      2048)] \
            == [16, 16, 64, 64, 128, 128]
        assert plan(2048, 4096, 4096, 132).consumers == 2


class TestKernelContract:
    """What the CUDA kernel refuses is refused before any launch, with a
    ValueError, and never falls back to the plain version."""

    def _operands(self, m=4, k_dim=128, n=32):
        pk = _torch(_packed(k_dim, n, seed=1))
        return (torch.zeros(m, k_dim, dtype=torch.bfloat16), pk["kernel_q4"],
                pk["kernel_scale"].to(torch.bfloat16))

    def test_accepts_the_contract(self):
        i4._check_kernel(*self._operands())

    def test_n_must_be_a_multiple_of_16(self):
        with pytest.raises(ValueError, match="N % 16"):
            i4._check_kernel(*self._operands(n=40))

    def test_operands_must_be_contiguous(self):
        x, packed, scales = self._operands()
        wide = torch.zeros(4, 256, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="contiguous"):
            i4._check_kernel(wide[:, ::2], packed, scales)

    def test_operands_must_be_16_byte_aligned(self):
        x, packed, scales = self._operands()
        shifted = torch.zeros(4 * 128 + 1, dtype=torch.bfloat16)[1:]
        with pytest.raises(ValueError, match="aligned"):
            i4._check_kernel(shifted.view(4, 128), packed, scales)

    def test_needs_a_token(self):
        x, packed, scales = self._operands()
        with pytest.raises(ValueError, match="M >= 1"):
            i4._check_kernel(x[:0], packed, scales)

    def test_other_devices_raise(self):
        x, packed, scales = (t.to("meta") for t in self._operands())
        with pytest.raises(ValueError, match="cuda or cpu"):
            int4_matmul(x, packed, scales)


class TestInt4Linear:
    @pytest.mark.parametrize("contract,features", [
        ((256,), (96,)),          # [in, out]
        ((256,), (4, 64)),        # q/k/v [D, H, Dh]
        ((2, 64), (96,)),         # out [H, Dh, D]: two contract dims
    ])
    def test_matches_int4_dense_general(self, contract, features):
        rs = np.random.RandomState(3)
        kernel = (rs.standard_normal(contract + features) * 0.05
                  ).astype(np.float32)
        pk = _np(jquant._quantize_kernel_int4(kernel, len(contract)))
        x = rs.standard_normal((2, 3) + contract).astype(np.float32)
        axis = tuple(range(-len(contract), 0))
        want = jquant.Int4DenseGeneral(
            features if len(features) > 1 else features[0], axis=axis,
            dtype=jnp.float32).apply({"params": pk}, x)
        layer = quant.Int4Linear(contract, features, dtype=torch.float32,
                                 device="cpu")
        layer.load_state_dict(_torch(pk))
        got = layer(torch.from_numpy(x))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    def test_contract_must_divide_two_groups(self):
        with pytest.raises(ValueError):
            quant.Int4Linear(64, 32, device="cpu")


class TestQuantizers:
    @pytest.mark.parametrize("shape,n_contract", [((256, 96), 1),
                                                  ((4, 64, 96), 2),
                                                  ((128, 4, 32), 1)])
    def test_int4_kernel_bytes_identical(self, shape, n_contract):
        rs = np.random.RandomState(11)
        kernel = (rs.standard_normal(shape) * 0.05).astype(np.float32)
        # edge cases: an all-zero group (scale clamps to 1e-12) and exact
        # .5 ties of g / scale (round half to even on both sides)
        flat = kernel.reshape(-1, kernel.shape[-1])
        flat[:64, 0] = 0.0
        flat[64:128, 1] = np.array([7.0, 2.5, -3.5, 0.5, -0.5, 1.5] + [0.0]
                                   * 58, np.float32)
        want = _np(jquant._quantize_kernel_int4(kernel, n_contract))
        got = quant.quantize_kernel_int4(torch.from_numpy(kernel),
                                         n_contract)
        for key in ("kernel_q4", "kernel_scale"):
            assert got[key].shape == want[key].shape
            np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]))

    def test_int4_rejects_moe_tree(self):
        tree = {"layer_0": {"moe": {"experts": {"gate": {
            "kernel": torch.zeros(2, 128, 8)}}}}}
        with pytest.raises(ValueError, match="expert"):
            quant.quantize_params_int4(tree)


class TestInt8Linear:
    @pytest.mark.parametrize("contract,features,n_contract", [
        ((256,), (4, 64), 1), ((2, 64), (96,), 2)])
    def test_matches_int8_dense_general(self, contract, features,
                                        n_contract):
        rs = np.random.RandomState(4)
        kernel = (rs.standard_normal(contract + features) * 0.05
                  ).astype(np.float32)
        qk = _np(jquant._quantize_kernel(kernel, n_contract=n_contract))
        x = rs.standard_normal((2, 3) + contract).astype(np.float32)
        axis = tuple(range(-len(contract), 0))
        want = jquant.Int8DenseGeneral(
            features if len(features) > 1 else features[0], axis=axis,
            dtype=jnp.float32).apply({"params": qk}, x)
        layer = quant.Int8Linear(contract, features, dtype=torch.float32,
                                 device="cpu")
        layer.load_state_dict(_torch(qk))
        got = layer(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
