"""The roofline's counts against counts worked out by hand, two shapes
each."""

import pytest

from benchmark import roofline
from benchmark.shapes import load_shape

H100 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]


def test_flash_counts():
    # B 1, H 1, S 4, D 2: the causal triangle holds 4 * 4 / 2 = 8 query-key
    # pairs, each D = 2 multiply-adds (4 FLOPs) a product: 32 a product
    assert roofline.flash_fwd_flops(1, 1, 4, 2) == 64
    assert roofline.flash_bwd_flops(1, 1, 4, 2) == 160
    # the Mistral cell: 4 rows, 32 heads, 4096, head dim 128:
    # 2 * 4 * 32 * 4096^2 * 128 / 2 = 274,877,906,944 a product
    assert roofline.flash_unit(4, 32, 4096, 128) == 274_877_906_944
    assert roofline.flash_fwd_flops(4, 32, 4096, 128) == 549_755_813_888
    assert roofline.flash_bwd_flops(4, 32, 4096, 128) == 1_374_389_534_720


def test_int4_layer_counts():
    # M 16, K 4096, N 6144 (the fused qkv at batch 16): packed weights
    # 4096 * 6144 / 2 = 12,582,912 B, scales 64 * 6144 * 2 = 786,432 B,
    # x 16 * 4096 * 2 = 131,072 B, out 16 * 6144 * 2 = 196,608 B
    flops, nbytes = roofline.int4_layer(16, 4096, 6144)
    assert flops == 2 * 16 * 4096 * 6144 == 805_306_368
    assert nbytes == 12_582_912 + 786_432 + 131_072 + 196_608
    # M 128, K 128, N 16: 1,024 + 64 + 32,768 + 4,096 bytes
    flops, nbytes = roofline.int4_layer(128, 128, 16)
    assert flops == 524_288
    assert nbytes == 37_952
    t, bound = roofline.least_seconds(*roofline.int4_layer(16, 4096, 6144),
                                      H100)
    assert bound == "bytes" and t == pytest.approx(13_697_024 / 3.35e12)


def test_training_flops_per_token():
    # Mistral stage: a layer's products 4096*4096*2 (q, out)
    # + 4096*1024*2 (k, v) + 3*4096*14336 (SwiGLU) = 218,103,808;
    # 16 layers and the head 4096*32000 = 3,620,732,928; 6x that plus
    # attention 12 * 16 * 4096 * 32 * 128 / 2 = 1,610,612,736
    stage = load_shape("mistral-7b-pp2")
    assert roofline.matmul_params(stage) == 3_620_732_928
    assert roofline.train_flops_per_token(stage, 4096) == \
        6 * 3_620_732_928 + 1_610_612_736
    # Mixtral, 2 layers: attention 41,943,040, two experts 352,321,536,
    # the router 4096*8 = 32,768; with the head 919,666,688
    moe = load_shape("mixtral-8x7b-l2")
    assert roofline.matmul_params(moe) == 919_666_688
    assert roofline.train_flops_per_token(moe, 4096) == \
        6 * 919_666_688 + 12 * 2 * 4096 * 32 * 128 / 2


def test_decode_step_counts():
    full = load_shape("mistral-7b")
    # int4 bytes of one forward at 16 rows: per layer qkv (4096 x 6144),
    # out (4096 x 4096), gate_up (4096 x 28672), down (14336 x 4096),
    # then the head (4096 x 32000)
    kn = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)] * 32 \
        + [(4096, 32000)]
    assert roofline.int4_kernels(full) == kn
    weights = sum(k * n / 2 + k / 64 * n * 2 for k, n in kn)
    acts = sum(16 * k * 2 + 16 * n * 2 for k, n in kn)
    flops, nbytes = roofline.decode_step(full, 16, 299)
    # the cache up to and with position 299: 300 positions of K and V,
    # 32 layers, 16 rows, 8 kv heads of 128, bf16; then one position
    # written; the embedding rows and the 65 norm scales
    kv = 2 * 32 * 16 * 8 * 128 * 2
    assert nbytes == weights + acts + kv * 300 + kv + 16 * 4096 * 2 \
        + 65 * 4096 * 2
    assert flops == sum(2 * 16 * k * n for k, n in kn) \
        + 4 * 32 * 16 * 32 * 128 * 300
    # at batch 1, position 0
    flops, nbytes = roofline.decode_step(full, 1, 0)
    assert nbytes == weights + sum(k * 2 + n * 2 for k, n in kn) \
        + 2 * (2 * 32 * 8 * 128 * 2) + 4096 * 2 + 65 * 4096 * 2
    assert flops == sum(2 * k * n for k, n in kn) + 4 * 32 * 32 * 128


def test_an_unknown_card_has_no_peak():
    assert roofline.peak("NVIDIA H100 PCIe") is None
