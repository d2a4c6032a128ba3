// int4 dequant-matmul for Hopper (sm_90a):  out[M,N] = x[M,K] @ W.
//
// Replaces the Pallas TPU kernel kubeflow_tpu/ops/int4_matmul.py:int4_matmul
// and computes the same function:
//   - W is stored nibble-packed: byte (i, n) of packed[K/2, N] holds
//     W[2i, n] in its low nibble and W[2i+1, n] in its high nibble, each a
//     signed 4-bit value in [-8, 7];
//   - every 64 contract rows share one bf16 scale per column,
//     scales[K/64, N] (the [K/64, 1, N] layout of models/quant.py is the
//     same memory);
//   - each weight is nibble * scale in fp32, rounded to bf16 (the operand
//     the TPU kernel feeds its matrix unit); x * w accumulates in fp32
//     over all of K; the output is written once, as bf16.
// x is read in place, with no even/odd split, and the scales are read in
// place as bf16: the split and the fp32 copy of the scales in the TPU
// version work around Mosaic's lack of int8 shifts and in-VMEM
// interleaving, which a CUDA thread does not need.
//
// What bounds it on an H100:
//   - M = 16 (decode): for the card, device-memory bytes.  The packed
//     weights (K*N/2), the scales (K*N/32) and x and out (a few hundred
//     KB) are each moved once; at 3.35 TB/s a 4096 x 4096 layer needs
//     2.7 us.  The design reads every weight byte exactly once: each
//     thread loads one 32-bit word (4 adjacent columns) per packed row,
//     so a half-warp reads 64 contiguous bytes, and it issues the 32
//     loads of a whole scale group before it uses any of them, to keep
//     many bytes in flight.  The 16 k-slices of a block split K among
//     themselves, so a narrow layer still spreads over many threads.
//     Without tensor cores, though, the 2*M*N*K operations on CUDA cores
//     (about 67 TFLOP/s of fp32) take some 8 us for that layer, longer
//     than its bytes: at decode this design is bound by instructions,
//     not bytes (PERF.md has its times).
//   - M = 2048 (prefill): the CUDA-core FMAs.  Each thread keeps 16 rows
//     x 4 columns of fp32 accumulators in registers, so one dequantized
//     weight feeds 16 FMAs and one staged x value feeds 4.
//   Tensor cores (mma.sync m16n8k16 fits M = 16 exactly, wgmma for
//   prefill), split-K across blocks and TMA loads are left for later
//   work.
//
// Grid: blockIdx.x walks N in tiles of BN = 64 columns, blockIdx.y walks
// M in tiles of BM = 16 rows.  A block of 256 threads is 16 k-slices of
// 16 threads.  Each round the block stages x[BM rows, 16 groups of 64
// contract rows] in shared memory (transposed, so the 16 row values of
// one contract row are 32 contiguous bytes), and slice s multiplies group
// s of the round.  At the end the slices' partial sums are added in a
// fixed tree in shared memory, so the result does not vary from run to
// run.
//
// Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface (int4_matmul_bf16 below),
// loaded by kubeflow_tpu_torch/ops/int4_matmul.py through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 64;               // contract rows per scale
constexpr int HALF = GROUP / 2;         // packed rows per scale group
constexpr int BM = 16;                  // output rows per block
constexpr int COLS = 4;                 // adjacent columns per thread
constexpr int TN = 16;                  // threads across N in one slice
constexpr int BN = TN * COLS;           // output columns per block
constexpr int KS = 16;                  // k-slices per block
constexpr int THREADS = TN * KS;        // 256
constexpr int SLICE_PAD = 8;            // bf16 elements between slices'
                                        // staged rows: keeps the two slices
                                        // of a warp on different banks
constexpr int SLICE_ELEMS = GROUP * BM + SLICE_PAD;
constexpr int STAGE_BYTES = KS * SLICE_ELEMS * 2;
constexpr int RED_BYTES = (KS / 2) * BM * BN * 4;
constexpr int SMEM_BYTES = STAGE_BYTES > RED_BYTES ? STAGE_BYTES : RED_BYTES;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
    return __uint_as_float(bits << 16);
}

__device__ __forceinline__ float round_to_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void load_row(const uint16_t* row, float* vals) {
    // BM = 16 bf16 values = two 16-byte shared-memory loads
    const uint4* p = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const uint4 q = p[h];
        const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            vals[h * 8 + 2 * i] = bf16_bits_to_float(words[i] & 0xFFFFu);
            vals[h * 8 + 2 * i + 1] = bf16_bits_to_float(words[i] >> 16);
        }
    }
}

__global__ void __launch_bounds__(THREADS)
int4_matmul_kernel(const uint16_t* __restrict__ x,
                   const uint8_t* __restrict__ packed,
                   const uint16_t* __restrict__ scales,
                   uint16_t* __restrict__ out, int M, int K, int N) {
    // staged x during the K loop; the fp32 partial sums afterwards
    __shared__ __align__(16) unsigned char smem[SMEM_BYTES];
    uint16_t* xs = reinterpret_cast<uint16_t*>(smem);
    float* red = reinterpret_cast<float*>(smem);

    const int tid = threadIdx.x;
    const int tx = tid % TN;
    const int slice = tid / TN;
    const int n = blockIdx.x * BN + tx * COLS;  // this thread's 1st column
    const int m0 = blockIdx.y * BM;
    const bool col_ok = n < N;  // N % COLS == 0: all four columns exist
    const int groups = K / GROUP;

    float acc[BM][COLS];
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
        for (int j = 0; j < COLS; ++j) acc[m][j] = 0.f;

    for (int g0 = 0; g0 < groups; g0 += KS) {
        __syncthreads();  // the previous round's readers are done
        // stage x[m0:m0+BM, g0*64 : (g0+KS)*64] as xs[slice][row][m];
        // rows past M and groups past K read as 0
        for (int i = tid; i < BM * KS * GROUP; i += THREADS) {
            const int m = i / (KS * GROUP);
            const int kk = i % (KS * GROUP);
            const int gm = m0 + m;
            const int gk = g0 * GROUP + kk;
            xs[(kk / GROUP) * SLICE_ELEMS + (kk % GROUP) * BM + m] =
                (gm < M && gk < K) ? x[(size_t)gm * K + gk] : uint16_t(0);
        }
        __syncthreads();

        const int g = g0 + slice;
        if (g < groups && col_ok) {
            const uint8_t* p = packed + (size_t)g * HALF * N + n;
            uint32_t w[HALF];
#pragma unroll
            for (int r = 0; r < HALF; ++r)
                w[r] = __ldg(reinterpret_cast<const uint32_t*>(
                    p + (size_t)r * N));
            const uint2 s4 = __ldg(reinterpret_cast<const uint2*>(
                scales + (size_t)g * N + n));
            const float sc[COLS] = {
                bf16_bits_to_float(s4.x & 0xFFFFu),
                bf16_bits_to_float(s4.x >> 16),
                bf16_bits_to_float(s4.y & 0xFFFFu),
                bf16_bits_to_float(s4.y >> 16)};
            const uint16_t* xrows = xs + slice * SLICE_ELEMS;
            // unrolled by 2 only: a full unroll keeps w[] out of local
            // memory but measured 3-13% slower (PERF.md)
#pragma unroll 2
            for (int r = 0; r < HALF; ++r) {
                float wl[COLS], wh[COLS];
#pragma unroll
                for (int j = 0; j < COLS; ++j) {
                    const uint8_t b = (uint8_t)(w[r] >> (8 * j));
                    // sign-extend each nibble: shift the low one to the top
                    // of an 8-bit value first (a plain b << 4 would promote
                    // to int and lose the sign)
                    const int lo = (int)(int8_t)(uint8_t)(b << 4) >> 4;
                    const int hi = (int)(int8_t)b >> 4;
                    wl[j] = round_to_bf16((float)lo * sc[j]);
                    wh[j] = round_to_bf16((float)hi * sc[j]);
                }
                float xe[BM], xo[BM];
                load_row(xrows + (2 * r) * BM, xe);
                load_row(xrows + (2 * r + 1) * BM, xo);
#pragma unroll
                for (int m = 0; m < BM; ++m)
#pragma unroll
                    for (int j = 0; j < COLS; ++j) {
                        acc[m][j] = fmaf(xe[m], wl[j], acc[m][j]);
                        acc[m][j] = fmaf(xo[m], wh[j], acc[m][j]);
                    }
            }
        }
    }

    // add the slices' partial sums in a fixed tree: 16 -> 8 -> 4 -> 2 -> 1
    for (int half = KS / 2; half >= 1; half >>= 1) {
        __syncthreads();
        if (slice >= half && slice < 2 * half) {
            float* dst = red + (slice - half) * BM * BN + tx * COLS;
#pragma unroll
            for (int m = 0; m < BM; ++m)
                *reinterpret_cast<float4*>(dst + m * BN) = make_float4(
                    acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        }
        __syncthreads();
        if (slice < half) {
            const float* src = red + slice * BM * BN + tx * COLS;
#pragma unroll
            for (int m = 0; m < BM; ++m) {
                const float4 v = *reinterpret_cast<const float4*>(
                    src + m * BN);
                acc[m][0] += v.x;
                acc[m][1] += v.y;
                acc[m][2] += v.z;
                acc[m][3] += v.w;
            }
        }
    }

    if (slice == 0 && col_ok) {
#pragma unroll
        for (int m = 0; m < BM; ++m) {
            if (m0 + m >= M) break;
            uint32_t bits[COLS];
#pragma unroll
            for (int j = 0; j < COLS; ++j)
                bits[j] = __bfloat16_as_ushort(__float2bfloat16_rn(acc[m][j]));
            *reinterpret_cast<uint2*>(out + (size_t)(m0 + m) * N + n) =
                make_uint2(bits[0] | (bits[1] << 16), bits[2] | (bits[3] << 16));
        }
    }
}

}  // namespace

// x: [M, K] bf16; packed: [K/2, N] int8; scales: [K/64, N] bf16;
// out: [M, N] bf16, all contiguous.  The caller checks K % 64 == 0,
// N % 4 == 0, 1 <= M <= 65535 * 16 and the pointers' alignment
// (packed 4 bytes, scales 8 bytes).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int int4_matmul_bf16(const void* x, const void* packed,
                                const void* scales, void* out, int M, int K,
                                int N, void* stream) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    int4_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(packed),
        static_cast<const uint16_t*>(scales), static_cast<uint16_t*>(out), M,
        K, N);
    return (int)cudaGetLastError();
}
