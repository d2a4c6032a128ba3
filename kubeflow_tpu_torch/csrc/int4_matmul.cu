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
//   - each weight is nibble * scale, exact in fp32, rounded to bf16 (the
//     operand the TPU kernel feeds its matrix unit); x * w accumulates in
//     fp32 over all of K; the output is written once, as bf16.
// Both packed and scales are read in place, in the reference layout.
//
// What bounds it on an H100:
//   - decode (M = 16): device-memory bytes.  The packed weights (K*N/2)
//     and scales (K*N/32) are each moved once; a 4096 x 4096 layer needs
//     2.7 us at 3.35 TB/s.  The tensor cores take the products, so what is
//     left per weight is its dequantization: 2 weights (one packed byte)
//     cost 4 instructions.  Enough bytes stay in flight through a deep TMA
//     ring and a split of K across blocks wherever the output tiles alone
//     fall short of the card's SMs.
//   - prefill (M = 2048): the tensor cores' operations (2*M*N*K), fed by
//     wgmma with the dequantized weights as the register A operand.
//
// Design: outT[N, M] = W^T x^T on wgmma.mma_async, so one kernel serves
// both regimes (the token count M is wgmma's N: 16, 64 or 128).
//   - A = the dequantized weights, 64 output columns x 16 contract rows
//     per wgmma, held in registers.  In the m64k16 A layout a thread holds
//     contract pairs (2t, 2t+1) and (2t+8, 2t+9) of two rows: each pair is
//     one packed byte's low and high nibble, so the reference layout feeds
//     the fragment with no interleave.  The rows of A may stand for any
//     columns of W: a consumer warpgroup owns 128 columns as two m64 tiles,
//     and each thread's four A rows (rows g and g+8 of both tiles) are four
//     adjacent columns, so one 32-bit shared load brings a thread all four
//     bytes of a packed row.  Columns 16w + 4(g & 3) + 64(g >> 2) for warp
//     w and lane group g put the four packed rows a warp reads at once in
//     disjoint banks under the 128-byte swizzle.
//   - Dequantization of a byte: one prmt puts its low nibble and (from
//     the word shifted right by 4) its high nibble into the two halves of
//     a 32-bit word, one lop3 masks them and makes each the mantissa of
//     bf16 128.0 offset by 8 (136 + v), one fma.rn.bf16x2 subtracts 136
//     (exact), one mul.rn.bf16x2 multiplies by the column's scale, which
//     rounds the exact product once, as the fp32 product rounded to bf16.
//   - B = the tile of x, [M rows, 64 contract] bf16, K-major as it lies in
//     memory, read by wgmma from shared memory through a 128-byte-swizzled
//     descriptor: no transpose.
//   - A producer warpgroup's one thread keeps TMA loads of x, packed and
//     scale tiles (one scale group, 64 contract rows, a stage) in flight
//     into a ring of shared-memory stages on full/empty mbarriers; tiles
//     past M or N are zero-filled by the TMA and their stores masked.
//   - The accumulator rows are output columns, so a thread holds four
//     adjacent columns of each of its tokens and writes them as one 8-byte
//     store: lanes 0-3 and 4-7 of a row group write 32 contiguous bytes
//     each, whole sectors, with no transpose through shared memory.
//   - Split-K: where the output tiles alone fall short of the SMs (every
//     decode layer of Llama-2-7B but the LM head), each block takes a run
//     of scale groups and writes its fp32 partial sums to a workspace; the
//     last block of a tile to finish (an integer counter, reset by that
//     block) adds the partials in split order, so the sum, and the result,
//     does not depend on which block finished last.  No float atomics.
//   The split and tile are chosen on the host (ops/int4_matmul.py:plan).
//
// Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface (int4_matmul_bf16 below),
// loaded by kubeflow_tpu_torch/ops/int4_matmul.py through ctypes.

#include "hopper.cuh"

namespace {

constexpr int GROUP = 64;           // contract rows per scale
constexpr int HALF = GROUP / 2;     // packed rows per scale group
constexpr int WG_COLS = 128;        // output columns per consumer warpgroup

constexpr int BAD_SHAPE = -1;
constexpr int TMA_ERROR = -2;       // no tensor-map encoder, or it refused

// shared memory of one stage, from a 1024-byte aligned base: the x box
// (BM rows of 128 bytes, swizzled), each consumer's packed box (32 rows of
// 128 bytes, swizzled), each consumer's scales (128 bf16); then the
// barriers and one flag a consumer
template <int BM, int CONSUMERS, int STAGES>
struct Int4Smem {
    static constexpr int X_BYTES = BM * GROUP * 2;
    static constexpr int W_BYTES = HALF * WG_COLS;
    static constexpr int S_BYTES = WG_COLS * 2;
    static constexpr int W_OFF = X_BYTES;
    static constexpr int S_OFF = W_OFF + CONSUMERS * W_BYTES;
    static constexpr int LOAD_BYTES = S_OFF + CONSUMERS * S_BYTES;
    static constexpr int STAGE_BYTES = (LOAD_BYTES + 1023) / 1024 * 1024;
    static constexpr int BAR_OFF = STAGES * STAGE_BYTES;
    static constexpr int FLAG_OFF = BAR_OFF + 16 * STAGES;
    static constexpr int BYTES = FLAG_OFF + 16 + 1024;   // + alignment slack
};

__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
    return v;
}

__device__ __forceinline__ uint2 lds_u2(uint32_t addr) {
    uint2 v;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(v.x), "=r"(v.y) : "r"(addr));
    return v;
}

// a barrier among the 128 threads of one warpgroup (ids 1, 2, ...; 0 is
// __syncthreads)
__device__ __forceinline__ void wg_sync(int id) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(WG_THREADS)
                 : "memory");
}

// byte J of w as a bf16 pair {low nibble, high nibble} times the bf16
// pair s2 (the column's scale twice); w4 = w >> 4
template <int J>
__device__ __forceinline__ uint32_t dequant(uint32_t w, uint32_t w4,
                                            uint32_t s2) {
    constexpr uint32_t SEL = J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12);
    const uint32_t nib = __byte_perm(w, w4, SEL);
    // each half 0x4300 | (nibble ^ 8): bf16 136 + v for the signed nibble v
    const uint32_t biased = (nib & 0x000F000Fu) ^ 0x43084308u;
    uint32_t v, out;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"            // (136 + v) * 1 - 136
        : "=r"(v) : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));
    asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(out) : "r"(v), "r"(s2));
    return out;
}

// the 128-byte swizzle of the TMA: 16-byte chunk c of row r of a box lies
// at chunk c ^ (r % 8)
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
    return row * ROW_BYTES + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

template <int BM, int CONSUMERS, int STAGES>
__global__ void __launch_bounds__((CONSUMERS + 1) * WG_THREADS,
                                  BM == 16 ? 2 : 1)
int4_matmul_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap ts,
                   uint16_t* __restrict__ out, float* __restrict__ ws,
                   int* __restrict__ counters, int M, int N, int groups,
                   int gps, int splits) {
    using L = Int4Smem<BM, CONSUMERS, STAGES>;
    constexpr bool REGS = CONSUMERS > 1;   // setmaxnreg: 24 / 240
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    const uint32_t full0 = base + L::BAR_OFF, empty0 = full0 + 8 * STAGES;
    int* flags = reinterpret_cast<int*>(smem_raw + (base - raw) + L::FLAG_OFF);

    // split fastest, then token tiles, then column tiles: the blocks of
    // one column tile share their weights, those of one split their x
    const int mtiles = (M + BM - 1) / BM;
    const int split = blockIdx.x % splits;
    const int mt = blockIdx.x / splits % mtiles;
    const int n_blk = blockIdx.x / splits / mtiles * (CONSUMERS * WG_COLS);
    const int g0 = split * gps;
    const int iters = min(groups, g0 + gps) - g0;
    const int active = min(CONSUMERS, (N - n_blk + WG_COLS - 1) / WG_COLS);
    const int wg = threadIdx.x / WG_THREADS;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, 4 * active);
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (wg == 0) {
        if constexpr (REGS) regs_dec<24>();
        if (threadIdx.x == 0) {
            for (int i = 0; i < iters; ++i) {
                const int s = i % STAGES;
                if (i >= STAGES)
                    mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
                const int g = g0 + i;
                const uint32_t full = full0 + 8 * s;
                const uint32_t st = base + s * L::STAGE_BYTES;
                mbar_expect_tx(full, L::X_BYTES
                               + active * (L::W_BYTES + L::S_BYTES));
                tma_load_2d(st, &tx, full, g * GROUP, mt * BM);
                for (int c = 0; c < active; ++c) {
                    const int n = n_blk + c * WG_COLS;
                    tma_load_2d(st + L::W_OFF + c * L::W_BYTES, &tw, full, n,
                                g * HALF);
                    tma_load_2d(st + L::S_OFF + c * L::S_BYTES, &ts, full, n,
                                g);
                }
            }
        }
    } else {
        if constexpr (REGS) regs_inc<240>();
        const int c = wg - 1;
        if (c >= active) return;   // its columns all lie past N
        const int tid = threadIdx.x % WG_THREADS;
        const int warp = tid / 32, lane = tid % 32;
        const int g = lane >> 2, t = lane & 3;
        // this thread's four columns: rows g, g+8 of tile 0, then of tile 1
        const int col = warp * 16 + (g & 3) * 4 + (g >> 2) * 64;
        const int n_wg = n_blk + c * WG_COLS;

        float acc0[BM / 2], acc1[BM / 2];
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) acc0[i] = acc1[i] = 0.f;

        for (int i = 0; i < iters; ++i) {
            const int s = i % STAGES;
            mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
            const uint32_t st = base + s * L::STAGE_BYTES;
            const uint32_t sw = st + L::W_OFF + c * L::W_BYTES;
            const uint2 sc = lds_u2(st + L::S_OFF + c * L::S_BYTES + col * 2);
            const uint32_t s2[4] = {
                __byte_perm(sc.x, 0, 0x1010), __byte_perm(sc.x, 0, 0x3232),
                __byte_perm(sc.y, 0, 0x1010), __byte_perm(sc.y, 0, 0x3232)};

            // A fragments of the group's four k16 steps, both tiles:
            // packed rows 8kk + t (pairs 2t, 2t+1) and 8kk + t + 4
            // (pairs 2t+8, 2t+9); byte j of a word is column col + j
            uint32_t a0[4][4], a1[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const uint32_t w0 = lds_u32(sw + swizzled(8 * kk + t, col));
                const uint32_t w1 =
                    lds_u32(sw + swizzled(8 * kk + t + 4, col));
                const uint32_t w0s = w0 >> 4, w1s = w1 >> 4;
                a0[kk][0] = dequant<0>(w0, w0s, s2[0]);
                a0[kk][1] = dequant<1>(w0, w0s, s2[1]);
                a0[kk][2] = dequant<0>(w1, w1s, s2[0]);
                a0[kk][3] = dequant<1>(w1, w1s, s2[1]);
                a1[kk][0] = dequant<2>(w0, w0s, s2[2]);
                a1[kk][1] = dequant<3>(w0, w0s, s2[3]);
                a1[kk][2] = dequant<2>(w1, w1s, s2[2]);
                a1[kk][3] = dequant<3>(w1, w1s, s2[3]);
            }

            // outT += W^T x^T: x's tile is B, K-major, 32 bytes a k16 step
            const uint64_t xd = opaque(sw128_desc(st, 16));
            fence_regs(a0);
            fence_regs(a1);
            fence_regs(acc0);
            fence_regs(acc1);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                wgmma_rs<0>(acc0, a0[kk], xd + kk * 2);
                wgmma_rs<0>(acc1, a1[kk], xd + kk * 2);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc0);
            fence_regs(acc1);
            fence_regs(a0);
            fence_regs(a1);

            // this warp is done with the stage
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * s);
            __syncwarp();
        }

        // acc[4j + e] is column col + 2 (tile) + (e >> 1) of token
        // 8j + 2t + (e & 1) of the tile
        const int m0 = mt * BM + 2 * t;
        const int n = n_wg + col;
        const bool n_ok = n < N;   // N % 16 == 0: all four or none
        if (splits == 1) {
            if (!n_ok) return;
#pragma unroll
            for (int j = 0; j < BM / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int m = m0 + 8 * j + e;
                    if (m >= M) continue;
                    *reinterpret_cast<uint2*>(out + (size_t)m * N + n) =
                        make_uint2(
                            pack_bf16(acc0[4 * j + e], acc0[4 * j + 2 + e]),
                            pack_bf16(acc1[4 * j + e], acc1[4 * j + 2 + e]));
                }
            return;
        }

        // split-K: this block's partial sums, then the last block of the
        // tile adds all of them in split order
        float* part = ws + (size_t)split * M * N;
        if (n_ok) {
#pragma unroll
            for (int j = 0; j < BM / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int m = m0 + 8 * j + e;
                    if (m >= M) continue;
                    *reinterpret_cast<float4*>(part + (size_t)m * N + n) =
                        make_float4(acc0[4 * j + e], acc0[4 * j + 2 + e],
                                    acc1[4 * j + e], acc1[4 * j + 2 + e]);
                }
        }
        __threadfence();
        wg_sync(1 + c);
        const int tile = mt * ((N + WG_COLS - 1) / WG_COLS) + n_wg / WG_COLS;
        if (tid == 0) {
            const int done = atomicAdd(counters + tile, 1);
            flags[c] = done == splits - 1;
            if (done == splits - 1) counters[tile] = 0;   // for the next call
        }
        wg_sync(1 + c);
        if (!flags[c] || !n_ok) return;
        __threadfence();
        // each token's sum in split order, two tokens at a time; the loads
        // of four splits are issued together (only the adds wait on them)
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
            const int m = m0 + 8 * j;
            if (m >= M) break;
            const int m1 = min(m + 1, M - 1);
            float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
#pragma unroll 4
            for (int p = 0; p < splits; ++p) {
                const float* src = ws + (size_t)p * M * N + n;
                const float4 v0 = __ldcg(
                    reinterpret_cast<const float4*>(src + (size_t)m * N));
                const float4 v1 = __ldcg(
                    reinterpret_cast<const float4*>(src + (size_t)m1 * N));
                s0.x += v0.x;
                s0.y += v0.y;
                s0.z += v0.z;
                s0.w += v0.w;
                s1.x += v1.x;
                s1.y += v1.y;
                s1.z += v1.z;
                s1.w += v1.w;
            }
            *reinterpret_cast<uint2*>(out + (size_t)m * N + n) = make_uint2(
                pack_bf16(s0.x, s0.y), pack_bf16(s0.z, s0.w));
            if (m + 1 < M)
                *reinterpret_cast<uint2*>(out + (size_t)(m + 1) * N + n) =
                    make_uint2(pack_bf16(s1.x, s1.y), pack_bf16(s1.z, s1.w));
        }
    }
}

// a rank-2 map over a row-major [rows, cols] array of `elem` bytes, in
// boxes of box_rows x box_cols, rows past the end read as zeros
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem,
               const void* ptr, int rows, int cols, int box_rows,
               int box_cols, CUtensorMapSwizzle swizzle) {
    const EncodeTiled fn = encoder();
    if (fn == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t unit[2] = {1, 1};
    return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int CONSUMERS, int STAGES>
int launch(const void* x, const void* packed, const void* scales, void* out,
           void* ws, void* counters, int M, int K, int N, int splits,
           int gps, cudaStream_t stream) {
    CUtensorMap tx, tw, ts;
    if (!encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, BM,
                   GROUP, CU_TENSOR_MAP_SWIZZLE_128B)
        || !encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, packed, K / 2, N,
                      HALF, WG_COLS, CU_TENSOR_MAP_SWIZZLE_128B)
        || !encode_2d(&ts, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, scales,
                      K / GROUP, N, 1, WG_COLS, CU_TENSOR_MAP_SWIZZLE_NONE))
        return TMA_ERROR;
    using L = Int4Smem<BM, CONSUMERS, STAGES>;
    auto kernel = int4_matmul_kernel<BM, CONSUMERS, STAGES>;
    if (int rc = prepare(kernel, L::BYTES)) return rc;
    const int mtiles = (M + BM - 1) / BM;
    const int ntiles = (N + CONSUMERS * WG_COLS - 1) / (CONSUMERS * WG_COLS);
    kernel<<<splits * mtiles * ntiles, (CONSUMERS + 1) * WG_THREADS, L::BYTES,
             stream>>>(tx, tw, ts, static_cast<uint16_t*>(out),
                       static_cast<float*>(ws), static_cast<int*>(counters),
                       M, N, K / GROUP, gps, splits);
    return (int)cudaGetLastError();
}

}  // namespace

// x: [M, K] bf16; packed: [K/2, N] int8; scales: [K/64, N] bf16; out:
// [M, N] bf16, all contiguous and 16-byte aligned, K % 64 == 0,
// N % 16 == 0.  bm (16, 64 or 128: the token tile, with one, one or two
// consumer warpgroups), splits and gps (scale groups a split) come from
// ops/int4_matmul.py:plan.  With splits > 1, ws holds splits * M * N fp32
// partials and counters one zeroed int per (token tile, 128 columns),
// which the kernel leaves zeroed.  Launches on `stream` and returns 0,
// BAD_SHAPE (-1), TMA_ERROR (-2) or a cudaError_t code.
extern "C" int int4_matmul_bf16(const void* x, const void* packed,
                                const void* scales, void* out, void* ws,
                                void* counters, int M, int K, int N, int bm,
                                int splits, int gps, void* stream) {
    const int groups = K / GROUP;
    if (M < 1 || K < GROUP || K % GROUP || N < 16 || N % 16 || splits < 1
        || gps < 1 || (splits - 1) * gps >= groups || splits * gps < groups
        || (splits > 1 && (ws == nullptr || counters == nullptr)))
        return BAD_SHAPE;
    const cudaStream_t st = (cudaStream_t)stream;
    if (bm == 16)
        return launch<16, 1, 8>(x, packed, scales, out, ws, counters, M, K, N,
                                splits, gps, st);
    if (bm == 64)
        return launch<64, 1, 4>(x, packed, scales, out, ws, counters, M, K, N,
                                splits, gps, st);
    if (bm == 128)
        return launch<128, 2, 4>(x, packed, scales, out, ws, counters, M, K,
                                 N, splits, gps, st);
    return BAD_SHAPE;
}
