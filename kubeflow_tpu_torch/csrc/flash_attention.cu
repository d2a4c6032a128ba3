// Flash attention for Hopper (sm_90a): forward, dK/dV and dQ kernels.
//
// Replaces the three Pallas TPU kernels that
// kubeflow_tpu/ops/attention.py:flash_attention reaches through
// jax.experimental.pallas.ops.tpu.flash_attention:
//   - flash_fwd     <- _flash_attention_impl     (q, k, v -> o, lse)
//   - flash_bwd_dkv <- _flash_attention_bwd_dkv  (q, k, v, dO, lse, di
//                                                 -> dK, dV)
//   - flash_bwd_dq  <- _flash_attention_bwd_dq   (q, k, v, dO, lse, di
//                                                 -> dQ)
// and computes the same functions: softmax(Q K^T * scale) V, causal with
// the mask top-left aligned (query i sees keys 0..i), q_len == kv_len.
//
// Rounding points (those of the Pallas kernels and of xla_attention):
// bf16 inputs; fp32 scores, softmax statistics and accumulators; the
// probabilities P rounded to bf16 before the PV product (in the forward
// unnormalised, in [0, 1], as Pallas does); dS = P * (dP - di) * scale
// rounded to bf16 before the dK and dQ products; bf16 outputs.  The
// forward's residual is one fp32 log-sum-exp per row, lse [B, H, S]
// (Pallas keeps the row max m and sum l, lane-padded: the same
// information).  di = rowsum(dO * O) [B, H, S] fp32 is computed by the
// caller in plain torch, as the reference computes it outside its
// kernels.
//
// Layout: q, k, v and dO are [B, S, H, D] (kv with KVH heads) read in
// place through their batch, sequence and head strides (the last dim
// contiguous), so the reference's [B, H, S, D] transposes cost nothing.
// Outputs are contiguous: o, dq [B, S, H, D]; dk, dv [B, S, KVH, D].
// Grouped-query attention: query head h reads kv head h / (H / KVH); the
// dK/dV kernel sums the H / KVH query heads of its kv head itself, in a
// fixed order.  No atomics: every output element is summed by one thread
// in a fixed order, so a second run gives the same bits.
//
// What bounds them on an H100: the tensor-core products.  A causal
// forward at the main path's shape (B 40, S 2048, H 12, D 128) does
// 4*B*H*S^2*D/2 = 5.2e11 FLOPs and moves 0.8 GB; the two backward
// kernels do 4 and 3 such products.  At 989 TFLOP/s bf16 that is 0.52,
// 1.04 and 0.78 ms, above the bytes' 0.2-0.3 ms (at the Gemma step's
// B 2, S 8192, H 16, D 256: 1.11, 2.22 and 1.67 ms).  Every design keeps S
// and P out of device memory (scores in registers, P fed back to the
// tensor cores from the registers that hold it) and skips the tiles
// wholly above the diagonal, which halves the work.
//
// All three kernels are built for Hopper's own path to the tensor cores
// (helpers in hopper.cuh).  A block is three warpgroups (384 threads):
//   - the producer, warpgroup 0, drops to 24 registers a thread
//     (setmaxnreg); one of its threads keeps TMA loads
//     (cp.async.bulk.tensor, rank 4 over the strided [B, S, H, D] view,
//     128-byte swizzle) in flight into a ring of two shared-memory
//     stages, each with a "full" mbarrier that the copies complete and an
//     "empty" one that the consumer warps arrive on when done with it;
//   - two consumers, warpgroups 1 and 2, rise to 240 registers; each owns
//     64 rows of the block's tile and runs wgmma.mma_async on the stages
//     that have arrived.  Both operands of a score product come from
//     shared memory (K-major); the product with P or dS takes them as the
//     register A operand, since the m64nNk16 accumulator layout is the A
//     layout, and reads its B operand MN-major through the transpose bit.
// A 128-byte swizzle spans 64 bf16 columns, so at D = 128 a tile is two
// TMA boxes, and the wgmma descriptors step through both halves.  The
// grid is one-dimensional, with the blocks of one (batch, head) next to
// each other in launch order: the blocks on the card at once then share
// their streamed tiles in L2 instead of each reading them from memory.
//   - forward: a block owns 128 query rows of one (batch, head), Q
//     resident, and the producer streams 128-key K and V tiles (160 KB of
//     shared memory at D = 128).  Per tile: S = Q K^T (m64n128k16), the
//     online softmax in fp32 on the accumulator, P rounded into the A
//     registers, O += P V.  The softmax is kept short, as it runs between
//     the two products: masking is a pass of its own, on the diagonal tile
//     and a tile that runs past S only; 2^x is one ex2.approx; the row
//     maxima and sums run in four independent chains.  Each head's longest
//     rows first.
//   - dK/dV: a block owns 128 keys of one (batch, kv head), K and V
//     resident, and the producer streams 64-row tiles of Q and dO with
//     their lse and di (bulk copies) for every query head of the group
//     and, within each, every tile from the diagonal down (128 KB at
//     D = 128).  Per tile: S^T = K Q^T and dP^T = V dO^T (m64n64k16);
//     P^T = exp2(S^T * scale * log2e - lse * log2e) while dP^T runs; P^T
//     rounded for dV and dS^T = P^T (dP^T - di) * scale rounded for dK, 16
//     queries at a time; then dV += P^T dO and dK += dS^T Q.  The key
//     blocks that see the most rows first.
//   - dQ: a block owns 128 query rows of one (batch, head), Q and dO
//     resident with each row's lse and di in registers, and the producer
//     streams 64-key K and V tiles up to the diagonal (128 KB at D = 128).
//     Per tile: S = Q K^T and dP = dO V^T (m64n64k16, both from shared
//     memory); P = 2^(S * scale * log2e - lse * log2e), one ex2.approx,
//     while dP runs, the mask a pass of its own on the diagonal tile only;
//     dS = P (dP - di) * scale rounded into the A registers; dQ += dS K
//     with K read MN-major, as the forward reads V.  64-key tiles keep
//     S, dP and the dQ accumulator (32 + 32 + 64 fp32 at D = 128) within
//     the consumers' registers.  Each head's longest rows first.
// Head dim 256 (Gemma) keeps the three designs with the tiles cut to fit
// 227 KB of shared memory and 240 registers a consumer thread (`Tiles`):
//   - forward: 64-key K and V tiles (192 KB); a consumer holds a 64 x 256
//     fp32 O (128 registers) and a 64 x 64 S (32).  A causal block's last
//     tile is wholly masked for consumer 0's rows and adds zeros;
//   - dK/dV: two 64 x 256 fp32 accumulators do not fit one thread's
//     registers, so a block owns 64 keys and its two consumers share them:
//     consumer 0 forms P^T and sums dV += P^T dO, consumer 1 forms dP^T,
//     takes P^T (fp32, 16 KB) through shared memory and sums
//     dK += dS^T Q.  Each does two of the four products, and two named
//     barriers hand the P^T buffer back and forth (208 KB);
//   - dQ: 32-key K and V tiles (192 KB).
// A 256-column product with P or dS is two m64n128k16 on the
// accumulator's halves.
// S need only be a multiple of 64, so a 128-row tile can run half past
// the end: the TMA fills those rows with zeros, keys at or past S are
// masked (a zero key would score 0, not -inf) and rows at or past S are
// not stored.
// These replace v3 (mma.sync.m16n8k16 fed by ldmatrix, 4 warps of 16
// rows, cp.async double buffering); PERF.md keeps both versions' times,
// and what was measured to bound the new ones.
//
// Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface (the extern "C"
// functions at the end), loaded by kubeflow_tpu_torch/ops/
// flash_attention.py through ctypes.  The TMA descriptors are encoded on
// the host for each call by libcuda's cuTensorMapEncodeTiled, which the
// CUDA runtime hands over by name, so nothing links against libcuda.

#include <math.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {   // element strides of a [B, S, H, D] view
    long long b, s, h;
};

// 2^x on the special-function unit, flushing subnormal results to zero
// (exp2f adds range checks and scaling around the same instruction)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------ shared by all three

constexpr int HOPPER_THREADS = 3 * WG_THREADS;   // producer + 2 consumers
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int STAGES = 2;
constexpr int FWD_BQ = 128, DKV_BQ = 64, DQ_BQ = 128;

// the key tiles of each head dim (D 64 and 128: 128, 128 and 64)
template <int D>
struct Tiles {
    static constexpr int FWD_BK = D == 256 ? 64 : 128;
    static constexpr int DKV_BK = D == 256 ? 64 : 128;
    // the two consumers share the block's keys, one summing dV, one dK
    static constexpr bool DKV_SPLIT = D == 256;
    static constexpr int DQ_BK = D == 256 ? 32 : 64;
};

// named barriers (0 is __syncthreads) over the two consumer warpgroups of
// the split dK/dV kernel: P^T written, P^T read
constexpr int P_FULL = 1, P_EMPTY = 2, CONSUMER_THREADS = 2 * WG_THREADS;

__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(CONSUMER_THREADS)
                 : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(CONSUMER_THREADS)
                 : "memory");
}

__device__ __forceinline__ void sts_f4(uint32_t addr, float a, float b,
                                       float c, float d) {
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(addr), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}

__device__ __forceinline__ float4 lds_f4(uint32_t addr) {
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
                 : "memory");
    return v;
}

// d += a B, B MN-major (read through the transpose bit) in 64-column
// boxes box_bytes apart, d holding D / 2 floats: one m64nDk16 up to
// D = 128, two m64n128k16 on the accumulator's halves at D = 256
template <int D>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[D / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t b, uint32_t box_bytes) {
    if constexpr (D <= 128) {
        wgmma_rs<1>(d, a, b);
    } else {
        static_assert(D == 256, "head dims 64, 128 and 256");
        wgmma_rs<1>(*reinterpret_cast<float(*)[64]>(&d[0]), a, b);
        wgmma_rs<1>(*reinterpret_cast<float(*)[64]>(&d[64]), a,
                    b + 2 * box_bytes / 16);
    }
}

// two floats from shared memory at a 32-bit shared address (a generic
// pointer per column would cost two registers each, hoisted out of the loop)
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
    float2 v;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(v.x), "=f"(v.y) : "r"(addr));
    return v;
}

// shared memory, from a 1024-byte aligned base (each tile BOXES boxes of
// rows x 128 bytes, every box 1024-byte aligned), then the barriers
template <int D>
struct FwdSmem {
    static constexpr int Q_BYTES = FWD_BQ * D * 2;
    static constexpr int KV_BYTES = Tiles<D>::FWD_BK * D * 2;
    static constexpr int Q_OFF = 0;
    static constexpr int KV_OFF = Q_BYTES;   // stage s: K, then V
    static constexpr int BAR_OFF = KV_OFF + STAGES * 2 * KV_BYTES;
    static constexpr int BYTES = BAR_OFF + 64 + 1024;   // + alignment slack
};

template <int D>
struct DkvSmem {
    static constexpr int KV_BYTES = Tiles<D>::DKV_BK * D * 2;
    static constexpr int QT_BYTES = DKV_BQ * D * 2;
    static constexpr int K_OFF = 0, V_OFF = KV_BYTES;
    static constexpr int STAGE_OFF = 2 * KV_BYTES;   // stage s: Q, then dO
    static constexpr int ROWS_OFF = STAGE_OFF + STAGES * 2 * QT_BYTES;
                                                     // stage s: lse, di
    static constexpr int ROW_BYTES_F = DKV_BQ * 4;
    static constexpr int P_OFF = ROWS_OFF + STAGES * 2 * ROW_BYTES_F;
    // the split kernel's P^T, 64 keys x 64 queries fp32
    static constexpr int P_BYTES = Tiles<D>::DKV_SPLIT ? 64 * DKV_BQ * 4 : 0;
    static constexpr int BAR_OFF = P_OFF + P_BYTES;
    static constexpr int BYTES = BAR_OFF + 64 + 1024;
};

template <int D>
struct DqSmem {
    static constexpr int QT_BYTES = DQ_BQ * D * 2;   // Q or dO
    static constexpr int KV_BYTES = Tiles<D>::DQ_BK * D * 2;
    static constexpr int Q_OFF = 0, DO_OFF = QT_BYTES;
    static constexpr int KV_OFF = 2 * QT_BYTES;      // stage s: K, then V
    static constexpr int BAR_OFF = KV_OFF + STAGES * 2 * KV_BYTES;
    static constexpr int BYTES = BAR_OFF + 64 + 1024;
};

// ---------------------------------------------------------------- forward

template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 bf16* __restrict__ o, float* __restrict__ lse, int S, int H,
                 int KVH, float scale, int causal) {
    using L = FwdSmem<D>;
    constexpr int BOXES = D / BOX;
    constexpr int FWD_BK = Tiles<D>::FWD_BK;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    const uint32_t q_full = base + L::BAR_OFF;
    const uint32_t full0 = q_full + 8, empty0 = q_full + 8 + 8 * STAGES;

    // the query blocks of one (batch, head) are neighbours in launch order,
    // so the blocks on the card at once share their K and V tiles in L2;
    // the longest rows of each head first
    const int nqb = (S + FWD_BQ - 1) / FWD_BQ;
    const int bh = blockIdx.x / nqb;
    const int b = bh / H, h = bh % H;
    const int kvh = h / (H / KVH);
    const int qb = nqb - 1 - blockIdx.x % nqb;
    // key tiles up to the block's last row (causal) or all of them
    const int nkt = (S + FWD_BK - 1) / FWD_BK;
    const int nkb = causal ? min((qb + 1) * (FWD_BQ / FWD_BK), nkt) : nkt;
    const int wg = threadIdx.x / WG_THREADS;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, CONSUMER_WARPS);
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (wg == 0) {
        // producer: Q once, then K and V tiles through the ring
        regs_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            mbar_expect_tx(q_full, L::Q_BYTES);
            for (int x = 0; x < BOXES; ++x)
                tma_load(base + L::Q_OFF + x * FWD_BQ * ROW_BYTES, &tq, q_full,
                         x * BOX, h, qb * FWD_BQ, b);
            for (int kb = 0; kb < nkb; ++kb) {
                const int s = kb % STAGES;
                if (kb >= STAGES)
                    mbar_wait(empty0 + 8 * s, ((kb / STAGES) & 1) ^ 1);
                const uint32_t full = full0 + 8 * s;
                const uint32_t sk = base + L::KV_OFF + s * 2 * L::KV_BYTES;
                mbar_expect_tx(full, 2 * L::KV_BYTES);
                for (int x = 0; x < BOXES; ++x) {
                    tma_load(sk + x * FWD_BK * ROW_BYTES, &tk, full, x * BOX,
                             kvh, kb * FWD_BK, b);
                    tma_load(sk + L::KV_BYTES + x * FWD_BK * ROW_BYTES, &tv,
                             full, x * BOX, kvh, kb * FWD_BK, b);
                }
            }
        }
    } else {
        // consumer c: query rows 64c..64c+63 of the block's tile
        regs_inc<CONSUMER_REGS>();
        const int c = wg - 1;
        const int tid = threadIdx.x % WG_THREADS;
        const int warp = tid / 32, lane = tid % 32;
        const int t2 = (lane & 3) * 2;
        const int row_lo = qb * FWD_BQ + c * 64;
        const int row0 = row_lo + warp * 16 + (lane >> 2);   // and row0 + 8
        const uint32_t sq = base + L::Q_OFF + c * 64 * ROW_BYTES;
        // when causal, the key tiles from diag on are masked for these rows
        // (at FWD_BK 64 consumer 0's second one wholly: it adds zeros)
        const int diag = row_lo / FWD_BK;

        float acc[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
        float m[2] = {-INFINITY, -INFINITY};   // running max, log2 units
        float l[2] = {0.f, 0.f};               // this thread's part of the sum
        const float sl2 = scale * LOG2E;

        mbar_wait(q_full, 0);
        for (int kb = 0; kb < nkb; ++kb) {
            const int s = kb % STAGES;
            mbar_wait(full0 + 8 * s, (kb / STAGES) & 1);
            const uint32_t sk = base + L::KV_OFF + s * 2 * L::KV_BYTES;
            const uint32_t sv = sk + L::KV_BYTES;

            // S = Q K^T: this consumer's 64 rows x FWD_BK keys
            float sc[FWD_BK / 2];
            const uint64_t qd = opaque(sw128_desc(sq, 16));
            const uint64_t kd = opaque(sw128_desc(sk, 16));
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const int off = (kk % 4) * 32;
                wgmma_ss(
                    sc, qd + ((kk / 4) * FWD_BQ * ROW_BYTES + off) / 16,
                    kd + ((kk / 4) * FWD_BK * ROW_BYTES + off) / 16, kk > 0);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(sc);

            // online softmax in log2 units.  Only the diagonal tiles and a
            // tile that runs past S are masked, in a pass of their own:
            // element 4j + e is key kb*BK + t2 + 8j + (e & 1) of row
            // row0 + 8 (e / 2), so each test is a constant against a limit
#pragma unroll
            for (int i = 0; i < FWD_BK / 2; ++i) sc[i] *= sl2;
            if ((causal && kb >= diag) || (kb + 1) * FWD_BK > S) {
                const int past_row = causal ? row0 - kb * FWD_BK - t2
                                            : FWD_BK;
                const int past_seq = S - kb * FWD_BK - t2;
#pragma unroll
                for (int j = 0; j < FWD_BK / 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int key = j * 8 + (e & 1);
                        if (key > past_row + (e >> 1) * 8 || key >= past_seq)
                            sc[4 * j + e] = -INFINITY;
                    }
            }
            // row maxima in four independent chains a row
            float mx[2][4];
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int q = 0; q < 4; ++q) mx[r][q] = m[r];
#pragma unroll
            for (int i = 0; i < FWD_BK / 2; ++i) {
                mx[(i >> 1) & 1][(i >> 2) & 3] =
                    fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], sc[i]);
            }
            float base_[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const float row_max = quad_max(fmaxf(
                    fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3])));
                base_[r] = row_max == -INFINITY ? 0.f : row_max;
                const float alpha = ex2(m[r] - base_[r]);
                m[r] = row_max;
                l[r] *= alpha;
#pragma unroll
                for (int j = 0; j < D / 8; ++j) {
                    acc[4 * j + 2 * r] *= alpha;
                    acc[4 * j + 2 * r + 1] *= alpha;
                }
            }
            // P, and its row sums in four independent chains a row
            float sum[2][4] = {};
#pragma unroll
            for (int i = 0; i < FWD_BK / 2; ++i) {
                const float p = ex2(sc[i] - base_[(i >> 1) & 1]);
                sc[i] = p;
                sum[(i >> 1) & 1][(i >> 2) & 3] += p;
            }
#pragma unroll
            for (int r = 0; r < 2; ++r)
                l[r] += (sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]);

            // O += P V: P, unnormalised, rounded to bf16 in the A registers
            uint32_t pa[FWD_BK / 16][4];
#pragma unroll
            for (int kk = 0; kk < FWD_BK / 16; ++kk)
                acc_to_a_wg(pa[kk], sc, kk);
            const uint64_t vd = opaque(sw128_desc(sv, FWD_BK * ROW_BYTES));
            fence_regs(pa);
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < FWD_BK / 16; ++kk)
                wgmma_rs_mn<D>(acc, pa[kk], vd + kk * 16 * ROW_BYTES / 16,
                               FWD_BK * ROW_BYTES);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
            fence_regs(pa);

            // this warp is done with the stage
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * s);
            __syncwarp();
        }

#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float total = quad_sum(l[r]);
            const float inv = total > 0.f ? 1.f / total : 0.f;
            const int row = row0 + r * 8;
            if (row >= S) continue;
            bf16* op = o + (((long long)b * S + row) * H + h) * D + t2;
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
                *reinterpret_cast<__nv_bfloat162*>(op + j * 8) =
                    __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                          acc[4 * j + 2 * r + 1] * inv);
            if ((lane & 3) == 0)
                lse[((long long)b * H + h) * S + row] =
                    (m[r] + log2f(total)) * LN2;
        }
    }
}

// ------------------------------------------------------------ dK and dV

template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int H, int KVH,
                     float scale, int causal) {
    using L = DkvSmem<D>;
    constexpr int BOXES = D / BOX;
    constexpr int DKV_BK = Tiles<D>::DKV_BK;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    const uint32_t kv_full = base + L::BAR_OFF;
    const uint32_t full0 = kv_full + 8, empty0 = kv_full + 8 + 8 * STAGES;

    // the key blocks of one (batch, kv head) are neighbours in launch
    // order, so the blocks on the card at once share their Q and dO tiles
    // in L2; the first key blocks, which see the most rows, first
    const int nkb = (S + DKV_BK - 1) / DKV_BK;
    const int b = blockIdx.x / nkb / KVH, kvh = blockIdx.x / nkb % KVH;
    const int groups = H / KVH;
    const int kb = blockIdx.x % nkb;
    // iteration it walks query tile qt0 + it % nqt of query head
    // kvh * groups + it / nqt; tiles above the diagonal are all masked
    const int qt0 = causal ? kb * DKV_BK / DKV_BQ : 0;
    const int nqt = S / DKV_BQ - qt0;
    const int iters = groups * nqt;
    const int wg = threadIdx.x / WG_THREADS;

    if (threadIdx.x == 0) {
        mbar_init(kv_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, CONSUMER_WARPS);
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (wg == 0) {
        // producer: K and V once, then Q, dO, lse and di tiles
        regs_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
            for (int x = 0; x < BOXES; ++x) {
                tma_load(base + L::K_OFF + x * DKV_BK * ROW_BYTES, &tk,
                         kv_full, x * BOX, kvh, kb * DKV_BK, b);
                tma_load(base + L::V_OFF + x * DKV_BK * ROW_BYTES, &tv,
                         kv_full, x * BOX, kvh, kb * DKV_BK, b);
            }
            for (int it = 0; it < iters; ++it) {
                const int s = it % STAGES;
                if (it >= STAGES)
                    mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
                const int h = kvh * groups + it / nqt;
                const int q0 = (qt0 + it % nqt) * DKV_BQ;
                const uint32_t full = full0 + 8 * s;
                const uint32_t sq = base + L::STAGE_OFF + s * 2 * L::QT_BYTES;
                const uint32_t rows = base + L::ROWS_OFF
                    + s * 2 * L::ROW_BYTES_F;
                mbar_expect_tx(full, 2 * L::QT_BYTES + 2 * L::ROW_BYTES_F);
                for (int x = 0; x < BOXES; ++x) {
                    tma_load(sq + x * DKV_BQ * ROW_BYTES, &tq, full, x * BOX,
                             h, q0, b);
                    tma_load(sq + L::QT_BYTES + x * DKV_BQ * ROW_BYTES, &tdo,
                             full, x * BOX, h, q0, b);
                }
                const long long row = ((long long)b * H + h) * S + q0;
                bulk_load(rows, lse + row, L::ROW_BYTES_F, full);
                bulk_load(rows + L::ROW_BYTES_F, di + row, L::ROW_BYTES_F,
                          full);
            }
        }
    } else if constexpr (!Tiles<D>::DKV_SPLIT) {
        // consumer c: keys 64c..64c+63 of the block's 128
        regs_inc<CONSUMER_REGS>();
        const int c = wg - 1;
        const int tid = threadIdx.x % WG_THREADS;
        const int warp = tid / 32, lane = tid % 32;
        const int t2 = (lane & 3) * 2;
        const int key_lo = kb * DKV_BK + c * 64;
        const int key0 = key_lo + warp * 16 + (lane >> 2);   // and key0 + 8
        const uint32_t sk = base + L::K_OFF + c * 64 * ROW_BYTES;
        const uint32_t sv = base + L::V_OFF + c * 64 * ROW_BYTES;

        float dka[D / 2], dva[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
        const float sl2 = scale * LOG2E;

        mbar_wait(kv_full, 0);
        for (int it = 0; it < iters; ++it) {
            const int s = it % STAGES;
            const int q0 = (qt0 + it % nqt) * DKV_BQ;
            mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
            // a tile wholly above this consumer's keys adds nothing
            if (!(causal && q0 + DKV_BQ <= key_lo)) {
                const uint32_t sq = base + L::STAGE_OFF
                    + s * 2 * L::QT_BYTES;
                const uint32_t sdo = sq + L::QT_BYTES;
                // lse and di of this thread's query columns t2 + 8j (+1)
                const uint32_t slse = base + L::ROWS_OFF
                    + s * 2 * L::ROW_BYTES_F + t2 * 4;
                const uint32_t sdi = slse + L::ROW_BYTES_F;

                // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each
                float st[DKV_BQ / 2], dpt[DKV_BQ / 2];
                const uint64_t kd = opaque(sw128_desc(sk, 16));
                const uint64_t vd = opaque(sw128_desc(sv, 16));
                const uint64_t qd = opaque(sw128_desc(sq, 16));
                const uint64_t dod = opaque(sw128_desc(sdo, 16));
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk) {
                    const int off = (kk % 4) * 32;
                    wgmma_ss(
                        st, kd + ((kk / 4) * DKV_BK * ROW_BYTES + off) / 16,
                        qd + ((kk / 4) * DKV_BQ * ROW_BYTES + off) / 16,
                        kk > 0);
                }
                wgmma_commit();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk) {
                    const int off = (kk % 4) * 32;
                    wgmma_ss(
                        dpt, vd + ((kk / 4) * DKV_BK * ROW_BYTES + off) / 16,
                        dod + ((kk / 4) * DKV_BQ * ROW_BYTES + off) / 16,
                        kk > 0);
                }
                wgmma_commit();
                wgmma_wait<1>();
                fence_regs(st);

                // P^T, from the forward's log-sum-exp, while dP^T runs
                // (element 4j + e is key key0 + 8 (e / 2) and query
                // q0 + t2 + 8j + (e & 1))
                const bool diag = causal && q0 < key_lo + 64;
                const int before = key0 - q0 - t2;
#pragma unroll
                for (int j = 0; j < DKV_BQ / 8; ++j) {
                    const float2 l2 = lds_f2(slse + j * 32);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        float p = exp2f(st[4 * j + e] * sl2
                                        - ((e & 1) ? l2.y : l2.x) * LOG2E);
                        if (diag && j * 8 + (e & 1) < before + (e >> 1) * 8)
                            p = 0.f;
                        st[4 * j + e] = p;
                    }
                }
                wgmma_wait<0>();
                fence_regs(dpt);

                // P^T rounded to bf16 for dV, and dS^T = P^T (dP^T - di) *
                // scale rounded to bf16 for dK, 16 queries at a time
                uint32_t pa[DKV_BQ / 16][4], dsa[DKV_BQ / 16][4];
#pragma unroll
                for (int kk = 0; kk < DKV_BQ / 16; ++kk) {
                    acc_to_a_wg(pa[kk], st, kk);
#pragma unroll
                    for (int j = 2 * kk; j < 2 * kk + 2; ++j) {
                        const float2 d2 = lds_f2(sdi + j * 32);
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            st[4 * j + e] = st[4 * j + e]
                                * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x))
                                * scale;
                    }
                    acc_to_a_wg(dsa[kk], st, kk);
                }

                // dV += P^T dO and dK += dS^T Q
                const uint64_t dot = opaque(
                    sw128_desc(sdo, DKV_BQ * ROW_BYTES));
                const uint64_t qt = opaque(
                    sw128_desc(sq, DKV_BQ * ROW_BYTES));
                fence_regs(pa);
                fence_regs(dsa);
                fence_regs(dva);
                fence_regs(dka);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < DKV_BQ / 16; ++kk)
                    wgmma_rs_mn<D>(dva, pa[kk], dot + kk * 16 * ROW_BYTES / 16,
                                   DKV_BQ * ROW_BYTES);
#pragma unroll
                for (int kk = 0; kk < DKV_BQ / 16; ++kk)
                    wgmma_rs_mn<D>(dka, dsa[kk], qt + kk * 16 * ROW_BYTES / 16,
                                   DKV_BQ * ROW_BYTES);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(dva);
                fence_regs(dka);
                fence_regs(pa);
                fence_regs(dsa);
            }
            // this warp is done with the stage
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * s);
            __syncwarp();
        }

#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int key = key0 + r * 8;
            if (key >= S) continue;
            const long long off = (((long long)b * S + key) * KVH + kvh) * D
                + t2;
#pragma unroll
            for (int j = 0; j < D / 8; ++j) {
                *reinterpret_cast<__nv_bfloat162*>(dk + off + j * 8) =
                    __floats2bfloat162_rn(dka[4 * j + 2 * r],
                                          dka[4 * j + 2 * r + 1]);
                *reinterpret_cast<__nv_bfloat162*>(dv + off + j * 8) =
                    __floats2bfloat162_rn(dva[4 * j + 2 * r],
                                          dva[4 * j + 2 * r + 1]);
            }
        }
    } else {
        // both consumers take the block's 64 keys: consumer 0 forms P^T and
        // sums dV, consumer 1 forms dP^T, takes P^T through shared memory
        // and sums dK.  Every tile starts at or below the diagonal (64-row
        // query tiles from the block's own), so both run every iteration
        // and meet at the barriers in step.
        regs_inc<CONSUMER_REGS>();
        const int c = wg - 1;
        const int tid = threadIdx.x % WG_THREADS;
        const int warp = tid / 32, lane = tid % 32;
        const int t2 = (lane & 3) * 2;
        const int key_lo = kb * DKV_BK;
        const int key0 = key_lo + warp * 16 + (lane >> 2);   // and key0 + 8
        const uint32_t sk = base + L::K_OFF, sv = base + L::V_OFF;
        // this thread's 32 values of P^T, four at a time, the same thread of
        // the other consumer holding the same elements of dP^T
        const uint32_t sp = base + L::P_OFF + tid * 16;

        float acc[D / 2];   // dV (consumer 0) or dK (consumer 1)
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
        const float sl2 = scale * LOG2E;

        mbar_wait(kv_full, 0);
        for (int it = 0; it < iters; ++it) {
            const int s = it % STAGES;
            const int q0 = (qt0 + it % nqt) * DKV_BQ;
            mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
            const uint32_t sq = base + L::STAGE_OFF + s * 2 * L::QT_BYTES;
            const uint32_t sdo = sq + L::QT_BYTES;
            const uint32_t slse = base + L::ROWS_OFF
                + s * 2 * L::ROW_BYTES_F + t2 * 4;
            const uint32_t sdi = slse + L::ROW_BYTES_F;

            // S^T = K Q^T (consumer 0) or dP^T = V dO^T (consumer 1)
            float st[DKV_BQ / 2];
            const uint64_t ad = opaque(sw128_desc(c == 0 ? sk : sv, 16));
            const uint64_t bd = opaque(sw128_desc(c == 0 ? sq : sdo, 16));
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const int off = (kk % 4) * 32;
                wgmma_ss(st, ad + ((kk / 4) * DKV_BK * ROW_BYTES + off) / 16,
                         bd + ((kk / 4) * DKV_BQ * ROW_BYTES + off) / 16,
                         kk > 0);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(st);

            uint32_t a[DKV_BQ / 16][4];
            if (c == 0) {
                // P^T from the forward's log-sum-exp (element 4j + e is key
                // key0 + 8 (e / 2) and query q0 + t2 + 8j + (e & 1))
                const bool diag = causal && q0 < key_lo + 64;
                const int before = key0 - q0 - t2;
#pragma unroll
                for (int j = 0; j < DKV_BQ / 8; ++j) {
                    const float2 l2 = lds_f2(slse + j * 32);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        float p = exp2f(st[4 * j + e] * sl2
                                        - ((e & 1) ? l2.y : l2.x) * LOG2E);
                        if (diag && j * 8 + (e & 1) < before + (e >> 1) * 8)
                            p = 0.f;
                        st[4 * j + e] = p;
                    }
                }
                // to consumer 1, once it has read the last P^T
                if (it > 0) named_sync(P_EMPTY);
#pragma unroll
                for (int i = 0; i < DKV_BQ / 2; i += 4)
                    sts_f4(sp + i / 4 * WG_THREADS * 16, st[i], st[i + 1],
                           st[i + 2], st[i + 3]);
                named_arrive(P_FULL);
                // P^T rounded to bf16 for dV += P^T dO
#pragma unroll
                for (int kk = 0; kk < DKV_BQ / 16; ++kk)
                    acc_to_a_wg(a[kk], st, kk);
            } else {
                // dS^T = P^T (dP^T - di) * scale, rounded to bf16 for
                // dK += dS^T Q
                named_sync(P_FULL);
#pragma unroll
                for (int i = 0; i < DKV_BQ / 2; i += 4) {
                    const float4 p = lds_f4(sp + i / 4 * WG_THREADS * 16);
                    const float2 d2 = lds_f2(sdi + (i / 4) * 32);
                    st[i] = p.x * (st[i] - d2.x) * scale;
                    st[i + 1] = p.y * (st[i + 1] - d2.y) * scale;
                    st[i + 2] = p.z * (st[i + 2] - d2.x) * scale;
                    st[i + 3] = p.w * (st[i + 3] - d2.y) * scale;
                }
                if (it + 1 < iters) named_arrive(P_EMPTY);
#pragma unroll
                for (int kk = 0; kk < DKV_BQ / 16; ++kk)
                    acc_to_a_wg(a[kk], st, kk);
            }

            // dV += P^T dO or dK += dS^T Q, dO or Q read MN-major
            const uint64_t bt = opaque(
                sw128_desc(c == 0 ? sdo : sq, DKV_BQ * ROW_BYTES));
            fence_regs(a);
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < DKV_BQ / 16; ++kk)
                wgmma_rs_mn<D>(acc, a[kk], bt + kk * 16 * ROW_BYTES / 16,
                               DKV_BQ * ROW_BYTES);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
            fence_regs(a);

            // this warp is done with the stage
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * s);
            __syncwarp();
        }

        bf16* out = c == 0 ? dv : dk;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int key = key0 + r * 8;
            if (key >= S) continue;
            const long long off = (((long long)b * S + key) * KVH + kvh) * D
                + t2;
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
                *reinterpret_cast<__nv_bfloat162*>(out + off + j * 8) =
                    __floats2bfloat162_rn(acc[4 * j + 2 * r],
                                          acc[4 * j + 2 * r + 1]);
        }
    }
}

// -------------------------------------------------------------------- dQ

template <int D>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, bf16* __restrict__ dq,
                    int S, int H, int KVH, float scale, int causal) {
    using L = DqSmem<D>;
    constexpr int BOXES = D / BOX;
    constexpr int DQ_BK = Tiles<D>::DQ_BK;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    const uint32_t q_full = base + L::BAR_OFF;
    const uint32_t full0 = q_full + 8, empty0 = q_full + 8 + 8 * STAGES;

    // the query blocks of one (batch, head) are neighbours in launch order,
    // so the blocks on the card at once share their K and V tiles in L2;
    // the longest rows of each head first
    const int nqb = (S + DQ_BQ - 1) / DQ_BQ;
    const int bh = blockIdx.x / nqb;
    const int b = bh / H, h = bh % H;
    const int kvh = h / (H / KVH);
    const int qb = nqb - 1 - blockIdx.x % nqb;
    // key tiles up to the block's last row (causal) or all of them
    const int nkb = causal ? min((qb + 1) * (DQ_BQ / DQ_BK), S / DQ_BK)
                           : S / DQ_BK;
    const int wg = threadIdx.x / WG_THREADS;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, CONSUMER_WARPS);
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (wg == 0) {
        // producer: Q and dO once, then K and V tiles through the ring
        regs_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            mbar_expect_tx(q_full, 2 * L::QT_BYTES);
            for (int x = 0; x < BOXES; ++x) {
                tma_load(base + L::Q_OFF + x * DQ_BQ * ROW_BYTES, &tq, q_full,
                         x * BOX, h, qb * DQ_BQ, b);
                tma_load(base + L::DO_OFF + x * DQ_BQ * ROW_BYTES, &tdo,
                         q_full, x * BOX, h, qb * DQ_BQ, b);
            }
            for (int kb = 0; kb < nkb; ++kb) {
                const int s = kb % STAGES;
                if (kb >= STAGES)
                    mbar_wait(empty0 + 8 * s, ((kb / STAGES) & 1) ^ 1);
                const uint32_t full = full0 + 8 * s;
                const uint32_t sk = base + L::KV_OFF + s * 2 * L::KV_BYTES;
                mbar_expect_tx(full, 2 * L::KV_BYTES);
                for (int x = 0; x < BOXES; ++x) {
                    tma_load(sk + x * DQ_BK * ROW_BYTES, &tk, full, x * BOX,
                             kvh, kb * DQ_BK, b);
                    tma_load(sk + L::KV_BYTES + x * DQ_BK * ROW_BYTES, &tv,
                             full, x * BOX, kvh, kb * DQ_BK, b);
                }
            }
        }
    } else {
        // consumer c: query rows 64c..64c+63 of the block's tile
        regs_inc<CONSUMER_REGS>();
        const int c = wg - 1;
        const int tid = threadIdx.x % WG_THREADS;
        const int warp = tid / 32, lane = tid % 32;
        const int t2 = (lane & 3) * 2;
        const int row_lo = qb * DQ_BQ + c * 64;
        const int row0 = row_lo + warp * 16 + (lane >> 2);   // and row0 + 8
        const uint32_t sq = base + L::Q_OFF + c * 64 * ROW_BYTES;
        const uint32_t sdo = base + L::DO_OFF + c * 64 * ROW_BYTES;
        // S is a multiple of 64, so this consumer's rows are all in S or
        // all past it (half of the last 128-row tile, zero-filled by TMA);
        // when causal its key tiles from diag to last hold its diagonal
        const bool live = row_lo < S;
        const int diag = row_lo / DQ_BK;
        const int last = causal ? (row_lo + 63) / DQ_BK : nkb - 1;

        // each row's lse (log2 units) and di, held for the whole loop
        float lse2[2] = {0.f, 0.f}, dir[2] = {0.f, 0.f};
        if (live) {
            const long long rows = ((long long)b * H + h) * S;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                lse2[r] = lse[rows + row0 + 8 * r] * LOG2E;
                dir[r] = di[rows + row0 + 8 * r];
            }
        }
        float dqa[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
        const float sl2 = scale * LOG2E;

        mbar_wait(q_full, 0);
        for (int kb = 0; kb < nkb; ++kb) {
            const int s = kb % STAGES;
            mbar_wait(full0 + 8 * s, (kb / STAGES) & 1);
            if (live && kb <= last) {
                const uint32_t sk = base + L::KV_OFF + s * 2 * L::KV_BYTES;
                const uint32_t sv = sk + L::KV_BYTES;

                // S = Q K^T and dP = dO V^T: 64 rows x DQ_BK keys each
                float st[DQ_BK / 2], dpt[DQ_BK / 2];
                const uint64_t qd = opaque(sw128_desc(sq, 16));
                const uint64_t dod = opaque(sw128_desc(sdo, 16));
                const uint64_t kd = opaque(sw128_desc(sk, 16));
                const uint64_t vd = opaque(sw128_desc(sv, 16));
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk) {
                    const int off = (kk % 4) * 32;
                    wgmma_ss(st,
                             qd + ((kk / 4) * DQ_BQ * ROW_BYTES + off) / 16,
                             kd + ((kk / 4) * DQ_BK * ROW_BYTES + off) / 16,
                             kk > 0);
                }
                wgmma_commit();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk) {
                    const int off = (kk % 4) * 32;
                    wgmma_ss(dpt,
                             dod + ((kk / 4) * DQ_BQ * ROW_BYTES + off) / 16,
                             vd + ((kk / 4) * DQ_BK * ROW_BYTES + off) / 16,
                             kk > 0);
                }
                wgmma_commit();
                wgmma_wait<1>();
                fence_regs(st);

                // P = 2^(S * scale * log2e - lse * log2e) while dP runs.
                // Only the diagonal tiles are masked, in a pass of their
                // own: element 4j + e is key kb*BK + t2 + 8j + (e & 1) of
                // row row0 + 8 (e / 2)
                if (causal && kb >= diag) {
                    const int past = row0 - kb * DQ_BK - t2;
#pragma unroll
                    for (int j = 0; j < DQ_BK / 8; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            if (j * 8 + (e & 1) > past + (e >> 1) * 8)
                                st[4 * j + e] = -INFINITY;
                }
#pragma unroll
                for (int i = 0; i < DQ_BK / 2; ++i)
                    st[i] = ex2(st[i] * sl2 - lse2[(i >> 1) & 1]);
                wgmma_wait<0>();
                fence_regs(dpt);

                // dS = P (dP - di) * scale, rounded to bf16 into the A
                // registers (the accumulator layout is the A layout)
                uint32_t dsa[DQ_BK / 16][4];
#pragma unroll
                for (int i = 0; i < DQ_BK / 2; ++i)
                    st[i] = st[i] * (dpt[i] - dir[(i >> 1) & 1]) * scale;
#pragma unroll
                for (int kk = 0; kk < DQ_BK / 16; ++kk)
                    acc_to_a_wg(dsa[kk], st, kk);

                // dQ += dS K, K read MN-major through the transpose bit
                const uint64_t kt = opaque(sw128_desc(sk, DQ_BK * ROW_BYTES));
                fence_regs(dsa);
                fence_regs(dqa);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < DQ_BK / 16; ++kk)
                    wgmma_rs_mn<D>(dqa, dsa[kk], kt + kk * 16 * ROW_BYTES / 16,
                                   DQ_BK * ROW_BYTES);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(dqa);
                fence_regs(dsa);
            }
            // this warp is done with the stage
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * s);
            __syncwarp();
        }

        if (live) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const long long row = (long long)b * S + row0 + r * 8;
                bf16* dqp = dq + (row * H + h) * D + t2;
#pragma unroll
                for (int j = 0; j < D / 8; ++j)
                    *reinterpret_cast<__nv_bfloat162*>(dqp + j * 8) =
                        __floats2bfloat162_rn(dqa[4 * j + 2 * r],
                                              dqa[4 * j + 2 * r + 1]);
            }
        }
    }
}

constexpr int BAD_SHAPE = -1;
constexpr int TMA_ERROR = -2;   // no tensor-map encoder, or it refused

// a rank-4 map over the [B, S, heads, D] view at ptr, in boxes of 64
// columns x `rows` rows of one (batch, head), 128-byte swizzled; rows past
// S read as zeros
bool encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int heads,
                 int D, Strides st, int rows) {
    const EncodeTiled fn = encoder();
    if (fn == nullptr) return false;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                                (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                   (cuuint64_t)st.b * 2};
    const cuuint32_t box[4] = {(cuuint32_t)BOX, 1, (cuuint32_t)rows, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
              const_cast<void*>(ptr), dims, strides, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int S, int H, int KVH, int causal,
               float scale, Strides qs, Strides ks, Strides vs,
               cudaStream_t stream) {
    CUtensorMap tq, tk, tv;
    constexpr int FWD_BK = Tiles<D>::FWD_BK;
    if (!encode_bshd(&tq, q, B, S, H, D, qs, FWD_BQ)
        || !encode_bshd(&tk, k, B, S, KVH, D, ks, FWD_BK)
        || !encode_bshd(&tv, v, B, S, KVH, D, vs, FWD_BK))
        return TMA_ERROR;
    const int smem = FwdSmem<D>::BYTES;
    if (int rc = prepare(flash_fwd_kernel<D>, smem)) return rc;
    const int grid = B * H * ((S + FWD_BQ - 1) / FWD_BQ);
    flash_fwd_kernel<D><<<grid, HOPPER_THREADS, smem, stream>>>(
        tq, tk, tv, (bf16*)o, (float*)lse, S, H, KVH, scale, causal);
    return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* di, void* dk, void* dv, int B,
               int S, int H, int KVH, int causal, float scale, Strides qs,
               Strides ks, Strides vs, Strides dos, cudaStream_t stream) {
    CUtensorMap tq, tk, tv, tdo;
    constexpr int DKV_BK = Tiles<D>::DKV_BK;
    if (!encode_bshd(&tq, q, B, S, H, D, qs, DKV_BQ)
        || !encode_bshd(&tk, k, B, S, KVH, D, ks, DKV_BK)
        || !encode_bshd(&tv, v, B, S, KVH, D, vs, DKV_BK)
        || !encode_bshd(&tdo, dout, B, S, H, D, dos, DKV_BQ))
        return TMA_ERROR;
    const int smem = DkvSmem<D>::BYTES;
    if (int rc = prepare(flash_bwd_dkv_kernel<D>, smem)) return rc;
    const int grid = B * KVH * ((S + DKV_BK - 1) / DKV_BK);
    flash_bwd_dkv_kernel<D><<<grid, HOPPER_THREADS, smem, stream>>>(
        tq, tk, tv, tdo, (const float*)lse, (const float*)di, (bf16*)dk,
        (bf16*)dv, S, H, KVH, scale, causal);
    return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* di, void* dq, int B, int S, int H,
              int KVH, int causal, float scale, Strides qs, Strides ks,
              Strides vs, Strides dos, cudaStream_t stream) {
    CUtensorMap tq, tk, tv, tdo;
    constexpr int DQ_BK = Tiles<D>::DQ_BK;
    if (!encode_bshd(&tq, q, B, S, H, D, qs, DQ_BQ)
        || !encode_bshd(&tk, k, B, S, KVH, D, ks, DQ_BK)
        || !encode_bshd(&tv, v, B, S, KVH, D, vs, DQ_BK)
        || !encode_bshd(&tdo, dout, B, S, H, D, dos, DQ_BQ))
        return TMA_ERROR;
    const int smem = DqSmem<D>::BYTES;
    if (int rc = prepare(flash_bwd_dq_kernel<D>, smem)) return rc;
    const int grid = B * H * ((S + DQ_BQ - 1) / DQ_BQ);
    flash_bwd_dq_kernel<D><<<grid, HOPPER_THREADS, smem, stream>>>(
        tq, tk, tv, tdo, (const float*)lse, (const float*)di, (bf16*)dq, S,
        H, KVH, scale, causal);
    return (int)cudaGetLastError();
}

// the wrapper checks shapes too; this guards the C interface itself
bool shape_ok(int B, int S, int H, int KVH) {
    return B > 0 && S > 0 && S % 64 == 0 && S / 64 <= 65535 && H > 0
        && KVH > 0 && H % KVH == 0;
}

}  // namespace

// Strides are in elements, for the [B, S, H, D] views: (batch, seq, head).
// Each function returns 0, BAD_SHAPE (-1), TMA_ERROR (-2) or a cudaError_t
// code.

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int S, int H,
                              int KVH, int D, int causal, float scale,
                              long long qsb, long long qss, long long qsh,
                              long long ksb, long long kss, long long ksh,
                              long long vsb, long long vss, long long vsh,
                              void* stream) {
    if (!shape_ok(B, S, H, KVH)) return BAD_SHAPE;
    const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
    const cudaStream_t st = (cudaStream_t)stream;
    if (D == 256)
        return launch_fwd<256>(q, k, v, o, lse, B, S, H, KVH, causal, scale,
                               qs, ks, vs, st);
    if (D == 128)
        return launch_fwd<128>(q, k, v, o, lse, B, S, H, KVH, causal, scale,
                               qs, ks, vs, st);
    if (D == 64)
        return launch_fwd<64>(q, k, v, o, lse, B, S, H, KVH, causal, scale,
                              qs, ks, vs, st);
    return BAD_SHAPE;
}

extern "C" int flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dk, void* dv, int B, int S, int H,
    int KVH, int D, int causal, float scale, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long dsb, long long dss, long long dsh,
    void* stream) {
    if (!shape_ok(B, S, H, KVH)) return BAD_SHAPE;
    const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
        dos{dsb, dss, dsh};
    const cudaStream_t st = (cudaStream_t)stream;
    if (D == 256)
        return launch_dkv<256>(q, k, v, dout, lse, di, dk, dv, B, S, H, KVH,
                               causal, scale, qs, ks, vs, dos, st);
    if (D == 128)
        return launch_dkv<128>(q, k, v, dout, lse, di, dk, dv, B, S, H, KVH,
                               causal, scale, qs, ks, vs, dos, st);
    if (D == 64)
        return launch_dkv<64>(q, k, v, dout, lse, di, dk, dv, B, S, H, KVH,
                              causal, scale, qs, ks, vs, dos, st);
    return BAD_SHAPE;
}

extern "C" int flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dq, int B, int S, int H, int KVH,
    int D, int causal, float scale, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long dsb, long long dss, long long dsh,
    void* stream) {
    if (!shape_ok(B, S, H, KVH)) return BAD_SHAPE;
    const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
        dos{dsb, dss, dsh};
    const cudaStream_t st = (cudaStream_t)stream;
    if (D == 256)
        return launch_dq<256>(q, k, v, dout, lse, di, dq, B, S, H, KVH,
                              causal, scale, qs, ks, vs, dos, st);
    if (D == 128)
        return launch_dq<128>(q, k, v, dout, lse, di, dq, B, S, H, KVH,
                              causal, scale, qs, ks, vs, dos, st);
    if (D == 64)
        return launch_dq<64>(q, k, v, dout, lse, di, dq, B, S, H, KVH, causal,
                             scale, qs, ks, vs, dos, st);
    return BAD_SHAPE;
}
