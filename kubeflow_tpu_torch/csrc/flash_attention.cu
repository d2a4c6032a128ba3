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
// fixed order.
//
// What bounds them on an H100: the tensor-core products.  A causal
// forward at the main path's shape (B 40, S 2048, H 12, D 128) does
// 4*B*H*S^2*D/2 = 5.2e11 FLOPs and moves 0.8 GB; the two backward
// kernels do 4 and 3 such products.  At 989 TFLOP/s bf16 that is 0.52,
// 1.04 and 0.78 ms, above the bytes' 0.2-0.3 ms.  The design keeps S and
// P out of device memory (online softmax in registers, P fed back to the
// tensor cores from the registers that hold the scores) and skips every
// tile wholly above the diagonal, which halves the work.  The products
// use mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with operands loaded
// from shared memory by ldmatrix.  The streamed tiles (K and V in the
// forward and dQ kernels, Q, dO, lse and di in the dK/dV kernel) come in
// by cp.async into two stages, so the next tile loads while the block
// computes on this one.  wgmma, TMA and warp specialisation are left for
// later work (PERF.md has the times).
//
// Tiling: 4 warps per block, each warp owns 16 rows of the block's tile.
//   - forward: a block owns 64 query rows of one (batch, head) and walks
//     the key blocks of 64 up to the diagonal, online softmax in fp32;
//   - dK/dV: a block owns 64 keys of one (batch, kv head) and walks, for
//     each query head of the group, the query tiles of 32 from the
//     diagonal down (the Pallas split: a q loop inside each k block);
//   - dQ: a block owns 64 query rows and walks the key blocks of 64 up to
//     the diagonal (a k loop inside each q block).
// No atomics: every output element is summed by one thread in a fixed
// order, so a second run gives the same bits.
//
// Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface (the extern "C"
// functions at the end), loaded by kubeflow_tpu_torch/ops/
// flash_attention.py through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;    // bf16 of padding per shared-memory row: keeps
                          // 16-byte row alignment and spreads a fragment's
                          // rows over all 32 banks
constexpr int FWD_BQ = 64, FWD_BK = 64;
constexpr int DKV_BK = 64, DKV_BQ = 32;
constexpr int DQ_BQ = 64, DQ_BK = 64;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {   // element strides of a [B, S, H, D] view
    long long b, s, h;
};

// c += a * b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col),
// c 16x8 fp32.  Fragment layout, with g = lane / 4 and t = lane % 4:
//   a: {a0,a1} row g, cols 2t..2t+1; {a2,a3} row g+8, same cols;
//      {a4,a5} row g, cols 2t+8..; {a6,a7} row g+8, cols 2t+8..
//   b: {b0,b1} rows (k) 2t..2t+1, col g; {b2,b3} rows 2t+8.., col g
//   c: c0,c1 row g, cols 2t..2t+1; c2,c3 row g+8, same cols
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// The a operand from two accumulator tiles: cols k0..k0+7 (lo) and
// k0+8..k0+15 (hi) of a 16-row fp32 tile, rounded to bf16.  The
// accumulator layout of two adjacent n8 tiles is the a layout of one
// 16x16 tile, so scores become the next product's operand in registers.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float lo[4],
                                         const float hi[4]) {
    a[0] = pack_bf16(lo[0], lo[1]);
    a[1] = pack_bf16(lo[2], lo[3]);
    a[2] = pack_bf16(hi[0], hi[1]);
    a[3] = pack_bf16(hi[2], hi[3]);
}

// ldmatrix: four 8x8 b16 matrices from shared memory, one row address
// per lane (lanes 8i..8i+7 give the rows of matrix i); register i of lane
// l holds row l/4, cols 2(l%4)..2(l%4)+1 of matrix i (with .trans, of its
// transpose): the mma fragment layout
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

// a fragment of rows r0..r0+15, cols c0..c0+15 of a row-major tile
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* t, int r0,
                                       int c0, int lane) {
    ldsm_x4(a, t + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// b fragments of two n8 tiles, n0.. (b[0..1]) and n0+8.. (b[2..3]), with
// b[k][n] = t[n0 + n][k0 + k]: the transposed operand of Q K^T (t = K),
// dO V^T (t = V), K Q^T (t = Q), V dO^T (t = dO)
template <int LD>
__device__ __forceinline__ void load_b_t(uint32_t b[4], const bf16* t,
                                         int n0, int k0, int lane) {
    ldsm_x4(b, t + (n0 + (lane >> 4) * 8 + (lane & 7)) * LD + k0
                   + ((lane >> 3) & 1) * 8);
}

// b fragments of two n8 tiles with b[k][n] = t[k0 + k][n0 + n]: the
// row-major operand of P V (t = V), P^T dO (t = dO), dS^T Q (t = Q),
// dS K (t = K)
template <int LD>
__device__ __forceinline__ void load_b_n(uint32_t b[4], const bf16* t,
                                         int k0, int n0, int lane) {
    ldsm_x4_trans(b, t + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + n0
                         + (lane >> 4) * 8);
}

// asynchronous 16-byte copies from device to shared memory: issued by
// each thread, grouped by commit, waited for by wait<n> (at most n of this
// thread's latest groups still in flight); a barrier then makes every
// thread's copies visible to the block
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// start copying rows x D bf16 from a strided global view into a padded
// shared tile, 16 bytes a thread at a time (row stride a multiple of 8)
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int rows) {
    constexpr int CHUNKS = D / 8;
    for (int c = threadIdx.x; c < rows * CHUNKS; c += THREADS) {
        const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
        cp_async16(dst + r * (D + PAD) + col, src + r * row_stride + col);
    }
}

// start copying n fp32 (n a multiple of 4) into shared memory
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int n) {
    for (int c = threadIdx.x; c < n / 4; c += THREADS)
        cp_async16(dst + 4 * c, src + 4 * c);
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------- forward

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int KVH, Strides qs,
                 Strides ks, Strides vs, float scale, int causal) {
    constexpr int LD = D + PAD, BQ = FWD_BQ, BK = FWD_BK;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* sq = reinterpret_cast<bf16*>(smem);
    bf16* skv = sq + BQ * LD;   // two stages of [K tile; V tile]

    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const int kvh = h / (H / KVH);
    const int qb = gridDim.y - 1 - blockIdx.y;   // longest rows first
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int t2 = (lane & 3) * 2;
    const int row0 = qb * BQ + warp * 16 + (lane >> 2);   // and row0 + 8

    const bf16* kp = k + b * ks.b + kvh * ks.h;
    const bf16* vp = v + b * vs.b + kvh * vs.h;
    auto load_kv = [&](int kb, int stage) {
        bf16* dst = skv + stage * 2 * BK * LD;
        load_tile<D>(dst, kp + (long long)kb * BK * ks.s, ks.s, BK);
        load_tile<D>(dst + BK * LD, vp + (long long)kb * BK * vs.s, vs.s,
                     BK);
        cp_async_commit();
    };
    load_tile<D>(sq, q + b * qs.b + h * qs.h + (long long)qb * BQ * qs.s,
                 qs.s, BQ);
    load_kv(0, 0);

    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};   // running max, log2 units
    float l[2] = {0.f, 0.f};               // this thread's part of the sum
    const float sl2 = scale * LOG2E;
    const int nkb = causal ? qb + 1 : S / BK;

    for (int kb = 0; kb < nkb; ++kb) {
        // the next tiles load while this block computes on these
        if (kb + 1 < nkb) {
            load_kv(kb + 1, (kb + 1) & 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* sk = skv + (kb & 1) * 2 * BK * LD;
        const bf16* sv = sk + BK * LD;

        float s[BK / 8][4];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4];
            load_a<LD>(a, sq, warp * 16, kk * 16, lane);
#pragma unroll
            for (int n = 0; n < BK / 8; n += 2) {
                uint32_t bf[4];
                load_b_t<LD>(bf, sk, n * 8, kk * 16, lane);
                mma16816(s[n], a, bf);
                mma16816(s[n + 1], a, bf + 2);
            }
        }

        const bool diag = causal && kb == qb;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[n][e] * sl2;
                const int col = kb * BK + n * 8 + t2 + (e & 1);
                if (diag && col > row0 + (e >> 1) * 8) x = -INFINITY;
                s[n][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        }
        float base[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = quad_max(mx[r]);
            base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
            const float alpha = exp2f(m[r] - base[r]);
            m[r] = mx[r];
            l[r] *= alpha;
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
                acc[n][2 * r] *= alpha;
                acc[n][2 * r + 1] *= alpha;
            }
        }
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = exp2f(s[n][e] - base[e >> 1]);
                s[n][e] = p;
                sum[e >> 1] += p;
            }
        }
        l[0] += sum[0];
        l[1] += sum[1];

#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t a[4];
            acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
            for (int n = 0; n < D / 8; n += 2) {
                uint32_t bf[4];
                load_b_n<LD>(bf, sv, kk * 16, n * 8, lane);
                mma16816(acc[n], a, bf);
                mma16816(acc[n + 1], a, bf + 2);
            }
        }
        __syncthreads();   // every warp is done with this stage
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const float total = quad_sum(l[r]);
        const float inv = total > 0.f ? 1.f / total : 0.f;
        const int row = row0 + r * 8;
        bf16* op = o + (((long long)b * S + row) * H + h) * D + t2;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
            *reinterpret_cast<__nv_bfloat162*>(op + n * 8) =
                __floats2bfloat162_rn(acc[n][2 * r] * inv,
                                      acc[n][2 * r + 1] * inv);
        if ((lane & 3) == 0)
            lse[((long long)b * H + h) * S + row] =
                (m[r] + log2f(total)) * LN2;
    }
}

// ------------------------------------------------------------ dK and dV

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int H, int KVH, Strides qs,
                     Strides ks, Strides vs, Strides dos, float scale,
                     int causal) {
    constexpr int LD = D + PAD, BK = DKV_BK, BQ = DKV_BQ;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* sk = reinterpret_cast<bf16*>(smem);
    bf16* sv = sk + BK * LD;
    bf16* sqd = sv + BK * LD;   // two stages of [Q tile; dO tile]
    float* srows = reinterpret_cast<float*>(sqd + 4 * BQ * LD);
                                // two stages of [lse; di] of those rows

    const int b = blockIdx.x / KVH, kvh = blockIdx.x % KVH;
    const int groups = H / KVH;
    const int kb = blockIdx.y;   // the first key blocks see the most rows
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int t2 = (lane & 3) * 2;
    const int key0 = kb * BK + warp * 16 + (lane >> 2);   // and key0 + 8

    float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
    const float sl2 = scale * LOG2E;
    // iteration it walks query tile qt0 + it % nqt of query head
    // kvh * groups + it / nqt; tiles above the diagonal are all masked
    const int qt0 = causal ? kb * BK / BQ : 0;
    const int nqt = S / BQ - qt0;
    const int iters = groups * nqt;
    auto load_q = [&](int it, int stage) {
        const int h = kvh * groups + it / nqt;
        const int qbase = (qt0 + it % nqt) * BQ;
        bf16* dst = sqd + stage * 2 * BQ * LD;
        load_tile<D>(dst, q + b * qs.b + h * qs.h + (long long)qbase * qs.s,
                     qs.s, BQ);
        load_tile<D>(dst + BQ * LD,
                     dout + b * dos.b + h * dos.h
                         + (long long)qbase * dos.s,
                     dos.s, BQ);
        const long long row = ((long long)b * H + h) * S + qbase;
        load_rows(srows + stage * 2 * BQ, lse + row, BQ);
        load_rows(srows + stage * 2 * BQ + BQ, di + row, BQ);
        cp_async_commit();
    };
    load_tile<D>(sk, k + b * ks.b + kvh * ks.h + (long long)kb * BK * ks.s,
                 ks.s, BK);
    load_tile<D>(sv, v + b * vs.b + kvh * vs.h + (long long)kb * BK * vs.s,
                 vs.s, BK);
    load_q(0, 0);

    for (int it = 0; it < iters; ++it) {
        // the next tiles load while this block computes on these
        if (it + 1 < iters) {
            load_q(it + 1, (it + 1) & 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int qbase = (qt0 + it % nqt) * BQ;
        const bf16* sq = sqd + (it & 1) * 2 * BQ * LD;
        const bf16* sdo = sq + BQ * LD;
        const float* slse = srows + (it & 1) * 2 * BQ;
        const float* sdi = slse + BQ;

        // S^T = K Q^T: this warp's 16 keys x BQ queries
        float st[BQ / 8][4];
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n)
            st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4];
            load_a<LD>(a, sk, warp * 16, kk * 16, lane);
#pragma unroll
            for (int n = 0; n < BQ / 8; n += 2) {
                uint32_t bf[4];
                load_b_t<LD>(bf, sq, n * 8, kk * 16, lane);
                mma16816(st[n], a, bf);
                mma16816(st[n + 1], a, bf + 2);
            }
        }
        // P^T, from the forward's log-sum-exp
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qi = n * 8 + t2 + (e & 1);
                float p = exp2f(st[n][e] * sl2 - slse[qi] * LOG2E);
                if (causal && key0 + (e >> 1) * 8 > qbase + qi) p = 0.f;
                st[n][e] = p;
            }
        }
        // dV += P^T dO
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
            uint32_t a[4];
            acc_to_a(a, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
            for (int n = 0; n < D / 8; n += 2) {
                uint32_t bf[4];
                load_b_n<LD>(bf, sdo, kk * 16, n * 8, lane);
                mma16816(dva[n], a, bf);
                mma16816(dva[n + 1], a, bf + 2);
            }
        }
        // dP^T = V dO^T
        float dpt[BQ / 8][4];
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n)
            dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4];
            load_a<LD>(a, sv, warp * 16, kk * 16, lane);
#pragma unroll
            for (int n = 0; n < BQ / 8; n += 2) {
                uint32_t bf[4];
                load_b_t<LD>(bf, sdo, n * 8, kk * 16, lane);
                mma16816(dpt[n], a, bf);
                mma16816(dpt[n + 1], a, bf + 2);
            }
        }
        // dS^T = P^T (dP^T - di) * scale
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qi = n * 8 + t2 + (e & 1);
                st[n][e] = st[n][e] * (dpt[n][e] - sdi[qi]) * scale;
            }
        }
        // dK += dS^T Q
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
            uint32_t a[4];
            acc_to_a(a, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
            for (int n = 0; n < D / 8; n += 2) {
                uint32_t bf[4];
                load_b_n<LD>(bf, sq, kk * 16, n * 8, lane);
                mma16816(dka[n], a, bf);
                mma16816(dka[n + 1], a, bf + 2);
            }
        }
        __syncthreads();   // every warp is done with this stage
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const long long off =
            (((long long)b * S + key0 + r * 8) * KVH + kvh) * D + t2;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
            *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
                __floats2bfloat162_rn(dka[n][2 * r], dka[n][2 * r + 1]);
            *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
                __floats2bfloat162_rn(dva[n][2 * r], dva[n][2 * r + 1]);
        }
    }
}

// ------------------------------------------------------------------- dQ

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, bf16* __restrict__ dq,
                    int S, int H, int KVH, Strides qs, Strides ks, Strides vs,
                    Strides dos, float scale, int causal) {
    constexpr int LD = D + PAD, BQ = DQ_BQ, BK = DQ_BK;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* sq = reinterpret_cast<bf16*>(smem);
    bf16* sdo = sq + BQ * LD;
    bf16* skv = sdo + BQ * LD;   // two stages of [K tile; V tile]

    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const int kvh = h / (H / KVH);
    const int qb = gridDim.y - 1 - blockIdx.y;   // longest rows first
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int t2 = (lane & 3) * 2;
    const int row0 = qb * BQ + warp * 16 + (lane >> 2);   // and row0 + 8

    const bf16* kp = k + b * ks.b + kvh * ks.h;
    const bf16* vp = v + b * vs.b + kvh * vs.h;
    auto load_kv = [&](int kb, int stage) {
        bf16* dst = skv + stage * 2 * BK * LD;
        load_tile<D>(dst, kp + (long long)kb * BK * ks.s, ks.s, BK);
        load_tile<D>(dst + BK * LD, vp + (long long)kb * BK * vs.s, vs.s,
                     BK);
        cp_async_commit();
    };
    load_tile<D>(sq, q + b * qs.b + h * qs.h + (long long)qb * BQ * qs.s,
                 qs.s, BQ);
    load_tile<D>(sdo,
                 dout + b * dos.b + h * dos.h + (long long)qb * BQ * dos.s,
                 dos.s, BQ);
    load_kv(0, 0);
    const float sl2 = scale * LOG2E;
    const float* lsep = lse + ((long long)b * H + h) * S;
    const float* dip = di + ((long long)b * H + h) * S;
    const float lse2[2] = {lsep[row0] * LOG2E, lsep[row0 + 8] * LOG2E};
    const float dir[2] = {dip[row0], dip[row0 + 8]};

    float dqa[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
        dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
    const int nkb = causal ? qb + 1 : S / BK;

    for (int kb = 0; kb < nkb; ++kb) {
        // the next tiles load while this block computes on these
        if (kb + 1 < nkb) {
            load_kv(kb + 1, (kb + 1) & 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* sk = skv + (kb & 1) * 2 * BK * LD;
        const bf16* sv = sk + BK * LD;

        float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
        // S = Q K^T and dP = dO V^T for this warp's 16 rows
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4], ad[4];
            load_a<LD>(a, sq, warp * 16, kk * 16, lane);
            load_a<LD>(ad, sdo, warp * 16, kk * 16, lane);
#pragma unroll
            for (int n = 0; n < BK / 8; n += 2) {
                uint32_t bf[4];
                load_b_t<LD>(bf, sk, n * 8, kk * 16, lane);
                mma16816(s[n], a, bf);
                mma16816(s[n + 1], a, bf + 2);
                load_b_t<LD>(bf, sv, n * 8, kk * 16, lane);
                mma16816(dp[n], ad, bf);
                mma16816(dp[n + 1], ad, bf + 2);
            }
        }
        // dS = P (dP - di) * scale
        const bool diag = causal && kb == qb;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                float p = exp2f(s[n][e] * sl2 - lse2[r]);
                if (diag && kb * BK + n * 8 + t2 + (e & 1) > row0 + r * 8)
                    p = 0.f;
                s[n][e] = p * (dp[n][e] - dir[r]) * scale;
            }
        }
        // dQ += dS K
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t a[4];
            acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
            for (int n = 0; n < D / 8; n += 2) {
                uint32_t bf[4];
                load_b_n<LD>(bf, sk, kk * 16, n * 8, lane);
                mma16816(dqa[n], a, bf);
                mma16816(dqa[n + 1], a, bf + 2);
            }
        }
        __syncthreads();   // every warp is done with this stage
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        bf16* dqp = dq + (((long long)b * S + row0 + r * 8) * H + h) * D + t2;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
            *reinterpret_cast<__nv_bfloat162*>(dqp + n * 8) =
                __floats2bfloat162_rn(dqa[n][2 * r], dqa[n][2 * r + 1]);
    }
}

// shared memory: the fixed tiles, then two stages of the streamed ones
template <int D>
constexpr int fwd_smem() { return (FWD_BQ + 4 * FWD_BK) * (D + PAD) * 2; }
template <int D>
constexpr int dkv_smem() {
    return (2 * DKV_BK + 4 * DKV_BQ) * (D + PAD) * 2 + 4 * DKV_BQ * 4;
}
template <int D>
constexpr int dq_smem() { return (2 * DQ_BQ + 4 * DQ_BK) * (D + PAD) * 2; }

template <typename Kernel>
int prepare(Kernel kernel, int smem_bytes) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int S, int H, int KVH, int causal,
               float scale, Strides qs, Strides ks, Strides vs,
               cudaStream_t stream) {
    const int smem = fwd_smem<D>();
    if (int rc = prepare(flash_fwd_kernel<D>, smem)) return rc;
    const dim3 grid(B * H, S / FWD_BQ);
    flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
        (float*)lse, S, H, KVH, qs, ks, vs, scale, causal);
    return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* di, void* dk, void* dv, int B,
               int S, int H, int KVH, int causal, float scale, Strides qs,
               Strides ks, Strides vs, Strides dos, cudaStream_t stream) {
    const int smem = dkv_smem<D>();
    if (int rc = prepare(flash_bwd_dkv_kernel<D>, smem)) return rc;
    const dim3 grid(B * KVH, S / DKV_BK);
    flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)di, (bf16*)dk, (bf16*)dv, S, H, KVH,
        qs, ks, vs, dos, scale, causal);
    return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* di, void* dq, int B, int S, int H,
              int KVH, int causal, float scale, Strides qs, Strides ks,
              Strides vs, Strides dos, cudaStream_t stream) {
    const int smem = dq_smem<D>();
    if (int rc = prepare(flash_bwd_dq_kernel<D>, smem)) return rc;
    const dim3 grid(B * H, S / DQ_BQ);
    flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)di, (bf16*)dq, S, H, KVH, qs, ks, vs,
        dos, scale, causal);
    return (int)cudaGetLastError();
}

constexpr int BAD_SHAPE = -1;

// the wrapper checks shapes too; this guards the C interface itself
bool shape_ok(int B, int S, int H, int KVH) {
    return B > 0 && S > 0 && S % 64 == 0 && S / 64 <= 65535 && H > 0
        && KVH > 0 && H % KVH == 0;
}

}  // namespace

// Strides are in elements, for the [B, S, H, D] views: (batch, seq, head).
// Each function returns 0, BAD_SHAPE (-1) or a cudaError_t code.

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
    if (D == 128)
        return launch_dq<128>(q, k, v, dout, lse, di, dq, B, S, H, KVH,
                              causal, scale, qs, ks, vs, dos, st);
    if (D == 64)
        return launch_dq<64>(q, k, v, dout, lse, di, dq, B, S, H, KVH, causal,
                             scale, qs, ks, vs, dos, st);
    return BAD_SHAPE;
}
