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
// 1.04 and 0.78 ms, above the bytes' 0.2-0.3 ms.  Every design keeps S
// and P out of device memory (scores in registers, P fed back to the
// tensor cores from the registers that hold it) and skips the tiles
// wholly above the diagonal, which halves the work.
//
// The forward and dK/dV kernels are built for Hopper's own path to the
// tensor cores.  A block is three warpgroups (384 threads):
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
// S need only be a multiple of 64, so a 128-row tile can run half past
// the end: the TMA fills those rows with zeros, keys at or past S are
// masked (a zero key would score 0, not -inf) and rows at or past S are
// not stored.
// These replace v3's forward and dK/dV (mma.sync.m16n8k16 fed by
// ldmatrix, 4 warps of 16 rows, cp.async double buffering, 2 blocks per
// SM); PERF.md keeps both versions' times, and what was measured to bound
// the new ones.

// The dQ kernel is still v3: mma.sync.m16n8k16 with operands loaded from
// shared memory by ldmatrix, 4 warps per block, each owning 16 of the
// block's 64 query rows and walking the key blocks of 64 up to the
// diagonal (a k loop inside each q block, the Pallas split), the K and V
// tiles coming in by cp.async into two stages.
//
// Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface (the extern "C"
// functions at the end), loaded by kubeflow_tpu_torch/ops/
// flash_attention.py through ctypes.  The TMA descriptors are encoded on
// the host for each call by libcuda's cuTensorMapEncodeTiled, which the
// CUDA runtime hands over by name, so nothing links against libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {   // element strides of a [B, S, H, D] view
    long long b, s, h;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

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

// ------------------------------------------- Hopper machinery (fwd, dK/dV)

constexpr int WG_THREADS = 128;                  // one warpgroup
constexpr int HOPPER_THREADS = 3 * WG_THREADS;   // producer + 2 consumers
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int STAGES = 2;
constexpr int BOX = 64;          // bf16 columns of one 128-byte swizzled box
constexpr int ROW_BYTES = 128;   // a box row
constexpr int FWD_BQ = 128, FWD_BK = 128;
constexpr int DKV_BK = 128, DKV_BQ = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the producer's arrival, announcing the bytes its copies will complete
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done != 0;
}

// wait for the completion of the barrier's phase of this parity (its n-th
// completion has parity n & 1).  No timeout that traps: a trap block shared
// by the producer's and the consumers' code made ptxas spill the consumers'
// registers and serialize their wgmma (measured on an H100).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    while (!mbar_try(bar, parity)) {
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

// one box of a rank-4 tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// contiguous bytes (a multiple of 16, 16-byte aligned) into shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// at most N of this warpgroup's latest committed groups still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// registers a wgmma reads or writes asynchronously: the compiler must not
// move their reads above the wait, nor their writes past the wgmma, nor
// reuse them in between
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand whose
// atoms (8 rows of 128 bytes, 1024-byte aligned) follow each other every
// 1024 bytes (SBO).  lbo is the byte step between 64-column boxes of an
// MN-major operand (ignored for K-major ones).  A K step of 16 inside an
// atom adds 32 bytes to the address of a K-major operand, 16 rows (2048
// bytes) to that of an MN-major one.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
    return (uint64_t)((addr >> 4) & 0x3FFF)
        | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
        | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// a descriptor the compiler must recompute where it is used: the K steps'
// descriptors are then base + constant, each formed just before its wgmma,
// instead of one register pair each held across the loop
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
    asm volatile("" : "+l"(d));
    return d;
}

// d (+)= A B, m64nNk16, bf16 in, fp32 accumulate.  Accumulator layout, for
// the thread's warp w of the warpgroup, g = lane / 4, t = lane % 4:
// d[4j + e] is row 16w + g + 8 (e / 2), col 8j + 2t + (e % 2).
//   wgmma_ss: A and B from shared memory, both K-major (scale_d 0: d = AB)
//   wgmma_rs: A from registers, B MN-major (transposed): d += AB; a[0..3]
//             hold (row g, cols 2t..2t+1), (g+8, 2t..), (g, 2t+8..),
//             (g+8, 2t+8..) of the warp's 16 x 16 slice, which is the
//             accumulator layout of cols 16k..16k+15
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33,"
        " p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65,"
        " p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36,"
        " p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68,"
        " p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// P (or dS) as the A operand of the next product: cols 16k..16k+15 of a
// 64-row fp32 accumulator, rounded to bf16
template <int N>
__device__ __forceinline__ void acc_to_a_wg(uint32_t (&a)[4],
                                            const float (&d)[N], int k) {
    a[0] = pack_bf16(d[8 * k + 0], d[8 * k + 1]);
    a[1] = pack_bf16(d[8 * k + 2], d[8 * k + 3]);
    a[2] = pack_bf16(d[8 * k + 4], d[8 * k + 5]);
    a[3] = pack_bf16(d[8 * k + 6], d[8 * k + 7]);
}

// shared memory, from a 1024-byte aligned base (each tile BOXES boxes of
// rows x 128 bytes, every box 1024-byte aligned), then the barriers
template <int D>
struct FwdSmem {
    static constexpr int Q_BYTES = FWD_BQ * D * 2;
    static constexpr int KV_BYTES = FWD_BK * D * 2;
    static constexpr int Q_OFF = 0;
    static constexpr int KV_OFF = Q_BYTES;   // stage s: K, then V
    static constexpr int BAR_OFF = KV_OFF + STAGES * 2 * KV_BYTES;
    static constexpr int BYTES = BAR_OFF + 64 + 1024;   // + alignment slack
};

template <int D>
struct DkvSmem {
    static constexpr int KV_BYTES = DKV_BK * D * 2;
    static constexpr int QT_BYTES = DKV_BQ * D * 2;
    static constexpr int K_OFF = 0, V_OFF = KV_BYTES;
    static constexpr int STAGE_OFF = 2 * KV_BYTES;   // stage s: Q, then dO
    static constexpr int ROWS_OFF = STAGE_OFF + STAGES * 2 * QT_BYTES;
                                                     // stage s: lse, di
    static constexpr int ROW_BYTES_F = DKV_BQ * 4;
    static constexpr int BAR_OFF = ROWS_OFF + STAGES * 2 * ROW_BYTES_F;
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
    const int nkb = causal ? qb + 1 : (S + FWD_BK - 1) / FWD_BK;
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
        const int row0 = qb * FWD_BQ + c * 64 + warp * 16 + (lane >> 2);
                                                        // and row0 + 8
        const uint32_t sq = base + L::Q_OFF + c * 64 * ROW_BYTES;

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

            // S = Q K^T: this consumer's 64 rows x 128 keys
            float sc[FWD_BK / 2];
            const uint64_t qd = opaque(sw128_desc(sq, 16));
            const uint64_t kd = opaque(sw128_desc(sk, 16));
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const int off = (kk % 4) * 32;
                wgmma_ss<FWD_BK>(
                    sc, qd + ((kk / 4) * FWD_BQ * ROW_BYTES + off) / 16,
                    kd + ((kk / 4) * FWD_BK * ROW_BYTES + off) / 16, kk > 0);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(sc);

            // online softmax in log2 units.  Only the diagonal tile and a
            // tile that runs past S are masked, in a pass of their own:
            // element 4j + e is key kb*BK + t2 + 8j + (e & 1) of row
            // row0 + 8 (e / 2), so each test is a constant against a limit
#pragma unroll
            for (int i = 0; i < FWD_BK / 2; ++i) sc[i] *= sl2;
            if ((causal && kb == qb) || (kb + 1) * FWD_BK > S) {
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
                wgmma_rs<D>(acc, pa[kk], vd + kk * 16 * ROW_BYTES / 16);
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
    } else {
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
                    wgmma_ss<DKV_BQ>(
                        st, kd + ((kk / 4) * DKV_BK * ROW_BYTES + off) / 16,
                        qd + ((kk / 4) * DKV_BQ * ROW_BYTES + off) / 16,
                        kk > 0);
                }
                wgmma_commit();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk) {
                    const int off = (kk % 4) * 32;
                    wgmma_ss<DKV_BQ>(
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
                    wgmma_rs<D>(dva, pa[kk], dot + kk * 16 * ROW_BYTES / 16);
#pragma unroll
                for (int kk = 0; kk < DKV_BQ / 16; ++kk)
                    wgmma_rs<D>(dka, dsa[kk], qt + kk * 16 * ROW_BYTES / 16);
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
    }
}

// -------------------------------------------------- dQ (mma.sync, v3)

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;    // bf16 of padding per shared-memory row: keeps
                          // 16-byte row alignment and spreads a fragment's
                          // rows over all 32 banks
constexpr int DQ_BQ = 64, DQ_BK = 64;

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

template <int D>
constexpr int dq_smem() { return (2 * DQ_BQ + 4 * DQ_BK) * (D + PAD) * 2; }

template <typename Kernel>
int prepare(Kernel kernel, int smem_bytes) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

constexpr int BAD_SHAPE = -1;
constexpr int TMA_ERROR = -2;   // no tensor-map encoder, or it refused

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t rc = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t rc = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

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
    const int smem = dq_smem<D>();
    if (int rc = prepare(flash_bwd_dq_kernel<D>, smem)) return rc;
    const dim3 grid(B * H, S / DQ_BQ);
    flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
        (const float*)lse, (const float*)di, (bf16*)dq, S, H, KVH, qs, ks, vs,
        dos, scale, causal);
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
