// Flash attention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces opadpo_tpu/ops/attention.py:_fwd_kernel (launched by
// _flash_fwd): one CTA per (batch, head, 128-row query tile) walks the KV
// tiles and keeps the online softmax (running max m, sum l, output
// accumulator) in f32 registers.
//
// Semantics follow the JAX kernel and mha_reference exactly:
// - the key mask arrives as an additive f32 bias [B, Skv] (0 valid / -1e30
//   masked; NULL: every key valid); the producer copies each tile's slice
//   to shared memory with -inf from Skv on, so keys at or past Skv score
//   -inf and the consumers need no bound test; the causal rule is
//   col <= row + offset, and causally hidden keys score the finite -1e30
//   (-inf past Skv), never the bias's sum with it.  Sq queries attend Skv
//   keys; offset is Skv - Sq (queries aligned to the end of the keys): 0
//   for square self-attention, the prefix length for the shared-prefix
//   response stream, whose keys are [prefix ++ response];
// - m starts at -inf, and o = acc / l_safe, lse = m + log(l_safe) with
//   l_safe = (l == 0 ? 1 : l) and lse = -1e30 where l == 0 or the row saw
//   no valid key (m = -1e30: -1e30 + log(Skv) is -1e30 in f32);
// - causal tiles past the diagonal are skipped, but a query tile holding a
//   row that sees no valid key walks every tile, so that row comes out
//   uniform over all Skv keys, as mha_reference gives it.  The tile count
//   is fixed before the loop: the wrapper computes it for every (batch
//   row, query tile) (ops/attention.py:kv_tile_count) and the kernel reads
//   it, so producer and consumers agree on it without a vote.
// The scores are taken in log2 units (scale * log2 e folded in, exp2); a
// masked score keeps the value -1e30, which is all the rules above use.
//
// What bounds it: causal LLaMA prefill does ~4*S^2*D/2 flops per (b, h)
// against S*D*2*4 bytes; at S=703, D=128 the data sheet's rates make it
// bytes-bound by a small margin, and the response stream (896 queries over
// 1599 keys) operations-bound.  So both products run on wgmma and the
// loads stay off the compute warps:
// - warp specialisation: warpgroups 0 and 1 consume (64 query rows each,
//   registers raised to 232 by setmaxnreg), warpgroup 2 produces (registers
//   lowered to 40; one thread issues every copy, its warp fills the bias);
// - TMA: Q [128 rows] once, then K and V tiles of 128 keys into a ring of
//   NST stages in shared memory, each with a K-full (its TMA bytes and the
//   producer warp's 32 bias writes), a V-full and an empty mbarrier; the
//   [B, S, H, D] views are read by their strides through 4-D
//   tensor maps (dims D, S, H, B), 128-byte swizzled, a 64-column box per
//   slab (D 128 is two slabs); rows past S and columns past D (D 32 runs as
//   64) arrive as zeros, so nothing is padded in device memory;
// - S = Q K^T on wgmma m64n128k16 from shared memory (both K-major); the
//   softmax runs on the accumulator fragments (row max and sum over the
//   four lanes of a quad); P goes to bf16 A fragments in registers and
//   O += P V runs on wgmma's register-A form with V MN-major in shared
//   memory.  Nothing passes through shared memory between the products;
// - within a warpgroup, tile j+1's scores are issued before tile j's P V,
//   and tile j+1's softmax runs while P V does.  A consumer then holds two
//   stages (K of j+1, V of j), so the ring has three: at two the loads
//   were exposed and the overlap lost time;
// - the causal test runs only on tiles that reach past the tile's first
//   row's diagonal; the bias is added on every tile.
// Not done yet: a persistent grid, clusters and multicast, ping-pong of
// the consumer warpgroups.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 128;            // query rows per CTA, 64 per consumer warpgroup
constexpr int BK = 128;            // keys per K/V tile
constexpr int NST = 3;             // stages of the K/V ring (227 KB at D 128)
constexpr int NTHREADS = 384;      // consumer warpgroups 0, 1; producer 2
constexpr int SLAB = 128 * 128;    // 128 rows of 64 bf16: one swizzle span wide
constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// shared memory, byte offsets from a 1024-aligned base (the swizzle's period)
template <int DP>
struct Smem {
  static constexpr int NSLAB = DP / 64;
  static constexpr int TILE = NSLAB * SLAB;     // one Q, K or V tile
  static constexpr int Q = 0;
  static constexpr int K = TILE;
  static constexpr int V = K + NST * TILE;
  static constexpr int BIAS = V + NST * TILE;
  static constexpr int BAR = BIAS + NST * BK * 4;
  // mbarriers: Q-full, then K-full, V-full and empty for each stage
  static constexpr int BYTES = BAR + 8 * (1 + 3 * NST);
  static constexpr int ALLOC = BYTES + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// raise the transaction bytes the barrier's current phase waits for,
// without arriving
__device__ __forceinline__ void mbar_add_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (K-major: SBO = 1024 between 8-row groups; MN-major:
// LBO between 64-column slabs, SBO = 1024 between 8-row groups of K)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving register reads or writes across an
// asynchronous wgmma's issue or wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define F16(a, i) F4(a, i), F4(a, i + 4), F4(a, i + 8), F4(a, i + 12)

// d[64x128] (+)= A[64x16] B[16x128], both from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F16(d, 0), F16(d, 16), F16(d, 32), F16(d, 48)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64x128] += A[64x16] (registers) B[16x128] (shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n}\n"
      : F16(d, 0), F16(d, 16), F16(d, 32), F16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64x64] += A[64x16] (registers) B[16x64] (shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F16(d, 0), F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F16
#undef F4

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulator fragments (wgmma m64nN, f32): thread t of a warpgroup holds
// rows (t/32)*16 + (t%32)/4 (+8) and, for each 8-column block n, columns
// 8n + 2(t%4) (+1): d[4n], d[4n+1] on the first row, d[4n+2], d[4n+3] on
// the second.  The same pairs, as bf16, are the A fragments of P V.

// issue S = Q K^T for one tile: D/16 steps of 16 columns, 32 bytes apart in
// a 64-column slab
template <int DP>
__device__ __forceinline__ void issue_scores(float (&sc)[64], uint32_t qa,
                                             uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk / 4) * SLAB + (kk % 4) * 32;
    wgmma_ss_n128(sc, sw128_desc(qa + off, 16, 1024),
                  sw128_desc(ka + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// issue O += P V for one tile: 16 keys a step, 16 rows of 128 bytes apart
template <int DP>
__device__ __forceinline__ void issue_pv(float (&oacc)[DP / 2],
                                         const uint32_t (&pa)[32],
                                         uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t af[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                            pa[4 * kk + 3]};
    const uint64_t db = sw128_desc(va + kk * 2048, SLAB, 1024);
    if constexpr (DP == 128)
      wgmma_rs_n128(oacc, af, db);
    else
      wgmma_rs_n64(oacc, af, db);
  }
  wgmma_commit();
}

// One tile's online softmax on the score fragments, in place: scores to
// log2 units plus the key bias, the causal rule where `diag` (a key is
// hidden iff lim - 8n - e < 0, lim = row + offset - k0 - 2(t%4) for the
// first row), the running max (m), this thread's share of the running sum
// (l), sc = exp2(x - m) and the factors (a) the output rescales by.
__device__ __forceinline__ void softmax_tile(float (&sc)[64],
                                             const float* bias_s, int c2,
                                             bool diag, int lim,
                                             float scale_log2, float (&m)[2],
                                             float (&l)[2], float (&a)[2]) {
  float mx0 = m[0], mx1 = m[1];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const float2 bb = *reinterpret_cast<const float2*>(bias_s + n * 8 + c2);
    float x0 = fmaf(sc[4 * n], scale_log2, bb.x);
    float x1 = fmaf(sc[4 * n + 1], scale_log2, bb.y);
    float x2 = fmaf(sc[4 * n + 2], scale_log2, bb.x);
    float x3 = fmaf(sc[4 * n + 3], scale_log2, bb.y);
    if (diag) {
      const int lim0 = lim - 8 * n;
      if (lim0 < 0) x0 = fminf(kMask, bb.x);
      if (lim0 < 1) x1 = fminf(kMask, bb.y);
      if (lim0 < -8) x2 = fminf(kMask, bb.x);
      if (lim0 < -7) x3 = fminf(kMask, bb.y);
    }
    sc[4 * n] = x0;
    sc[4 * n + 1] = x1;
    sc[4 * n + 2] = x2;
    sc[4 * n + 3] = x3;
    mx0 = fmaxf(mx0, fmaxf(x0, x1));
    mx1 = fmaxf(mx1, fmaxf(x2, x3));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  a[0] = ex2(m[0] - mx0);
  a[1] = ex2(m[1] - mx1);
  m[0] = mx0;
  m[1] = mx1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    sc[4 * n] = ex2(sc[4 * n] - mx0);
    sc[4 * n + 1] = ex2(sc[4 * n + 1] - mx0);
    sc[4 * n + 2] = ex2(sc[4 * n + 2] - mx1);
    sc[4 * n + 3] = ex2(sc[4 * n + 3] - mx1);
    ps0 += sc[4 * n] + sc[4 * n + 1];
    ps1 += sc[4 * n + 2] + sc[4 * n + 3];
  }
  l[0] = l[0] * a[0] + ps0;        // quads sum their shares at the end
  l[1] = l[1] * a[1] + ps1;
}

// P (f32 fragments) to the bf16 A fragments of P V
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&pa)[32]) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    pa[2 * n] = pack_bf16(sc[4 * n], sc[4 * n + 1]);
    pa[2 * n + 1] = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ kbias,
                 const int* __restrict__ tile_counts, int counts_ld,
                 bf16* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int H, int causal,
                 int offset, float scale_log2) {
  constexpr int DP = D < 64 ? 64 : D;      // D 32 runs as 64, the rest zeros
  using L = Smem<DP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar_q = sbase + L::BAR;
  auto full_k = [&](int s) { return bar_q + 8 * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8 * (1 + NST + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + 2 * NST + s); };

  const int qt = gridDim.x - 1 - blockIdx.x;          // longest tiles first
  const int q0 = qt * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ntiles = tile_counts[b * counts_ld + qt];
  // tiles below `inner` lie wholly at or left of the first row's diagonal
  const int inner = causal ? (q0 + offset + 1) / BK : ntiles;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(full_k(s), 32);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: thread 256 issues every copy, its warp the bias ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x - 256;
      if (lane == 0) {
        mbar_expect_tx(bar_q, L::TILE);
        for (int sl = 0; sl < L::NSLAB; ++sl)
          tma_load_4d(sbase + L::Q + sl * SLAB, &tq, bar_q, sl * 64, q0, h, b);
      }
      const float* brow = kbias ? kbias + int64_t(b) * Skv : nullptr;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % NST;
        if (j >= NST) mbar_wait(empty(s), ((j / NST) - 1) & 1);
        if (lane == 0) {
          mbar_add_tx(full_k(s), L::TILE);
          for (int sl = 0; sl < L::NSLAB; ++sl)
            tma_load_4d(sbase + L::K + s * L::TILE + sl * SLAB, &tk,
                        full_k(s), sl * 64, j * BK, h, b);
          mbar_expect_tx(full_v(s), L::TILE);
          for (int sl = 0; sl < L::NSLAB; ++sl)
            tma_load_4d(sbase + L::V + s * L::TILE + sl * SLAB, &tv,
                        full_v(s), sl * 64, j * BK, h, b);
        }
        float* bias_s = reinterpret_cast<float*>(smem + L::BIAS + s * BK * 4);
#pragma unroll
        for (int e = 0; e < BK / 32; ++e) {
          const int col = j * BK + e * 32 + lane;
          bias_s[e * 32 + lane] =
              col < Skv ? (brow ? __ldg(brow + col) : 0.f) : -INFINITY;
        }
        mbar_arrive(full_k(s));          // each lane, after its writes
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r0 = q0 + wg * 64 + (t / 32) * 16 + lane / 4;  // and r0 + 8
    const int c2 = (lane % 4) * 2;
    float sc[64];
    float oacc[DP / 2];
    uint32_t pa[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2];
    const uint32_t qa = sbase + L::Q + wg * 64 * 128;
    const int lim = r0 + offset - c2;
    auto bias_tile = [&](int j) {
      return reinterpret_cast<const float*>(smem + L::BIAS +
                                            (j % NST) * BK * 4);
    };

    // tile 0's scores and softmax; then each step issues tile j+1's scores
    // and tile j's P V, and runs tile j+1's softmax while P V runs
    mbar_wait(bar_q, 0);
    mbar_wait(full_k(0), 0);
    fence_regs(sc);
    wgmma_fence();
    issue_scores<DP>(sc, qa, sbase + L::K);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, bias_tile(0), c2, 0 >= inner, lim, scale_log2, m, l, a);
    pack_p(sc, pa);

    for (int j = 0; j + 1 < ntiles; ++j) {
      const int s = j % NST;
      const int sn = (j + 1) % NST;
      mbar_wait(full_v(s), (j / NST) & 1);
      mbar_wait(full_k(sn), ((j + 1) / NST) & 1);
      fence_regs(sc);
      fence_regs(oacc);
      fence_regs(pa);
      wgmma_fence();
      issue_scores<DP>(sc, qa, sbase + L::K + sn * L::TILE);
      issue_pv<DP>(oacc, pa, sbase + L::V + s * L::TILE);
      wgmma_wait<1>();                   // the scores; P V may still run
      fence_regs(sc);
      softmax_tile(sc, bias_tile(j + 1), c2, j + 1 >= inner,
                   lim - (j + 1) * BK, scale_log2, m, l, a);
      wgmma_wait<0>();
      fence_regs(oacc);
      fence_regs(pa);
      mbar_arrive(empty(s));
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        oacc[4 * n] *= a[0];
        oacc[4 * n + 1] *= a[0];
        oacc[4 * n + 2] *= a[1];
        oacc[4 * n + 3] *= a[1];
      }
      pack_p(sc, pa);
    }
    {                                    // the last tile's P V
      const int s = (ntiles - 1) % NST;
      mbar_wait(full_v(s), ((ntiles - 1) / NST) & 1);
      fence_regs(oacc);
      fence_regs(pa);
      wgmma_fence();
      issue_pv<DP>(oacc, pa, sbase + L::V + s * L::TILE);
      wgmma_wait<0>();
      fence_regs(oacc);
      mbar_arrive(empty(s));
    }

    float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
    const float m0 = m[0], m1 = m[1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r >= Sq) continue;
      const float lh = half ? l1 : l0;
      const float mh = half ? m1 : m0;
      const float inv = 1.f / (lh == 0.f ? 1.f : lh);
      bf16* orow = o + ((int64_t(b) * Sq + r) * H + h) * D;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        if (n * 8 < D)
          *reinterpret_cast<uint32_t*>(orow + n * 8 + c2) =
              pack_bf16(oacc[4 * n + 2 * half] * inv,
                        oacc[4 * n + 2 * half + 1] * inv);
      }
      if ((lane & 3) == 0)
        lse[(int64_t(b) * H + h) * Sq + r] =
            (lh == 0.f || mh <= 0.5f * kMask) ? kMask : mh * kLn2 + logf(lh);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in the driver (libcuda), which the CUDA
// runtime has loaded already; taking it by dlsym needs no -lcuda at build
// time and no particular runtime version's entry-point API.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// 4-D map over a bf16 [B, S, H, D] view with element strides st = (b, s,
// h), unit stride on D: dims (D, S, H, B), a box of 64 columns x 128 rows
constexpr int kErrNoEncode = -1;        // returned when the driver lacks it
constexpr int kErrEncodeBase = 100000;  // + the CUresult of a failed encode

int make_map(CUtensorMap* map, const void* base, int S, int H, int B, int D,
             const int64_t* st) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(H),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(st[1]) * 2, cuuint64_t(st[2]) * 2,
                                 cuuint64_t(st[0]) * 2};
  const cuuint32_t box[4] = {64, 128, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase + int(r);
}

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const float* kbias, const int* tile_counts, int counts_ld, void* o,
           float* lse, int B, int Sq, int Skv, int H, int causal, int offset,
           float scale_log2, cudaStream_t stream) {
  constexpr int smem = Smem<(D < 64 ? 64 : D)>::ALLOC;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return int(e);
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      tq, tk, tv, kbias, tile_counts, counts_ld, static_cast<bf16*>(o), lse,
      Sq, Skv, H, causal, offset, scale_log2);
  return int(cudaGetLastError());
}

}  // namespace

// dynamic shared memory of the kernel for head width D (its ring, Q, the
// bias tiles, the barriers and 1024 bytes of alignment slack)
extern "C" int opadpo_flash_fwd_smem_bytes(int D) {
  return D == 128 ? Smem<128>::ALLOC : Smem<64>::ALLOC;
}

// q: bf16 [B, Sq, H, D], k, v: bf16 [B, Skv, H, D], with element strides
// (b, s, h) given in `strides` (9 values: q then k then v), unit stride on
// D, 16-byte aligned rows; kbias: f32 [B, Skv] additive key bias (0 or
// -1e30), or NULL for every key valid; tile_counts: int32, the KV tiles
// query tile t of batch row b walks at tile_counts[b * counts_ld + t]
// (counts_ld 0: one row for all b); o: bf16 [B, Sq, H, D] contiguous;
// lse: f32 [B, H, Sq] contiguous; causal rule col <= row + offset.
// Returns 0, the cudaError_t of the launch, -1 if the driver has no
// cuTensorMapEncodeTiled, or 100000 + its CUresult.
extern "C" int opadpo_flash_fwd_bf16(const void* q, const void* k,
                                     const void* v, const void* kbias,
                                     const void* tile_counts, int counts_ld,
                                     void* o, void* lse, int B, int Sq,
                                     int Skv, int H, int D,
                                     const int64_t* strides, int causal,
                                     int offset, float scale, void* stream) {
  if (D != 32 && D != 64 && D != 128) return int(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, Sq, H, B, D, strides);
  if (err == 0) err = make_map(&tk, k, Skv, H, B, D, strides + 3);
  if (err == 0) err = make_map(&tv, v, Skv, H, B, D, strides + 6);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kb = static_cast<const float*>(kbias);
  const int* tc = static_cast<const int*>(tile_counts);
  float* ls = static_cast<float*>(lse);
  const float sl2 = scale * kLog2e;
  if (D == 128)
    return launch<128>(tq, tk, tv, kb, tc, counts_ld, o, ls, B, Sq, Skv, H,
                       causal, offset, sl2, st);
  if (D == 64)
    return launch<64>(tq, tk, tv, kb, tc, counts_ld, o, ls, B, Sq, Skv, H,
                      causal, offset, sl2, st);
  return launch<32>(tq, tk, tv, kb, tc, counts_ld, o, ls, B, Sq, Skv, H,
                    causal, offset, sl2, st);
}
