// Hopper (sm_90a) building blocks shared by the flash kernels
// (flash_fwd.cu, flash_bwd.cu), the quant matmuls (int8_matmul.cu,
// int4_matmul.cu), the cluster decode kernels (decode_attention.cu) and the
// head split (heads_layout.cu): mbarriers, 1-D bulk copies, cluster
// barriers and distributed shared-memory stores, TMA tensor loads and
// stores, 128-byte swizzled wgmma descriptors and the wgmma forms they
// use, the accumulator-fragment helpers, the matmuls' stage ring and
// output store, and the host-side encoding of the 4-D tensor maps over
// strided [B, S, H, D] bf16 views (swizzled, and unswizzled with any box),
// of the 3-D maps over strided bf16 tensors and of the 2-D maps over
// contiguous bf16 / int8 matrices.
//
// Fragment layout (wgmma m64nN, f32 accumulators): thread t of a
// warpgroup holds rows (t/32)*16 + (t%32)/4 (+8) and, for each 8-column
// block n, columns 8n + 2(t%4) (+1): d[4n], d[4n+1] on the first row,
// d[4n+2], d[4n+3] on the second.  The same pairs, packed to bf16 by
// pack_acc, are the A fragments of a register-A wgmma whose depth runs
// over those columns.
//
// Shared-memory tiles are 128-byte swizzled, as TMA writes them: a tile of
// R rows and D columns is D/64 slabs of R rows x 128 bytes, each slab
// 1024-aligned.  As a K-major operand (depth along the columns) a tile's
// descriptor steps 32 bytes per 16 columns inside a slab and a slab per
// 64; as an MN-major B operand (depth along the rows) it steps 16 rows
// (2048 bytes) per wgmma, with the slab size as the leading byte offset.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace hopper {

typedef __nv_bfloat16 bf16;

constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// bulk tensor store of the box at shared address `src` through a 3-D map,
// in this thread's current bulk async-group; elements of the box outside
// the tensor are not written.  The writer threads fence their shared
// stores to the async proxy (fence_proxy_async) and sync before one
// thread issues it, and that thread waits for the read (bulk_wait_read)
// before the box is overwritten or the CTA exits.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// close this thread's current bulk async-group (the stores issued since)
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk groups still read shared
// memory (their sources may then be overwritten or freed)
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// fetch a tensor map's descriptor ahead of its first TMA copy
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global memory to this CTA's shared memory, completing on
// the barrier's transaction count
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- thread-block clusters ----

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// the cluster barrier, split: every thread of every CTA arrives, then
// waits.  After a release arrival, the thread's writes before it are
// visible to the cluster's reads after the wait; a relaxed arrival early
// and a wait before the first distributed shared-memory access show that
// every CTA of the cluster has started.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared-memory address of `p` in the CTA of cluster rank `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void st_cluster4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// make this thread's ordinary shared-memory stores visible to the async
// proxy (wgmma operands read from shared memory)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` over the first `count` threads of the block
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
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

#define HOPPER_F4(a, i) \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define HOPPER_F16(a, i)                                       \
  HOPPER_F4(a, i), HOPPER_F4(a, i + 4), HOPPER_F4(a, i + 8), \
      HOPPER_F4(a, i + 12)

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
      : HOPPER_F16(d, 0), HOPPER_F16(d, 16), HOPPER_F16(d, 32),
        HOPPER_F16(d, 48)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64x64] (+)= A[64x16] B[16x64], both from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_F16(d, 0), HOPPER_F16(d, 16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64x16] (+)= A[64x16] B[16x16], both from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_F4(d, 0), HOPPER_F4(d, 4)
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
      : HOPPER_F16(d, 0), HOPPER_F16(d, 16), HOPPER_F16(d, 32),
        HOPPER_F16(d, 48)
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
      : HOPPER_F16(d, 0), HOPPER_F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64x16] (+)= A[64x16] (registers) B[16x16] (shared memory, K-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n}\n"
      : HOPPER_F4(d, 0), HOPPER_F4(d, 4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef HOPPER_F16
#undef HOPPER_F4

// D accumulator (64 x DN, D = DN/2 floats a thread) += A (registers, 4
// fragments of 16 columns each) times the MN-major tile at `b` (16 depth
// rows per step, 2048 bytes apart; slabs of `slab` bytes): the register-A
// product of every consumer, with D 64 or 128 wide.
template <int DN, int KSTEPS>
__device__ __forceinline__ void issue_rs(float (&d)[DN / 2],
                                         const uint32_t (&a)[4 * KSTEPS],
                                         uint32_t b, uint32_t slab) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint32_t af[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                            a[4 * kk + 3]};
    const uint64_t db = sw128_desc(b + kk * 2048, slab, 1024);
    if constexpr (DN == 128)
      wgmma_rs_n128(d, af, db);
    else
      wgmma_rs_n64(d, af, db);
  }
  wgmma_commit();
}

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

// f32 accumulator fragments (N columns, N/2 a thread) to the bf16 A
// fragments of a register-A product over those columns
template <int N>
__device__ __forceinline__ void pack_acc(const float (&sc)[N],
                                         uint32_t (&pa)[N / 2]) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    pa[2 * n] = pack_bf16(sc[4 * n], sc[4 * n + 1]);
    pa[2 * n + 1] = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
  }
}

// one thread's two rows of an f32 accumulator (64 x DN) to bf16 rows of a
// contiguous [B, S, H, D] output: `row0` (and row0 + 8) at `base` (the
// element of (b, row 0, h, column 0)) with `row_stride` elements between
// rows; rows at or past `n_rows` are dropped
template <int DN>
__device__ __forceinline__ void store_rows(const float (&acc)[DN / 2],
                                           bf16* base, int64_t row_stride,
                                           int row0, int n_rows, int c2) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 8 * half;
    if (r >= n_rows) continue;
    bf16* out = base + int64_t(r) * row_stride;
#pragma unroll
    for (int n = 0; n < DN / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8 + c2) =
          pack_bf16(acc[4 * n + 2 * half], acc[4 * n + 2 * half + 1]);
  }
}

// ---- the quant matmuls' stage ring (int8_matmul.cu, int4_matmul.cu) ----

// shared memory: byte offsets from a 1024-aligned base.  NST stages, each
// the activation tile (A bytes) then the raw weight tile (W); then two
// widened tiles (WIDE_ each), NS scale slices (S each: #10 one a stage,
// #11's tile kernel two), the full and empty barriers, and a word for the
// decode kernels' ticket.
template <int A_, int W_, int WIDE_, int NST_, int S_ = 0, int NS_ = NST_>
struct Layout {
  static constexpr int A = A_, W = W_, S = S_, NST = NST_;
  static constexpr int STAGE = A + W;
  static constexpr int WIDE = NST * STAGE;
  static constexpr int SC = WIDE + 2 * WIDE_;
  static constexpr int BAR = SC + NS_ * S;
  static constexpr int FLAG = BAR + 16 * NST;
  static constexpr int BYTES = FLAG + 16;
  static constexpr int ALLOC = BYTES + 1024;
  static_assert(A % 1024 == 0 && W % 1024 == 0 && WIDE_ % 1024 == 0,
                "tiles keep the 1024-byte swizzle period");
  static_assert(ALLOC <= 232448, "more than a block's shared memory");
};

// the full and empty barriers of an NST-stage ring at byte `bar` of the
// 1024-aligned base
template <int NST>
struct Ring {
  unsigned char* smem;
  uint32_t base;
  int bar;
  __device__ uint32_t full(int s) const { return base + bar + 8 * s; }
  __device__ uint32_t empty(int s) const {
    return base + bar + 8 * (NST + s);
  }
};

// align the dynamic shared memory to 1024 bytes and initialise the ring of
// layout L: one arrival (the producer's, with the transaction bytes) fills
// a stage, CONSUMERS arrivals empty it
template <typename L, int CONSUMERS = 256>
__device__ __forceinline__ Ring<L::NST> ring_setup(unsigned char* raw_smem) {
  const uint32_t raw = smem_u32(raw_smem);
  Ring<L::NST> r;
  r.smem = raw_smem + ((1024 - (raw & 1023)) & 1023);
  r.base = smem_u32(r.smem);
  r.bar = L::BAR;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::NST; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// out[o] (and out[o + 1]) of a bf16 or f32 output; `pair` when both lie in
// the row and the pair is aligned
__device__ __forceinline__ void store2(void* out, int out_f32, int64_t o,
                                       float v0, float v1, bool has1,
                                       bool pair) {
  if (out_f32) {
    float* p = static_cast<float*>(out) + o;
    if (pair) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    } else {
      p[0] = v0;
      if (has1) p[1] = v1;
    }
  } else {
    bf16* p = static_cast<bf16*>(out) + o;
    if (pair) {
      *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
    } else {
      p[0] = __float2bfloat16(v0);
      if (has1) p[1] = __float2bfloat16(v1);
    }
  }
}

// ---- host side: tensor maps ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in the driver (libcuda), which the CUDA
// runtime has loaded already; taking it by dlsym needs no -lcuda at build
// time and no particular runtime version's entry-point API.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

constexpr int kErrNoEncode = -1;        // returned when the driver lacks it
constexpr int kErrEncodeBase = 100000;  // + the CUresult of a failed encode

// 4-D map over a bf16 [B, S, H, D] view with element strides st = (b, s,
// h), unit stride on D: dims (D, S, H, B), a box of 64 columns x
// `box_rows` rows, 128-byte swizzle; rows past S and columns past D load
// as zeros
inline int make_map(CUtensorMap* map, const void* base, int S, int H, int B,
                    int D, const int64_t* st, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(H),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(st[1]) * 2, cuuint64_t(st[2]) * 2,
                                 cuuint64_t(st[0]) * 2};
  const cuuint32_t box[4] = {64, cuuint32_t(box_rows), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase + int(r);
}

// 3-D map over bf16 elements: dims (d0, d1, d2), unit stride on d0 and
// byte strides s1, s2 (multiples of 16) on d1 and d2, a box of b0 x b1 x 1,
// no swizzle; a load reads elements outside the dims as zeros, a store
// skips them
inline int make_map_3d_bf16(CUtensorMap* map, const void* base, int64_t d0,
                            int64_t d1, int64_t d2, int64_t s1, int64_t s2,
                            int b0, int b1) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t dims[3] = {cuuint64_t(d0), cuuint64_t(d1), cuuint64_t(d2)};
  const cuuint64_t strides[2] = {cuuint64_t(s1), cuuint64_t(s2)};
  const cuuint32_t box[3] = {cuuint32_t(b0), cuuint32_t(b1), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase + int(r);
}

// 4-D map over bf16 elements: dims (d0, d1, d2, d3), unit stride on d0 and
// byte strides s1, s2, s3 (multiples of 16, in any order) on the others, a
// box of b0 x b1 x b2 x b3, no swizzle; a load reads elements outside the
// dims as zeros
inline int make_map_4d_bf16(CUtensorMap* map, const void* base, int64_t d0,
                            int64_t d1, int64_t d2, int64_t d3, int64_t s1,
                            int64_t s2, int64_t s3, int b0, int b1, int b2,
                            int b3) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t dims[4] = {cuuint64_t(d0), cuuint64_t(d1), cuuint64_t(d2),
                              cuuint64_t(d3)};
  const cuuint64_t strides[3] = {cuuint64_t(s1), cuuint64_t(s2),
                                 cuuint64_t(s3)};
  const cuuint32_t box[4] = {cuuint32_t(b0), cuuint32_t(b1), cuuint32_t(b2),
                             cuuint32_t(b3)};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase + int(r);
}

// 2-D map over a contiguous row-major matrix of `rows` x `cols` elements
// of `elem_bytes` bytes (bf16 or int8; the row, cols * elem_bytes bytes,
// a multiple of 16): dims (cols, rows), a box of `box_cols` x `box_rows`,
// with the swizzle `sw`; elements past either end load as zeros
inline int make_map_2d_sw(CUtensorMap* map, const void* base, int elem_bytes,
                          int64_t cols, int64_t rows, int box_cols,
                          int box_rows, CUtensorMapSwizzle sw) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * elem_bytes};
  const cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(
      map, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(base), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase + int(r);
}

// the same, 128-byte swizzled or not
inline int make_map_2d(CUtensorMap* map, const void* base, int elem_bytes,
                       int64_t cols, int64_t rows, int box_cols, int box_rows,
                       bool swizzle128) {
  return make_map_2d_sw(
      map, base, elem_bytes, cols, rows, box_cols, box_rows,
      swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
}

// 1-D map over a contiguous f32 vector of n values, a box of `box`;
// values past n load as zeros
inline int make_map_1d_f32(CUtensorMap* map, const void* base, int64_t n,
                           int box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t dims[1] = {cuuint64_t(n)};
  const cuuint64_t strides[1] = {0};  // none for rank 1
  const cuuint32_t boxd[1] = {cuuint32_t(box)};
  const cuuint32_t estr[1] = {1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                        const_cast<void*>(base), dims, strides, boxd, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase + int(r);
}

// set a kernel's dynamic shared memory once per process
template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes, bool& configured) {
  if (configured) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return int(e);
  configured = true;
  return 0;
}

}  // namespace hopper
