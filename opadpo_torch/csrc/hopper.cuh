// Hopper (sm_90a) building blocks shared by the flash kernels
// (flash_fwd.cu, flash_bwd.cu): mbarriers, TMA tensor loads, 128-byte
// swizzled wgmma descriptors and the wgmma forms they use, the
// accumulator-fragment helpers, and the host-side encoding of the 4-D
// tensor maps over strided [B, S, H, D] bf16 views.
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
