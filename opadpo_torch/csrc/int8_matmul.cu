// Matrix products over frozen int8 weights for Hopper (sm_90a): TMA rings,
// each weight tile widened once per CTA in shared memory, wgmma.
//
// Replaces two Pallas kernels of opadpo_tpu/ops/quant.py:
// - #9  _q8_matmul_kernel:   y[M, N] = (x[M, K] @ q[N, K]^T, f32 sums)
//                             * scale[N], bf16 or f32 out;
// - #10 _q8_matmul_t_kernel: dx[M, K] = gs[M, N] @ q[N, K], f32 sums, bf16
//                             out, gs = bf16_rne(f32(g) * scale[N]) folded
//                             here as the JAX wrapper folds it.
// The weight q is int8 [N, K], K contiguous; its codes widen exactly to
// bf16.  Three kernels, each with one producer warp (one thread issues
// every TMA copy into a ring of stages behind full / empty mbarriers) and
// two consumer warpgroups:
// - q8_tile (#9, M > 16): a CTA owns 128 rows of x (64 a warpgroup) and
//   BN (256, or 64 where that leaves SMs idle) weight rows, and walks K in 64-deep tiles; the
//   consumers widen each raw int8 weight tile once into a bf16 K-major
//   tile (128-byte swizzle, the layout TMA gives a bf16 tile), and each
//   warpgroup runs wgmma m64nNk16 from shared memory on it;
// - q8_decode (#9, M <= 16): bound by the weight stream.  The transposed
//   product: the widened weight tile is wgmma's M side (64 weight rows a
//   warpgroup, each warpgroup widening its own), the x rows, up to 16, its
//   N (m64n16k16; ptxas 12.8 crashes on this kernel with m64n8k16), so no
//   m16 tile is padded up from 8 rows as mma.sync's were.  The contraction
//   is split over CTAs only as far as needed to fill the card
//   (ops/quant.py:decode_splits); the last CTA of a weight tile to arrive
//   (an atomic ticket) sums the f32 partials in split order, scales and
//   casts: one launch, sums in a fixed order;
// - q8t_tile (#10): a CTA owns 128 rows of g and 256 output columns, and
//   walks the contraction (the weight's rows) in 64-deep tiles: g, raw
//   int8 and scale tiles by TMA; the weight tile widened once into bf16
//   MN-major (the flash forward's V layout); each consumer reads its 64
//   rows of g, folds the scale (f32 product, rounded to bf16) and packs
//   the register-A fragments of two wgmma m64n128k16 per 16-deep step.
// In every loop the next weight tile is widened while the tensor cores run
// on the current one; each wgmma group retires before the loop's back edge
// and the last tile is peeled (ptxas serialises wgmmas in flight across a
// back edge, C7514).  A named barrier of the consumers keeps the halves of
// a widened tile together; two widened buffers alternate.
//
// What bounds them (H100 SXM data sheet): at M ~ 700 the bf16 tensor-core
// rate (2 * 703 operations per weight byte), but the tiles' L2 traffic
// comes first: 256 weight rows a CTA read each x tile for four times the
// work of 64 and ran 18-39 % faster on fewer CTAs on an H100
// (tools/time_quant.py --bn, PERF.md).  At decode the weight bytes.  Widening: each int8 byte is placed into the mantissa of
// 2^23 + 128 + b (byte_perm), one f32 subtract leaves b exactly, and the
// high halves of two such floats are the bf16 pair: no int-to-float or
// float-to-bf16 convert (tests/test_torch_quant.py emulates it for all
// 256 codes).
//
// Rows of every matrix must be a multiple of 16 bytes apart (TMA): K % 16
// for #9 and #10, N % 8 for #10's g.  Other shapes take the mma.sync
// kernel of quant_matmul.cu; the wrapper chooses by shape.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BK = 64;            // contraction per tile (128 bf16 bytes)
constexpr int NCONS = 256;        // two consumer warpgroups
constexpr int NTHREADS = NCONS + 32;  // and one producer warp
constexpr int ROW = 128;          // bytes of a swizzled bf16 row (64 values)

// ---- widening ----

// four int8 codes -> four bf16 values (exact)
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;                // b + 128, 0 .. 255
  const float magic = 8388736.f;                     // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - magic;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - magic;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - magic;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - magic;
  return make_uint2(
      __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632),
      __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632));
}

// 16 codes -> bf16 values 0-7 (lo) and 8-15 (hi)
__device__ __forceinline__ void widen16(uint4 w, uint4& lo, uint4& hi) {
  const uint2 a = widen4(w.x), b = widen4(w.y), c = widen4(w.z),
              d = widen4(w.w);
  lo = make_uint4(a.x, a.y, b.x, b.y);
  hi = make_uint4(c.x, c.y, d.x, d.y);
}

// raw int8 tile [R][64] (64-byte rows) -> bf16 K-major [R][64], 128-byte
// rows swizzled (16-byte chunk c of row r at c ^ (r % 8))
// by NT threads, t one of them
template <int R, int NT>
__device__ __forceinline__ void widen_kmajor(const unsigned char* raw,
                                             unsigned char* wide, int t) {
#pragma unroll
  for (int i = 0; i < R * 4 / NT; ++i) {
    const int v = t + i * NT;
    const int r = v >> 2, cb = v & 3;
    uint4 lo, hi;
    widen16(*reinterpret_cast<const uint4*>(raw + r * 64 + cb * 16), lo, hi);
    unsigned char* row = wide + r * ROW;
    *reinterpret_cast<uint4*>(row + (((2 * cb) ^ (r & 7)) << 4)) = lo;
    *reinterpret_cast<uint4*>(row + (((2 * cb + 1) ^ (r & 7)) << 4)) = hi;
  }
}

// raw int8 tile [64 depth rows][OUT columns] -> bf16 MN-major: OUT / 64
// slabs of 64 columns, each [64 rows][128 bytes] swizzled, SLAB_T apart
constexpr int SLAB_T = 64 * ROW;
constexpr int OUT = 256;          // #10's dx columns a CTA
__device__ __forceinline__ void widen_mnmajor(const unsigned char* raw,
                                              unsigned char* wide, int t) {
#pragma unroll
  for (int i = 0; i < 64 * OUT / 16 / NCONS; ++i) {
    const int v = t + i * NCONS;
    const int r = v / (OUT / 16), cb = v % (OUT / 16);
    uint4 lo, hi;
    widen16(*reinterpret_cast<const uint4*>(raw + r * OUT + cb * 16), lo, hi);
    unsigned char* row = wide + (cb >> 2) * SLAB_T + r * ROW;
    const int c8 = 2 * (cb & 3);
    *reinterpret_cast<uint4*>(row + ((c8 ^ (r & 7)) << 4)) = lo;
    *reinterpret_cast<uint4*>(row + (((c8 + 1) ^ (r & 7)) << 4)) = hi;
  }
}

// #9, M > 16: BN weight rows a CTA (a ring of 4 stages at 256)
template <int BN>
using TileL = Layout<128 * ROW, BN * BK, BN * ROW, BN == 256 ? 4 : 6>;
constexpr int MP = 16;            // x rows of the decode kernel's tile
using DecodeL = Layout<MP * ROW, 128 * BK, 128 * ROW, 6>;   // #9, M <= 16
using TransL = Layout<128 * ROW, 64 * OUT, OUT / 64 * SLAB_T, 4, 256>;  // #10

// the producer's walk: tiles j = 0 .. n-1 of the stage ring; tile j loads
// the activation box at (a0 + j * a_step, a1), the weight box at
// (w0 + j * w_step_c, w1 + j * w_step_r) and, with L::S, the scale box at
// a0 + j * a_step
template <typename L>
__device__ __forceinline__ void produce(const Ring<L::NST>& rg,
                                       const CUtensorMap* ta,
                                       const CUtensorMap* tw,
                                       const CUtensorMap* ts, int n, int a0,
                                       int a1, int w0, int w1, int a_step,
                                       int w_step_c, int w_step_r) {
  for (int j = 0; j < n; ++j) {
    const int s = j % L::NST;
    if (j >= L::NST) mbar_wait(rg.empty(s), ((j / L::NST) - 1) & 1);
    mbar_expect_tx(rg.full(s), L::STAGE + L::S);
    const uint32_t dst = rg.base + s * L::STAGE;
    tma_load_2d(dst, ta, rg.full(s), a0 + j * a_step, a1);
    tma_load_2d(dst + L::A, tw, rg.full(s), w0 + j * w_step_c,
                w1 + j * w_step_r);
    if constexpr (L::S > 0)
      tma_load_1d(rg.base + L::SC + s * L::S, ts, rg.full(s),
                  a0 + j * a_step);
  }
}

// ---- #9, M > 16 ----

// the accumulator of BN columns: PARTS products of up to 128 columns
template <int BN>
struct TileAcc {
  static_assert(BN == 64 || BN == 256, "BN 64 or 256");
  static constexpr int PARTS = BN == 256 ? 2 : 1;
  static constexpr int N = BN == 64 ? 64 : 128;   // columns of a part
};

template <int BN>
__device__ __forceinline__ void issue_tile(
    float (&acc)[TileAcc<BN>::PARTS][TileAcc<BN>::N / 2], uint32_t xa,
    uint32_t wb) {
  using T = TileAcc<BN>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t da = sw128_desc(xa + kk * 32, 16, 1024);
#pragma unroll
    for (int p = 0; p < T::PARTS; ++p) {
      const uint64_t db = sw128_desc(wb + p * 128 * ROW + kk * 32, 16, 1024);
      if constexpr (T::N == 128)
        wgmma_ss_n128(acc[p], da, db, 1);
      else
        wgmma_ss_n64(acc[p], da, db, 1);
    }
  }
  wgmma_commit();
}

template <int BN>
__device__ __forceinline__ void fence_acc(
    float (&acc)[TileAcc<BN>::PARTS][TileAcc<BN>::N / 2]) {
#pragma unroll
  for (int p = 0; p < TileAcc<BN>::PARTS; ++p) fence_regs(acc[p]);
}

template <int BN>
__global__ void __launch_bounds__(NTHREADS, 1)
q8_tile_kernel(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tw,
               const float* __restrict__ scale, void* __restrict__ out,
               int out_f32, int M, int N, int K) {
  using L = TileL<BN>;
  using T = TileAcc<BN>;
  extern __shared__ unsigned char smem_raw[];
  const auto rg = ring_setup<L>(smem_raw);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * 128;
  const int nk = (K + BK - 1) / BK;
  if (threadIdx.x >= NCONS) {
    if (threadIdx.x == NCONS)
      produce<L>(rg, &tx, &tw, nullptr, nk, 0, m0, 0, n0, BK, BK, 0);
    return;
  }
  const int t = threadIdx.x, wg = t / 128;
  auto x_at = [&](int s) { return rg.base + s * L::STAGE + wg * 64 * ROW; };
  auto raw_at = [&](int s) { return rg.smem + s * L::STAGE + L::A; };
  auto wide_at = [&](int b) { return L::WIDE + b * BN * ROW; };
  float acc[T::PARTS][T::N / 2];
#pragma unroll
  for (int p = 0; p < T::PARTS; ++p)
#pragma unroll
    for (int i = 0; i < T::N / 2; ++i) acc[p][i] = 0.f;

  mbar_wait(rg.full(0), 0);
  widen_kmajor<BN, NCONS>(raw_at(0), rg.smem + wide_at(0), t);
  fence_proxy_async();
  bar_sync(1, NCONS);
  for (int kt = 0; kt + 1 < nk; ++kt) {
    const int s = kt % L::NST, sn = (kt + 1) % L::NST;
    fence_acc<BN>(acc);
    wgmma_fence();
    issue_tile<BN>(acc, x_at(s), rg.base + wide_at(kt & 1));
    mbar_wait(rg.full(sn), ((kt + 1) / L::NST) & 1);
    widen_kmajor<BN, NCONS>(raw_at(sn), rg.smem + wide_at((kt + 1) & 1), t);
    fence_proxy_async();
    wgmma_wait<0>();
    fence_acc<BN>(acc);
    mbar_arrive(rg.empty(s));
    bar_sync(1, NCONS);
  }
  fence_acc<BN>(acc);
  wgmma_fence();
  issue_tile<BN>(acc, x_at((nk - 1) % L::NST),
                 rg.base + wide_at((nk - 1) & 1));
  wgmma_wait<0>();
  fence_acc<BN>(acc);

  // part p, element 4j + e: row g (+8 for e >= 2), column 128p + 8j +
  // 2(t%4) + (e & 1)
  const int lane = t % 32;
  const int r0 = m0 + wg * 64 + ((t % 128) / 32) * 16 + lane / 4;
  const bool even = (N & 1) == 0;
#pragma unroll
  for (int p = 0; p < T::PARTS; ++p)
#pragma unroll
    for (int j = 0; j < T::N / 8; ++j) {
      const int col = n0 + 128 * p + 8 * j + 2 * (lane % 4);
      if (col >= N) continue;
      const bool has1 = col + 1 < N;
      const float s0 = scale[col], s1 = has1 ? scale[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r < M)
          store2(out, out_f32, int64_t(r) * N + col,
                 acc[p][4 * j + 2 * h] * s0, acc[p][4 * j + 2 * h + 1] * s1,
                 has1, has1 && even);
      }
    }
}

// ---- #9, M <= 16: the transposed product ----

__device__ __forceinline__ void issue_decode(float (&acc)[MP / 2],
                                             uint32_t wa, uint32_t xb) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_ss_n16(acc, sw128_desc(wa + kk * 32, 16, 1024),
                 sw128_desc(xb + kk * 32, 16, 1024), 1);
  wgmma_commit();
}

// grid (weight tiles of 128 rows, splits); split z walks contraction tiles
// [z * per, min(nk, (z + 1) * per)).  Each warpgroup widens and multiplies
// its own 64 weight rows, so the two sync apart (named barriers 1 and 2).
// With splits > 1 each CTA writes its f32 partial to ws[z][tile][MP][128]
// and takes a ticket; the last of the tile sums the splits in order and
// resets the ticket for the next launch.
__global__ void __launch_bounds__(NTHREADS, 2)
q8_decode_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw,
                 const float* __restrict__ scale, void* __restrict__ out,
                 int out_f32, float* __restrict__ ws,
                 int* __restrict__ tickets, int M, int N, int K, int per,
                 int splits) {
  using L = DecodeL;
  extern __shared__ unsigned char smem_raw[];
  const auto rg = ring_setup<L>(smem_raw);
  const int tile = blockIdx.x, z = blockIdx.y, tiles = gridDim.x;
  const int n0 = tile * 128;
  const int nk = (K + BK - 1) / BK;
  const int t0 = z * per;
  const int nt = min(nk, t0 + per) - t0;
  if (threadIdx.x >= NCONS) {
    if (threadIdx.x == NCONS)
      produce<L>(rg, &tx, &tw, nullptr, nt, t0 * BK, 0, t0 * BK, n0, BK, BK,
                 0);
    return;
  }
  const int t = threadIdx.x, wg = t / 128, tw_ = t % 128;
  auto x_at = [&](int s) { return rg.base + s * L::STAGE; };
  auto raw_at = [&](int s) {
    return rg.smem + s * L::STAGE + L::A + wg * 64 * BK;
  };
  auto wide_at = [&](int b) { return L::WIDE + (2 * b + wg) * 64 * ROW; };
  float acc[MP / 2];
#pragma unroll
  for (int i = 0; i < MP / 2; ++i) acc[i] = 0.f;

  mbar_wait(rg.full(0), 0);
  widen_kmajor<64, 128>(raw_at(0), rg.smem + wide_at(0), tw_);
  fence_proxy_async();
  bar_sync(1 + wg, 128);
  for (int j = 0; j + 1 < nt; ++j) {
    const int s = j % L::NST, sn = (j + 1) % L::NST;
    fence_regs(acc);
    wgmma_fence();
    issue_decode(acc, rg.base + wide_at(j & 1), x_at(s));
    mbar_wait(rg.full(sn), ((j + 1) / L::NST) & 1);
    widen_kmajor<64, 128>(raw_at(sn), rg.smem + wide_at((j + 1) & 1), tw_);
    fence_proxy_async();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(rg.empty(s));
    bar_sync(1 + wg, 128);
  }
  fence_regs(acc);
  wgmma_fence();
  issue_decode(acc, rg.base + wide_at((nt - 1) & 1), x_at((nt - 1) % L::NST));
  wgmma_wait<0>();
  fence_regs(acc);

  // element 4j + e: weight row g (+8 for e >= 2), x row 8j + 2(t%4) + (e&1)
  const int lane = t % 32;
  const int nl0 = wg * 64 + (tw_ / 32) * 16 + lane / 4;
  const int c2 = 2 * (lane % 4);
  if (splits == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + nl0 + 8 * h;
      if (n >= N) continue;
      const float sc = scale[n];
#pragma unroll
      for (int j = 0; j < MP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * j + c2 + e;
          if (m < M)
            store2(out, out_f32, int64_t(m) * N + n,
                   acc[4 * j + 2 * h + e] * sc, 0.f, false, false);
        }
    }
    return;
  }
  float* part = ws + (int64_t(z) * tiles + tile) * MP * 128;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < MP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        part[(8 * j + c2 + e) * 128 + nl0 + 8 * h] = acc[4 * j + 2 * h + e];
  __threadfence();
  bar_sync(3, NCONS);
  volatile int* flag = reinterpret_cast<volatile int*>(rg.smem + L::FLAG);
  if (t == 0) *flag = atomicAdd(tickets + tile, 1) == splits - 1;
  bar_sync(3, NCONS);
  if (!*flag) return;
  __threadfence();
  // this thread's elements e = t + 256 i (x row e / 128, weight row
  // n0 + e % 128), each summed over the splits in order; the loads of a
  // split are all in flight at once
  constexpr int PER = MP * 128 / NCONS;
  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = 0.f;
  const float* src = ws + int64_t(tile) * MP * 128 + t;
  for (int zz = 0; zz < splits; ++zz) {
    const float* sz = src + int64_t(zz) * tiles * MP * 128;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if ((t + i * NCONS) / 128 < M) v[i] += __ldcg(sz + i * NCONS);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = t + i * NCONS, m = e / 128, n = n0 + e % 128;
    if (m < M && n < N)
      store2(out, out_f32, int64_t(m) * N + n, v[i] * scale[n], 0.f, false,
             false);
  }
  if (t == 0) tickets[tile] = 0;
}

// ---- #10: dx = bf16(g * scale) @ q ----

// this thread's A fragments of a 64-deep g tile (swizzled [128][64] bf16 at
// `gt`), each value times its scale (the tile's 64 f32 at `sc`, zero past
// N) in f32 and rounded to bf16: k-step kk, fragment 4kk + 2(jb & 1) + h
// holds row g + 8h, columns 8jb + 2(t%4) (+1) with jb = 2kk + (jb & 1)
__device__ __forceinline__ void load_gs(uint32_t (&a)[16],
                                        const unsigned char* gt,
                                        const float* sc, int row, int lane) {
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    const float2 s = *reinterpret_cast<const float2*>(sc + 8 * jb + 2 * tq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
          gt + (row + 8 * h) * ROW + ((jb ^ g) << 4) + 4 * tq);
      a[4 * (jb / 2) + 2 * (jb & 1) + h] =
          pack_bf16(__uint_as_float(w << 16) * s.x,
                    __uint_as_float(w & 0xFFFF0000u) * s.y);
    }
  }
}

// D (64 x OUT, PARTS accumulators of 128 columns) += A (registers) times
// the MN-major widened tile at `b`, 16 depth rows (2048 bytes) per step
constexpr int PARTS = OUT / 128;
__device__ __forceinline__ void issue_t(float (&acc)[PARTS][64],
                                        const uint32_t (&a)[16], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t af[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                            a[4 * kk + 3]};
#pragma unroll
    for (int p = 0; p < PARTS; ++p)
      wgmma_rs_n128(acc[p], af,
                    sw128_desc(b + p * 2 * SLAB_T + kk * 2048, SLAB_T, 1024));
  }
  wgmma_commit();
}

// The accumulators take 128 registers a thread: a third warpgroup makes
// the block 384 threads, so that the consumers can raise their registers
// to 232 (setmaxnreg) as the producer lowers its own to 40; at 288
// threads ptxas caps them at 168 and spills.
constexpr int THREADS_T = NCONS + 128;

__global__ void __launch_bounds__(THREADS_T, 1)
q8t_tile_kernel(const __grid_constant__ CUtensorMap tg,
                const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap ts,
                bf16* __restrict__ dx, int M, int N, int K) {
  using L = TransL;
  extern __shared__ unsigned char smem_raw[];
  const auto rg = ring_setup<L>(smem_raw);
  const int k0 = blockIdx.x * OUT, m0 = blockIdx.y * 128;
  const int nt = (N + 63) / 64;
  if (threadIdx.x >= NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == NCONS)
      produce<L>(rg, &tg, &tw, &ts, nt, 0, m0, k0, 0, 64, 0, 64);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int t = threadIdx.x, wg = t / 128, lane = t % 32;
  const int row = wg * 64 + ((t % 128) / 32) * 16 + lane / 4;  // and + 8
  auto g_at = [&](int s) { return rg.smem + s * L::STAGE; };
  auto raw_at = [&](int s) { return rg.smem + s * L::STAGE + L::A; };
  auto sc_at = [&](int s) {
    return reinterpret_cast<const float*>(rg.smem + L::SC + s * L::S);
  };
  auto wide_at = [&](int b) { return L::WIDE + b * (OUT / 64) * SLAB_T; };
  float acc[PARTS][64];
#pragma unroll
  for (int p = 0; p < PARTS; ++p)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[p][i] = 0.f;
  uint32_t a[16], an[16];
  auto fence_acc = [&]() {
#pragma unroll
    for (int p = 0; p < PARTS; ++p) fence_regs(acc[p]);
  };

  // tile j on the tensor cores from `cur` while tile j + 1 is widened and
  // its fragments made in `nxt`: two register sets by turns (a copy from
  // one to the other lets ptxas share their registers, and it then
  // serialises the wgmmas: C7513)
  auto step = [&](uint32_t (&cur)[16], uint32_t (&nxt)[16], int j) {
    const int sn = (j + 1) % L::NST;
    fence_acc();
    fence_regs(cur);
    wgmma_fence();
    issue_t(acc, cur, rg.base + wide_at(j & 1));
    mbar_wait(rg.full(sn), ((j + 1) / L::NST) & 1);
    widen_mnmajor(raw_at(sn), rg.smem + wide_at((j + 1) & 1), t);
    load_gs(nxt, g_at(sn), sc_at(sn), row, lane);
    mbar_arrive(rg.empty(sn));
    fence_proxy_async();
    wgmma_wait<0>();
    fence_acc();
    fence_regs(cur);
    bar_sync(1, NCONS);
  };
  auto last = [&](uint32_t (&cur)[16], int j) {
    fence_acc();
    fence_regs(cur);
    wgmma_fence();
    issue_t(acc, cur, rg.base + wide_at(j & 1));
    wgmma_wait<0>();
    fence_acc();
    fence_regs(cur);
  };

  mbar_wait(rg.full(0), 0);
  widen_mnmajor(raw_at(0), rg.smem + wide_at(0), t);
  load_gs(a, g_at(0), sc_at(0), row, lane);
  mbar_arrive(rg.empty(0));
  fence_proxy_async();
  bar_sync(1, NCONS);
  int j = 0;
  for (; j + 2 < nt; j += 2) {
    step(a, an, j);
    step(an, a, j + 1);
  }
  if (j + 1 < nt) {
    step(a, an, j);
    last(an, j + 1);
  } else {
    last(a, j);
  }

  // K % 16 == 0, so a column pair lies wholly inside or outside dx
  const int c2 = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + row + 8 * h;
    if (r >= M) continue;
    bf16* orow = dx + int64_t(r) * K;
#pragma unroll
    for (int p = 0; p < PARTS; ++p)
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int col = k0 + 128 * p + 8 * n + c2;
        if (col < K)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(acc[p][4 * n + 2 * h], acc[p][4 * n + 2 * h + 1]);
      }
  }
}

template <int BN>
int launch_tile(const CUtensorMap& tx, const CUtensorMap& tw, const float* sc,
                void* out, int out_f32, int M, int N, int K,
                cudaStream_t st) {
  static bool configured = false;
  const int err = allow_smem(q8_tile_kernel<BN>, TileL<BN>::ALLOC, configured);
  if (err != 0) return err;
  const dim3 grid((N + BN - 1) / BN, (M + 127) / 128);
  q8_tile_kernel<BN><<<grid, NTHREADS, TileL<BN>::ALLOC, st>>>(
      tx, tw, sc, out, out_f32, M, N, K);
  return int(cudaGetLastError());
}

}  // namespace

// dynamic shared memory of each kernel: 0 q8_tile BN 64, 1 BN 256,
// 2 q8_decode, 3 q8t_tile
extern "C" int opadpo_int8_matmul_smem_bytes(int which) {
  switch (which) {
    case 0: return TileL<64>::ALLOC;
    case 1: return TileL<256>::ALLOC;
    case 2: return DecodeL::ALLOC;
    default: return TransL::ALLOC;
  }
}

// #9 at M > 16: x bf16 [M, K], q int8 [N, K], scale f32 [N], out [M, N]
// (f32 if out_f32 else bf16), contiguous and 16-byte aligned, K % 16 == 0;
// bn 64 or 256 weight rows per CTA.  Returns 0, a cudaError_t, -1 if
// the driver has no cuTensorMapEncodeTiled, or 100000 + its CUresult.
extern "C" int opadpo_q8_tile(const void* x, const void* q, const void* scale,
                              void* out, int out_f32, int M, int N, int K,
                              int bn, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || (bn != 64 && bn != 256))
    return int(cudaErrorInvalidValue);
  CUtensorMap tx, tw;
  int err = make_map_2d(&tx, x, 2, K, M, BK, 128, true);
  if (err == 0) err = make_map_2d(&tw, q, 1, K, N, BK, bn, false);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (bn == 256) return launch_tile<256>(tx, tw, sc, out, out_f32, M, N, K, st);
  return launch_tile<64>(tx, tw, sc, out, out_f32, M, N, K, st);
}

// #9 at M <= 16, the contraction split `splits` ways (per = ceil(nk /
// splits) 64-deep tiles each, none empty).  With splits > 1: ws f32 of
// splits * ceil(N / 128) * 16 * 128 and tickets int32 [ceil(N / 128)],
// zero before the launch and left zero.
extern "C" int opadpo_q8_decode(const void* x, const void* q,
                                const void* scale, void* out, int out_f32,
                                void* ws, void* tickets, int M, int N, int K,
                                int splits, void* stream) {
  const int nk = (K + BK - 1) / BK;
  if (M <= 0 || M > MP || N <= 0 || K <= 0 || K % 16 || splits < 1 ||
      splits > nk || (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return int(cudaErrorInvalidValue);
  const int per = (nk + splits - 1) / splits;
  if ((splits - 1) * per >= nk) return int(cudaErrorInvalidValue);
  CUtensorMap tx, tw;
  int err = make_map_2d(&tx, x, 2, K, M, BK, MP, true);
  if (err == 0) err = make_map_2d(&tw, q, 1, K, N, BK, 128, false);
  if (err != 0) return err;
  static bool configured = false;
  err = allow_smem(q8_decode_kernel, DecodeL::ALLOC, configured);
  if (err != 0) return err;
  const dim3 grid((N + 127) / 128, splits);
  q8_decode_kernel<<<grid, NTHREADS, DecodeL::ALLOC,
                     static_cast<cudaStream_t>(stream)>>>(
      tx, tw, static_cast<const float*>(scale), out, out_f32,
      static_cast<float*>(ws), static_cast<int*>(tickets), M, N, K, per,
      splits);
  return int(cudaGetLastError());
}

// #10: g bf16 [M, N] with N % 8 == 0, q int8 [N, K] with K % 16 == 0,
// scale f32 [N], dx bf16 [M, K]; contiguous, 16-byte aligned.
extern "C" int opadpo_q8t_tile(const void* g, const void* q,
                               const void* scale, void* dx, int M, int N,
                               int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 8)
    return int(cudaErrorInvalidValue);
  CUtensorMap tg, tw, ts;
  int err = make_map_2d(&tg, g, 2, N, M, 64, 128, true);
  if (err == 0) err = make_map_2d(&tw, q, 1, K, N, OUT, 64, false);
  if (err == 0) err = make_map_1d_f32(&ts, scale, N, 64);
  if (err != 0) return err;
  static bool configured = false;
  err = allow_smem(q8t_tile_kernel, TransL::ALLOC, configured);
  if (err != 0) return err;
  const dim3 grid((K + OUT - 1) / OUT, (M + 127) / 128);
  q8t_tile_kernel<<<grid, THREADS_T, TransL::ALLOC,
                    static_cast<cudaStream_t>(stream)>>>(
      tg, tw, ts, static_cast<bf16*>(dx), M, N, K);
  return int(cudaGetLastError());
}
