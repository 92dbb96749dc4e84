// Matrix product over frozen int4 weights for Hopper (sm_90a): a TMA ring
// of packed weight tiles, each widened once per CTA, wgmma.
//
// Replaces the Pallas kernel #11 of opadpo_tpu/ops/quant.py,
// _q4_matmul_kernel:
//   y[M, N] = sum over 128-deep groups G of (x[:, G] @ w4[N, G]^T, summed
//             in f32) * scale[N, G], bf16 or f32 out:
// each group's partial sum is taken in f32 and scaled before it joins the
// accumulator (the scale is not folded into bf16 weights).  The weight is
// packed [N, K/2] int8: within each group byte r holds k = r in its low
// nibble and k = r + 64 in its high nibble, both signed; scale is f32
// [N, K/128].  So one group's 64-byte row segment widens into two 64-deep
// bf16 K-major tiles, the low nibbles k 0-63 and the high ones k 64-127.
//
// The skeleton is int8_matmul.cu's: one producer thread issues every TMA
// copy into a ring of stages behind full / empty mbarriers (hopper.cuh's
// Ring), two consumer warpgroups widen and multiply.  A stage is one group:
// x as two 64-column slabs and the raw packed weight tile [rows][64 bytes].
// - q4_tile (M > 16): a CTA owns 128 x rows (64 a warpgroup) and BN (128,
//   or 64 where that leaves SMs idle) weight rows.  The consumers widen
//   each group's tile once into two 128-byte swizzled bf16 slabs, the
//   layout TMA gives a bf16 tile, and wgmma m64nBNk16 reads both operands
//   from shared memory.  Per group it takes the partial with scale-d 0 on
//   the group's first k16 (no zeroing), then one FMA pass adds partial *
//   scale[col] into the accumulator.  Partial and accumulator take BN f32
//   registers a thread, so the block has a producer warpgroup and
//   setmaxnreg (232 / 40), as #10.  As it widens a group's tile, consumer
//   t < BN reads the scale of weight row n0 + t for that group into a
//   shared slice of BN f32 (the groups of a row are contiguous, so eight
//   share a 32-byte sector), and the FMA pass reads the slice.  The next
//   group is widened while the tensor cores run on the current one; two
//   widened buffers alternate.
// - q4_decode (M <= 16): the transposed product of int8_matmul.cu's
//   q8_decode: the weight rows are wgmma's M side (64 a warpgroup), the x
//   rows its N side (m64n16k16).  Each thread widens its own A fragments
//   straight from the raw tile into registers (register-A wgmma), so no
//   widened tile goes through shared memory and the two warpgroups need no
//   barrier between them; the raw tile is 64-byte swizzled by TMA so a
//   warp's reads fall in distinct banks.  A group is two independent chains
//   of four k16 steps (its low and its high nibbles).  The group scale is
//   per accumulator row: each thread reads its two rows' scales for the
//   next group ahead.  Two CTAs share an SM (a 6-stage ring each, at most
//   96 registers a thread), so one warpgroup widens while another's wgmmas
//   run: a second fragment set, to widen the next group during the
//   wgmmas, does not fit in 96 registers, and one CTA an SM with two sets
//   ran slower (PERF.md).  The groups are split across CTAs only as far
//   as needed to fill the card (ops/quant.py:decode_splits); the last CTA
//   of a weight tile to arrive (an atomic ticket) sums the f32 partials in
//   split order and casts: one launch, sums in a fixed order.
// In both loops each wgmma group retires before the loop's back edge
// (ptxas serialises wgmmas in flight across a back edge, C7514); the tile
// kernel peels its last group.
//
// Widening, without a convert instruction: each nibble is placed in the
// low bits of a 16-bit half by one byte_perm, and one AND-XOR flips its
// sign bit, so nibble n becomes u = n + 8 in 0 .. 15, and sets the bf16
// exponent of 128.0 (0x4300 | u is 128 + u exactly); one bf16x2 FMA
// subtracts 136: exact for all 16 codes (tests/test_torch_quant.py
// emulates it for all 256 bytes, with the constants read from this file).
//
// What bounds it (H100 SXM data sheet): at decode the weight stream, N * K
// / 2 bytes and the N * K / 128 scales; at M ~ 700 the bf16 tensor-core
// rate (4 * 703 operations per weight byte), but as for #9 the tiles' L2
// traffic comes first: a stage reads 32 KB of x for BN weight rows.
// Rows of x (K bf16) and of the packed weight (K / 2 bytes) are multiples
// of 16 bytes for every K % 128 == 0, and no TMA box reads the scales, so
// every shape the wrapper accepts takes these kernels.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int GK = 128;           // contraction per stage: one group
constexpr int RAW = GK / 2;       // packed bytes of a weight row a group
constexpr int ROW = 128;          // bytes of a swizzled bf16 row (64 values)
constexpr int NCONS = 256;        // two consumer warpgroups
constexpr int MP = 16;            // x rows of the decode kernel's tile

// ---- widening ----

// bf16x2 a - 136 (a * 1 + (-136), one rounding: exact for 128 + u)
__device__ __forceinline__ uint32_t minus136(uint32_t a) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// two of the four packed bytes of w (`sel` 0x4140: bytes 0, 1; 0x4342:
// bytes 2, 3) -> the bf16 pair of their low nibbles (lo) and of their high
// nibbles (hi).  Each nibble lands in the low bits of a 16-bit half, and
// one AND-XOR flips its sign bit (n + 8) and sets the exponent of 128.0
__device__ __forceinline__ void widen_nib2(uint32_t w, uint32_t sel,
                                           uint32_t& lo, uint32_t& hi) {
  const uint32_t v = w >> 4;            // high nibbles in the low ones
  lo = minus136((__byte_perm(w, 0, sel) & 0x000F000Fu) ^ 0x43084308u);
  hi = minus136((__byte_perm(v, 0, sel) & 0x000F000Fu) ^ 0x43084308u);
}

// four packed bytes -> lo[0], lo[1] (bytes 0-1, 2-3) and hi[0], hi[1]
__device__ __forceinline__ void widen_nib4(uint32_t w, uint32_t* lo,
                                           uint32_t* hi) {
  widen_nib2(w, 0x4140, lo[0], hi[0]);
  widen_nib2(w, 0x4342, lo[1], hi[1]);
}

// raw packed tile [R][64 bytes] of one group -> two bf16 K-major slabs
// [R][128 bytes], `slab` bytes apart (k 0-63, then k 64-127), 16-byte
// chunk c of row r at c ^ (r % 8); by NT threads, t one of them
template <int R, int NT>
__device__ __forceinline__ void widen_group(const unsigned char* raw,
                                            unsigned char* wide, int slab,
                                            int t) {
#pragma unroll
  for (int i = 0; i < R * 4 / NT; ++i) {
    const int v = t + i * NT;
    const int r = v >> 2, cb = v & 3;
    const uint4 w = *reinterpret_cast<const uint4*>(raw + r * RAW + cb * 16);
    uint32_t lo[8], hi[8];
    widen_nib4(w.x, lo, hi);
    widen_nib4(w.y, lo + 2, hi + 2);
    widen_nib4(w.z, lo + 4, hi + 4);
    widen_nib4(w.w, lo + 6, hi + 6);
    unsigned char* row = wide + r * ROW;
    const int c0 = ((2 * cb) ^ (r & 7)) << 4;
    const int c1 = ((2 * cb + 1) ^ (r & 7)) << 4;
    *reinterpret_cast<uint4*>(row + c0) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(row + c1) =
        make_uint4(lo[4], lo[5], lo[6], lo[7]);
    *reinterpret_cast<uint4*>(row + slab + c0) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(row + slab + c1) =
        make_uint4(hi[4], hi[5], hi[6], hi[7]);
  }
}

// this thread's A fragments of one group (register-A wgmma m64k16), from
// its warpgroup's raw tile [64][64 bytes] at `raw`, 64-byte swizzled by TMA
// (16-byte chunk c of row r at c ^ ((r >> 1) & 3), so that the eight rows
// a warp reads at once fall in distinct banks): k-step t of the group in
// a[4t .. 4t + 3], rows r0 and r0 + 8, columns 2q (+1) and 8 + 2q (+1);
// steps 0-3 are the low nibbles of bytes 16t + .., steps 4-7 the high
// nibbles of the same bytes
__device__ __forceinline__ void load_frags(uint32_t (&a)[32],
                                           const unsigned char* raw, int r0,
                                           int q) {
  const uint32_t sel = (q & 1) ? 0x4342u : 0x4140u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const unsigned char* row = raw + r * RAW + 4 * (q >> 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            row + ((kk ^ ((r >> 1) & 3)) << 4) + 8 * p);
        widen_nib2(w, sel, a[4 * kk + 2 * p + h], a[4 * (kk + 4) + 2 * p + h]);
      }
  }
}

// M > 16: 128 x rows, BN weight rows (4 stages at 128, 5 at 64)
// (hopper.cuh's Layout: a stage is x's two slabs, then the raw tile; the
// tile kernel's two scale slices of BN f32 follow the widened tiles)
template <int BN>
using TileL = Layout<2 * 128 * ROW, BN * RAW, 2 * BN * ROW, BN == 128 ? 4 : 5,
                     BN * 4, 2>;
// M <= 16: 16 x rows, 128 weight rows, 6 stages, two CTAs an SM
using DecodeL = Layout<2 * MP * ROW, 128 * RAW, 0, 6>;
static_assert(TileL<64>::A % 2048 == 0 && TileL<128>::A % 2048 == 0 &&
                  DecodeL::A % 2048 == 0,
              "x's two slabs keep the 1024-byte swizzle period");

// the producer's walk: groups g0 .. g0 + n - 1 into the stage ring; group
// g loads x's two slabs at (g * 128 (+ 64), m0) and the packed weight box
// at (g * 64 bytes, n0)
template <typename L>
__device__ __forceinline__ void produce(const Ring<L::NST>& rg,
                                       const CUtensorMap* tx,
                                       const CUtensorMap* tw, int n, int g0,
                                       int m0, int n0) {
  for (int j = 0; j < n; ++j) {
    const int s = j % L::NST, g = g0 + j;
    if (j >= L::NST) mbar_wait(rg.empty(s), ((j / L::NST) - 1) & 1);
    mbar_expect_tx(rg.full(s), L::STAGE);
    const uint32_t dst = rg.base + s * L::STAGE;
    tma_load_2d(dst, tx, rg.full(s), g * GK, m0);
    tma_load_2d(dst + L::A / 2, tx, rg.full(s), g * GK + 64, m0);
    tma_load_2d(dst + L::A, tw, rg.full(s), g * RAW, n0);
  }
}

// ---- M > 16 ----

constexpr int TILE_THREADS = NCONS + 128;   // and a producer warpgroup

// part (64 x BN) = this warpgroup's x rows (two slabs `xs` apart at `xa`)
// times the widened group (two slabs `ws` apart at `wb`), transposed; the
// first k16 overwrites part (scale-d 0)
template <int BN>
__device__ __forceinline__ void issue_tile(float (&part)[BN / 2], uint32_t xa,
                                           uint32_t wb) {
  constexpr int XS = 128 * ROW, WS = BN * ROW;
#pragma unroll
  for (int kk = 0; kk < GK / 16; ++kk) {
    const uint64_t da =
        sw128_desc(xa + (kk / 4) * XS + (kk % 4) * 32, 16, 1024);
    const uint64_t db =
        sw128_desc(wb + (kk / 4) * WS + (kk % 4) * 32, 16, 1024);
    if constexpr (BN == 128)
      wgmma_ss_n128(part, da, db, kk > 0);
    else
      wgmma_ss_n64(part, da, db, kk > 0);
  }
  wgmma_commit();
}

// acc += part * the group's scale of each column (8j + 2(lane % 4) (+1))
template <int BN>
__device__ __forceinline__ void add_scaled(float (&acc)[BN / 2],
                                           const float (&part)[BN / 2],
                                           const float* sc, int lane) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 s = *reinterpret_cast<const float2*>(sc + 8 * j +
                                                      2 * (lane % 4));
    acc[4 * j] = fmaf(part[4 * j], s.x, acc[4 * j]);
    acc[4 * j + 1] = fmaf(part[4 * j + 1], s.y, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(part[4 * j + 2], s.x, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(part[4 * j + 3], s.y, acc[4 * j + 3]);
  }
}

template <int BN>
__global__ void __launch_bounds__(TILE_THREADS, 1)
q4_tile_kernel(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tw,
               const float* __restrict__ scale, void* __restrict__ out,
               int out_f32, int M, int N, int K) {
  using L = TileL<BN>;
  extern __shared__ unsigned char smem_raw[];
  const auto rg = ring_setup<L>(smem_raw);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * 128;
  const int groups = K / GK;
  if (threadIdx.x >= NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == NCONS) {
      prefetch_map(&tx);
      prefetch_map(&tw);
      produce<L>(rg, &tx, &tw, groups, 0, m0, n0);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int t = threadIdx.x, wg = t / 128, lane = t % 32;
  auto x_at = [&](int s) { return rg.base + s * L::STAGE + wg * 64 * ROW; };
  auto raw_at = [&](int s) { return rg.smem + s * L::STAGE + L::A; };
  auto wide_at = [&](int b) { return L::WIDE + b * 2 * BN * ROW; };
  float* sc = reinterpret_cast<float*>(rg.smem + L::SC);   // [2][BN]
  // this thread's weight row of the scale slices (t < BN): zero past N
  const bool has_sc = t < BN && n0 + t < N;
  const float* srow = scale + int64_t(has_sc ? n0 + t : 0) * groups;
  auto scale_of = [&](int g) { return has_sc ? __ldg(srow + g) : 0.f; };
  // widen group g's tile (stage s) into buffer g & 1 with its scale slice
  auto stage_in = [&](int g, int s) {
    const float v = scale_of(g);
    mbar_wait(rg.full(s), (g / L::NST) & 1);
    widen_group<BN, NCONS>(raw_at(s), rg.smem + wide_at(g & 1), BN * ROW, t);
    if (t < BN) sc[(g & 1) * BN + t] = v;
    fence_proxy_async();
  };
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  stage_in(0, 0);
  bar_sync(1, NCONS);
  for (int g = 0; g + 1 < groups; ++g) {
    const int s = g % L::NST;
    fence_regs(part);
    wgmma_fence();
    issue_tile<BN>(part, x_at(s), rg.base + wide_at(g & 1));
    stage_in(g + 1, (g + 1) % L::NST);
    wgmma_wait<0>();
    fence_regs(part);
    add_scaled<BN>(acc, part, sc + (g & 1) * BN, lane);
    mbar_arrive(rg.empty(s));
    bar_sync(1, NCONS);
  }
  const int gl = groups - 1;
  fence_regs(part);
  wgmma_fence();
  issue_tile<BN>(part, x_at(gl % L::NST), rg.base + wide_at(gl & 1));
  wgmma_wait<0>();
  fence_regs(part);
  add_scaled<BN>(acc, part, sc + (gl & 1) * BN, lane);

  // element 4j + e: row g (+8 for e >= 2), column 8j + 2(t%4) + (e & 1)
  const int r0 = m0 + wg * 64 + ((t % 128) / 32) * 16 + lane / 4;
  const bool even = (N & 1) == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= N) continue;
    const bool has1 = col + 1 < N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < M)
        store2(out, out_f32, int64_t(r) * N + col, acc[4 * j + 2 * h],
               acc[4 * j + 2 * h + 1], has1, has1 && even);
    }
  }
}

// ---- M <= 16: the transposed product ----

constexpr int DECODE_THREADS = NCONS + 32;  // and a producer warp

// pa (steps 0-3, the low nibbles) and pb (steps 4-7, the high ones) = the
// weight rows (A fragments `a`) times the x tile (two slabs at `xb`): two
// independent chains of four, interleaved; each first k16 overwrites
__device__ __forceinline__ void issue_decode(float (&pa)[MP / 2],
                                             float (&pb)[MP / 2],
                                             const uint32_t (&a)[32],
                                             uint32_t xb) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t lo[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                            a[4 * kk + 3]};
    const uint32_t hi[4] = {a[4 * kk + 16], a[4 * kk + 17], a[4 * kk + 18],
                            a[4 * kk + 19]};
    wgmma_rs_n16(pa, lo, sw128_desc(xb + kk * 32, 16, 1024), kk > 0);
    wgmma_rs_n16(pb, hi, sw128_desc(xb + MP * ROW + kk * 32, 16, 1024),
                 kk > 0);
  }
  wgmma_commit();
}

// grid (weight tiles of 128 rows, splits); split z walks groups [z * per,
// min(groups, (z + 1) * per)).  Each warpgroup reads its own 64 weight rows
// of the raw tile into registers, so the two need no barrier between them;
// a thread arrives on a stage's empty barrier once the wgmmas that read
// its fragments and the stage's x tile have retired.  With
// splits > 1 each CTA writes its f32 partial to ws[z][tile][MP][128] and
// takes a ticket; the last of the tile sums the splits in order and resets
// the ticket for the next launch.
__global__ void __launch_bounds__(DECODE_THREADS, 2)
q4_decode_kernel(const __grid_constant__ CUtensorMap tx,
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
  const int groups = K / GK;
  const int g0 = z * per;
  const int nt = min(groups, g0 + per) - g0;
  if (threadIdx.x >= NCONS) {
    if (threadIdx.x == NCONS) {
      prefetch_map(&tx);
      prefetch_map(&tw);
      produce<L>(rg, &tx, &tw, nt, g0, 0, n0);
    }
    return;
  }
  const int t = threadIdx.x, wg = t / 128, lane = t % 32, q = lane % 4;
  auto x_at = [&](int s) { return rg.base + s * L::STAGE; };
  auto raw_at = [&](int s) {
    return rg.smem + s * L::STAGE + L::A + wg * 64 * RAW;
  };
  // element 4j + e: weight row nl0 (+8 for e >= 2), x row 8j + 2q + (e & 1)
  const int r0 = ((t % 128) / 32) * 16 + lane / 4;   // in the warpgroup's 64
  const int nl0 = wg * 64 + r0;
  const bool has0 = n0 + nl0 < N, has8 = n0 + nl0 + 8 < N;
  const float* s0 = scale + int64_t(has0 ? n0 + nl0 : 0) * groups + g0;
  const float* s8 = scale + int64_t(has8 ? n0 + nl0 + 8 : 0) * groups + g0;
  float acc[MP / 2], pa[MP / 2], pb[MP / 2], sc[2], sn[2];
#pragma unroll
  for (int i = 0; i < MP / 2; ++i) acc[i] = 0.f;
  uint32_t a[32];
  auto scales_of = [&](int j, float (&v)[2]) {
    v[0] = has0 ? __ldg(s0 + j) : 0.f;
    v[1] = has8 ? __ldg(s8 + j) : 0.f;
  };
  scales_of(0, sc);
  for (int j = 0; j < nt; ++j) {
    const int s = j % L::NST;
    scales_of(min(j + 1, nt - 1), sn);
    mbar_wait(rg.full(s), (j / L::NST) & 1);
    load_frags(a, raw_at(s), r0, q);
    fence_regs(pa);
    fence_regs(pb);
    fence_regs(a);
    wgmma_fence();
    issue_decode(pa, pb, a, x_at(s));
    wgmma_wait<0>();
    fence_regs(pa);
    fence_regs(pb);
    fence_regs(a);
    mbar_arrive(rg.empty(s));
    // acc += (pa + pb) * the group's scale of each weight row (element
    // 4j + 2h + e: row h of the thread's two)
#pragma unroll
    for (int i = 0; i < MP / 2; ++i)
      acc[i] = fmaf(pa[i] + pb[i], sc[(i / 2) & 1], acc[i]);
    sc[0] = sn[0];
    sc[1] = sn[1];
  }

  const int c2 = 2 * q;
  if (splits == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + nl0 + 8 * h;
      if (n >= N) continue;
#pragma unroll
      for (int jj = 0; jj < MP / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * jj + c2 + e;
          if (m < M)
            store2(out, out_f32, int64_t(m) * N + n, acc[4 * jj + 2 * h + e],
                   0.f, false, false);
        }
    }
    return;
  }
  float* part_ws = ws + (int64_t(z) * tiles + tile) * MP * 128;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int jj = 0; jj < MP / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * jj + c2 + e < M)
          part_ws[(8 * jj + c2 + e) * 128 + nl0 + 8 * h] =
              acc[4 * jj + 2 * h + e];
  __threadfence();
  bar_sync(3, NCONS);
  volatile int* flag = reinterpret_cast<volatile int*>(rg.smem + L::FLAG);
  if (t == 0) *flag = atomicAdd(tickets + tile, 1) == splits - 1;
  bar_sync(3, NCONS);
  if (!*flag) return;
  __threadfence();
  // this thread's elements e = t + 256 i (x row e / 128, weight row
  // n0 + e % 128), each summed over the splits in order
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
      store2(out, out_f32, int64_t(m) * N + n, v[i], 0.f, false, false);
  }
  if (t == 0) tickets[tile] = 0;
}

template <int BN>
int launch_tile(const CUtensorMap& tx, const CUtensorMap& tw, const float* sc,
                void* out, int out_f32, int M, int N, int K,
                cudaStream_t st) {
  static bool configured = false;
  const int err = allow_smem(q4_tile_kernel<BN>, TileL<BN>::ALLOC, configured);
  if (err != 0) return err;
  const dim3 grid((N + BN - 1) / BN, (M + 127) / 128);
  q4_tile_kernel<BN><<<grid, TILE_THREADS, TileL<BN>::ALLOC, st>>>(
      tx, tw, sc, out, out_f32, M, N, K);
  return int(cudaGetLastError());
}

}  // namespace

// dynamic shared memory of each kernel: 0 q4_tile BN 64, 1 BN 128,
// 2 q4_decode
extern "C" int opadpo_int4_matmul_smem_bytes(int which) {
  switch (which) {
    case 0: return TileL<64>::ALLOC;
    case 1: return TileL<128>::ALLOC;
    default: return DecodeL::ALLOC;
  }
}

// M > 16: x bf16 [M, K], q4 packed int8 [N, K/2], scale f32 [N, K/128],
// out [M, N] (f32 if out_f32 else bf16), contiguous and 16-byte aligned,
// K % 128 == 0; bn 64 or 128 weight rows per CTA.  Returns 0, a
// cudaError_t, -1 if the driver has no cuTensorMapEncodeTiled, or 100000 +
// its CUresult.
extern "C" int opadpo_q4_tile(const void* x, const void* q4, const void* scale,
                              void* out, int out_f32, int M, int N, int K,
                              int bn, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % GK || (bn != 64 && bn != 128))
    return int(cudaErrorInvalidValue);
  CUtensorMap tx, tw;
  int err = make_map_2d(&tx, x, 2, K, M, 64, 128, true);
  if (err == 0) err = make_map_2d(&tw, q4, 1, K / 2, N, RAW, bn, false);
  if (err != 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (bn == 128)
    return launch_tile<128>(tx, tw, sc, out, out_f32, M, N, K, st);
  return launch_tile<64>(tx, tw, sc, out, out_f32, M, N, K, st);
}

// M <= 16, the groups split `splits` ways (per = ceil(groups / splits)
// each, none empty).  With splits > 1: ws f32 of splits * ceil(N / 128) *
// 16 * 128 and tickets int32 [ceil(N / 128)], zero before the launch and
// left zero.
extern "C" int opadpo_q4_decode(const void* x, const void* q4,
                                const void* scale, void* out, int out_f32,
                                void* ws, void* tickets, int M, int N, int K,
                                int splits, void* stream) {
  const int groups = K / GK;
  if (M <= 0 || M > MP || N <= 0 || K <= 0 || K % GK || splits < 1 ||
      splits > groups || (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return int(cudaErrorInvalidValue);
  const int per = (groups + splits - 1) / splits;
  if ((splits - 1) * per >= groups) return int(cudaErrorInvalidValue);
  CUtensorMap tx, tw;
  int err = make_map_2d(&tx, x, 2, K, M, 64, MP, true);
  if (err == 0)
    err = make_map_2d_sw(&tw, q4, 1, K / 2, N, RAW, 128,
                         CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != 0) return err;
  static bool configured = false;
  err = allow_smem(q4_decode_kernel, DecodeL::ALLOC, configured);
  if (err != 0) return err;
  const dim3 grid((N + 127) / 128, splits);
  q4_decode_kernel<<<grid, DECODE_THREADS, DecodeL::ALLOC,
                     static_cast<cudaStream_t>(stream)>>>(
      tx, tw, static_cast<const float*>(scale), out, out_f32,
      static_cast<float*>(ws), static_cast<int*>(tickets), M, N, K, per,
      splits);
  return int(cudaGetLastError());
}
