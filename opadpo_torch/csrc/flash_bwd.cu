// Flash attention backward for Hopper (sm_90a): dQ, dK, dV in bf16 from
// the forward's saved log-sum-exp, f32 accumulation.
//
// Replaces opadpo_tpu/ops/attention.py:_dq_kernel and _dkv_kernel
// (launched by _flash_bwd) with two kernels of the same split:
// - flash_bwd_dq_kernel: one CTA per (batch, head, 128-row query tile)
//   walks 64-key tiles: dQ = sum_j dS_j K_j;
// - flash_bwd_dkv_kernel: one CTA per (batch, head, 128-key tile) walks
//   64-row query tiles: dK = sum_i dS_i^T Q_i and dV = sum_i P_i^T dO_i.
// Both rebuild s = q.k * scale + bias, P = exp(s - lse) from the forward's
// lse, dP = dO V^T and dS = P * (dP - delta) * scale, where delta =
// rowsum(dO * O) comes from the caller (the JAX package computes it outside
// its kernels too).  As there, P is cast to bf16 before P^T dO and dS
// before its two products.  Every output element is written by one CTA,
// which sums its tiles in a fixed order: no atomics, and the results are
// the same from run to run.  So dQ keeps its own kernel and recomputes S
// and dP: 14*D flops per visible (query, key) pair in all.
//
// Masking is flash_fwd.cu's: additive key bias, causal rule col <= row +
// offset with hidden keys at the finite -1e30, keys at or past Skv
// excluded (their bias is -inf).  The scores are taken in log2 units, x =
// s * scale * log2 e + bias, and a row's lse enters as lse2 = lse * log2 e,
// except for a row that sees no valid key (lse -1e30, as the forward and
// the plain version write it): there lse2 is -1e30 itself, so that every
// key's x (-1e30 exactly: bias or causal mask; -inf past Skv) gives
// P = exp2(x - lse2) = 1 on every key and 0 past Skv, as the plain
// version's exp(-1e30 - lse) does.  Mixing the units instead would give
// exp2(+4.4e29) = inf.  Query rows past Sq take lse2 = +inf (P = 0) and
// delta 0, so they add nothing to dK or dV.
//
// The walks are fixed before the loops: the wrapper computes them from the
// blind rows of each batch row (the leading query rows that see no valid
// key, ops/attention.py:blind_rows) and the kernels read them:
// - dQ: a query tile walks every key tile iff its first row is blind,
//   else up to its diagonal (attention.kv_tile_count, the forward's rule
//   with 128 x 64 tiles);
// - dK/dV: a key tile visits the query tiles from max(0, k0 - offset) / 64
//   to the end, after the leading ones that hold blind rows
//   (attention.q_tile_walk: walk[b, t] = (lead, start)).
//
// What bounds it: per visible pair 6*D flops in dQ and 8*D in dK/dV
// against ~12 bytes per element of q, k, v, dO and the outputs, so at the
// DPO shapes ([2, 703] causal, 896 queries over 1599 keys; 32 heads of 128)
// they are operations-bound, or nearly.  So the products run on wgmma and
// the loads stay off the compute warps, as in flash_fwd.cu:
// - warp specialisation: warpgroups 0 and 1 consume, 64 rows each
//   (queries in dQ, keys in dK/dV), with registers raised by setmaxnreg;
//   warpgroup 2 produces, registers lowered; one thread issues every TMA
//   copy and its warp writes the per-tile vectors (the key bias in dQ,
//   lse2 and delta in dK/dV) to shared memory;
// - TMA through 4-D tensor maps over the strided [B, S, H, D] views,
//   128-byte swizzle: the CTA's own tiles once (Q and dO, or K and V),
//   then a ring of NST stages of the walked tiles (K and V, or Q and dO, 64
//   rows each), with full and empty mbarriers;
// - dQ: S = Q K^T and dP = dO V^T on wgmma m64n64 from shared memory (all
//   K-major); dS in registers, packed to bf16 A fragments; dQ += dS K on
//   the register-A form with K as the MN-major B operand, from the same
//   swizzled tile;
// - dK/dV: S^T = K Q^T and dP^T = V dO^T the same way, so the row
//   statistics run along the columns; P^T and dS^T packed to A fragments;
//   dV += P^T dO and dK += dS^T Q with dO and Q MN-major;
// - within a warpgroup, tile j+1's S and dP are issued together with tile
//   j's last product (dQ += dS K after them; dK += dS^T Q before them, as
//   dK/dV has registers for one set of A fragments only), and tile j+1's
//   P runs while the rest finishes; each step retires its groups before
//   the loop's back edge, and the first and last tiles are peeled, so no
//   wgmma issue in the loop is conditional and none is in flight across
//   the back edge;
// - the causal test runs only on the tiles that cross the diagonal (and
//   dK/dV's leading blind tiles, which lie wholly past it); nothing passes
//   through shared memory between the products, and nothing is voted.
// Not done yet: ping-pong of the consumer warpgroups, clusters, a
// persistent grid.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BIG = 128;           // the CTA's own rows: 64 per consumer
constexpr int BW = 64;             // rows of a walked tile
constexpr int NST = 4;             // stages of the ring
constexpr int NTHREADS = 384;      // consumer warpgroups 0, 1; producer 2
constexpr int SLAB_BIG = BIG * 128;  // 128 rows x 128 bytes
constexpr int SLAB_W = BW * 128;     // 64 rows x 128 bytes
// registers a thread after setmaxnreg: 2 x 128 x CONSUMER_REGS + 128 x
// PRODUCER_REGS = 64,512 of the SM's 65,536, what 384 threads hold at
// launch (168 each).  dK/dV needs 240: at 232 / 40 it spilled
constexpr int DKV_CONSUMER_REGS = 240;
constexpr int DKV_PRODUCER_REGS = 24;
constexpr int DQ_CONSUMER_REGS = 232;
constexpr int DQ_PRODUCER_REGS = 40;

// shared memory, byte offsets from a 1024-aligned base (the swizzle's
// period): the CTA's two tiles (128 rows), NST stages of two walked tiles
// (64 rows), NST x VEC floats of per-stage vectors, and the mbarriers
template <int D, int VEC>
struct Smem {
  static constexpr int NSLAB = D / 64;
  static constexpr int BIG_TILE = NSLAB * SLAB_BIG;
  static constexpr int W_TILE = NSLAB * SLAB_W;
  static constexpr int OWN0 = 0;                 // Q (dQ) or K (dK/dV)
  static constexpr int OWN1 = BIG_TILE;          // dO or V
  static constexpr int W0 = 2 * BIG_TILE;        // K or Q stages
  static constexpr int W1 = W0 + NST * W_TILE;   // V or dO stages
  static constexpr int VECS = W1 + NST * W_TILE;
  static constexpr int BAR = VECS + NST * VEC * 4;
  // mbarriers: own-full, then full and empty for each stage
  static constexpr int BYTES = BAR + 8 * (1 + 2 * NST);
  static constexpr int ALLOC = BYTES + 1024;
};
template <int D>
using DqSmem = Smem<D, BW>;          // the key bias of each stage
template <int D>
using DkvSmem = Smem<D, 2 * BW>;     // lse2 and delta of each stage

// acc[64 x 64] = A B^T over D: A's 64 rows at `a` and B's at `b`, both
// K-major, their 64-column slabs `a_slab` and `b_slab` bytes apart
template <int D>
__device__ __forceinline__ void issue_ss64(float (&acc)[32], uint32_t a,
                                           uint32_t a_slab, uint32_t b,
                                           uint32_t b_slab) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(acc,
                 sw128_desc(a + (kk / 4) * a_slab + (kk % 4) * 32, 16, 1024),
                 sw128_desc(b + (kk / 4) * b_slab + (kk % 4) * 32, 16, 1024),
                 kk > 0);
  wgmma_commit();
}

// a row's lse in the units of the scores (see the header)
__device__ __forceinline__ float lse_log2(float lse) {
  return lse <= 0.5f * kMask ? kMask : lse * kLog2e;
}

// wait for a stage, then issue x = A0 B0^T and y = A1 B1^T over D (two
// commit groups): the CTA's own rows of this warpgroup (128-row slabs)
// against the stage's walked tiles (64-row slabs)
template <int D>
__device__ __forceinline__ void issue_scores(float (&x)[32], float (&y)[32],
                                             uint32_t a0, uint32_t a1,
                                             uint32_t b0, uint32_t b1,
                                             uint32_t full_bar,
                                             uint32_t parity) {
  mbar_wait(full_bar, parity);
  fence_regs(x);
  fence_regs(y);
  wgmma_fence();
  issue_ss64<D>(x, a0, SLAB_BIG, b0, SLAB_W);
  issue_ss64<D>(y, a1, SLAB_BIG, b1, SLAB_W);
}

// acc += A (registers, 64 columns) B, B the stage's 64-row tile at `b`,
// MN-major (one commit group)
template <int D>
__device__ __forceinline__ void issue_acc(float (&acc)[D / 2],
                                          uint32_t (&a)[16], uint32_t b) {
  fence_regs(acc);
  fence_regs(a);
  wgmma_fence();
  issue_rs<D, BW / 16>(acc, a, b, SLAB_W);
}

// dQ, one key tile j, from the wait for its S to its dS in pa, with every
// wgmma group retired at the end.  Pending at the start: S_j, dP_j, and
// with EXTRA = 1 dQ_{j-1} after them; stage j-1 is released (`release`)
// once dQ_{j-1} is done.  P from the bias slice of the stage (-inf past
// Skv), the causal rule where `diag` (the key of column 8n + e1 is hidden
// from row 8 e2 iff lj - 8n < e1 - 8 e2, lj = r0 + offset - c2 - 64 j),
// the rows' lse2; then dS = P (dP - delta) scale.
template <int D, int EXTRA>
__device__ __forceinline__ void dq_tile(float (&sc)[32], float (&dp)[32],
                                        float (&dqa)[D / 2],
                                        uint32_t (&pa)[16],
                                        const float* bias_s, int c2,
                                        bool diag, int lj,
                                        const float (&lse2)[2],
                                        const float (&dlt)[2], float scale,
                                        float scale_log2, bool release,
                                        uint32_t empty_prev) {
  wgmma_wait<1 + EXTRA>();
  fence_regs(sc);
#pragma unroll
  for (int n = 0; n < BW / 8; ++n) {
    const float2 bb = *reinterpret_cast<const float2*>(bias_s + n * 8 + c2);
    float x0 = fmaf(sc[4 * n], scale_log2, bb.x);
    float x1 = fmaf(sc[4 * n + 1], scale_log2, bb.y);
    float x2 = fmaf(sc[4 * n + 2], scale_log2, bb.x);
    float x3 = fmaf(sc[4 * n + 3], scale_log2, bb.y);
    if (diag) {
      const int l0 = lj - 8 * n;
      if (l0 < 0) x0 = fminf(kMask, bb.x);
      if (l0 < 1) x1 = fminf(kMask, bb.y);
      if (l0 < -8) x2 = fminf(kMask, bb.x);
      if (l0 < -7) x3 = fminf(kMask, bb.y);
    }
    sc[4 * n] = ex2(x0 - lse2[0]);
    sc[4 * n + 1] = ex2(x1 - lse2[0]);
    sc[4 * n + 2] = ex2(x2 - lse2[1]);
    sc[4 * n + 3] = ex2(x3 - lse2[1]);
  }
  wgmma_wait<EXTRA>();
  fence_regs(dp);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    sc[i] = sc[i] * (dp[i] - dlt[(i >> 1) & 1]) * scale;
  wgmma_wait<0>();
  fence_regs(dqa);
  fence_regs(pa);
  if (release) mbar_arrive(empty_prev);
  pack_acc(sc, pa);
}

// dK/dV, one query tile j, from the wait for its S^T to its dS^T in pf,
// with every wgmma group retired at the end.  Pending at the start:
// dK_{j-1} (none for j = 0), S^T_j, dP^T_j; the first wait retires all
// but dP^T_j, so stage j-1 is released (`release`) at once.  One set of A
// fragments (pf) carries P^T to dV and then dS^T to dK, to spare 16
// registers: at D 128 the consumers hold 208 in arrays of their 240, and
// ptxas still serialises some wgmmas for register resources (C7512; see
// PERF.md).  P^T from the two keys' bias (kb) and the stage's lse2 per
// column (vec[0, 64)), the causal rule where `diag` (key 8 e2 is hidden
// from the query of column 8n + e1 iff 8n + e1 < lj + 8 e2, lj = key0 -
// offset - c2 - q0); dS^T = P^T (dP^T - delta) scale with delta at
// vec[64, 128).
template <int D>
__device__ __forceinline__ void dkv_tile(float (&st)[32], float (&dpt)[32],
                                         float (&dka)[D / 2],
                                         float (&dva)[D / 2],
                                         uint32_t (&pf)[16],
                                         const float* vec, uint32_t dos,
                                         const float (&kb)[2], int c2,
                                         bool diag, int lj, float scale,
                                         float scale_log2, bool release,
                                         uint32_t empty_prev) {
  wgmma_wait<1>();
  fence_regs(st);
  fence_regs(dka);
  fence_regs(pf);
  if (release) mbar_arrive(empty_prev);
#pragma unroll
  for (int n = 0; n < BW / 8; ++n) {
    const float2 l2 = *reinterpret_cast<const float2*>(vec + n * 8 + c2);
    float x0 = fmaf(st[4 * n], scale_log2, kb[0]);
    float x1 = fmaf(st[4 * n + 1], scale_log2, kb[0]);
    float x2 = fmaf(st[4 * n + 2], scale_log2, kb[1]);
    float x3 = fmaf(st[4 * n + 3], scale_log2, kb[1]);
    if (diag) {
      if (8 * n < lj) x0 = fminf(kMask, kb[0]);
      if (8 * n + 1 < lj) x1 = fminf(kMask, kb[0]);
      if (8 * n < lj + 8) x2 = fminf(kMask, kb[1]);
      if (8 * n + 1 < lj + 8) x3 = fminf(kMask, kb[1]);
    }
    st[4 * n] = ex2(x0 - l2.x);
    st[4 * n + 1] = ex2(x1 - l2.y);
    st[4 * n + 2] = ex2(x2 - l2.x);
    st[4 * n + 3] = ex2(x3 - l2.y);
  }
  pack_acc(st, pf);
  issue_acc<D>(dva, pf, dos);        // dV += P^T dO
  wgmma_wait<1>();
  fence_regs(dpt);
#pragma unroll
  for (int n = 0; n < BW / 8; ++n) {
    const float2 dl = *reinterpret_cast<const float2*>(vec + BW + n * 8 + c2);
    st[4 * n] = st[4 * n] * (dpt[4 * n] - dl.x) * scale;
    st[4 * n + 1] = st[4 * n + 1] * (dpt[4 * n + 1] - dl.y) * scale;
    st[4 * n + 2] = st[4 * n + 2] * (dpt[4 * n + 2] - dl.x) * scale;
    st[4 * n + 3] = st[4 * n + 3] * (dpt[4 * n + 3] - dl.y) * scale;
  }
  wgmma_wait<0>();
  fence_regs(dva);
  fence_regs(pf);
  pack_acc(st, pf);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ kbias,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ tile_counts, int counts_ld,
                    bf16* __restrict__ dq, int Sq, int Skv, int H, int causal,
                    int offset, float scale, float scale_log2) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar_own = sbase + L::BAR;
  auto full = [&](int s) { return bar_own + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_own + 8 * (1 + NST + s); };

  const int qt = gridDim.x - 1 - blockIdx.x;          // longest walks first
  const int q0 = qt * BIG;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ntiles = tile_counts[b * counts_ld + qt];
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: thread 256 issues every copy, its warp the bias ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        DQ_PRODUCER_REGS) : "memory");
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x - 256;
      if (lane == 0) {
        mbar_expect_tx(bar_own, 2 * L::BIG_TILE);
        for (int sl = 0; sl < L::NSLAB; ++sl) {
          tma_load_4d(sbase + L::OWN0 + sl * SLAB_BIG, &tq, bar_own, sl * 64,
                      q0, h, b);
          tma_load_4d(sbase + L::OWN1 + sl * SLAB_BIG, &tdo, bar_own,
                      sl * 64, q0, h, b);
        }
      }
      const float* brow = kbias ? kbias + int64_t(b) * Skv : nullptr;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % NST;
        if (j >= NST) mbar_wait(empty(s), ((j / NST) - 1) & 1);
        if (lane == 0) {
          mbar_add_tx(full(s), 2 * L::W_TILE);
          for (int sl = 0; sl < L::NSLAB; ++sl) {
            tma_load_4d(sbase + L::W0 + s * L::W_TILE + sl * SLAB_W, &tk,
                        full(s), sl * 64, j * BW, h, b);
            tma_load_4d(sbase + L::W1 + s * L::W_TILE + sl * SLAB_W, &tv,
                        full(s), sl * 64, j * BW, h, b);
          }
        }
        float* bias_s = reinterpret_cast<float*>(smem + L::VECS + s * BW * 4);
#pragma unroll
        for (int e = 0; e < BW / 32; ++e) {
          const int col = j * BW + e * 32 + lane;
          bias_s[e * 32 + lane] =
              col < Skv ? (brow ? __ldg(brow + col) : 0.f) : -INFINITY;
        }
        mbar_arrive(full(s));          // each lane, after its writes
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        DQ_CONSUMER_REGS) : "memory");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int q0w = q0 + wg * 64;
    const int r0 = q0w + (t / 32) * 16 + lane / 4;   // and r0 + 8
    const int c2 = (lane % 4) * 2;
    const int64_t stat = (int64_t(b) * H + h) * Sq;
    float lse2[2], dlt[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + 8 * e;
      lse2[e] = r < Sq ? lse_log2(__ldg(lse + stat + r)) : INFINITY;
      dlt[e] = r < Sq ? __ldg(delta + stat + r) : 0.f;
    }
    float sc[32], dp[32], dqa[D / 2];
    uint32_t pa[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) pa[i] = 0u;
    const uint32_t qa = sbase + L::OWN0 + wg * 64 * 128;
    const uint32_t doa = sbase + L::OWN1 + wg * 64 * 128;
    // tiles below `inner` lie wholly at or left of the first row's diagonal
    const int inner = causal ? (q0w + offset + 1) / BW : ntiles;
    const int lim = r0 + offset - c2;

    auto stage = [&](int j) { return j % NST; };
    auto w0 = [&](int j) { return sbase + L::W0 + stage(j) * L::W_TILE; };
    auto w1 = [&](int j) { return sbase + L::W1 + stage(j) * L::W_TILE; };
    auto bias_of = [&](int j) {
      return reinterpret_cast<const float*>(smem + L::VECS +
                                            stage(j) * BW * 4);
    };

    // ntiles >= 1: every query tile walks at least its diagonal tile.  As
    // in flash_fwd.cu, step j issues S_{j+1} and dP_{j+1}, then dQ_j, and
    // retires all three before the loop's back edge: with wgmmas in flight
    // across it, ptxas serialised them (C7514)
    mbar_wait(bar_own, 0);
    issue_scores<D>(sc, dp, qa, doa, w0(0), w1(0), full(0), 0);
    dq_tile<D, 0>(sc, dp, dqa, pa, bias_of(0), c2, 0 >= inner, lim, lse2,
                  dlt, scale, scale_log2, false, 0);
    for (int j = 0; j + 1 < ntiles; ++j) {
      issue_scores<D>(sc, dp, qa, doa, w0(j + 1), w1(j + 1),
                      full(stage(j + 1)), ((j + 1) / NST) & 1);
      issue_acc<D>(dqa, pa, w0(j));    // dQ += dS K
      dq_tile<D, 1>(sc, dp, dqa, pa, bias_of(j + 1), c2, j + 1 >= inner,
                    lim - (j + 1) * BW, lse2, dlt, scale, scale_log2, true,
                    empty(stage(j)));
    }
    issue_acc<D>(dqa, pa, w0(ntiles - 1));   // the last tile's, peeled
    wgmma_wait<0>();
    fence_regs(dqa);
    store_rows<D>(dqa, dq + (int64_t(b) * Sq * H + h) * D, int64_t(H) * D, r0,
                  Sq, c2);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ kbias,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ walk, int walk_ld,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
                     int Skv, int H, int causal, int offset, float scale,
                     float scale_log2) {
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t bar_own = sbase + L::BAR;
  auto full = [&](int s) { return bar_own + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_own + 8 * (1 + NST + s); };

  const int kt = blockIdx.x;                          // longest walks first
  const int k0 = kt * BIG;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nq = (Sq + BW - 1) / BW;
  // the walk: query tiles [0, lead), then [start, nq)
  const int lead = walk[b * walk_ld + 2 * kt];
  const int start = walk[b * walk_ld + 2 * kt + 1];
  const int ntiles = lead + nq - start;
  auto tile_of = [&](int j) { return j < lead ? j : start + (j - lead); };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: thread 256 issues every copy, its warp lse2, delta --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        DKV_PRODUCER_REGS) : "memory");
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x - 256;
      if (lane == 0) {
        mbar_expect_tx(bar_own, 2 * L::BIG_TILE);
        for (int sl = 0; sl < L::NSLAB; ++sl) {
          tma_load_4d(sbase + L::OWN0 + sl * SLAB_BIG, &tk, bar_own, sl * 64,
                      k0, h, b);
          tma_load_4d(sbase + L::OWN1 + sl * SLAB_BIG, &tv, bar_own, sl * 64,
                      k0, h, b);
        }
      }
      const int64_t stat = (int64_t(b) * H + h) * Sq;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % NST;
        const int qr = tile_of(j) * BW;
        if (j >= NST) mbar_wait(empty(s), ((j / NST) - 1) & 1);
        if (lane == 0) {
          mbar_add_tx(full(s), 2 * L::W_TILE);
          for (int sl = 0; sl < L::NSLAB; ++sl) {
            tma_load_4d(sbase + L::W0 + s * L::W_TILE + sl * SLAB_W, &tq,
                        full(s), sl * 64, qr, h, b);
            tma_load_4d(sbase + L::W1 + s * L::W_TILE + sl * SLAB_W, &tdo,
                        full(s), sl * 64, qr, h, b);
          }
        }
        float* vec = reinterpret_cast<float*>(smem + L::VECS + s * 2 * BW * 4);
#pragma unroll
        for (int e = 0; e < BW / 32; ++e) {
          const int r = qr + e * 32 + lane;
          vec[e * 32 + lane] =
              r < Sq ? lse_log2(__ldg(lse + stat + r)) : INFINITY;
          vec[BW + e * 32 + lane] = r < Sq ? __ldg(delta + stat + r) : 0.f;
        }
        mbar_arrive(full(s));          // each lane, after its writes
      }
    }
  } else {
    // ---- consumers: 64 keys per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        DKV_CONSUMER_REGS) : "memory");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int kw = k0 + wg * 64;
    const int key0 = kw + (t / 32) * 16 + lane / 4;   // and key0 + 8
    const int c2 = (lane % 4) * 2;
    float kb[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = key0 + 8 * e;
      kb[e] = key < Skv ? (kbias ? __ldg(kbias + int64_t(b) * Skv + key) : 0.f)
                        : -INFINITY;
    }
    float st[32], dpt[32], dka[D / 2], dva[D / 2];
    uint32_t pf[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) pf[i] = 0u;
    const uint32_t ka = sbase + L::OWN0 + wg * 64 * 128;
    const uint32_t va = sbase + L::OWN1 + wg * 64 * 128;
    const int lim = key0 - offset - c2;

    auto stage = [&](int j) { return j % NST; };
    auto w0 = [&](int j) { return sbase + L::W0 + stage(j) * L::W_TILE; };
    auto w1 = [&](int j) { return sbase + L::W1 + stage(j) * L::W_TILE; };
    auto vec_of = [&](int j) {
      return reinterpret_cast<const float*>(smem + L::VECS +
                                            stage(j) * 2 * BW * 4);
    };
    // some (query, key) pair of query tile j is causally hidden
    auto diag = [&](int j) {
      return causal && tile_of(j) * BW + offset < kw + 63;
    };

    // ntiles >= 1: start < nq, as every key tile has a query row past it.
    // Step j issues dK_j, then S^T_{j+1} and dP^T_{j+1}, and retires every
    // group before the loop's back edge (see the dQ kernel)
    mbar_wait(bar_own, 0);
    issue_scores<D>(st, dpt, ka, va, w0(0), w1(0), full(0), 0);
    dkv_tile<D>(st, dpt, dka, dva, pf, vec_of(0), w1(0), kb, c2, diag(0),
                lim - tile_of(0) * BW, scale, scale_log2, false, 0);
    for (int j = 0; j + 1 < ntiles; ++j) {
      issue_acc<D>(dka, pf, w0(j));    // dK += dS^T Q
      issue_scores<D>(st, dpt, ka, va, w0(j + 1), w1(j + 1),
                      full(stage(j + 1)), ((j + 1) / NST) & 1);
      dkv_tile<D>(st, dpt, dka, dva, pf, vec_of(j + 1), w1(j + 1), kb, c2,
                  diag(j + 1), lim - tile_of(j + 1) * BW, scale, scale_log2,
                  true, empty(stage(j)));
    }
    issue_acc<D>(dka, pf, w0(ntiles - 1));   // the last tile's, peeled
    wgmma_wait<0>();
    fence_regs(dka);
    fence_regs(dva);
    const int64_t row_stride = int64_t(H) * D;
    const int64_t base = (int64_t(b) * Skv * H + h) * D;
    store_rows<D>(dka, dk + base, row_stride, key0, Skv, c2);
    store_rows<D>(dva, dv + base, row_stride, key0, Skv, c2);
  }
}

template <int D>
int launch_dq(const CUtensorMap* maps, const float* kbias, const float* lse,
              const float* delta, const int* counts, int counts_ld, void* dq,
              int B, int Sq, int Skv, int H, int causal, int offset,
              float scale, cudaStream_t stream) {
  static bool configured = false;
  const int err = allow_smem(flash_bwd_dq_kernel<D>, DqSmem<D>::ALLOC,
                             configured);
  if (err != 0) return err;
  dim3 grid((Sq + BIG - 1) / BIG, H, B);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, DqSmem<D>::ALLOC, stream>>>(
      maps[0], maps[1], maps[2], maps[3], kbias, lse, delta, counts,
      counts_ld, static_cast<bf16*>(dq), Sq, Skv, H, causal, offset, scale,
      scale * kLog2e);
  return int(cudaGetLastError());
}

template <int D>
int launch_dkv(const CUtensorMap* maps, const float* kbias, const float* lse,
               const float* delta, const int* walk, int walk_ld, void* dk,
               void* dv, int B, int Sq, int Skv, int H, int causal,
               int offset, float scale, cudaStream_t stream) {
  static bool configured = false;
  const int err = allow_smem(flash_bwd_dkv_kernel<D>, DkvSmem<D>::ALLOC,
                             configured);
  if (err != 0) return err;
  dim3 grid((Skv + BIG - 1) / BIG, H, B);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, DkvSmem<D>::ALLOC, stream>>>(
      maps[0], maps[1], maps[2], maps[3], kbias, lse, delta, walk, walk_ld,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Skv, H, causal,
      offset, scale, scale * kLog2e);
  return int(cudaGetLastError());
}

// tensor maps of q, k, v, dO for one kernel: the CTA's own tiles are
// BIG rows, the walked ones BW
int make_maps(CUtensorMap* maps, const void* q, const void* k, const void* v,
              const void* dO, int B, int Sq, int Skv, int H, int D,
              const int64_t* st, bool own_queries) {
  const int qrows = own_queries ? BIG : BW;
  const int krows = own_queries ? BW : BIG;
  int err = make_map(&maps[0], q, Sq, H, B, D, st, qrows);
  if (err == 0) err = make_map(&maps[1], k, Skv, H, B, D, st + 3, krows);
  if (err == 0) err = make_map(&maps[2], v, Skv, H, B, D, st + 6, krows);
  if (err == 0) err = make_map(&maps[3], dO, Sq, H, B, D, st + 9, qrows);
  return err;
}

}  // namespace

// dynamic shared memory of the dQ (which 0) or dK/dV (which 1) kernel for
// head width D: its own tiles, the ring, the per-stage vectors, the
// barriers and 1024 bytes of alignment slack
extern "C" int opadpo_flash_bwd_smem_bytes(int which, int D) {
  if (which == 0) return D == 128 ? DqSmem<128>::ALLOC : DqSmem<64>::ALLOC;
  return D == 128 ? DkvSmem<128>::ALLOC : DkvSmem<64>::ALLOC;
}

// q, dO: bf16 [B, Sq, H, D]; k, v: bf16 [B, Skv, H, D]; element strides
// (b, s, h) in `strides` (12 values: q, k, v, dO), unit stride on D,
// 16-byte aligned rows; kbias: f32 [B, Skv] additive key bias or NULL;
// lse, delta: f32 [B, H, Sq] contiguous; tile_counts: int32, the 64-key
// tiles query tile t (128 rows) of batch row b walks, at
// tile_counts[b * counts_ld + t] (counts_ld 0: one row for all b); dq:
// bf16 [B, Sq, H, D] contiguous; causal rule col <= row + offset.  D is 64
// or 128.  Returns 0, the cudaError_t of the launch, -1 if the driver has
// no cuTensorMapEncodeTiled, or 100000 + its CUresult.
extern "C" int opadpo_flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dO,
    const void* kbias, const void* lse, const void* delta,
    const void* tile_counts, int counts_ld, void* dq, int B, int Sq, int Skv,
    int H, int D, const int64_t* strides, int causal, int offset, float scale,
    void* stream) {
  if (D != 64 && D != 128) return int(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const int err = make_maps(maps, q, k, v, dO, B, Sq, Skv, H, D, strides,
                            true);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kb = static_cast<const float*>(kbias);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* tc = static_cast<const int*>(tile_counts);
  if (D == 128)
    return launch_dq<128>(maps, kb, ls, dl, tc, counts_ld, dq, B, Sq, Skv, H,
                          causal, offset, scale, s);
  return launch_dq<64>(maps, kb, ls, dl, tc, counts_ld, dq, B, Sq, Skv, H,
                       causal, offset, scale, s);
}

// as opadpo_flash_bwd_dq_bf16, with walk: int32 pairs (lead, start) per
// (batch row, 128-key tile) at walk[b * walk_ld + 2 t] (walk_ld 0: one row
// for all b), the 64-row query tiles [0, lead) then [start, ceil(Sq / 64));
// writes dk, dv: bf16 [B, Skv, H, D] contiguous
extern "C" int opadpo_flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dO,
    const void* kbias, const void* lse, const void* delta, const void* walk,
    int walk_ld, void* dk, void* dv, int B, int Sq, int Skv, int H, int D,
    const int64_t* strides, int causal, int offset, float scale,
    void* stream) {
  if (D != 64 && D != 128) return int(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const int err = make_maps(maps, q, k, v, dO, B, Sq, Skv, H, D, strides,
                            false);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kb = static_cast<const float*>(kbias);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* wk = static_cast<const int*>(walk);
  if (D == 128)
    return launch_dkv<128>(maps, kb, ls, dl, wk, walk_ld, dk, dv, B, Sq, Skv,
                           H, causal, offset, scale, s);
  return launch_dkv<64>(maps, kb, ls, dl, wk, walk_ld, dk, dv, B, Sq, Skv, H,
                        causal, offset, scale, s);
}
