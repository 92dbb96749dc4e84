// Flash attention backward for Hopper (sm_90a): dQ, dK, dV in bf16 from
// the forward's saved log-sum-exp, f32 accumulation.
//
// Replaces opadpo_tpu/ops/attention.py:_dq_kernel and _dkv_kernel
// (launched by _flash_bwd) with two kernels of the same split:
// - flash_bwd_dq_kernel: one CTA per (batch, head, 64-row query tile)
//   walks the key tiles its rows can see: dQ = sum_j dS_j K_j;
// - flash_bwd_dkv_kernel: one CTA per (batch, head, 64-key tile) walks the
//   query tiles that can see it, from max(0, k0 - offset) / 64 on:
//   dK = sum_i dS_i^T Q_i and dV = sum_i P_i^T dO_i.
// Both rebuild s = q.k * scale + bias, P = exp(s - lse) from the forward's
// lse, dP = dO V^T and dS = P * (dP - delta) * scale, where delta =
// rowsum(dO * O) comes from the caller (the JAX package computes it outside
// its kernels too).  As there, P is cast to dO's type before P^T dO and dS
// to bf16 before its two products.  Every output element is written by one
// CTA, which sums its tiles in a fixed order: no atomics, and the results
// are the same from run to run.
//
// Masking is flash_fwd.cu's: additive key bias, causal rule col <= row +
// offset with hidden keys at the finite -1e30, keys at or past Skv
// excluded.  A fully masked row (no valid key; its lse is -1e30 + log Skv,
// which is -1e30 in f32) gets P = exp(-1e30 - lse) = 1 on every key, as the
// plain version computes it: finite, never NaN.  So that the kernels agree
// with the plain version on such rows too, a tile holding one walks over
// every key tile (dQ) and the dK/dV CTAs also visit the earlier query
// tiles that hold one.  On the training path those rows' dO is zero.
//
// What bounds it: per visible (query, key) pair the two kernels do 14*D
// flops (S and dP in both, dQ, dK, dV) against ~12 bytes per element of
// q, k, v, dO and the three outputs, so at the DPO shapes ([2, 703] causal,
// 896 queries over 1599 keys; 32 heads of 128) they are operations-bound on
// the tensor cores.  This first version uses WMMA (mma.sync, bf16 -> f32)
// with plain 16-byte loads and one tile in flight, as flash_fwd.cu does;
// wgmma, TMA and a tile ring are left for a later pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NWARPS = 4;       // each warp owns 16 rows of its CTA's tile
constexpr int NTHREADS = NWARPS * 32;
constexpr float kMask = -1e30f;

template <int D>
struct Layout {
  static constexpr int LDT = D + 8;    // bf16 row stride of the 4 tiles
  static constexpr int LDP = 64 + 8;   // bf16 row stride of P / dS
  static constexpr int LDS = 64 + 4;   // f32 warp scratch row stride
  static constexpr size_t tile_bytes = size_t(64) * LDT * 2;
  static constexpr size_t p_bytes = size_t(64) * LDP * 2;
  static constexpr size_t s_bytes = size_t(NWARPS) * 16 * LDS * 4;
  // 4 tiles, 2 f32 scratches, 2 bf16 P/dS tiles, 3 vectors of 64 f32
  static constexpr size_t total =
      4 * tile_bytes + 2 * s_bytes + 2 * p_bytes + 3 * 64 * 4;
};

// rows [row0, row0 + 64) of one (b, h) slice into shared memory; rows at or
// past n_rows are zero
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t row_stride, int row0,
                                          int n_rows, int tid) {
  constexpr int VPR = D / 8;
  for (int idx = tid; idx < 64 * VPR; idx += NTHREADS) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::LDT + c) = val;
  }
}

// out[16 x 64] (f32, ld LDS) = A[16 x D] . B[64 x D]^T, A and B row-major
// bf16 in shared memory with row stride LDT
template <int D>
__device__ __forceinline__ void warp_abt(float* out, const bf16* a,
                                         const bf16* b) {
  constexpr int LDT = Layout<D>::LDT;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
    wmma::load_matrix_sync(af, a + kk, LDT);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr;
      wmma::load_matrix_sync(bfr, b + n * 16 * LDT + kk, LDT);
      wmma::mma_sync(acc[n], af, bfr, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(out + n * 16, acc[n], Layout<D>::LDS,
                            wmma::mem_row_major);
}

// acc[16 x D] += A[16 x 64] . B[64 x D]; A row-major bf16 (ld LDP), B
// row-major bf16 (ld LDT)
template <int D>
__device__ __forceinline__ void warp_ab_acc(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, const bf16* a,
    const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
    wmma::load_matrix_sync(af, a + kk, Layout<D>::LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
      wmma::load_matrix_sync(bfr, b + kk * Layout<D>::LDT + n * 16,
                             Layout<D>::LDT);
      wmma::mma_sync(acc[n], af, bfr, acc[n]);
    }
  }
}

// one warp's 16 x D f32 accumulator -> bf16 rows of a [*, H, D] output,
// 64 columns at a time through the warp's scratch; rows at or past n_rows
// are dropped
template <int D>
__device__ __forceinline__ void warp_store(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, float* sw,
    bf16* out, int64_t row_stride, int row0, int n_rows, int lane) {
  const int r_loc = lane >> 1;
  const int half = lane & 1;
#pragma unroll
  for (int chunk = 0; chunk < D / 64; ++chunk) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
      wmma::store_matrix_sync(sw + n * 16, acc[chunk * 4 + n],
                              Layout<D>::LDS, wmma::mem_row_major);
    __syncwarp();
    const int row = row0 + r_loc;
    if (row < n_rows) {
      const float* src = sw + r_loc * Layout<D>::LDS + half * 32;
      bf16* dst = out + row * row_stride + chunk * 64 + half * 32;
#pragma unroll
      for (int c = 0; c < 32; c += 8) {
        __align__(16) bf16 pack[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) pack[e] = __float2bfloat16(src[c + e]);
        *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<uint4*>(pack);
      }
    }
    __syncwarp();
  }
}

struct Strides {
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,
      o_sh;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dO,
                    const float* __restrict__ kbias,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int Sq, int Skv, int H, Strides st, int causal,
                    int offset, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::tile_bytes);
  bf16* Ks = reinterpret_cast<bf16*>(smem + 2 * L::tile_bytes);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 3 * L::tile_bytes);
  float* Ss = reinterpret_cast<float*>(smem + 4 * L::tile_bytes);
  float* dPs = Ss + NWARPS * 16 * L::LDS;
  bf16* dSs = reinterpret_cast<bf16*>(dPs + NWARPS * 16 * L::LDS);
  float* Bs = reinterpret_cast<float*>(dSs + 2 * 64 * L::LDP);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  load_tile<D>(Qs, q + b * st.q_sb + h * st.q_sh, st.q_ss, q0, Sq, tid);
  load_tile<D>(dOs, dO + b * st.o_sb + h * st.o_sh, st.o_ss, q0, Sq, tid);
  const bf16* kb = k + b * st.k_sb + h * st.k_sh;
  const bf16* vb = v + b * st.v_sb + h * st.v_sh;

  // each lane owns half of one query row: 32 of the 64 key columns
  const int r_loc = lane >> 1;
  const int half = lane & 1;
  const int row = q0 + warp * 16 + r_loc;
  const int64_t stat = (int64_t(b) * H + h) * Sq + row;
  const float lse_r = row < Sq ? lse[stat] : 0.f;
  const float delta_r = row < Sq ? delta[stat] : 0.f;
  float* Sw = Ss + warp * 16 * L::LDS;
  float* dPw = dPs + warp * 16 * L::LDS;
  bf16* dSw = dSs + warp * 16 * L::LDP;

  const int nkv = (Skv + BK - 1) / BK;
  int bound = causal ? min(nkv, (q0 + BQ + offset + BK - 1) / BK) : nkv;
  // a fully masked row has P = 1 on every key: walk over all of them
  if (__syncthreads_or(row < Sq && lse_r <= 0.5f * kMask)) bound = nkv;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  for (int j = 0; j < bound; ++j) {
    const int k0 = j * BK;
    __syncthreads();                   // previous tile fully consumed
    load_tile<D>(Ks, kb, st.k_ss, k0, Skv, tid);
    load_tile<D>(Vs, vb, st.v_ss, k0, Skv, tid);
    if (tid < BK) {
      const int c = k0 + tid;
      Bs[tid] = c < Skv ? (kbias ? kbias[int64_t(b) * Skv + c] : 0.f)
                        : -INFINITY;
    }
    __syncthreads();

    warp_abt<D>(Sw, Qs + warp * 16 * L::LDT, Ks);     // Q K^T
    warp_abt<D>(dPw, dOs + warp * 16 * L::LDT, Vs);   // dO V^T
    __syncwarp();

    const float* srow = Sw + r_loc * L::LDS + half * 32;
    const float* dprow = dPw + r_loc * L::LDS + half * 32;
    bf16* dsrow = dSw + r_loc * L::LDP + half * 32;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int cl = half * 32 + c;
      const int col = k0 + cl;
      float ds = 0.f;
      if (row < Sq && col < Skv) {
        const float s = (causal && col > row + offset)
                            ? kMask : srow[c] * scale + Bs[cl];
        const float p = expf(s - lse_r);
        ds = p * (dprow[c] - delta_r) * scale;
      }
      dsrow[c] = __float2bfloat16(ds);
    }
    __syncwarp();
    warp_ab_acc<D>(acc, dSw, Ks);                      // dQ += dS K
  }
  warp_store<D>(acc, Sw, dq + (int64_t(b) * Sq * H + h) * D, int64_t(H) * D,
                q0 + warp * 16, Sq, lane);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dO,
                     const float* __restrict__ kbias,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Sq, int Skv, int H,
                     Strides st, int causal, int offset, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::tile_bytes);
  bf16* Qs = reinterpret_cast<bf16*>(smem + 2 * L::tile_bytes);
  bf16* dOs = reinterpret_cast<bf16*>(smem + 3 * L::tile_bytes);
  float* Ss = reinterpret_cast<float*>(smem + 4 * L::tile_bytes);
  float* dPs = Ss + NWARPS * 16 * L::LDS;
  bf16* Ps = reinterpret_cast<bf16*>(dPs + NWARPS * 16 * L::LDS);
  bf16* dSs = Ps + 64 * L::LDP;
  float* Bs = reinterpret_cast<float*>(dSs + 64 * L::LDP);
  float* lse_s = Bs + 64;
  float* delta_s = lse_s + 64;

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  load_tile<D>(Ks, k + b * st.k_sb + h * st.k_sh, st.k_ss, k0, Skv, tid);
  load_tile<D>(Vs, v + b * st.v_sb + h * st.v_sh, st.v_ss, k0, Skv, tid);
  if (tid < BK) {
    const int c = k0 + tid;
    Bs[tid] = c < Skv ? (kbias ? kbias[int64_t(b) * Skv + c] : 0.f)
                      : -INFINITY;
  }
  const bf16* qb = q + b * st.q_sb + h * st.q_sh;
  const bf16* ob = dO + b * st.o_sb + h * st.o_sh;
  const float* lse_b = lse + (int64_t(b) * H + h) * Sq;
  const float* delta_b = delta + (int64_t(b) * H + h) * Sq;

  // each lane owns half of one key row: 32 of the 64 query columns
  const int r_loc = lane >> 1;
  const int half = lane & 1;
  const int kl = warp * 16 + r_loc;    // key row within the tile
  const int key = k0 + kl;
  float* Sw = Ss + warp * 16 * L::LDS;
  float* dPw = dPs + warp * 16 * L::LDS;
  bf16* Pw = Ps + warp * 16 * L::LDP;
  bf16* dSw = dSs + warp * 16 * L::LDP;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[D / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  const int nq = (Sq + BQ - 1) / BQ;
  const int start = causal ? max(0, k0 - offset) / BQ : 0;
  for (int i = 0; i < nq; ++i) {
    const int q0 = i * BQ;
    __syncthreads();                   // previous tile fully consumed
    if (i < start) {
      // a query tile before the causal start sees this key tile only
      // through a fully masked row
      const int r = q0 + (tid & 63);
      if (!__syncthreads_or(tid < 64 && r < Sq &&
                            lse_b[r] <= 0.5f * kMask)) continue;
    }
    load_tile<D>(Qs, qb, st.q_ss, q0, Sq, tid);
    load_tile<D>(dOs, ob, st.o_ss, q0, Sq, tid);
    if (tid < BQ) {
      const int r = q0 + tid;
      lse_s[tid] = r < Sq ? lse_b[r] : 0.f;
      delta_s[tid] = r < Sq ? delta_b[r] : 0.f;
    }
    __syncthreads();

    warp_abt<D>(Sw, Ks + warp * 16 * L::LDT, Qs);     // (Q K^T)^T
    warp_abt<D>(dPw, Vs + warp * 16 * L::LDT, dOs);   // (dO V^T)^T
    __syncwarp();

    const float* srow = Sw + r_loc * L::LDS + half * 32;
    const float* dprow = dPw + r_loc * L::LDS + half * 32;
    bf16* prow = Pw + r_loc * L::LDP + half * 32;
    bf16* dsrow = dSw + r_loc * L::LDP + half * 32;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int rl = half * 32 + c;
      const int row = q0 + rl;
      float p = 0.f, ds = 0.f;
      if (row < Sq && key < Skv) {
        const float s = (causal && key > row + offset)
                            ? kMask : srow[c] * scale + Bs[kl];
        p = expf(s - lse_s[rl]);
        ds = p * (dprow[c] - delta_s[rl]) * scale;
      }
      prow[c] = __float2bfloat16(p);
      dsrow[c] = __float2bfloat16(ds);
    }
    __syncwarp();
    warp_ab_acc<D>(dv_acc, Pw, dOs);                   // dV += P^T dO
    warp_ab_acc<D>(dk_acc, dSw, Qs);                   // dK += dS^T Q
  }
  bf16* dk_b = dk + (int64_t(b) * Skv * H + h) * D;
  bf16* dv_b = dv + (int64_t(b) * Skv * H + h) * D;
  warp_store<D>(dk_acc, Sw, dk_b, int64_t(H) * D, k0 + warp * 16, Skv, lane);
  warp_store<D>(dv_acc, Sw, dv_b, int64_t(H) * D, k0 + warp * 16, Skv, lane);
}

template <typename Kernel>
int configure(Kernel kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  return int(e);
}

Strides unpack(const int64_t* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4],  s[5],
                 s[6], s[7], s[8], s[9], s[10], s[11]};
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dO,
              const float* kbias, const float* lse, const float* delta,
              void* dq, int B, int Sq, int Skv, int H, const int64_t* st,
              int causal, int offset, float scale, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = Layout<D>::total;
  if (!configured) {
    const int e = configure(flash_bwd_dq_kernel<D>, smem);
    if (e != 0) return e;
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO), kbias, lse,
      delta, static_cast<bf16*>(dq), Sq, Skv, H, unpack(st), causal, offset,
      scale);
  return int(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO,
               const float* kbias, const float* lse, const float* delta,
               void* dk, void* dv, int B, int Sq, int Skv, int H,
               const int64_t* st, int causal, int offset, float scale,
               cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = Layout<D>::total;
  if (!configured) {
    const int e = configure(flash_bwd_dkv_kernel<D>, smem);
    if (e != 0) return e;
    configured = true;
  }
  dim3 grid((Skv + BK - 1) / BK, H, B);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO), kbias, lse,
      delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Skv, H,
      unpack(st), causal, offset, scale);
  return int(cudaGetLastError());
}

}  // namespace

// q, dO: bf16 [B, Sq, H, D]; k, v: bf16 [B, Skv, H, D]; element strides
// (b, s, h) in `strides` (12 values: q, k, v, dO), unit stride on D; kbias:
// f32 [B, Skv] additive key bias or NULL; lse, delta: f32 [B, H, Sq]
// contiguous; dq: bf16 [B, Sq, H, D] contiguous; causal rule col <= row +
// offset.  D is 64 or 128.  Returns the cudaError_t of the launch.
extern "C" int opadpo_flash_bwd_dq_bf16(const void* q, const void* k,
                                        const void* v, const void* dO,
                                        const void* kbias, const void* lse,
                                        const void* delta, void* dq, int B,
                                        int Sq, int Skv, int H, int D,
                                        const int64_t* strides, int causal,
                                        int offset, float scale,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kb = static_cast<const float*>(kbias);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (D == 128)
    return launch_dq<128>(q, k, v, dO, kb, ls, dl, dq, B, Sq, Skv, H,
                          strides, causal, offset, scale, s);
  if (D == 64)
    return launch_dq<64>(q, k, v, dO, kb, ls, dl, dq, B, Sq, Skv, H, strides,
                         causal, offset, scale, s);
  return int(cudaErrorInvalidValue);
}

// as opadpo_flash_bwd_dq_bf16, writing dk, dv: bf16 [B, Skv, H, D]
// contiguous
extern "C" int opadpo_flash_bwd_dkv_bf16(const void* q, const void* k,
                                         const void* v, const void* dO,
                                         const void* kbias, const void* lse,
                                         const void* delta, void* dk,
                                         void* dv, int B, int Sq, int Skv,
                                         int H, int D,
                                         const int64_t* strides, int causal,
                                         int offset, float scale,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kb = static_cast<const float*>(kbias);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dO, kb, ls, dl, dk, dv, B, Sq, Skv, H,
                           strides, causal, offset, scale, s);
  if (D == 64)
    return launch_dkv<64>(q, k, v, dO, kb, ls, dl, dk, dv, B, Sq, Skv, H,
                          strides, causal, offset, scale, s);
  return int(cudaErrorInvalidValue);
}
