// Matrix products over frozen int8 weights for Hopper (sm_90a): bf16
// activations, weights widened to bf16 in shared memory, tensor-core
// mma.sync (m16n8k16, bf16 -> f32), f32 accumulation.
//
// Replaces two Pallas kernels of opadpo_tpu/ops/quant.py, only at shapes
// whose rows are not a multiple of 16 bytes long, which int8_matmul.cu's
// TMA loads cannot take (ops/quant.py chooses; #11, the int4 kernel, runs
// on int4_matmul.cu at every shape):
// - Q8  (_q8_matmul_kernel):   y[M, N] = (x[M, K] @ q[N, K]^T) * scale[N]
// - Q8T (_q8_matmul_t_kernel): dx[M, K] = gs[M, N] @ q[N, K], where the
//   caller has folded the weight scale into gs = bf16(g * scale)
// Weights are stored [N, K] with K contiguous.
//
// Generic form used below: out[M, N] = A[M, K] @ B[K, N], A bf16 row-major,
// K the contraction.  For Q8, B is the weight read as [N][K]; for Q8T the
// weight is [K][N] (its rows are the contraction), so the tile is staged
// [k][n] and the B fragments are gathered from it.
//
// What bounds it: at decode (M <= 16) the weight stream, M * N * K
// multiply-adds against N * K weight bytes; at M ~ 700 the products (about
// 2 * 703 operations per weight byte, bf16 tensor-core bound).  The design:
// one CTA owns a 64-column output tile and BM (16 or 64) rows and walks the
// contraction in 128-deep tiles; the next tile is prefetched into registers
// (16-byte loads, coalesced along the weight rows) while the tensor cores
// work on the current one from shared memory.  Where the output tiles are
// too few to fill the card (decode), the contraction is split across CTAs
// (grid z) into an f32 workspace that a second kernel sums in a fixed
// order, applies the Q8 scale to and casts: deterministic, no atomics.
// wgmma, TMA and a deeper ring are left for a later pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BN = 64;         // output columns per CTA
constexpr int BK = 128;        // contraction depth per tile
constexpr int NT = 128;        // 4 warps
constexpr int LDA = BK + 8;    // bf16 row stride of the A tile and of [n][k]
constexpr int LDT = BN + 8;    // bf16 row stride of the Q8T [k][n] tile

enum Mode { Q8 = 0, Q8T = 1 };

template <int BM, int MODE>
struct Tiles {
  bf16 a[BM][LDA];
  bf16 b[MODE == Q8T ? BK : BN][MODE == Q8T ? LDT : LDA];
};

// 16-byte vectors of the raw int8 weight tile per thread
template <int MODE>
struct BVec {
  static constexpr int n = BN * BK / 16 / NT;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) |
         (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A rows [m0, m0 + BM), columns [k0, k0 + BK) into registers; zero outside
// [M, K].  `vec`: K % 8 == 0, so a vector never straddles the row's end.
template <int BM>
__device__ __forceinline__ void load_a(uint4 (&r)[BM / 8], const bf16* a,
                                       int M, int K, int m0, int k0,
                                       bool vec, int tid) {
#pragma unroll
  for (int i = 0; i < BM / 8; ++i) {
    const int v = tid + i * NT;
    const int row = m0 + v / 16;
    const int col = k0 + (v % 16) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < M && col < K) {
      const bf16* p = a + int64_t(row) * K + col;
      if (vec) {
        val = *reinterpret_cast<const uint4*>(p);
      } else {
        __align__(16) bf16 tmp[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          tmp[e] = (col + e < K) ? p[e] : __ushort_as_bfloat16(0);
        val = *reinterpret_cast<const uint4*>(tmp);
      }
    }
    r[i] = val;
  }
}

template <int BM, int MODE>
__device__ __forceinline__ void store_a(Tiles<BM, MODE>& t,
                                        const uint4 (&r)[BM / 8], int tid) {
#pragma unroll
  for (int i = 0; i < BM / 8; ++i) {
    const int v = tid + i * NT;
    *reinterpret_cast<uint4*>(&t.a[v / 16][(v % 16) * 8]) = r[i];
  }
}

// 16 raw bytes from `p`, of which `avail` lie inside the row (zero past
// them); one vector load when all 16 do and `vec`
__device__ __forceinline__ uint4 load16(const int8_t* p, int avail, bool vec) {
  if (avail >= 16 && vec) return *reinterpret_cast<const uint4*>(p);
  __align__(16) int8_t tmp[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) tmp[e] = e < avail ? p[e] : int8_t(0);
  return *reinterpret_cast<const uint4*>(tmp);
}

// The raw weight tile for contraction tile k0 into registers.
//   Q8:  rows n of q[N][K], bytes k0 .. k0 + 127
//   Q8T: rows k0 .. k0 + 127 of q[K][N], bytes n0 .. n0 + 63
template <int MODE>
__device__ __forceinline__ void load_b(uint4 (&r)[BVec<MODE>::n],
                                       const int8_t* w, int N, int K, int n0,
                                       int k0, bool vec, int tid) {
#pragma unroll
  for (int i = 0; i < BVec<MODE>::n; ++i) {
    const int v = tid + i * NT;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (MODE == Q8) {
      const int n = n0 + v / 8, kb = k0 + (v % 8) * 16;
      if (n < N && kb < K)
        val = load16(w + int64_t(n) * K + kb, K - kb, vec);
    } else {
      const int k = k0 + v / 4, nb = n0 + (v % 4) * 16;
      if (k < K && nb < N)
        val = load16(w + int64_t(k) * N + nb, N - nb, vec);
    }
    r[i] = val;
  }
}

template <int BM, int MODE>
__device__ __forceinline__ void store_b(Tiles<BM, MODE>& t,
                                        const uint4 (&r)[BVec<MODE>::n],
                                        int tid) {
#pragma unroll
  for (int i = 0; i < BVec<MODE>::n; ++i) {
    const int v = tid + i * NT;
    const int8_t* by = reinterpret_cast<const int8_t*>(&r[i]);
    __align__(16) bf16 lo[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) lo[e] = __float2bfloat16(float(by[e]));
    bf16* dst = MODE == Q8 ? &t.b[v / 8][(v % 8) * 16]
                           : &t.b[v / 4][(v % 4) * 16];
    reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(lo)[0];
    reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(lo)[1];
  }
}

template <int BM>
struct Warps {
  static constexpr int WM = BM == 16 ? 1 : 2;  // warps along M
  static constexpr int WN = 4 / WM;            // warps along N
  static constexpr int MI = BM / (16 * WM);    // m16 tiles per warp
  static constexpr int NI = BN / (8 * WN);     // n8 tiles per warp
};

// out[M, N] (bf16 or f32) or, with splits > 1, the f32 partial sums of this
// split into ws[split][M][N].  `scale`: Q8 the [N] column scale, Q8T
// unused.  Tiles [z * per, (z + 1) * per) of the contraction belong to
// split z.
template <int BM, int MODE>
__global__ void __launch_bounds__(NT)
quant_mm_kernel(const bf16* __restrict__ a, const int8_t* __restrict__ w,
                const float* __restrict__ scale, void* __restrict__ out,
                int out_f32, float* __restrict__ ws, int M, int N, int K,
                int per, int splits, int a_vec, int b_vec) {
  using W = Warps<BM>;
  __shared__ __align__(16) unsigned char smem[sizeof(Tiles<BM, MODE>)];
  Tiles<BM, MODE>& t = *reinterpret_cast<Tiles<BM, MODE>*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int nk = (K + BK - 1) / BK;
  const int t0 = blockIdx.z * per;
  const int t1 = min(nk, t0 + per);
  const int wm0 = (warp / W::WN) * W::MI * 16;
  const int wn0 = (warp % W::WN) * W::NI * 8;

  float acc[W::MI][W::NI][4];
#pragma unroll
  for (int mi = 0; mi < W::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < W::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  uint4 ra[BM / 8];
  uint4 rb[BVec<MODE>::n];
  if (t0 < t1) {
    load_a<BM>(ra, a, M, K, m0, t0 * BK, a_vec, tid);
    load_b<MODE>(rb, w, N, K, n0, t0 * BK, b_vec, tid);
    store_a<BM, MODE>(t, ra, tid);
    store_b<BM, MODE>(t, rb, tid);
  }
  __syncthreads();

  for (int kt = t0; kt < t1; ++kt) {
    const bool more = kt + 1 < t1;
    if (more) {
      load_a<BM>(ra, a, M, K, m0, (kt + 1) * BK, a_vec, tid);
      load_b<MODE>(rb, w, N, K, n0, (kt + 1) * BK, b_vec, tid);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[W::MI][4];
#pragma unroll
      for (int mi = 0; mi < W::MI; ++mi) {
        const int r = wm0 + mi * 16 + g;
        af[mi][0] = ld32(&t.a[r][kk + 2 * tq]);
        af[mi][1] = ld32(&t.a[r + 8][kk + 2 * tq]);
        af[mi][2] = ld32(&t.a[r][kk + 2 * tq + 8]);
        af[mi][3] = ld32(&t.a[r + 8][kk + 2 * tq + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < W::NI; ++ni) {
        const int n = wn0 + ni * 8 + g;
        uint32_t b0, b1;
        if (MODE == Q8T) {
          b0 = pack2(t.b[kk + 2 * tq][n], t.b[kk + 2 * tq + 1][n]);
          b1 = pack2(t.b[kk + 2 * tq + 8][n], t.b[kk + 2 * tq + 9][n]);
        } else {
          b0 = ld32(&t.b[n][kk + 2 * tq]);
          b1 = ld32(&t.b[n][kk + 2 * tq + 8]);
        }
#pragma unroll
        for (int mi = 0; mi < W::MI; ++mi)
          mma16816(acc[mi][ni], af[mi], b0, b1);
      }
    }
    __syncthreads();                   // tile kt fully consumed
    if (more) {
      store_a<BM, MODE>(t, ra, tid);
      store_b<BM, MODE>(t, rb, tid);
      __syncthreads();
    }
  }

  // epilogue: element e of tile (mi, ni) is row g (+8 for e >= 2), column
  // 2 tq + (e & 1) of that tile
#pragma unroll
  for (int mi = 0; mi < W::MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < W::NI; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm0 + mi * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn0 + ni * 8 + 2 * tq + (e & 1);
        if (row >= M || col >= N) continue;
        float v = acc[mi][ni][e];
        const int64_t o = int64_t(row) * N + col;
        if (splits > 1) {
          ws[int64_t(blockIdx.z) * M * N + o] = v;
          continue;
        }
        if (MODE == Q8) v *= scale[col];
        if (out_f32) static_cast<float*>(out)[o] = v;
        else static_cast<bf16*>(out)[o] = __float2bfloat16(v);
      }
    }
  }
}

// out = (sum over splits of ws, in split order) [* scale[col]]
__global__ void splitk_reduce(const float* __restrict__ ws,
                              const float* __restrict__ scale,
                              void* __restrict__ out, int out_f32, int M,
                              int N, int splits) {
  const int64_t total = int64_t(M) * N;
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x;
       i < total; i += int64_t(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += ws[s * total + i];
    if (scale) v *= scale[i % N];
    if (out_f32) static_cast<float*>(out)[i] = v;
    else static_cast<bf16*>(out)[i] = __float2bfloat16(v);
  }
}

template <int BM, int MODE>
int launch(const void* a, const void* w, const float* scale, void* out,
           int out_f32, float* ws, int M, int N, int K, int splits,
           cudaStream_t stream) {
  const int nk = (K + BK - 1) / BK;
  const int per = (nk + splits - 1) / splits;
  const int a_vec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0);
  const int b_vec = ((MODE == Q8T ? N : K) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  quant_mm_kernel<BM, MODE><<<grid, NT, 0, stream>>>(
      static_cast<const bf16*>(a), static_cast<const int8_t*>(w), scale, out,
      out_f32, ws, M, N, K, per, splits, a_vec, b_vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return int(e);
  const int64_t total = int64_t(M) * N;
  const int64_t want = (total + 255) / 256;
  const int blocks = want < 4096 ? int(want) : 4096;
  splitk_reduce<<<blocks, 256, 0, stream>>>(
      ws, MODE == Q8 ? scale : nullptr, out, out_f32, M, N, splits);
  return int(cudaGetLastError());
}

template <int MODE>
int dispatch(const void* a, const void* w, const float* scale, void* out,
             int out_f32, float* ws, int M, int N, int K, int splits,
             cudaStream_t stream) {
  if (M <= 16)
    return launch<16, MODE>(a, w, scale, out, out_f32, ws, M, N, K, splits,
                            stream);
  return launch<64, MODE>(a, w, scale, out, out_f32, ws, M, N, K, splits,
                          stream);
}

}  // namespace

// mode 0 (Q8): a = x bf16 [M, K], w = int8 [N, K], scale f32 [N];
// mode 1 (Q8T): a = gs bf16 [M, K] (K the weight's rows), w = int8 [K, N],
//   scale unused (NULL).
// out: [M, N] contiguous, f32 if out_f32 else bf16.  With splits > 1, ws is
// an f32 workspace of splits * M * N.  All pointers are device pointers and
// the tensors contiguous.  Rows M <= 16 take 16-row tiles, larger M 64-row
// tiles.  Returns the cudaError_t of the launches.
extern "C" int opadpo_quant_matmul(int mode, const void* a, const void* w,
                                   const void* scale, void* out, int out_f32,
                                   void* ws, int M, int N, int K, int splits,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* wsp = static_cast<float*>(ws);
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || (splits > 1 && !wsp))
    return int(cudaErrorInvalidValue);
  if (mode == Q8)
    return dispatch<Q8>(a, w, sc, out, out_f32, wsp, M, N, K, splits, st);
  if (mode == Q8T)
    return dispatch<Q8T>(a, w, sc, out, out_f32, wsp, M, N, K, splits, st);
  return int(cudaErrorInvalidValue);
}
