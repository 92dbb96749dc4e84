// Head-layout passes around the flash kernels, with RoPE folded in, for
// Hopper (sm_90a), bf16 in and out, rotation in f32.
//
// scatter_heads replaces opadpo_tpu/ops/attention.py:_scatter_heads_kernel
// (the _to_heads prologue): a projection output x [B, S, Hkv*hd] becomes
// head-major [B, H, S, hd], H = rep * Hkv, output head h reading source
// head h / rep (the GQA repeat, never materialised), each head rotated by
// the rotate-half RoPE at its row's position:
//   out[:hd/2] = x1 cos - x2 sin,  out[hd/2:] = x2 cos + x1 sin,
// with cos/sin = table[position][:hd/2] (f32 tables [max_len, hd]).  One
// launch takes up to three such tensors (q, k and v of a stream), each
// with its own strides, RoPE flag and rep, sharing B, S, hd and the
// positions.
//
// gather_heads replaces _gather_heads_kernel (the _to_heads VJP): a
// gradient g, logically [B, H, S, hd] with any strides and unit stride on
// hd, becomes [B, S, Hkv*hd], each output head the sum over its `group`
// repeated heads of the inverse rotation R(-theta):
//   out[:hd/2] = x1 cos + x2 sin,  out[hd/2:] = x2 cos - x1 sin.
// Without RoPE (the V path) both are a plain layout change.
//
// The JAX package also runs these for its _from_heads epilogue, because
// the Pallas kernel writes head-major output.  The port's flash kernels
// write [B, S, H, hd], which is [B, S, H*hd] already, so the epilogue and
// its VJP need no pass at all, and the flash kernels read the prologue's
// [B, H, S, hd] output through a permuted view, unpadded.
//
// What bounds them: each is one read of the input and one write of the
// output with ~6 flops per element, and the positions and one cos and sin
// half-row per row, so both are bytes-bound.
//
// The scatter kernel, for the card:
//  - Work.  A tile is 64 rows of one source head of one tensor, [64, hd].
//    A CTA of 256 threads owns 64 rows of one batch and a contiguous run
//    of the launch's tiles (q's heads, then k's, then v's, split evenly
//    into `groups` runs); ops/heads_layout.py scatter_grid picks the groups
//    so that every CTA of the launch is resident at once (one wave).
//  - Tables once per row.  A thread owns the same 8 columns of each half
//    of the same rows in every tile, so it loads its rows' positions and
//    cos / sin values into registers once, while the first tiles are in
//    flight, and every head of q and k reuses them.
//  - Loads.  One thread keeps 4 tiles in flight, TMA copies through a 3-D
//    map over each x (hd columns x S rows x B, its own strides; rows past
//    S read as zeros), each completing on its stage's mbarrier.
//  - Rotation in place in shared memory, 16-byte reads and writes (a
//    quarter warp touches one row's 128 contiguous bytes); v's tiles are
//    not touched.  Then one thread stores the tile to each of its rep
//    output heads by TMA through a 3-D map over out (hd x S x B*H), which
//    clips at S, so the tail block writes nothing into the next head's
//    rows.  A stage is refilled once the store of the tile before it has
//    read it, so loads, rotation and stores overlap.
//
// The gather kernel: one CTA handles 64 rows of one (b, kv head); a
// thread moves 8 lanes of each half of a head row with 16-byte loads and
// stores, so a warp reads and writes whole 256-byte head rows (hd = 128),
// and the cos/sin rows come from the tables, which stay in L2.

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int ROWS = 64;
constexpr int NTHREADS = 128;

struct Vec8 {
  float v[8];
};

__device__ __forceinline__ Vec8 load8(const bf16* p) {
  __align__(16) bf16 raw[8];
  *reinterpret_cast<uint4*>(raw) = *reinterpret_cast<const uint4*>(p);
  Vec8 out;
#pragma unroll
  for (int e = 0; e < 8; ++e) out.v[e] = __bfloat162float(raw[e]);
  return out;
}

__device__ __forceinline__ void store8(bf16* p, const Vec8& x) {
  __align__(16) bf16 raw[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) raw[e] = __float2bfloat16(x.v[e]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<uint4*>(raw);
}

__device__ __forceinline__ Vec8 load8f(const float* p) {
  Vec8 out;
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out.v[0] = a.x; out.v[1] = a.y; out.v[2] = a.z; out.v[3] = a.w;
  out.v[4] = b.x; out.v[5] = b.y; out.v[6] = b.z; out.v[7] = b.w;
  return out;
}

// rotate the pair (x1, x2) of one head row's lanes [i, i+8) and
// [i+hd/2, i+hd/2+8); inverse applies R(-theta)
__device__ __forceinline__ void rotate(Vec8& x1, Vec8& x2, const Vec8& c,
                                       const Vec8& s, bool inverse) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float a = x1.v[e], b = x2.v[e];
    if (inverse) {
      x1.v[e] = a * c.v[e] + b * s.v[e];
      x2.v[e] = b * c.v[e] - a * s.v[e];
    } else {
      x1.v[e] = a * c.v[e] - b * s.v[e];
      x2.v[e] = b * c.v[e] + a * s.v[e];
    }
  }
}

// ---- the scatter kernel ----

constexpr int SROWS = 64;        // rows of a tile
constexpr int STHREADS = 256;
constexpr int SSTAGES = 4;       // tiles in flight a CTA
constexpr int MAX_TENSORS = 3;

struct ScatterTensor {
  CUtensorMap in;    // x: (Hkv * hd, S, B), box (hd, SROWS, 1)
  CUtensorMap out;   // out: (hd, S, B * H), box (hd, SROWS, 1)
  int rope, rep, nsrc;   // RoPE flag, GQA repeat, source heads (Hkv)
};

struct ScatterParams {
  ScatterTensor t[MAX_TENSORS];
  const float* cos;  // NULL when no tensor takes RoPE
  const float* sin;
  const int* pos;
  int tiles, S, groups;
};

template <int HD>
__host__ __device__ constexpr int scatter_smem() {
  return SSTAGES * SROWS * HD * 2 + 8 * SSTAGES + 1024;  // + alignment
}

// grid (ceil(S / 64), B, groups)
template <int HD>
__global__ void __launch_bounds__(STHREADS, 3)
scatter_heads_kernel(const __grid_constant__ ScatterParams p) {
  constexpr int TPR = HD / 16;              // threads a row
  constexpr int RPP = STHREADS / TPR;       // rows a pass
  constexpr int PASSES = SROWS / RPP;
  constexpr int TILE = SROWS * HD * 2;      // bytes
  extern __shared__ unsigned char raw_smem[];
  unsigned char* smem =
      raw_smem + ((1024 - (hopper::smem_u32(raw_smem) & 1023)) & 1023);
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t bar = base + SSTAGES * TILE;
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * SROWS;
  const int b = blockIdx.y;
  const int lo = blockIdx.z * p.tiles / p.groups;
  const int count = (blockIdx.z + 1) * p.tiles / p.groups - lo;

  // tile lo + i of the launch -> its tensor and source head
  auto locate = [&](int i, int& j) -> const ScatterTensor& {
    j = lo + i;
    int t = 0;
    while (j >= p.t[t].nsrc) j -= p.t[t++].nsrc;
    return p.t[t];
  };
  auto issue = [&](int i) {                // thread 0: load tile i
    int j;
    const ScatterTensor& T = locate(i, j);
    const uint32_t full = bar + 8 * (i % SSTAGES);
    hopper::mbar_expect_tx(full, TILE);
    hopper::tma_load_3d(base + (i % SSTAGES) * TILE, &T.in, full, j * HD, s0,
                        b);
  };

  if (tid == 0) {
    for (int s = 0; s < SSTAGES; ++s) hopper::mbar_init(bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < min(SSTAGES, count); ++i) issue(i);

  // this thread's rows and columns, and their tables
  const int c8 = (tid % TPR) * 8;
  const int row0 = tid / TPR;
  Vec8 cs[PASSES], sn[PASSES];
#pragma unroll
  for (int ps = 0; ps < PASSES; ++ps) {
    const int s = s0 + row0 + ps * RPP;
    if (p.cos != nullptr && s < p.S) {
      const int64_t at = int64_t(p.pos[int64_t(b) * p.S + s]) * HD + c8;
      cs[ps] = load8f(p.cos + at);
      sn[ps] = load8f(p.sin + at);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) cs[ps].v[e] = 1.f, sn[ps].v[e] = 0.f;
    }
  }

  for (int i = 0; i < count; ++i) {
    int j;
    const ScatterTensor& T = locate(i, j);
    const int st = i % SSTAGES;
    hopper::mbar_wait(bar + 8 * st, (i / SSTAGES) & 1);
    if (T.rope) {
#pragma unroll
      for (int ps = 0; ps < PASSES; ++ps) {
        bf16* r = reinterpret_cast<bf16*>(smem + st * TILE) +
                  (row0 + ps * RPP) * HD + c8;
        Vec8 x1 = load8(r), x2 = load8(r + HD / 2);
        rotate(x1, x2, cs[ps], sn[ps], false);
        store8(r, x1);
        store8(r + HD / 2, x2);
      }
      hopper::fence_proxy_async();
    }
    __syncthreads();
    if (tid == 0) {
      const int h0 = b * T.nsrc * T.rep + j * T.rep;
      for (int r = 0; r < T.rep; ++r)
        hopper::tma_store_3d(&T.out, base + st * TILE, 0, s0, h0 + r);
      hopper::bulk_commit();
      // refill the previous tile's stage once its store has read it
      if (i >= 1 && i - 1 + SSTAGES < count) {
        hopper::bulk_wait_read<1>();
        issue(i - 1 + SSTAGES);
      }
    }
  }
  if (tid == 0) hopper::bulk_wait_read<0>();   // no store reads past exit
}

template <int HD>
int scatter_launch(const ScatterParams& p, dim3 grid, cudaStream_t stream) {
  static bool configured = false;
  const int e = hopper::allow_smem(scatter_heads_kernel<HD>,
                                   scatter_smem<HD>(), configured);
  if (e != 0) return e;
  scatter_heads_kernel<HD><<<grid, STHREADS, scatter_smem<HD>(), stream>>>(
      p);
  return int(cudaGetLastError());
}

// grid (ceil(S / 64), Hkv, B); g is [B, H, S, hd] with strides (g_sb,
// g_sh, g_ss), H = group * Hkv; out is [B, S, Hkv*hd] contiguous
__global__ void __launch_bounds__(NTHREADS)
gather_heads_kernel(const bf16* __restrict__ g, const float* __restrict__ cos,
                    const float* __restrict__ sin,
                    const int* __restrict__ pos, bf16* __restrict__ out,
                    int S, int Hkv, int hd, int group, int64_t g_sb,
                    int64_t g_sh, int64_t g_ss) {
  const int j = blockIdx.y;
  const int b = blockIdx.z;
  const int half = hd / 2;
  const int tpr = half / 8;
  const int rpp = NTHREADS / tpr;
  const int lane8 = (threadIdx.x % tpr) * 8;
  for (int r = threadIdx.x / tpr; r < ROWS; r += rpp) {
    const int s = blockIdx.x * ROWS + r;
    if (s >= S) break;
    Vec8 c, sn;
    if (cos != nullptr) {
      const int64_t t = int64_t(pos[int64_t(b) * S + s]) * hd + lane8;
      c = load8f(cos + t);
      sn = load8f(sin + t);
    }
    Vec8 a1, a2;
#pragma unroll
    for (int e = 0; e < 8; ++e) a1.v[e] = a2.v[e] = 0.f;
    for (int q = 0; q < group; ++q) {
      const bf16* src = g + b * g_sb + (int64_t(j) * group + q) * g_sh +
                        s * g_ss + lane8;
      Vec8 x1 = load8(src);
      Vec8 x2 = load8(src + half);
      if (cos != nullptr) rotate(x1, x2, c, sn, true);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        a1.v[e] += x1.v[e];
        a2.v[e] += x2.v[e];
      }
    }
    bf16* dst = out + (int64_t(b) * S + s) * Hkv * hd + j * hd + lane8;
    store8(dst, a1);
    store8(dst + half, a2);
  }
}

}  // namespace

// n (1..3) tensors: x[t] bf16 [B, S, nsrc[t]*hd] with batch and row
// strides x_strides[2t], x_strides[2t + 1] (elements, multiples of 8; unit
// inner stride; 16-byte aligned) -> out[t] bf16 [B, rep[t]*nsrc[t], S, hd]
// contiguous, rotated where rope[t]; cos, sin: f32 [max_len, hd] tables and
// pos: int32 [B, S] contiguous, or all NULL when no tensor takes RoPE.  hd
// is 64 or 128; `groups` (1 .. the tiles, sum of nsrc) from
// ops/heads_layout.py scatter_grid.  Returns the cudaError_t of the launch,
// -1 if the driver has no cuTensorMapEncodeTiled, or 100000 + its CUresult.
extern "C" int opadpo_scatter_heads_bf16(int n, const void* const* x,
                                         const int64_t* x_strides,
                                         void* const* out, const int* rope,
                                         const int* rep, const int* nsrc,
                                         const void* cos, const void* sin,
                                         const void* pos, int B, int S,
                                         int hd, int groups, void* stream) {
  if (n < 1 || n > MAX_TENSORS || (hd != 64 && hd != 128) || S <= 0 ||
      B <= 0 || groups < 1)
    return int(cudaErrorInvalidValue);
  ScatterParams p = {};
  for (int t = 0; t < n; ++t) {
    if (nsrc[t] < 1 || rep[t] < 1 || (rope[t] && cos == nullptr))
      return int(cudaErrorInvalidValue);
    const int64_t heads = int64_t(B) * nsrc[t] * rep[t];
    int e = hopper::make_map_3d_bf16(&p.t[t].in, x[t], int64_t(nsrc[t]) * hd,
                                     S, B, x_strides[2 * t + 1] * 2,
                                     x_strides[2 * t] * 2, hd, SROWS);
    if (e == 0)
      e = hopper::make_map_3d_bf16(&p.t[t].out, out[t], hd, S, heads,
                                   int64_t(hd) * 2, int64_t(S) * hd * 2, hd,
                                   SROWS);
    if (e != 0) return e;
    p.t[t].rope = rope[t];
    p.t[t].rep = rep[t];
    p.t[t].nsrc = nsrc[t];
    p.tiles += nsrc[t];
  }
  if (groups > p.tiles) return int(cudaErrorInvalidValue);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.pos = static_cast<const int*>(pos);
  p.S = S;
  p.groups = groups;
  const dim3 grid((S + SROWS - 1) / SROWS, B, groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd == 128 ? scatter_launch<128>(p, grid, st)
                   : scatter_launch<64>(p, grid, st);
}

// CTAs of the scatter kernel an SM holds at once, or -(cudaError_t)
extern "C" int opadpo_scatter_heads_ctas_per_sm(int hd) {
  int n = 0;
  cudaError_t e;
  if (hd == 128) {
    static bool configured = false;
    if (hopper::allow_smem(scatter_heads_kernel<128>, scatter_smem<128>(),
                           configured))
      return -1;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, scatter_heads_kernel<128>, STHREADS, scatter_smem<128>());
  } else if (hd == 64) {
    static bool configured = false;
    if (hopper::allow_smem(scatter_heads_kernel<64>, scatter_smem<64>(),
                           configured))
      return -1;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, scatter_heads_kernel<64>, STHREADS, scatter_smem<64>());
  } else {
    return -int(cudaErrorInvalidValue);
  }
  return e == cudaSuccess ? n : -int(e);
}

// g: bf16 [B, H, S, hd] with strides g_sb, g_sh, g_ss (unit stride on hd);
// cos, sin, pos as above (inverse rotation); out: bf16 [B, S, Hkv*hd]
// contiguous, H = group * Hkv.  Returns the cudaError_t of the launch.
extern "C" int opadpo_gather_heads_bf16(const void* g, const void* cos,
                                        const void* sin, const void* pos,
                                        void* out, int B, int S, int Hkv,
                                        int hd, int group, int64_t g_sb,
                                        int64_t g_sh, int64_t g_ss,
                                        void* stream) {
  if (hd <= 0 || hd % 16 != 0 || NTHREADS % (hd / 16) != 0 || S <= 0)
    return int(cudaErrorInvalidValue);
  dim3 grid((S + ROWS - 1) / ROWS, Hkv, B);
  gather_heads_kernel<<<grid, NTHREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<const int*>(pos),
      static_cast<bf16*>(out), S, Hkv, hd, group, g_sb, g_sh, g_ss);
  return int(cudaGetLastError());
}
