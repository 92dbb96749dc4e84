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
// hd, becomes [B, S, Hkv*hd], each output head the f32 sum over its `group`
// repeated heads of the inverse rotation R(-theta):
//   out[:hd/2] = x1 cos + x2 sin,  out[hd/2:] = x2 cos - x1 sin.
// Without RoPE (the V path) only the heads are summed.  One launch takes up
// to three such gradients (dQ, dK and dV of a stream), each with its own
// strides, RoPE flag and group, sharing B, H, S, hd and the positions.
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
// The gather kernel is the scatter kernel run backwards:
//  - Work.  A tile is 64 rows of one output (kv) head of one tensor; the
//    CTAs and their runs of tiles (dQ's heads, then dK's, then dV's) are
//    the scatter's, from the same grid rule (gather_grid).
//  - Loads.  One TMA copy through a 4-D map over each gradient (hd x S x H
//    x B, the view's own element strides, so a permuted or sliced view
//    needs no copy) brings the `group` heads of a kv head, a box of (hd,
//    64, group, 1); rows past S read as zeros.  4 tiles in flight where
//    they fit (2 at least), each on its stage's mbarrier.
//  - Tables once per row, as in the scatter kernel.
//  - Rotation and sum in shared memory: each thread rotates its columns of
//    every head of the tile in f32 registers, sums them and writes the sum
//    over the first head's rows (in place at group 1); a tile without RoPE
//    at group 1 (dV of a model without GQA) is not touched.  Then one
//    thread stores the first head's rows by TMA through a 3-D map over out
//    (Hkv*hd x S x B), which clips at S, and a stage is refilled once the
//    store of the tile before it has read it.

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

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

// the cos / sin values of columns [c8, c8 + 8) of the rows s, s + RPP,
// ... (PASSES rows) of batch b: table[pos[b, s]]; 1 and 0 past S or
// without RoPE (cos NULL)
template <int HD, int PASSES, int RPP>
__device__ __forceinline__ void load_tables(const float* cos,
                                            const float* sin, const int* pos,
                                            int b, int S, int s, int c8,
                                            Vec8 (&cs)[PASSES],
                                            Vec8 (&sn)[PASSES]) {
#pragma unroll
  for (int ps = 0; ps < PASSES; ++ps, s += RPP) {
    if (cos != nullptr && s < S) {
      const int64_t at = int64_t(pos[int64_t(b) * S + s]) * HD + c8;
      cs[ps] = load8f(cos + at);
      sn[ps] = load8f(sin + at);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) cs[ps].v[e] = 1.f, sn[ps].v[e] = 0.f;
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
  load_tables<HD, PASSES, RPP>(p.cos, p.sin, p.pos, b, p.S, s0 + row0, c8,
                               cs, sn);

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
int scatter_allow() {
  static bool configured = false;
  return hopper::allow_smem(scatter_heads_kernel<HD>, scatter_smem<HD>(),
                            configured);
}

template <int HD>
int scatter_launch(const ScatterParams& p, dim3 grid, cudaStream_t stream) {
  const int e = scatter_allow<HD>();
  if (e != 0) return e;
  scatter_heads_kernel<HD><<<grid, STHREADS, scatter_smem<HD>(), stream>>>(
      p);
  return int(cudaGetLastError());
}

// ---- the gather kernel ----

constexpr int SMEM_MAX = 232448;          // a block's shared memory, opt-in

struct GatherTensor {
  CUtensorMap in;    // g: (hd, S, H, B), own strides, box (hd, SROWS, group, 1)
  CUtensorMap out;   // out: (Hkv * hd, S, B), box (hd, SROWS, 1)
  int rope, group, nout;   // RoPE flag, heads summed, output heads (Hkv)
};

struct GatherParams {
  GatherTensor t[MAX_TENSORS];
  const float* cos;  // NULL when no tensor takes RoPE
  const float* sin;
  const int* pos;
  int tiles, S, groups;
  int stages, stage;  // tiles in flight (2 .. SSTAGES), bytes a stage
};

// stages of a launch whose largest group is gmax (up to SSTAGES tiles of
// gmax heads' 64 rows; fewer than 2 cannot run), and its shared memory
inline int gather_stages(int hd, int gmax, int& smem) {
  const int stage = gmax * SROWS * hd * 2;
  const int fit = (SMEM_MAX - 1024 - 8 * SSTAGES) / stage;
  const int stages = fit < SSTAGES ? fit : SSTAGES;
  smem = stages * stage + 8 * SSTAGES + 1024;  // + alignment
  return stages;
}

// grid (ceil(S / 64), B, groups)
template <int HD>
__global__ void __launch_bounds__(STHREADS, 3)
gather_heads_kernel(const __grid_constant__ GatherParams p) {
  constexpr int TPR = HD / 16;              // threads a row
  constexpr int RPP = STHREADS / TPR;       // rows a pass
  constexpr int PASSES = SROWS / RPP;
  constexpr int HEAD = SROWS * HD;          // elements of one head's rows
  extern __shared__ unsigned char raw_smem[];
  unsigned char* smem =
      raw_smem + ((1024 - (hopper::smem_u32(raw_smem) & 1023)) & 1023);
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t bar = base + p.stages * p.stage;
  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * SROWS;
  const int b = blockIdx.y;
  const int lo = blockIdx.z * p.tiles / p.groups;
  const int count = (blockIdx.z + 1) * p.tiles / p.groups - lo;

  // tile lo + i of the launch -> its tensor and output head
  auto locate = [&](int i, int& j) -> const GatherTensor& {
    j = lo + i;
    int t = 0;
    while (j >= p.t[t].nout) j -= p.t[t++].nout;
    return p.t[t];
  };
  auto issue = [&](int i) {                // thread 0: load tile i
    int j;
    const GatherTensor& T = locate(i, j);
    const int st = i % p.stages;
    const uint32_t full = bar + 8 * st;
    hopper::mbar_expect_tx(full, T.group * HEAD * 2);
    hopper::tma_load_4d(base + st * p.stage, &T.in, full, 0, s0,
                        j * T.group, b);
  };

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) hopper::mbar_init(bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < min(p.stages, count); ++i) issue(i);

  // this thread's rows and columns, and their tables
  const int c8 = (tid % TPR) * 8;
  const int row0 = tid / TPR;
  Vec8 cs[PASSES], sn[PASSES];
  load_tables<HD, PASSES, RPP>(p.cos, p.sin, p.pos, b, p.S, s0 + row0, c8,
                               cs, sn);

  for (int i = 0; i < count; ++i) {
    int j;
    const GatherTensor& T = locate(i, j);
    const int st = i % p.stages;
    hopper::mbar_wait(bar + 8 * st, (i / p.stages) & 1);
    if (T.rope || T.group > 1) {
      bf16* tile = reinterpret_cast<bf16*>(smem + st * p.stage);
#pragma unroll
      for (int ps = 0; ps < PASSES; ++ps) {
        bf16* r = tile + (row0 + ps * RPP) * HD + c8;
        Vec8 a1 = load8(r), a2 = load8(r + HD / 2);
        if (T.rope) rotate(a1, a2, cs[ps], sn[ps], true);
        for (int q = 1; q < T.group; ++q) {
          Vec8 x1 = load8(r + q * HEAD), x2 = load8(r + q * HEAD + HD / 2);
          if (T.rope) rotate(x1, x2, cs[ps], sn[ps], true);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            a1.v[e] += x1.v[e];
            a2.v[e] += x2.v[e];
          }
        }
        store8(r, a1);
        store8(r + HD / 2, a2);
      }
      hopper::fence_proxy_async();
    }
    __syncthreads();
    if (tid == 0) {
      hopper::tma_store_3d(&T.out, base + st * p.stage, j * HD, s0, b);
      hopper::bulk_commit();
      // refill the previous tile's stage once its store has read it
      if (i >= 1 && i - 1 + p.stages < count) {
        hopper::bulk_wait_read<1>();
        issue(i - 1 + p.stages);
      }
    }
  }
  if (tid == 0) hopper::bulk_wait_read<0>();   // no store reads past exit
}

template <int HD>
int gather_allow() {
  static bool configured = false;
  return hopper::allow_smem(gather_heads_kernel<HD>, SMEM_MAX, configured);
}

template <int HD>
int gather_launch(const GatherParams& p, int smem, dim3 grid,
                  cudaStream_t stream) {
  const int e = gather_allow<HD>();
  if (e != 0) return e;
  gather_heads_kernel<HD><<<grid, STHREADS, smem, stream>>>(p);
  return int(cudaGetLastError());
}

// CTAs of `kernel` (STHREADS threads, `smem` bytes of shared memory, the
// size allowed by `allowed`, its cudaError_t) an SM holds at once, or
// -(cudaError_t)
template <typename Kernel>
int ctas_per_sm(Kernel kernel, int allowed, int smem) {
  if (allowed != 0) return -allowed;
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, STHREADS, smem);
  return e == cudaSuccess ? n : -int(e);
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
  if (hd == 128)
    return ctas_per_sm(scatter_heads_kernel<128>, scatter_allow<128>(),
                       scatter_smem<128>());
  if (hd == 64)
    return ctas_per_sm(scatter_heads_kernel<64>, scatter_allow<64>(),
                       scatter_smem<64>());
  return -int(cudaErrorInvalidValue);
}

// n (1..3) gradients: g[t] bf16, logically [B, H, S, hd], with element
// strides g_strides[3t .. 3t + 2] on B, H and S (multiples of 8; unit
// stride on hd; 16-byte aligned) -> out[t] bf16 [B, S, (H / group[t])*hd]
// contiguous, each output head the sum of its group[t] heads, rotated back
// where rope[t]; cos, sin and pos as for the scatter, or all NULL when no
// tensor takes RoPE.  hd is 64 or 128, and two tiles of the largest group
// must fit in a block's shared memory (gather_stages); `groups` (1 .. the
// tiles, sum of H / group[t]) from ops/heads_layout.py gather_grid.
// Returns as opadpo_scatter_heads_bf16 does.
extern "C" int opadpo_gather_heads_bf16(int n, const void* const* g,
                                        const int64_t* g_strides,
                                        void* const* out, const int* rope,
                                        const int* group, const void* cos,
                                        const void* sin, const void* pos,
                                        int B, int S, int H, int hd,
                                        int groups, void* stream) {
  if (n < 1 || n > MAX_TENSORS || (hd != 64 && hd != 128) || S <= 0 ||
      B <= 0 || H <= 0 || groups < 1)
    return int(cudaErrorInvalidValue);
  GatherParams p = {};
  int gmax = 1;
  for (int t = 0; t < n; ++t) {
    if (group[t] < 1 || H % group[t] != 0 || (rope[t] && cos == nullptr))
      return int(cudaErrorInvalidValue);
    const int64_t* st = g_strides + 3 * t;
    const int64_t width = int64_t(H / group[t]) * hd;
    int e = hopper::make_map_4d_bf16(&p.t[t].in, g[t], hd, S, H, B,
                                     st[2] * 2, st[1] * 2, st[0] * 2, hd,
                                     SROWS, group[t], 1);
    if (e == 0)
      e = hopper::make_map_3d_bf16(&p.t[t].out, out[t], width, S, B,
                                   width * 2, int64_t(S) * width * 2, hd,
                                   SROWS);
    if (e != 0) return e;
    p.t[t].rope = rope[t];
    p.t[t].group = group[t];
    p.t[t].nout = H / group[t];
    p.tiles += H / group[t];
    if (group[t] > gmax) gmax = group[t];
  }
  int smem;
  p.stages = gather_stages(hd, gmax, smem);
  if (groups > p.tiles || p.stages < 2) return int(cudaErrorInvalidValue);
  p.stage = gmax * SROWS * hd * 2;
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.pos = static_cast<const int*>(pos);
  p.S = S;
  p.groups = groups;
  const dim3 grid((S + SROWS - 1) / SROWS, B, groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd == 128 ? gather_launch<128>(p, smem, grid, st)
                   : gather_launch<64>(p, smem, grid, st);
}

// CTAs of the gather kernel an SM holds at once when the launch's largest
// group is gmax, or -(cudaError_t)
extern "C" int opadpo_gather_heads_ctas_per_sm(int hd, int gmax) {
  int smem;
  if ((hd != 64 && hd != 128) || gmax < 1 ||
      gather_stages(hd, gmax, smem) < 2)
    return -int(cudaErrorInvalidValue);
  return hd == 128
             ? ctas_per_sm(gather_heads_kernel<128>, gather_allow<128>(), smem)
             : ctas_per_sm(gather_heads_kernel<64>, gather_allow<64>(), smem);
}
