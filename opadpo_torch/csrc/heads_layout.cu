// Head-layout passes around the flash kernels, with RoPE folded in, for
// Hopper (sm_90a), bf16 in and out, rotation in f32.
//
// scatter_heads replaces opadpo_tpu/ops/attention.py:_scatter_heads_kernel
// (the _to_heads prologue): a projection output x [B, S, Hkv*hd] becomes
// head-major [B, H, S, hd], H = rep * Hkv, output head h reading source
// head h / rep (the GQA repeat, never materialised), each head rotated by
// the rotate-half RoPE at its row's position:
//   out[:hd/2] = x1 cos - x2 sin,  out[hd/2:] = x2 cos + x1 sin,
// with cos/sin = table[position][:hd/2] (f32 tables [max_len, hd]).
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
// What bounds it: each is one read of the input and one write of the
// output with ~6 flops per element, so both are bytes-bound.  One CTA
// handles 64 rows of one (b, head); a thread moves 8 lanes of each half of
// a head row with 16-byte loads and stores, so a warp reads and writes
// whole 256-byte head rows (hd = 128), and the cos/sin rows come from the
// tables, which stay in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// grid (ceil(S / 64), H, B); x rows have stride x_ss, batches x_sb
__global__ void __launch_bounds__(NTHREADS)
scatter_heads_kernel(const bf16* __restrict__ x, const float* __restrict__ cos,
                     const float* __restrict__ sin,
                     const int* __restrict__ pos, bf16* __restrict__ out,
                     int S, int H, int hd, int rep, int64_t x_sb,
                     int64_t x_ss) {
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int half = hd / 2;
  const int tpr = half / 8;              // threads per head row
  const int rpp = NTHREADS / tpr;        // rows per pass
  const int lane8 = (threadIdx.x % tpr) * 8;
  const bf16* xb = x + b * x_sb + (h / rep) * hd;
  bf16* ob = out + (int64_t(b) * H + h) * S * hd;
  for (int r = threadIdx.x / tpr; r < ROWS; r += rpp) {
    const int s = blockIdx.x * ROWS + r;
    if (s >= S) break;
    const bf16* src = xb + s * x_ss + lane8;
    Vec8 x1 = load8(src);
    Vec8 x2 = load8(src + half);
    if (cos != nullptr) {
      const int64_t t = int64_t(pos[int64_t(b) * S + s]) * hd + lane8;
      rotate(x1, x2, load8f(cos + t), load8f(sin + t), false);
    }
    bf16* dst = ob + int64_t(s) * hd + lane8;
    store8(dst, x1);
    store8(dst + half, x2);
  }
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

// x: bf16 [B, S, Hkv*hd] with batch and row strides x_sb, x_ss (unit inner
// stride); cos, sin: f32 [max_len, hd] tables or both NULL (no RoPE); pos:
// int32 [B, S] contiguous (ignored without RoPE); out: bf16 [B, H, S, hd]
// contiguous, H = rep * Hkv.  hd is 16, 32, 64, 128 or 256.  Returns the
// cudaError_t of the launch.
extern "C" int opadpo_scatter_heads_bf16(const void* x, const void* cos,
                                         const void* sin, const void* pos,
                                         void* out, int B, int S, int H,
                                         int hd, int rep, int64_t x_sb,
                                         int64_t x_ss, void* stream) {
  if (hd <= 0 || hd % 16 != 0 || NTHREADS % (hd / 16) != 0 || S <= 0)
    return int(cudaErrorInvalidValue);
  dim3 grid((S + ROWS - 1) / ROWS, H, B);
  scatter_heads_kernel<<<grid, NTHREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<const int*>(pos),
      static_cast<bf16*>(out), S, H, hd, rep, x_sb, x_ss);
  return int(cudaGetLastError());
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
