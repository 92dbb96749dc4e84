// One-query decode attention over the int8 head-major prompt KV cache, for
// Hopper (sm_90a).
//
// Replaces opadpo_tpu/ops/decode_attention.py:_kernel (launched through
// _prompt_call by decode_attention_prompt).  The TPU kernel carried the
// softmax state (m, l) across a sequential grid axis over sequence blocks;
// Hopper's blocks run in no order, so here one CTA per (batch, head) walks
// the whole filled prefix [0, s_used) itself, in two passes:
//   1. scores: s = (q . K_int8[s]) * (k_scale[s] * sm_scale) + bias[s],
//      kept in shared memory, and their max m = max(-1e30, max_s s);
//   2. values: p = exp(s - m), l = sum p, out = sum bf16(p * v_scale[s]) *
//      V_int8[s].
// The K scale is folded into the score and the V scale into p, as the TPU
// kernel does, and p * v_scale is rounded to bf16 there too.  m starts at
// -1e30 (not -inf), so a prompt that is masked everywhere comes out
// uniform, as in JAX.  The output is UNNORMALISED, with m and l beside it,
// because the caller merges it with the bf16 suffix by logsumexp.
//
// What bounds it: it reads 2*s_used*hd int8 bytes and 2*s_used f32 scales
// per (b, h) and does ~4 flops per byte, so it is bound by memory
// bandwidth.  K and V rows load as 16-byte vectors, hd/16 lanes per row,
// neighbouring lane groups on neighbouring rows, four rows in flight per
// group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int UNROLL = 4;
constexpr float kMask = -1e30f;

__device__ __forceinline__ float dot16(const float* qf, const int4& raw) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s += qf[i] * float(e[i]);
  return s;
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
decode_attn_int8_kernel(const bf16* __restrict__ q,
                        const int8_t* __restrict__ kq,
                        const float* __restrict__ kscale,
                        const int8_t* __restrict__ vq,
                        const float* __restrict__ vscale,
                        const float* __restrict__ bias,
                        float* __restrict__ out, float* __restrict__ m_out,
                        float* __restrict__ l_out, int H, int Sp, int s_used,
                        float sm_scale) {
  constexpr int LPR = HD / 16;         // lanes per row, 16 bytes each
  constexpr int RPW = 32 / LPR;        // rows per warp per load
  constexpr int GROUPS = NWARPS * RPW; // row streams in the CTA
  constexpr int STEP = GROUPS * UNROLL;

  extern __shared__ __align__(16) unsigned char smem[];
  float* part_acc = reinterpret_cast<float*>(smem);        // [GROUPS][HD]
  float* red = part_acc + GROUPS * HD;                     // [NWARPS]
  float* scores = red + NWARPS;                            // [s_used]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int part = lane % LPR;
  const int g = warp * RPW + lane / LPR;

  float qf[16];
  {
    const bf16* qrow = q + int64_t(bh) * HD + part * 16;
#pragma unroll
    for (int i = 0; i < 16; ++i) qf[i] = __bfloat162float(qrow[i]);
  }
  const int64_t kv_off = int64_t(bh) * Sp * HD + part * 16;
  const int8_t* kb = kq + kv_off;
  const int8_t* vb = vq + kv_off;
  const float* ks = kscale + int64_t(bh) * Sp;
  const float* vs = vscale + int64_t(bh) * Sp;
  const float* bi = bias + int64_t(b) * Sp;

  // pass 1: scores and their max
  float mx = kMask;
  for (int base = 0; base < s_used; base += STEP) {
    int4 kr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * GROUPS + g;
      kr[u] = r < s_used ? *reinterpret_cast<const int4*>(kb + int64_t(r) * HD)
                         : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * GROUPS + g;
      float d = dot16(qf, kr[u]);
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (r < s_used) {
        const float s = d * (ks[r] * sm_scale) + bi[r];
        mx = fmaxf(mx, s);
        if (part == 0) scores[r] = s;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) m = fmaxf(m, red[w]);

  // pass 2: probabilities into the value sum
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  float l = 0.f;
  for (int base = 0; base < s_used; base += STEP) {
    int4 vr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * GROUPS + g;
      vr[u] = r < s_used ? *reinterpret_cast<const int4*>(vb + int64_t(r) * HD)
                         : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * GROUPS + g;
      if (r < s_used) {
        const float p = expf(scores[r] - m);
        l += p;
        const float pw = __bfloat162float(__float2bfloat16(p * vs[r]));
        const int8_t* e = reinterpret_cast<const int8_t*>(&vr[u]);
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] += pw * float(e[i]);
      }
    }
  }

  // combine the row streams
#pragma unroll
  for (int i = 0; i < 16; ++i) part_acc[g * HD + part * 16 + i] = acc[i];
  // every lane of a group holds the same l; count it once per group
  float lw = part == 0 ? l : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lw += __shfl_xor_sync(0xffffffffu, lw, off);
  __syncthreads();                     // red[] reads done, part_acc written
  if (lane == 0) red[warp] = lw;
  __syncthreads();
  for (int c = tid; c < HD; c += NTHREADS) {
    float s = 0.f;
    for (int gg = 0; gg < GROUPS; ++gg) s += part_acc[gg * HD + c];
    out[int64_t(bh) * HD + c] = s;
  }
  if (tid == 0) {
    float lt = 0.f;
    for (int w = 0; w < NWARPS; ++w) lt += red[w];
    m_out[bh] = m;
    l_out[bh] = lt;
  }
}

template <int HD>
size_t smem_bytes(int s_used) {
  constexpr int GROUPS = NWARPS * (32 / (HD / 16));
  return size_t(GROUPS) * HD * 4 + NWARPS * 4 + size_t(s_used) * 4;
}

template <int HD>
int launch(const void* q, const int8_t* kq, const float* ks, const int8_t* vq,
           const float* vs, const float* bias, float* out, float* m, float* l,
           int B, int H, int Sp, int s_used, float sm_scale,
           cudaStream_t stream) {
  static int configured = 0;
  const size_t smem = smem_bytes<HD>(s_used);
  if (smem > size_t(configured)) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attn_int8_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    configured = int(smem);
  }
  decode_attn_int8_kernel<HD><<<B * H, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), kq, ks, vq, vs, bias, out, m, l, H, Sp,
      s_used, sm_scale);
  return int(cudaGetLastError());
}

}  // namespace

// q: bf16 [B, H, hd]; kq, vq: int8 [B, H, Sp, hd]; ks, vs: f32 [B, H, Sp];
// bias: f32 [B, Sp]; out: f32 [B, H, hd]; m, l: f32 [B, H]; all contiguous.
// Reads positions [0, s_used).  Returns the cudaError_t of the launch.
extern "C" int opadpo_decode_attn_int8(const void* q, const void* kq,
                                       const void* ks, const void* vq,
                                       const void* vs, const void* bias,
                                       void* out, void* m, void* l, int B,
                                       int H, int Sp, int hd, int s_used,
                                       float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* k8 = static_cast<const int8_t*>(kq);
  const int8_t* v8 = static_cast<const int8_t*>(vq);
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  const float* bb = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  if (hd == 128)
    return launch<128>(q, k8, kss, v8, vss, bb, o, mm, ll, B, H, Sp, s_used,
                       sm_scale, st);
  if (hd == 64)
    return launch<64>(q, k8, kss, v8, vss, bb, o, mm, ll, B, H, Sp, s_used,
                      sm_scale, st);
  return int(cudaErrorInvalidValue);
}
