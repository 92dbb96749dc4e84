// Decode attention over the quantized head-major prompt KV cache, for
// Hopper (sm_90a).  Three kernels share one body:
//
//   decode_attn_int8_kernel   one query per (b, h) over the int8 cache;
//                             replaces opadpo_tpu/ops/decode_attention.py
//                             _kernel (decode_attention_prompt);
//   decode_attn_int4_kernel   the same over the packed int4 cache; replaces
//                             _kernel4 (decode_attention_prompt4);
//   decode_attn_multi_kernel  G = 2..8 queries per (b, h) over the int8
//                             cache in one pass (speculative verify);
//                             replaces _kernel_multi
//                             (decode_attention_prompt_multi).
//
// The TPU kernels carried the softmax state (m, l) across a sequential grid
// axis over sequence blocks; Hopper's blocks run in no order, so here one
// CTA per (batch, head) walks the whole filled prefix [0, s_used) itself, in
// two passes:
//   1. scores: s = (q . K[s]) * (k_scale[s] * sm_scale) + bias[s], kept in
//      shared memory ([G][s_used] floats), and their max
//      m = max(-1e30, max_s s);
//   2. values: p = exp(s - m), l = sum p, out = sum bf16(p * v_scale[s]) *
//      V[s].
// The K scale is folded into the score and the V scale into p, as the TPU
// kernels do, and p * v_scale is rounded to bf16 there too.  m starts at
// -1e30 (not -inf), so a prompt that is masked everywhere comes out
// uniform, as in JAX.  The output is UNNORMALISED, with m and l beside it,
// because the caller merges it with the bf16 suffix by logsumexp.  The
// TPU kernels keep a running max per sequence block; normalising against
// the global max gives the same m, and (out / l, m + log l) that differ
// only by where p * v_scale was rounded to bf16.
//
// The int4 cache is packed group-local half-split (models/llama.py
// quantize_prompt_kv_int4): packed row r of a (b, h) holds position
// (r / 128) * 256 + r % 128 in its low nibble and that plus 128 in its
// high nibble.  A 16-byte load therefore carries 16 dims of two positions,
// unpacked by shifts (low ((p & 0xF) ^ 8) - 8, high p >> 4 on the
// sign-extended byte); scores, scales and the bias are indexed by the
// unpacked position, as for the int8 cache.
//
// What bounds them: they read s_used * hd bytes of K and of V per (b, h)
// (half that for int4) and 2 * s_used f32 scales, and do 4 * G flops per
// cache element, so they are bound by memory bandwidth; the multi-query
// kernel reads the cache ONCE for all G queries, which is the whole point
// of speculative verify.  K and V rows load as 16-byte vectors, hd/16 lanes
// per row, neighbouring lane groups on neighbouring rows, a few rows in
// flight per group; the G query fragments live in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_G = 8;
constexpr float kMask = -1e30f;

// the 16 values of one loaded vector: int8 codes, or one nibble half of
// 16 packed bytes (half 0 low, half 1 high)
template <bool PACKED>
__device__ __forceinline__ void unpack16(const int4& raw, int half,
                                         float* v) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int p = e[i];
    v[i] = PACKED ? float(half ? (p >> 4) : (((p & 0xF) ^ 8) - 8))
                  : float(p);
  }
}

// unpacked cache position of packed (or plain) row r, half j
template <bool PACKED>
__device__ __forceinline__ int position(int r, int j) {
  return PACKED ? (r >> 7) * 256 + (r & 127) + j * 128 : r;
}

// row streams in a CTA: hd/16 lanes per row, 32 lanes per warp
template <int HD>
__host__ __device__ constexpr int groups() {
  return NWARPS * (32 / (HD / 16));
}

template <int HD, int G, bool PACKED>
__device__ __forceinline__ void body(
    unsigned char* smem, const bf16* __restrict__ q,
    const int8_t* __restrict__ kq, const float* __restrict__ kscale,
    const int8_t* __restrict__ vq, const float* __restrict__ vscale,
    const float* __restrict__ bias, float* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int H, int Sp,
    int s_used, float sm_scale) {
  constexpr int LPR = HD / 16;          // lanes per row, 16 bytes each
  constexpr int RPW = 32 / LPR;         // rows per warp per load
  constexpr int GROUPS = groups<HD>();
  constexpr int UNROLL = G > 2 ? 2 : 4;
  constexpr int STEP = GROUPS * UNROLL;
  constexpr int NV = PACKED ? 2 : 1;    // positions per loaded row

  float* part_acc = reinterpret_cast<float*>(smem);   // [GROUPS][HD]
  float* red = part_acc + GROUPS * HD;                // [NWARPS][G]
  float* scores = red + NWARPS * G;                   // [G][s_used]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int part = lane % LPR;
  const int grp = warp * RPW + lane / LPR;
  const int rows = s_used / NV;         // loaded rows in use

  float qf[G][16];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const bf16* qrow = q + (int64_t(bh) * G + g) * HD + part * 16;
#pragma unroll
    for (int i = 0; i < 16; ++i) qf[g][i] = __bfloat162float(qrow[i]);
  }
  const int64_t kv_off = int64_t(bh) * (Sp / NV) * HD + part * 16;
  const int8_t* kb = kq + kv_off;
  const int8_t* vb = vq + kv_off;
  const float* ks = kscale + int64_t(bh) * Sp;
  const float* vs = vscale + int64_t(bh) * Sp;
  const float* bi = bias + int64_t(b) * Sp;

  // pass 1: scores and their max
  float mx[G];
#pragma unroll
  for (int g = 0; g < G; ++g) mx[g] = kMask;
  for (int base = 0; base < rows; base += STEP) {
    int4 kr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * GROUPS + grp;
      kr[u] = r < rows ? *reinterpret_cast<const int4*>(kb + int64_t(r) * HD)
                       : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * GROUPS + grp;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float kv[16];
        unpack16<PACKED>(kr[u], j, kv);
        float d[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < 16; ++i) s += qf[g][i] * kv[i];
          d[g] = s;
        }
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) {
#pragma unroll
          for (int g = 0; g < G; ++g)
            d[g] += __shfl_xor_sync(0xffffffffu, d[g], off);
        }
        if (r < rows) {
          const int pos = position<PACKED>(r, j);
          const float ksc = ks[pos] * sm_scale;
          const float bb = bi[pos];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float s = d[g] * ksc + bb;
            mx[g] = fmaxf(mx[g], s);
            if (part == 0) scores[g * s_used + pos] = s;
          }
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
    if (lane == 0) red[warp * G + g] = mx[g];
  }
  __syncthreads();                     // also: every score is written
  float m[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = red[g];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) m[g] = fmaxf(m[g], red[w * G + g]);
  }

  // pass 2: probabilities into the value sums
  float acc[G][16];
  float l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[g][i] = 0.f;
  }
  for (int base = 0; base < rows; base += STEP) {
    int4 vr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * GROUPS + grp;
      vr[u] = r < rows ? *reinterpret_cast<const int4*>(vb + int64_t(r) * HD)
                       : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base + u * GROUPS + grp;
      if (r < rows) {
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int pos = position<PACKED>(r, j);
          const float vsc = vs[pos];
          float vv[16];
          unpack16<PACKED>(vr[u], j, vv);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float p = expf(scores[g * s_used + pos] - m[g]);
            l[g] += p;
            const float pw = __bfloat162float(__float2bfloat16(p * vsc));
#pragma unroll
            for (int i = 0; i < 16; ++i) acc[g][i] += pw * vv[i];
          }
        }
      }
    }
  }

  // combine the row streams, one query at a time
#pragma unroll
  for (int g = 0; g < G; ++g) {
    // every lane of a row group holds the same l; count it once per group
    float lw = part == 0 ? l[g] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lw += __shfl_xor_sync(0xffffffffu, lw, off);
    __syncthreads();                   // red[] and part_acc reads are done
#pragma unroll
    for (int i = 0; i < 16; ++i)
      part_acc[grp * HD + part * 16 + i] = acc[g][i];
    if (lane == 0) red[warp] = lw;
    __syncthreads();
    const int64_t row = int64_t(bh) * G + g;
    for (int c = tid; c < HD; c += NTHREADS) {
      float s = 0.f;
      for (int gg = 0; gg < GROUPS; ++gg) s += part_acc[gg * HD + c];
      out[row * HD + c] = s;
    }
    if (tid == 0) {
      float lt = 0.f;
      for (int w = 0; w < NWARPS; ++w) lt += red[w];
      m_out[row] = m[g];
      l_out[row] = lt;
    }
  }
}

#define DECODE_ATTN_PARAMS                                                 \
  const bf16 *__restrict__ q, const int8_t *__restrict__ kq,               \
      const float *__restrict__ kscale, const int8_t *__restrict__ vq,     \
      const float *__restrict__ vscale, const float *__restrict__ bias,    \
      float *__restrict__ out, float *__restrict__ m_out,                  \
      float *__restrict__ l_out, int H, int Sp, int s_used, float sm_scale
#define DECODE_ATTN_ARGS                                                   \
  q, kq, kscale, vq, vscale, bias, out, m_out, l_out, H, Sp, s_used, sm_scale

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
decode_attn_int8_kernel(DECODE_ATTN_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem[];
  body<HD, 1, false>(smem, DECODE_ATTN_ARGS);
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
decode_attn_int4_kernel(DECODE_ATTN_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem[];
  body<HD, 1, true>(smem, DECODE_ATTN_ARGS);
}

template <int HD, int G>
__global__ void __launch_bounds__(NTHREADS)
decode_attn_multi_kernel(DECODE_ATTN_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem[];
  body<HD, G, false>(smem, DECODE_ATTN_ARGS);
}

typedef void (*KernelFn)(DECODE_ATTN_PARAMS);

template <int HD, int G, bool PACKED>
KernelFn kernel() {
  if constexpr (PACKED)
    return decode_attn_int4_kernel<HD>;
  else if constexpr (G == 1)
    return decode_attn_int8_kernel<HD>;
  else
    return decode_attn_multi_kernel<HD, G>;
}

template <int HD, int G>
size_t smem_bytes(int s_used) {
  return (size_t(groups<HD>()) * HD + NWARPS * G) * 4 +
         size_t(G) * s_used * 4;
}

template <int HD, int G, bool PACKED>
int launch(const bf16* q, const int8_t* kq, const float* ks,
           const int8_t* vq, const float* vs, const float* bias, float* out,
           float* m, float* l, int B, int H, int Sp, int s_used,
           float sm_scale, cudaStream_t stream) {
  static int configured = 0;
  const auto kern = kernel<HD, G, PACKED>();
  const size_t smem = smem_bytes<HD, G>(s_used);
  if (smem > size_t(configured)) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    configured = int(smem);
  }
  kern<<<B * H, NTHREADS, smem, stream>>>(q, kq, ks, vq, vs, bias, out, m,
                                           l, H, Sp, s_used, sm_scale);
  return int(cudaGetLastError());
}

template <int HD>
int launch_hd(int G, bool packed, const bf16* q, const int8_t* kq,
              const float* ks, const int8_t* vq, const float* vs,
              const float* bias, float* out, float* m, float* l, int B,
              int H, int Sp, int s_used, float sm_scale,
              cudaStream_t stream) {
#define DECODE_ATTN_LAUNCH(GG, PK)                                         \
  return launch<HD, GG, PK>(q, kq, ks, vq, vs, bias, out, m, l, B, H, Sp,  \
                            s_used, sm_scale, stream)
  if (packed) {
    if (G == 1) DECODE_ATTN_LAUNCH(1, true);
    return int(cudaErrorInvalidValue);
  }
  switch (G) {
    case 1: DECODE_ATTN_LAUNCH(1, false);
    case 2: DECODE_ATTN_LAUNCH(2, false);
    case 3: DECODE_ATTN_LAUNCH(3, false);
    case 4: DECODE_ATTN_LAUNCH(4, false);
    case 5: DECODE_ATTN_LAUNCH(5, false);
    case 6: DECODE_ATTN_LAUNCH(6, false);
    case 7: DECODE_ATTN_LAUNCH(7, false);
    case 8: DECODE_ATTN_LAUNCH(8, false);
  }
#undef DECODE_ATTN_LAUNCH
  return int(cudaErrorInvalidValue);
}

}  // namespace

// q: bf16 [B, H, G, hd]; kq, vq: int8 [B, H, Sp, hd], or with `packed`
// int4 pairs [B, H, Sp/2, hd]; ks, vs: f32 [B, H, Sp]; bias: f32 [B, Sp];
// out: f32 [B, H, G, hd]; m, l: f32 [B, H, G]; all contiguous.  Sp is the
// unpacked cache length.  Reads positions [0, s_used) (a multiple of 256
// when packed); G is 1..8, and 1 when packed; hd is 64 or 128.  Returns
// the cudaError_t of the launch.
extern "C" int opadpo_decode_attn(const void* q, const void* kq,
                                  const void* ks, const void* vq,
                                  const void* vs, const void* bias, void* out,
                                  void* m, void* l, int B, int H, int G,
                                  int Sp, int hd, int s_used, int packed,
                                  float sm_scale, void* stream) {
  if (G < 1 || G > MAX_G) return int(cudaErrorInvalidValue);
  const bf16* qq = static_cast<const bf16*>(q);
  const int8_t* k8 = static_cast<const int8_t*>(kq);
  const int8_t* v8 = static_cast<const int8_t*>(vq);
  const float* kss = static_cast<const float*>(ks);
  const float* vss = static_cast<const float*>(vs);
  const float* bb = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch_hd<128>(G, packed != 0, qq, k8, kss, v8, vss, bb, o, mm,
                          ll, B, H, Sp, s_used, sm_scale, st);
  if (hd == 64)
    return launch_hd<64>(G, packed != 0, qq, k8, kss, v8, vss, bb, o, mm, ll,
                         B, H, Sp, s_used, sm_scale, st);
  return int(cudaErrorInvalidValue);
}
