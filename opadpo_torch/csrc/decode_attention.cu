// Decode attention over the quantized head-major prompt KV cache, for
// Hopper (sm_90a).  One body, cluster_body<HD, G, PACKED>, in two kernels:
//
//   decode_attn_multi_kernel  G = 1..8 queries per (b, h) over the int8
//                             cache in one pass.  At G 1 it is #6, which
//                             replaces opadpo_tpu/ops/decode_attention.py
//                             _kernel (decode_attention_prompt); at G 1..8
//                             #8, which replaces _kernel_multi
//                             (decode_attention_prompt_multi, speculative
//                             verify);
//   decode_attn_int4_kernel   (#7) one query per (b, h) over the packed
//                             int4 cache; replaces _kernel4
//                             (decode_attention_prompt4).
//
// Each computes, per (b, h) and query, over the filled prefix [0, s_used):
//   s = (q . K[s]) * (k_scale[s] * sm_scale) + bias[s],
//   m = max(-1e30, max_s s),  p = exp(s - m),  l = sum p,
//   out = sum bf16(p * v_scale[s]) * V[s]   (UNNORMALISED),
// the K scale folded into the score and the V scale into p, as the TPU
// kernels do.  m starts at -1e30 (not -inf), so a prompt masked everywhere
// comes out uniform, as in JAX.  The caller merges (out, m, l) with the
// bf16 suffix by logsumexp.  The TPU kernels keep a running max per
// sequence block; normalising against the global max gives the same m,
// and (out / l, m + log l) that differ only by where p * v_scale was
// rounded to bf16.
//
// The int4 cache is packed group-local half-split (models/llama.py
// quantize_prompt_kv_int4): packed row r of a (b, h) holds position
// (r / 128) * 256 + r % 128 in its low nibble and that plus 128 in its
// high nibble; scores, scales and the bias are indexed by the unpacked
// position, as for the int8 cache.
//
// What bounds them: they read s_used * hd bytes of K and of V per (b, h)
// (half that for int4) and 2 * s_used f32 scales, and do 4 * G flops per
// cache element, so memory bandwidth; the CUDA cores' issue comes close
// behind, since every code is widened and multiplied there (the scores
// stay exact, below): about 3.5 instructions a code at G 1, 12 at G 8.
//
// The body: a cluster of N CTAs of 128 threads per (b, h), grid B * H *
// N, N <= 8, and the positions `per` each rank owns, both from
// ops/decode_attention.py decode_split: rank r owns [r * per, min(s_used,
// (r + 1) * per)), whole chunks of 128 cache rows (128 positions int8, a
// 256-position group int4).  The split keeps every CTA of a launch
// resident at once (a second wave of CTAs would add a whole CTA's time).
//  - Loads.  At entry one thread requests the rank's K scale, bias and V
//    scale slices by 1-D bulk copies on one mbarrier, and each warp its
//    32-row piece of the first K chunk into its own ring slot, on its own
//    barrier.  A warp requests its next piece (its piece of the next K
//    chunk, then of each V chunk) as soon as it has read the last, so
//    scoring starts when a warp's first K piece lands, every CTA's K
//    comes before its V, and a slice of any length streams through
//    16 KB.  (Requesting K and V of a chunk at once, or two slots a warp,
//    ran slower: with twice the shared memory a launch took two waves, and
//    K and V arrived interleaved.)
//  - Scores, on the CUDA cores: hd / 16 lanes a row, 16 dims each.  A lane
//    widens its codes without a convert instruction (int8: byte_perm into
//    2^23 + 128 + b, one subtract; int4: byte_perm into 2^23 + byte, an
//    AND-XOR of one nibble, one subtract, the high nibble as 16x its
//    value, scaled back exactly) and sums 16 products in sequence per
//    query.  A butterfly over the row's lanes scatters as it reduces, so
//    a lane ends with one position's score, summed in the order
//    ops/decode_attention.py _dots mirrors: a bf16 query times an integer
//    code is exact in f32, so the scores equal the plain version's bit for
//    bit.  Above 4 queries they run in two passes over the piece, and the
//    registers are capped (64 a thread at G 1, 128 above), without a
//    spill.
//  - The softmax merged in the cluster.  Each rank stores its slice max
//    per query into every rank's shared memory (distributed shared
//    memory); after a cluster barrier each holds the N maxima, so all use
//    the global m.  Each p = exp(s - m) is computed once, by one thread,
//    with l and bf16(p * v_scale), into the score's place.
//  - Values: hd / 8 lanes a row, 8 dims each, every query's sums in
//    registers; the row groups, then the warps, combine in a fixed order
//    into the rank's partial out [G][hd] and l, which each rank stores into
//    rank 0's inbox.  After a second cluster barrier rank 0 sums the N
//    partials in rank order and writes out, m and l.  So two launches are
//    bitwise equal, and only the f32 order of the value sums (and of l)
//    differs from one pass over the prefix.

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int MAX_G = 8;
constexpr float kMask = -1e30f;

// ---- the cluster body: a cluster of CTAs per (b, h) ----

#define CLUSTER_PARAMS                                                     \
  const bf16 *__restrict__ q, const int8_t *__restrict__ kq,               \
      const float *__restrict__ kscale, const int8_t *__restrict__ vq,     \
      const float *__restrict__ vscale, const float *__restrict__ bias,    \
      float *__restrict__ out, float *__restrict__ m_out,                  \
      float *__restrict__ l_out, int H, int Sp, int s_used, int per,       \
      float sm_scale
#define CLUSTER_ARGS                                                       \
  q, kq, kscale, vq, vscale, bias, out, m_out, l_out, H, Sp, s_used, per,  \
      sm_scale

constexpr int CT = 128;             // threads of a cluster CTA
constexpr int CWARPS = CT / 32;
constexpr int CROWS = 128;          // cache rows of a chunk
constexpr int PROWS = CROWS / CWARPS;  // rows of a warp's piece of a chunk
constexpr int MAX_RANKS = 8;        // the portable cluster size
constexpr uint32_t FULL = 0xffffffffu;

// four int8 codes -> exact f32: byte_perm puts b + 128 in the mantissa of
// 2^23 + 128 + b, one subtract leaves b
__device__ __forceinline__ void widen_i8x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j)) -
           8388736.f;
}

// four packed bytes -> their low nibbles (lo) and 16x their high nibbles
// (hi), exact: byte_perm puts the byte in the mantissa of 2^23, an AND-XOR
// keeps one nibble with its sign bit flipped (n + 8), one subtract
__device__ __forceinline__ void widen_i4x4(uint32_t w, float* lo,
                                           float* hi) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t t = __byte_perm(w, 0x4B000000u, 0x7540u | j);
    lo[j] = __uint_as_float((t & 0x4B00000Fu) ^ 0x8u) - 8388616.f;
    hi[j] = __uint_as_float((t & 0x4B0000F0u) ^ 0x80u) - 8388736.f;
  }
}

// 16 products in sequence, as _dots sums a 16-wide part
__device__ __forceinline__ float dot16(const float (&q)[16], const float* v) {
  float s = __fmul_rn(q[0], v[0]);
#pragma unroll
  for (int i = 1; i < 16; ++i) s = __fmaf_rn(q[i], v[i], s);
  return s;
}

// byte offsets in a cluster CTA's shared memory: the ring (a slot of PROWS
// rows x HD bytes a warp; after the values it holds the warps' partial
// sums [CWARPS][G][HD]), the K scale, V scale and
// bias slices and the scores [G][per] (f32), the queries [G][HD] f32, the
// warps' maxima or l [CWARPS][G], every rank's max [MAX_RANKS][G], the
// inbox of every rank's partial out [G][HD] and l [G] (rank 0's is read),
// and the barriers (the slices', then each warp's slot's)
struct CLayout {
  int ks, vs, bi, sc, qs, red, xmax, inbox, bar, bytes;
};

__host__ __device__ inline int inbox_row(int hd, int g) {
  return g * hd + 8;                // floats: out [G][HD], l [G], padding
}

__host__ __device__ inline CLayout clayout(int hd, int g, int per,
                                           int nranks) {
  CLayout L;
  L.ks = CWARPS * PROWS * hd;
  L.vs = L.ks + per * 4;
  L.bi = L.vs + per * 4;
  L.sc = L.bi + per * 4;
  L.qs = L.sc + g * per * 4;
  L.red = L.qs + g * hd * 4;
  L.xmax = L.red + CWARPS * MAX_G * 4;
  L.inbox = L.xmax + MAX_RANKS * MAX_G * 4;
  L.bar = L.inbox + nranks * inbox_row(hd, g) * 4;
  L.bytes = L.bar + (1 + CWARPS) * 8;
  return L;
}

// positions a reduction batch takes for GQ queries: the lanes' partials of
// a batch fit 16 registers (at least one packed row's two positions)
template <int LPR, int NV, int GQ>
__host__ __device__ constexpr int batch_positions() {
  int n = LPR;
  while (n > NV && n * GQ > 16) n /= 2;
  return n;
}

// the lanes' partials x[j][g] of the positions j of a batch, reduced over
// the row's lanes: at offset O each lane keeps half of its N values (the
// upper half where bit O of `part` is set) and adds its partner's partials
// of that half; once one value is left, it adds its partner's.  So the
// 16-wide parts combine pairwise as _dots halves them.
template <int O, int N, int NPB, int GQ>
__device__ __forceinline__ void scatter_reduce(float (&x)[NPB][GQ],
                                               int part) {
  if constexpr (O > 0) {
    const bool up = (part & O) != 0;
    if constexpr (N > 1) {
      constexpr int M = N / 2;
#pragma unroll
      for (int j = 0; j < M; ++j)
#pragma unroll
        for (int g = 0; g < GQ; ++g) {
          const float send = up ? x[j][g] : x[j + M][g];
          const float keep = up ? x[j + M][g] : x[j][g];
          x[j][g] = keep + __shfl_xor_sync(FULL, send, O);
        }
      scatter_reduce<O / 2, M, NPB, GQ>(x, part);
    } else {
#pragma unroll
      for (int g = 0; g < GQ; ++g)
        x[0][g] += __shfl_xor_sync(FULL, x[0][g], O);
      scatter_reduce<O / 2, 1, NPB, GQ>(x, part);
    }
  }
}

// the scores of a warp's piece (PROWS rows of a chunk, from row `row0`)
// for queries G0 .. G0 + GQ - 1.  Each row group (hd / 16 lanes, `part`
// the lane's 16 dims) takes NPB positions a batch; after scatter_reduce
// the lanes of index `part / (LPR / NPB)` hold the batch's position of
// that index
template <int HD, int G, bool PACKED, int G0, int GQ>
__device__ __forceinline__ void score_queries(
    const unsigned char* st, const float* qs, const float* ks,
    const float* bi, float* sc, int per, int cbase, int row0,
    float sm_scale, float (&mx)[G], int rgw, int part) {
  constexpr int LPR = HD / 16;                  // lanes a row
  constexpr int NV = PACKED ? 2 : 1;            // positions a row
  constexpr int RGW = 32 / LPR;                 // row groups a warp
  constexpr int NPB = batch_positions<LPR, NV, GQ>();
  constexpr int RB = NPB / NV;                  // rows a batch
  constexpr int NB = PROWS / RGW / RB;          // batches a piece
  constexpr int SPAN = LPR / NPB;               // lanes holding a position
  float qf[GQ][16];
#pragma unroll
  for (int g = 0; g < GQ; ++g)
#pragma unroll
    for (int i = 0; i < 16; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(
          qs + (G0 + g) * HD + part * 16 + i);
      qf[g][i] = v.x, qf[g][i + 1] = v.y, qf[g][i + 2] = v.z,
      qf[g][i + 3] = v.w;
    }
#pragma unroll
  for (int bt = 0; bt < NB; ++bt) {
    // batch row k of row group rgw: neighbouring groups on neighbouring
    // rows, so a quarter warp reads 128 contiguous bytes
    float x[NPB][GQ];
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int r = (bt * RB + k) * RGW + rgw;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(st + r * HD + part * 16);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      if constexpr (PACKED) {
        float lo[16], hi[16];
#pragma unroll
        for (int j = 0; j < 4; ++j) widen_i4x4(w[j], lo + 4 * j, hi + 4 * j);
#pragma unroll
        for (int g = 0; g < GQ; ++g) {
          x[2 * k][g] = dot16(qf[g], lo);
          x[2 * k + 1][g] = dot16(qf[g], hi);
        }
      } else {
        float v[16];
#pragma unroll
        for (int j = 0; j < 4; ++j) widen_i8x4(w[j], v + 4 * j);
#pragma unroll
        for (int g = 0; g < GQ; ++g) x[k][g] = dot16(qf[g], v);
      }
    }
    scatter_reduce<LPR / 2, NPB, NPB, GQ>(x, part);
    const int j = part / SPAN;
    const int half = j % NV;
    const int pos =
        cbase + row0 + (bt * RB + j / NV) * RGW + rgw + half * 128;
    const float ksc = __fmul_rn(ks[pos], sm_scale);
    const float bb = bi[pos];
    const float unit = half ? 0.0625f : 1.f;  // the high nibble's 16x
#pragma unroll
    for (int g = 0; g < GQ; ++g) {
      const float s = __fadd_rn(__fmul_rn(x[0][g] * unit, ksc), bb);
      if (part % SPAN == 0) sc[(G0 + g) * per + pos] = s;
      mx[G0 + g] = fmaxf(mx[G0 + g], s);
    }
  }
}

template <int HD, int G, bool PACKED>
__device__ __forceinline__ void score_piece(
    const unsigned char* st, const float* qs, const float* ks,
    const float* bi, float* sc, int per, int cbase, int row0,
    float sm_scale, float (&mx)[G], int rgw, int part) {
  if constexpr (G <= 4) {
    score_queries<HD, G, PACKED, 0, G>(st, qs, ks, bi, sc, per, cbase, row0,
                                       sm_scale, mx, rgw, part);
  } else {  // two passes over the piece keep the query registers in bounds
    constexpr int G1 = (G + 1) / 2;
    score_queries<HD, G, PACKED, 0, G1>(st, qs, ks, bi, sc, per, cbase,
                                        row0, sm_scale, mx, rgw, part);
    score_queries<HD, G, PACKED, G1, G - G1>(st, qs, ks, bi, sc, per, cbase,
                                             row0, sm_scale, mx, rgw, part);
  }
}

// a warp's piece of V into the value sums: row group rgw2 (hd / 8 lanes,
// `part2` the lane's 8 dims) takes rows rgw2, rgw2 + RGW2, ...; `w` holds
// bf16(p * v_scale) per (query, position), the high nibbles' weights
// already divided by 16
template <int HD, int G, bool PACKED>
__device__ __forceinline__ void value_piece(const unsigned char* st,
                                            const float* w, int per,
                                            int cbase, int row0,
                                            float (&acc)[G][8], int rgw2,
                                            int part2) {
  constexpr int RGW2 = 32 / (HD / 8);
#pragma unroll 4
  for (int k = 0; k < PROWS / RGW2; ++k) {
    const int r = k * RGW2 + rgw2;
    const uint2 raw =
        *reinterpret_cast<const uint2*>(st + r * HD + part2 * 8);
    const int p0 = cbase + row0 + r;
    if constexpr (PACKED) {
      float lo[8], hi[8];
      widen_i4x4(raw.x, lo, hi);
      widen_i4x4(raw.y, lo + 4, hi + 4);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float w0 = w[g * per + p0], w1 = w[g * per + p0 + 128];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = __fmaf_rn(w0, lo[i], acc[g][i]);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = __fmaf_rn(w1, hi[i], acc[g][i]);
      }
    } else {
      float v[8];
      widen_i8x4(raw.x, v);
      widen_i8x4(raw.y, v + 4);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float wg = w[g * per + p0];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = __fmaf_rn(wg, v[i], acc[g][i]);
      }
    }
  }
}

template <int HD, int G, bool PACKED>
__device__ __forceinline__ void cluster_body(unsigned char* smem,
                                             CLUSTER_PARAMS) {
  constexpr int NV = PACKED ? 2 : 1;
  constexpr int CPOS = CROWS * NV;      // positions of a chunk
  constexpr int PIECE = PROWS * HD;     // bytes of a warp's piece
  const int nr = int(hopper::cluster_size());
  const CLayout L = clayout(HD, G, per, nr);
  float* ks = reinterpret_cast<float*>(smem + L.ks);
  float* vs = reinterpret_cast<float*>(smem + L.vs);
  float* bi = reinterpret_cast<float*>(smem + L.bi);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* xmax = reinterpret_cast<float*>(smem + L.xmax);
  float* inbox = reinterpret_cast<float*>(smem + L.inbox);
  const uint32_t base = hopper::smem_u32(smem);
  const uint32_t vec_bar = base + L.bar;

  const int rank = int(hopper::cluster_rank());
  const int bh = blockIdx.x / nr;
  const int b = bh / H;
  const int lo = rank * per;
  const int len = min(per, s_used - lo);      // positions of this rank
  const int nch = len / CPOS;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // this warp's stream: its piece of K chunk 0 .. nch - 1, then of V chunk
  // 0 .. nch - 1, through its ring slot: each load is requested once the
  // warp has read the one before it
  const int8_t* kg = kq + (int64_t(bh) * (Sp / NV) + lo / NV) * HD +
                     warp * PIECE;
  const int8_t* vg = vq + (int64_t(bh) * (Sp / NV) + lo / NV) * HD +
                     warp * PIECE;
  const int nload = 2 * nch;
  unsigned char* slot = smem + warp * PIECE;
  const uint32_t bar = base + L.bar + 8 * (1 + warp);
  auto issue = [&](int i) {               // lane 0: load i of the stream
    const int8_t* src = i < nch ? kg + int64_t(i) * CROWS * HD
                                : vg + int64_t(i - nch) * CROWS * HD;
    hopper::mbar_expect_tx(bar, PIECE);
    hopper::bulk_load(hopper::smem_u32(slot), src, PIECE, bar);
  };
  auto piece = [&](int i) {               // wait for load i; its bytes
    hopper::mbar_wait(bar, i & 1);
    return slot;
  };
  auto release = [&](int i) {             // load i read: request the next
    __syncwarp();
    if (lane == 0 && i + 1 < nload) issue(i + 1);
  };

  if (tid == 0) {
    hopper::mbar_init(vec_bar, 1);
    for (int w = 0; w < CWARPS; ++w)
      hopper::mbar_init(base + L.bar + 8 * (1 + w), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t vb = uint32_t(len) * 4;
    hopper::mbar_expect_tx(vec_bar, 3 * vb);
    hopper::bulk_load(base + L.ks, kscale + int64_t(bh) * Sp + lo, vb,
                      vec_bar);
    hopper::bulk_load(base + L.bi, bias + int64_t(b) * Sp + lo, vb, vec_bar);
    hopper::bulk_load(base + L.vs, vscale + int64_t(bh) * Sp + lo, vb,
                      vec_bar);
  }
  if (lane == 0) issue(0);
  hopper::cluster_arrive_relaxed();    // this CTA has started
  for (int i = tid; i < G * HD; i += CT)
    qs[i] = __bfloat162float(q[int64_t(bh) * G * HD + i]);
  __syncthreads();

  // scores and this rank's max: each warp its piece of every K chunk
  constexpr int LPR = HD / 16;
  const int part = lane % LPR;
  const int rgw = lane / LPR;
  float mx[G];
#pragma unroll
  for (int g = 0; g < G; ++g) mx[g] = kMask;
  hopper::mbar_wait(vec_bar, 0);
  for (int c = 0; c < nch; ++c) {
    score_piece<HD, G, PACKED>(piece(c), qs, ks, bi, sc, per, c * CPOS,
                               warp * PROWS, sm_scale, mx, rgw, part);
    release(c);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float v = mx[g];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
    if (lane == 0) red[warp * G + g] = v;
  }
  __syncthreads();                     // also: every score is written
  hopper::cluster_wait();              // every CTA of the cluster started
  if (tid < G * nr) {                  // this rank's max to every rank
    const int g = tid % G;
    float v = red[g];
    for (int w = 1; w < CWARPS; ++w) v = fmaxf(v, red[w * G + g]);
    hopper::st_cluster(hopper::cluster_addr(xmax + rank * G + g, tid / G),
                       v);
  }
  hopper::cluster_arrive();
  hopper::cluster_wait();              // 1: every rank's max is here
  float m[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kMask;
    for (int r = 0; r < nr; ++r) m[g] = fmaxf(m[g], xmax[r * G + g]);
  }

  // each p once: l, and bf16(p * v_scale) in the score's place
  float lsum[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float lg = 0.f;
    for (int i = tid; i < len; i += CT) {
      const float p = expf(sc[g * per + i] - m[g]);
      lg += p;
      float w = __bfloat162float(__float2bfloat16(p * vs[i]));
      if (PACKED && (i & 128)) w *= 0.0625f;  // the high nibbles' 16x
      sc[g * per + i] = w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lg += __shfl_xor_sync(FULL, lg, off);
    lsum[g] = lg;
  }
  __syncthreads();                     // every weight is written, red read
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < G; ++g) red[warp * G + g] = lsum[g];

  // values: each warp its piece of every V chunk
  constexpr int LPR2 = HD / 8;
  const int part2 = lane % LPR2;
  const int rgw2 = lane / LPR2;
  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  for (int c = 0; c < nch; ++c) {
    value_piece<HD, G, PACKED>(piece(nch + c), sc, per, c * CPOS,
                               warp * PROWS, acc, rgw2, part2);
    release(nch + c);
  }
  // the row groups of a warp, then the warps, in a fixed order, into
  // rank 0's inbox
#pragma unroll
  for (int o = LPR2; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[g][i] += __shfl_xor_sync(FULL, acc[g][i], o);
  float* wp = reinterpret_cast<float*>(smem);  // the ring, every piece read
  __syncthreads();
  if (lane < LPR2) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float* d = wp + (warp * G + g) * HD + part2 * 8;
      *reinterpret_cast<float4*>(d) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      *reinterpret_cast<float4*>(d + 4) =
          make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
  }
  __syncthreads();
  float* mine = inbox + rank * inbox_row(HD, G);
  for (int e = tid * 4; e < G * HD; e += CT * 4) {
    float4 v = *reinterpret_cast<const float4*>(wp + e);
    for (int w = 1; w < CWARPS; ++w) {
      const float4 u = *reinterpret_cast<const float4*>(wp + w * G * HD + e);
      v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
    }
    hopper::st_cluster4(hopper::cluster_addr(mine + e, 0), v);
  }
  if (tid < G) {
    float v = red[tid];
    for (int w = 1; w < CWARPS; ++w) v += red[w * G + tid];
    hopper::st_cluster(hopper::cluster_addr(mine + G * HD + tid, 0), v);
  }
  hopper::cluster_arrive();
  hopper::cluster_wait();              // 2: every rank's partials are here
  if (rank == 0) {
    const int row = inbox_row(HD, G);
    for (int e = tid * 4; e < G * HD; e += CT * 4) {
      float4 v = *reinterpret_cast<const float4*>(inbox + e);
      for (int r = 1; r < nr; ++r) {
        const float4 u =
            *reinterpret_cast<const float4*>(inbox + r * row + e);
        v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
      }
      *reinterpret_cast<float4*>(out + int64_t(bh) * G * HD + e) = v;
    }
    if (tid < G) {
      float lt = inbox[G * HD + tid], mg = kMask;
      for (int r = 1; r < nr; ++r) lt += inbox[r * row + G * HD + tid];
      for (int r = 0; r < nr; ++r) mg = fmaxf(mg, xmax[r * G + tid]);
      m_out[int64_t(bh) * G + tid] = mg;
      l_out[int64_t(bh) * G + tid] = lt;
    }
  }
}

// registers: at most 64 a thread at G 1 (8 CTAs an SM), 128 above (4)
template <int HD>
__global__ void __launch_bounds__(CT, 8)
decode_attn_int4_kernel(CLUSTER_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem[];
  cluster_body<HD, 1, true>(smem, CLUSTER_ARGS);
}

template <int HD, int G>
__global__ void __launch_bounds__(CT, G == 1 ? 8 : 4)
decode_attn_multi_kernel(CLUSTER_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem[];
  cluster_body<HD, G, false>(smem, CLUSTER_ARGS);
}

// ---- launchers ----

template <int HD, int G, bool PACKED>
int launch_cluster(const bf16* q, const int8_t* kq, const float* ks,
                   const int8_t* vq, const float* vs, const float* bias,
                   float* out, float* m, float* l, int B, int H, int Sp,
                   int s_used, int nranks, int per,
                   float sm_scale, cudaStream_t stream) {
  void (*kern)(CLUSTER_PARAMS);
  if constexpr (PACKED)
    kern = decode_attn_int4_kernel<HD>;
  else
    kern = decode_attn_multi_kernel<HD, G>;
  static int configured = 0;
  const int smem = clayout(HD, G, per, nranks).bytes;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    configured = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H * nranks);
  cfg.blockDim = dim3(CT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kern, q, kq, ks, vq, vs, bias, out, m, l, H,
                         Sp, s_used, per, sm_scale);
  return int(e != cudaSuccess ? e : cudaGetLastError());
}

template <int HD>
int launch_hd(int kind, int G, const bf16* q, const int8_t* kq,
              const float* ks, const int8_t* vq, const float* vs,
              const float* bias, float* out, float* m, float* l, int B,
              int H, int Sp, int s_used, int nranks, int per,
              float sm_scale, cudaStream_t stream) {
#define DECODE_ATTN_LAUNCH(GG, PK)                                         \
  return launch_cluster<HD, GG, PK>(q, kq, ks, vq, vs, bias, out, m, l, B, \
                                    H, Sp, s_used, nranks, per,            \
                                    sm_scale, stream)
  if (kind != 2 && G != 1) return int(cudaErrorInvalidValue);
  if (kind == 1) DECODE_ATTN_LAUNCH(1, true);
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

// q: bf16 [B, H, G, hd]; kq, vq: int8 [B, H, Sp, hd], or for #7 int4
// pairs [B, H, Sp/2, hd]; ks, vs: f32 [B, H, Sp]; bias: f32 [B, Sp]; out:
// f32 [B, H, G, hd]; m, l: f32 [B, H, G]; all contiguous, 16-byte
// aligned.  Sp is the unpacked cache length, a multiple of 4 (16-byte rows
// of scales and bias).  kind 0 is #6 (G 1), 1 is #7 (G 1, s_used a
// multiple of 256), 2 is #8 (G 1..8); 0 and 2 run the same kernel, and
// s_used is a multiple of 128 for them; hd is 64 or 128.  The cluster
// split comes from ops/decode_attention.py decode_split: `nranks` CTAs of
// `per` positions (the last may hold fewer).  Returns the cudaError_t of
// the launch.
extern "C" int opadpo_decode_attn(const void* q, const void* kq,
                                  const void* ks, const void* vq,
                                  const void* vs, const void* bias, void* out,
                                  void* m, void* l, int B, int H, int G,
                                  int Sp, int hd, int s_used, int kind,
                                  int nranks, int per,
                                  float sm_scale, void* stream) {
  if (G < 1 || G > MAX_G || kind < 0 || kind > 2 || s_used > Sp)
    return int(cudaErrorInvalidValue);
  const int unit = kind == 1 ? 2 * CROWS : CROWS;
  if (nranks < 1 || nranks > MAX_RANKS || per < unit || per % unit ||
      Sp % 4 || (nranks - 1) * per >= s_used || nranks * per < s_used ||
      s_used % unit || clayout(hd, G, per, nranks).bytes > 232448)
    return int(cudaErrorInvalidValue);
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
    return launch_hd<128>(kind, G, qq, k8, kss, v8, vss, bb, o, mm, ll, B, H,
                          Sp, s_used, nranks, per, sm_scale, st);
  if (hd == 64)
    return launch_hd<64>(kind, G, qq, k8, kss, v8, vss, bb, o, mm, ll, B, H,
                         Sp, s_used, nranks, per, sm_scale, st);
  return int(cudaErrorInvalidValue);
}

// dynamic shared memory of a decode launch
extern "C" int opadpo_decode_attn_smem_bytes(int hd, int G, int per,
                                             int nranks) {
  return clayout(hd, G, per, nranks).bytes;
}
