// Window-attention building blocks shared by the forward kernels (window_attention.cu)
// and the backward kernels (window_attention_bwd.cu), one 64-token window and one
// 32-channel head at a time: the register-resident core of K1, K2, K16, K17 and K5 (the
// qkv projection epilogue qkv_head_epilogue, the cosine norms of q and k on their
// fragments, the probabilities head_probs_mma, and the products of the forward and
// backward on register fragments), K1's weight ring (WeightStream, gemm_rows), which
// K4's projection/LayerNorm backward shares, and the launch of K16 (qkv_attention),
// which K4's launch sequence runs first.
#pragma once

#include "common.cuh"

namespace hs {

// ---------------------------------------------------------------------------------
// The register-resident per-head core of K1, K2, K16, K17 and K5.  One 64-token window
// and one 32-channel head on 4 warps, each owning 16 query rows.  Products are
// mma.sync.m16n8k16 bf16 -> f32 with operands read by ldmatrix from shared-memory tiles
// whose padded rows (LD_HEAD, LD_W) make every ldmatrix phase conflict-free; scores,
// probabilities and the head output never leave registers, and nothing inside the core
// waits on a block barrier.  Fragment layouts (PTX ISA, m16n8k16): with g = lane / 4 and
// c = lane % 4, an accumulator holds rows g and g + 8, columns 2c and 2c + 1 of its
// 16 x 8 tile; an A fragment holds rows g, g + 8 and columns 2c, 2c + 1, 2c + 8, 2c + 9
// of its 16 x 16 tile, so the accumulators of two neighbouring n-tiles, rounded to bf16,
// are the A fragment of the next product.  mma.sync, ldmatrix and cp.async are enough
// while these kernels are latency-bound; wgmma and TMA are the step after that.
// ---------------------------------------------------------------------------------

constexpr int QKV_MAX_C = 384;  // widest C of K1, K4, K16, K17 (64 x C x tiles on chip)
constexpr int LD_HEAD = HD + 8;  // 64 x 32 bf16 tiles: q, k, v, q_hat, k_hat, dout
constexpr int LD_P = WS + 8;     // 64 x 64 bf16 tiles: probabilities, ds
constexpr int kHeadNT = 3 * HD / 8;           // n-tiles (8 columns) of a head's q|k|v
constexpr int LD_BIAS = WS + 8;  // f32 bias rows: a quad's float2 reads conflict-free

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// A fragments of rows row0..row0+15 of a 64 x HD bf16 tile (ld LD_HEAD): qa[ks] covers
// channels 16 ks .. 16 ks + 15
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[2][4], const bf16* q, int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
    ldsm_x4(qa[ks], q + (row0 + (lane & 15)) * LD_HEAD + ks * 16 + (lane >> 4) * 8);
}

// cosine flavour on query fragments: q_hat = bf16(q * (scale / |q|)), the clamped sum of
// squares of each row over its quad; iq: 1 / |q| of rows g (half 0) and g + 8 (half 1)
__device__ __forceinline__ void cos_q_frags(uint32_t (&qa)[2][4], float scale, float (&iq)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {  // row g (registers 0, 2), row g + 8 (1, 3)
    float2 v[4];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = unpack_bf2(qa[i >> 1][(i & 1) * 2 + half]);
      ss += v[i].x * v[i].x + v[i].y * v[i].y;
    }
    iq[half] = rsqrtf(fmaxf(quad_sum(ss), 1e-24f));
    const float m = iq[half] * scale;
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[i >> 1][(i & 1) * 2 + half] = pack_bf2(v[i].x * m, v[i].y * m);
  }
}

// cosine flavour on the B fragments of 8 keys, as ldsm_x4 gives them from a raw k tile
// (register i: key lane / 4, channels 8 i + 2 (lane % 4), + 1): k_hat = bf16(k / |k|),
// the clamped sum of squares of each key over its quad.  Returns 1 / |k| of the lane's
// key.  K2's probabilities normalize k here, inside head_probs_mma, and K5 makes its
// k_hat tile here, so that K5's k_hat is K2's bit for bit.
__device__ __forceinline__ float cos_k_frag(uint32_t (&kb)[4]) {
  float2 kv[4];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    kv[i] = unpack_bf2(kb[i]);
    ss += kv[i].x * kv[i].x + kv[i].y * kv[i].y;
  }
  const float ik = rsqrtf(fmaxf(quad_sum(ss), 1e-24f));
#pragma unroll
  for (int i = 0; i < 4; ++i) kb[i] = pack_bf2(kv[i].x * ik, kv[i].y * ik);
  return ik;
}

// p = e / d in f32, the IEEE division, ahead of p's bf16 rounding.  The division's slow
// path, taken where the dividend is subnormal or the quotient near underflow (the
// masked keys: e ~ e^-100 +- the score spread), doubled the masked kernels' time, so
// the dividend is scaled by 2^64 and the quotient back by 2^-64: both exact, so p is
// the IEEE quotient wherever that is a normal f32.  Below 2^-126 (bf16 keeps at most 7
// bits there) the scaled quotient is rounded twice and may sit one f32 subnormal step
// from it.  d >= 1 (the row max's own term is exp(0) = 1), so where e <= 2^-134 the
// quotient rounds to bf16 zero either way (2^-134 itself is a tie, which goes to the
// even zero) and the division is skipped: this also keeps zero from its dividend.
__device__ __forceinline__ float norm_p(float e, float d) {
  const bool keep = e > 0x1p-134f;
  const float q = ((keep ? e : 1.f) * 0x1p64f) / d;
  return keep ? q * 0x1p-64f : 0.f;
}

// The projection epilogue of one head for this warp's 16 rows row0..row0+15: acc
// holds x Wqkv over the head's q|k|v columns (n-tiles 0-3 q, 4-7 k, 8-11 v; rows g, g + 8
// as every accumulator here).  Adds the qkv bias (bq: the head's q columns of bqkv, its k
// and v columns at + C and + 2 C) and rounds to bf16 in place, so that acc holds the qkv
// rows.  COS (cosine): iq, ik are the inverse norms of rows g and g + 8 of q and k (rsqrt
// of the quad-summed squares, clamped); q_hat = bf16(q (iq scale)) becomes the A
// fragments qa and k_hat = bf16(k ik) goes to the tile kt.  Scaled-dot: qa = q, kt = k
// (the core's mul then carries sm_scale), iq and ik untouched.  v goes to the tile vt.
// kt, vt: 64 x HD bf16 (ld LD_HEAD).  K1 and K16 (forward) and K17 (the backward's
// recomputation) share it, so the backward's q, k, v and P are the forward's bits.
template <bool COS>
__device__ __forceinline__ void qkv_head_epilogue(float (&acc)[kHeadNT][4],
                                                  const bf16* __restrict__ bq, int C,
                                                  float scale, uint32_t (&qa)[2][4], bf16* kt,
                                                  bf16* vt, int row0, float (&iq)[2],
                                                  float (&ik)[2]) {
  const int lane = threadIdx.x & 31;
  const int r0 = row0 + (lane >> 2), r1 = r0 + 8, c2 = (lane & 3) * 2;
  float sq0 = 0.f, sq1 = 0.f, sk0 = 0.f, sk1 = 0.f;
#pragma unroll
  for (int t = 0; t < kHeadNT; ++t) {
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bq + (t >> 2) * C + (t & 3) * 8 + c2));
    acc[t][0] = bfr(acc[t][0] + b.x);
    acc[t][1] = bfr(acc[t][1] + b.y);
    acc[t][2] = bfr(acc[t][2] + b.x);
    acc[t][3] = bfr(acc[t][3] + b.y);
    if constexpr (COS) {
      const float e0 = acc[t][0] * acc[t][0] + acc[t][1] * acc[t][1];
      const float e1 = acc[t][2] * acc[t][2] + acc[t][3] * acc[t][3];
      if (t < 4) {
        sq0 += e0;
        sq1 += e1;
      } else if (t < 8) {
        sk0 += e0;
        sk1 += e1;
      }
    }
  }
  float mq0 = 1.f, mq1 = 1.f, mk0 = 1.f, mk1 = 1.f;
  if constexpr (COS) {
    iq[0] = rsqrtf(fmaxf(quad_sum(sq0), 1e-24f));
    iq[1] = rsqrtf(fmaxf(quad_sum(sq1), 1e-24f));
    ik[0] = rsqrtf(fmaxf(quad_sum(sk0), 1e-24f));
    ik[1] = rsqrtf(fmaxf(quad_sum(sk1), 1e-24f));
    mq0 = iq[0] * scale;
    mq1 = iq[1] * scale;
    mk0 = ik[0];
    mk1 = ik[1];
  }
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    if constexpr (COS) {
      qa[ks][0] = pack_bf2(acc[2 * ks][0] * mq0, acc[2 * ks][1] * mq0);
      qa[ks][1] = pack_bf2(acc[2 * ks][2] * mq1, acc[2 * ks][3] * mq1);
      qa[ks][2] = pack_bf2(acc[2 * ks + 1][0] * mq0, acc[2 * ks + 1][1] * mq0);
      qa[ks][3] = pack_bf2(acc[2 * ks + 1][2] * mq1, acc[2 * ks + 1][3] * mq1);
    } else {
      qa[ks][0] = pack_bf2(acc[2 * ks][0], acc[2 * ks][1]);
      qa[ks][1] = pack_bf2(acc[2 * ks][2], acc[2 * ks][3]);
      qa[ks][2] = pack_bf2(acc[2 * ks + 1][0], acc[2 * ks + 1][1]);
      qa[ks][3] = pack_bf2(acc[2 * ks + 1][2], acc[2 * ks + 1][3]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int c = 8 * n + c2;
    if constexpr (COS) {
      *reinterpret_cast<uint32_t*>(kt + r0 * LD_HEAD + c) =
          pack_bf2(acc[4 + n][0] * mk0, acc[4 + n][1] * mk0);
      *reinterpret_cast<uint32_t*>(kt + r1 * LD_HEAD + c) =
          pack_bf2(acc[4 + n][2] * mk1, acc[4 + n][3] * mk1);
    } else {
      *reinterpret_cast<uint32_t*>(kt + r0 * LD_HEAD + c) = pack_bf2(acc[4 + n][0], acc[4 + n][1]);
      *reinterpret_cast<uint32_t*>(kt + r1 * LD_HEAD + c) = pack_bf2(acc[4 + n][2], acc[4 + n][3]);
    }
    *reinterpret_cast<uint32_t*>(vt + r0 * LD_HEAD + c) = pack_bf2(acc[8 + n][0], acc[8 + n][1]);
    *reinterpret_cast<uint32_t*>(vt + r1 * LD_HEAD + c) = pack_bf2(acc[8 + n][2], acc[8 + n][3]);
  }
}

// The probabilities of one head for this warp's 16 query rows: s = q k^T * mul + bias
// (+ MASK_VALUE where group ids differ); p = softmax_row(s) in f32 (row-max shift, sum
// floored at 1e-30, p = norm_p(e, d)), left in p as the score accumulators: p[j][0..1]
// row g, p[j][2..3] row g + 8, keys 8j + 2c, 8j + 2c + 1.  qa: A fragments of the
// (scaled) query rows row0..row0+15; k: a 64 x HD bf16 tile (ld LD_HEAD) in shared
// memory; bias_h: the head's 64 x 64 f32 bias, row stride ldb (shared or global memory);
// g: the window's group ids in shared memory, or nullptr unmasked.  COS_K: k is raw and
// is normalized here, k_hat = bf16(k / |k|), each warp for all 64 keys.
template <bool COS_K>
__device__ __forceinline__ void head_probs_mma(const uint32_t (&qa)[2][4], const bf16* k,
                                               const float* bias_h, int ldb, const int* g,
                                               int row0, float mul, float (&s)[8][4]) {
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, c2 = (lane & 3) * 2;
  const int r0 = row0 + gr, r1 = r0 + 8;

  // the bias first, so its loads overlap the score products
  float2 b0[8], b1[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    b0[j] = *reinterpret_cast<const float2*>(bias_h + r0 * ldb + 8 * j + c2);
    b1[j] = *reinterpret_cast<const float2*>(bias_h + r1 * ldb + 8 * j + c2);
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {  // keys 8j .. 8j + 7
    uint32_t kb[4];  // channels 0-7, 8-15 (k-step 0), 16-23, 24-31 (k-step 1)
    ldsm_x4(kb, k + (8 * j + (lane & 7)) * LD_HEAD + (lane >> 3) * 8);
    if constexpr (COS_K) cos_k_frag(kb);
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_bf16(s[j], qa[0], kb[0], kb[1]);
    mma_bf16(s[j], qa[1], kb[2], kb[3]);
  }

  // scores -> probabilities, in place; each row lives in one quad
  int g0 = 0, g1 = 0;
  if (g != nullptr) {
    g0 = g[r0];
    g1 = g[r1];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = s[j][0] * mul + b0[j].x;
    s[j][1] = s[j][1] * mul + b0[j].y;
    s[j][2] = s[j][2] * mul + b1[j].x;
    s[j][3] = s[j][3] * mul + b1[j].y;
    if (g != nullptr) {
      const int2 gc = *reinterpret_cast<const int2*>(g + 8 * j + c2);
      if (gc.x != g0) s[j][0] += MASK_VALUE;
      if (gc.y != g0) s[j][1] += MASK_VALUE;
      if (gc.x != g1) s[j][2] += MASK_VALUE;
      if (gc.y != g1) s[j][3] += MASK_VALUE;
    }
  }
  float m0 = fmaxf(s[0][0], s[0][1]), m1 = fmaxf(s[0][2], s[0][3]);
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
    m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = expf(s[j][0] - m0);
    s[j][1] = expf(s[j][1] - m0);
    s[j][2] = expf(s[j][2] - m1);
    s[j][3] = expf(s[j][3] - m1);
    d0 += s[j][0] + s[j][1];
    d1 += s[j][2] + s[j][3];
  }
  d0 = fmaxf(quad_sum(d0), 1e-30f);
  d1 = fmaxf(quad_sum(d1), 1e-30f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = norm_p(s[j][0], d0);
    s[j][1] = norm_p(s[j][1], d0);
    s[j][2] = norm_p(s[j][2], d1);
    s[j][3] = norm_p(s[j][3], d1);
  }
}

// the A fragment of keys 16 kc .. 16 kc + 15 of 16 x 64 accumulators (score n-tiles 2kc,
// 2kc + 1), rounded to bf16
__device__ __forceinline__ void acc_a_frag(uint32_t (&a)[4], const float (&s)[8][4], int kc) {
  a[0] = pack_bf2(s[2 * kc][0], s[2 * kc][1]);
  a[1] = pack_bf2(s[2 * kc][2], s[2 * kc][3]);
  a[2] = pack_bf2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
  a[3] = pack_bf2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
}

// o (16 x HD f32) = bf16(a) b over WS: a this warp's 16 x 64 f32 accumulators (as the
// scores), rounded to bf16 as A fragments; b a 64 x HD bf16 tile (ld LD_HEAD) in shared
// memory.  o[n][0..1] row g, o[n][2..3] row g + 8, channels 8n + 2c, 8n + 2c + 1.  The
// forward's o = P v, the backward's dS k.
__device__ __forceinline__ void acc_times_tile(const float (&a)[8][4], const bf16* b,
                                               float (&o)[4][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 4; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t pa[4];
    acc_a_frag(pa, a, kc);
#pragma unroll
    for (int np = 0; np < 2; ++np) {  // channel n-tiles 2np, 2np + 1
      uint32_t vb[4];
      ldsm_x4_t(vb, b + (16 * kc + (lane & 15)) * LD_HEAD + (2 * np + (lane >> 4)) * 8);
      mma_bf16(o[2 * np], pa, vb[0], vb[1]);
      mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
    }
  }
}

// One head of window attention for this warp's 16 query rows: head_probs_mma, then
// o = bf16(p) v, f32 in registers (as acc_times_tile).  v: a 64 x HD bf16 tile (ld
// LD_HEAD); the rest as head_probs_mma.
template <bool COS_K>
__device__ __forceinline__ void attend_head_mma(const uint32_t (&qa)[2][4], const bf16* k,
                                                const bf16* v, const float* bias_h, int ldb,
                                                const int* g, int row0, float mul,
                                                float (&o)[4][4]) {
  float p[8][4];
  head_probs_mma<COS_K>(qa, k, bias_h, ldb, g, row0, mul, p);
  acc_times_tile(p, v, o);
}

// s (16 x 64 f32) = a b^T over HD: a the A fragments of this warp's 16 rows (as
// load_q_frags gives them), b a 64 x HD bf16 tile (ld LD_HEAD): the backward's dP = dO v^T
__device__ __forceinline__ void frags_times_tile_t(const uint32_t (&a)[2][4], const bf16* b,
                                                   float (&s)[8][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t bb[4];
    ldsm_x4(bb, b + (8 * j + (lane & 7)) * LD_HEAD + (lane >> 3) * 8);
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_bf16(s[j], a[0], bb[0], bb[1]);
    mma_bf16(s[j], a[1], bb[2], bb[3]);
  }
}

// o (16 x HD f32) = a^T b over WS for rows m0..m0+15 of a^T: a a 64 x 64 bf16 tile (ld
// LD_P), read transposed by ldmatrix.trans; b a 64 x HD bf16 tile (ld LD_HEAD).  The
// backward's dV = P^T dO and dK = dS^T q.
__device__ __forceinline__ void tile_t_times_tile(const bf16* a, int m0, const bf16* b,
                                                  float (&o)[4][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 4; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    // matrix i = lane / 8 is rows 16 kc + 8 (i / 2) .., columns m0 + 8 (i % 2) .. of a
    uint32_t at[4];
    ldsm_x4_t(at, a + (16 * kc + (lane & 7) + ((lane >> 4) << 3)) * LD_P + m0 +
                      ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bb[4];
      ldsm_x4_t(bb, b + (16 * kc + (lane & 15)) * LD_HEAD + (2 * np + (lane >> 4)) * 8);
      mma_bf16(o[2 * np], at, bb[0], bb[1]);
      mma_bf16(o[2 * np + 1], at, bb[2], bb[3]);
    }
  }
}

// ---------------------------------------------------------------------------------
// K1's weight ring, which K4's projection/LayerNorm backward shares: u = o Wp from the
// same chunks in the same ascending 16-wide k-steps gives K1's u bit for bit.
// ---------------------------------------------------------------------------------
constexpr int KC = 32;                // weight rows per ring stage
constexpr int kStages = 3;            // ring depth of each core
constexpr int kMaxNT = kHeadNT;       // n-tiles (8 columns) of one product: q|k|v of a head
constexpr int LD_W = kMaxNT * 8 + 8;  // ring rows: ldmatrix.trans over 8 rows conflict-free

// The weight chunks one core consumes, in order: for each of its heads h (core, core +
// 2, ...) the head's q, k and v column strips of Wqkv (C x 96), then for each of its
// column blocks b of Wp (core, core + 2, ...; nt_p n-tiles each), each cut into nk =
// C / KC chunks of KC rows.  Chunk s lands in ring stage s % kStages.  WRAP > 0: a block
// that walks several windows streams its WRAP column blocks of Wp (and no heads) once
// per window, and total counts the chunks of every window.
template <int WRAP = 0>
struct WeightStream {
  const bf16* wqkv;
  const bf16* wp;
  bf16* ring;
  int C, core, n_head_jobs, nt_p, nk, total;

  __device__ __forceinline__ bf16* stage(int s) const {
    return ring + (s % kStages) * (KC * LD_W);
  }

  // chunk s's cp.async copies by the core's 128 threads (none past the end); the
  // caller commits
  __device__ __forceinline__ void fetch(int s, int gtid) const {
    if (s >= total) return;
    int job = s / nk;
    const int k0 = (s - job * nk) * KC;
    if constexpr (WRAP > 0) job %= WRAP;
    bf16* dst = stage(s);
    if (job < n_head_jobs) {
      const int h = core + 2 * job;
      for (int idx = gtid; idx < KC * kMaxNT; idx += kCoreThreads) {
        const int r = idx / kMaxNT, t = idx - r * kMaxNT;
        cp_async16(dst + r * LD_W + t * 8,
                   wqkv + size_t(k0 + r) * 3 * C + (t >> 2) * C + h * HD + (t & 3) * 8);
      }
    } else {
      const int col0 = (core + 2 * (job - n_head_jobs)) * nt_p * 8;
      for (int idx = gtid; idx < KC * nt_p; idx += kCoreThreads) {
        const int r = idx / nt_p, t = idx - r * nt_p;
        cp_async16(dst + r * LD_W + t * 8, wp + size_t(k0 + r) * C + col0 + t * 8);
      }
    }
  }
};

// acc (this warp's rows row0..row0+15 x nt n-tiles, f32) += a (rows of a 64 x C bf16
// tile in shared memory, ld lda) x the core's next nk weight chunks; s counts the
// chunks consumed.  One core barrier per chunk, kStages - 1 chunks in flight.
template <int WRAP>
__device__ __forceinline__ void gemm_rows(float (&acc)[kMaxNT][4], const bf16* a, int lda,
                                          int nt, const WeightStream<WRAP>& st, int& s,
                                          int gtid, int row0) {
  const int lane = threadIdx.x & 31;
  const bf16* arow = a + (row0 + (lane & 15)) * lda + (lane >> 4) * 8;
  for (int kc = 0; kc < st.nk; ++kc, ++s) {
    cp_async_wait<kStages - 2>();
    group_sync(1 + st.core);  // chunk s has landed; chunk s - 1's stage is free
    st.fetch(s + kStages - 1, gtid);
    cp_async_commit();
    const bf16* w = st.stage(s) + lane * LD_W;
    uint32_t a0[4], a1[4];
    ldsm_x4(a0, arow + kc * KC);
    ldsm_x4(a1, arow + kc * KC + 16);
#pragma unroll
    for (int t = 0; t < kMaxNT; ++t) {
      if (t < nt) {
        uint32_t b[4];
        ldsm_x4_t(b, w + t * 8);
        mma_bf16(acc[t], a0, b[0], b[1]);
        mma_bf16(acc[t], a1, b[2], b[3]);
      }
    }
  }
}

// K16 (qkv_epi_kernel<1, false, COS>, window_attention.cu): out (T x C bf16) = attention
// of x Wqkv + bqkv before the output projection.  K4's launch sequence runs its cosine
// flavour first: K1's head loop, so its o is K1's bit for bit.
cudaError_t qkv_attention(const bf16* x, const bf16* wqkv, const bf16* bqkv, const int* groups,
                          const float* bias, const float* lscale, bf16* out, int T, int C,
                          bool use_cos, int has_mask, float sm_scale, cudaStream_t stream);

}  // namespace hs
