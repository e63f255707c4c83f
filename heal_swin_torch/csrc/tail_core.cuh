// The register-resident row core of the decoder tail: K3 (tail_pred_kernel), K6
// (tail_loss_kernel) and the row kernel of K7's launch sequence (tail_bwd_kernel), K8
// (tail_depth_kernel) and the row kernel of K9's launch sequence (tail_depth_bwd_kernel),
// csrc/final_head.cu.
//
// A block walks 128-row tiles of the tokens; a warp owns 16 rows of a tile.  For each of
// the p expand slices We_i (C x C, resident in shared memory for the block's whole walk):
// h = x We_i on mma.sync m16n8k16 from ldmatrix fragments, in ascending 16-wide k-steps
// from zero sums (mlp_core.cuh hidden_tile, its bias off), rounded to bf16 on the
// accumulators; the LayerNorm statistics over each row's quad (ln_rows, its bias off)
// with explicitly rounded operations; xhat in place; z = bf16(xhat gamma + beta),
// repacked 32 columns at a time as A fragments (pack_a_frags) and multiplied into the
// head Wh (C x 8 NF bf16, zero-padded from F to 8 NF columns) by mma: the logits, 16 x 8
// NF f32 accumulators, each row in one quad, 2 NF values a lane.  Every kernel makes h,
// z and the logits only through these functions on the same fragments, so K7's
// recomputed logits are K6's bits, K9's are K8's, and K3's f32 logits rounded to bf16 are
// K6's (an mma depends only on its fragments and its accumulator).  No (rows x C) tile of
// f32 goes through shared memory, and no loop over C runs on the CUDA cores.  The
// segmentation loss kernels round the logits to bf16 for the cross entropy
// (tail_softmax); K3 takes the argmax of the f32 logits, not rounded (tail_argmax); the
// depth kernels keep them f32 and take the masked depth loss of columns 0 and 1 (mean,
// logvar), which sit in the quad's lane with c2 = 0 (tail_depth, depth_dlogits).
//
// Heads above 32 classes run in chunks of 32 (NF 4): chunk ch is tail_logits on Wh's
// columns 32 ch .. 32 ch + 31, so a chunk's logits depend on the same fragments in every
// kernel (a column's sum does not depend on its neighbours).  The cross entropy walks the
// chunks once with a running max, a sum of exp(logit - max) rescaled where the max grows,
// the lowest column at the max and the target's logit (tail_chunk_stats), then merges the
// quad's lanes; K3 takes the running argmax of the f32 logits (tail_chunk_argmax); K7
// remakes each chunk's logits for its dlogits (tail_chunk_dlogits).
#pragma once

#include <math_constants.h>

#include "depth_loss.cuh"
#include "mlp_core.cuh"

namespace hs {

constexpr int TAIL_ROWS = 16 * kWarps;  // token rows of a block tile: a warp holds 16

// u (16 rows x 8 NT columns, NT = C / 8) = xhat of bf16(x We_i): x the warp's rows from
// row0 of the tile xs (ld ldx), wei the slice (C x C, ld C + 8).  Returns the rows'
// statistics (the LayerNorm backward needs rstd).
template <int NT>
__device__ __forceinline__ LnRows tail_xhat(float (&u)[NT][4], const bf16* xs, int ldx,
                                            int row0, const bf16* wei, int C, float eps) {
  hidden_tile<NT, false>(u, xs, ldx, row0, wei, C + 8, C, nullptr);
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) u[t][e] = bfr(u[t][e]);
  const LnRows r = ln_rows<NT, false>(u, NT, 0, nullptr, C, eps, nullptr, 1, 0);
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) u[t][e] = ln_xhat(u[t][e], r, e >> 1);
  return r;
}

// lf (16 x 8 NF f32) = z Wh with z = bf16(xhat gamma + beta) of the warp's rows, made 32
// columns at a time; whs: Wh (C x 8 NF bf16, ld ldwh).  zs: where not null, the warp's
// 16 rows of z are stored there too (bf16, ld ldz).
template <int NT, int NF>
__device__ __forceinline__ void tail_logits(float (&lf)[NF][4], const float (&xh)[NT][4],
                                            const float* __restrict__ gamma,
                                            const float* __restrict__ beta, const bf16* whs,
                                            int ldwh, bf16* zs, int ldz) {
  static_assert(NT % 4 == 0 && NF % 2 == 0, "32-column chunks, 16-column head tiles");
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < NF; ++n) lf[n][0] = lf[n][1] = lf[n][2] = lf[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NT / 4; ++j) {
    float z[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = 32 * j + 8 * t + c2;
      const float g0 = gamma[c], g1 = gamma[c + 1], b0 = beta[c], b1 = beta[c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        z[t][2 * h] = __fadd_rn(__fmul_rn(xh[4 * j + t][2 * h], g0), b0);
        z[t][2 * h + 1] = __fadd_rn(__fmul_rn(xh[4 * j + t][2 * h + 1], g1), b1);
        if (zs != nullptr)
          *reinterpret_cast<uint32_t*>(zs + (g + 8 * h) * ldz + c) =
              pack_bf2(z[t][2 * h], z[t][2 * h + 1]);
      }
    }
    uint32_t a[2][4];
    pack_a_frags(a, z);
    frags_times_rows<NF>(lf, a, whs + 32 * j * ldwh, ldwh, NF);
  }
}

struct CeRows {  // this lane's rows g and g + 8: the max logit (NaN where a logit is NaN)
  float mx[2], se[2];  // and the sum of exp(logit - max)
};

// the softmax of each row: lf -> the logits rounded to bf16 (-inf at columns >= F), ex =
// exp(lf - max) (0 at columns >= F); sums over the lane's columns, then its quad
template <int NF>
__device__ __forceinline__ CeRows tail_softmax(float (&lf)[NF][4], float (&ex)[NF][4], int F) {
  const int c2 = (threadIdx.x & 3) * 2;
  CeRows r;
  int nan[2] = {0, 0};
  r.mx[0] = r.mx[1] = -CUDART_INF_F;
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = 8 * n + c2 + (e & 1) < F ? bfr(lf[n][e]) : -CUDART_INF_F;
      lf[n][e] = v;
      nan[e >> 1] |= isnan(v) ? 1 : 0;
      r.mx[e >> 1] = fmaxf(r.mx[e >> 1], v);
    }
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    nan[h] |= __shfl_xor_sync(0xffffffffu, nan[h], 1);
    nan[h] |= __shfl_xor_sync(0xffffffffu, nan[h], 2);
    r.mx[h] = fmaxf(r.mx[h], __shfl_xor_sync(0xffffffffu, r.mx[h], 1));
    r.mx[h] = fmaxf(r.mx[h], __shfl_xor_sync(0xffffffffu, r.mx[h], 2));
    if (nan[h]) r.mx[h] = CUDART_NAN_F;
  }
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ex[n][e] = 8 * n + c2 + (e & 1) < F ? expf(lf[n][e] - r.mx[e >> 1]) : 0.f;
      s[e >> 1] = __fadd_rn(s[e >> 1], ex[n][e]);
    }
  r.se[0] = quad_sum(s[0]);
  r.se[1] = quad_sum(s[1]);
  return r;
}

// the lowest column < F of the lane's row g (h = 0) or g + 8 (h = 1) whose logit is >= mx,
// over the quad (every lane gets it); F where none is (mx NaN)
template <int NF>
__device__ __forceinline__ int quad_lowest_at(const float (&lf)[NF][4], int h, float mx, int F) {
  const int c2 = (threadIdx.x & 3) * 2;
  int best = F;
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int col = 8 * n + c2 + k;
      if (col < F && lf[n][2 * h + k] >= mx && col < best) best = col;
    }
  best = min(best, __shfl_xor_sync(0xffffffffu, best, 1));
  return min(best, __shfl_xor_sync(0xffffffffu, best, 2));
}

// K3's epilogue on the f32 logits of the warp's rows (tail_logits, not rounded): the
// lowest column at the row's max, and F - 1 for a row holding a NaN (argmax_lowest of
// ops/final_head.py); columns >= F are left out, since Wh's zero padding makes their
// logits exactly 0, which would win a row whose logits are all negative.  fmaxf drops a
// NaN, so a flag over the quad sees it.  The quad's lane with c2 = 0 writes the class of
// rows g and g + 8 to preds (T, p) at sub-pixel i.
template <int NF>
__device__ __forceinline__ void tail_argmax(const float (&lf)[NF][4], int* __restrict__ preds,
                                            size_t grow0, int i, int P, int F) {
  const int lane = threadIdx.x & 31;
  const int c2 = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -CUDART_INF_F;
    int nan = 0;
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (8 * n + c2 + k < F) {
          nan |= isnan(lf[n][2 * h + k]) ? 1 : 0;
          mx = fmaxf(mx, lf[n][2 * h + k]);
        }
    nan |= __shfl_xor_sync(0xffffffffu, nan, 1);
    nan |= __shfl_xor_sync(0xffffffffu, nan, 2);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const int best = quad_lowest_at<NF>(lf, h, mx, F);
    if ((lane & 3) == 0) preds[(grow0 + (lane >> 2) + 8 * h) * P + i] = nan ? F - 1 : best;
  }
}

__device__ __forceinline__ void put(bf16* p, float v) { *p = to_bf(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// the logits of the warp's rows g, g + 8 to tap (T, p, F): bf16 (rounded) or f32, sub-pixel
// i, the warp's first row grow0, lf's first column col0 (a probe's output; columns >= F
// are not written)
template <int NF, typename Out>
__device__ __forceinline__ void tail_tap(Out* __restrict__ tap, const float (&lf)[NF][4],
                                         size_t grow0, int i, int P, int F, int col0 = 0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = col0 + 8 * n + c2 + (e & 1);
      if (col < F) put(tap + ((grow0 + g + 8 * (e >> 1)) * P + i) * F + col, lf[n][e]);
    }
}

// ---------------------------------------------------------------------------------
// The head in chunks of 32 classes (F > 32; Wh zero-padded to a whole chunk)
// ---------------------------------------------------------------------------------

constexpr int TAIL_CHUNK = 32;  // classes of a head chunk: NF 4

struct CeStats {  // rows g (0) and g + 8 (1), the same in every lane of the quad
  float mx[2], se[2];  // the max rounded logit (NaN where one is NaN), sum of exp(l - max)
  float ly[2];         // the target's rounded logit (0 for a target outside 0 .. F - 1)
  int best[2];         // the lowest column at the max; F for a row holding a NaN
};

// chunk ch's logits of the warp's rows (tail_logits on Wh's columns 32 ch ..); zs as
// tail_logits' (z is written where not null)
template <int NT>
__device__ __forceinline__ void chunk_logits(float (&lf)[4][4], const float (&xh)[NT][4],
                                             const float* __restrict__ gamma,
                                             const float* __restrict__ beta, const bf16* whs,
                                             int ldwh, int ch, bf16* zs, int ldz) {
  tail_logits<NT, 4>(lf, xh, gamma, beta, whs + TAIL_CHUNK * ch, ldwh, zs, ldz);
}

// the cross entropy's statistics of the warp's rows over the head's nch chunks: each
// chunk's logits rounded to bf16 (-inf past F), then per lane a running max, the lowest
// column at it and a sum of exp(logit - max) rescaled by exp(old - new) where the max
// grows; the target's logit where the lane holds it; then the quad's lanes merged.  z is
// written to zs with chunk 0 where zs is not null; tap (may be null) gets the rounded
// logits as tail_tap's.
template <int NT, typename Tap>
__device__ __forceinline__ CeStats tail_chunk_stats(const float (&xh)[NT][4],
                                                    const float* __restrict__ gamma,
                                                    const float* __restrict__ beta,
                                                    const bf16* whs, int ldwh, int F, int nch,
                                                    const int (&yi)[2], bf16* zs, int ldz,
                                                    Tap* __restrict__ tap, size_t grow0, int i,
                                                    int P) {
  const int c2 = (threadIdx.x & 3) * 2;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, se[2] = {0.f, 0.f}, ly[2] = {0.f, 0.f};
  int best[2] = {F, F}, nan[2] = {0, 0};
  for (int ch = 0; ch < nch; ++ch) {
    float lf[4][4];
    chunk_logits<NT>(lf, xh, gamma, beta, whs, ldwh, ch, ch == 0 ? zs : nullptr, ldz);
    float m[2] = {mx[0], mx[1]};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // columns in ascending order within the lane
        const int col = TAIL_CHUNK * ch + 8 * n + c2 + (e & 1), h = e >> 1;
        const float v = col < F ? bfr(lf[n][e]) : -CUDART_INF_F;
        lf[n][e] = v;
        if (col < F) {
          nan[h] |= isnan(v) ? 1 : 0;
          if (best[h] == F ? v >= m[h] : v > m[h]) best[h] = col;  // a NaN compares false
          m[h] = fmaxf(m[h], v);
          if (col == yi[h]) ly[h] = v;
        }
      }
    if (tap != nullptr) tail_tap<4>(tap, lf, grow0, i, P, F, TAIL_CHUNK * ch);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = mx[h] == m[h] ? se[h] : __fmul_rn(se[h], expf(mx[h] - m[h]));
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float v = lf[n][2 * h + k];
          if (v != -CUDART_INF_F) s = __fadd_rn(s, expf(v - m[h]));
        }
      mx[h] = m[h];
      se[h] = s;
    }
  }
  CeStats r;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int nn = nan[h];
    nn |= __shfl_xor_sync(0xffffffffu, nn, 1);
    nn |= __shfl_xor_sync(0xffffffffu, nn, 2);
    float M = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, 2));
    r.se[h] = quad_sum(mx[h] == M ? se[h] : __fmul_rn(se[h], expf(mx[h] - M)));
    int b = mx[h] == M ? best[h] : F;
    b = min(b, __shfl_xor_sync(0xffffffffu, b, 1));
    b = min(b, __shfl_xor_sync(0xffffffffu, b, 2));
    r.ly[h] = quad_sum(ly[h]);  // one lane holds the target's logit, or none
    r.mx[h] = nn ? CUDART_NAN_F : M;
    r.best[h] = nn ? F : b;
  }
  return r;
}

// K7's dlogits of chunk ch, remade from the same logits: dl = bf16(sw (exp(l - max) / se -
// onehot)), 0 past F, into the warp's rows of the dlogits tile dls (ld ldwh, from row0)
template <int NT>
__device__ __forceinline__ void tail_chunk_dlogits(const float (&xh)[NT][4],
                                                   const float* __restrict__ gamma,
                                                   const float* __restrict__ beta,
                                                   const bf16* whs, int ldwh, int F, int ch,
                                                   const CeStats& st, const int (&yi)[2],
                                                   const float (&sw)[2], bf16* dls, int row0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  float lf[4][4];
  chunk_logits<NT>(lf, xh, gamma, beta, whs, ldwh, ch, nullptr, 0);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float dl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = TAIL_CHUNK * ch + 8 * n + c2 + (e & 1), h = e >> 1;
      dl[e] = col < F ? bfr(sw[h] * (__fdiv_rn(expf(bfr(lf[n][e]) - st.mx[h]), st.se[h]) -
                                     (col == yi[h] ? 1.f : 0.f)))
                      : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(dls + (row0 + g + 8 * h) * ldwh + TAIL_CHUNK * ch + 8 * n +
                                   c2) = pack_bf2(dl[2 * h], dl[2 * h + 1]);
  }
}

// K3's class of the warp's rows over the head's nch chunks: the f32 logits (not rounded),
// per lane a running max and the lowest column at it, then the quad merged; F - 1 for a
// row holding a NaN (tail_argmax's rule).  The quad's lane with c2 = 0 writes the classes;
// tap (may be null) gets the f32 logits.
template <int NT>
__device__ __forceinline__ void tail_chunk_argmax(const float (&xh)[NT][4],
                                                  const float* __restrict__ gamma,
                                                  const float* __restrict__ beta,
                                                  const bf16* whs, int ldwh, int F, int nch,
                                                  int* __restrict__ preds,
                                                  float* __restrict__ tap, size_t grow0, int i,
                                                  int P) {
  const int lane = threadIdx.x & 31;
  const int c2 = (lane & 3) * 2;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  int best[2] = {F, F}, nan[2] = {0, 0};
  for (int ch = 0; ch < nch; ++ch) {
    float lf[4][4];
    chunk_logits<NT>(lf, xh, gamma, beta, whs, ldwh, ch, nullptr, 0);
    if (tap != nullptr) tail_tap<4>(tap, lf, grow0, i, P, F, TAIL_CHUNK * ch);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = TAIL_CHUNK * ch + 8 * n + c2 + (e & 1), h = e >> 1;
        const float v = lf[n][e];
        if (col < F) {
          nan[h] |= isnan(v) ? 1 : 0;
          if (best[h] == F ? v >= m[h] : v > m[h]) best[h] = col;
          m[h] = fmaxf(m[h], v);
        }
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int nn = nan[h];
    nn |= __shfl_xor_sync(0xffffffffu, nn, 1);
    nn |= __shfl_xor_sync(0xffffffffu, nn, 2);
    float M = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, 2));
    int b = m[h] == M ? best[h] : F;
    b = min(b, __shfl_xor_sync(0xffffffffu, b, 1));
    b = min(b, __shfl_xor_sync(0xffffffffu, b, 2));
    if ((lane & 3) == 0) preds[(grow0 + (lane >> 2) + 8 * h) * P + i] = nn ? F - 1 : b;
  }
}

// K8's epilogue on the logits of the warp's rows (tail_logits): the quad's lane with c2 =
// 0, which holds columns 0 and 1 of rows g and g + 8, adds each valid target's loss to
// num and 1 to den, and writes the logits rounded to bf16 as the predictions (T, p F)
template <int NF>
__device__ __forceinline__ void tail_depth(const float (&lf)[NF][4], const float* __restrict__ t,
                                           bf16* __restrict__ preds, size_t grow0, int i,
                                           int P, int F, int kind, float delta, float& num,
                                           float& den) {
  const int lane = threadIdx.x & 31;
  if (lane & 3) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t e = (grow0 + (lane >> 2) + 8 * h) * P + i;
    const float l[2] = {lf[0][2 * h], lf[0][2 * h + 1]};
    const float tv = t[e];
    const bool valid = isfinite(tv);
    if (valid) {
      num += depth_loss(l, depth_diff(l[0], tv, valid), kind, delta);
      den += 1.f;
    }
    preds[e * F] = to_bf(l[0]);
    if (F > 1) preds[e * F + 1] = to_bf(l[1]);
  }
}

// K9's dlogits of the warp's rows g (h = 0) and g + 8 (h = 1): dl[h][f] = scale * d loss /
// d logit f, f32, 0 where the target is invalid and for f >= F; every lane of a quad gets
// its rows' values (the logits come from the quad's lane with c2 = 0)
template <int NF>
__device__ __forceinline__ void depth_dlogits(float (&dl)[2][2], const float (&lf)[NF][4],
                                              const float* __restrict__ t, float scale,
                                              size_t grow0, int i, int P, int F, int kind,
                                              float delta) {
  const int lane = threadIdx.x & 31;
  const int lead = lane & ~3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l[2] = {__shfl_sync(0xffffffffu, lf[0][2 * h], lead),
                        __shfl_sync(0xffffffffu, lf[0][2 * h + 1], lead)};
    const float tv = t[(grow0 + (lane >> 2) + 8 * h) * P + i];
    const bool valid = isfinite(tv);
    float g[2];
    depth_grads(l, depth_diff(l[0], tv, valid), valid, kind, delta, g);
    dl[h][0] = __fmul_rn(scale, g[0]);
    dl[h][1] = F > 1 ? __fmul_rn(scale, g[1]) : 0.f;
  }
}

}  // namespace hs
