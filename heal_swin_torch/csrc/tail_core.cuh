// The register-resident row core of the segmentation tail: K6 (tail_loss_kernel) and the
// row kernel of K7's launch sequence (tail_bwd_kernel), csrc/final_head.cu.
//
// A block walks 128-row tiles of the tokens; a warp owns 16 rows of a tile.  For each of
// the p expand slices We_i (C x C, resident in shared memory for the block's whole walk):
// h = x We_i on mma.sync m16n8k16 from ldmatrix fragments, in ascending 16-wide k-steps
// from zero sums (mlp_core.cuh hidden_tile, its bias off), rounded to bf16 on the
// accumulators; the LayerNorm statistics over each row's quad (ln_rows, its bias off)
// with explicitly rounded operations; xhat in place; z = bf16(xhat gamma + beta),
// repacked 32 columns at a time as A fragments (pack_a_frags) and multiplied into the
// head Wh (C x 8 NF bf16, zero-padded from F to 8 NF columns) by mma: the logits, 16 x 8
// NF f32 accumulators, each row in one quad, 2 NF values a lane.  K6 and K7 make h, z
// and the logits only through these functions on the same fragments, so K7's recomputed
// logits are K6's bits (an mma depends only on its fragments and its accumulator).  No
// (rows x C) tile of f32 goes through shared memory, and no loop over C runs on the CUDA
// cores.
#pragma once

#include <math_constants.h>

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

// the rounded logits of the warp's rows g, g + 8 to tap (T, p, F) bf16, sub-pixel i, the
// warp's first row grow0 (a probe's output; columns >= F are not written)
template <int NF>
__device__ __forceinline__ void tail_tap(bf16* __restrict__ tap, const float (&lf)[NF][4],
                                         size_t grow0, int i, int P, int F) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < NF; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * n + c2 + (e & 1);
      if (col < F) tap[((grow0 + g + 8 * (e >> 1)) * P + i) * F + col] = to_bf(lf[n][e]);
    }
}

}  // namespace hs
