// Window-attention building blocks shared by the forward kernels (window_attention.cu)
// and the backward kernels (window_attention_bwd.cu): one 64-token window and one
// 32-channel head at a time, tiles in shared memory, 16x16x16 bf16 WMMA products with
// f32 accumulation, 8 warps per block.
#pragma once

#include "common.cuh"

namespace hs {

// padded leading dimensions (elements); WMMA wants ldm % 8 == 0 (bf16) / % 4 == 0 (f32)
constexpr int LD_HEAD = HD + 8;     // 64 x 32 bf16 tiles: q, k, v, q_hat, k_hat, do
constexpr int LD_S = WS + 4;        // 64 x 64 f32 tiles: scores, probabilities, dp
constexpr int LD_P = WS + 8;        // 64 x 64 bf16 tiles: probabilities, ds
constexpr int LD_T = HD + 4;        // 64 x 32 f32 tiles: a head's output, dv, ds k_hat
constexpr int LD_QKV = 3 * HD + 4;  // one head's q|k|v projection, f32

// c (64 x 64 f32, ld LD_S) = a b^T over HD: a, b 64 x HD row-major bf16; 2 tiles/warp
__device__ inline void mm_abt(const bf16* a, int lda, const bf16* b, int ldb, float* c) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int t = warp * 2 + j;
    const int rt = t >> 2, ct = t & 3;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      FragA fa;
      FragBt fb;
      wmma::load_matrix_sync(fa, a + rt * 16 * lda + kk, lda);
      wmma::load_matrix_sync(fb, b + ct * 16 * ldb + kk, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + rt * 16 * LD_S + ct * 16, acc, LD_S, wmma::mem_row_major);
  }
}

// c (64 x 32 f32, ld LD_T) = op(a) b over WS: a 64 x 64 bf16 (ld LD_P), op(a) = a or
// a^T; b 64 x 32 row-major bf16; one tile per warp
template <bool TRANS>
__device__ inline void mm_pb(const bf16* a, const bf16* b, int ldb, float* c) {
  const int warp = threadIdx.x >> 5;
  const int rt = warp >> 1, ct = warp & 1;
  FragC acc;
  wmma::fill_fragment(acc, 0.f);
#pragma unroll
  for (int kk = 0; kk < WS; kk += 16) {
    FragB fb;
    wmma::load_matrix_sync(fb, b + kk * ldb + ct * 16, ldb);
    if constexpr (TRANS) {
      FragAt fa;  // element (m, k) of a^T at a[k * LD_P + m]
      wmma::load_matrix_sync(fa, a + kk * LD_P + rt * 16, LD_P);
      wmma::mma_sync(acc, fa, fb, acc);
    } else {
      FragA fa;
      wmma::load_matrix_sync(fa, a + rt * 16 * LD_P + kk, LD_P);
      wmma::mma_sync(acc, fa, fb, acc);
    }
  }
  wmma::store_matrix_sync(c + rt * 16 * LD_T + ct * 16, acc, LD_T, wmma::mem_row_major);
}

// p = softmax_row(s * mul + bias (-100 where group ids differ)) in f32, in place of the
// scores, and its bf16 copy in pl.  The shift is the row max (the Pallas kernels use a
// static bound; softmax is shift-invariant, and the row max cannot underflow a whole
// row); the sum is floored at 1e-30 as theirs.  One warp per row, two columns a lane.
__device__ inline void softmax_rows(float* s, bf16* pl, const int* g, bool masked,
                                    const float* __restrict__ bias_h, float mul) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < WS; r += kWarps) {
    float* srow = s + r * LD_S;
    const float* brow = bias_h + r * WS;
    float v0 = srow[lane] * mul + __ldg(brow + lane);
    float v1 = srow[lane + 32] * mul + __ldg(brow + lane + 32);
    if (masked) {
      const int gi = g[r];
      if (g[lane] != gi) v0 += MASK_VALUE;
      if (g[lane + 32] != gi) v1 += MASK_VALUE;
    }
    const float m = warp_max(fmaxf(v0, v1));
    const float e0 = expf(v0 - m);
    const float e1 = expf(v1 - m);
    const float d = fmaxf(warp_sum(e0 + e1), 1e-30f);
    const float p0 = e0 / d, p1 = e1 / d;
    srow[lane] = p0;
    srow[lane + 32] = p1;
    pl[r * LD_P + lane] = to_bf(p0);
    pl[r * LD_P + lane + 32] = to_bf(p1);
  }
}

// One head of window attention on shared-memory tiles: s = q k^T * mul + bias (+ mask);
// p = softmax_row(s) (f32 in s, bf16 in pl); o = bf16(p) v, f32 in s with leading
// dimension LD_T.  q, k, v 64 x HD bf16 (ld LD_HEAD).  Ends with a barrier.
__device__ inline void attend_head(const bf16* q, const bf16* k, const bf16* v, float* s,
                                   bf16* pl, const int* g, bool masked,
                                   const float* __restrict__ bias_h, float mul) {
  mm_abt(q, LD_HEAD, k, LD_HEAD, s);
  __syncthreads();
  softmax_rows(s, pl, g, masked, bias_h, mul);
  __syncthreads();
  mm_pb<false>(pl, v, LD_HEAD, s);
  __syncthreads();
}

// qkvf (64 x 3HD f32, ld LD_QKV) = x (64 x C bf16, shared, ld ldx) @ this head's q, k
// and v columns of Wqkv (C x 3C bf16, global, streamed from L2 as fragments): 4 row
// tiles x 6 column tiles, 3 per warp.  Ends with a barrier.
__device__ inline void project_head_qkv(const bf16* xs, int ldx, const bf16* __restrict__ wqkv,
                                        int C, int head, float* qkvf) {
  const int warp = threadIdx.x >> 5;
  const int rt = warp & 3;
  const int cbase = (warp >> 2) * 3;
  const int C3 = 3 * C;
  FragC acc[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int kk = 0; kk < C; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, xs + rt * 16 * ldx + kk, ldx);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int ct = cbase + j;
      const int gcol = (ct >> 1) * C + head * HD + (ct & 1) * 16;
      FragB b;
      wmma::load_matrix_sync(b, wqkv + size_t(kk) * C3 + gcol, C3);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
    wmma::store_matrix_sync(qkvf + rt * 16 * LD_QKV + (cbase + j) * 16, acc[j], LD_QKV,
                            wmma::mem_row_major);
  __syncthreads();
}

}  // namespace hs
