// The register-resident MLP row core of K12 (mlp_fwd_kernel) and K13's launch sequence
// (mlp_dx_kernel, mlp_dw_kernel), csrc/mlp.cu.
//
// A warp owns 16 token rows.  The hidden is walked in tiles of 16 rows x 32 columns:
// h = x W1[:, tile] in ascending 16-wide k-steps from zero sums, then + b1 in f32
// (hidden_tile), and dg = dout W2[tile, :]^T the same way (hidden_grad_tile).  Every
// kernel of the MLP computes h and dg through these two functions on the same
// ldmatrix fragments, so h, g = bf16(GELU(h)) and dh are the same bits in all of them:
// an mma depends only on its fragments and its accumulator.  GELU and its gradient run
// on the accumulators; the m16n8 accumulators of two neighbouring n-tiles, rounded to
// bf16, are one m16n8k16 A fragment (pack_a_frags), so g and dh go from one
// product into the next without leaving registers.  Fragment layouts as in
// attention.cuh: with g = lane / 4 and c = lane % 4 an accumulator holds rows g and
// g + 8, columns 2c and 2c + 1 of its 16 x 8 tile.
#pragma once

#include "common.cuh"

namespace hs {

constexpr int MLP_HC = 32;             // hidden columns of a hidden tile (4 n-tiles)
constexpr int MLP_LDC = MLP_HC + 8;    // leading dimension of 32-column bf16 tiles
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kTanhC = 0.044715f;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// K14 / K15's GELU and its gradient, one element at a time
__device__ __forceinline__ float gelu(float h, bool approx) {
  if (approx) {
    const float u = kSqrt2OverPi * (h + kTanhC * h * h * h);
    return 0.5f * h * (1.f + tanhf(u));
  }
  return 0.5f * h * (1.f + erff(h * kInvSqrt2));
}

__device__ __forceinline__ float gelu_grad(float h, bool approx) {
  if (approx) {
    const float u = kSqrt2OverPi * (h + kTanhC * h * h * h);
    const float t = tanhf(u);
    const float du = kSqrt2OverPi * (1.f + 3.f * kTanhC * h * h);
    return 0.5f * (1.f + t) + 0.5f * h * (1.f - t * t) * du;
  }
  const float cdf = 0.5f * (1.f + erff(h * kInvSqrt2));
  const float pdf = kInvSqrt2Pi * expf(-0.5f * h * h);
  return cdf + h * pdf;
}

// The row core's: the same arithmetic with the form (APPROX: tanh, else erf) fixed at
// compile time, so that a tile's loop holds no branch.  GELU and its gradient share one
// transcendental t, tanh(sqrt(2 / pi) (h + 0.044715 h^3)) or erf(h / sqrt 2); GELU(h) =
// h (1 + t) / 2 in both forms.  A kernel that needs both computes t once and gets the
// bits of each alone.
template <bool APPROX>
__device__ __forceinline__ float gelu_t(float h) {
  if constexpr (APPROX) return tanhf(kSqrt2OverPi * (h + kTanhC * h * h * h));
  else return erff(h * kInvSqrt2);
}

__device__ __forceinline__ float gelu_of(float h, float t) { return 0.5f * h * (1.f + t); }

template <bool APPROX>
__device__ __forceinline__ float gelu_grad_of(float h, float t) {
  if constexpr (APPROX) {
    const float du = kSqrt2OverPi * (1.f + 3.f * kTanhC * h * h);
    return 0.5f * (1.f + t) + 0.5f * h * (1.f - t * t) * du;
  } else {
    const float cdf = 0.5f * (1.f + t);
    const float pdf = kInvSqrt2Pi * expf(-0.5f * h * h);
    return cdf + h * pdf;
  }
}

// wait until at most n (0..4) of this thread's committed cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 4) cp_async_wait<4>();
  else if (n == 3) cp_async_wait<3>();
  else if (n == 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}

// rows x C bf16 (row stride C) from global memory -> a shared tile (leading dimension
// ld) by cp.async, 16 bytes a copy, all threads of the block; the caller commits
__device__ __forceinline__ void fetch_rows(bf16* dst, int ld, const bf16* __restrict__ src,
                                           int rows, int C) {
  const int cq = C / 8;
  for (int idx = threadIdx.x; idx < rows * cq; idx += blockDim.x) {
    const int r = idx / cq, q = (idx - r * cq) * 8;
    cp_async16(dst + r * ld + q, src + size_t(r) * C + q);
  }
}

// two 8 x 8 bf16 matrices, transposed; lanes 0-15 give the row addresses
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// h (16 x 8 NTH f32, NTH = 1, 2 or 4 n-tiles) = rows row0..row0+15 of a (bf16, ld lda)
// times w (C x 8 NTH bf16, ld ldw: row k, column n), ascending 16-wide k-steps from zero
// sums, then + b (the tile's b1 entries) in f32.  Each n-tile's sums depend only on its
// own fragments, so a 32-column hidden tile cut into n-tiles over several warps has the
// bits of the whole tile on one warp.
template <int NTH = 4>
__device__ __forceinline__ void hidden_tile(float (&h)[NTH][4], const bf16* a, int lda,
                                            int row0, const bf16* w, int ldw, int C,
                                            const float* __restrict__ b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < NTH; ++n) h[n][0] = h[n][1] = h[n][2] = h[n][3] = 0.f;
  const bf16* arow = a + (row0 + (lane & 15)) * lda + (lane >> 4) * 8;
  const bf16* wrow = w + (lane & 15) * ldw + (lane >> 4) * 8;
  for (int k = 0; k < C; k += 16) {
    uint32_t af[4];
    ldsm_x4(af, arow + k);
    if constexpr (NTH == 1) {
      uint32_t b0[2];
      ldsm_x2_t(b0, w + (lane & 15) * ldw + k * ldw);
      mma_bf16(h[0], af, b0[0], b0[1]);
    } else {
#pragma unroll
      for (int np = 0; np < NTH / 2; ++np) {  // n-tiles 2 np, 2 np + 1
        uint32_t b0[4];
        ldsm_x4_t(b0, wrow + k * ldw + 16 * np);
        mma_bf16(h[2 * np], af, b0[0], b0[1]);
        mma_bf16(h[2 * np + 1], af, b0[2], b0[3]);
      }
    }
  }
  const int c2 = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < NTH; ++n) {
    const float lo = b[8 * n + c2], hi = b[8 * n + c2 + 1];
    h[n][0] += lo;
    h[n][1] += hi;
    h[n][2] += lo;
    h[n][3] += hi;
  }
}

// dg (16 x 8 NTH f32) = rows row0..row0+15 of a (bf16, ld lda) times w^T, w (8 NTH x C
// bf16, ld ldw: row n, column k), ascending 16-wide k-steps from zero sums; C % 32 == 0
template <int NTH = 4>
__device__ __forceinline__ void hidden_grad_tile(float (&d)[NTH][4], const bf16* a, int lda,
                                                 int row0, const bf16* w, int ldw, int C) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < NTH; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
  const bf16* arow = a + (row0 + (lane & 15)) * lda + (lane >> 4) * 8;
  const bf16* wrow = w + (lane & 7) * ldw + (lane >> 3) * 8;
  for (int k = 0; k < C; k += 32) {
    uint32_t a0[4], a1[4];
    ldsm_x4(a0, arow + k);
    ldsm_x4(a1, arow + k + 16);
#pragma unroll
    for (int n = 0; n < NTH; ++n) {
      uint32_t bb[4];  // n-tile n: k 0-7, 8-15 (k-step k), 16-23, 24-31 (k-step k + 16)
      ldsm_x4(bb, wrow + 8 * n * ldw + k);
      mma_bf16(d[n], a0, bb[0], bb[1]);
      mma_bf16(d[n], a1, bb[2], bb[3]);
    }
  }
}

// the A fragments of two 16-wide k-steps (hidden columns 0-15, 16-31) from a 16 x 32
// tile of accumulators, rounded to bf16
__device__ __forceinline__ void pack_a_frags(uint32_t (&a)[2][4], const float (&t)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    a[ks][0] = pack_bf2(t[2 * ks][0], t[2 * ks][1]);
    a[ks][1] = pack_bf2(t[2 * ks][2], t[2 * ks][3]);
    a[ks][2] = pack_bf2(t[2 * ks + 1][0], t[2 * ks + 1][1]);
    a[ks][3] = pack_bf2(t[2 * ks + 1][2], t[2 * ks + 1][3]);
  }
}

// h -> GELU(h) in place (f32)
template <bool APPROX, int NTH>
__device__ __forceinline__ void gelu_tile(float (&h)[NTH][4]) {
#pragma unroll
  for (int n = 0; n < NTH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) h[n][e] = gelu_of(h[n][e], gelu_t<APPROX>(h[n][e]));
}

// dg -> dh = dg GELU'(h) in place (f32, unrounded)
template <bool APPROX, int NTH>
__device__ __forceinline__ void dh_tile(float (&dg)[NTH][4], const float (&h)[NTH][4]) {
#pragma unroll
  for (int n = 0; n < NTH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dg[n][e] = dg[n][e] * gelu_grad_of<APPROX>(h[n][e], gelu_t<APPROX>(h[n][e]));
}

// both at once, one transcendental an element: dg -> dh = dg GELU'(h), h -> GELU(h), the
// bits of dh_tile and gelu_tile
template <bool APPROX, int NTH>
__device__ __forceinline__ void gelu_dh_tile(float (&h)[NTH][4], float (&dg)[NTH][4]) {
#pragma unroll
  for (int n = 0; n < NTH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float t = gelu_t<APPROX>(h[n][e]);
      dg[n][e] = dg[n][e] * gelu_grad_of<APPROX>(h[n][e], t);
      h[n][e] = gelu_of(h[n][e], t);
    }
}

// acc (16 x 8 nt f32, nt <= NT, even) += a (A fragments of 16 x 32) times w (32 x 8 nt
// bf16, ld ldw: row k, column n): K12's g W2 chunk
template <int NT>
__device__ __forceinline__ void frags_times_rows(float (&acc)[NT][4], const uint32_t (&a)[2][4],
                                                 const bf16* w, int ldw, int nt) {
  const int lane = threadIdx.x & 31;
  const bf16* wrow = w + (lane & 15) * ldw + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (2 * np < nt) {
        uint32_t b[4];
        ldsm_x4_t(b, wrow + 16 * ks * ldw + 16 * np);
        mma_bf16(acc[2 * np], a[ks], b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a[ks], b[2], b[3]);
      }
    }
  }
}

// acc (16 x 8 nt f32) += a (A fragments of 16 x 32) times w^T, w (8 nt x 32 bf16, ld
// ldw: row n, column k): K13's dx += dh_lo W1 chunk^T
template <int NT>
__device__ __forceinline__ void frags_times_rows_t(float (&acc)[NT][4],
                                                   const uint32_t (&a)[2][4], const bf16* w,
                                                   int ldw, int nt) {
  const int lane = threadIdx.x & 31;
  const bf16* wrow = w + (lane & 7) * ldw + (lane >> 3) * 8;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < nt) {
      uint32_t b[4];
      ldsm_x4(b, wrow + 8 * t * ldw);
      mma_bf16(acc[t], a[0], b[0], b[1]);
      mma_bf16(acc[t], a[1], b[2], b[3]);
    }
  }
}

// acc (mw m-tiles x 2 n-tiles of 16 x 8 f32) += a^T b over R rows (R % 16 == 0): a an
// R x M bf16 tile (ld lda; m = column), m-tiles m_first + m_stride i for i < mw <= MW,
// read transposed by ldmatrix.trans; b an R x N bf16 tile (ld ldb; n = column), columns
// n0 .. n0 + 15.  K13's dW1 += x^T dh_lo and dW2^T += dout^T g.
template <int MW>
__device__ __forceinline__ void tile_t_times_tile_cols(float (&acc)[MW][2][4], const bf16* a,
                                                       int lda, int mw, int m_first,
                                                       int m_stride, const bf16* b, int ldb,
                                                       int n0, int R) {
  const int lane = threadIdx.x & 31;
  const bf16* brow = b + (lane & 15) * ldb + n0 + (lane >> 4) * 8;
  // matrix i = lane / 8 of an A^T fragment: rows k 8 (i / 2) .., columns m 8 (i % 2) ..
  const bf16* arow = a + ((lane & 7) + ((lane >> 4) << 3)) * lda + ((lane >> 3) & 1) * 8;
  for (int k = 0; k < R; k += 16) {
    uint32_t bb[4];
    ldsm_x4_t(bb, brow + k * ldb);
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      if (i < mw) {
        uint32_t at[4];
        ldsm_x4_t(at, arow + k * lda + (m_first + m_stride * i) * 16);
        mma_bf16(acc[i][0], at, bb[0], bb[1]);
        mma_bf16(acc[i][1], at, bb[2], bb[3]);
      }
    }
  }
}

}  // namespace hs
