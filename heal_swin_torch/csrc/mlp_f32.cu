// The SWIN block MLP and the SWIN-v2 MLP branch of HEAL-SWIN for Hopper (sm_90a) in
// float32, for the configs that compute in f32 (the paper run configs, the JAX config
// default dtype None) with mlp_impl="fused".  The bf16 forms are in mlp.cu.
//
// Replaces, in f32, four Pallas TPU kernels of heal_swin_tpu/ops/mlp.py:
//   K12 hs_mlp_fwd_f32       <- _fwd_kernel (fused_mlp, fwd_impl="pallas", x f32)
//   K13 hs_mlp_bwd_f32       <- _bwd_kernel (the backward of fused_mlp / fused_mlp_nd)
//   K14 hs_mlp_block_fwd_f32 <- _blk_fwd_kernel (fused_mlp_block)
//   K15 hs_mlp_block_bwd_f32 <- _blk_bwd_kernel
// With f32 operands every .astype(x.dtype) of the Pallas bodies is the identity: g, dh
// and du are not rounded below f32, and the LayerNorm statistics are taken on u as
// summed.  GELU and its gradient in f32, tanh or erf (mlp_core.cuh's gelu_t, the bf16
// kernels' own).
//
// K12 and K14 are launch sequences of the 3xTF32 products of attention_f32.cuh
// (gemm_3xtf32_kernel on mma.sync m16n8k8, each 32-k slice summed in a zeroed
// accumulator) with this file's epilogues and the LayerNorm row kernel:
//   K12: (1) NN x W1 + b1, epilogue EpiGelu: g = GELU(h) (T x H, the workspace);
//        (2) NN g W2 + b2 -> out.
//   K14: K12's (1) and (2) into out, then (3) mlp_ln_fwd_f32_kernel: out = x + dscale
//        (LN(u) gamma + beta), in place.
// K13 and K15 run every product on the wgmma core of gemm_3xtf32_wgmma.cuh
// (gemm_3xtf32_wg_kernel: wgmma m64n96k8 tf32 from hi and lo planes that one pass of the
// block splits once a slice in shared memory), reduce_rows (reduce.cu) summing their
// fixed-order partial rows:
//   K13: (1) the dual product: one tile of h = x W1 + b1 and of dg = dout W2^T, both over
//        C, epilogue WgEpiDual: g = GELU(h) and dh = dg GELU'(h) written (h never is),
//        and per 128-row block a partial row [sum of dh | sum of dout] (db1 | db2);
//        (2) NT dh W1^T -> dx; (3) the TN pair in one launch: g^T dout (dW2) and dh^T x
//        (dW1, stored transposed), split over the tokens into partial rows, reduce_rows
//        -> [dW2 | dW1] (none where one split takes all the tokens); (4) reduce_rows of
//        the row blocks' partial rows -> [db1 | db2].  4-6 launches, from 9.
//   K15: (1) NN x W1 + b1, epilogue WgEpiGelu: g and GELU'(h) (one erf an element for
//        both); (2) NN g W2 + b2 -> u; (3) mlp_ln_bwd_f32_kernel: du over u, and a partial
//        row [db2 | dgamma | dbeta] per 128 rows; (4) NT du W2^T, epilogue WgEpiDh: dh =
//        dg GELU'(h) over GELU'(h), and the partial row's db1; (5) reduce_rows -> [db1 |
//        db2 | dgamma | dbeta]; (6) NT dz + dh W1^T -> dx (WgEpiStore<residual>); (7) the
//        TN pair (g^T du, dh^T x) and reduce_rows -> [dW2 | dW1].  K15's dg needs du, which
//        needs u and so g, so its dh cannot come from K13's dual product; GELU'(h) is
//        stored by (1), not h remade in (4): on the card (H100, tools/attention_pair_timing.py
//        against the remade form) the remake cost a seventh product and a second erf an
//        element, which outweighed the write and read of GELU'(h) (4 T H bytes each).
// The workspace holds the hidden in f32: g (K12, K14); g and dh (K13, K15), 4 T H bytes
// each (402,653,184 at the paper's stage 0, T 262,144 and H 384), for K15 u / du (4 T C);
// the row blocks' partial rows, the TN pair's partial rows and reduce_rows' scratch.
// No float atomics: two launches give the same bits.
//
// What bounds them: a product is 2 T C H FLOP on 4 T (C + H) bytes, H = 4C: 8 C / 5
// FLOP a byte, 154 at C 96, under the 3xTF32 ridge (164.9 TFLOPS over 3.35 TB/s, ~49)
// only below C 31: the products decide, K12 and K14 two of them, K13 five, K15 six (at
// every stage T C^2 = 2.416e9: 38.65 / 96.6 / 116 GFLOP, 0.234 / 0.586 / 0.703 ms).  The
// sequences move the (T, H) hidden through device memory, 4 T H bytes a pass: K13 writes
// g and dh and reads dh twice and g once (5 passes, 2.0 GB at stage 0, ~0.6 ms; 8 before
// the dual product), K15 6 (g written, read twice; dh written, read twice).  On the
// mma.sync core the products ran at ~42 TFLOPS of f32 work (each warp split every
// fragment it loaded; 184-220 bytes spilled); the wgmma core splits each operand element
// once a tile and keeps the tensor cores fed from shared memory while the next slice is
// split and the last tile stored.

#include "attention_f32.cuh"
#include "gemm_3xtf32_wgmma.cuh"
#include "mlp_core.cuh"

namespace hs {
namespace {

constexpr int kMaxC = 768;
constexpr int kMlpLnRows = 128;  // rows a block of the LayerNorm backward (16 a warp): the
                                 // wgmma core's row block, whose partial rows K15 shares

// ---------------------------------------------------------------------------------
// Epilogues of gemm_3xtf32_kernel (attention_f32.cuh EpiBias's protocol): the pair at
// out[i], out[i + 1] from the sums a0, a1 and the bias pair b (zero without a bias).
// ---------------------------------------------------------------------------------

// out = GELU(a + b1) (h = a + b1 is not kept)
template <bool APPROX>
struct EpiGelu {
  __device__ __forceinline__ static void store(float* out, float*, size_t i, float a0,
                                               float a1, float2 b) {
    const float h0 = __fadd_rn(a0, b.x), h1 = __fadd_rn(a1, b.y);
    *reinterpret_cast<float2*>(out + i) =
        make_float2(gelu_of(h0, gelu_t<APPROX>(h0)), gelu_of(h1, gelu_t<APPROX>(h1)));
  }
};

// ---------------------------------------------------------------------------------
// Epilogues of gemm_3xtf32_wg_kernel (gemm_3xtf32_wgmma.cuh): Epi::store on a finished
// tile's accumulators, Epi::on_split on a landed raw slice
// ---------------------------------------------------------------------------------

// h = sum + b1 -> g = GELU(h) into out[0] and GELU'(h) into aux (one transcendental an
// element for both): K15's first step
template <bool APPROX>
struct WgEpiGelu : WgNoHooks {
  template <int J0>
  __device__ __forceinline__ static void chunk(const WgArgs& a, const float (&acc)[WG_ACC],
                                               int m0, int n0) {
    float2 b[WG_EPI_CHUNK];
    wg_bias_pairs<J0>(a, n0, b);
#pragma unroll
    for (int jj = 0; jj < WG_EPI_CHUNK; ++jj) {
      const int j = J0 + jj, n = n0 + 8 * j;
      if (n >= a.N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 8 * h;
        if (m >= a.M) continue;
        const float h0 = __fadd_rn(acc[4 * j + 2 * h], b[jj].x);
        const float h1 = __fadd_rn(acc[4 * j + 2 * h + 1], b[jj].y);
        const float t0 = gelu_t<APPROX>(h0), t1 = gelu_t<APPROX>(h1);
        const size_t o = size_t(m) * a.N + n;
        *reinterpret_cast<float2*>(a.out[0] + o) = make_float2(gelu_of(h0, t0), gelu_of(h1, t1));
        *reinterpret_cast<float2*>(a.aux + o) =
            make_float2(gelu_grad_of<APPROX>(h0, t0), gelu_grad_of<APPROX>(h1, t1));
      }
    }
  }
  __device__ __forceinline__ static void store(const WgArgs& a, const WgSlice& v,
                                               const float (&acc)[WG_ACC],
                                               const float (&)[WG_ACC], float*,
                                               const float*, int tid) {
    const int m0 = v.mb * WG_BM + wg_row(tid), n0 = v.nb * WG_BN + wg_col(tid);
    chunk<0>(a, acc, m0, n0);
    chunk<WG_EPI_CHUNK>(a, acc, m0, n0);
    chunk<2 * WG_EPI_CHUNK>(a, acc, m0, n0);
  }
};

// a tile's column sums: the thread's pair (s0, s1) of column group j summed over the
// warp's 16 rows (rows8) into the warp's row of scratch (8 x WG_BN, the tile's own: the
// kernel alternates two, so a warpgroup a tile ahead does not write over rows still read)
__device__ __forceinline__ void col_sums_warp(float s0, float s1, int j, float* scratch,
                                              int tid) {
  s0 = rows8(s0);
  s1 = rows8(s1);
  if ((tid & 31) < 4) {
    scratch[(tid >> 5) * WG_BN + 8 * j + wg_col(tid)] = s0;
    scratch[(tid >> 5) * WG_BN + 8 * j + wg_col(tid) + 1] = s1;
  }
}

// ... then the 8 warps' rows summed in order into the row block's partial row (part + mb
// ld_part, the tile's columns); the consumers' barrier between
__device__ __forceinline__ void col_sums_out(const WgArgs& a, const WgSlice& v,
                                             const float* scratch, int tid) {
  named_sync(WG_BAR_CONSUMERS, WG_CONSUMERS);
  if (tid < WG_BN && v.nb * WG_BN + tid < a.N) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += scratch[w * WG_BN + tid];
    a.part[size_t(v.mb) * a.ld_part + v.nb * WG_BN + tid] = s;
  }
}

// dh = sum GELU'(h), GELU'(h) read from aux, into out[0] (may be aux: each pair read, then
// written, by one thread); the row block's column sums of dh into the partial rows (db1):
// K15's dh step
struct WgEpiDh : WgNoHooks {
  template <int J0>
  __device__ __forceinline__ static void chunk(const WgArgs& a, const float (&acc)[WG_ACC],
                                               float* scratch, int m0, int n0, int tid) {
    float2 gp[WG_EPI_CHUNK][2];
    wg_matrix_pairs<J0>(a.aux, a, m0, n0, gp);
#pragma unroll
    for (int jj = 0; jj < WG_EPI_CHUNK; ++jj) {
      const int j = J0 + jj, n = n0 + 8 * j;
      float s0 = 0.f, s1 = 0.f;  // the thread's column sums of dh (its two rows)
      if (n < a.N) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 8 * h;
          if (m >= a.M) continue;
          const float d0 = acc[4 * j + 2 * h] * gp[jj][h].x;
          const float d1 = acc[4 * j + 2 * h + 1] * gp[jj][h].y;
          *reinterpret_cast<float2*>(a.out[0] + size_t(m) * a.N + n) = make_float2(d0, d1);
          s0 += d0;
          s1 += d1;
        }
      }
      col_sums_warp(s0, s1, j, scratch, tid);
    }
  }
  __device__ __forceinline__ static void store(const WgArgs& a, const WgSlice& v,
                                               const float (&acc)[WG_ACC],
                                               const float (&)[WG_ACC], float* scratch,
                                               const float*, int tid) {
    const int m0 = v.mb * WG_BM + wg_row(tid), n0 = v.nb * WG_BN + wg_col(tid);
    chunk<0>(a, acc, scratch, m0, n0, tid);
    chunk<WG_EPI_CHUNK>(a, acc, scratch, m0, n0, tid);
    chunk<2 * WG_EPI_CHUNK>(a, acc, scratch, m0, n0, tid);
    col_sums_out(a, v, scratch, tid);
  }
};

// The f32 K13's dual product's epilogue: h = sums0 + b1 (x W1, never stored), dg = sums1
// (dout W2^T); g = GELU(h) -> out[0] and dh = dg GELU'(h) -> out[1] (one transcendental
// an element for both); the row block's column sums of dh -> part[mb ld_part + n] (db1)
// and of op set 1's A (dout, k < K = C) -> part[mb ld_part + N + k] (db2), the latter
// gathered by the producer (on_split) while A's raw slices land (the tile's column block 0
// only; a row of 4 warps' sums for each of two tiles in flight).  Each sum in a fixed
// order: a thread's rows, the warp's row groups, the warps in order.
template <bool APPROX>
struct WgEpiDual {
  __device__ __forceinline__ static void on_split(const WgArgs&, const WgSlice& v,
                                                  const float* raw, float* psum, int tid) {
    if (v.phase != 1 || v.nb != 0) return;
    // A's raw slice: 128 rows x 32 k; the thread's rows (tid >> 3) + 16 j, k chunk tid & 7
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < WG_BM / 16; ++j) {
      const float4 x =
          *reinterpret_cast<const float4*>(raw + wg_kc((tid >> 3) + 16 * j, (tid & 7) * 4));
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
#pragma unroll
    for (int o = 8; o < 32; o <<= 1) {  // the warp's 4 lanes of one k chunk
      s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
      s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
      s.z += __shfl_xor_sync(0xffffffffu, s.z, o);
      s.w += __shfl_xor_sync(0xffffffffu, s.w, o);
    }
    if ((tid & 31) < 8)
      *reinterpret_cast<float4*>(psum + (tid >> 5) * WG_MAX_K2 + v.k0 + 4 * (tid & 7)) = s;
  }

  template <int J0>
  __device__ __forceinline__ static void chunk(const WgArgs& a, const float (&acc0)[WG_ACC],
                                               const float (&acc1)[WG_ACC], float* scratch,
                                               int m0, int n0, int tid) {
    float2 b[WG_EPI_CHUNK];
    wg_bias_pairs<J0>(a, n0, b);
#pragma unroll
    for (int jj = 0; jj < WG_EPI_CHUNK; ++jj) {
      const int j = J0 + jj, n = n0 + 8 * j;
      float s0 = 0.f, s1 = 0.f;  // the thread's column sums of dh (its two rows)
      if (n < a.N) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 8 * h;
          if (m >= a.M) continue;
          const int i = 4 * j + 2 * h;
          const float h0 = __fadd_rn(acc0[i], b[jj].x), h1 = __fadd_rn(acc0[i + 1], b[jj].y);
          const float t0 = gelu_t<APPROX>(h0), t1 = gelu_t<APPROX>(h1);
          const float d0 = acc1[i] * gelu_grad_of<APPROX>(h0, t0);
          const float d1 = acc1[i + 1] * gelu_grad_of<APPROX>(h1, t1);
          const size_t o = size_t(m) * a.N + n;
          *reinterpret_cast<float2*>(a.out[0] + o) =
              make_float2(gelu_of(h0, t0), gelu_of(h1, t1));
          *reinterpret_cast<float2*>(a.out[1] + o) = make_float2(d0, d1);
          s0 += d0;
          s1 += d1;
        }
      }
      col_sums_warp(s0, s1, j, scratch, tid);
    }
  }

  __device__ __forceinline__ static void store(const WgArgs& a, const WgSlice& v,
                                               const float (&acc0)[WG_ACC],
                                               const float (&acc1)[WG_ACC], float* scratch,
                                               const float* psum, int tid) {
    const int m0 = v.mb * WG_BM + wg_row(tid), n0 = v.nb * WG_BN + wg_col(tid);
    chunk<0>(a, acc0, acc1, scratch, m0, n0, tid);
    chunk<WG_EPI_CHUNK>(a, acc0, acc1, scratch, m0, n0, tid);
    chunk<2 * WG_EPI_CHUNK>(a, acc0, acc1, scratch, m0, n0, tid);
    col_sums_out(a, v, scratch, tid);
    if (v.nb == 0) {
      float* row = a.part + size_t(v.mb) * a.ld_part + a.N;
      for (int k = tid; k < a.K; k += WG_CONSUMERS) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) s += psum[w * WG_MAX_K2 + k];
        row[k] = s;
      }
    }
  }
};

// the f32 K13's dual product: g and dh (T x H), and the row blocks' partial rows [db1 (H)
// | db2 (C)] (ld_part floats apart)
template <bool APPROX>
cudaError_t dual_f32(const float* x, const float* w1, const float* b1, const float* dout,
                     const float* w2, float* g, float* dh, float* part, int ld_part, int T,
                     int C, int H, cudaStream_t s) {
  WgArgs a{};
  a.A[0] = x; a.B[0] = w1; a.A[1] = dout; a.B[1] = w2;
  a.out[0] = g; a.out[1] = dh; a.bias = b1; a.part = part; a.ld_part = ld_part;
  a.M = T; a.N = H; a.K = C; a.kchunk = C; a.splits = 1; a.groups = 1;
  return wg_launch<true, false, true, true, WgEpiDual<APPROX>>(a, s);
}

// K15's dh step: dh = (du W2^T) GELU'(h), GELU'(h) read from gp and dh written over it,
// and the row blocks' column sums of dh (db1) into part (ld_part floats apart)
cudaError_t dh_from_grad_f32(const float* du, const float* w2, float* gp, float* part,
                             int ld_part, int T, int C, int H, cudaStream_t s) {
  WgArgs a{};
  a.A[0] = du; a.B[0] = w2; a.out[0] = gp; a.aux = gp; a.part = part; a.ld_part = ld_part;
  a.M = T; a.N = H; a.K = C; a.kchunk = C; a.splits = 1; a.groups = 1;
  return wg_launch<true, true, true, false, WgEpiDh>(a, s);
}

// ---------------------------------------------------------------------------------
// mlp_ln_fwd_f32_kernel<P>: K14's last step, a warp a row (C <= 32 P): ln_row_center's
// statistics of u, then out = x + dscale ((u - mean) rstd gamma + beta), each product
// and sum one rounding as the plain version's; out may be u.
// ---------------------------------------------------------------------------------
template <int P>
__global__ void __launch_bounds__(kThreads)
mlp_ln_fwd_f32_kernel(const float* u, const float* __restrict__ x,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const float* __restrict__ dscale, float* out, int T, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= T) return;
  const size_t off = size_t(row) * C;
  const int per = C / 32;
  float v[P];
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (i < per) v[i] = u[off + lane + 32 * i];
  const float rstd = ln_row_center(v, per, C, eps);
  const float ds = dscale != nullptr ? dscale[row] : 1.f;
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (i < per) {
      const int c = lane + 32 * i;
      float y = __fadd_rn(__fmul_rn(__fmul_rn(v[i], rstd), gamma[c]), beta[c]);
      if (dscale != nullptr) y = __fmul_rn(y, ds);
      out[off + c] = __fadd_rn(x[off + c], y);
    }
}

// ---------------------------------------------------------------------------------
// mlp_ln_bwd_f32_kernel<P>: K15's LayerNorm backward, a warp a row, 16 rows a warp and
// kMlpLnRows a block (rows past T skipped): u's statistics as K14 takes them, xhat, dy =
// dz dscale, then du = rstd (dy gamma - mean(dy gamma) - xhat mean(dy gamma xhat))
// written over u (du may be u), and the block's column sums of du (db2), dy xhat (dgamma)
// and dy (dbeta) as one partial row [db2 | dgamma | dbeta] at part + blockIdx.x ld + off,
// each column summed over the 8 warps in order.
// ---------------------------------------------------------------------------------
template <int P>
__global__ void __launch_bounds__(kThreads)
mlp_ln_bwd_f32_kernel(const float* u, const float* __restrict__ dz,
                      const float* __restrict__ gamma, const float* __restrict__ dscale,
                      float* du, float* __restrict__ part, int T, int C, int ld, int off,
                      float eps) {
  __shared__ float cols[kWarps][3][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = C / 32;
  float sb[P], sg[P], sz[P];
#pragma unroll
  for (int i = 0; i < P; ++i) sb[i] = sg[i] = sz[i] = 0.f;
  for (int rr = 0; rr < kMlpLnRows / kWarps; ++rr) {
    const size_t row = size_t(blockIdx.x) * kMlpLnRows + warp * (kMlpLnRows / kWarps) + rr;
    if (row >= size_t(T)) break;
    const size_t o = row * C;
    const float ds = dscale != nullptr ? dscale[row] : 1.f;
    float v[P], z[P];
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (i < per) {
        v[i] = u[o + lane + 32 * i];
        z[i] = dz[o + lane + 32 * i];
        if (dscale != nullptr) z[i] = __fmul_rn(z[i], ds);
      }
    const float rstd = ln_row_center(v, per, C, eps);
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (i < per) {
        v[i] = __fmul_rn(v[i], rstd);  // xhat
        const float dg = __fmul_rn(z[i], gamma[lane + 32 * i]);
        a += dg;
        b += dg * v[i];
      }
    a = __fdiv_rn(warp_sum(a), float(C));
    b = __fdiv_rn(warp_sum(b), float(C));
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (i < per) {
        const float dg = __fmul_rn(z[i], gamma[lane + 32 * i]);
        const float d = rstd * (dg - a - v[i] * b);
        du[o + lane + 32 * i] = d;
        sb[i] += d;
        sg[i] += z[i] * v[i];
        sz[i] += z[i];
      }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (i >= per) break;  // per is the block's
    cols[warp][0][lane] = sb[i];
    cols[warp][1][lane] = sg[i];
    cols[warp][2][lane] = sz[i];
    __syncthreads();
    if (threadIdx.x < 96) {
      const int k = threadIdx.x >> 5, l = threadIdx.x & 31;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += cols[w][k][l];
      part[size_t(blockIdx.x) * ld + off + size_t(k) * C + 32 * i + l] = s;
    }
    __syncthreads();
  }
}

inline bool takes(int T, int C, int H) {
  return T > 0 && T % 64 == 0 && C > 0 && C % 32 == 0 && C <= kMaxC && H > 0 && H % 32 == 0;
}

// row blocks of kMlpLnRows (= WG_BM) rows: the partial rows of K13, K15 and the LayerNorm
inline int row_blocks(int T) { return (T + kMlpLnRows - 1) / kMlpLnRows; }

// the LayerNorm kernels' register bound: C <= 96, 192, 384, 768
template <template <int> class Launch, class... Args>
inline cudaError_t by_width(int C, Args... args) {
  const int per = C / 32;
  if (per <= 3) return Launch<3>::run(args...);
  if (per <= 6) return Launch<6>::run(args...);
  if (per <= 12) return Launch<12>::run(args...);
  return Launch<24>::run(args...);
}

template <int P>
struct LnFwd {
  static cudaError_t run(const float* u, const float* x, const float* gamma, const float* beta,
                         const float* dscale, float* out, int T, int C, float eps,
                         cudaStream_t s) {
    mlp_ln_fwd_f32_kernel<P><<<(T + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        u, x, gamma, beta, dscale, out, T, C, eps);
    return cudaGetLastError();
  }
};

template <int P>
struct LnBwd {
  static cudaError_t run(const float* u, const float* dz, const float* gamma,
                         const float* dscale, float* du, float* part, int T, int C, int ld,
                         int off, float eps, cudaStream_t s) {
    mlp_ln_bwd_f32_kernel<P><<<row_blocks(T), kThreads, 0, s>>>(u, dz, gamma, dscale, du,
                                                                 part, T, C, ld, off, eps);
    return cudaGetLastError();
  }
};

// K12's and K14's step (1): g = GELU(x W1 + b1), (T x H)
cudaError_t hidden_f32(const float* x, const float* w1, const float* b1, float* g, int T,
                       int C, int H, bool approx, cudaStream_t s) {
  return approx ? gemm_nn_f32<EpiGelu<true>>(x, w1, b1, g, T, H, C, s)
                : gemm_nn_f32<EpiGelu<false>>(x, w1, b1, g, T, H, C, s);
}

// the backward's workspace: g and dh (T x H); with the branch u / du (T x C); the row
// blocks' partial rows ([db1 | db2], or [db1 | db2 | dgamma | dbeta]); the TN pair's
// partial rows and their reduction's scratch; the row blocks' reduction's scratch
struct BwdWork {
  size_t g, dh, u, part, tn, tmp, total;
  int ld_part;
};

inline BwdWork bwd_work(int T, int C, int H, bool block) {
  BwdWork w;
  const int rb = row_blocks(T);
  w.ld_part = H + (block ? 3 : 1) * C;
  const size_t hid = align128(size_t(T) * H * 4);
  size_t off = 0;
  w.g = off; off += hid;
  w.dh = off; off += hid;
  w.u = off; off += block ? align128(size_t(T) * C * 4) : 0;
  w.part = off; off += align128(size_t(rb) * w.ld_part * 4);
  w.tn = off; off += align128(wg_tn_tmp_floats(T, H, C, 2) * 4);
  w.tmp = off; off += align128(reduce_rows_tmp_floats(rb, w.ld_part) * 4);
  w.total = off;
  return w;
}

template <class T>
T* at(void* work, size_t off) {
  return reinterpret_cast<T*>(static_cast<unsigned char*>(work) + off);
}

}  // namespace
}  // namespace hs

extern "C" {

// K12's and K14's workspace: g (T x H), f32
size_t hs_mlp_fwd_f32_workspace(int T, int C, int H) {
  (void)C;
  return hs::align128(size_t(T) * H * 4);
}

// f32 K12: (1) g = GELU(x W1 + b1) into the workspace; (2) out = g W2 + b2
int hs_mlp_fwd_f32(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, void* work, int T, int C, int H, int approximate,
                   void* stream) {
  if (!hs::takes(T, C, H)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(work);
  cudaError_t e = hs::hidden_f32(static_cast<const float*>(x), static_cast<const float*>(w1),
                                 static_cast<const float*>(b1), g, T, C, H, approximate != 0,
                                 s);
  if (e != cudaSuccess) return int(e);
  return int(hs::gemm_nn_f32(g, static_cast<const float*>(w2), static_cast<const float*>(b2),
                             static_cast<float*>(out), T, C, H, s));
}

// f32 K14: K12's steps into out, then the LayerNorm, the DropPath scale (has_dscale) and
// the residual in place
int hs_mlp_block_fwd_f32(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* b2, const void* gamma, const void* beta,
                         const void* dscale, void* out, void* work, int T, int C, int H,
                         int approximate, int has_dscale, float ln_eps, void* stream) {
  const int code = hs_mlp_fwd_f32(x, w1, b1, w2, b2, out, work, T, C, H, approximate, stream);
  if (code != 0) return code;
  float* o = static_cast<float*>(out);
  return int(hs::by_width<hs::LnFwd>(
      C, static_cast<const float*>(o), static_cast<const float*>(x),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      has_dscale ? static_cast<const float*>(dscale) : nullptr, o, T, C, ln_eps,
      static_cast<cudaStream_t>(stream)));
}

size_t hs_mlp_bwd_f32_workspace(int T, int C, int H) {
  return hs::bwd_work(T, C, H, false).total;
}

// f32 K13: dx (T x C), dw = [dW2 (H x C) | dW1 (C x H)] and red = [db1 (H) | db2 (C)]
int hs_mlp_bwd_f32(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* dout, void* dx, void* dw, void* red, void* work,
                   int T, int C, int H, int approximate, void* stream) {
  (void)b2;  // b2 does not enter the backward
  if (!hs::takes(T, C, H)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const hs::BwdWork w = hs::bwd_work(T, C, H, false);
  float* g = hs::at<float>(work, w.g);
  float* dh = hs::at<float>(work, w.dh);
  float* part = hs::at<float>(work, w.part);
  const float* xf = static_cast<const float*>(x);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* w2f = static_cast<const float*>(w2);
  const float* dof = static_cast<const float*>(dout);
  cudaError_t e = approximate != 0
      ? hs::dual_f32<true>(xf, w1f, b1f, dof, w2f, g, dh, part, w.ld_part, T, C, H, s)
      : hs::dual_f32<false>(xf, w1f, b1f, dof, w2f, g, dh, part, w.ld_part, T, C, H, s);
  if (e == cudaSuccess)
    e = hs::wg_nt<hs::WgEpiStore<false>>(dh, w1f, static_cast<float*>(dx), nullptr, T, C, H,
                                         s);
  if (e == cudaSuccess)
    e = hs::wg_tn(g, dof, dh, xf, static_cast<float*>(dw), T, H, C, 2,
                  hs::at<float>(work, w.tn), s);
  if (e == cudaSuccess)
    e = hs::reduce_rows(part, static_cast<float*>(red), hs::row_blocks(T), w.ld_part,
                        hs::at<float>(work, w.tmp), s);
  return int(e);
}

size_t hs_mlp_block_bwd_f32_workspace(int T, int C, int H) {
  return hs::bwd_work(T, C, H, true).total;
}

// f32 K15: dx (T x C), dw = [dW2 | dW1] and red = [db1 (H) | db2 | dgamma | dbeta (C each)]
int hs_mlp_block_bwd_f32(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* b2, const void* gamma, const void* beta,
                         const void* dscale, const void* dz, void* dx, void* dw, void* red,
                         void* work, int T, int C, int H, int approximate, int has_dscale,
                         float ln_eps, void* stream) {
  (void)beta;  // beta does not enter the backward
  if (!hs::takes(T, C, H)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const hs::BwdWork w = hs::bwd_work(T, C, H, true);
  float* g = hs::at<float>(work, w.g);
  float* dh = hs::at<float>(work, w.dh);
  float* u = hs::at<float>(work, w.u);
  float* part = hs::at<float>(work, w.part);
  const float* xf = static_cast<const float*>(x);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* w2f = static_cast<const float*>(w2);
  const float* dzf = static_cast<const float*>(dz);
  const bool approx = approximate != 0;
  cudaError_t e = approx  // dh holds GELU'(h) until step (4) writes dh over it
      ? hs::wg_nn<hs::WgEpiGelu<true>>(xf, w1f, b1f, g, dh, T, H, C, s)
      : hs::wg_nn<hs::WgEpiGelu<false>>(xf, w1f, b1f, g, dh, T, H, C, s);
  if (e == cudaSuccess)
    e = hs::wg_nn<hs::WgEpiStore<false>>(g, w2f, static_cast<const float*>(b2), u, nullptr, T,
                                         C, H, s);
  if (e == cudaSuccess)
    e = hs::by_width<hs::LnBwd>(C, static_cast<const float*>(u), dzf,
                                static_cast<const float*>(gamma),
                                has_dscale ? static_cast<const float*>(dscale) : nullptr, u,
                                part, T, C, w.ld_part, H, ln_eps, s);
  if (e == cudaSuccess) e = hs::dh_from_grad_f32(u, w2f, dh, part, w.ld_part, T, C, H, s);
  if (e == cudaSuccess)
    e = hs::reduce_rows(part, static_cast<float*>(red), hs::row_blocks(T), w.ld_part,
                        hs::at<float>(work, w.tmp), s);
  if (e == cudaSuccess)
    e = hs::wg_nt<hs::WgEpiStore<true>>(dh, w1f, static_cast<float*>(dx),
                                        const_cast<float*>(dzf), T, C, H, s);
  if (e == cudaSuccess)
    e = hs::wg_tn(g, u, dh, xf, static_cast<float*>(dw), T, H, C, 2,
                  hs::at<float>(work, w.tn), s);
  return int(e);
}

// --- the sequences' own steps alone, for their checks against their plain twins (no
// launch of their own on the main path)

// K12's step (1): g = GELU(x W1 + b1), (T x H) f32
int hs_mlp_hidden_f32(const void* x, const void* w1, const void* b1, void* g, int T, int C,
                      int H, int approximate, void* stream) {
  if (!hs::takes(T, C, H)) return int(cudaErrorInvalidValue);
  return int(hs::hidden_f32(static_cast<const float*>(x), static_cast<const float*>(w1),
                            static_cast<const float*>(b1), static_cast<float*>(g), T, C, H,
                            approximate != 0, static_cast<cudaStream_t>(stream)));
}

// the dual product's workspace: the row blocks' partial rows and their reduction's scratch
size_t hs_mlp_dual_f32_workspace(int T, int C, int H) {
  const int rb = hs::row_blocks(T);
  return hs::align128(size_t(rb) * (H + C) * 4) +
         hs::align128(hs::reduce_rows_tmp_floats(rb, H + C) * 4);
}

// K13's step (1), the dual product: g = GELU(x W1 + b1), dh = (dout W2^T) GELU'(x W1 + b1)
// (T x H each) and red = [db1 (H) | db2 (C)]
int hs_mlp_dual_f32(const void* x, const void* w1, const void* b1, const void* w2,
                    const void* dout, void* g, void* dh, void* red, void* work, int T, int C,
                    int H, int approximate, void* stream) {
  if (!hs::takes(T, C, H)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rb = hs::row_blocks(T);
  float* part = static_cast<float*>(work);
  const float* xf = static_cast<const float*>(x);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* w2f = static_cast<const float*>(w2);
  const float* dof = static_cast<const float*>(dout);
  float* gf = static_cast<float*>(g);
  float* dhf = static_cast<float*>(dh);
  cudaError_t e = approximate != 0
      ? hs::dual_f32<true>(xf, w1f, b1f, dof, w2f, gf, dhf, part, H + C, T, C, H, s)
      : hs::dual_f32<false>(xf, w1f, b1f, dof, w2f, gf, dhf, part, H + C, T, C, H, s);
  if (e != cudaSuccess) return int(e);
  return int(hs::reduce_rows(part, static_cast<float*>(red), rb, H + C,
                             hs::at<float>(work, hs::align128(size_t(rb) * (H + C) * 4)), s));
}

// the wgmma core's products alone: layout 0 NN (A M x K, B K x N), 1 NT (B N x K), 2 TN
// (A K x M, B K x N, split over K and reduced); the workspace is the TN product's
size_t hs_gemm_wg_f32_workspace(int M, int N, int K, int layout) {
  return layout == 2 ? hs::align128(hs::wg_tn_tmp_floats(K, M, N, 1) * 4) : 0;
}

int hs_gemm_wg_f32(const void* A, const void* B, void* out, void* work, int M, int N, int K,
                   int layout, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(B);
  float* o = static_cast<float*>(out);
  switch (layout) {
    case 0: return int(hs::wg_nn<hs::WgEpiStore<false>>(af, bf, nullptr, o, nullptr, M, N, K, s));
    case 1: return int(hs::wg_nt<hs::WgEpiStore<false>>(af, bf, o, nullptr, M, N, K, s));
    case 2:
      return int(hs::wg_tn(af, bf, nullptr, nullptr, o, K, M, N, 1, static_cast<float*>(work), s));
    default: return int(cudaErrorInvalidValue);
  }
}

// K14's step (3): out = x + dscale (LN(u) gamma + beta) (out may be u)
int hs_mlp_block_ln_f32(const void* u, const void* x, const void* gamma, const void* beta,
                        const void* dscale, void* out, int T, int C, float ln_eps,
                        void* stream) {
  if (!hs::takes(T, C, 32)) return int(cudaErrorInvalidValue);
  return int(hs::by_width<hs::LnFwd>(
      C, static_cast<const float*>(u), static_cast<const float*>(x),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(dscale), static_cast<float*>(out), T, C, ln_eps,
      static_cast<cudaStream_t>(stream)));
}

size_t hs_mlp_block_ln_bwd_f32_workspace(int T, int C) {
  const int rb = hs::row_blocks(T);
  return hs::align128(size_t(rb) * 3 * C * 4) +
         hs::align128(hs::reduce_rows_tmp_floats(rb, 3 * C) * 4);
}

// K15's step (3): du (may be u) and red = [db2 | dgamma | dbeta]
int hs_mlp_block_ln_bwd_f32(const void* u, const void* dz, const void* gamma,
                            const void* dscale, void* du, void* red, void* work, int T, int C,
                            float ln_eps, void* stream) {
  if (!hs::takes(T, C, 32)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rb = hs::row_blocks(T);
  float* part = static_cast<float*>(work);
  const cudaError_t e = hs::by_width<hs::LnBwd>(
      C, static_cast<const float*>(u), static_cast<const float*>(dz),
      static_cast<const float*>(gamma), static_cast<const float*>(dscale),
      static_cast<float*>(du), part, T, C, 3 * C, 0, ln_eps, s);
  if (e != cudaSuccess) return int(e);
  return int(hs::reduce_rows(part, static_cast<float*>(red), rb, 3 * C,
                             hs::at<float>(work, hs::align128(size_t(rb) * 3 * C * 4)), s));
}

}  // extern "C"
