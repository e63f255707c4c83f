// Window attention of HEAL-SWIN for Hopper (sm_90a) in float32, forward only, for the
// configs that compute in f32 (the paper run configs: dtype None) at eval and predict.
//
// Replaces, in f32, two Pallas TPU kernels of heal_swin_tpu/ops/window_attention.py:
//   K1 hs_window_attention_qkv_epi_f32  <- _fwd_kernel_xw_epi (fused_window_attention_qkv_epi,
//      x f32): x @ Wqkv + b -> cosine attention (rel-pos bias, -100 group mask, f32
//      softmax) -> @ Wp + bp -> optional LayerNorm.
//   K2 hs_window_attention_f32          <- _fwd_kernel / _attn_fwd_body (fused_window_attention,
//      qkv f32): attention from precomputed qkv rows, cosine or scaled-dot.
// With f32 operands every cast of the Pallas bodies is the identity, so nothing is rounded
// below f32 (window_attention_plain and window_attention_qkv_epi_plain run in f32).
//
// Why f32 FMAs on the CUDA cores and not the tensor cores: the cosine logit scale (up to
// 100) multiplies every error of q_hat . k_hat, and one TF32 pass (~5e-4 relative a
// product) would move a logit by ~0.05, far over the 1e-5 the kernels are held to.
//
// What bounds them.  K1 does 512 C^2 + 16384 C FLOPs a window (the two projections and
// the two attention products) on 512 C bytes of f32 activations in and out: bounded by
// the arithmetic.  In f32 its operands do not fit a block: a 64-token x tile at C 384 is
// 98,304 bytes, the o tile as much, one head's Wqkv columns (C x 96) 147,456.  So K1 is
// a launch sequence from one entry, each step simple and bounded by its own arithmetic:
//   1. gemm_nn_f32: qkv = x Wqkv + bqkv, (T, 3C) f32 into the workspace;
//   2. attn_f32_kernel (K2's kernel, cosine): o (T, C) f32 into the workspace;
//   3. gemm_nn_f32: u = o Wp + bp, into the output;
//   4. ln_rows_f32 (with LayerNorm): the output's rows normalized in place, f32
//      two-pass statistics.
// The workspace is 16 T C bytes (qkv, o).  K2 moves 16 T C bytes (qkv in, o out) for
// 16384 C FLOPs a window, 32 FLOP/byte: bounded by memory and latency.
//
// attn_f32_kernel: one block of 64 threads per (window, head), a thread per query row.
// The thread loads its q, k, v rows (float4), normalizes q and k (cosine: rsqrt of the
// clamped sum of squares; q times rsqrt * scale, as the plain version), writes k_hat and
// v to shared memory, and after one barrier holds its 64 scores in registers: the dot
// products over k_hat's rows by broadcast (every thread of a warp reads the same row),
// [* sm_scale,] + bias, + -100 where the group ids differ; softmax with the row max as
// the shift (shift-invariant; the plain version's and the bf16 kernels' choice) and
// e / max(sum e, 1e-30); o = sum_j p_j v_j over v's rows by broadcast.  Explicit
// __fmul_rn / __fadd_rn / __fdiv_rn where the plain version's order is a separate
// rounding, so that nvcc contracts nothing there.
//
// gemm_nn_f32: 64 x 64 output tiles, 256 threads each with 4 x 4 outputs, the A and B
// slices of 16 k staged in shared memory (A transposed), f32 FMAs in ascending k, the
// bias added after the sum (the plain version's matmul, then + b).

#include <math_constants.h>

#include "common.cuh"

namespace hs {
namespace {

constexpr int LDK = HD + 4;  // f32 k_hat / v rows in shared memory: float4-aligned

__global__ void __launch_bounds__(WS)
attn_f32_kernel(const float* __restrict__ qkv, const int* __restrict__ groups,
                const float* __restrict__ bias, const float* __restrict__ lscale,
                float* __restrict__ out, int C, int use_cos, int has_mask, float sm_scale) {
  __shared__ __align__(16) float ks[WS * LDK];
  __shared__ __align__(16) float vs[WS * LDK];
  __shared__ int gs[WS];
  const int head = blockIdx.y, r = threadIdx.x;
  const size_t tok = size_t(blockIdx.x) * WS + r;
  const float4* row = reinterpret_cast<const float4*>(qkv + tok * 3 * C + head * HD);
  const int C4 = C / 4;
  float q[HD], k[HD];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) {
    const float4 a = row[i], b = row[C4 + i];
    q[4 * i] = a.x; q[4 * i + 1] = a.y; q[4 * i + 2] = a.z; q[4 * i + 3] = a.w;
    k[4 * i] = b.x; k[4 * i + 1] = b.y; k[4 * i + 2] = b.z; k[4 * i + 3] = b.w;
    reinterpret_cast<float4*>(vs + r * LDK)[i] = row[2 * C4 + i];
  }
  if (use_cos) {
    float sq = 0.f, sk = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      sq = fmaf(q[d], q[d], sq);
      sk = fmaf(k[d], k[d], sk);
    }
    // q * (rsqrt(|q|^2) * scale) and k * rsqrt(|k|^2), each product one rounding
    const float mq = __fmul_rn(rsqrtf(fmaxf(sq, 1e-24f)), lscale[head]);
    const float ik = rsqrtf(fmaxf(sk, 1e-24f));
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      q[d] = __fmul_rn(q[d], mq);
      k[d] = __fmul_rn(k[d], ik);
    }
  }
#pragma unroll
  for (int i = 0; i < HD / 4; ++i)
    reinterpret_cast<float4*>(ks + r * LDK)[i] =
        make_float4(k[4 * i], k[4 * i + 1], k[4 * i + 2], k[4 * i + 3]);
  const bool masked = has_mask != 0;
  if (masked) gs[r] = groups[tok];
  __syncthreads();

  const float4* brow = reinterpret_cast<const float4*>(bias + (size_t(head) * WS + r) * WS);
  const int gr = masked ? gs[r] : 0;
  float s[WS];
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int j4 = 0; j4 < WS / 4; ++j4) {
    const float4 b4 = brow[j4];
    const float bj[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * j4 + jj;
      const float4* kr = reinterpret_cast<const float4*>(ks + j * LDK);
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < HD / 4; ++i) {
        const float4 v = kr[i];
        a = fmaf(q[4 * i], v.x, a);
        a = fmaf(q[4 * i + 1], v.y, a);
        a = fmaf(q[4 * i + 2], v.z, a);
        a = fmaf(q[4 * i + 3], v.w, a);
      }
      if (!use_cos) a = __fmul_rn(a, sm_scale);
      a = __fadd_rn(a, bj[jj]);
      if (masked && gs[j] != gr) a = __fadd_rn(a, MASK_VALUE);
      s[j] = a;
      mx = fmaxf(mx, a);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < WS; ++j) {
    s[j] = expf(__fsub_rn(s[j], mx));
    sum = __fadd_rn(sum, s[j]);
  }
  const float den = fmaxf(sum, 1e-30f);
  float o[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.f;
#pragma unroll
  for (int j = 0; j < WS; ++j) {
    const float p = __fdiv_rn(s[j], den);
    const float4* vr = reinterpret_cast<const float4*>(vs + j * LDK);
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) {
      const float4 v = vr[i];
      o[4 * i] = fmaf(p, v.x, o[4 * i]);
      o[4 * i + 1] = fmaf(p, v.y, o[4 * i + 1]);
      o[4 * i + 2] = fmaf(p, v.z, o[4 * i + 2]);
      o[4 * i + 3] = fmaf(p, v.w, o[4 * i + 3]);
    }
  }
  float4* orow = reinterpret_cast<float4*>(out + tok * C + head * HD);
#pragma unroll
  for (int i = 0; i < HD / 4; ++i)
    orow[i] = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
}

cudaError_t attention_f32(const float* qkv, const int* groups, const float* bias,
                          const float* lscale, float* out, int T, int C, int use_cos,
                          int has_mask, float sm_scale, cudaStream_t s) {
  if (T % WS || T <= 0 || C % HD || C <= 0) return cudaErrorInvalidValue;
  attn_f32_kernel<<<dim3(T / WS, C / HD), WS, 0, s>>>(qkv, groups, bias, lscale, out, C,
                                                      use_cos, has_mask, sm_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------------
// gemm_nn_f32: out (M x N) = A (M x K) B (K x N) [+ bias (N)], row-major f32; M % 64 == 0,
// K % 16 == 0, N % 4 == 0.  Grid (M / 64, ceil(N / 64)).
// ---------------------------------------------------------------------------------
constexpr int GN_T = 64;
constexpr int GN_K = 16;
constexpr int GN_THREADS = 256;

__global__ void __launch_bounds__(GN_THREADS)
gemm_nn_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ bias, float* __restrict__ out, int M, int N,
                   int K) {
  __shared__ __align__(16) float As[GN_K * GN_T];  // [k][m]
  __shared__ __align__(16) float Bs[GN_K * GN_T];  // [k][n]
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // outputs: rows m0 + 4 ty .., columns n0 + 4 tx ..
  const int m0 = blockIdx.x * GN_T, n0 = blockIdx.y * GN_T;
  const int ar = tid >> 2, ak = (tid & 3) * 4;    // A: row m0 + ar, k .. k + 3
  const int br = tid >> 4, bn = (tid & 15) * 4;   // B: row k + br, columns n0 + bn ..
  const bool b_in = n0 + bn < N;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int k0 = 0; k0 < K; k0 += GN_K) {
    const float4 va = *reinterpret_cast<const float4*>(A + size_t(m0 + ar) * K + k0 + ak);
    const float4 vb = b_in ? *reinterpret_cast<const float4*>(B + size_t(k0 + br) * N + n0 + bn)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    As[(ak + 0) * GN_T + ar] = va.x;
    As[(ak + 1) * GN_T + ar] = va.y;
    As[(ak + 2) * GN_T + ar] = va.z;
    As[(ak + 3) * GN_T + ar] = va.w;
    *reinterpret_cast<float4*>(Bs + br * GN_T + bn) = vb;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GN_K; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(As + kk * GN_T + 4 * ty);
      const float4 b4 = *reinterpret_cast<const float4*>(Bs + kk * GN_T + 4 * tx);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
  const int n = n0 + 4 * tx;
  if (n >= N) return;
  float4 bb = make_float4(0.f, 0.f, 0.f, 0.f);
  if (bias != nullptr) bb = *reinterpret_cast<const float4*>(bias + n);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int m = m0 + 4 * ty + a;
    *reinterpret_cast<float4*>(out + size_t(m) * N + n) =
        make_float4(__fadd_rn(acc[a][0], bb.x), __fadd_rn(acc[a][1], bb.y),
                    __fadd_rn(acc[a][2], bb.z), __fadd_rn(acc[a][3], bb.w));
  }
}

cudaError_t gemm_nn_f32(const float* A, const float* B, const float* bias, float* out, int M,
                        int N, int K, cudaStream_t s) {
  if (M % GN_T || K % GN_K || N % 4 || M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const dim3 grid(M / GN_T, (N + GN_T - 1) / GN_T);
  gemm_nn_f32_kernel<<<grid, GN_THREADS, 0, s>>>(A, B, bias, out, M, N, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------------
// ln_rows_f32: each row of u (T x C, C % 32 == 0, C <= 32 kLnMaxPer = 384) LayerNormed in place,
// a warp per row: mean, then the mean of the squared deviations from the held values,
// y = (u - mean) * rstd * gamma + beta with each product and the sum one rounding, as
// the plain version's _ln_f32.
// ---------------------------------------------------------------------------------
constexpr int kLnMaxPer = 12;  // C <= 384

__global__ void __launch_bounds__(256)
ln_rows_f32_kernel(float* __restrict__ u, const float* __restrict__ gamma,
                   const float* __restrict__ beta, int T, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= T) return;
  float* ur = u + size_t(row) * C;
  const int per = C / 32;
  float v[kLnMaxPer];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxPer; ++i)
    if (i < per) {
      v[i] = ur[lane + 32 * i];
      s += v[i];
    }
  const float mean = __fdiv_rn(warp_sum(s), float(C));
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxPer; ++i)
    if (i < per) {
      v[i] = __fsub_rn(v[i], mean);
      sq = fmaf(v[i], v[i], sq);
    }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), float(C)), eps));
#pragma unroll
  for (int i = 0; i < kLnMaxPer; ++i)
    if (i < per) {
      const int c = lane + 32 * i;
      ur[c] = __fadd_rn(__fmul_rn(__fmul_rn(v[i], rstd), gamma[c]), beta[c]);
    }
}

}  // namespace
}  // namespace hs

extern "C" {

// f32 K1's workspace: qkv (T x 3C) and o (T x C), f32
size_t hs_window_attention_qkv_epi_f32_workspace(int T, int C) {
  return hs::align128(size_t(T) * 3 * C * 4) + hs::align128(size_t(T) * C * 4);
}

// f32 K1: gemm_nn_f32 (qkv), attn_f32_kernel (cosine), gemm_nn_f32 (u = o Wp + bp), then
// with has_ln ln_rows_f32 in place, on one stream; every operand f32 but the group ids
int hs_window_attention_qkv_epi_f32(const void* x, const void* wqkv, const void* bqkv,
                                    const void* wp, const void* bp, const void* ln_g,
                                    const void* ln_b, const void* groups, const void* bias,
                                    const void* lscale, void* out, void* work, int T, int C,
                                    int has_ln, int has_mask, float ln_eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % hs::HD || C > 32 * hs::kLnMaxPer || T % hs::WS) return int(cudaErrorInvalidValue);
  float* qkv = static_cast<float*>(work);
  float* o = reinterpret_cast<float*>(static_cast<unsigned char*>(work) +
                                      hs::align128(size_t(T) * 3 * C * 4));
  cudaError_t e = hs::gemm_nn_f32(static_cast<const float*>(x), static_cast<const float*>(wqkv),
                                  static_cast<const float*>(bqkv), qkv, T, 3 * C, C, s);
  if (e != cudaSuccess) return int(e);
  e = hs::attention_f32(qkv, static_cast<const int*>(groups), static_cast<const float*>(bias),
                        static_cast<const float*>(lscale), o, T, C, 1, has_mask, 1.f, s);
  if (e != cudaSuccess) return int(e);
  e = hs::gemm_nn_f32(o, static_cast<const float*>(wp), static_cast<const float*>(bp),
                      static_cast<float*>(out), T, C, C, s);
  if (e != cudaSuccess || !has_ln) return int(e);
  hs::ln_rows_f32_kernel<<<(T + 7) / 8, 256, 0, s>>>(
      static_cast<float*>(out), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), T, C, ln_eps);
  return int(cudaGetLastError());
}

// f32 K2: attention from f32 qkv rows (T, 3C) -> (T, C) f32, cosine or scaled-dot
int hs_window_attention_f32(const void* qkv, const void* groups, const void* bias,
                            const void* lscale, void* out, int T, int C, int use_cos,
                            int has_mask, float sm_scale, void* stream) {
  return int(hs::attention_f32(static_cast<const float*>(qkv), static_cast<const int*>(groups),
                               static_cast<const float*>(bias),
                               static_cast<const float*>(lscale), static_cast<float*>(out), T,
                               C, use_cos, has_mask, sm_scale,
                               static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
