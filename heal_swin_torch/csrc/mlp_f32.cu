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
// Each is a launch sequence from one entry, on one stream, of the 3xTF32 products of
// attention_f32.cuh (gemm_3xtf32_kernel NN / NT / TN on mma.sync m16n8k8, each 32-k slice
// summed in a zeroed accumulator), with this file's epilogues, two LayerNorm row kernels
// and reduce_rows (reduce.cu):
//   K12: (1) NN x W1 + b1, epilogue EpiGelu: g = GELU(h) (T x H, the workspace);
//        (2) NN g W2 + b2 -> out.
//   K14: K12's (1) and (2) into out, then (3) mlp_ln_fwd_f32_kernel: out = x + dscale
//        (LN(u) gamma + beta), in place.
//   K13: (1) NN with EpiGelu writing h too; (2) NT dout W2^T, epilogue EpiDGelu: dh =
//        dg GELU'(h), over h; (3) NT dh W1^T -> dx; (4) TN x^T dh -> dW1 (split over the
//        tokens into partial matrices, summed by reduce_rows in a fixed order) and
//        reduce_rows of dh -> db1; (5) TN g^T dout -> dW2 and reduce_rows of dout -> db2.
//   K15: K13's (1); (2) NN g W2 + b2 -> u (T x C, the workspace); (3)
//        mlp_ln_bwd_f32_kernel: du over u, and a partial row of [db2 | dgamma | dbeta]
//        per 64 rows, then reduce_rows; (4) NT du W2^T with EpiDGelu -> dh over h; (5) NT
//        dh W1^T, epilogue EpiResidual: dx = dz + dh W1^T; (6) TN x^T dh -> dW1,
//        reduce_rows -> db1, TN g^T du -> dW2.
// The workspace holds the hidden in f32: g (K12, K14), h / dh and g (K13, K15), 4 T H
// bytes each (402,653,184 at the paper's stage 0, T 262,144 and H 384), and for K15 u /
// du (4 T C), the row kernel's partial rows and the TN products' and reductions' scratch.
// No float atomics: two launches give the same bits.
//
// What bounds them: a product is 2 T C H FLOP on 4 T (C + H) bytes, H = 4C: 8 C / 5
// FLOP a byte, 154 at C 96, under the 3xTF32 ridge (164.9 TFLOPS over 3.35 TB/s, ~49)
// only below C 31: the products decide, K12 and K14 two of them, K13 five, K15 six (at
// every stage T C^2 = 2.416e9: 38.65 / 96.6 / 116 GFLOP, 0.234 / 0.586 / 0.703 ms).  The
// sequence moves the (T, H) hidden through device memory, 4 T H bytes a pass, ~8 passes
// in K13 (3.2 GB at stage 0, ~1 ms): a fused f32 row core (the hidden kept on chip, as
// the bf16 kernels keep it) is the remedy, left for a later change.

#include "attention_f32.cuh"
#include "mlp_core.cuh"

namespace hs {
namespace {

constexpr int kMaxC = 768;
constexpr int kMlpLnRows = 64;  // rows a block of the LayerNorm backward, 8 a warp

// ---------------------------------------------------------------------------------
// Epilogues of gemm_3xtf32_kernel (attention_f32.cuh EpiBias's protocol): the pair at
// out[i], out[i + 1] from the sums a0, a1 and the bias pair b (zero without a bias).
// ---------------------------------------------------------------------------------

// h = a + b1, written to aux when aux is not null; out = GELU(h)
template <bool APPROX>
struct EpiGelu {
  __device__ __forceinline__ static void store(float* out, float* aux, size_t i, float a0,
                                               float a1, float2 b) {
    const float h0 = __fadd_rn(a0, b.x), h1 = __fadd_rn(a1, b.y);
    if (aux != nullptr) *reinterpret_cast<float2*>(aux + i) = make_float2(h0, h1);
    *reinterpret_cast<float2*>(out + i) =
        make_float2(gelu_of(h0, gelu_t<APPROX>(h0)), gelu_of(h1, gelu_t<APPROX>(h1)));
  }
};

// dh = a GELU'(h), h read from aux; out may be aux (each pair is read, then written, by
// the same thread)
template <bool APPROX>
struct EpiDGelu {
  __device__ __forceinline__ static void store(float* out, float* aux, size_t i, float a0,
                                               float a1, float2 b) {
    (void)b;
    const float2 h = *reinterpret_cast<const float2*>(aux + i);
    *reinterpret_cast<float2*>(out + i) =
        make_float2(a0 * gelu_grad_of<APPROX>(h.x, gelu_t<APPROX>(h.x)),
                    a1 * gelu_grad_of<APPROX>(h.y, gelu_t<APPROX>(h.y)));
  }
};

// out = aux + a: the residual added after the sum
struct EpiResidual {
  __device__ __forceinline__ static void store(float* out, float* aux, size_t i, float a0,
                                               float a1, float2 b) {
    (void)b;
    const float2 r = *reinterpret_cast<const float2*>(aux + i);
    *reinterpret_cast<float2*>(out + i) = make_float2(__fadd_rn(r.x, a0), __fadd_rn(r.y, a1));
  }
};

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
// mlp_ln_bwd_f32_kernel<P>: K15's LayerNorm backward, a warp a row, 8 rows a warp and
// kMlpLnRows a block: u's statistics as K14 takes them, xhat, dy = dz dscale, then du =
// rstd (dy gamma - mean(dy gamma) - xhat mean(dy gamma xhat)) written over u (du may be
// u), and the block's column sums of du (db2), dy xhat (dgamma) and dy (dbeta) as one
// partial row [db2 | dgamma | dbeta], each column summed over the 8 warps in order.
// ---------------------------------------------------------------------------------
template <int P>
__global__ void __launch_bounds__(kThreads)
mlp_ln_bwd_f32_kernel(const float* u, const float* __restrict__ dz,
                      const float* __restrict__ gamma, const float* __restrict__ dscale,
                      float* du, float* __restrict__ part, int C, float eps) {
  __shared__ float cols[kWarps][3][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = C / 32;
  float sb[P], sg[P], sz[P];
#pragma unroll
  for (int i = 0; i < P; ++i) sb[i] = sg[i] = sz[i] = 0.f;
  for (int rr = 0; rr < kMlpLnRows / kWarps; ++rr) {
    const size_t row = size_t(blockIdx.x) * kMlpLnRows + warp * (kMlpLnRows / kWarps) + rr;
    const size_t off = row * C;
    const float ds = dscale != nullptr ? dscale[row] : 1.f;
    float v[P], z[P];
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (i < per) {
        v[i] = u[off + lane + 32 * i];
        z[i] = dz[off + lane + 32 * i];
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
        du[off + lane + 32 * i] = d;
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
      part[size_t(blockIdx.x) * 3 * C + size_t(k) * C + 32 * i + l] = s;
    }
    __syncthreads();
  }
}

inline bool takes(int T, int C, int H) {
  return T > 0 && T % kMlpLnRows == 0 && C > 0 && C % 32 == 0 && C <= kMaxC && H > 0 &&
         H % 32 == 0;
}

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
                         const float* dscale, float* du, float* part, int T, int C, float eps,
                         cudaStream_t s) {
    mlp_ln_bwd_f32_kernel<P><<<T / kMlpLnRows, kThreads, 0, s>>>(u, dz, gamma, dscale, du,
                                                                  part, C, eps);
    return cudaGetLastError();
  }
};

// K13's and K15's step (1): h = x W1 + b1 into h (unless null) and g = GELU(h), (T x H)
cudaError_t hidden_f32(const float* x, const float* w1, const float* b1, float* h, float* g,
                       int T, int C, int H, bool approx, cudaStream_t s) {
  return approx ? gemm_nn_f32<EpiGelu<true>>(x, w1, b1, g, T, H, C, s, h)
                : gemm_nn_f32<EpiGelu<false>>(x, w1, b1, g, T, H, C, s, h);
}

// K13's step (2), K15's (4): dh = (dout W2^T) GELU'(h), W2 (H x C); dh may be h
cudaError_t dh_f32(const float* dout, const float* w2, float* h, float* dh, int T, int C,
                   int H, bool approx, cudaStream_t s) {
  return approx ? gemm_nt_f32<EpiDGelu<true>>(dout, w2, dh, T, H, C, s, h)
                : gemm_nt_f32<EpiDGelu<false>>(dout, w2, dh, T, H, C, s, h);
}

// the LayerNorm backward and its partial rows' reduction into red = [db2 | dgamma |
// dbeta]; part holds T / kMlpLnRows rows of 3C floats, tmp reduce_rows' scratch
cudaError_t ln_bwd_f32(const float* u, const float* dz, const float* gamma, const float* dscale,
                       float* du, float* part, float* red, float* tmp, int T, int C, float eps,
                       cudaStream_t s) {
  const cudaError_t e = by_width<LnBwd>(C, u, dz, gamma, dscale, du, part, T, C, eps, s);
  if (e != cudaSuccess) return e;
  return reduce_rows(part, red, T / kMlpLnRows, 3 * C, tmp, s);
}

size_t max3(size_t a, size_t b, size_t c) { return a > b ? (a > c ? a : c) : (b > c ? b : c); }

// the backward's workspace: h / dh and g (T x H); with the branch u / du (T x C) and the
// row kernel's partial rows; the TN products' and the reductions' scratch
struct BwdWork {
  size_t h, g, u, part, tmp, total;
};

inline BwdWork bwd_work(int T, int C, int H, bool block) {
  BwdWork w;
  size_t tmp = max3(gemm_tn_f32_tmp_floats(T, C, H), gemm_tn_f32_tmp_floats(T, H, C),
                    max3(reduce_rows_tmp_floats(T, H), reduce_rows_tmp_floats(T, C),
                         block ? reduce_rows_tmp_floats(T / kMlpLnRows, 3 * C) : 0));
  const size_t hid = align128(size_t(T) * H * 4);
  size_t off = 0;
  w.h = off; off += hid;
  w.g = off; off += hid;
  w.u = off; off += block ? align128(size_t(T) * C * 4) : 0;
  w.part = off; off += block ? align128(size_t(T / kMlpLnRows) * 3 * C * 4) : 0;
  w.tmp = off; off += align128(tmp * 4);
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
                                 static_cast<const float*>(b1), nullptr, g, T, C, H,
                                 approximate != 0, s);
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

// f32 K13: dx (T x C), dW1 (C x H), dW2 (H x C) and red = [db1 (H) | db2 (C)]
int hs_mlp_bwd_f32(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* dout, void* dx, void* dw1, void* dw2, void* red,
                   void* work, int T, int C, int H, int approximate, void* stream) {
  (void)b2;  // b2 does not enter the backward
  if (!hs::takes(T, C, H)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const hs::BwdWork w = hs::bwd_work(T, C, H, false);
  float* h = hs::at<float>(work, w.h);
  float* g = hs::at<float>(work, w.g);
  float* tmp = hs::at<float>(work, w.tmp);
  const float* xf = static_cast<const float*>(x);
  const float* w1f = static_cast<const float*>(w1);
  const float* dof = static_cast<const float*>(dout);
  float* redf = static_cast<float*>(red);
  const bool approx = approximate != 0;
  cudaError_t e = hs::hidden_f32(xf, w1f, static_cast<const float*>(b1), h, g, T, C, H, approx, s);
  if (e == cudaSuccess)
    e = hs::dh_f32(dof, static_cast<const float*>(w2), h, h, T, C, H, approx, s);
  if (e == cudaSuccess) e = hs::gemm_nt_f32(h, w1f, static_cast<float*>(dx), T, C, H, s);
  if (e == cudaSuccess) e = hs::gemm_tn_f32(xf, h, static_cast<float*>(dw1), T, C, H, tmp, s);
  if (e == cudaSuccess) e = hs::reduce_rows(h, redf, T, H, tmp, s);
  if (e == cudaSuccess) e = hs::gemm_tn_f32(g, dof, static_cast<float*>(dw2), T, H, C, tmp, s);
  if (e == cudaSuccess) e = hs::reduce_rows(dof, redf + H, T, C, tmp, s);
  return int(e);
}

size_t hs_mlp_block_bwd_f32_workspace(int T, int C, int H) {
  return hs::bwd_work(T, C, H, true).total;
}

// f32 K15: dx (T x C), dW1, dW2 and red = [db1 (H) | db2 | dgamma | dbeta (C each)]
int hs_mlp_block_bwd_f32(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* b2, const void* gamma, const void* beta,
                         const void* dscale, const void* dz, void* dx, void* dw1, void* dw2,
                         void* red, void* work, int T, int C, int H, int approximate,
                         int has_dscale, float ln_eps, void* stream) {
  (void)beta;  // beta does not enter the backward
  if (!hs::takes(T, C, H)) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const hs::BwdWork w = hs::bwd_work(T, C, H, true);
  float* h = hs::at<float>(work, w.h);
  float* g = hs::at<float>(work, w.g);
  float* u = hs::at<float>(work, w.u);
  float* part = hs::at<float>(work, w.part);
  float* tmp = hs::at<float>(work, w.tmp);
  const float* xf = static_cast<const float*>(x);
  const float* w1f = static_cast<const float*>(w1);
  const float* w2f = static_cast<const float*>(w2);
  const float* dzf = static_cast<const float*>(dz);
  float* redf = static_cast<float*>(red);
  const bool approx = approximate != 0;
  cudaError_t e = hs::hidden_f32(xf, w1f, static_cast<const float*>(b1), h, g, T, C, H, approx, s);
  if (e == cudaSuccess)
    e = hs::gemm_nn_f32(g, w2f, static_cast<const float*>(b2), u, T, C, H, s);
  if (e == cudaSuccess)
    e = hs::ln_bwd_f32(u, dzf, static_cast<const float*>(gamma),
                       has_dscale ? static_cast<const float*>(dscale) : nullptr, u, part,
                       redf + H, tmp, T, C, ln_eps, s);
  if (e == cudaSuccess) e = hs::dh_f32(u, w2f, h, h, T, C, H, approx, s);
  if (e == cudaSuccess)
    e = hs::gemm_nt_f32<hs::EpiResidual>(h, w1f, static_cast<float*>(dx), T, C, H, s,
                                         const_cast<float*>(dzf));
  if (e == cudaSuccess) e = hs::gemm_tn_f32(xf, h, static_cast<float*>(dw1), T, C, H, tmp, s);
  if (e == cudaSuccess) e = hs::reduce_rows(h, redf, T, H, tmp, s);
  if (e == cudaSuccess) e = hs::gemm_tn_f32(g, u, static_cast<float*>(dw2), T, H, C, tmp, s);
  return int(e);
}

// --- the sequences' own steps alone, for their checks against their plain twins (no
// launch of their own on the main path)

// step (1): h (unless null) and g = GELU(h), (T x H) f32
int hs_mlp_hidden_f32(const void* x, const void* w1, const void* b1, void* h, void* g, int T,
                      int C, int H, int approximate, void* stream) {
  if (!hs::takes(T, C, H)) return int(cudaErrorInvalidValue);
  return int(hs::hidden_f32(static_cast<const float*>(x), static_cast<const float*>(w1),
                            static_cast<const float*>(b1), static_cast<float*>(h),
                            static_cast<float*>(g), T, C, H, approximate != 0,
                            static_cast<cudaStream_t>(stream)));
}

// the GELU-gradient product: dh = (dout W2^T) GELU'(h) (dh may be h)
int hs_mlp_dh_f32(const void* dout, const void* w2, void* h, void* dh, int T, int C, int H,
                  int approximate, void* stream) {
  if (!hs::takes(T, C, H)) return int(cudaErrorInvalidValue);
  return int(hs::dh_f32(static_cast<const float*>(dout), static_cast<const float*>(w2),
                        static_cast<float*>(h), static_cast<float*>(dh), T, C, H,
                        approximate != 0, static_cast<cudaStream_t>(stream)));
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
  return hs::align128(size_t(T / hs::kMlpLnRows) * 3 * C * 4) +
         hs::align128(hs::reduce_rows_tmp_floats(T / hs::kMlpLnRows, 3 * C) * 4);
}

// K15's step (3): du (may be u) and red = [db2 | dgamma | dbeta]
int hs_mlp_block_ln_bwd_f32(const void* u, const void* dz, const void* gamma,
                            const void* dscale, void* du, void* red, void* work, int T, int C,
                            float ln_eps, void* stream) {
  if (!hs::takes(T, C, 32)) return int(cudaErrorInvalidValue);
  float* part = static_cast<float*>(work);
  float* tmp = hs::at<float>(work, hs::align128(size_t(T / hs::kMlpLnRows) * 3 * C * 4));
  return int(hs::ln_bwd_f32(static_cast<const float*>(u), static_cast<const float*>(dz),
                            static_cast<const float*>(gamma), static_cast<const float*>(dscale),
                            static_cast<float*>(du), part, static_cast<float*>(red), tmp, T, C,
                            ln_eps, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
