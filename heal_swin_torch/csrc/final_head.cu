// Decoder tail of HEAL-SWIN for Hopper (sm_90a): FinalPatchExpand_X4 -> LayerNorm ->
// head, fused with the argmax (serving), the weighted cross entropy (segmentation
// training) or the masked depth loss (depth training).
//
// Replaces five Pallas TPU kernels of heal_swin_tpu/ops/final_head.py:
//   K3 hs_final_head_predict         <- _pred_kernel (fused_final_head_predict)
//   K6 hs_final_head_loss            <- _fwd_kernel (fused_final_head)
//   K7 hs_final_head_loss_bwd        <- _bwd_kernel (its custom-VJP backward)
//   K8 hs_final_head_depth_loss      <- _fwd_kernel_depth (fused_final_head_depth)
//   K9 hs_final_head_depth_loss_bwd  <- _bwd_kernel_depth (its custom-VJP backward)
// For every token row x (C) and each of its p sub-pixels:
//   h_i = x @ We_i (f32 accumulation, rounded to bf16) -> LN in f32 -> z_i (bf16)
//   -> logits_i = z_i @ Wh (f32).
// K3: argmax of the f32 logits, lowest index on ties, F - 1 for a row holding a NaN;
//   (T, p) int32 class indices.
// K6: logits rounded to bf16 -> log-softmax -> sum w*nll, sum w and the (F, F)
//   confusion matrix (target rows, argmax columns; a row holding a NaN counts in no
//   cell).
// K8: F <= 2 f32 logits (mean, logvar), each a warp-reduced lane-wise product of z
//   and Wh, NOT rounded -> the masked depth loss of one kind (l2 / l1 / huber / nll)
//   against targets t (T, p) f32 whose non-finite entries mark background: an
//   invalid target is selected to 0 before the subtraction, so inf never enters the
//   arithmetic.  Sum loss, count of valid targets, and the logits rounded to bf16 as
//   the (T, p*F) predictions.
// K7: recompute the forward; dlogits = bf16((gloss/den) w (softmax - onehot)) ->
//   dWh += z^T dlogits, dz = dlogits Wh^T -> dgamma, dbeta and the LN backward dh
//   (bf16) -> dx = sum_i dh_i We_i^T; dWe_i = x^T dh_i.
// K9: the same with dlogits = (gloss/den) * dloss/dlogits in f32.
//
// What bounds it on this card: at the paper tail (T = 262144, C = 96, p = 4) each
// kernel reads 50 MB of tokens against 2*T*p*C^2 = 19 GFLOP of expand products (K7 and
// K9 twice that plus dx; the head, F = 10 for segmentation and F = 1 for depth, adds
// little): ~400 FLOP/byte, so the expand products decide, and the (T*p, F) logits and
// dlogits that the unfused tail writes and reads back never leave the SM.
//
// K6 and K7 run on the register-resident row core of tail_core.cuh: persistent blocks
// (grid = min(128-row tiles, resident blocks)), each staging the p expand slices and Wh
// once by cp.async and walking its tiles with a double-buffered cp.async ring for x; a
// warp owns 16 rows, and h, the LayerNorm, z and the logits stay in mma.sync
// accumulators and fragments.  K6 reduces each row's cross entropy, argmax and weight
// over its quad; the confusion matrix counts in a shared int array (integer atomics are
// order-free); one partial row [sum w*nll, sum w, F x F] a block.  K7 is a launch
// sequence from one entry: the row kernel (the forward recomputed through K6's
// functions, dlogits on the accumulators, dz = dlogits Wh^T by mma, dgamma and dbeta as
// column sums by shuffles into a row a warp, dh rounded to bf16 in registers and
// written to a (T, p*C) workspace, dx += dh_i We_i^T by mma in accumulators kept across
// the p slices and written once, dWh += z^T dlogits through the tile's z and dlogits in
// shared memory by ldmatrix.trans, one partial row [dWh | dgamma | dbeta] a block), then
// dWe = x^T dh by reduce.cu's gemm_tn, then reduce_rows over the partial rows.
//
// K3, K8 and K9 keep their first design: one block per 64-row tile holds all p expand
// slices We (p, C, C) bf16 and Wh in shared memory (79 KB + 4 KB at the paper widths,
// above the 48 KB default, so the launch opts in with cudaFuncSetAttribute); the expand
// products run on the tensor cores as 16x16x16 bf16 WMMA tiles with f32 accumulation,
// LN, the narrow head product and the loss run one warp per row in f32.  K9's sums
// (dWh, dgamma, dbeta) become one partial row per block; dWe = x^T dh is a split-K
// product over the tokens (reduce.cu gemm_tn) of the bf16 dh the backward leaves in a
// workspace.
//
// No atomics on floats anywhere: the sums across blocks run in a fixed order in
// reduce.cu, and the results do not change from run to run.

#include <type_traits>

#include <math_constants.h>

#include "tail_core.cuh"

namespace hs {
namespace {

constexpr int ROWS = 64;  // token rows per block

struct HeadLayout {
  size_t we, wh, x, h, total;
};

__host__ __device__ inline HeadLayout head_layout(int C, int F, int P) {
  HeadLayout L;
  const size_t ldw = size_t(C) + 8;
  size_t off = 0;
  L.we = off; off += align128(size_t(P) * C * ldw * 2);
  L.wh = off; off += align128(size_t(C) * F * 4);
  L.x = off; off += align128(ROWS * ldw * 2);
  L.h = off; off += align128(size_t(ROWS) * (C + 4) * 4);
  L.total = off;
  return L;
}

// Stage the p expand slices We (p, C, C) and this block's 64-row tile of x (bf16, rows
// padded to C + 8) and Wh (C, F, as f32) in shared memory.
__device__ __forceinline__ void stage_tail(const bf16* __restrict__ we,
                                           const bf16* __restrict__ wh,
                                           const bf16* __restrict__ x, bf16* wes, float* whs,
                                           bf16* xs, int C, int F, int P, int tile) {
  const int LDW = C + 8;
  const int chunks = C / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < P * C * chunks; idx += kThreads) {
    const int r = idx / chunks, q = idx % chunks;
    reinterpret_cast<uint4*>(wes + size_t(r) * LDW)[q] =
        reinterpret_cast<const uint4*>(we + size_t(r) * C)[q];
  }
  for (int idx = threadIdx.x; idx < C * F; idx += kThreads) whs[idx] = bf(wh[idx]);
  for (int idx = threadIdx.x; idx < ROWS * chunks; idx += kThreads) {
    const int r = idx / chunks, q = idx % chunks;
    reinterpret_cast<uint4*>(xs + r * LDW)[q] =
        reinterpret_cast<const uint4*>(x + (size_t(tile) * ROWS + r) * C)[q];
  }
}

// h (64 x C f32, row stride C + 4) = the x tile @ We_i, f32 accumulators on the tensor
// cores, one 16 x 16 output tile per warp at a time
__device__ __forceinline__ void expand_product(const bf16* xs, const bf16* wei, float* hf,
                                               int C) {
  const int LDW = C + 8;
  const int LDH = C + 4;
  const int ntiles = (ROWS / 16) * (C / 16);
  for (int t = threadIdx.x >> 5; t < ntiles; t += kWarps) {
    const int rt = t & 3, ct = t >> 2;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < C; kk += 16) {
      FragA a;
      FragB b;
      wmma::load_matrix_sync(a, xs + rt * 16 * LDW + kk, LDW);
      wmma::load_matrix_sync(b, wei + size_t(kk) * LDW + ct * 16, LDW);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(hf + rt * 16 * LDH + ct * 16, acc, LDH, wmma::mem_row_major);
  }
}

// One row in place, one warp per row: h rounded to bf16 -> LN with f32 statistics ->
// z rounded to bf16.  Every lane may read the whole row afterwards.
__device__ __forceinline__ void ln_row(float* hrow, const float* __restrict__ gamma,
                                       const float* __restrict__ beta, int C, float eps,
                                       int lane) {
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = bfr(hrow[c]);
    hrow[c] = v;
    sum += v;
  }
  const float mean = warp_sum(sum) / C;
  float sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = hrow[c] - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(warp_sum(sq) / C + eps);
  for (int c = lane; c < C; c += 32)
    hrow[c] = bfr((hrow[c] - mean) * rstd * gamma[c] + beta[c]);
  __syncwarp();
}

// ---------------------------------------------------------------------------------
// K3: the argmax; one block per 64-row tile.
// ---------------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
final_head_predict_kernel(const bf16* __restrict__ x, const bf16* __restrict__ we,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          const bf16* __restrict__ wh, int* __restrict__ preds, int C, int F,
                          int P, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const HeadLayout L = head_layout(C, F, P);
  const int LDW = C + 8;
  const int LDH = C + 4;
  bf16* wes = reinterpret_cast<bf16*>(smem + L.we);
  float* whs = reinterpret_cast<float*>(smem + L.wh);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.x);
  float* hf = reinterpret_cast<float*>(smem + L.h);

  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  stage_tail(we, wh, x, wes, whs, xs, C, F, P, tile);
  __syncthreads();

  for (int i = 0; i < P; ++i) {
    expand_product(xs, wes + size_t(i) * C * LDW, hf, C);
    __syncthreads();
    for (int r = warp; r < ROWS; r += kWarps) {
      float* hrow = hf + r * LDH;
      ln_row(hrow, gamma, beta, C, eps, lane);
      float logit = 0.f;
      if (lane < F)
        for (int c = 0; c < C; ++c) logit = fmaf(hrow[c], whs[c * F + lane], logit);

      float best = __shfl_sync(0xffffffffu, logit, 0);
      int best_idx = 0;
      bool has_nan = isnan(best);
      for (int j = 1; j < F; ++j) {
        const float lj = __shfl_sync(0xffffffffu, logit, j);
        if (isnan(lj)) {
          has_nan = true;
        } else if (lj > best) {
          best = lj;
          best_idx = j;
        }
      }
      if (lane == 0)
        preds[(size_t(tile) * ROWS + r) * P + i] = has_nan ? F - 1 : best_idx;
      __syncwarp();
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------------
// The masked depth loss of K8 and K9 (heal_swin_tpu/ops/final_head.py
// _depth_loss_vals, _depth_loss_grads).  Kinds in the order of the wrapper's
// DEPTH_KINDS.
// ---------------------------------------------------------------------------------
enum DepthKind : int { kL2 = 0, kL1 = 1, kHuber = 2, kNll = 3 };

// jnp.sign: +-1, and d itself at 0 and NaN
__device__ __forceinline__ float sign_of(float d) {
  return d > 0.f ? 1.f : (d < 0.f ? -1.f : d);
}

// The F <= 2 head outputs of one row, f32: lane-wise products of z and Wh summed over
// the warp (every lane gets the same sums).  Reads only this lane's columns.
__device__ __forceinline__ void depth_logits(const float* zrow, const float* whs, int C,
                                             int F, int lane, float (&lf)[2]) {
  float s0 = 0.f, s1 = 0.f;
  for (int c = lane; c < C; c += 32) {
    s0 = fmaf(zrow[c], whs[c * F], s0);
    if (F > 1) s1 = fmaf(zrow[c], whs[c * F + 1], s1);
  }
  lf[0] = warp_sum(s0);
  lf[1] = F > 1 ? warp_sum(s1) : 0.f;
}

// d = logit 0 - target: an invalid target is selected to 0 before the subtraction,
// and d is 0 where the target is invalid
__device__ __forceinline__ float depth_diff(float lf0, float t, bool valid) {
  const float ts = valid ? t : 0.f;
  return valid ? lf0 - ts : 0.f;
}

// the loss of one valid element
__device__ __forceinline__ float depth_loss(const float (&lf)[2], float d, int kind,
                                            float delta) {
  switch (kind) {
    case kL2:
      return 0.5f * d * d;
    case kL1:
      return fabsf(d);
    case kHuber: {
      const float ad = fabsf(d);
      return ad < delta ? 0.5f * ad * ad / delta : ad - 0.5f * delta;
    }
    default:  // kNll over (mean, logvar)
      return 0.5f * lf[1] + (0.5f * d * d) * expf(-lf[1]);
  }
}

// d loss / d logits of one element: (g0, g1), both 0 where invalid; g1 is 0 for every
// kind but nll (a logvar channel before the loss switches to the NLL)
__device__ __forceinline__ void depth_grads(const float (&lf)[2], float d, bool valid,
                                            int kind, float delta, float (&g)[2]) {
  g[0] = 0.f;
  g[1] = 0.f;
  if (!valid) return;
  switch (kind) {
    case kL2:
      g[0] = d;
      break;
    case kL1:
      g[0] = sign_of(d);
      break;
    case kHuber:
      g[0] = fabsf(d) < delta ? d / delta : sign_of(d);
      break;
    default: {
      const float e = expf(-lf[1]);
      g[0] = d * e;
      g[1] = 0.5f - (0.5f * d * d) * e;
    }
  }
}

// ---------------------------------------------------------------------------------
// K8: the masked depth loss; one block per 64-row tile, writing the predictions and
// the partial row [sum loss, count of valid targets].
// ---------------------------------------------------------------------------------
__host__ __device__ inline size_t depth_loss_smem(int C, int F, int P) {
  return head_layout(C, F, P).total + align128(2 * kWarps * 4);
}

__global__ void __launch_bounds__(kThreads)
final_head_depth_loss_kernel(const bf16* __restrict__ x, const bf16* __restrict__ we,
                             const float* __restrict__ gamma, const float* __restrict__ beta,
                             const bf16* __restrict__ wh, const float* __restrict__ t,
                             bf16* __restrict__ preds, float* __restrict__ part, int C, int F,
                             int P, int kind, float delta, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const HeadLayout L = head_layout(C, F, P);
  const int LDW = C + 8;
  const int LDH = C + 4;
  bf16* wes = reinterpret_cast<bf16*>(smem + L.we);
  float* whs = reinterpret_cast<float*>(smem + L.wh);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.x);
  float* hf = reinterpret_cast<float*>(smem + L.h);
  float* wsum = reinterpret_cast<float*>(smem + L.total);

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  stage_tail(we, wh, x, wes, whs, xs, C, F, P, tile);
  __syncthreads();

  float num = 0.f, den = 0.f;  // this warp's sums (every lane holds them)
  for (int i = 0; i < P; ++i) {
    expand_product(xs, wes + size_t(i) * C * LDW, hf, C);
    __syncthreads();
    for (int r = warp; r < ROWS; r += kWarps) {
      float* hrow = hf + r * LDH;
      ln_row(hrow, gamma, beta, C, eps, lane);
      float lf[2];
      depth_logits(hrow, whs, C, F, lane, lf);
      const size_t row = size_t(tile) * ROWS + r;
      const float tv = t[row * P + i];
      const bool valid = isfinite(tv);
      const float d = depth_diff(lf[0], tv, valid);
      num += valid ? depth_loss(lf, d, kind, delta) : 0.f;
      den += valid ? 1.f : 0.f;
      if (lane < F) preds[(row * P + i) * F + lane] = to_bf(lane == 0 ? lf[0] : lf[1]);
      __syncwarp();
    }
    __syncthreads();
  }
  if (lane == 0) {
    wsum[warp] = num;
    wsum[kWarps + warp] = den;
  }
  __syncthreads();
  if (tid == 0) {
    float n = 0.f, d = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      n += wsum[w];
      d += wsum[kWarps + w];
    }
    part[size_t(tile) * 2] = n;
    part[size_t(tile) * 2 + 1] = d;
  }
}

// ---------------------------------------------------------------------------------
// K9: the backward of K8; one block per 64-row tile.  Writes dx, dh (bf16, for the dWe
// product) and the partial row [dWh (C x F) | dgamma (C) | dbeta (C)].  A row's
// dlogits come from its z through the functor DepthGrads.
// ---------------------------------------------------------------------------------
constexpr int LDL = 32;   // dlogits row stride (one lane per output channel)
constexpr int LMAXJ = 4;  // per-lane registers of a row pass: C / 32 <= 4 (C <= 128)

// K9: dlogits = scale * d loss / d logits of the f32 logits, kept in f32
struct DepthGrads {
  const float* t;
  int kind;
  float delta;

  __device__ __forceinline__ void operator()(const float* zrow, const float* whs, int C,
                                             int F, size_t e, float scale, float* dlr,
                                             int lane) const {
    float lf[2];
    depth_logits(zrow, whs, C, F, lane, lf);
    const float tv = t[e];
    const bool valid = isfinite(tv);
    float g[2];
    depth_grads(lf, depth_diff(lf[0], tv, valid), valid, kind, delta, g);
    if (lane < F) dlr[lane] = scale * (lane == 0 ? g[0] : g[1]);
  }
};

struct BwdLayout {
  size_t we, wh, x, hf, dh, dx, dl, dwh, wacc, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int C, int F, int P) {
  BwdLayout L;
  const size_t ldw = size_t(C) + 8;
  size_t off = 0;
  L.we = off; off += align128(size_t(P) * C * ldw * 2);
  L.wh = off; off += align128(size_t(C) * F * 4);
  L.x = off; off += align128(ROWS * ldw * 2);
  L.hf = off; off += align128(size_t(ROWS) * (C + 4) * 4);
  L.dh = off; off += align128(ROWS * ldw * 2);
  L.dx = off; off += align128(size_t(ROWS) * (C + 4) * 4);
  L.dl = off; off += align128(size_t(ROWS) * LDL * 4);
  L.dwh = off; off += align128(size_t(C) * F * 4);
  L.wacc = off; off += align128(size_t(kWarps) * 2 * C * 4);
  L.total = off;
  return L;
}

template <class Grads>
__global__ void __launch_bounds__(kThreads)
final_head_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ we,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const bf16* __restrict__ wh, Grads grads,
                      const float* __restrict__ scale_p, bf16* __restrict__ dx,
                      bf16* __restrict__ dh_s, float* __restrict__ part, int C, int F, int P,
                      float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L = bwd_layout(C, F, P);
  const int LDW = C + 8;
  const int LDH = C + 4;
  bf16* wes = reinterpret_cast<bf16*>(smem + L.we);
  float* whs = reinterpret_cast<float*>(smem + L.wh);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.x);
  float* hf = reinterpret_cast<float*>(smem + L.hf);  // h, then z (f32 of bf16)
  bf16* dhs = reinterpret_cast<bf16*>(smem + L.dh);
  float* dxa = reinterpret_cast<float*>(smem + L.dx);
  float* dl = reinterpret_cast<float*>(smem + L.dl);
  float* dwh = reinterpret_cast<float*>(smem + L.dwh);
  float* wacc = reinterpret_cast<float*>(smem + L.wacc);

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nj = (C + 31) / 32;
  const float scale = *scale_p;

  stage_tail(we, wh, x, wes, whs, xs, C, F, P, tile);
  for (int idx = tid; idx < C * F; idx += kThreads) dwh[idx] = 0.f;
  for (int idx = tid; idx < ROWS * LDH; idx += kThreads) dxa[idx] = 0.f;
  for (int idx = tid; idx < kWarps * 2 * C; idx += kThreads) wacc[idx] = 0.f;
  __syncthreads();

  const int ntiles = (ROWS / 16) * (C / 16);
  float* wg = wacc + warp * 2 * C;  // this warp's dgamma | dbeta sums
  for (int i = 0; i < P; ++i) {
    const bf16* wei = wes + size_t(i) * C * LDW;
    expand_product(xs, wei, hf, C);
    __syncthreads();

    for (int r = warp; r < ROWS; r += kWarps) {
      // the LayerNorm forward, keeping xhat of this lane's columns in registers
      float* hrow = hf + r * LDH;
      float xh[LMAXJ];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < LMAXJ; ++j) {
        const int c = lane + 32 * j;
        if (j < nj && c < C) {
          xh[j] = bfr(hrow[c]);
          sum += xh[j];
        }
      }
      const float mean = warp_sum(sum) / C;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < LMAXJ; ++j) {
        const int c = lane + 32 * j;
        if (j < nj && c < C) {
          const float d = xh[j] - mean;
          sq += d * d;
        }
      }
      const float rstd = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
      for (int j = 0; j < LMAXJ; ++j) {
        const int c = lane + 32 * j;
        if (j < nj && c < C) {
          xh[j] = (xh[j] - mean) * rstd;
          hrow[c] = bfr(xh[j] * gamma[c] + beta[c]);  // z
        }
      }
      __syncwarp();

      const size_t e = (size_t(tile) * ROWS + r) * P + i;
      grads(hrow, whs, C, F, e, scale, dl + r * LDL, lane);
      __syncwarp();

      // dz = dlogits Wh^T; dgamma, dbeta; the LN backward dh (bf16)
      float dzh[LMAXJ];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < LMAXJ; ++j) {
        const int c = lane + 32 * j;
        if (j < nj && c < C) {
          float dz = 0.f;
          for (int f = 0; f < F; ++f) dz = fmaf(dl[r * LDL + f], whs[c * F + f], dz);
          wg[c] += dz * xh[j];
          wg[C + c] += dz;
          dzh[j] = dz * gamma[c];
          s1 += dzh[j];
          s2 += dzh[j] * xh[j];
        }
      }
      const float m1 = warp_sum(s1) / C;
      const float m2 = warp_sum(s2) / C;
      bf16* grow = dh_s + e * C;
#pragma unroll
      for (int j = 0; j < LMAXJ; ++j) {
        const int c = lane + 32 * j;
        if (j < nj && c < C) {
          const bf16 v = to_bf(rstd * (dzh[j] - m1 - xh[j] * m2));
          dhs[r * LDW + c] = v;
          grow[c] = v;
        }
      }
    }
    __syncthreads();

    // dWh += z^T dlogits (each thread owns fixed elements); dx += dh We_i^T
    for (int idx = tid; idx < C * F; idx += kThreads) {
      const int c = idx / F, f = idx % F;
      float acc = 0.f;
      for (int r = 0; r < ROWS; ++r) acc = fmaf(hf[r * LDH + c], dl[r * LDL + f], acc);
      dwh[idx] += acc;
    }
    for (int t = warp; t < ntiles; t += kWarps) {
      const int rt = t & 3, ct = t >> 2;
      FragC acc;
      wmma::load_matrix_sync(acc, dxa + rt * 16 * LDH + ct * 16, LDH, wmma::mem_row_major);
      for (int kk = 0; kk < C; kk += 16) {
        FragA a;
        FragBt b;  // element (k, n) of We_i^T at wei[n * LDW + k]
        wmma::load_matrix_sync(a, dhs + rt * 16 * LDW + kk, LDW);
        wmma::load_matrix_sync(b, wei + size_t(ct) * 16 * LDW + kk, LDW);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(dxa + rt * 16 * LDH + ct * 16, acc, LDH, wmma::mem_row_major);
    }
    __syncthreads();
  }

  for (int idx = tid; idx < ROWS * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    dx[(size_t(tile) * ROWS + r) * C + c] = to_bf(dxa[r * LDH + c]);
  }
  float* prow = part + size_t(tile) * (C * F + 2 * C);
  for (int idx = tid; idx < C * F; idx += kThreads) prow[idx] = dwh[idx];
  for (int c = tid; c < 2 * C; c += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += wacc[w * 2 * C + c];
    prow[C * F + c] = s;
  }
}

inline size_t part_bytes(int T, int W) { return align128(size_t(T / ROWS) * W * 4); }

// the loss kernels' workspace: partial rows, then reduce_rows' scratch
size_t loss_workspace(int T, int W) {
  return part_bytes(T, W) + align128(reduce_rows_tmp_floats(T / ROWS, W) * 4);
}

// the backward kernels' workspace: dh (T, P*C) bf16, partial rows, then the scratch
// of reduce_rows or gemm_tn, whichever is larger
size_t bwd_workspace(int T, int C, int F, int P) {
  const int W = C * F + 2 * C;
  size_t tmp = reduce_rows_tmp_floats(T / ROWS, W);
  const size_t g = gemm_tn_tmp_floats(T, C, P * C);
  tmp = tmp > g ? tmp : g;
  return align128(size_t(T) * P * C * 2) + part_bytes(T, W) + align128(tmp * 4);
}

// K9 and its cross-block passes: the partial rows into red = [dWh | dgamma | dbeta],
// dWe = x^T dh
template <class Grads>
cudaError_t launch_bwd(const void* x, const void* we, const void* gamma, const void* beta,
                       const void* wh, Grads grads, const void* scale, void* dx, void* dwe,
                       void* red, void* work, int T, int C, int F, int P, float eps,
                       cudaStream_t s) {
  const size_t smem = bwd_layout(C, F, P).total;
  cudaError_t e = cudaFuncSetAttribute(final_head_bwd_kernel<Grads>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const int W = C * F + 2 * C;
  unsigned char* base = static_cast<unsigned char*>(work);
  bf16* dh_s = reinterpret_cast<bf16*>(base);
  float* part = reinterpret_cast<float*>(base + align128(size_t(T) * P * C * 2));
  float* tmp = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(part) +
                                        part_bytes(T, W));
  final_head_bwd_kernel<Grads><<<T / ROWS, kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(we),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const bf16*>(wh), grads, static_cast<const float*>(scale),
      static_cast<bf16*>(dx), dh_s, part, C, F, P, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = reduce_rows(part, static_cast<float*>(red), T / ROWS, W, tmp, s);
  if (e != cudaSuccess) return e;
  return gemm_tn(static_cast<const bf16*>(x), dh_s, static_cast<float*>(dwe), T, C, P * C,
                 tmp, s);
}

// ---------------------------------------------------------------------------------
// K6 and the row kernel of K7 on the tail row core (tail_core.cuh).  Persistent blocks
// of 8 warps: block b walks the 128-row tiles b, b + grid, ...; the p expand slices and
// Wh stay resident, the x tiles come through a double-buffered cp.async ring.
// ---------------------------------------------------------------------------------

// shared memory: We's p slices (p x C x C, rows padded to C + 8) | Wh (C x 8 NF bf16,
// zero-padded, rows padded to 8 NF + 8) | two stages of the x tile (128 x C) | K6: the
// confusion matrix (F x F int) and the warps' loss sums; K7's row kernel: the tile's z
// (128 x C) and dlogits (128 x 8 NF), both bf16, for dWh, and the warps' dgamma | dbeta
// column sums (2C floats a warp)
struct TailLayout {
  size_t wh, x, stage, z, dl, red, total;
  int ldwh;
};

__host__ __device__ inline TailLayout tail_layout(int C, int F, int P, bool bwd) {
  TailLayout L;
  L.ldwh = (F <= 16 ? 16 : 32) + 8;
  const size_t ldx = size_t(C) + 8;
  size_t off = align128(size_t(P) * C * ldx * 2);
  L.wh = off; off += align128(size_t(C) * L.ldwh * 2);
  L.stage = align128(TAIL_ROWS * ldx * 2);
  L.x = off; off += 2 * L.stage;
  L.z = L.dl = 0;
  if (bwd) {
    L.z = off; off += L.stage;
    L.dl = off; off += align128(size_t(TAIL_ROWS) * L.ldwh * 2);
  }
  L.red = off;
  off += bwd ? align128(size_t(kWarps) * 2 * C * 4)
             : align128(size_t(F) * F * 4) + align128(2 * kWarps * 4);
  L.total = off;
  return L;
}

// the block's resident operands: We's slices by cp.async (the caller commits them with
// its first x tile), Wh with its padding columns zeroed
__device__ __forceinline__ void stage_tail_weights(bf16* wes, bf16* whs,
                                                   const bf16* __restrict__ we,
                                                   const bf16* __restrict__ wh, int C, int F,
                                                   int P, int ldwh) {
  fetch_rows(wes, C + 8, we, P * C, C);
  for (int idx = threadIdx.x; idx < C * ldwh; idx += kThreads) {
    const int r = idx / ldwh, f = idx - r * ldwh;
    whs[idx] = f < F ? wh[size_t(r) * F + f] : to_bf(0.f);
  }
}

// x tile `tile` (its rows that exist) into a ring stage by cp.async; none past the last
__device__ __forceinline__ void fetch_tail_tile(bf16* xs, const bf16* __restrict__ x, int tile,
                                                int tiles, int T, int C) {
  if (tile < tiles)
    fetch_rows(xs, C + 8, x + size_t(tile) * TAIL_ROWS * C, min(TAIL_ROWS, T - tile * TAIL_ROWS),
               C);
}

// K6: the partial row [sum w*nll, sum w, confusion matrix (F x F)] of each block; tap,
// where not null, gets the rounded logits (T, p, F)
template <int NT, int NF>
__global__ void __launch_bounds__(kThreads, 1)
tail_loss_kernel(const bf16* __restrict__ x, const bf16* __restrict__ we,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 const bf16* __restrict__ wh, const int* __restrict__ y,
                 const float* __restrict__ welem, float* __restrict__ part,
                 bf16* __restrict__ tap, int T, int F, int P, float eps) {
  constexpr int C = 8 * NT;
  constexpr int ldx = C + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const TailLayout L = tail_layout(C, F, P, false);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int row0 = warp * 16;
  bf16* wes = reinterpret_cast<bf16*>(smem);
  bf16* whs = reinterpret_cast<bf16*>(smem + L.wh);
  int* cm = reinterpret_cast<int*>(smem + L.red);
  float* wsum = reinterpret_cast<float*>(smem + L.red + align128(size_t(F) * F * 4));
  auto xs = [&](int s) { return reinterpret_cast<bf16*>(smem + L.x + (s & 1) * L.stage); };
  const int tiles = (T + TAIL_ROWS - 1) / TAIL_ROWS;

  stage_tail_weights(wes, whs, we, wh, C, F, P, L.ldwh);
  fetch_tail_tile(xs(0), x, blockIdx.x, tiles, T, C);
  cp_async_commit();
  for (int idx = tid; idx < F * F; idx += kThreads) cm[idx] = 0;

  float num = 0.f, den = 0.f;  // the sums of this lane's rows (lanes with c = 0)
  int s = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++s) {
    cp_async_wait<0>();
    __syncthreads();  // tile s has landed (with the weights); tile s - 1's stage is free
    fetch_tail_tile(xs(s + 1), x, tile + gridDim.x, tiles, T, C);
    cp_async_commit();
    if (row0 >= min(TAIL_ROWS, T - tile * TAIL_ROWS)) continue;
    const size_t grow0 = size_t(tile) * TAIL_ROWS + row0;
    for (int i = 0; i < P; ++i) {
      float xh[NT][4], lf[NF][4], ex[NF][4];
      tail_xhat<NT>(xh, xs(s), ldx, row0, wes + size_t(i) * C * ldx, C, eps);
      tail_logits<NT, NF>(lf, xh, gamma, beta, whs, L.ldwh, nullptr, 0);
      const CeRows ce = tail_softmax<NF>(lf, ex, F);
      if (tap != nullptr) tail_tap<NF>(tap, lf, grow0, i, P, F);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t e = (grow0 + g + 8 * h) * P + i;
        const int yi = y[e];
        float ly = 0.f;
        int best = F;  // the lowest column at the max; none for a row holding a NaN
#pragma unroll
        for (int n = 0; n < NF; ++n)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int col = 8 * n + c2 + k;
            const float v = lf[n][2 * h + k];
            if (col < F) {
              if (col == yi) ly = v;
              if (v >= ce.mx[h] && col < best) best = col;
            }
          }
        ly = quad_sum(ly);
        best = min(best, __shfl_xor_sync(0xffffffffu, best, 1));
        best = min(best, __shfl_xor_sync(0xffffffffu, best, 2));
        if ((lane & 3) == 0) {
          const float wi = welem[e];
          num += wi * (ce.mx[h] + logf(ce.se[h]) - ly);
          den += wi;
          if (best < F && yi >= 0 && yi < F) atomicAdd(cm + yi * F + best, 1);  // order-free
        }
      }
    }
  }
  num = warp_sum(num);
  den = warp_sum(den);
  if (lane == 0) {
    wsum[warp] = num;
    wsum[kWarps + warp] = den;
  }
  __syncthreads();
  float* prow = part + size_t(blockIdx.x) * (2 + F * F);
  if (tid == 0) {
    float n = 0.f, d = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      n += wsum[w];
      d += wsum[kWarps + w];
    }
    prow[0] = n;
    prow[1] = d;
  }
  for (int idx = tid; idx < F * F; idx += kThreads) prow[2 + idx] = float(cm[idx]);
}

// K7's row kernel: dx (T x C bf16), dh (T x p C bf16: dh_i in columns i C ..) and the
// partial row [dWh (C x F) | dgamma (C) | dbeta (C)] of each block, for the loss
// gradient scale = gloss / den (on the device); tap as K6's
template <int NT, int NF>
__global__ void __launch_bounds__(kThreads, 1)
tail_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ we,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                const bf16* __restrict__ wh, const int* __restrict__ y,
                const float* __restrict__ welem, const float* __restrict__ scale_p,
                bf16* __restrict__ dx, bf16* __restrict__ dh, float* __restrict__ part,
                bf16* __restrict__ tap, int T, int F, int P, float eps) {
  constexpr int C = 8 * NT;
  constexpr int ldx = C + 8;
  constexpr int KS = NF / 2;  // 16-wide k-steps of a dlogits row
  extern __shared__ __align__(128) unsigned char smem[];
  const TailLayout L = tail_layout(C, F, P, true);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int row0 = warp * 16;
  const int ldwh = L.ldwh;
  bf16* wes = reinterpret_cast<bf16*>(smem);
  bf16* whs = reinterpret_cast<bf16*>(smem + L.wh);
  bf16* zs = reinterpret_cast<bf16*>(smem + L.z);
  bf16* dls = reinterpret_cast<bf16*>(smem + L.dl);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* wred = red + warp * 2 * C;  // this warp's dgamma | dbeta column sums
  auto xs = [&](int s) { return reinterpret_cast<bf16*>(smem + L.x + (s & 1) * L.stage); };
  const int tiles = (T + TAIL_ROWS - 1) / TAIL_ROWS;
  const float scale = *scale_p;
  const bool dwh_rows = warp < C / 16;  // this warp sums rows 16 warp .. of dWh

  stage_tail_weights(wes, whs, we, wh, C, F, P, ldwh);
  fetch_tail_tile(xs(0), x, blockIdx.x, tiles, T, C);
  cp_async_commit();
  for (int idx = tid; idx < kWarps * 2 * C; idx += kThreads) red[idx] = 0.f;

  float dwh[KS][1][2][4];
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dwh[k][0][j][e] = 0.f;
  int s = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++s) {
    cp_async_wait<0>();
    __syncthreads();  // tile s has landed (with the weights); tile s - 1's stage is free
    fetch_tail_tile(xs(s + 1), x, tile + gridDim.x, tiles, T, C);
    cp_async_commit();
    const int rows = min(TAIL_ROWS, T - tile * TAIL_ROWS);
    const bool active = row0 < rows;
    const size_t grow0 = size_t(tile) * TAIL_ROWS + row0;
    float dxa[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) dxa[t][0] = dxa[t][1] = dxa[t][2] = dxa[t][3] = 0.f;
    for (int i = 0; i < P; ++i) {
      const bf16* wei = wes + size_t(i) * C * ldx;
      float xh[NT][4];
      LnRows r;
      if (active) r = tail_xhat<NT>(xh, xs(s), ldx, row0, wei, C, eps);
      __syncthreads();  // the last slice's dWh product has read zs and dls
      if (active) {
        float lf[NF][4], ex[NF][4];
        tail_logits<NT, NF>(lf, xh, gamma, beta, whs, ldwh, zs + row0 * ldx, ldx);
        const CeRows ce = tail_softmax<NF>(lf, ex, F);
        if (tap != nullptr) tail_tap<NF>(tap, lf, grow0, i, P, F);

        // dlogits = bf16(scale w (softmax - onehot)), 0 at columns >= F
        float dl[NF][4];
        int yi[2];
        float sw[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t e = (grow0 + g + 8 * h) * P + i;
          yi[h] = y[e];
          sw[h] = __fmul_rn(scale, welem[e]);
        }
#pragma unroll
        for (int n = 0; n < NF; ++n) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int col = 8 * n + c2 + (k & 1), h = k >> 1;
            dl[n][k] = col < F ? bfr(sw[h] * (__fdiv_rn(ex[n][k], ce.se[h]) -
                                               (col == yi[h] ? 1.f : 0.f)))
                               : 0.f;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(dls + (row0 + g + 8 * h) * ldwh + 8 * n + c2) =
                pack_bf2(dl[n][2 * h], dl[n][2 * h + 1]);
        }
        uint32_t da[KS][4];
#pragma unroll
        for (int k = 0; k < KS; ++k) pack_a_frag(da[k], dl[2 * k], dl[2 * k + 1]);

        // dz = dlogits Wh^T, 32 columns at a time, twice: first the LayerNorm backward's
        // row means m1, m2 of dz gamma and dz gamma xhat and the column sums dgamma =
        // sum dz xhat, dbeta = sum dz; then dh, recomputing dz (the same bits)
        float m[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
        for (int j = 0; j < NT / 4; ++j) {
          float dz[4][4] = {};
          frags_times_rows_t<4, KS>(dz, da, whs + 32 * j * ldwh, ldwh, 4);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int c = 32 * j + 8 * t + c2, n = 4 * j + t;
            const float gm0 = gamma[c], gm1 = gamma[c + 1];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float a0 = __fmul_rn(dz[t][2 * h], gm0);
              const float a1 = __fmul_rn(dz[t][2 * h + 1], gm1);
              m[h][0] = __fadd_rn(m[h][0], __fadd_rn(a0, a1));
              m[h][1] = __fmaf_rn(a1, xh[n][2 * h + 1], __fmaf_rn(a0, xh[n][2 * h], m[h][1]));
            }
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const float dg = rows8(__fadd_rn(__fmul_rn(dz[t][k], xh[n][k]),
                                               __fmul_rn(dz[t][2 + k], xh[n][2 + k])));
              const float db = rows8(__fadd_rn(dz[t][k], dz[t][2 + k]));
              if (lane < 4) {
                wred[c + k] += dg;
                wred[C + c + k] += db;
              }
            }
          }
        }
        row_sums<2>(m, nullptr, 1, 0);
        float m1[2], m2[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          m1[h] = __fdiv_rn(m[h][0], float(C));
          m2[h] = __fdiv_rn(m[h][1], float(C));
        }
        bf16* dhrow = dh + grow0 * P * C + size_t(i) * C;
#pragma unroll
        for (int j = 0; j < NT / 4; ++j) {
          float dz[4][4] = {};
          frags_times_rows_t<4, KS>(dz, da, whs + 32 * j * ldwh, ldwh, 4);
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int c = 32 * j + 8 * t + c2;
            const float gm[2] = {gamma[c], gamma[c + 1]};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int h = k >> 1;
              const float a = __fmul_rn(dz[t][k], gm[k & 1]);
              dz[t][k] = r.rstd[h] * (a - m1[h] - xh[4 * j + t][k] * m2[h]);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<uint32_t*>(dhrow + size_t(g + 8 * h) * P * C + c) =
                  pack_bf2(dz[t][2 * h], dz[t][2 * h + 1]);
          }
          uint32_t dha[2][4];
          pack_a_frags(dha, dz);
          frags_times_rows_t<NT>(dxa, dha, wei + 32 * j, ldx, NT);
        }
      }
      __syncthreads();  // the tile's z and dlogits are in
      if (dwh_rows)
#pragma unroll
        for (int k = 0; k < KS; ++k)
          tile_t_times_tile_cols<1>(dwh[k], zs, ldx, 1, warp, kWarps, dls, ldwh, 16 * k, rows);
    }
    if (active) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int c = 8 * t + c2;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(dx + (grow0 + g + 8 * h) * C + c) =
              pack_bf2(dxa[t][2 * h], dxa[t][2 * h + 1]);
      }
    }
  }

  // the block's partial row: dWh from the warps' accumulators, dgamma | dbeta summed over
  // the warps in warp order
  __syncthreads();
  float* prow = part + size_t(blockIdx.x) * (C * F + 2 * C);
  if (dwh_rows) {
#pragma unroll
    for (int k = 0; k < KS; ++k)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * warp + g + 8 * (e >> 1), col = 16 * k + 8 * j + c2 + (e & 1);
          if (col < F) prow[row * F + col] = dwh[k][0][j][e];
        }
  }
  for (int c = tid; c < 2 * C; c += kThreads) {
    float sum = red[c];
    for (int w = 1; w < kWarps; ++w) sum += red[w * 2 * C + c];
    prow[C * F + c] = sum;
  }
}

// f(NT, NF) for the instantiation of C (32, 64, 96 or 128) and F (<= 16: NF 2, <= 32: 4)
template <typename Fn>
cudaError_t with_tail(int C, int F, Fn f) {
  if (F < 1 || F > 32) return cudaErrorInvalidValue;
  auto nf = [&](auto nt) {
    return F <= 16 ? f(nt, std::integral_constant<int, 2>{})
                   : f(nt, std::integral_constant<int, 4>{});
  };
  switch (C) {
    case 32: return nf(std::integral_constant<int, 4>{});
    case 64: return nf(std::integral_constant<int, 8>{});
    case 96: return nf(std::integral_constant<int, 12>{});
    case 128: return nf(std::integral_constant<int, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

constexpr size_t kTailMaxSmem = 232448;  // an H100 block's opt-in shared memory

// the kernel's grid: min(its tiles, the blocks the card holds at once at this shared
// memory), after its one opt-in to the most shared memory a block may have
template <int NT, int NF, bool BWD>
cudaError_t tail_grid(int T, int F, int P, int* grid) {
  static std::atomic<unsigned> done{0};
  const void* k = BWD ? reinterpret_cast<const void*>(tail_bwd_kernel<NT, NF>)
                      : reinterpret_cast<const void*>(tail_loss_kernel<NT, NF>);
  cudaError_t e = smem_opt_in(k, kTailMaxSmem, done);
  if (e != cudaSuccess) return e;
  const size_t smem = tail_layout(8 * NT, F, P, BWD).total;
  if (smem > kTailMaxSmem || T <= 0) return cudaErrorInvalidValue;
  int per = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (T + TAIL_ROWS - 1) / TAIL_ROWS, resident = per * sm_count();
  *grid = tiles < resident ? tiles : resident;
  return cudaSuccess;
}

inline int grid_of(int T, int C, int F, int P, bool bwd) {
  int G = 0;
  const cudaError_t e = with_tail(C, F, [&](auto nt, auto nf) {
    constexpr int NT = decltype(nt)::value, NF = decltype(nf)::value;
    return bwd ? tail_grid<NT, NF, true>(T, F, P, &G) : tail_grid<NT, NF, false>(T, F, P, &G);
  });
  return e == cudaSuccess ? G : 0;
}

// K6's workspace: its partial rows, then reduce_rows' scratch
inline size_t tail_loss_workspace(int T, int C, int F, int P) {
  const int G = grid_of(T, C, F, P, false), W = 2 + F * F;
  return align128(size_t(G) * W * 4) + align128(reduce_rows_tmp_floats(G, W) * 4);
}

// K6: the row kernel, then reduce_rows over its partial rows into red = [sum w*nll,
// sum w, confusion matrix]
cudaError_t launch_tail_loss(const void* x, const void* we, const void* gamma,
                             const void* beta, const void* wh, const void* y,
                             const void* welem, void* red, void* work, void* tap, int T,
                             int C, int F, int P, float eps, cudaStream_t s) {
  return with_tail(C, F, [&](auto nt, auto nf) {
    constexpr int NT = decltype(nt)::value, NF = decltype(nf)::value;
    int G = 0;
    cudaError_t e = tail_grid<NT, NF, false>(T, F, P, &G);
    if (e != cudaSuccess) return e;
    const int W = 2 + F * F;
    float* part = static_cast<float*>(work);
    float* tmp = reinterpret_cast<float*>(static_cast<unsigned char*>(work) +
                                          align128(size_t(G) * W * 4));
    tail_loss_kernel<NT, NF><<<G, kThreads, tail_layout(C, F, P, false).total, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(we),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const bf16*>(wh), static_cast<const int*>(y),
        static_cast<const float*>(welem), part, static_cast<bf16*>(tap), T, F, P, eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    return reduce_rows(part, static_cast<float*>(red), G, W, tmp, s);
  });
}

// K7's workspace: dh (T x p C bf16), the row kernel's partial rows, then the scratch of
// reduce_rows or gemm_tn, whichever is larger
struct TailBwdWork {
  size_t part, tmp, total;
  int grid;
};

inline TailBwdWork tail_bwd_work(int T, int C, int F, int P) {
  TailBwdWork w;
  w.grid = grid_of(T, C, F, P, true);
  const int W = C * F + 2 * C;
  size_t tmp = reduce_rows_tmp_floats(w.grid, W);
  const size_t gt = gemm_tn_tmp_floats(T, C, P * C);
  tmp = tmp > gt ? tmp : gt;
  w.part = align128(size_t(T) * P * C * 2);
  w.tmp = w.part + align128(size_t(w.grid) * W * 4);
  w.total = w.tmp + align128(tmp * 4);
  return w;
}

// K7's row kernel alone: dx, dh and its partial rows part (grid x (C F + 2C))
cudaError_t launch_tail_bwd_rows(const void* x, const void* we, const void* gamma,
                                 const void* beta, const void* wh, const void* y,
                                 const void* welem, const void* scale, void* dx, void* dh,
                                 void* part, void* tap, int T, int C, int F, int P, float eps,
                                 cudaStream_t s) {
  return with_tail(C, F, [&](auto nt, auto nf) {
    constexpr int NT = decltype(nt)::value, NF = decltype(nf)::value;
    int G = 0;
    cudaError_t e = tail_grid<NT, NF, true>(T, F, P, &G);
    if (e != cudaSuccess) return e;
    tail_bwd_kernel<NT, NF><<<G, kThreads, tail_layout(C, F, P, true).total, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(we),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const bf16*>(wh), static_cast<const int*>(y),
        static_cast<const float*>(welem), static_cast<const float*>(scale),
        static_cast<bf16*>(dx), static_cast<bf16*>(dh), static_cast<float*>(part),
        static_cast<bf16*>(tap), T, F, P, eps);
    return cudaGetLastError();
  });
}

// K7: the row kernel, reduce_rows over its partial rows into red = [dWh | dgamma |
// dbeta], then dWe = x^T dh by gemm_tn, on one stream
cudaError_t launch_tail_bwd(const void* x, const void* we, const void* gamma, const void* beta,
                            const void* wh, const void* y, const void* welem, const void* scale,
                            void* dx, void* dwe, void* red, void* work, int T, int C, int F,
                            int P, float eps, cudaStream_t s) {
  const TailBwdWork w = tail_bwd_work(T, C, F, P);
  if (w.grid < 1) return cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(work);
  bf16* dh = reinterpret_cast<bf16*>(base);
  float* part = reinterpret_cast<float*>(base + w.part);
  float* tmp = reinterpret_cast<float*>(base + w.tmp);
  cudaError_t e = launch_tail_bwd_rows(x, we, gamma, beta, wh, y, welem, scale, dx, dh, part,
                                       nullptr, T, C, F, P, eps, s);
  if (e != cudaSuccess) return e;
  e = reduce_rows(part, static_cast<float*>(red), w.grid, C * F + 2 * C, tmp, s);
  if (e != cudaSuccess) return e;
  return gemm_tn(static_cast<const bf16*>(x), dh, static_cast<float*>(dwe), T, C, P * C, tmp, s);
}

}  // namespace
}  // namespace hs

extern "C" {

size_t hs_final_head_predict_smem(int C, int F, int P) { return hs::head_layout(C, F, P).total; }

int hs_final_head_predict(const void* x, const void* we, const void* gamma, const void* beta,
                          const void* wh, void* preds, int T, int C, int F, int P, float eps,
                          void* stream) {
  using hs::bf16;
  const size_t smem = hs::head_layout(C, F, P).total;
  cudaError_t e = cudaFuncSetAttribute(hs::final_head_predict_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  hs::final_head_predict_kernel<<<T / hs::ROWS, hs::kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(we),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const bf16*>(wh), static_cast<int*>(preds), C, F, P, eps);
  return int(cudaGetLastError());
}


size_t hs_final_head_loss_smem(int C, int F, int P) {
  return hs::tail_layout(C, F, P, false).total;
}

// K6's and K7's row kernels' grids (0 where they do not take the shape)
int hs_final_head_loss_grid(int T, int C, int F, int P) {
  return hs::grid_of(T, C, F, P, false);
}

int hs_final_head_loss_bwd_grid(int T, int C, int F, int P) {
  return hs::grid_of(T, C, F, P, true);
}

size_t hs_final_head_loss_workspace(int T, int C, int F, int P) {
  return hs::tail_loss_workspace(T, C, F, P);
}

// K6: red = [sum w*nll, sum w, confusion matrix]; tap (may be null) gets the rounded
// logits (T, p, F) bf16
int hs_final_head_loss(const void* x, const void* we, const void* gamma, const void* beta,
                       const void* wh, const void* y, const void* welem, void* red,
                       void* work, void* tap, int T, int C, int F, int P, float eps,
                       void* stream) {
  return int(hs::launch_tail_loss(x, we, gamma, beta, wh, y, welem, red, work, tap, T, C, F,
                                  P, eps, static_cast<cudaStream_t>(stream)));
}

size_t hs_final_head_loss_bwd_smem(int C, int F, int P) {
  return hs::tail_layout(C, F, P, true).total;
}

size_t hs_final_head_loss_bwd_workspace(int T, int C, int F, int P) {
  return hs::tail_bwd_work(T, C, F, P).total;
}

// K7's row kernel alone: dx, dh (T x p C bf16) and its partial rows (hs_final_head_loss_
// bwd_grid rows of C F + 2C floats: dWh | dgamma | dbeta); tap as K6's
int hs_final_head_loss_bwd_rows(const void* x, const void* we, const void* gamma,
                                const void* beta, const void* wh, const void* y,
                                const void* welem, const void* scale, void* dx, void* dh,
                                void* part, void* tap, int T, int C, int F, int P, float eps,
                                void* stream) {
  return int(hs::launch_tail_bwd_rows(x, we, gamma, beta, wh, y, welem, scale, dx, dh, part,
                                      tap, T, C, F, P, eps,
                                      static_cast<cudaStream_t>(stream)));
}

// K7: the row kernel, reduce_rows, gemm_tn; red = [dWh | dgamma | dbeta]
int hs_final_head_loss_bwd(const void* x, const void* we, const void* gamma,
                           const void* beta, const void* wh, const void* y,
                           const void* welem, const void* scale, void* dx, void* dwe,
                           void* red, void* work, int T, int C, int F, int P, float eps,
                           void* stream) {
  return int(hs::launch_tail_bwd(x, we, gamma, beta, wh, y, welem, scale, dx, dwe, red, work,
                                 T, C, F, P, eps, static_cast<cudaStream_t>(stream)));
}

size_t hs_final_head_depth_loss_smem(int C, int F, int P) {
  return hs::depth_loss_smem(C, F, P);
}

size_t hs_final_head_depth_loss_workspace(int T) { return hs::loss_workspace(T, 2); }

int hs_final_head_depth_loss(const void* x, const void* we, const void* gamma,
                             const void* beta, const void* wh, const void* t, void* red,
                             void* preds, void* work, int T, int C, int F, int P, int kind,
                             float eps, float delta, void* stream) {
  using hs::bf16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = hs::depth_loss_smem(C, F, P);
  cudaError_t e = cudaFuncSetAttribute(hs::final_head_depth_loss_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  float* part = static_cast<float*>(work);
  float* tmp = reinterpret_cast<float*>(static_cast<unsigned char*>(work) +
                                        hs::part_bytes(T, 2));
  hs::final_head_depth_loss_kernel<<<T / hs::ROWS, hs::kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(we),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const bf16*>(wh), static_cast<const float*>(t), static_cast<bf16*>(preds),
      part, C, F, P, kind, delta, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  return int(hs::reduce_rows(part, static_cast<float*>(red), T / hs::ROWS, 2, tmp, s));
}

size_t hs_final_head_depth_loss_bwd_smem(int C, int F, int P) {
  return hs::bwd_layout(C, F, P).total;
}

size_t hs_final_head_depth_loss_bwd_workspace(int T, int C, int F, int P) {
  return hs::bwd_workspace(T, C, F, P);
}

int hs_final_head_depth_loss_bwd(const void* x, const void* we, const void* gamma,
                                 const void* beta, const void* wh, const void* t,
                                 const void* scale, void* dx, void* dwe, void* red, void* work,
                                 int T, int C, int F, int P, int kind, float eps, float delta,
                                 void* stream) {
  const hs::DepthGrads grads{static_cast<const float*>(t), kind, delta};
  return int(hs::launch_bwd(x, we, gamma, beta, wh, grads, scale, dx, dwe, red, work, T, C,
                            F, P, eps, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
