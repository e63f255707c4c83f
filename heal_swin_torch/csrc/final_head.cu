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
// K7 / K9 (one kernel, templated on how a row's dlogits are made): recompute the
//   forward per tile; dlogits = bf16((gloss/den) w (softmax - onehot)) for K7, and
//   (gloss/den) * dloss/dlogits in f32 for K9 -> dWh += z^T dlogits, dz = dlogits
//   Wh^T -> dgamma, dbeta and the LN backward dh (bf16) -> dx = sum_i dh_i We_i^T;
//   dWe_i = x^T dh_i.
//
// What bounds it on this card: at the paper tail (T = 262144, C = 96, p = 4) each
// kernel reads 50 MB of tokens against 2*T*p*C^2 = 19 GFLOP of expand products (K7 and
// K9 twice that plus dx; the head, F = 10 for segmentation and F = 1 for depth, adds
// little): ~400 FLOP/byte, so the expand products decide, and the (T*p, F) logits and
// dlogits that the unfused tail writes and reads back never leave the SM.
//
// What the design does about it: one block per 64-row tile holds all p expand slices
// We (p, C, C) bf16 and Wh in shared memory (79 KB + 4 KB at the paper widths, above
// the 48 KB default, so the launch opts in with cudaFuncSetAttribute); the expand
// products run on the tensor cores as 16x16x16 bf16 WMMA tiles with f32 accumulation,
// LN, the narrow head product and the loss run one warp per row in f32.  The sums the
// TPU kernels accumulate across their sequential grid (loss sums, confusion matrix,
// dWh, dgamma, dbeta) become one partial row per block, summed in a fixed order by
// reduce.cu; dWe = x^T dh is a split-K product over the tokens (reduce.cu gemm_tn) of
// the bf16 dh the backward leaves in a workspace.  No atomics on floats: the results
// do not change from run to run.

#include <math_constants.h>

#include "common.cuh"

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
// K6: the weighted cross entropy and the confusion matrix; one block per 64-row tile,
// writing the partial row [sum w*nll, sum w, confusion matrix (F x F)].
// ---------------------------------------------------------------------------------
__host__ __device__ inline size_t loss_smem(int C, int F, int P) {
  return head_layout(C, F, P).total + align128(size_t(F) * F * 4) + align128(2 * kWarps * 4);
}

__global__ void __launch_bounds__(kThreads)
final_head_loss_kernel(const bf16* __restrict__ x, const bf16* __restrict__ we,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       const bf16* __restrict__ wh, const int* __restrict__ y,
                       const float* __restrict__ welem, float* __restrict__ part, int C,
                       int F, int P, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const HeadLayout L = head_layout(C, F, P);
  const int LDW = C + 8;
  const int LDH = C + 4;
  bf16* wes = reinterpret_cast<bf16*>(smem + L.we);
  float* whs = reinterpret_cast<float*>(smem + L.wh);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.x);
  float* hf = reinterpret_cast<float*>(smem + L.h);
  int* cm = reinterpret_cast<int*>(smem + L.total);
  float* wsum = reinterpret_cast<float*>(smem + L.total + align128(size_t(F) * F * 4));

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  stage_tail(we, wh, x, wes, whs, xs, C, F, P, tile);
  for (int idx = tid; idx < F * F; idx += kThreads) cm[idx] = 0;
  __syncthreads();

  float num = 0.f, den = 0.f;  // this warp's sums (every lane holds them)
  for (int i = 0; i < P; ++i) {
    expand_product(xs, wes + size_t(i) * C * LDW, hf, C);
    __syncthreads();
    for (int r = warp; r < ROWS; r += kWarps) {
      float* hrow = hf + r * LDH;
      ln_row(hrow, gamma, beta, C, eps, lane);
      float lf = -CUDART_INF_F;  // this lane's class logit, rounded to bf16
      if (lane < F) {
        float logit = 0.f;
        for (int c = 0; c < C; ++c) logit = fmaf(hrow[c], whs[c * F + lane], logit);
        lf = bfr(logit);
      }
      const bool has_nan = __any_sync(0xffffffffu, lane < F && isnan(lf));
      const float mx = has_nan ? CUDART_NAN_F : warp_max(lf);
      const float se = warp_sum(lane < F ? expf(lf - mx) : 0.f);
      const size_t e = (size_t(tile) * ROWS + r) * P + i;
      const int yi = y[e];
      const float wi = welem[e];
      const float ly = warp_sum(lane < F && lane == yi ? lf : 0.f);
      num += wi * (mx + logf(se) - ly);
      den += wi;
      // lowest index reaching the max; none for a row holding a NaN
      const unsigned at_max = __ballot_sync(0xffffffffu, lane < F && lf >= mx);
      if (lane == 0 && at_max && yi >= 0 && yi < F)
        atomicAdd(cm + yi * F + (__ffs(at_max) - 1), 1);  // integer: order-free
      __syncwarp();
    }
    __syncthreads();
  }
  if (lane == 0) {
    wsum[warp] = num;
    wsum[kWarps + warp] = den;
  }
  __syncthreads();
  float* prow = part + size_t(tile) * (2 + F * F);
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
// K7 / K9: the backward of K6 / K8; one block per 64-row tile.  Writes dx, dh (bf16,
// for the dWe product) and the partial row [dWh (C x F) | dgamma (C) | dbeta (C)].
// The two differ only in how a row's dlogits come from its z: CeGrads (K7) and
// DepthGrads (K9) below.
// ---------------------------------------------------------------------------------
constexpr int LDL = 32;   // dlogits row stride (one lane per output channel)
constexpr int LMAXJ = 4;  // per-lane registers of a row pass: C / 32 <= 4 (C <= 128)

// K7: dlogits = bf16(scale * w * (softmax - onehot)) of the bf16-rounded logits
struct CeGrads {
  const int* y;
  const float* welem;

  __device__ __forceinline__ void operator()(const float* zrow, const float* whs, int C,
                                             int F, size_t e, float scale, float* dlr,
                                             int lane) const {
    float lf = -CUDART_INF_F;
    if (lane < F) {
      float logit = 0.f;
      for (int c = 0; c < C; ++c) logit = fmaf(zrow[c], whs[c * F + lane], logit);
      lf = bfr(logit);
    }
    const bool has_nan = __any_sync(0xffffffffu, lane < F && isnan(lf));
    const float mx = has_nan ? CUDART_NAN_F : warp_max(lf);
    const float ex = lane < F ? expf(lf - mx) : 0.f;
    const float se = warp_sum(ex);
    const int yi = y[e];
    const float wi = welem[e];
    if (lane < F) dlr[lane] = bfr((scale * wi) * (ex / se - (lane == yi ? 1.f : 0.f)));
  }
};

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

// K7 / K9 and their cross-block passes: the partial rows into red = [dWh | dgamma |
// dbeta], dWe = x^T dh
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


size_t hs_final_head_loss_smem(int C, int F, int P) { return hs::loss_smem(C, F, P); }

size_t hs_final_head_loss_workspace(int T, int F) { return hs::loss_workspace(T, 2 + F * F); }

int hs_final_head_loss(const void* x, const void* we, const void* gamma, const void* beta,
                       const void* wh, const void* y, const void* welem, void* red,
                       void* work, int T, int C, int F, int P, float eps, void* stream) {
  using hs::bf16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = hs::loss_smem(C, F, P);
  cudaError_t e = cudaFuncSetAttribute(hs::final_head_loss_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const int W = 2 + F * F;
  float* part = static_cast<float*>(work);
  float* tmp = reinterpret_cast<float*>(static_cast<unsigned char*>(work) +
                                        hs::part_bytes(T, W));
  hs::final_head_loss_kernel<<<T / hs::ROWS, hs::kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(we),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const bf16*>(wh), static_cast<const int*>(y),
      static_cast<const float*>(welem), part, C, F, P, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  return int(hs::reduce_rows(part, static_cast<float*>(red), T / hs::ROWS, W, tmp, s));
}

size_t hs_final_head_loss_bwd_smem(int C, int F, int P) {
  return hs::bwd_layout(C, F, P).total;
}

size_t hs_final_head_loss_bwd_workspace(int T, int C, int F, int P) {
  return hs::bwd_workspace(T, C, F, P);
}

int hs_final_head_loss_bwd(const void* x, const void* we, const void* gamma,
                           const void* beta, const void* wh, const void* y,
                           const void* welem, const void* scale, void* dx, void* dwe,
                           void* red, void* work, int T, int C, int F, int P, float eps,
                           void* stream) {
  const hs::CeGrads grads{static_cast<const int*>(y), static_cast<const float*>(welem)};
  return int(hs::launch_bwd(x, we, gamma, beta, wh, grads, scale, dx, dwe, red, work, T, C,
                            F, P, eps, static_cast<cudaStream_t>(stream)));
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
