// Decoder tail of HEAL-SWIN for Hopper (sm_90a) in float32, the row kernels and their launch
// plumbing, shared by final_head_f32.cu (K3, K6, K7 and gemm_tn_f32's entries) and
// final_head_depth_f32.cu (K8, K9), which nvcc compiles side by side: FinalPatchExpand_X4 ->
// LayerNorm -> head, fused with the argmax (segmentation predict), with the weighted
// cross entropy (segmentation training) or with the masked depth loss (depth training),
// for the configs that compute in f32 (the paper run configs: dtype None).
//
// Replaces, in f32, five Pallas TPU kernels of heal_swin_tpu/ops/final_head.py:
//   K3 hs_final_head_predict_f32         <- _pred_kernel (fused_final_head_predict, x f32)
//   K6 hs_final_head_loss_f32            <- _fwd_kernel (fused_final_head, x f32)
//   K7 hs_final_head_loss_bwd_f32        <- _bwd_kernel (its custom-VJP backward)
//   K8 hs_final_head_depth_loss_f32      <- _fwd_kernel_depth (fused_final_head_depth)
//   K9 hs_final_head_depth_loss_bwd_f32  <- _bwd_kernel_depth (its custom-VJP backward)
// For every token row x (C) and each of its p sub-pixels, nothing rounded below f32:
//   h_i = x We_i -> LayerNorm (f32 statistics) -> xhat, z_i = xhat gamma + beta ->
//   logits_i = z_i Wh -> log-softmax -> sum w*nll, sum w and the (F, F) confusion matrix
//   (target rows, argmax columns, lowest index on ties; a row holding a NaN counts in
//   no cell).
// K7: the forward recomputed; dlogits = (gloss / den) w (softmax - onehot); dWh += z^T
//   dlogits, dz = dlogits Wh^T -> dgamma = sum dz xhat, dbeta = sum dz and the LayerNorm
//   backward dh -> dx = sum_i dh_i We_i^T; dWe_i = x^T dh_i.
// K3: the same logits -> the argmax per sub-pixel, the lowest index at the max, F - 1
//   for a row holding a NaN (tail_argmax); optionally the f32 logits beside.
// K8: the same logits (F <= 2: mean, logvar) -> the masked depth loss of one kind (l2 /
//   l1 / huber / nll, depth_loss.cuh) against targets t (T, p) whose non-finite entries
//   are background -> sum loss, the count of valid targets and the predictions (T, p F),
//   the logits themselves.  K9: K7 with dlogits = scale * dloss/dlogits (0 at background;
//   the logvar channel 0 but for nll).
//
// Design: f32 FMAs on the CUDA cores, a thread per token row.  The bf16 kernels' layout
// (all p slices of We resident beside a double-buffered x ring, tail_core.cuh) does not
// fit in f32: at C 96, p 4 the slices alone take 147,456 bytes and the ring 98,304 more,
// over a block's 232,448.  So a block holds ONE slice (C x C f32, 36,864 bytes at C 96)
// and walks the sub-pixels in an outer loop: for each slice i it stages We_i and walks
// its 128-row tiles (block b: tiles b, b + grid, ..., the partition of the bf16 kernels
// and of the plain twins), each tile loaded into shared memory (rows padded to C + 1
// floats, so a warp's threads, one per row, read a column without bank conflicts).  A
// thread holds its row's h (C floats) in registers, reads We_i's row k by broadcast
// (float4), and takes the LayerNorm and the cross entropy without shuffles.  The
// sub-pixels are independent in the forward; K7's dx sums over them, and since a block
// walks the same tiles in every slice, the same thread owns the same row each time: it
// writes its dx row at slice 0 and adds to it at the others (no other thread touches
// it, no atomics).
//
// K6's row kernel keeps each thread's sum w*nll and sum w in registers and counts the
// confusion matrix in a shared int array (integer atomics are order-free); one partial
// row [sum w*nll, sum w, F x F] a block, then reduce_rows.  K7 is a launch sequence: its
// row kernel writes dx, dh (T x p C f32 workspace, dh_i in columns i C ..) and one
// partial row [dWh (C x F) | dgamma | dbeta] a block: after the row pass each tile's
// xhat and dlogits go to shared memory (xhat over the spent x tile), and thread c < C
// sums column c over the tile's rows (z and dz recomputed there by the same
// expressions), each tile from zero, the tiles' sums added in registers across the
// block's tiles and slices; then reduce_rows over the partial rows, then dWe = x^T dh
// by gemm_tn_f32 (split over tokens, the splits through reduce_rows).  Every sum across
// blocks runs in a fixed order, so the results do not change from run to run.
//
// K8 and K9 are K6's and K7's row kernels with another loss (the template argument
// Loss: CeLoss or DepthLoss): they make h, xhat, z and the logits through the same
// functions, so K9's recomputed logits are K8's bits as K7's are K6's.  K8's partial row
// is [sum loss, count], and it writes the predictions beside; K9 is K7's launch sequence.
// K3 is K6's row kernel with the epilogue Argmax (its classes, no partial rows): its
// logits are K6's bits, and its classes the argmax of them.
//
// The instantiations: C in 32, 64, 96, 128 and the head padded to NF = 8 or 16 columns
// for the cross entropy and the argmax (F <= 16: the paper's segmentation heads have 8,
// 10 and 12 classes), NF = 4 for the depth head (F <= 2); the depth loss's kind is a
// launch argument.

#pragma once

#include <math_constants.h>

#include <type_traits>

#include "common.cuh"
#include "depth_loss.cuh"

namespace hs {
namespace {

constexpr int F32_ROWS = 128;  // token rows of a tile: one thread each
constexpr int F32_THREADS = F32_ROWS;
constexpr size_t kF32MaxSmem = 232448;  // an H100 block's opt-in shared memory

enum F32Kind : int { kF32Ce = 0, kF32CeBwd = 1, kF32Depth = 2, kF32DepthBwd = 3, kF32Pred = 4 };

// the loss a row kernel takes of its logits: the weighted cross entropy of targets y
// and element weights welem (K6, K7), or the masked depth loss of one kind against
// targets t, a non-finite value marking background (K8, K9; preds: K8's predictions)
struct CeLoss {
  const int* y;
  const float* welem;
};

struct DepthLoss {
  const float* t;
  float* preds;
  int kind;
  float delta;
};

// K3's epilogue in place of a loss: the class of each element (row, sub-pixel)
struct Argmax {
  int* preds;
};

template <class Loss>
constexpr bool kIsDepth = std::is_same<Loss, DepthLoss>::value;
template <class Loss>
constexpr bool kIsPred = std::is_same<Loss, Argmax>::value;

// the row kernels' kinds of a loss: the forward's and the backward's
template <class Loss>
constexpr int kFwdKind = kIsDepth<Loss> ? kF32Depth : kIsPred<Loss> ? kF32Pred : kF32Ce;
template <class Loss>
constexpr int kBwdKind = kIsDepth<Loss> ? kF32DepthBwd : kF32CeBwd;

__host__ __device__ inline bool f32_is_bwd(int kind) {
  return kind == kF32CeBwd || kind == kF32DepthBwd;
}

// shared memory: We_i (C x C) | Wh (C x NF, zero-padded) | gamma | beta | the x tile
// (128 x (C + 1)) | K6: the confusion matrix (F x F int) and the warps' loss sums; K8: the
// warps' loss sums; K7, K9: the tile's dlogits (128 x NF); K3: nothing
struct F32Layout {
  size_t wh, gb, x, red, total;
};

__host__ __device__ inline F32Layout f32_layout(int C, int NF, int F, int kind) {
  F32Layout L;
  size_t off = align128(size_t(C) * C * 4);
  L.wh = off; off += align128(size_t(C) * NF * 4);
  L.gb = off; off += align128(size_t(2) * C * 4);
  L.x = off; off += align128(size_t(F32_ROWS) * (C + 1) * 4);
  L.red = off;
  if (f32_is_bwd(kind))
    off += align128(size_t(F32_ROWS) * NF * 4);
  else if (kind != kF32Pred)
    off += (kind == kF32Ce ? align128(size_t(F) * F * 4) : 0) +
           align128(2 * (F32_THREADS / 32) * 4);
  L.total = off;
  return L;
}

// the block's resident head and LayerNorm parameters: Wh with its padding columns zeroed
template <int C, int NF>
__device__ __forceinline__ void stage_head(float* whs, float* gs, const float* __restrict__ wh,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta, int F) {
  for (int idx = threadIdx.x; idx < C * NF; idx += F32_THREADS) {
    const int r = idx / NF, f = idx - r * NF;
    whs[idx] = f < F ? wh[size_t(r) * F + f] : 0.f;
  }
  for (int c = threadIdx.x; c < C; c += F32_THREADS) {
    gs[c] = gamma[c];
    gs[C + c] = beta[c];
  }
}

// We_i (C x C) into shared memory, 16 bytes at a time
template <int C>
__device__ __forceinline__ void stage_slice(float* wes, const float* __restrict__ wei) {
  const float4* src = reinterpret_cast<const float4*>(wei);
  float4* dst = reinterpret_cast<float4*>(wes);
  for (int idx = threadIdx.x; idx < C * C / 4; idx += F32_THREADS) dst[idx] = src[idx];
}

// the rows of tile `tile` that exist into xs (ld C + 1); returns their count
template <int C>
__device__ __forceinline__ int load_tile(float* xs, const float* __restrict__ x, int tile,
                                         int T) {
  const int rows = min(F32_ROWS, T - tile * F32_ROWS);
  const float4* src = reinterpret_cast<const float4*>(x + size_t(tile) * F32_ROWS * C);
  for (int idx = threadIdx.x; idx < rows * C / 4; idx += F32_THREADS) {
    const float4 v = src[idx];
    const int e = idx * 4, r = e / C, c = e - r * C;
    float* d = xs + r * (C + 1) + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  return rows;
}

// h = x We_i for the thread's row xr (C floats, ld 1), We_i's rows by broadcast
template <int C>
__device__ __forceinline__ void expand_row(float (&h)[C], const float* xr, const float* wes) {
#pragma unroll
  for (int c = 0; c < C; ++c) h[c] = 0.f;
#pragma unroll 2
  for (int k = 0; k < C; ++k) {
    const float xk = xr[k];
    const float4* w = reinterpret_cast<const float4*>(wes + k * C);
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 v = w[q];
      h[4 * q] = fmaf(xk, v.x, h[4 * q]);
      h[4 * q + 1] = fmaf(xk, v.y, h[4 * q + 1]);
      h[4 * q + 2] = fmaf(xk, v.z, h[4 * q + 2]);
      h[4 * q + 3] = fmaf(xk, v.w, h[4 * q + 3]);
    }
  }
}

// the row's LayerNorm: h -> xhat in place; returns rstd
template <int C>
__device__ __forceinline__ float ln_xhat(float (&h)[C], float eps) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) s += h[c];
  const float mean = s / C;
  float v = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    h[c] -= mean;
    v = fmaf(h[c], h[c], v);
  }
  const float rstd = rsqrtf(v / C + eps);
#pragma unroll
  for (int c = 0; c < C; ++c) h[c] *= rstd;
  return rstd;
}

// z = xhat gamma + beta: the one expression of z, in the row pass and K7's column pass
__device__ __forceinline__ float z_of(float xhat, float g, float b) { return fmaf(xhat, g, b); }

// lf = z Wh (NF columns, 0 past F since Wh is zero-padded)
template <int C, int NF>
__device__ __forceinline__ void head_row(float (&lf)[NF], const float (&xh)[C],
                                         const float* gs, const float* whs) {
#pragma unroll
  for (int f = 0; f < NF; ++f) lf[f] = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float z = z_of(xh[c], gs[c], gs[C + c]);
    const float4* w = reinterpret_cast<const float4*>(whs + c * NF);
#pragma unroll
    for (int q = 0; q < NF / 4; ++q) {
      const float4 v = w[q];
      lf[4 * q] = fmaf(z, v.x, lf[4 * q]);
      lf[4 * q + 1] = fmaf(z, v.y, lf[4 * q + 1]);
      lf[4 * q + 2] = fmaf(z, v.z, lf[4 * q + 2]);
      lf[4 * q + 3] = fmaf(z, v.w, lf[4 * q + 3]);
    }
  }
}

struct CeRow {
  float mx, se;  // the max logit (NaN where a logit is NaN), the sum of exp(logit - max)
  int best;      // the lowest column at the max; F for a row holding a NaN
};

// the row's softmax over its F logits: ex = exp(lf - max) (0 past F)
template <int NF>
__device__ __forceinline__ CeRow ce_row(const float (&lf)[NF], float (&ex)[NF], int F) {
  CeRow r;
  r.mx = -CUDART_INF_F;
  bool nan = false;
#pragma unroll
  for (int f = 0; f < NF; ++f)
    if (f < F) {
      nan |= isnan(lf[f]);
      r.mx = fmaxf(r.mx, lf[f]);  // fmaxf drops a NaN: the flag keeps it
    }
  if (nan) r.mx = CUDART_NAN_F;
  r.se = 0.f;
  r.best = F;
#pragma unroll
  for (int f = NF - 1; f >= 0; --f) {
    ex[f] = f < F ? expf(lf[f] - r.mx) : 0.f;
    if (f < F && lf[f] >= r.mx) r.best = f;
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) r.se += ex[f];
  return r;
}

// K3's class of a row's logits: the lowest column at the max, F - 1 where a logit is
// NaN (the plain argmax_lowest: no column compares >= a NaN max, and the index clamps)
template <int NF>
__device__ __forceinline__ int argmax_row(const float (&lf)[NF], int F) {
  float mx = -CUDART_INF_F;
  bool nan = false;
#pragma unroll
  for (int f = 0; f < NF; ++f)
    if (f < F) {
      nan |= isnan(lf[f]);
      mx = fmaxf(mx, lf[f]);
    }
  int best = F - 1;
#pragma unroll
  for (int f = NF - 1; f >= 0; --f)
    if (!nan && f < F && lf[f] >= mx) best = f;
  return best;
}

// the logit of the row's target (0 for a target outside 0 .. F - 1, as the one-hot)
template <int NF>
__device__ __forceinline__ float target_logit(const float (&lf)[NF], int yi, int F) {
  float ly = 0.f;
#pragma unroll
  for (int f = 0; f < NF; ++f)
    if (f < F && f == yi) ly = lf[f];
  return ly;
}

template <int NF>
__device__ __forceinline__ void write_tap(float* __restrict__ tap, const float (&lf)[NF],
                                          size_t row, int i, int P, int F) {
  float* t = tap + (row * P + i) * F;
#pragma unroll
  for (int f = 0; f < NF; ++f)
    if (f < F) t[f] = lf[f];
}

// the depth loss of element e (row, sub-pixel) from its logits: (loss, 1) added to
// (num, den) where its target is valid
template <int NF>
__device__ __forceinline__ void depth_sums(const float (&lf)[NF], const DepthLoss& loss,
                                           size_t e, float& num, float& den) {
  const float tv = loss.t[e];
  const bool valid = isfinite(tv);
  if (valid) {
    const float l[2] = {lf[0], lf[1]};
    num += depth_loss(l, depth_diff(l[0], tv, valid), loss.kind, loss.delta);
    den += 1.f;
  }
}

// K9's dlogits of element e: scale * dloss/dlogits, 0 at background and past F
template <int NF>
__device__ __forceinline__ void depth_dl(float (&dl)[NF], const float (&lf)[NF],
                                         const DepthLoss& loss, size_t e, float scale, int F) {
  const float tv = loss.t[e];
  const bool valid = isfinite(tv);
  const float l[2] = {lf[0], lf[1]};
  float g[2];
  depth_grads(l, depth_diff(l[0], tv, valid), valid, loss.kind, loss.delta, g);
#pragma unroll
  for (int f = 2; f < NF; ++f) dl[f] = 0.f;
  dl[0] = __fmul_rn(scale, g[0]);
  dl[1] = F > 1 ? __fmul_rn(scale, g[1]) : 0.f;
}

// K6 (CeLoss): the partial row [sum w*nll, sum w, confusion matrix (F x F)] of each
// block; K8 (DepthLoss): [sum loss, count of valid targets], and the predictions; K3
// (Argmax): the classes (T, p), no partial rows.  tap, where not null, gets the logits
// (T, p, F)
template <int C, int NF, class Loss>
__global__ void __launch_bounds__(F32_THREADS)
tail_loss_f32_kernel(const float* __restrict__ x, const float* __restrict__ we,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     const float* __restrict__ wh, const Loss loss, float* __restrict__ part,
                     float* __restrict__ tap, int T, int F, int P, float eps) {
  constexpr bool CE = std::is_same<Loss, CeLoss>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const F32Layout L = f32_layout(C, NF, F, kFwdKind<Loss>);
  float* wes = reinterpret_cast<float*>(smem);
  float* whs = reinterpret_cast<float*>(smem + L.wh);
  float* gs = reinterpret_cast<float*>(smem + L.gb);
  float* xs = reinterpret_cast<float*>(smem + L.x);
  int* cm = reinterpret_cast<int*>(smem + L.red);
  float* wsum = reinterpret_cast<float*>(smem + L.red + (CE ? align128(size_t(F) * F * 4) : 0));
  const int tid = threadIdx.x;
  const int tiles = (T + F32_ROWS - 1) / F32_ROWS;

  stage_head<C, NF>(whs, gs, wh, gamma, beta, F);
  if constexpr (CE)
    for (int idx = tid; idx < F * F; idx += F32_THREADS) cm[idx] = 0;
  float num = 0.f, den = 0.f;
  for (int i = 0; i < P; ++i) {
    __syncthreads();  // the last slice's rows are done with wes
    stage_slice<C>(wes, we + size_t(i) * C * C);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      __syncthreads();  // the slice has landed; the last tile's rows are done with xs
      const int rows = load_tile<C>(xs, x, tile, T);
      __syncthreads();
      if (tid >= rows) continue;
      const size_t row = size_t(tile) * F32_ROWS + tid, e = row * P + i;
      float h[C], lf[NF];
      expand_row<C>(h, xs + tid * (C + 1), wes);
      ln_xhat<C>(h, eps);
      head_row<C, NF>(lf, h, gs, whs);
      if (tap != nullptr) write_tap<NF>(tap, lf, row, i, P, F);
      if constexpr (kIsPred<Loss>) {
        loss.preds[e] = argmax_row<NF>(lf, F);
      } else if constexpr (CE) {
        float ex[NF];
        const CeRow ce = ce_row<NF>(lf, ex, F);
        const int yi = loss.y[e];
        const float wi = loss.welem[e];
        num += wi * (ce.mx + logf(ce.se) - target_logit<NF>(lf, yi, F));
        den += wi;
        if (ce.best < F && yi >= 0 && yi < F) atomicAdd(cm + yi * F + ce.best, 1);  // order-free
      } else {
        depth_sums<NF>(lf, loss, e, num, den);
        write_tap<NF>(loss.preds, lf, row, i, P, F);  // the predictions: the f32 logits
      }
    }
  }
  if constexpr (kIsPred<Loss>) return;
  num = warp_sum(num);
  den = warp_sum(den);
  const int warp = tid >> 5;
  if ((tid & 31) == 0) {
    wsum[warp] = num;
    wsum[F32_THREADS / 32 + warp] = den;
  }
  __syncthreads();
  float* prow = part + size_t(blockIdx.x) * (CE ? 2 + F * F : 2);
  if (tid == 0) {
    float n = 0.f, d = 0.f;
    for (int w = 0; w < F32_THREADS / 32; ++w) {
      n += wsum[w];
      d += wsum[F32_THREADS / 32 + w];
    }
    prow[0] = n;
    prow[1] = d;
  }
  if constexpr (CE)
    for (int idx = tid; idx < F * F; idx += F32_THREADS) prow[2 + idx] = float(cm[idx]);
}

// K7's (CeLoss) and K9's (DepthLoss) row kernel: dx (T x C f32), dh (T x p C f32: dh_i
// in columns i C ..) and the partial row [dWh (C x F) | dgamma (C) | dbeta (C)] of each
// block, for the loss gradient scale = gloss / den (K7) or gloss / max(count, 1) (K9), on
// the device; tap as K6's
template <int C, int NF, class Loss>
__global__ void __launch_bounds__(F32_THREADS)
tail_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ we,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const float* __restrict__ wh, const Loss loss,
                    const float* __restrict__ scale_p, float* __restrict__ dx,
                    float* __restrict__ dh, float* __restrict__ part, float* __restrict__ tap,
                    int T, int F, int P, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const F32Layout L = f32_layout(C, NF, F, kBwdKind<Loss>);
  float* wes = reinterpret_cast<float*>(smem);
  float* whs = reinterpret_cast<float*>(smem + L.wh);
  float* gs = reinterpret_cast<float*>(smem + L.gb);
  float* xs = reinterpret_cast<float*>(smem + L.x);
  float* dls = reinterpret_cast<float*>(smem + L.red);
  const int tid = threadIdx.x;
  const int tiles = (T + F32_ROWS - 1) / F32_ROWS;
  const float scale = *scale_p;
  const bool owns_col = tid < C;  // thread c < C sums column c of dWh, dgamma, dbeta

  stage_head<C, NF>(whs, gs, wh, gamma, beta, F);
  __syncthreads();
  float whc[NF], cdwh[NF], cdg = 0.f, cdb = 0.f, gc = 0.f, bc = 0.f;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    whc[f] = owns_col ? whs[tid * NF + f] : 0.f;
    cdwh[f] = 0.f;
  }
  if (owns_col) {
    gc = gs[tid];
    bc = gs[C + tid];
  }
  for (int i = 0; i < P; ++i) {
    __syncthreads();  // the last slice's rows are done with wes
    stage_slice<C>(wes, we + size_t(i) * C * C);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      __syncthreads();  // the slice has landed; the last tile's column sums are done
      const int rows = load_tile<C>(xs, x, tile, T);
      __syncthreads();
      const bool active = tid < rows;
      const size_t row = size_t(tile) * F32_ROWS + tid, e = row * P + i;
      float h[C], dl[NF];
      float rstd = 0.f;
      if (active) {
        float lf[NF];
        expand_row<C>(h, xs + tid * (C + 1), wes);
        rstd = ln_xhat<C>(h, eps);
        head_row<C, NF>(lf, h, gs, whs);
        if (tap != nullptr) write_tap<NF>(tap, lf, row, i, P, F);
        if constexpr (kIsDepth<Loss>) {
          depth_dl<NF>(dl, lf, loss, e, scale, F);
        } else {
          const CeRow ce = ce_row<NF>(lf, dl, F);
          const int yi = loss.y[e];
          const float sw = __fmul_rn(scale, loss.welem[e]);
#pragma unroll
          for (int f = 0; f < NF; ++f)
            dl[f] = f < F ? sw * (__fdiv_rn(dl[f], ce.se) - (f == yi ? 1.f : 0.f)) : 0.f;
        }
      }
      __syncthreads();  // every row has read its x: the tile becomes the rows' xhat
      if (active) {
        float* xr = xs + tid * (C + 1);
#pragma unroll
        for (int c = 0; c < C; ++c) xr[c] = h[c];
#pragma unroll
        for (int f = 0; f < NF; ++f) dls[tid * NF + f] = dl[f];

        // the LayerNorm backward: the row means m1, m2 of dz gamma and dz gamma xhat,
        // then dh, recomputing dz (the same bits); h becomes dh
        float m1 = 0.f, m2 = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float dz = 0.f;
#pragma unroll
          for (int f = 0; f < NF; ++f) dz = fmaf(dl[f], whs[c * NF + f], dz);
          const float dzh = dz * gs[c];
          m1 += dzh;
          m2 = fmaf(dzh, h[c], m2);
        }
        m1 /= C;
        m2 /= C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float dz = 0.f;
#pragma unroll
          for (int f = 0; f < NF; ++f) dz = fmaf(dl[f], whs[c * NF + f], dz);
          h[c] = rstd * (dz * gs[c] - m1 - h[c] * m2);
        }
        float4* dhr = reinterpret_cast<float4*>(dh + row * P * C + size_t(i) * C);
#pragma unroll
        for (int q = 0; q < C / 4; ++q)
          dhr[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);

        // dx += dh_i We_i^T: row k of We_i by broadcast, four columns of dx at a time
        float4* dxr = reinterpret_cast<float4*>(dx + row * C);
#pragma unroll 1
        for (int k4 = 0; k4 < C / 4; ++k4) {
          float a[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4* w = reinterpret_cast<const float4*>(wes + (4 * k4 + j) * C);
            float s = 0.f;
#pragma unroll
            for (int q = 0; q < C / 4; ++q) {
              const float4 v = w[q];
              s = fmaf(h[4 * q], v.x, s);
              s = fmaf(h[4 * q + 1], v.y, s);
              s = fmaf(h[4 * q + 2], v.z, s);
              s = fmaf(h[4 * q + 3], v.w, s);
            }
            a[j] = s;
          }
          float4 v = make_float4(a[0], a[1], a[2], a[3]);
          if (i > 0) {  // this thread wrote the row at slice 0
            const float4 o = dxr[k4];
            v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
          }
          dxr[k4] = v;
        }
      }
      __syncthreads();  // the tile's xhat and dlogits are in place
      if (owns_col) {
        // the tile's column sums from zero, then added to the block's: a blocked sum, so
        // that no running sum takes more than a tile's rows one after another (a column
        // whose terms share a sign, as dbeta's under the l1 loss, loses ~n eps in a
        // sequential sum of n terms)
        float tdwh[NF], tdg = 0.f, tdb = 0.f;
#pragma unroll
        for (int f = 0; f < NF; ++f) tdwh[f] = 0.f;
        for (int r = 0; r < rows; ++r) {
          const float xv = xs[r * (C + 1) + tid];
          const float z = z_of(xv, gc, bc);
          const float4* d4 = reinterpret_cast<const float4*>(dls + r * NF);
          float dz = 0.f;
#pragma unroll
          for (int q = 0; q < NF / 4; ++q) {
            const float4 d = d4[q];
            const float dd[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              dz = fmaf(dd[j], whc[4 * q + j], dz);
              tdwh[4 * q + j] = fmaf(z, dd[j], tdwh[4 * q + j]);
            }
          }
          tdg = fmaf(dz, xv, tdg);
          tdb += dz;
        }
#pragma unroll
        for (int f = 0; f < NF; ++f) cdwh[f] += tdwh[f];
        cdg += tdg;
        cdb += tdb;
      }
    }
  }
  if (owns_col) {
    float* prow = part + size_t(blockIdx.x) * (C * F + 2 * C);
#pragma unroll
    for (int f = 0; f < NF; ++f)
      if (f < F) prow[tid * F + f] = cdwh[f];
    prow[C * F + tid] = cdg;
    prow[C * F + C + tid] = cdb;
  }
}

// ---------------------------------------------------------------------------------
// gemm_tn_f32: out (M x N f32) = A^T B over K rows, A (K x M) and B (K x N) row-major f32
// (dWe = x^T dh).  K (the tokens, up to 262144) splits into 2048-row chunks (<= 128
// splits); a block is one 64 x 64 output tile of one chunk, its 256 threads 4 x 4 outputs
// each from 16-row slices of A and B staged in shared memory; the split partials go
// through reduce_rows.  f32 FMAs on the CUDA cores.
// ---------------------------------------------------------------------------------

constexpr int FG_T = 64;   // output tile (FG_T x FG_T)
constexpr int FG_K = 16;   // rows of a staged slice
constexpr int FG_THREADS = 256;
constexpr int FG_CHUNK = 2048;
constexpr int FG_MAX_SPLITS = 128;

int gemm_f32_splits(int K) {
  const int s = (K + FG_CHUNK - 1) / FG_CHUNK;
  return s < FG_MAX_SPLITS ? s : FG_MAX_SPLITS;
}

// grid (ceil(M / 64), ceil(N / 64), splits): part[z] (M x N) = A[k0:k1]^T B[k0:k1]
__global__ void __launch_bounds__(FG_THREADS)
gemm_tn_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ part, int K, int M, int N, int chunk) {
  __shared__ __align__(16) float As[FG_K * FG_T];
  __shared__ __align__(16) float Bs[FG_K * FG_T];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;  // output rows m0 + 4 ty .., columns n0 + 4 tx ..
  const int m0 = blockIdx.x * FG_T, n0 = blockIdx.y * FG_T;
  const int k0 = blockIdx.z * chunk, k1 = min(K, k0 + chunk);
  // each thread stages one float4 of A and of B per slice (16 rows x 16 float4s); M and N
  // are multiples of 4, so a float4 is wholly inside or wholly outside
  const int lr = tid >> 4, lc = (tid & 15) * 4;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int k = k0; k < k1; k += FG_K) {
    float4 va = make_float4(0.f, 0.f, 0.f, 0.f), vb = va;
    if (m0 + lc < M) va = *reinterpret_cast<const float4*>(A + size_t(k + lr) * M + m0 + lc);
    if (n0 + lc < N) vb = *reinterpret_cast<const float4*>(B + size_t(k + lr) * N + n0 + lc);
    *reinterpret_cast<float4*>(As + lr * FG_T + lc) = va;
    *reinterpret_cast<float4*>(Bs + lr * FG_T + lc) = vb;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FG_K; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(As + kk * FG_T + 4 * ty);
      const float4 b4 = *reinterpret_cast<const float4*>(Bs + kk * FG_T + 4 * tx);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
  float* out = part + size_t(blockIdx.z) * M * N;
  const int n = n0 + 4 * tx;
  if (n >= N) return;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int m = m0 + 4 * ty + a;
    if (m < M)
      *reinterpret_cast<float4*>(out + size_t(m) * N + n) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  }
}

size_t gemm_tn_f32_tmp_floats(int K, int M, int N) {
  const int S = gemm_f32_splits(K);
  return size_t(S) * M * N + reduce_rows_tmp_floats(S, M * N);
}

cudaError_t gemm_tn_f32(const float* A, const float* B, float* out, int K, int M, int N,
                        float* tmp, cudaStream_t stream) {
  if (K % FG_K || M % 4 || N % 4 || K <= 0) return cudaErrorInvalidValue;
  const int S = gemm_f32_splits(K);
  int chunk = (K + S - 1) / S;
  chunk = (chunk + FG_K - 1) / FG_K * FG_K;  // an empty last split writes zeros
  const dim3 grid((M + FG_T - 1) / FG_T, (N + FG_T - 1) / FG_T, S);
  gemm_tn_f32_kernel<<<grid, FG_THREADS, 0, stream>>>(A, B, tmp, K, M, N, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_rows(tmp, out, S, M * N, tmp + size_t(S) * M * N, stream);
}

// ---------------------------------------------------------------------------------
// launch plumbing
// ---------------------------------------------------------------------------------

// f(C, NF) for the instantiation of C (32, 64, 96, 128) and F: the cross entropy's head
// (F <= 8: NF 8; <= 16: NF 16) or, with DEPTH, the depth head (F <= 2: NF 4)
template <bool DEPTH, typename Fn>
cudaError_t with_f32(int C, int F, Fn f) {
  if (F < 1 || F > (DEPTH ? 2 : 16)) return cudaErrorInvalidValue;
  auto nf = [&](auto c) {
    if constexpr (DEPTH) return f(c, std::integral_constant<int, 4>{});
    else
      return F <= 8 ? f(c, std::integral_constant<int, 8>{})
                    : f(c, std::integral_constant<int, 16>{});
  };
  switch (C) {
    case 32: return nf(std::integral_constant<int, 32>{});
    case 64: return nf(std::integral_constant<int, 64>{});
    case 96: return nf(std::integral_constant<int, 96>{});
    case 128: return nf(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

inline int nf_of(int F, bool depth) { return depth ? 4 : F <= 8 ? 8 : 16; }

template <int C, int NF, class Loss, bool BWD>
const void* f32_kernel() {
  if constexpr (BWD) return reinterpret_cast<const void*>(tail_bwd_f32_kernel<C, NF, Loss>);
  else return reinterpret_cast<const void*>(tail_loss_f32_kernel<C, NF, Loss>);
}

// the row kernel's grid: min(its tiles, the blocks the card holds at once at its shared
// memory), after its one opt-in to the most shared memory a block may have
template <int C, int NF, class Loss, bool BWD>
cudaError_t f32_grid(int T, int F, int* grid) {
  static std::atomic<unsigned> done{0};
  const void* k = f32_kernel<C, NF, Loss, BWD>();
  cudaError_t e = smem_opt_in(k, kF32MaxSmem, done);
  if (e != cudaSuccess) return e;
  const size_t smem = f32_layout(C, NF, F, BWD ? kBwdKind<Loss> : kFwdKind<Loss>).total;
  if (smem > kF32MaxSmem || T <= 0) return cudaErrorInvalidValue;
  int per = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k, F32_THREADS, smem);
  if (e != cudaSuccess) return e;
  if (per < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (T + F32_ROWS - 1) / F32_ROWS, resident = per * sm_count();
  *grid = tiles < resident ? tiles : resident;
  return cudaSuccess;
}

template <class Loss, bool BWD>
int f32_grid_of(int T, int C, int F) {
  int G = 0;
  const cudaError_t e = with_f32<kIsDepth<Loss>>(C, F, [&](auto c, auto nf) {
    return f32_grid<decltype(c)::value, decltype(nf)::value, Loss, BWD>(T, F, &G);
  });
  return e == cudaSuccess ? G : 0;
}

// a forward's partial row: K6's [sum w*nll, sum w, confusion matrix], K8's [sum loss,
// count]
template <class Loss>
inline int f32_part_width(int F) {
  return kIsDepth<Loss> ? 2 : 2 + F * F;
}

// K6's and K8's workspace: the partial rows, then reduce_rows' scratch
template <class Loss>
size_t f32_loss_workspace(int T, int C, int F) {
  const int G = f32_grid_of<Loss, false>(T, C, F), W = f32_part_width<Loss>(F);
  return align128(size_t(G) * W * 4) + align128(reduce_rows_tmp_floats(G, W) * 4);
}

// K6 and K8: the row kernel, then reduce_rows over its partial rows into red
template <class Loss>
cudaError_t launch_f32_loss(const void* x, const void* we, const void* gamma, const void* beta,
                            const void* wh, const Loss& loss, void* red, void* work, void* tap,
                            int T, int C, int F, int P, float eps, cudaStream_t s) {
  return with_f32<kIsDepth<Loss>>(C, F, [&](auto c, auto nf) {
    constexpr int CC = decltype(c)::value, NF = decltype(nf)::value;
    int G = 0;
    cudaError_t e = f32_grid<CC, NF, Loss, false>(T, F, &G);
    if (e != cudaSuccess) return e;
    const int W = f32_part_width<Loss>(F);
    float* part = static_cast<float*>(work);
    float* tmp = reinterpret_cast<float*>(static_cast<unsigned char*>(work) +
                                          align128(size_t(G) * W * 4));
    tail_loss_f32_kernel<CC, NF, Loss>
        <<<G, F32_THREADS, f32_layout(CC, NF, F, kFwdKind<Loss>).total, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(we),
            static_cast<const float*>(gamma), static_cast<const float*>(beta),
            static_cast<const float*>(wh), loss, part, static_cast<float*>(tap), T, F, P, eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    return reduce_rows(part, static_cast<float*>(red), G, W, tmp, s);
  });
}

// K3: the row kernel with the Argmax epilogue, the classes (T, p) into preds
inline cudaError_t launch_f32_pred(const void* x, const void* we, const void* gamma,
                                   const void* beta, const void* wh, void* preds, void* tap,
                                   int T, int C, int F, int P, float eps, cudaStream_t s) {
  return with_f32<false>(C, F, [&](auto c, auto nf) {
    constexpr int CC = decltype(c)::value, NF = decltype(nf)::value;
    int G = 0;
    cudaError_t e = f32_grid<CC, NF, Argmax, false>(T, F, &G);
    if (e != cudaSuccess) return e;
    const size_t smem = f32_layout(CC, NF, F, kF32Pred).total;
    tail_loss_f32_kernel<CC, NF, Argmax><<<G, F32_THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(we),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const float*>(wh), Argmax{static_cast<int*>(preds)}, nullptr,
        static_cast<float*>(tap), T, F, P, eps);
    return cudaGetLastError();
  });
}

// K7's and K9's row kernel alone: dx, dh and its partial rows part (grid x (C F + 2C))
template <class Loss>
cudaError_t launch_f32_bwd_rows(const void* x, const void* we, const void* gamma,
                                const void* beta, const void* wh, const Loss& loss,
                                const void* scale, void* dx, void* dh, void* part, void* tap,
                                int T, int C, int F, int P, float eps, cudaStream_t s) {
  return with_f32<kIsDepth<Loss>>(C, F, [&](auto c, auto nf) {
    constexpr int CC = decltype(c)::value, NF = decltype(nf)::value;
    int G = 0;
    cudaError_t e = f32_grid<CC, NF, Loss, true>(T, F, &G);
    if (e != cudaSuccess) return e;
    tail_bwd_f32_kernel<CC, NF, Loss>
        <<<G, F32_THREADS, f32_layout(CC, NF, F, kBwdKind<Loss>).total, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(we),
            static_cast<const float*>(gamma), static_cast<const float*>(beta),
            static_cast<const float*>(wh), loss, static_cast<const float*>(scale),
            static_cast<float*>(dx), static_cast<float*>(dh), static_cast<float*>(part),
            static_cast<float*>(tap), T, F, P, eps);
    return cudaGetLastError();
  });
}

// K7's and K9's workspace: dh (T x p C f32), the row kernel's partial rows, then the
// scratch of reduce_rows or gemm_tn_f32, whichever is larger
struct F32BwdWork {
  size_t part, tmp, total;
  int grid;
};

template <class Loss>
F32BwdWork f32_bwd_work(int T, int C, int F, int P) {
  F32BwdWork w;
  w.grid = f32_grid_of<Loss, true>(T, C, F);
  const int W = C * F + 2 * C;
  size_t tmp = reduce_rows_tmp_floats(w.grid, W);
  const size_t gt = gemm_tn_f32_tmp_floats(T, C, P * C);
  tmp = tmp > gt ? tmp : gt;
  w.part = align128(size_t(T) * P * C * 4);
  w.tmp = w.part + align128(size_t(w.grid) * W * 4);
  w.total = w.tmp + align128(tmp * 4);
  return w;
}

// K7 and K9: the row kernel, reduce_rows over its partial rows into red = [dWh | dgamma |
// dbeta], then dWe = x^T dh by gemm_tn_f32, on one stream
template <class Loss>
cudaError_t launch_f32_bwd(const void* x, const void* we, const void* gamma, const void* beta,
                           const void* wh, const Loss& loss, const void* scale, void* dx,
                           void* dwe, void* red, void* work, int T, int C, int F, int P,
                           float eps, cudaStream_t s) {
  const F32BwdWork w = f32_bwd_work<Loss>(T, C, F, P);
  if (w.grid < 1) return cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(work);
  float* dh = reinterpret_cast<float*>(base);
  float* part = reinterpret_cast<float*>(base + w.part);
  float* tmp = reinterpret_cast<float*>(base + w.tmp);
  cudaError_t e = launch_f32_bwd_rows(x, we, gamma, beta, wh, loss, scale, dx, dh, part,
                                      nullptr, T, C, F, P, eps, s);
  if (e != cudaSuccess) return e;
  e = reduce_rows(part, static_cast<float*>(red), w.grid, C * F + 2 * C, tmp, s);
  if (e != cudaSuccess) return e;
  return gemm_tn_f32(static_cast<const float*>(x), dh, static_cast<float*>(dwe), T, C, P * C,
                     tmp, s);
}

inline CeLoss ce_loss(const void* y, const void* welem) {
  return CeLoss{static_cast<const int*>(y), static_cast<const float*>(welem)};
}

// the depth loss of kind (DepthKind) on targets t; false where the kind or F is not taken
inline bool depth_loss_of(const void* t, void* preds, int kind, float delta, int F,
                          DepthLoss* out) {
  if (kind < kL2 || kind > kNll || (kind == kNll && F != 2)) return false;
  *out = DepthLoss{static_cast<const float*>(t), static_cast<float*>(preds), kind, delta};
  return true;
}

}  // namespace
}  // namespace hs
