// Decoder tail of HEAL-SWIN for Hopper (sm_90a) in float32, the tile kernels and their
// launch plumbing, shared by final_head_f32.cu (K3, K6, K7) and final_head_depth_f32.cu
// (K8, K9), which nvcc compiles side by side: FinalPatchExpand_X4 -> LayerNorm -> head,
// fused with the argmax (segmentation predict), with the weighted cross entropy
// (segmentation training) or with the masked depth loss (depth training), for the
// configs that compute in f32 (the paper run configs: dtype None).
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
//   for a row holding a NaN; optionally the f32 logits beside.
// K8: the same logits (F <= 2: mean, logvar) -> the masked depth loss of one kind (l2 /
//   l1 / huber / nll, depth_loss.cuh) against targets t (T, p) whose non-finite entries
//   are background -> sum loss, the count of valid targets and the predictions (T, p F),
//   the logits themselves.  K9: K7 with dlogits = scale * dloss/dlogits (0 at background;
//   the logvar channel 0 but for nll).
//
// What bounds them.  At the paper tail (T 262,144, C 96, p 4) the forward does 2 T p C^2
// (+ the head) = 19.6 GFLOP on ~100 MB of f32 tokens, the backward three times the
// products on twice the bytes: both bounded by the arithmetic, which has to be f32-exact
// (the kernels are held to the plain f32 versions within 1e-5).  So every product runs on
// the tensor cores in 3xTF32 (tf32.cuh), as the f32 K1 and K2 do.
//
// The tile core.  A block of 8 warps walks 128-row tiles of the tokens (block b: tiles b,
// b + grid, ...); a warp owns 16 rows of a tile.  The bf16 kernels' layout (all p slices
// of We resident, tail_core.cuh) does not fit in f32, so a block holds ONE slice We_i (C x
// C f32, rows padded to C + 8 floats) and walks the sub-pixels in an outer loop, each over
// the same tiles.  A tile of x arrives by cp.async (rows padded to C + 4 floats; rows past
// T zero-filled).  Then, for the warp's 16 rows, one function makes everything every
// kernel needs:
//   tf_expand: h = x We_i, mma.sync m16n8k8 in 3xTF32, k ascending in steps of 8 from zero
//     sums, 32 columns at a time with the small terms in their own accumulator
//     (mma_3xtf32_apart, as the logits and dx), h in the accumulators (16 x C: C / 8
//     n-tiles, 4 C / 8 floats a lane);
//   tf_layernorm: the statistics over each row's quad with explicitly rounded operations,
//     xhat in place;
//   tf_logits: z = fmaf(xhat, gamma, beta) and logits = z Wh, the head zero-padded to NH =
//     8 or 16 columns.  The A fragments of z come straight from the accumulators: a lane
//     holds columns 2c and 2c + 1 of each 8-column step where an A fragment wants k = c
//     and c + 4, so the k index of each step runs over the columns in the order (0, 2, 4,
//     6, 1, 3, 5, 7), and Wh's rows are read in the same order (no shuffle).
// An mma's result depends only on its fragments, so every kernel that calls these on the
// same x and weights gets the same bits: K7's recomputed logits are K6's, K9's are K8's,
// and K3's classes are the argmax of logits that are K6's.  The logits go to a 128 x NH
// tile in shared memory, and the per-row epilogues of the cross entropy, the depth loss
// and the argmax run there, a lane per row (lanes 0-15 of each warp).
//
// K6, K8 (tail_fwd_3xtf32_kernel<C, NF, CeLoss / DepthLoss>): the epilogue's sums in
// registers (the confusion matrix in a shared int array: integer atomics are order-free),
// one partial row a block [sum w*nll, sum w, F x F] or [sum loss, count], then
// reduce_rows.  K3 (<C, NF, Argmax>): the classes, no partial rows.
//
// K7, K9 (tail_bwd_3xtf32_kernel): for each tile, after the forward recomputed (z kept in a
// second tile), the epilogue writes each row's dlogits over its logits; then per warp
//   dz = dlogits Wh^T (3xTF32, recomputed in a second pass rather than held) and the
//     LayerNorm backward: dh in place of xhat; the column sums of dz xhat and dz over the
//     warp's 16 rows (a reduce-scatter over the 8 row groups: each lane keeps C / 16 of
//     them), added to the warp's running sums;
//   dx (+)= dh We_i^T, dh's A fragments straight from the accumulators (the permuted k of
//     tf_logits; We_i's rows read as float2), 32 columns of dx at a time; the same thread
//     owns the same dx elements in every slice, so it writes them at slice 0 and adds at
//     the others (no atomics);
// and per block, over the tile's rows:
//   dWh += z^T dlogits (each warp one or two 16 x 8 output tiles, from zero each tile);
//   then dh over z in the second tile, and dWe_i += x^T dh (8 warps of (C / 2) x (C / 4)
//     outputs, 4 (C / 32)^2 accumulators a lane: each tile's sum from zero, added rounded
//     to nearest to the block's sum for slice i).
// In both block products the k index (the rows) runs in the order (0, 2, 4, 6, 1, 3, 5,
// 7) of each 8-row step, so that x, z and dh (rows padded to C + 4 floats) and the
// dlogits (NH + 4) are read without bank conflicts.  One partial row a block [dWe (C x p C)
// | dWh (C x F) | dgamma | dbeta]: dWe_i at the end of slice i, the rest at the end of
// the walk (dgamma and dbeta: the warps' sums added in a fixed order); then reduce_rows
// over the partial rows.  No T x p C workspace, no float atomics, and every sum across
// lanes, warps and blocks in a fixed order, so two launches are bit-equal.
//
// The instantiations: C in 32, 64, 96, 128 and the head padded to NF = 8 or 16 columns
// for the cross entropy and the argmax (F <= 16: the paper's segmentation heads have 8,
// 10 and 12 classes), NF = 4 for the depth head (F <= 2; 8 columns on the tensor cores);
// the depth loss's kind is a launch argument.

#pragma once

#include <math_constants.h>

#include <type_traits>

#include "common.cuh"
#include "depth_loss.cuh"
#include "tf32.cuh"

namespace hs {
namespace {

constexpr int TF_ROWS = 128;  // token rows of a tile
constexpr int TF_WARPS = 8;   // a warp owns 16 rows of a tile
constexpr int TF_THREADS = TF_WARPS * 32;
constexpr size_t kF32MaxSmem = 232448;  // an H100 block's opt-in shared memory

enum F32Kind : int { kF32Ce = 0, kF32CeBwd = 1, kF32Depth = 2, kF32DepthBwd = 3, kF32Pred = 4 };

// the loss a tile kernel takes of its logits: the weighted cross entropy of targets y
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

// the tile kernels' kinds of a loss: the forward's and the backward's
template <class Loss>
constexpr int kFwdKind = kIsDepth<Loss> ? kF32Depth : kIsPred<Loss> ? kF32Pred : kF32Ce;
template <class Loss>
constexpr int kBwdKind = kIsDepth<Loss> ? kF32DepthBwd : kF32CeBwd;

__host__ __device__ inline bool f32_is_bwd(int kind) {
  return kind == kF32CeBwd || kind == kF32DepthBwd;
}

// the head's columns on the tensor cores: NF rounded up to a whole 8-column n-tile
__host__ __device__ constexpr int nh_of(int NF) { return NF < 8 ? 8 : NF; }

// shared memory: We_i (C x (C + 8)) | Wh (C x (NH + 4), zero-padded) | gamma | beta | the x
// tile (128 x (C + 4)) | K7, K9: the z / dh tile (128 x (C + 4)) | the logits / dlogits
// tile (128 x (NH + 4)) | K6: the confusion matrix (F x F int) and the warps' loss sums;
// K8: the warps' loss sums; K3, K7, K9: nothing
struct F32Layout {
  size_t wh, gb, x, zd, l, red, total;
};

__host__ __device__ inline F32Layout f32_layout(int C, int NF, int F, int kind) {
  const int NH = nh_of(NF);
  F32Layout L;
  size_t off = align128(size_t(C) * (C + 8) * 4);
  L.wh = off; off += align128(size_t(C) * (NH + 4) * 4);
  L.gb = off; off += align128(size_t(2) * C * 4);
  L.x = off; off += align128(size_t(TF_ROWS) * (C + 4) * 4);
  L.zd = off;
  if (f32_is_bwd(kind)) off += align128(size_t(TF_ROWS) * (C + 4) * 4);
  L.l = off; off += align128(size_t(TF_ROWS) * (NH + 4) * 4);
  L.red = off;
  if (kind == kF32Ce || kind == kF32Depth)
    off += (kind == kF32Ce ? align128(size_t(F) * F * 4) : 0) + align128(2 * TF_WARPS * 4);
  L.total = off;
  return L;
}

// the block's resident head and LayerNorm parameters: Wh (C x F) into C x NH (ld NH + 4)
// with its padding columns zeroed
template <int C, int NF>
__device__ __forceinline__ void stage_head(float* whs, float* gs, const float* __restrict__ wh,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta, int F) {
  constexpr int NH = nh_of(NF), LDH = NH + 4;
  for (int idx = threadIdx.x; idx < C * NH; idx += TF_THREADS) {
    const int r = idx / NH, f = idx - r * NH;
    whs[r * LDH + f] = f < F ? wh[size_t(r) * F + f] : 0.f;
  }
  for (int c = threadIdx.x; c < C; c += TF_THREADS) {
    gs[c] = gamma[c];
    gs[C + c] = beta[c];
  }
}

// We_i (C x C) into shared memory (ld C + 8) by cp.async; the caller commits
template <int C>
__device__ __forceinline__ void stage_slice(float* wes, const float* __restrict__ wei) {
  constexpr int Q = C / 4;
  for (int idx = threadIdx.x; idx < C * Q; idx += TF_THREADS) {
    const int r = idx / Q, q = idx - r * Q;
    cp_async16(wes + r * (C + 8) + 4 * q, wei + size_t(r) * C + 4 * q);
  }
}

// tile `tile` of x into xs (ld C + 4) by cp.async, rows past T zero-filled; the caller
// commits.  Returns the count of rows that exist.
template <int C>
__device__ __forceinline__ int load_tile(float* xs, const float* __restrict__ x, int tile,
                                         int T) {
  constexpr int Q = C / 4;
  const int rows = min(TF_ROWS, T - tile * TF_ROWS);
  const float* src = x + size_t(tile) * TF_ROWS * C;
  for (int idx = threadIdx.x; idx < TF_ROWS * Q; idx += TF_THREADS) {
    const int r = idx / Q, q = idx - r * Q;
    const bool valid = r < rows;
    cp_async16_zfill(xs + r * (C + 4) + 4 * q, src + size_t(valid ? r : 0) * C + 4 * q, valid);
  }
  return rows;
}

// split a's four values into the A fragment (hi, lo)
__device__ __forceinline__ void split4(uint32_t (&ah)[4], uint32_t (&al)[4], float a0, float a1,
                                       float a2, float a3) {
  split_tf32(a0, ah[0], al[0]);
  split_tf32(a1, ah[1], al[1]);
  split_tf32(a2, ah[2], al[2]);
  split_tf32(a3, ah[3], al[3]);
}

// h (the warp's 16 rows x C, accumulators: h[t] = (g, 8t + 2c), (g, 8t + 2c + 1), (g + 8,
// 8t + 2c), (g + 8, 8t + 2c + 1)) = x We_i for the rows r0 .. r0 + 15 of xs, in 3xTF32, 32
// columns at a time, k ascending in steps of 8 from zero sums, the small terms apart
// (mma_3xtf32_apart)
template <int C>
__device__ __forceinline__ void tf_expand(float (&h)[C / 8][4], const float* xs,
                                          const float* wes, int r0) {
  constexpr int NT = C / 8, LDX = C + 4, LDW = C + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const float* xa = xs + (r0 + g) * LDX + c;
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += 4) {
    float hh[4][4], hl[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) hh[q][e] = hl[q][e] = 0.f;
#pragma unroll 2
    for (int j = 0; j < NT; ++j) {
      uint32_t ah[4], al[4];
      split4(ah, al, xa[8 * j], xa[8 * LDX + 8 * j], xa[8 * j + 4], xa[8 * LDX + 8 * j + 4]);
      const float* wb = wes + (8 * j + c) * LDW + 8 * n0 + g;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(wb[8 * q], bh0, bl0);
        split_tf32(wb[4 * LDW + 8 * q], bh1, bl1);
        mma_3xtf32_apart(hh[q], hl[q], ah, al, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[n0 + q][e] = __fadd_rn(hh[q][e], hl[q][e]);
  }
}

// the LayerNorm of the warp's rows g (accumulator entries 0, 1) and g + 8 (2, 3): h ->
// xhat in place, rstd of each row; each row's sums over its quad, every lane the same bits
template <int C>
__device__ __forceinline__ void tf_layernorm(float (&h)[C / 8][4], float (&rstd)[2],
                                             float eps) {
  constexpr int NT = C / 8;
  float s[2] = {0.f, 0.f}, v[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e >> 1] = __fadd_rn(s[e >> 1], h[t][e]);
  const float mean[2] = {quad_sum(s[0]) / C, quad_sum(s[1]) / C};
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[t][e] = __fsub_rn(h[t][e], mean[e >> 1]);
      v[e >> 1] = fmaf(h[t][e], h[t][e], v[e >> 1]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) rstd[r] = rsqrtf(quad_sum(v[r]) / C + eps);
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) h[t][e] = __fmul_rn(h[t][e], rstd[e >> 1]);
}

// z = xhat gamma + beta: the one expression of z
__device__ __forceinline__ float z_of(float xhat, float g, float b) { return fmaf(xhat, g, b); }

// 16 rows of accumulators (N / 8 n-tiles) into a row-major tile at p (ld ld), float2 each
template <int NT>
__device__ __forceinline__ void tf_store_rows(float* p, const float (&a)[NT][4], int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    *reinterpret_cast<float2*>(p + g * ld + 8 * t + c2) = make_float2(a[t][0], a[t][1]);
    *reinterpret_cast<float2*>(p + (g + 8) * ld + 8 * t + c2) = make_float2(a[t][2], a[t][3]);
  }
}

// lf (the warp's 16 rows x NH) = z Wh, z = z_of(xhat, gamma, beta) from the accumulators
// xh, Wh (C x NH, ld NH + 4) in whs, gamma | beta in gs.  The k index of each 8-column
// step runs over the columns (0, 2, 4, 6, 1, 3, 5, 7), on z's fragments and Wh's rows
// alike.  zout, where not null: the warp's 16 rows of z are stored there too (ld C + 4).
template <int C, int NF>
__device__ __forceinline__ void tf_logits(float (&lf)[nh_of(NF) / 8][4],
                                          const float (&xh)[C / 8][4], const float* gs,
                                          const float* whs, float* zout) {
  constexpr int NT = C / 8, NTH = nh_of(NF) / 8, LDH = nh_of(NF) + 4, LDX = C + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, c2 = (lane & 3) * 2;
  float ll[NTH][4];  // the small terms apart (mma_3xtf32_apart)
#pragma unroll
  for (int n = 0; n < NTH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) lf[n][e] = ll[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = 8 * j + c2;
    const float g0 = gs[col], g1 = gs[col + 1], b0 = gs[C + col], b1 = gs[C + col + 1];
    const float z0 = z_of(xh[j][0], g0, b0), z1 = z_of(xh[j][1], g1, b1);
    const float z2 = z_of(xh[j][2], g0, b0), z3 = z_of(xh[j][3], g1, b1);
    if (zout != nullptr) {
      *reinterpret_cast<float2*>(zout + g * LDX + col) = make_float2(z0, z1);
      *reinterpret_cast<float2*>(zout + (g + 8) * LDX + col) = make_float2(z2, z3);
    }
    uint32_t ah[4], al[4];  // (g, k c) = z(g, 2c), (g + 8, k c), (g, k c + 4) = z(g, 2c + 1), ..
    split4(ah, al, z0, z2, z1, z3);
    const float* wb = whs + col * LDH + g;
#pragma unroll
    for (int n = 0; n < NTH; ++n) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(wb[8 * n], bh0, bl0);
      split_tf32(wb[LDH + 8 * n], bh1, bl1);
      mma_3xtf32_apart(lf[n], ll[n], ah, al, bh0, bh1, bl0, bl1);
    }
  }
#pragma unroll
  for (int n = 0; n < NTH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) lf[n][e] = __fadd_rn(lf[n][e], ll[n][e]);
}

// the forward recomputed for the warp's rows r0 ..: xhat in h, rstd, and the logits stored
// to the warp's rows of the logits tile ls (ld NH + 4); z stored to zout where not null
template <int C, int NF>
__device__ __forceinline__ void tf_forward(float (&h)[C / 8][4], float (&rstd)[2],
                                           const float* xs, const float* wes, const float* gs,
                                           const float* whs, float* ls, float* zout, int r0,
                                           float eps) {
  constexpr int NH = nh_of(NF);
  tf_expand<C>(h, xs, wes, r0);
  tf_layernorm<C>(h, rstd, eps);
  float lf[NH / 8][4];
  tf_logits<C, NF>(lf, h, gs, whs, zout);
  tf_store_rows<NH / 8>(ls + r0 * (NH + 4), lf, NH + 4);
}

// a row's NF logits from the logits tile (row start 16-byte aligned, NF % 4 == 0)
template <int NF>
__device__ __forceinline__ void load_row(float (&lf)[NF], const float* lr) {
#pragma unroll
  for (int q = 0; q < NF / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(lr)[q];
    lf[4 * q] = v.x;
    lf[4 * q + 1] = v.y;
    lf[4 * q + 2] = v.z;
    lf[4 * q + 3] = v.w;
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
__global__ void __launch_bounds__(TF_THREADS, 2)
tail_fwd_3xtf32_kernel(const float* __restrict__ x, const float* __restrict__ we,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       const float* __restrict__ wh, const Loss loss, float* __restrict__ part,
                       float* __restrict__ tap, int T, int F, int P, float eps) {
  constexpr bool CE = std::is_same<Loss, CeLoss>::value;
  constexpr int LDL = nh_of(NF) + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const F32Layout L = f32_layout(C, NF, F, kFwdKind<Loss>);
  float* wes = reinterpret_cast<float*>(smem);
  float* whs = reinterpret_cast<float*>(smem + L.wh);
  float* gs = reinterpret_cast<float*>(smem + L.gb);
  float* xs = reinterpret_cast<float*>(smem + L.x);
  float* ls = reinterpret_cast<float*>(smem + L.l);
  int* cm = reinterpret_cast<int*>(smem + L.red);
  float* wsum = reinterpret_cast<float*>(smem + L.red + (CE ? align128(size_t(F) * F * 4) : 0));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, r0 = warp * 16;
  const int tiles = (T + TF_ROWS - 1) / TF_ROWS;

  stage_head<C, NF>(whs, gs, wh, gamma, beta, F);
  if constexpr (CE)
    for (int idx = tid; idx < F * F; idx += TF_THREADS) cm[idx] = 0;
  float num = 0.f, den = 0.f;
  for (int i = 0; i < P; ++i) {
    __syncthreads();  // the last slice's rows are done with wes
    stage_slice<C>(wes, we + size_t(i) * C * C);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      __syncthreads();  // the last tile's rows are done with xs
      const int rows = load_tile<C>(xs, x, tile, T);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (r0 >= rows) continue;
      float h[C / 8][4], rstd[2];
      tf_forward<C, NF>(h, rstd, xs, wes, gs, whs, ls, nullptr, r0, eps);
      __syncwarp();
      const int r = r0 + lane;
      if (lane >= 16 || r >= rows) continue;
      const size_t row = size_t(tile) * TF_ROWS + r, e = row * P + i;
      float lf[NF];
      load_row<NF>(lf, ls + r * LDL);
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
  if (lane == 0) {
    wsum[warp] = num;
    wsum[TF_WARPS + warp] = den;
  }
  __syncthreads();
  float* prow = part + size_t(blockIdx.x) * (CE ? 2 + F * F : 2);
  if (tid == 0) {
    float n = 0.f, d = 0.f;
    for (int w = 0; w < TF_WARPS; ++w) {
      n += wsum[w];
      d += wsum[TF_WARPS + w];
    }
    prow[0] = n;
    prow[1] = d;
  }
  if constexpr (CE)
    for (int idx = tid; idx < F * F; idx += TF_THREADS) prow[2 + idx] = float(cm[idx]);
}

// one halving step of rows8_scatter: the lanes with lane bit MASK keep the upper HALF of
// v[0 .. 2 HALF), the others the lower, each adding its partner's copy of the half it keeps
template <int HALF, int MASK>
__device__ __forceinline__ void halve_across(float (&v)[8]) {
  const bool up = (threadIdx.x & MASK) != 0;
#pragma unroll
  for (int q = 0; q < HALF; ++q) {
    const float send = up ? v[q] : v[HALF + q];
    const float keep = up ? v[HALF + q] : v[q];
    v[q] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, MASK));
  }
}

// v (8 values a lane) summed over the lanes of each c (the 8 row groups g), scattered:
// the lane with g returns the sum of value g.  Three halving steps (lane bits 4, 3, 2), a
// tree in a fixed order.
__device__ __forceinline__ float rows8_scatter(float (&v)[8]) {
  halve_across<4, 16>(v);
  halve_across<2, 8>(v);
  halve_across<1, 4>(v);
  return v[0];
}

// the LayerNorm backward of the warp's rows from their dlogits (rows of lw, ld NH + 4):
// dz = dlogits Wh^T in 3xTF32 (n-tile by n-tile, made twice: for the row means m1 of dz
// gamma and m2 of dz gamma xhat, then for dh), xhat -> dh in place; the columns' sums of
// dz xhat (dgamma) and dz (dbeta) over the 16 rows added to dgb: slot s of lane (g, c)
// holds the column of n-tile 2s + g / 4, parity (g & 1), dgamma for g & 2 == 0
template <int C, int NF>
__device__ __forceinline__ void tf_ln_bwd(float (&h)[C / 8][4], const float (&rstd)[2],
                                          const float* lw, const float* whs, const float* gs,
                                          float (&dgb)[C / 16]) {
  constexpr int NT = C / 8, NTH = nh_of(NF) / 8, LDL = nh_of(NF) + 4, LDH = nh_of(NF) + 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3, c2 = 2 * c;
  uint32_t ah[NTH][4], al[NTH][4];
#pragma unroll
  for (int k = 0; k < NTH; ++k) {
    const float* a = lw + g * LDL + 8 * k + c;
    split4(ah[k], al[k], a[0], a[8 * LDL], a[4], a[8 * LDL + 4]);
  }
  auto dz_tile = [&](int t, float (&d)[4]) {  // dz's n-tile t (channels 8t ..)
    d[0] = d[1] = d[2] = d[3] = 0.f;
    const float* wb = whs + (8 * t + g) * LDH + c;
#pragma unroll
    for (int k = 0; k < NTH; ++k) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(wb[8 * k], bh0, bl0);
      split_tf32(wb[8 * k + 4], bh1, bl1);
      mma_3xtf32(d, ah[k], al[k], bh0, bh1, bl0, bl1);
    }
  };
  float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    float d[4];
    dz_tile(t, d);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float dzh = __fmul_rn(d[e], gs[8 * t + c2 + (e & 1)]);
      m1[e >> 1] = __fadd_rn(m1[e >> 1], dzh);
      m2[e >> 1] = fmaf(dzh, h[t][e], m2[e >> 1]);
    }
  }
  float a1[2], a2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    a1[r] = quad_sum(m1[r]) / C;
    a2[r] = quad_sum(m2[r]) / C;
  }
#pragma unroll
  for (int s = 0; s < NT / 2; ++s) {
    float v[8];  // [dgamma 2c, 2c + 1, dbeta 2c, 2c + 1] of n-tiles 2s and 2s + 1
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = 2 * s + u;
      float d[4];
      dz_tile(t, d);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        v[4 * u + p] = __fadd_rn(__fmul_rn(d[p], h[t][p]), __fmul_rn(d[p + 2], h[t][p + 2]));
        v[4 * u + 2 + p] = __fadd_rn(d[p], d[p + 2]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dzh = __fmul_rn(d[e], gs[8 * t + c2 + (e & 1)]);
        h[t][e] = __fmul_rn(rstd[e >> 1], __fsub_rn(__fsub_rn(dzh, a1[e >> 1]),
                                                     __fmul_rn(h[t][e], a2[e >> 1])));
      }
    }
    dgb[s] = __fadd_rn(dgb[s], rows8_scatter(v));
  }
}

// the warp's 16 rows of dx (grow0 ..; `live` of them exist) = dh We_i^T, plus dx where
// `add`; dh's A fragments from the accumulators (k over each 8 channels in the order (0,
// 2, 4, 6, 1, 3, 5, 7), as tf_logits), We_i's rows read as float2 in the same order; 32
// columns of dx at a time
template <int C>
__device__ __forceinline__ void tf_dx(const float (&dh)[C / 8][4], const float* wes,
                                      float* __restrict__ dx, size_t grow0, int live, bool add) {
  constexpr int NT = C / 8, LDW = C + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll 1
  for (int n0 = 0; n0 < C; n0 += 32) {
    float acc[4][4], accl[4][4];  // the small terms apart (mma_3xtf32_apart)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = accl[q][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ah[4], al[4];
      split4(ah, al, dh[j][0], dh[j][2], dh[j][1], dh[j][3]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 b =
            *reinterpret_cast<const float2*>(wes + (n0 + 8 * q + g) * LDW + 8 * j + c2);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b.x, bh0, bl0);
        split_tf32(b.y, bh1, bl1);
        mma_3xtf32_apart(acc[q], accl[q], ah, al, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = __fadd_rn(acc[q][e], accl[q][e]);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (g + 8 * hr >= live) continue;
      float* d = dx + (grow0 + g + 8 * hr) * C + n0 + c2;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float2 v = make_float2(acc[q][2 * hr], acc[q][2 * hr + 1]);
        float2* p = reinterpret_cast<float2*>(d + 8 * q);
        if (add) {  // this lane wrote these elements at slice 0
          const float2 o = *p;
          v = make_float2(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y));
        }
        *p = v;
      }
    }
  }
}

// the k order of the block products over a tile's rows: k index c <-> row 2c, c + 4 <->
// row 2c + 1 of each 8-row step (conflict-free reads of rows padded to C + 4 / NH + 4)

// dwh (the warp's output tiles w, w + 8, .. of dWh (C x NH)) += z^T dlogits over the
// tile's first `rows` rows (z in zd, dlogits in ls), each tile's sum from zero
template <int C, int NF>
__device__ __forceinline__ void tf_dwh(float (&dwh)[(C / 16 * (nh_of(NF) / 8) + 7) / 8][4],
                                       const float* zd, const float* ls, int rows) {
  constexpr int NTH = nh_of(NF) / 8, TILES = C / 16 * NTH, MINE = (TILES + 7) / 8;
  constexpr int LDX = C + 4, LDL = nh_of(NF) + 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int s = 0; s < MINE; ++s) {
    const int id = warp + TF_WARPS * s;
    if (id >= TILES) break;
    const int m0 = (id / NTH) * 16, n0 = (id % NTH) * 8;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < rows; k0 += 8) {
      const float* za = zd + (k0 + 2 * c) * LDX + m0 + g;
      const float* lb = ls + (k0 + 2 * c) * LDL + n0 + g;
      uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
      split4(ah, al, za[0], za[8], za[LDX], za[LDX + 8]);
      split_tf32(lb[0], bh0, bl0);
      split_tf32(lb[LDL], bh1, bl1);
      mma_3xtf32(acc, ah, al, bh0, bh1, bl0, bl1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) dwh[s][e] = __fadd_rn(dwh[s][e], acc[e]);
  }
}

// acc (the warp's (C / 2) x (C / 4) block of dWe_i: rows (x channels) from (warp / 4) C /
// 2, columns (dh channels) from (warp % 4) C / 4) += x^T dh over the tile's first `rows`
// rows (x in xs, dh in zd): the tile's sum from zero, added to acc rounded to nearest (a
// tensor-core sum carried over the block's whole walk would lose an ulp of it at each of
// its ~750 adds, mma_3xtf32_apart)
template <int C>
__device__ __forceinline__ void tf_dwe(float (&acc)[C / 32][C / 32][4], const float* xs,
                                       const float* zd, int rows) {
  constexpr int MW = C / 32, LDX = C + 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, c = lane & 3;
  const int m0 = (warp >> 2) * (C / 2), n0 = (warp & 3) * (C / 4);
  float t[MW][MW][4];
#pragma unroll
  for (int mt = 0; mt < MW; ++mt)
#pragma unroll
    for (int nt = 0; nt < MW; ++nt) t[mt][nt][0] = t[mt][nt][1] = t[mt][nt][2] = t[mt][nt][3] = 0.f;
  for (int k0 = 0; k0 < rows; k0 += 8) {
    const float* xa = xs + (k0 + 2 * c) * LDX + m0 + g;
    const float* db = zd + (k0 + 2 * c) * LDX + n0 + g;
    uint32_t ah[MW][4], al[MW][4];
#pragma unroll
    for (int mt = 0; mt < MW; ++mt)
      split4(ah[mt], al[mt], xa[16 * mt], xa[16 * mt + 8], xa[LDX + 16 * mt],
             xa[LDX + 16 * mt + 8]);
#pragma unroll
    for (int nt = 0; nt < MW; ++nt) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(db[8 * nt], bh0, bl0);
      split_tf32(db[LDX + 8 * nt], bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < MW; ++mt) mma_3xtf32(t[mt][nt], ah[mt], al[mt], bh0, bh1, bl0, bl1);
    }
  }
#pragma unroll
  for (int mt = 0; mt < MW; ++mt)
#pragma unroll
    for (int nt = 0; nt < MW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], t[mt][nt][e]);
}

// K7's (CeLoss) and K9's (DepthLoss) tile kernel: dx (T x C f32) and the partial row [dWe
// (C x p C) | dWh (C x F) | dgamma (C) | dbeta (C)] of each block, for the loss gradient
// scale = gloss / den (K7) or gloss / max(count, 1) (K9), on the device; tap as K6's
template <int C, int NF, class Loss>
__global__ void __launch_bounds__(TF_THREADS, 1)
tail_bwd_3xtf32_kernel(const float* __restrict__ x, const float* __restrict__ we,
                       const float* __restrict__ gamma, const float* __restrict__ beta,
                       const float* __restrict__ wh, const Loss loss,
                       const float* __restrict__ scale_p, float* __restrict__ dx,
                       float* __restrict__ part, float* __restrict__ tap, int T, int F, int P,
                       float eps) {
  constexpr int NH = nh_of(NF), NTH = NH / 8, LDL = NH + 4, LDX = C + 4, MW = C / 32;
  constexpr int WH_MINE = (C / 16 * NTH + 7) / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const F32Layout L = f32_layout(C, NF, F, kBwdKind<Loss>);
  float* wes = reinterpret_cast<float*>(smem);
  float* whs = reinterpret_cast<float*>(smem + L.wh);
  float* gs = reinterpret_cast<float*>(smem + L.gb);
  float* xs = reinterpret_cast<float*>(smem + L.x);
  float* zd = reinterpret_cast<float*>(smem + L.zd);
  float* ls = reinterpret_cast<float*>(smem + L.l);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, r0 = warp * 16;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int tiles = (T + TF_ROWS - 1) / TF_ROWS;
  const float scale = *scale_p;
  float* prow = part + size_t(blockIdx.x) * (size_t(P) * C * C + C * F + 2 * C);

  stage_head<C, NF>(whs, gs, wh, gamma, beta, F);
  float dwh[WH_MINE][4], dgb[C / 16];
#pragma unroll
  for (int s = 0; s < WH_MINE; ++s) dwh[s][0] = dwh[s][1] = dwh[s][2] = dwh[s][3] = 0.f;
#pragma unroll
  for (int s = 0; s < C / 16; ++s) dgb[s] = 0.f;
  for (int i = 0; i < P; ++i) {
    float dwe[MW][MW][4];
#pragma unroll
    for (int mt = 0; mt < MW; ++mt)
#pragma unroll
      for (int nt = 0; nt < MW; ++nt)
        dwe[mt][nt][0] = dwe[mt][nt][1] = dwe[mt][nt][2] = dwe[mt][nt][3] = 0.f;
    __syncthreads();  // the last slice's rows are done with wes
    stage_slice<C>(wes, we + size_t(i) * C * C);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      __syncthreads();  // the last tile's products are done with xs and zd
      const int rows = load_tile<C>(xs, x, tile, T);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      const bool live = r0 < rows;
      const size_t grow0 = size_t(tile) * TF_ROWS + r0;
      float h[C / 8][4], rstd[2];
      if (live) {
        // the forward recomputed: xhat in h, z to the z tile, the logits to ls
        tf_forward<C, NF>(h, rstd, xs, wes, gs, whs, ls, zd + r0 * LDX, r0, eps);
        __syncwarp();
        if (lane < 16) {  // each row's dlogits over its logits (0 past F and for no row)
          float* lr = ls + (r0 + lane) * LDL;
          float dl[NH];
#pragma unroll
          for (int f = 0; f < NH; ++f) dl[f] = 0.f;
          if (r0 + lane < rows) {
            const size_t row = grow0 + lane, e = row * P + i;
            float lf[NF];
            load_row<NF>(lf, lr);
            if (tap != nullptr) write_tap<NF>(tap, lf, row, i, P, F);
            float d[NF];
            if constexpr (kIsDepth<Loss>) {
              depth_dl<NF>(d, lf, loss, e, scale, F);
            } else {
              const CeRow ce = ce_row<NF>(lf, d, F);
              const int yi = loss.y[e];
              const float sw = __fmul_rn(scale, loss.welem[e]);
#pragma unroll
              for (int f = 0; f < NF; ++f)
                d[f] = f < F ? sw * (__fdiv_rn(d[f], ce.se) - (f == yi ? 1.f : 0.f)) : 0.f;
            }
#pragma unroll
            for (int f = 0; f < NF; ++f) dl[f] = d[f];
          }
#pragma unroll
          for (int q = 0; q < NH / 4; ++q)
            reinterpret_cast<float4*>(lr)[q] =
                make_float4(dl[4 * q], dl[4 * q + 1], dl[4 * q + 2], dl[4 * q + 3]);
        }
        __syncwarp();
        tf_ln_bwd<C, NF>(h, rstd, ls + r0 * LDL, whs, gs, dgb);
        tf_dx<C>(h, wes, dx, grow0, rows - r0, i > 0);
      }
      __syncthreads();  // every row's z and dlogits are in place
      tf_dwh<C, NF>(dwh, zd, ls, rows);
      __syncthreads();  // z is read: the tile takes dh
      if (live) tf_store_rows<C / 8>(zd + r0 * LDX, h, LDX);
      __syncthreads();
      tf_dwe<C>(dwe, xs, zd, rows);
    }
    // the block's dWe_i: columns i C .. of dWe (C x p C)
    const int m0 = (warp >> 2) * (C / 2), n0 = (warp & 3) * (C / 4);
#pragma unroll
    for (int mt = 0; mt < MW; ++mt)
#pragma unroll
      for (int nt = 0; nt < MW; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int m = m0 + 16 * mt + g + 8 * hr, n = i * C + n0 + 8 * nt + c2;
          *reinterpret_cast<float2*>(prow + size_t(m) * P * C + n) =
              make_float2(dwe[mt][nt][2 * hr], dwe[mt][nt][2 * hr + 1]);
        }
  }
  // dWh (C x F) after dWe
  float* pwh = prow + size_t(P) * C * C;
#pragma unroll
  for (int s = 0; s < WH_MINE; ++s) {
    const int id = warp + TF_WARPS * s;
    if (id >= C / 16 * NTH) break;
    const int m0 = (id / NTH) * 16, n0 = (id % NTH) * 8;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + g + 8 * (e >> 1), f = n0 + c2 + (e & 1);
      if (f < F) pwh[m * F + f] = dwh[s][e];
    }
  }
  // dgamma | dbeta: each warp's column sums (lane (g, c) slot s: n-tile 2s + g / 4, column
  // parity g & 1, dbeta where g & 2), then the warps added in a fixed order
  __syncthreads();  // the x tile is free
  float* sc = xs;
#pragma unroll
  for (int s = 0; s < C / 16; ++s) {
    const int col = 8 * (2 * s + (g >> 2)) + c2 + (g & 1);
    sc[warp * 2 * C + ((g >> 1) & 1) * C + col] = dgb[s];
  }
  __syncthreads();
  if (tid < 2 * C) {
    float s = 0.f;
    for (int w = 0; w < TF_WARPS; ++w) s = __fadd_rn(s, sc[w * 2 * C + tid]);
    prow[size_t(P) * C * C + C * F + tid] = s;
  }
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
  if constexpr (BWD) return reinterpret_cast<const void*>(tail_bwd_3xtf32_kernel<C, NF, Loss>);
  else return reinterpret_cast<const void*>(tail_fwd_3xtf32_kernel<C, NF, Loss>);
}

// the tile kernel's grid: min(its tiles, the blocks the card holds at once at its shared
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
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k, TF_THREADS, smem);
  if (e != cudaSuccess) return e;
  if (per < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (T + TF_ROWS - 1) / TF_ROWS, resident = per * sm_count();
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

// K6 and K8: the tile kernel, then reduce_rows over its partial rows into red
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
    tail_fwd_3xtf32_kernel<CC, NF, Loss>
        <<<G, TF_THREADS, f32_layout(CC, NF, F, kFwdKind<Loss>).total, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(we),
            static_cast<const float*>(gamma), static_cast<const float*>(beta),
            static_cast<const float*>(wh), loss, part, static_cast<float*>(tap), T, F, P, eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    return reduce_rows(part, static_cast<float*>(red), G, W, tmp, s);
  });
}

// K3: the tile kernel with the Argmax epilogue, the classes (T, p) into preds
inline cudaError_t launch_f32_pred(const void* x, const void* we, const void* gamma,
                                   const void* beta, const void* wh, void* preds, void* tap,
                                   int T, int C, int F, int P, float eps, cudaStream_t s) {
  return with_f32<false>(C, F, [&](auto c, auto nf) {
    constexpr int CC = decltype(c)::value, NF = decltype(nf)::value;
    int G = 0;
    cudaError_t e = f32_grid<CC, NF, Argmax, false>(T, F, &G);
    if (e != cudaSuccess) return e;
    const size_t smem = f32_layout(CC, NF, F, kF32Pred).total;
    tail_fwd_3xtf32_kernel<CC, NF, Argmax><<<G, TF_THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(we),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const float*>(wh), Argmax{static_cast<int*>(preds)}, nullptr,
        static_cast<float*>(tap), T, F, P, eps);
    return cudaGetLastError();
  });
}

// the width of K7's and K9's partial rows: [dWe (C x p C) | dWh (C x F) | dgamma | dbeta]
inline int f32_bwd_width(int C, int F, int P) { return P * C * C + C * F + 2 * C; }

// K7's and K9's tile kernel alone: dx and its partial rows part (grid x f32_bwd_width)
template <class Loss>
cudaError_t launch_f32_bwd_rows(const void* x, const void* we, const void* gamma,
                                const void* beta, const void* wh, const Loss& loss,
                                const void* scale, void* dx, void* part, void* tap, int T,
                                int C, int F, int P, float eps, cudaStream_t s) {
  return with_f32<kIsDepth<Loss>>(C, F, [&](auto c, auto nf) {
    constexpr int CC = decltype(c)::value, NF = decltype(nf)::value;
    int G = 0;
    cudaError_t e = f32_grid<CC, NF, Loss, true>(T, F, &G);
    if (e != cudaSuccess) return e;
    tail_bwd_3xtf32_kernel<CC, NF, Loss>
        <<<G, TF_THREADS, f32_layout(CC, NF, F, kBwdKind<Loss>).total, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(we),
            static_cast<const float*>(gamma), static_cast<const float*>(beta),
            static_cast<const float*>(wh), loss, static_cast<const float*>(scale),
            static_cast<float*>(dx), static_cast<float*>(part), static_cast<float*>(tap), T,
            F, P, eps);
    return cudaGetLastError();
  });
}

// K7's and K9's workspace: the tile kernel's partial rows, then reduce_rows' scratch
struct F32BwdWork {
  size_t tmp, total;
  int grid;
};

template <class Loss>
F32BwdWork f32_bwd_work(int T, int C, int F, int P) {
  F32BwdWork w;
  w.grid = f32_grid_of<Loss, true>(T, C, F);
  const int W = f32_bwd_width(C, F, P);
  w.tmp = align128(size_t(w.grid) * W * 4);
  w.total = w.tmp + align128(reduce_rows_tmp_floats(w.grid, W) * 4);
  return w;
}

// K7 and K9: the tile kernel, then reduce_rows over its partial rows into red = [dWe |
// dWh | dgamma | dbeta], on one stream
template <class Loss>
cudaError_t launch_f32_bwd(const void* x, const void* we, const void* gamma, const void* beta,
                           const void* wh, const Loss& loss, const void* scale, void* dx,
                           void* red, void* work, int T, int C, int F, int P, float eps,
                           cudaStream_t s) {
  const F32BwdWork w = f32_bwd_work<Loss>(T, C, F, P);
  if (w.grid < 1) return cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(work);
  float* part = reinterpret_cast<float*>(base);
  cudaError_t e = launch_f32_bwd_rows(x, we, gamma, beta, wh, loss, scale, dx, part, nullptr,
                                      T, C, F, P, eps, s);
  if (e != cudaSuccess) return e;
  return reduce_rows(part, static_cast<float*>(red), w.grid, f32_bwd_width(C, F, P),
                     reinterpret_cast<float*>(base + w.tmp), s);
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
