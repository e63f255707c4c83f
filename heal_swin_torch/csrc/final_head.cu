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
// K8: F <= 2 f32 logits (mean, logvar), NOT rounded -> the masked depth loss of one
//   kind (l2 / l1 / huber / nll) against targets t (T, p) f32 whose non-finite entries
//   mark background: an invalid target is selected to 0 before the subtraction, so inf
//   never enters the arithmetic.  Sum loss, count of valid targets, and the logits
//   rounded to bf16 as the (T, p*F) predictions.
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
// All five run on the register-resident row core of tail_core.cuh: persistent blocks
// (grid = min(128-row tiles, resident blocks)), each staging the p expand slices and Wh
// once by cp.async and walking its tiles with a double-buffered cp.async ring for x; a
// warp owns 16 rows, and h, the LayerNorm, z and the logits stay in mma.sync
// accumulators and fragments, made by the same functions in every kernel (so K3's f32
// logits rounded to bf16 are K6's, and K7's and K9's recomputed logits K6's and K8's).
// Where the p slices do not fit beside K3's, K6's or K7's tiles (K7 at C 128, p 4; C 96 and
// 128 at p 16), they stream through a ring of two stages instead (SliceRing): slice i + 1's
// copy is issued before slice i's products, one block barrier a slice.  Heads above 32
// classes (up to 128) run in chunks of 32 (NF 0): K6 keeps each row's running max, sum and
// argmax over the chunks, K7 walks them twice (statistics, then each chunk's dlogits into
// the tile, dz read back from it by ldmatrix), K3 keeps a running argmax.
// Each kernel opts in to a block's largest shared memory once per device (tail_grid).
// K3 takes each row's argmax over its quad (tail_argmax) and writes one int32 class a
// sub-pixel, no partial rows.  K6 reduces each row's cross entropy, argmax and weight
// over its quad; the confusion matrix counts in a shared int array (integer atomics are
// order-free); one partial row [sum w*nll, sum w, F x F] a block.  K8 takes the depth
// loss of each row on the quad's lane that holds its logits 0 and 1 (Wh zero-padded to
// 16 columns); one partial row [sum loss, count] a block.  K7 is a launch sequence from
// one entry: the row kernel (the forward recomputed through K6's functions, dlogits on
// the accumulators, dz = dlogits Wh^T by mma, dgamma and dbeta as column sums by
// shuffles into a row a warp, dh rounded to bf16 in registers and written to a (T, p*C)
// workspace, dx += dh_i We_i^T by mma in accumulators kept across the p slices and
// written once, dWh += z^T dlogits through the tile's z and dlogits in shared memory by
// ldmatrix.trans, one partial row [dWh | dgamma | dbeta] a block), then reduce_rows over
// the partial rows, then dWe = x^T dh by reduce.cu's gemm_tn.  K9 is the same sequence
// on its own row kernel (the forward recomputed through K8's functions; the f32 dlogits
// shuffled from the quad's logit lane, dz = dl0 Wh[:, 0] (+ dl1 Wh[:, 1]) element by
// element in f32, dWh = z^T dlogits as column sums like dgamma and dbeta, no tile in
// shared memory), then gemm_tn, then reduce_rows.
//
// No atomics on floats anywhere: the sums across blocks run in a fixed order in
// reduce.cu, and the results do not change from run to run.

#include <type_traits>

#include "tail_core.cuh"

namespace hs {
namespace {

// ---------------------------------------------------------------------------------
// K3, K6, K8 and the row kernels of K7 and K9 on the tail row core (tail_core.cuh).
// Persistent blocks of 8 warps: block b walks the 128-row tiles b, b + grid, ...; the p
// expand slices and Wh stay resident, the x tiles come through a double-buffered
// cp.async ring.
// ---------------------------------------------------------------------------------

// the five kernels of the tail row core
enum TailKind : int { kCe = 0, kCeBwd = 1, kDepth = 2, kDepthBwd = 3, kPred = 4 };

constexpr size_t kTailMaxSmem = 232448;  // an H100 block's opt-in shared memory
constexpr int kTailMaxF = 128;           // the widest class head (the Pallas tails' F)

// shared memory: We's slices (p x C x C, rows padded to C + 8; where all p do not fit, K3,
// K6 and K7 hold two stages and stream them, SliceRing) | Wh (C x FP bf16, zero-padded, FP
// = 16 for F <= 16 (NF 2 and the depth head), else F rounded up to a whole chunk of 32,
// rows padded to FP + 8) | two stages of the x tile (128 x C) | K6: the confusion matrix
// (F x F int) and the warps' loss sums; K7's row kernel: the tile's z (128 x C) and
// dlogits (128 x FP), both bf16, for dWh, heads above 32 classes the block's dWh sums (C
// x FP f32), and the warps' dgamma | dbeta column sums (2C floats a warp); K8: the warps'
// loss sums; K9's row kernel: the warps' dWh | dgamma | dbeta column sums (C F + 2C
// floats a warp); K3: nothing more
struct TailLayout {
  size_t wh, x, stage, z, dl, dwh, red, total;
  int ldwh, fp;
  bool stream;  // the slices pass through two stages (SliceRing)
};

__host__ __device__ inline TailLayout tail_layout_with(int C, int F, int P, int kind,
                                                       bool stream) {
  TailLayout L;
  L.fp = F <= 16 ? 16 : (F + 31) / 32 * 32;
  L.ldwh = L.fp + 8;
  L.stream = stream;
  const size_t ldx = size_t(C) + 8;
  size_t off = align128(size_t(stream ? 2 : P) * C * ldx * 2);
  L.wh = off; off += align128(size_t(C) * L.ldwh * 2);
  L.stage = align128(TAIL_ROWS * ldx * 2);
  L.x = off; off += 2 * L.stage;
  L.z = L.dl = L.dwh = 0;
  if (kind == kCeBwd) {
    L.z = off; off += L.stage;
    L.dl = off; off += align128(size_t(TAIL_ROWS) * L.ldwh * 2);
    if (F > 32) {
      L.dwh = off; off += align128(size_t(C) * L.fp * 4);
    }
  }
  L.red = off;
  switch (kind) {
    case kCe: off += align128(size_t(F) * F * 4) + align128(2 * kWarps * 4); break;
    case kCeBwd: off += align128(size_t(kWarps) * 2 * C * 4); break;
    case kDepth: off += align128(2 * kWarps * 4); break;
    case kDepthBwd: off += align128(size_t(kWarps) * (C * F + 2 * C) * 4); break;
    default: break;
  }
  L.total = off;
  return L;
}

// the resident layout, or, for K3, K6 and K7 where the p slices do not fit beside the
// tiles, the streamed one
__host__ __device__ inline TailLayout tail_layout(int C, int F, int P, int kind) {
  const TailLayout L = tail_layout_with(C, F, P, kind, false);
  if (L.total > kTailMaxSmem && P > 2 && (kind == kCe || kind == kCeBwd || kind == kPred))
    return tail_layout_with(C, F, P, kind, true);
  return L;
}

// Wh (C x F) into C x FP (ld ldwh) with its padding columns zeroed
__device__ __forceinline__ void stage_tail_head(bf16* whs, const bf16* __restrict__ wh, int C,
                                                int F, int ldwh) {
  for (int idx = threadIdx.x; idx < C * ldwh; idx += kThreads) {
    const int r = idx / ldwh, f = idx - r * ldwh;
    whs[idx] = f < F ? wh[size_t(r) * F + f] : to_bf(0.f);
  }
}

// the block's resident operands: We's slices by cp.async (the caller commits them with
// its first x tile), Wh with its padding columns zeroed
__device__ __forceinline__ void stage_tail_weights(bf16* wes, bf16* whs,
                                                   const bf16* __restrict__ we,
                                                   const bf16* __restrict__ wh, int C, int F,
                                                   int P, int ldwh) {
  fetch_rows(wes, C + 8, we, P * C, C);
  stage_tail_head(whs, wh, C, F, ldwh);
}

// The expand slices of K3, K6 and K7: resident (all p in shared memory for the block's
// whole walk) or, where they do not fit beside the tiles (tail_layout), streamed through a
// ring of two stages, slice i of the block's s-th tile in stage (s p + i) % 2; the copy of
// the next slice starts before the current slice's products, so it overlaps them.
struct SliceRing {
  bf16* base;
  const bf16* we;  // (p, C, C)
  int C, P;
  bool stream;

  __device__ size_t size() const { return size_t(C) * (C + 8); }

  // the first slices by cp.async: all p, or slice 0; the caller commits them
  __device__ void stage() const { fetch_rows(base, C + 8, we, (stream ? 1 : P) * C, C); }

  // slice i of the block's s-th tile, ready to read.  Streamed, every warp of the block
  // calls it: for i > 0 it waits for the slice's copy (for i = 0 the tile's wait did) and
  // for every warp to be done with the other stage, then starts the copy of the next
  // slice (i + 1, or slice 0 of the block's next tile where `more`) into that stage.
  __device__ const bf16* next(int s, int i, bool more) const {
    if (!stream) return base + size_t(i) * size();
    if (i > 0) {
      cp_async_wait<0>();
      __syncthreads();
    }
    const int q = s * P + i;
    if (i + 1 < P || more)
      fetch_rows(base + size_t((q + 1) & 1) * size(), C + 8,
                 we + size_t(i + 1 < P ? i + 1 : 0) * C * C, C, C);
    cp_async_commit();
    return base + size_t(q & 1) * size();
  }
};

// x tile `tile` (its rows that exist) into a ring stage by cp.async; none past the last
__device__ __forceinline__ void fetch_tail_tile(bf16* xs, const bf16* __restrict__ x, int tile,
                                                int tiles, int T, int C) {
  if (tile < tiles)
    fetch_rows(xs, C + 8, x + size_t(tile) * TAIL_ROWS * C, min(TAIL_ROWS, T - tile * TAIL_ROWS),
               C);
}

// K6: the partial row [sum w*nll, sum w, confusion matrix (F x F)] of each block; tap,
// where not null, gets the rounded logits (T, p, F).  NF 0: the head in chunks of 32
// (tail_chunk_stats)
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
  const TailLayout L = tail_layout(C, F, P, kCe);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int row0 = warp * 16;
  const SliceRing ring{reinterpret_cast<bf16*>(smem), we, C, P, L.stream};
  bf16* whs = reinterpret_cast<bf16*>(smem + L.wh);
  int* cm = reinterpret_cast<int*>(smem + L.red);
  float* wsum = reinterpret_cast<float*>(smem + L.red + align128(size_t(F) * F * 4));
  auto xs = [&](int s) { return reinterpret_cast<bf16*>(smem + L.x + (s & 1) * L.stage); };
  const int tiles = (T + TAIL_ROWS - 1) / TAIL_ROWS;

  ring.stage();
  stage_tail_head(whs, wh, C, F, L.ldwh);
  fetch_tail_tile(xs(0), x, blockIdx.x, tiles, T, C);
  cp_async_commit();
  for (int idx = tid; idx < F * F; idx += kThreads) cm[idx] = 0;

  float num = 0.f, den = 0.f;  // the sums of this lane's rows (lanes with c = 0)
  // the tile walk, compiled apart for the resident slices and the streamed ones (a single
  // walk with the ring's run-time choice runs the paper shape's resident K6 ~4% slower)
  auto walk = [&](auto streamed) {
    constexpr bool ST = decltype(streamed)::value;
    int s = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++s) {
      cp_async_wait<0>();
      __syncthreads();  // tile s has landed (with the weights); tile s - 1's stage is free
      fetch_tail_tile(xs(s + 1), x, tile + gridDim.x, tiles, T, C);
      cp_async_commit();
      const bool active = row0 < min(TAIL_ROWS, T - tile * TAIL_ROWS);
      if (!ST && !active) continue;
      const size_t grow0 = size_t(tile) * TAIL_ROWS + row0;
      for (int i = 0; i < P; ++i) {
        const bf16* wei = ST ? ring.next(s, i, tile + gridDim.x < tiles)
                             : ring.base + size_t(i) * C * ldx;
        if (ST && !active) continue;
        float xh[NT][4];
        tail_xhat<NT>(xh, xs(s), ldx, row0, wei, C, eps);
        if constexpr (NF == 0) {
          int yi[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) yi[h] = y[(grow0 + g + 8 * h) * P + i];
          const CeStats st = tail_chunk_stats<NT>(xh, gamma, beta, whs, L.ldwh, F,
                                                  L.fp / TAIL_CHUNK, yi, nullptr, 0, tap, grow0,
                                                  i, P);
          if ((lane & 3) == 0) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float wi = welem[(grow0 + g + 8 * h) * P + i];
              num += wi * (st.mx[h] + logf(st.se[h]) - st.ly[h]);
              den += wi;
              if (st.best[h] < F && yi[h] >= 0 && yi[h] < F)
                atomicAdd(cm + yi[h] * F + st.best[h], 1);  // order-free
            }
          }
        } else {
          float lf[NF][4], ex[NF][4];
          tail_logits<NT, NF>(lf, xh, gamma, beta, whs, L.ldwh, nullptr, 0);
          const CeRows ce = tail_softmax<NF>(lf, ex, F);
          if (tap != nullptr) tail_tap<NF>(tap, lf, grow0, i, P, F);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const size_t e = (grow0 + g + 8 * h) * P + i;
            const int yi = y[e];
            float ly = 0.f;
#pragma unroll
            for (int n = 0; n < NF; ++n)
#pragma unroll
              for (int k = 0; k < 2; ++k) {
                const int col = 8 * n + c2 + k;
                if (col < F && col == yi) ly = lf[n][2 * h + k];
              }
            ly = quad_sum(ly);
            // the lowest column at the max; none (F) for a row holding a NaN
            const int best = quad_lowest_at<NF>(lf, h, ce.mx[h], F);
            if ((lane & 3) == 0) {
              const float wi = welem[e];
              num += wi * (ce.mx[h] + logf(ce.se[h]) - ly);
              den += wi;
              if (best < F && yi >= 0 && yi < F)
                atomicAdd(cm + yi * F + best, 1);  // order-free
            }
          }
        }
      }
    }
  };
  if (L.stream)
    walk(std::true_type{});
  else
    walk(std::false_type{});
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
// gradient scale = gloss / den (on the device); tap as K6's.  NF 0: the head in chunks of
// 32, walked twice a slice: the row statistics (tail_chunk_stats, K6's), then each chunk's
// logits remade for its dlogits into the tile (tail_chunk_dlogits); dz = dlogits Wh^T
// reads the dlogits' A fragments from the tile, and dWh sums in shared memory.
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
  constexpr bool CH = NF == 0;
  constexpr int KS = CH ? 2 : NF / 2;  // 16-wide k-steps of a dlogits row (of a chunk)
  extern __shared__ __align__(128) unsigned char smem[];
  const TailLayout L = tail_layout(C, F, P, kCeBwd);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int row0 = warp * 16;
  const int ldwh = L.ldwh;
  const int nch = L.fp / TAIL_CHUNK;
  const SliceRing ring{reinterpret_cast<bf16*>(smem), we, C, P, L.stream};
  bf16* whs = reinterpret_cast<bf16*>(smem + L.wh);
  bf16* zs = reinterpret_cast<bf16*>(smem + L.z);
  bf16* dls = reinterpret_cast<bf16*>(smem + L.dl);
  float* dwhs = reinterpret_cast<float*>(smem + L.dwh);  // NF 0: the block's dWh (C x FP)
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* wred = red + warp * 2 * C;  // this warp's dgamma | dbeta column sums
  auto xs = [&](int s) { return reinterpret_cast<bf16*>(smem + L.x + (s & 1) * L.stage); };
  const int tiles = (T + TAIL_ROWS - 1) / TAIL_ROWS;
  const float scale = *scale_p;
  const bool dwh_rows = warp < C / 16;  // this warp sums rows 16 warp .. of dWh

  ring.stage();
  stage_tail_head(whs, wh, C, F, ldwh);
  fetch_tail_tile(xs(0), x, blockIdx.x, tiles, T, C);
  cp_async_commit();
  for (int idx = tid; idx < kWarps * 2 * C; idx += kThreads) red[idx] = 0.f;
  if constexpr (CH)
    for (int idx = tid; idx < C * L.fp; idx += kThreads) dwhs[idx] = 0.f;

  float dwh[CH ? 1 : KS][1][2][4];
#pragma unroll
  for (int k = 0; k < (CH ? 1 : KS); ++k)
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
      const bf16* wei = ring.next(s, i, tile + gridDim.x < tiles);
      float xh[NT][4];
      LnRows r;
      if (active) r = tail_xhat<NT>(xh, xs(s), ldx, row0, wei, C, eps);
      __syncthreads();  // the last slice's dWh product has read zs and dls
      if (active) {
        int yi[2];
        float sw[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t e = (grow0 + g + 8 * h) * P + i;
          yi[h] = y[e];
          sw[h] = __fmul_rn(scale, welem[e]);
        }
        uint32_t da[KS][4];  // the dlogits' A fragments (NF 2, 4: held in registers)
        if constexpr (CH) {
          const CeStats st = tail_chunk_stats<NT>(xh, gamma, beta, whs, ldwh, F, nch, yi,
                                                  zs + row0 * ldx, ldx, tap, grow0, i, P);
          for (int ch = 0; ch < nch; ++ch)
            tail_chunk_dlogits<NT>(xh, gamma, beta, whs, ldwh, F, ch, st, yi, sw, dls, row0);
          __syncwarp();  // the warp's dlogits rows are in the tile
        } else {
          float lf[NF][4], ex[NF][4];
          tail_logits<NT, NF>(lf, xh, gamma, beta, whs, ldwh, zs + row0 * ldx, ldx);
          const CeRows ce = tail_softmax<NF>(lf, ex, F);
          if (tap != nullptr) tail_tap<NF>(tap, lf, grow0, i, P, F);

          // dlogits = bf16(scale w (softmax - onehot)), 0 at columns >= F
          float dl[NF][4];
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
#pragma unroll
          for (int k = 0; k < KS; ++k) pack_a_frag(da[k], dl[2 * k], dl[2 * k + 1]);
        }

        // dz (columns 32 j ..) = dlogits Wh^T: from the registers, or chunk by chunk from
        // the dlogits tile (ldmatrix), k ascending either way
        auto dz_of = [&](float (&dz)[4][4], int j) {
#pragma unroll
          for (int t = 0; t < 4; ++t) dz[t][0] = dz[t][1] = dz[t][2] = dz[t][3] = 0.f;
          if constexpr (CH) {
            const bf16* dlrow = dls + (row0 + (lane & 15)) * ldwh + (lane >> 4) * 8;
            for (int ch = 0; ch < nch; ++ch) {
              uint32_t dc[2][4];
              ldsm_x4(dc[0], dlrow + TAIL_CHUNK * ch);
              ldsm_x4(dc[1], dlrow + TAIL_CHUNK * ch + 16);
              frags_times_rows_t<4, 2>(dz, dc, whs + 32 * j * ldwh + TAIL_CHUNK * ch, ldwh, 4);
            }
          } else {
            frags_times_rows_t<4, KS>(dz, da, whs + 32 * j * ldwh, ldwh, 4);
          }
        };

        // dz = dlogits Wh^T, 32 columns at a time, twice: first the LayerNorm backward's
        // row means m1, m2 of dz gamma and dz gamma xhat and the column sums dgamma =
        // sum dz xhat, dbeta = sum dz; then dh, recomputing dz (the same bits)
        float m[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
        for (int j = 0; j < NT / 4; ++j) {
          float dz[4][4];
          dz_of(dz, j);
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
          float dz[4][4];
          dz_of(dz, j);
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
      if constexpr (CH) {
        // dWh += z^T dlogits: 16 x 16 output tiles over the warps, each tile's sum from
        // zero added to the block's sums in shared memory by the one lane that owns them
        const int kt = L.fp / 16;
        for (int id = warp; id < (C / 16) * kt; id += kWarps) {
          const int mt = id / kt, kg = id - mt * kt;
          float acc[1][2][4] = {};
          tile_t_times_tile_cols<1>(acc, zs, ldx, 1, mt, kWarps, dls, ldwh, 16 * kg, rows);
#pragma unroll
          for (int jn = 0; jn < 2; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float* d = dwhs + (16 * mt + g + 8 * (e >> 1)) * L.fp + 16 * kg + 8 * jn + c2 +
                         (e & 1);
              *d = __fadd_rn(*d, acc[0][jn][e]);
            }
        }
      } else if (dwh_rows) {
#pragma unroll
        for (int k = 0; k < KS; ++k)
          tile_t_times_tile_cols<1>(dwh[k], zs, ldx, 1, warp, kWarps, dls, ldwh, 16 * k, rows);
      }
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

  // the block's partial row: dWh from the warps' accumulators (or the block's sums),
  // dgamma | dbeta summed over the warps in warp order
  __syncthreads();
  float* prow = part + size_t(blockIdx.x) * (C * F + 2 * C);
  if constexpr (CH) {
    for (int idx = tid; idx < C * F; idx += kThreads) {
      const int row = idx / F, col = idx - row * F;
      prow[idx] = dwhs[row * L.fp + col];
    }
  } else if (dwh_rows) {
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

// K8: the partial row [sum loss, count of valid targets] of each block and the bf16
// predictions (T, p F); tap, where not null, gets the f32 logits (T, p, F)
template <int NT, int NF>
__global__ void __launch_bounds__(kThreads, 1)
tail_depth_kernel(const bf16* __restrict__ x, const bf16* __restrict__ we,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  const bf16* __restrict__ wh, const float* __restrict__ t,
                  bf16* __restrict__ preds, float* __restrict__ part, float* __restrict__ tap,
                  int T, int F, int P, int kind, float delta, float eps) {
  constexpr int C = 8 * NT;
  constexpr int ldx = C + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const TailLayout L = tail_layout(C, F, P, kDepth);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = warp * 16;
  bf16* wes = reinterpret_cast<bf16*>(smem);
  bf16* whs = reinterpret_cast<bf16*>(smem + L.wh);
  float* wsum = reinterpret_cast<float*>(smem + L.red);
  auto xs = [&](int s) { return reinterpret_cast<bf16*>(smem + L.x + (s & 1) * L.stage); };
  const int tiles = (T + TAIL_ROWS - 1) / TAIL_ROWS;

  stage_tail_weights(wes, whs, we, wh, C, F, P, L.ldwh);
  fetch_tail_tile(xs(0), x, blockIdx.x, tiles, T, C);
  cp_async_commit();

  float num = 0.f, den = 0.f;  // the sums of this lane's rows (lanes with c2 = 0)
  int s = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++s) {
    cp_async_wait<0>();
    __syncthreads();  // tile s has landed (with the weights); tile s - 1's stage is free
    fetch_tail_tile(xs(s + 1), x, tile + gridDim.x, tiles, T, C);
    cp_async_commit();
    if (row0 >= min(TAIL_ROWS, T - tile * TAIL_ROWS)) continue;
    const size_t grow0 = size_t(tile) * TAIL_ROWS + row0;
    for (int i = 0; i < P; ++i) {
      float xh[NT][4], lf[NF][4];
      tail_xhat<NT>(xh, xs(s), ldx, row0, wes + size_t(i) * C * ldx, C, eps);
      tail_logits<NT, NF>(lf, xh, gamma, beta, whs, L.ldwh, nullptr, 0);
      if (tap != nullptr) tail_tap<NF>(tap, lf, grow0, i, P, F);
      tail_depth<NF>(lf, t, preds, grow0, i, P, F, kind, delta, num, den);
    }
  }
  num = warp_sum(num);
  den = warp_sum(den);
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
    part[size_t(blockIdx.x) * 2] = n;
    part[size_t(blockIdx.x) * 2 + 1] = d;
  }
}

// K3: the class index of every sub-pixel, preds (T, p) int32; tap, where not null, gets
// the f32 logits (T, p, F) the argmax took.  K8's skeleton without its partial rows, on
// K6's slice ring; NF 0: the head in chunks of 32 (tail_chunk_argmax).
template <int NT, int NF>
__global__ void __launch_bounds__(kThreads, 1)
tail_pred_kernel(const bf16* __restrict__ x, const bf16* __restrict__ we,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 const bf16* __restrict__ wh, int* __restrict__ preds, float* __restrict__ tap,
                 int T, int F, int P, float eps) {
  constexpr int C = 8 * NT;
  constexpr int ldx = C + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const TailLayout L = tail_layout(C, F, P, kPred);
  const int row0 = (threadIdx.x >> 5) * 16;
  const SliceRing ring{reinterpret_cast<bf16*>(smem), we, C, P, L.stream};
  bf16* whs = reinterpret_cast<bf16*>(smem + L.wh);
  auto xs = [&](int s) { return reinterpret_cast<bf16*>(smem + L.x + (s & 1) * L.stage); };
  const int tiles = (T + TAIL_ROWS - 1) / TAIL_ROWS;

  ring.stage();
  stage_tail_head(whs, wh, C, F, L.ldwh);
  fetch_tail_tile(xs(0), x, blockIdx.x, tiles, T, C);
  cp_async_commit();

  int s = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++s) {
    cp_async_wait<0>();
    __syncthreads();  // tile s has landed (with the weights); tile s - 1's stage is free
    fetch_tail_tile(xs(s + 1), x, tile + gridDim.x, tiles, T, C);
    cp_async_commit();
    const bool active = row0 < min(TAIL_ROWS, T - tile * TAIL_ROWS);
    if (!active && !L.stream) continue;
    const size_t grow0 = size_t(tile) * TAIL_ROWS + row0;
    for (int i = 0; i < P; ++i) {
      const bf16* wei = ring.next(s, i, tile + gridDim.x < tiles);
      if (!active) continue;
      float xh[NT][4];
      tail_xhat<NT>(xh, xs(s), ldx, row0, wei, C, eps);
      if constexpr (NF == 0) {
        tail_chunk_argmax<NT>(xh, gamma, beta, whs, L.ldwh, F, L.fp / TAIL_CHUNK, preds, tap,
                              grow0, i, P);
      } else {
        float lf[NF][4];
        tail_logits<NT, NF>(lf, xh, gamma, beta, whs, L.ldwh, nullptr, 0);
        if (tap != nullptr) tail_tap<NF>(tap, lf, grow0, i, P, F);
        tail_argmax<NF>(lf, preds, grow0, i, P, F);
      }
    }
  }
}

// dz of one element (row h of the lane's two, column c): dl0 Wh[c, 0] (+ dl1 Wh[c, 1]) in
// f32, in the plain version's order
__device__ __forceinline__ float depth_dz(const float (&dl)[2], const bf16* whrow, int F) {
  const float a = __fmul_rn(dl[0], bf(whrow[0]));
  return F > 1 ? __fadd_rn(a, __fmul_rn(dl[1], bf(whrow[1]))) : a;
}

// K9's row kernel: dx (T x C bf16), dh (T x p C bf16: dh_i in columns i C ..) and the
// partial row [dWh (C x F) | dgamma (C) | dbeta (C)] of each block, for the loss
// gradient scale = gloss / count (on the device); tap as K8's.  The forward is K8's,
// through the same functions; the dlogits stay f32, so dz = dlogits Wh^T is made
// element by element on the accumulator layout, and dWh = z^T dlogits, dgamma and dbeta
// are column sums by shuffles into one row a warp (rows8), added to the warp's row in
// shared memory, summed over the warps in warp order at the end
template <int NT, int NF>
__global__ void __launch_bounds__(kThreads, 1)
tail_depth_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ we,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const bf16* __restrict__ wh, const float* __restrict__ t,
                      const float* __restrict__ scale_p, bf16* __restrict__ dx,
                      bf16* __restrict__ dh, float* __restrict__ part, float* __restrict__ tap,
                      int T, int F, int P, int kind, float delta, float eps) {
  constexpr int C = 8 * NT;
  constexpr int ldx = C + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const TailLayout L = tail_layout(C, F, P, kDepthBwd);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int row0 = warp * 16;
  const int ldwh = L.ldwh;
  const int W = C * F + 2 * C;  // a partial row: dWh (C x F) | dgamma | dbeta
  bf16* wes = reinterpret_cast<bf16*>(smem);
  bf16* whs = reinterpret_cast<bf16*>(smem + L.wh);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* wred = red + warp * W;  // this warp's column sums
  auto xs = [&](int s) { return reinterpret_cast<bf16*>(smem + L.x + (s & 1) * L.stage); };
  const int tiles = (T + TAIL_ROWS - 1) / TAIL_ROWS;
  const float scale = *scale_p;

  stage_tail_weights(wes, whs, we, wh, C, F, P, ldwh);
  fetch_tail_tile(xs(0), x, blockIdx.x, tiles, T, C);
  cp_async_commit();
  for (int idx = tid; idx < kWarps * W; idx += kThreads) red[idx] = 0.f;

  int s = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++s) {
    cp_async_wait<0>();
    __syncthreads();  // tile s has landed (with the weights); tile s - 1's stage is free
    fetch_tail_tile(xs(s + 1), x, tile + gridDim.x, tiles, T, C);
    cp_async_commit();
    if (row0 >= min(TAIL_ROWS, T - tile * TAIL_ROWS)) continue;
    const size_t grow0 = size_t(tile) * TAIL_ROWS + row0;
    float dxa[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) dxa[n][0] = dxa[n][1] = dxa[n][2] = dxa[n][3] = 0.f;
    for (int i = 0; i < P; ++i) {
      const bf16* wei = wes + size_t(i) * C * ldx;
      float xh[NT][4], lf[NF][4], dl[2][2];
      const LnRows r = tail_xhat<NT>(xh, xs(s), ldx, row0, wei, C, eps);
      tail_logits<NT, NF>(lf, xh, gamma, beta, whs, ldwh, nullptr, 0);
      if (tap != nullptr) tail_tap<NF>(tap, lf, grow0, i, P, F);
      depth_dlogits<NF>(dl, lf, t, scale, grow0, i, P, F, kind, delta);

      // the LayerNorm backward's row means m1, m2 of dz gamma and dz gamma xhat, and the
      // column sums dWh = sum dl z (z remade with tail_logits' rounded operations: its
      // bits), dgamma = sum dz xhat, dbeta = sum dz
      float m[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = 8 * n + c2;
        const float gm[2] = {gamma[c], gamma[c + 1]}, be[2] = {beta[c], beta[c + 1]};
        float dz[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) dz[e] = depth_dz(dl[e >> 1], whs + (c + (e & 1)) * ldwh, F);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float a0 = __fmul_rn(dz[2 * h], gm[0]);
          const float a1 = __fmul_rn(dz[2 * h + 1], gm[1]);
          m[h][0] = __fadd_rn(m[h][0], __fadd_rn(a0, a1));
          m[h][1] = __fmaf_rn(a1, xh[n][2 * h + 1], __fmaf_rn(a0, xh[n][2 * h], m[h][1]));
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float dg = rows8(__fadd_rn(__fmul_rn(dz[k], xh[n][k]),
                                           __fmul_rn(dz[2 + k], xh[n][2 + k])));
          const float db = rows8(__fadd_rn(dz[k], dz[2 + k]));
          const float z0 = bfr(__fadd_rn(__fmul_rn(xh[n][k], gm[k]), be[k]));
          const float z1 = bfr(__fadd_rn(__fmul_rn(xh[n][2 + k], gm[k]), be[k]));
          float dw[2];
#pragma unroll
          for (int f = 0; f < 2; ++f)
            dw[f] = f < F ? rows8(__fadd_rn(__fmul_rn(dl[0][f], z0), __fmul_rn(dl[1][f], z1)))
                          : 0.f;
          if (lane < 4) {
            wred[(c + k) * F] += dw[0];
            if (F > 1) wred[(c + k) * F + 1] += dw[1];
            wred[C * F + c + k] += dg;
            wred[C * F + C + c + k] += db;
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

      // dh = rstd (dz gamma - m1 - xhat m2), dz remade (the same bits), rounded to bf16 in
      // registers: to the workspace, and as A fragments into dx += dh We_i^T
      bf16* dhrow = dh + grow0 * P * C + size_t(i) * C;
#pragma unroll
      for (int j = 0; j < NT / 4; ++j) {
        float d4[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int n = 4 * j + u, c = 8 * n + c2;
          const float gm[2] = {gamma[c], gamma[c + 1]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const float a =
                __fmul_rn(depth_dz(dl[h], whs + (c + (e & 1)) * ldwh, F), gm[e & 1]);
            d4[u][e] = r.rstd[h] * (a - m1[h] - xh[n][e] * m2[h]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(dhrow + size_t(g + 8 * h) * P * C + c) =
                pack_bf2(d4[u][2 * h], d4[u][2 * h + 1]);
        }
        uint32_t dha[2][4];
        pack_a_frags(dha, d4);
        frags_times_rows_t<NT>(dxa, dha, wei + 32 * j, ldx, NT);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + c2;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(dx + (grow0 + g + 8 * h) * C + c) =
            pack_bf2(dxa[n][2 * h], dxa[n][2 * h + 1]);
    }
  }

  // the block's partial row: the warps' column sums in warp order
  __syncthreads();
  float* prow = part + size_t(blockIdx.x) * W;
  for (int c = tid; c < W; c += kThreads) {
    float sum = red[c];
    for (int w = 1; w < kWarps; ++w) sum += red[w * W + c];
    prow[c] = sum;
  }
}

// f(NT) for the instantiation of C: 32, 64, 96 or 128 (NT = C / 8)
template <typename Fn>
cudaError_t with_c(int C, Fn f) {
  switch (C) {
    case 32: return f(std::integral_constant<int, 4>{});
    case 64: return f(std::integral_constant<int, 8>{});
    case 96: return f(std::integral_constant<int, 12>{});
    case 128: return f(std::integral_constant<int, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

// f(NT, NF) for the class head's instantiation (K3, K6, K7) of C and F: F <= 16 (NF 2),
// <= 32 (NF 4), or up to 128 in chunks of 32 (NF 0)
template <typename Fn>
cudaError_t with_tail(int C, int F, Fn f) {
  if (F < 1 || F > kTailMaxF) return cudaErrorInvalidValue;
  return with_c(C, [&](auto nt) {
    if (F <= 16) return f(nt, std::integral_constant<int, 2>{});
    if (F <= 32) return f(nt, std::integral_constant<int, 4>{});
    return f(nt, std::integral_constant<int, 0>{});
  });
}

// f(NT, NF) for the depth head's instantiation of C and F in (1, 2): NF 2
template <typename Fn>
cudaError_t with_depth(int C, int F, Fn f) {
  if (F < 1 || F > 2) return cudaErrorInvalidValue;
  return with_c(C, [&](auto nt) { return f(nt, std::integral_constant<int, 2>{}); });
}

template <int NT, int NF, int KIND>
const void* tail_kernel() {
  if constexpr (KIND == kCe) return reinterpret_cast<const void*>(tail_loss_kernel<NT, NF>);
  else if constexpr (KIND == kCeBwd)
    return reinterpret_cast<const void*>(tail_bwd_kernel<NT, NF>);
  else if constexpr (KIND == kDepth)
    return reinterpret_cast<const void*>(tail_depth_kernel<NT, NF>);
  else if constexpr (KIND == kDepthBwd)
    return reinterpret_cast<const void*>(tail_depth_bwd_kernel<NT, NF>);
  else
    return reinterpret_cast<const void*>(tail_pred_kernel<NT, NF>);
}

// the kernel's grid: min(its tiles, the blocks the card holds at once at this shared
// memory), after its one opt-in to the most shared memory a block may have
template <int NT, int NF, int KIND>
cudaError_t tail_grid(int T, int F, int P, int* grid) {
  static std::atomic<unsigned> done{0};
  const void* k = tail_kernel<NT, NF, KIND>();
  cudaError_t e = smem_opt_in(k, kTailMaxSmem, done);
  if (e != cudaSuccess) return e;
  const size_t smem = tail_layout(8 * NT, F, P, KIND).total;
  if (smem > kTailMaxSmem || T <= 0) return cudaErrorInvalidValue;
  int per = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (T + TAIL_ROWS - 1) / TAIL_ROWS, resident = per * sm_count();
  *grid = tiles < resident ? tiles : resident;
  return cudaSuccess;
}

inline int grid_of(int T, int C, int F, int P, int kind) {
  int G = 0;
  auto grid = [&](auto nt, auto nf) {
    constexpr int NT = decltype(nt)::value, NF = decltype(nf)::value;
    if constexpr (NF == 2) {  // the depth kernels have no NF 4 instantiation
      if (kind == kDepth) return tail_grid<NT, NF, kDepth>(T, F, P, &G);
      if (kind == kDepthBwd) return tail_grid<NT, NF, kDepthBwd>(T, F, P, &G);
    }
    return kind == kCe ? tail_grid<NT, NF, kCe>(T, F, P, &G)
                       : tail_grid<NT, NF, kCeBwd>(T, F, P, &G);
  };
  const bool depth = kind == kDepth || kind == kDepthBwd;
  const cudaError_t e = depth ? with_depth(C, F, grid) : with_tail(C, F, grid);
  return e == cudaSuccess ? G : 0;
}

// K6's and K8's workspace: the partial rows (W floats each), then reduce_rows' scratch
inline size_t tail_loss_workspace(int T, int C, int F, int P, int kind) {
  const int G = grid_of(T, C, F, P, kind), W = kind == kCe ? 2 + F * F : 2;
  return align128(size_t(G) * W * 4) + align128(reduce_rows_tmp_floats(G, W) * 4);
}

// K3: the row kernel alone; preds (T, p) int32, tap (may be null) the f32 logits
cudaError_t launch_tail_pred(const void* x, const void* we, const void* gamma,
                             const void* beta, const void* wh, void* preds, void* tap, int T,
                             int C, int F, int P, float eps, cudaStream_t s) {
  return with_tail(C, F, [&](auto nt, auto nf) {
    constexpr int NT = decltype(nt)::value, NF = decltype(nf)::value;
    int G = 0;
    const cudaError_t e = tail_grid<NT, NF, kPred>(T, F, P, &G);
    if (e != cudaSuccess) return e;
    tail_pred_kernel<NT, NF><<<G, kThreads, tail_layout(C, F, P, kPred).total, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(we),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const bf16*>(wh), static_cast<int*>(preds), static_cast<float*>(tap), T,
        F, P, eps);
    return cudaGetLastError();
  });
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
    cudaError_t e = tail_grid<NT, NF, kCe>(T, F, P, &G);
    if (e != cudaSuccess) return e;
    const int W = 2 + F * F;
    float* part = static_cast<float*>(work);
    float* tmp = reinterpret_cast<float*>(static_cast<unsigned char*>(work) +
                                          align128(size_t(G) * W * 4));
    tail_loss_kernel<NT, NF><<<G, kThreads, tail_layout(C, F, P, kCe).total, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(we),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const bf16*>(wh), static_cast<const int*>(y),
        static_cast<const float*>(welem), part, static_cast<bf16*>(tap), T, F, P, eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    return reduce_rows(part, static_cast<float*>(red), G, W, tmp, s);
  });
}

// K8: the row kernel, then reduce_rows over its partial rows into red = [sum loss, count]
cudaError_t launch_tail_depth(const void* x, const void* we, const void* gamma,
                              const void* beta, const void* wh, const void* t, void* red,
                              void* preds, void* work, void* tap, int T, int C, int F, int P,
                              int kind, float eps, float delta, cudaStream_t s) {
  return with_depth(C, F, [&](auto nt, auto nf) {
    constexpr int NT = decltype(nt)::value, NF = decltype(nf)::value;
    int G = 0;
    cudaError_t e = tail_grid<NT, NF, kDepth>(T, F, P, &G);
    if (e != cudaSuccess) return e;
    float* part = static_cast<float*>(work);
    float* tmp = reinterpret_cast<float*>(static_cast<unsigned char*>(work) +
                                          align128(size_t(G) * 2 * 4));
    tail_depth_kernel<NT, NF><<<G, kThreads, tail_layout(C, F, P, kDepth).total, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(we),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const bf16*>(wh), static_cast<const float*>(t), static_cast<bf16*>(preds),
        part, static_cast<float*>(tap), T, F, P, kind, delta, eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    return reduce_rows(part, static_cast<float*>(red), G, 2, tmp, s);
  });
}

// K7's and K9's workspace: dh (T x p C bf16), the row kernel's partial rows, then the
// scratch of reduce_rows or gemm_tn, whichever is larger
struct TailBwdWork {
  size_t part, tmp, total;
  int grid;
};

inline TailBwdWork tail_bwd_work(int T, int C, int F, int P, int kind) {
  TailBwdWork w;
  w.grid = grid_of(T, C, F, P, kind);
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
    cudaError_t e = tail_grid<NT, NF, kCeBwd>(T, F, P, &G);
    if (e != cudaSuccess) return e;
    tail_bwd_kernel<NT, NF><<<G, kThreads, tail_layout(C, F, P, kCeBwd).total, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(we),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const bf16*>(wh), static_cast<const int*>(y),
        static_cast<const float*>(welem), static_cast<const float*>(scale),
        static_cast<bf16*>(dx), static_cast<bf16*>(dh), static_cast<float*>(part),
        static_cast<bf16*>(tap), T, F, P, eps);
    return cudaGetLastError();
  });
}

// K9's row kernel alone: dx, dh and its partial rows part (grid x (C F + 2C))
cudaError_t launch_tail_depth_bwd_rows(const void* x, const void* we, const void* gamma,
                                       const void* beta, const void* wh, const void* t,
                                       const void* scale, void* dx, void* dh, void* part,
                                       void* tap, int T, int C, int F, int P, int kind,
                                       float eps, float delta, cudaStream_t s) {
  return with_depth(C, F, [&](auto nt, auto nf) {
    constexpr int NT = decltype(nt)::value, NF = decltype(nf)::value;
    int G = 0;
    cudaError_t e = tail_grid<NT, NF, kDepthBwd>(T, F, P, &G);
    if (e != cudaSuccess) return e;
    tail_depth_bwd_kernel<NT, NF><<<G, kThreads, tail_layout(C, F, P, kDepthBwd).total, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(we),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const bf16*>(wh), static_cast<const float*>(t),
        static_cast<const float*>(scale), static_cast<bf16*>(dx), static_cast<bf16*>(dh),
        static_cast<float*>(part), static_cast<float*>(tap), T, F, P, kind, delta, eps);
    return cudaGetLastError();
  });
}

// K7: the row kernel, reduce_rows over its partial rows into red = [dWh | dgamma |
// dbeta], then dWe = x^T dh by gemm_tn, on one stream
cudaError_t launch_tail_bwd(const void* x, const void* we, const void* gamma, const void* beta,
                            const void* wh, const void* y, const void* welem, const void* scale,
                            void* dx, void* dwe, void* red, void* work, int T, int C, int F,
                            int P, float eps, cudaStream_t s) {
  const TailBwdWork w = tail_bwd_work(T, C, F, P, kCeBwd);
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

// K9: the row kernel, dWe = x^T dh by gemm_tn, then reduce_rows over the row kernel's
// partial rows into red = [dWh | dgamma | dbeta], on one stream
cudaError_t launch_tail_depth_bwd(const void* x, const void* we, const void* gamma,
                                  const void* beta, const void* wh, const void* t,
                                  const void* scale, void* dx, void* dwe, void* red, void* work,
                                  int T, int C, int F, int P, int kind, float eps, float delta,
                                  cudaStream_t s) {
  const TailBwdWork w = tail_bwd_work(T, C, F, P, kDepthBwd);
  if (w.grid < 1) return cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(work);
  bf16* dh = reinterpret_cast<bf16*>(base);
  float* part = reinterpret_cast<float*>(base + w.part);
  float* tmp = reinterpret_cast<float*>(base + w.tmp);
  cudaError_t e = launch_tail_depth_bwd_rows(x, we, gamma, beta, wh, t, scale, dx, dh, part,
                                             nullptr, T, C, F, P, kind, eps, delta, s);
  if (e != cudaSuccess) return e;
  e = gemm_tn(static_cast<const bf16*>(x), dh, static_cast<float*>(dwe), T, C, P * C, tmp, s);
  if (e != cudaSuccess) return e;
  return reduce_rows(part, static_cast<float*>(red), w.grid, C * F + 2 * C, tmp, s);
}

}  // namespace
}  // namespace hs

extern "C" {

size_t hs_final_head_predict_smem(int C, int F, int P) {
  return hs::tail_layout(C, F, P, hs::kPred).total;
}

// K3: preds (T, p) int32; tap (may be null) gets the f32 logits (T, p, F)
int hs_final_head_predict(const void* x, const void* we, const void* gamma, const void* beta,
                          const void* wh, void* preds, void* tap, int T, int C, int F, int P,
                          float eps, void* stream) {
  return int(hs::launch_tail_pred(x, we, gamma, beta, wh, preds, tap, T, C, F, P, eps,
                                  static_cast<cudaStream_t>(stream)));
}

size_t hs_final_head_loss_smem(int C, int F, int P) {
  return hs::tail_layout(C, F, P, hs::kCe).total;
}

// K6's and K7's row kernels' grids (0 where they do not take the shape)
int hs_final_head_loss_grid(int T, int C, int F, int P) {
  return hs::grid_of(T, C, F, P, hs::kCe);
}

int hs_final_head_loss_bwd_grid(int T, int C, int F, int P) {
  return hs::grid_of(T, C, F, P, hs::kCeBwd);
}

size_t hs_final_head_loss_workspace(int T, int C, int F, int P) {
  return hs::tail_loss_workspace(T, C, F, P, hs::kCe);
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
  return hs::tail_layout(C, F, P, hs::kCeBwd).total;
}

size_t hs_final_head_loss_bwd_workspace(int T, int C, int F, int P) {
  return hs::tail_bwd_work(T, C, F, P, hs::kCeBwd).total;
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
  return hs::tail_layout(C, F, P, hs::kDepth).total;
}

// K8's and K9's row kernels' grids (0 where they do not take the shape)
int hs_final_head_depth_loss_grid(int T, int C, int F, int P) {
  return hs::grid_of(T, C, F, P, hs::kDepth);
}

int hs_final_head_depth_loss_bwd_grid(int T, int C, int F, int P) {
  return hs::grid_of(T, C, F, P, hs::kDepthBwd);
}

size_t hs_final_head_depth_loss_workspace(int T, int C, int F, int P) {
  return hs::tail_loss_workspace(T, C, F, P, hs::kDepth);
}

// K8: red = [sum loss, count of valid targets], preds (T, p F) bf16; tap (may be null)
// gets the f32 logits (T, p, F)
int hs_final_head_depth_loss(const void* x, const void* we, const void* gamma,
                             const void* beta, const void* wh, const void* t, void* red,
                             void* preds, void* work, void* tap, int T, int C, int F, int P,
                             int kind, float eps, float delta, void* stream) {
  return int(hs::launch_tail_depth(x, we, gamma, beta, wh, t, red, preds, work, tap, T, C, F,
                                   P, kind, eps, delta, static_cast<cudaStream_t>(stream)));
}

size_t hs_final_head_depth_loss_bwd_smem(int C, int F, int P) {
  return hs::tail_layout(C, F, P, hs::kDepthBwd).total;
}

size_t hs_final_head_depth_loss_bwd_workspace(int T, int C, int F, int P) {
  return hs::tail_bwd_work(T, C, F, P, hs::kDepthBwd).total;
}

// K9's row kernel alone: dx, dh (T x p C bf16) and its partial rows (hs_final_head_depth_
// loss_bwd_grid rows of C F + 2C floats: dWh | dgamma | dbeta); tap as K8's
int hs_final_head_depth_loss_bwd_rows(const void* x, const void* we, const void* gamma,
                                      const void* beta, const void* wh, const void* t,
                                      const void* scale, void* dx, void* dh, void* part,
                                      void* tap, int T, int C, int F, int P, int kind,
                                      float eps, float delta, void* stream) {
  return int(hs::launch_tail_depth_bwd_rows(x, we, gamma, beta, wh, t, scale, dx, dh, part,
                                            tap, T, C, F, P, kind, eps, delta,
                                            static_cast<cudaStream_t>(stream)));
}

// K9: the row kernel, gemm_tn, reduce_rows; red = [dWh | dgamma | dbeta]
int hs_final_head_depth_loss_bwd(const void* x, const void* we, const void* gamma,
                                 const void* beta, const void* wh, const void* t,
                                 const void* scale, void* dx, void* dwe, void* red, void* work,
                                 int T, int C, int F, int P, int kind, float eps, float delta,
                                 void* stream) {
  return int(hs::launch_tail_depth_bwd(x, we, gamma, beta, wh, t, scale, dx, dwe, red, work, T,
                                       C, F, P, kind, eps, delta,
                                       static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
