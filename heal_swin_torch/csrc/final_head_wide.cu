// The decoder tail's wide route for Hopper (sm_90a): K3, K6, K7, K8 and K9 at every width
// the Pallas tails take and the row cores of final_head.cu / tail_f32.cuh do not, in bf16
// and in f32: any C % 8 == 0 up to 192, any head of 1 to 128 classes (F in {1, 2} for
// depth), any patch p, T % 64 == 0.
//
// Replaces, at those widths, the Pallas TPU kernels of heal_swin_tpu/ops/final_head.py:
//   K3 <- _pred_kernel, K6 <- _fwd_kernel, K7 <- _bwd_kernel, K8 <- _fwd_kernel_depth,
//   K9 <- _bwd_kernel_depth
// with the same arithmetic as the plain versions of ops/final_head.py: per sub-row h =
// x We_i (f32 sums, rounded to x's dtype), the LayerNorm in f32, z = xhat gamma + beta
// (rounded to x's dtype), logits = z Wh in f32; the cross entropy on the logits rounded
// to x's dtype, the argmax and the depth loss on the f32 logits.
//
// Why another route.  The row cores hold a row's C columns in mma accumulators, one
// instantiation per C in 32, 64, 96, 128, and their tiles in shared memory grow with C, the
// head and (K8, K9 in bf16) p: a head of 128 classes at C 128 does not fit K7's tiles, and
// the f32 core's one slice is 153.6 KB at C 192 beside a 100 KB x tile.  Here nothing grows
// with p, and C and F are launch arguments: every kernel is a launch sequence of
//   1. the expand H = x We (T x p C, x's dtype) by the hand-written GEMMs of reduce.cu
//      (bf16: gemm_nt on We^T, rounded to bf16 on the way out) and attention_f32.cuh (f32:
//      gemm_3xtf32_kernel NN, 3xTF32 mma.sync), their last k slice zero-filled past C;
//   2. tail_rows_kernel on the T p sub-rows of H (a (T p) x C matrix in H's memory):
//      persistent blocks of 16 warps, a warp n = 4 sub-rows at a time (2 backward; block b,
//      warp w: rows n (16 b + w) .., then + 16 n grid, ...).  Lane l holds columns l + 32 j
//      (j < 6) of each row: the LayerNorm's sums over the warp, z to rows of shared memory,
//      then lane l makes logits l + 32 q (q < 4) of the n rows against Wh (C x F, f32 in
//      shared memory, rows padded to an odd count so that a column read across lanes is
//      conflict-free), one Wh load feeding n FMAs; the kernel's epilogue: the argmax
//      (K3), the softmax cross entropy and the confusion matrix in shared memory (K6),
//      the masked depth loss (K8); the backward's dlogits, dz =
//      dlogits Wh^T (lane l: dz of its columns, one Wh load for the n rows) and the
//      LayerNorm backward dh, written over the row of H it came from (K7, K9);
//   3. the backward's products: dx = dh We^T (gemm_nt / gemm_3xtf32_kernel NT over k = p C),
//      dWe = x^T dh (gemm_tn / TN split-K, reduce_rows), K7's dWh = z^T dlogits (the same
//      TN on the z and dlogits the row kernel wrote), and reduce_rows over the row kernel's
//      partial rows: [sum, count | confusion matrix] or [dgamma | dbeta] or, K9, [dWh |
//      dgamma | dbeta] (dWh for F <= 2 in registers, 2 x 6 sums a lane).
// Every sum across lanes, warps and blocks runs in a fixed order (the confusion matrix
// counts with integer atomics, which are order-free), so two launches give the same bits.

#include <type_traits>

#include "attention_f32.cuh"
#include "depth_loss.cuh"

namespace hs {
namespace {

constexpr int WR_WARPS = 16;
constexpr int WR_THREADS = WR_WARPS * 32;
constexpr int WR_MAX_C = 192;         // Swin-L's embed width
constexpr int WR_V = WR_MAX_C / 32;   // a lane's columns of a row
constexpr int WR_MAX_F = 128;
constexpr int WR_Q = WR_MAX_F / 32;   // a lane's head columns
constexpr size_t kWideMaxSmem = 232448;  // an H100 block's opt-in shared memory

enum WideKind : int { kWPred = 0, kWCe = 1, kWCeBwd = 2, kWDepth = 3, kWDepthBwd = 4 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return bf(v); }

// v rounded to E (the plain version's .to(x.dtype))
template <class E>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<E, bf16>::value) return bfr(v);
  else return v;
}

template <class E>
__device__ __forceinline__ void store(E* p, float v) {
  if constexpr (std::is_same<E, bf16>::value) *p = to_bf(v);
  else *p = v;
}

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// the row kernel's partial row: K6 [sum w*nll, sum w | confusion matrix (F x F)]; K8 [sum
// loss, count]; K7 [dgamma | dbeta]; K9 [dWh (C x F) | dgamma | dbeta]; K3 none
__host__ __device__ inline int wide_part_width(int kind, int C, int F) {
  switch (kind) {
    case kWCe: return 2 + F * F;
    case kWDepth: return 2;
    case kWCeBwd: return 2 * C;
    case kWDepthBwd: return C * F + 2 * C;
    default: return 0;
  }
}

// a warp's own sums before the block adds them: [sum, count] or the partial row's columns
__host__ __device__ inline int wide_warp_width(int kind, int C, int F) {
  return kind == kWCe ? 2 : wide_part_width(kind, C, F);
}

// shared memory: Wh (C x ldw f32, zero past F) | each warp's z rows (rows_per_warp x C
// f32) | K7, K9: its dlogits rows (rows_per_warp x 32 nq f32) | K6: the confusion matrix
// (F x F int) | the warps' sums.  The largest, K6 at C 192, F 128, is 213,888 B.
struct WideLayout {
  size_t z, dl, cm, red, total;
  int ldw;
};

// the sub-rows a warp holds at once: a Wh load feeds that many rows' FMAs (the backward
// keeps dz and xhat of each, so it holds fewer)
__host__ __device__ constexpr int rows_per_warp(int kind) {
  return kind == kWCeBwd || kind == kWDepthBwd ? 2 : 4;
}

__host__ __device__ inline WideLayout wide_layout(int C, int F, int kind) {
  WideLayout L;
  const int rpw = rows_per_warp(kind);
  L.ldw = round_up(F, 32) + 1;  // odd: Wh[c][f] across lanes c hits 32 banks
  size_t off = align128(size_t(C) * L.ldw * 4);
  L.z = off; off += align128(size_t(WR_WARPS) * rpw * C * 4);
  L.dl = off;
  if (kind == kWCeBwd || kind == kWDepthBwd)
    off += align128(size_t(WR_WARPS) * rpw * round_up(F, 32) * 4);
  L.cm = off; if (kind == kWCe) off += align128(size_t(F) * F * 4);
  L.red = off; off += align128(size_t(WR_WARPS) * wide_warp_width(kind, C, F) * 4);
  L.total = off;
  return L;
}

struct WideRows {
  const void* h;           // (R, C) in x's dtype: the expand's sub-rows; K7, K9: dh over it
  const float* gamma;
  const float* beta;
  const void* wh;          // (C, F) in x's dtype
  const int* y;            // K6, K7: (R,) targets
  const float* welem;      // K6, K7: (R,) element weights
  const float* t;          // K8, K9: (R,) targets, non-finite = background
  const float* scale;      // K7, K9: the loss gradient over the denominator (device)
  int* preds;              // K3: (R,) classes
  void* dpred;             // K8: (R, F) predictions in x's dtype
  void* z;                 // K7: (R, C) z in x's dtype
  void* dl;                // K7: (R, F8) dlogits in x's dtype, zero past F
  float* part;             // (grid, wide_part_width)
  void* tap;               // (R, F) logits: f32 (K3, K8, K9), x's dtype (K6, K7); or null
  int R, C, F, loss_kind;
  float delta, eps;
};

// the row's (max, sum of exp(l - max), lowest column at the max or F where a logit is NaN)
// over lanes l + 32 q < F of the warp; ex = exp(l - max) (0 past F)
struct RowMax {
  float mx, se;
  int best;
};

__device__ __forceinline__ RowMax row_softmax(const float (&l)[WR_Q], float (&ex)[WR_Q],
                                              int F, int nq, bool want_exp) {
  const int lane = threadIdx.x & 31;
  RowMax r;
  bool nan = false;
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int q = 0; q < WR_Q; ++q)
    if (q < nq && lane + 32 * q < F) {
      nan |= isnan(l[q]);
      mx = fmaxf(mx, l[q]);  // fmaxf drops a NaN: the flag keeps it
    }
  nan = __any_sync(0xffffffffu, nan);
  mx = warp_max(mx);
  r.mx = nan ? CUDART_NAN_F : mx;
  int best = F;
#pragma unroll
  for (int q = WR_Q - 1; q >= 0; --q)
    if (q < nq && lane + 32 * q < F && l[q] >= r.mx) best = lane + 32 * q;
  r.best = __reduce_min_sync(0xffffffffu, best);
  r.se = 0.f;
  if (want_exp) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < WR_Q; ++q) {
      ex[q] = q < nq && lane + 32 * q < F ? expf(l[q] - r.mx) : 0.f;
      s += ex[q];
    }
    r.se = warp_sum(s);
  }
  return r;
}

template <class E, int KIND>
__global__ void __launch_bounds__(WR_THREADS, 1) tail_rows_kernel(const WideRows a) {
  constexpr bool BWD = KIND == kWCeBwd || KIND == kWDepthBwd;
  constexpr bool DEPTH = KIND == kWDepth || KIND == kWDepthBwd;
  constexpr int RPW = rows_per_warp(KIND);
  extern __shared__ __align__(128) unsigned char wide_smem[];
  unsigned char* smem = wide_smem;
  const int C = a.C, F = a.F;
  const WideLayout L = wide_layout(C, F, KIND);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ldw = L.ldw, nq = (F + 31) / 32, FP = 32 * nq;
  float* whs = reinterpret_cast<float*>(smem);
  float* zs = reinterpret_cast<float*>(smem + L.z) + warp * RPW * C;    // RPW rows of z
  float* dls = reinterpret_cast<float*>(smem + L.dl) + warp * RPW * FP;  // and of dlogits
  int* cm = reinterpret_cast<int*>(smem + L.cm);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const E* wh = static_cast<const E*>(a.wh);
  E* h = static_cast<E*>(const_cast<void*>(a.h));

  for (int idx = tid; idx < C * ldw; idx += WR_THREADS) {
    const int c = idx / ldw, f = idx - c * ldw;
    whs[idx] = f < F ? to_f(wh[size_t(c) * F + f]) : 0.f;
  }
  if constexpr (KIND == kWCe)
    for (int idx = tid; idx < F * F; idx += WR_THREADS) cm[idx] = 0;
  float g[WR_V], b[WR_V];
#pragma unroll
  for (int j = 0; j < WR_V; ++j) {
    const int col = lane + 32 * j;
    g[j] = col < C ? a.gamma[col] : 0.f;
    b[j] = col < C ? a.beta[col] : 0.f;
  }
  __syncthreads();

  const float scale = BWD ? *a.scale : 0.f;
  float num = 0.f, den = 0.f;                  // lane 0: the warp's loss sums
  float dgam[WR_V], dbet[WR_V], dwh[2][WR_V];  // the backward's column sums
#pragma unroll
  for (int j = 0; j < WR_V; ++j) dgam[j] = dbet[j] = dwh[0][j] = dwh[1][j] = 0.f;

  const int stride = gridDim.x * WR_WARPS * RPW;
  // the tokens of rows r .. r + RPW - 1 into v (0 past R and past C): the loop loads the
  // next rows' while it works on these
  auto load_rows = [&](int r, float (&v)[RPW][WR_V]) {
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      const E* hr = h + size_t(r + k) * C;
#pragma unroll
      for (int j = 0; j < WR_V; ++j) {
        const int col = lane + 32 * j;
        v[k][j] = r + k < a.R && col < C ? to_f(hr[col]) : 0.f;
      }
    }
  };
  float next[RPW][WR_V];
  load_rows((blockIdx.x * WR_WARPS + warp) * RPW, next);
  for (int r0 = (blockIdx.x * WR_WARPS + warp) * RPW; r0 < a.R; r0 += stride) {
    const int rows = min(RPW, a.R - r0);  // the warp's rows that exist (warp-uniform)
    float xh[RPW][WR_V], rstd[RPW];
#pragma unroll
    for (int k = 0; k < RPW; ++k)
#pragma unroll
      for (int j = 0; j < WR_V; ++j) xh[k][j] = next[k][j];
    if (r0 + stride < a.R) load_rows(r0 + stride, next);
    // the rows' targets and weights, loaded beside their tokens
    int yk[RPW];
    float wk[RPW], tk[RPW];
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      const bool live = k < rows;
      if constexpr (KIND == kWCe || KIND == kWCeBwd) {
        yk[k] = live ? a.y[r0 + k] : 0;
        wk[k] = live ? a.welem[r0 + k] : 0.f;
      }
      if constexpr (DEPTH) tk[k] = live ? a.t[r0 + k] : 0.f;
    }
    // the LayerNorm of each row: mean, then the mean of the squared deviations
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < WR_V; ++j) s = __fadd_rn(s, xh[k][j]);
      const float mean = __fdiv_rn(warp_sum(s), float(C));
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < WR_V; ++j) {
        if (lane + 32 * j < C) {
          xh[k][j] = __fsub_rn(xh[k][j], mean);
          sq = __fmaf_rn(xh[k][j], xh[k][j], sq);
        }
      }
      rstd[k] = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), float(C)), a.eps));
#pragma unroll
      for (int j = 0; j < WR_V; ++j) {
        const int col = lane + 32 * j;
        xh[k][j] = col < C ? __fmul_rn(xh[k][j], rstd[k]) : 0.f;
        if (col < C) zs[k * C + col] = round_to<E>(__fadd_rn(__fmul_rn(xh[k][j], g[j]), b[j]));
      }
    }
    __syncwarp();
    // logits lane + 32 q = z Wh of each row, k ascending; one Wh load a column for all
    // the rows, z four columns at a time (C % 8 == 0)
    float lf[RPW][WR_Q];
#pragma unroll
    for (int k = 0; k < RPW; ++k)
#pragma unroll
      for (int q = 0; q < WR_Q; ++q) lf[k][q] = 0.f;
    const float* wl = whs + lane;
    for (int c = 0; c < C; c += 4) {
      float4 z4[RPW];
#pragma unroll
      for (int k = 0; k < RPW; ++k) z4[k] = *reinterpret_cast<const float4*>(zs + k * C + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int q = 0; q < WR_Q; ++q) {
          if (q < nq) {
            const float w = wl[(c + cc) * ldw + 32 * q];
#pragma unroll
            for (int k = 0; k < RPW; ++k) {
              const float zc = cc == 0 ? z4[k].x : cc == 1 ? z4[k].y : cc == 2 ? z4[k].z : z4[k].w;
              lf[k][q] = __fmaf_rn(zc, w, lf[k][q]);
            }
          }
        }
      }
    }

    // each row's epilogue; a row past R (live false) computes beside the others, so that
    // the rows' warp reductions interleave, and stores and adds nothing
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      const bool live = k < rows;
      const int r = r0 + k;
      float* dlk = dls + k * FP;
      if constexpr (KIND == kWPred) {
        float ex[WR_Q];
        const RowMax m = row_softmax(lf[k], ex, F, nq, false);
        if (live && lane == 0) a.preds[r] = m.best < F ? m.best : F - 1;  // F - 1: NaN row
        if (live && a.tap != nullptr)
#pragma unroll
          for (int q = 0; q < WR_Q; ++q)
            if (q < nq && lane + 32 * q < F)
              static_cast<float*>(a.tap)[size_t(r) * F + lane + 32 * q] = lf[k][q];
      } else if constexpr (KIND == kWCe || KIND == kWCeBwd) {
        // the cross entropy on the logits rounded to x's dtype
        float l[WR_Q], ex[WR_Q];
#pragma unroll
        for (int q = 0; q < WR_Q; ++q) l[q] = round_to<E>(lf[k][q]);
        const RowMax m = row_softmax(l, ex, F, nq, true);
        const int yi = yk[k];
        if (live && a.tap != nullptr)
#pragma unroll
          for (int q = 0; q < WR_Q; ++q)
            if (q < nq && lane + 32 * q < F)
              store(static_cast<E*>(a.tap) + size_t(r) * F + lane + 32 * q, l[q]);
        if constexpr (KIND == kWCe) {
          float sel = 0.f;  // the target's logit (0 for a target outside 0 .. F - 1)
#pragma unroll
          for (int q = 0; q < WR_Q; ++q)
            if (q < nq && yi >= 0 && yi < F && (yi >> 5) == q) sel = l[q];
          const float ly = __shfl_sync(0xffffffffu, sel, yi & 31);
          if (live && lane == 0) {
            const float wi = wk[k];
            num += wi * (m.mx + logf(m.se) - (yi >= 0 && yi < F ? ly : 0.f));
            den += wi;
            if (m.best < F && yi >= 0 && yi < F) atomicAdd(cm + yi * F + m.best, 1);  // order-free
          }
        } else {
          // dlogits = scale w (softmax - onehot), rounded to x's dtype, 0 past F
          const float sw = __fmul_rn(scale, wk[k]);
          const int F8 = round_up(F, 8);
          E* dlr = static_cast<E*>(a.dl) + size_t(r) * F8;
#pragma unroll
          for (int q = 0; q < WR_Q; ++q) {
            const int f = lane + 32 * q;
            if (q < nq) {
              const float d = f < F ? round_to<E>(sw * (__fdiv_rn(ex[q], m.se) -
                                                        (f == yi ? 1.f : 0.f)))
                                    : 0.f;
              dlk[f] = d;
              if (live && f < F8) store(dlr + f, d);
            }
          }
          E* zr = static_cast<E*>(a.z) + size_t(r) * C;
#pragma unroll
          for (int j = 0; j < WR_V; ++j)
            if (live && lane + 32 * j < C) store(zr + lane + 32 * j, zs[k * C + lane + 32 * j]);
        }
      } else {
        // depth: logits 0 (mean) and 1 (logvar), f32, on lanes 0 and 1
        const float l0 = __shfl_sync(0xffffffffu, lf[k][0], 0);
        const float l1 = __shfl_sync(0xffffffffu, lf[k][0], 1);
        const float lv[2] = {l0, F > 1 ? l1 : 0.f};
        const float tv = tk[k];
        const bool valid = isfinite(tv);
        if (live && a.tap != nullptr && lane < F)
          static_cast<float*>(a.tap)[size_t(r) * F + lane] = lf[k][0];
        if constexpr (KIND == kWDepth) {
          if (live && lane < F) store(static_cast<E*>(a.dpred) + size_t(r) * F + lane, lf[k][0]);
          if (live && lane == 0 && valid) {
            num += depth_loss(lv, depth_diff(l0, tv, valid), a.loss_kind, a.delta);
            den += 1.f;
          }
        } else {
          float gr[2];
          depth_grads(lv, depth_diff(l0, tv, valid), valid, a.loss_kind, a.delta, gr);
          if (lane < 2) dlk[lane] = lane == 0 ? __fmul_rn(scale, gr[0])
                                              : (F > 1 ? __fmul_rn(scale, gr[1]) : 0.f);
        }
      }
    }

    if constexpr (BWD) {
      __syncwarp();  // the rows' dlogits are in dls
      // dz = dlogits Wh^T for the lane's columns, one Wh load for all the rows
      float dz[RPW][WR_V];
#pragma unroll
      for (int j = 0; j < WR_V; ++j) {
        const int col = lane + 32 * j;
#pragma unroll
        for (int k = 0; k < RPW; ++k) dz[k][j] = 0.f;
        if (col < C) {
          const float* w = whs + col * ldw;
          if constexpr (DEPTH) {
#pragma unroll
            for (int k = 0; k < RPW; ++k) {
              dz[k][j] = __fmul_rn(dls[k * FP], w[0]);
              if (F > 1) dz[k][j] = __fadd_rn(dz[k][j], __fmul_rn(dls[k * FP + 1], w[1]));
            }
          } else {
            for (int f = 0; f < F; ++f) {
              const float wf = w[f];
#pragma unroll
              for (int k = 0; k < RPW; ++k) dz[k][j] = __fmaf_rn(dls[k * FP + f], wf, dz[k][j]);
            }
          }
        }
      }
      // the LayerNorm backward of each row: dh over h; the columns' sums (of live rows)
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        const bool live = k < rows;
        float m1 = 0.f, m2 = 0.f;
#pragma unroll
        for (int j = 0; j < WR_V; ++j) {
          const float dzg = __fmul_rn(dz[k][j], g[j]);
          m1 = __fadd_rn(m1, dzg);
          m2 = __fmaf_rn(dzg, xh[k][j], m2);
        }
        m1 = __fdiv_rn(warp_sum(m1), float(C));
        m2 = __fdiv_rn(warp_sum(m2), float(C));
        E* hr = h + size_t(r0 + k) * C;
#pragma unroll
        for (int j = 0; j < WR_V; ++j) {
          const int col = lane + 32 * j;
          if (live && col < C) {
            const float dzg = __fmul_rn(dz[k][j], g[j]);
            store(hr + col, rstd[k] * (dzg - m1 - xh[k][j] * m2));  // dh over h
            dgam[j] = __fadd_rn(dgam[j], __fmul_rn(dz[k][j], xh[k][j]));
            dbet[j] = __fadd_rn(dbet[j], dz[k][j]);
            if constexpr (DEPTH) {
              const float zc = zs[k * C + col];
              dwh[0][j] = __fmaf_rn(zc, dls[k * FP], dwh[0][j]);
              dwh[1][j] = __fmaf_rn(zc, dls[k * FP + 1], dwh[1][j]);
            }
          }
        }
      }
    }
    __syncwarp();  // zs and dls are free for the next rows
  }

  // the block's partial row: the warps' sums added in warp order
  if constexpr (KIND == kWPred) return;
  const int W = wide_warp_width(KIND, C, F);
  float* wr = red + warp * W;
  if constexpr (KIND == kWCe || KIND == kWDepth) {
    if (lane == 0) {
      wr[0] = num;
      wr[1] = den;
    }
  } else {
#pragma unroll
    for (int j = 0; j < WR_V; ++j) {
      const int col = lane + 32 * j;
      if (col < C) {
        if constexpr (DEPTH) {
          wr[col * F] = dwh[0][j];
          if (F > 1) wr[col * F + 1] = dwh[1][j];
          wr[C * F + col] = dgam[j];
          wr[C * F + C + col] = dbet[j];
        } else {
          wr[col] = dgam[j];
          wr[C + col] = dbet[j];
        }
      }
    }
  }
  __syncthreads();
  float* prow = a.part + size_t(blockIdx.x) * wide_part_width(KIND, C, F);
  for (int c = tid; c < W; c += WR_THREADS) {
    float sum = red[c];
    for (int w = 1; w < WR_WARPS; ++w) sum = __fadd_rn(sum, red[w * W + c]);
    prow[c] = sum;
  }
  if constexpr (KIND == kWCe)
    for (int idx = tid; idx < F * F; idx += WR_THREADS) prow[2 + idx] = float(cm[idx]);
}

// ---------------------------------------------------------------------------------
// launch plumbing
// ---------------------------------------------------------------------------------

template <class E, typename Fn>
cudaError_t with_kind(int kind, Fn f) {
  switch (kind) {
    case kWPred: return f(std::integral_constant<int, kWPred>{});
    case kWCe: return f(std::integral_constant<int, kWCe>{});
    case kWCeBwd: return f(std::integral_constant<int, kWCeBwd>{});
    case kWDepth: return f(std::integral_constant<int, kWDepth>{});
    case kWDepthBwd: return f(std::integral_constant<int, kWDepthBwd>{});
    default: return cudaErrorInvalidValue;
  }
}

inline bool wide_takes(int T, int C, int F, int P, int kind) {
  const bool depth = kind == kWDepth || kind == kWDepthBwd;
  return T > 0 && T % 64 == 0 && C >= 8 && C <= WR_MAX_C && C % 8 == 0 && P >= 1 && F >= 1 &&
         F <= (depth ? 2 : WR_MAX_F);
}

// the row kernel's grid: min(the rows' warps' blocks, the blocks the card holds at once)
template <class E>
int wide_grid(int T, int C, int F, int P, int kind) {
  if (!wide_takes(T, C, F, P, kind)) return 0;
  int G = 0;
  const cudaError_t e = with_kind<E>(kind, [&](auto k) {
    constexpr int KIND = decltype(k)::value;
    static std::atomic<unsigned> done{0};
    const void* fn = reinterpret_cast<const void*>(tail_rows_kernel<E, KIND>);
    cudaError_t err = smem_opt_in(fn, kWideMaxSmem, done);
    if (err != cudaSuccess) return err;
    const size_t smem = wide_layout(C, F, KIND).total;
    if (smem > kWideMaxSmem) return cudaErrorInvalidValue;
    int per = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fn, WR_THREADS, smem);
    if (err != cudaSuccess) return err;
    if (per < 1) return cudaErrorInvalidConfiguration;
    const long rows = long(T) * P, of_block = long(WR_WARPS) * rows_per_warp(KIND);
    const long blocks = (rows + of_block - 1) / of_block;
    const long resident = long(per) * sm_count();
    G = int(blocks < resident ? blocks : resident);
    return cudaSuccess;
  });
  return e == cudaSuccess ? G : 0;
}

template <class E>
cudaError_t launch_rows(const WideRows& a, int kind, int grid, cudaStream_t s) {
  return with_kind<E>(kind, [&](auto k) {
    constexpr int KIND = decltype(k)::value;
    tail_rows_kernel<E, KIND><<<grid, WR_THREADS, wide_layout(a.C, a.F, KIND).total, s>>>(a);
    return cudaGetLastError();
  });
}

// the wide workspace (bytes): H (T x p C; dh over it) | K7: z (T p x C), dlogits (T p x F8),
// dWh (C x F8 f32) | the partial rows (grid x width f32) | the GEMMs' and reduce_rows'
// scratch
struct WideWork {
  size_t z, dl, dwh, part, tmp, total;
  int grid;
};

template <class E>
WideWork wide_work(int T, int C, int F, int P, int kind) {
  constexpr size_t es = sizeof(E);
  constexpr bool f32 = std::is_same<E, float>::value;
  WideWork w;
  w.grid = wide_grid<E>(T, C, F, P, kind);
  const size_t R = size_t(T) * P;
  const int F8 = round_up(F, 8), Wp = wide_part_width(kind, C, F);
  size_t off = align128(R * C * es);
  w.z = w.dl = w.dwh = off;
  if (kind == kWCeBwd) {
    w.z = off; off += align128(R * C * es);
    w.dl = off; off += align128(R * F8 * es);
    w.dwh = off; off += align128(size_t(C) * F8 * 4);
  }
  w.part = off; off += align128(size_t(w.grid) * Wp * 4);
  size_t tmp = reduce_rows_tmp_floats(w.grid, Wp);
  auto at_least = [&](size_t v) { tmp = tmp > v ? tmp : v; };
  if (kind == kWCeBwd || kind == kWDepthBwd)
    at_least(f32 ? gemm_tn_f32_tmp_floats(T, C, P * C) : gemm_tn_tmp_floats(T, C, P * C));
  if (kind == kWCeBwd)
    at_least(f32 ? gemm_tn_f32_tmp_floats(int(R), C, F8) : gemm_tn_tmp_floats(int(R), C, F8));
  w.tmp = off; off += align128(tmp * 4);
  w.total = off;
  return w;
}

// the expand H = x We (T x p C): bf16 through We^T (p C x C), f32 through We (C x p C)
inline cudaError_t expand(const bf16* x, const void* we, const void* weT, bf16* H, int T, int C,
                          int P, cudaStream_t s) {
  (void)we;
  return gemm_nt_any_k(x, static_cast<const bf16*>(weT), H, T, P * C, C, s);
}

inline cudaError_t expand(const float* x, const void* we, const void* weT, float* H, int T,
                          int C, int P, cudaStream_t s) {
  (void)weT;
  return gemm_nn_f32_any_k(x, static_cast<const float*>(we), H, T, P * C, C, s);
}

// dx = dh We^T (T x C) over k = p C
inline cudaError_t dx_of(const bf16* dh, const void* we, void* dx, int T, int C, int P,
                         cudaStream_t s) {
  return gemm_nt_any_k(dh, static_cast<const bf16*>(we), static_cast<bf16*>(dx), T, C, P * C, s);
}

inline cudaError_t dx_of(const float* dh, const void* we, void* dx, int T, int C, int P,
                         cudaStream_t s) {
  return gemm_nt_f32_any_k(dh, static_cast<const float*>(we), static_cast<float*>(dx), T, C,
                           P * C, s);
}

// out (M x N f32) = A^T B over K rows
inline cudaError_t tn(const bf16* A, const bf16* B, float* out, int K, int M, int N, float* tmp,
                      cudaStream_t s) {
  return gemm_tn(A, B, out, K, M, N, tmp, s);
}

inline cudaError_t tn(const float* A, const float* B, float* out, int K, int M, int N,
                      float* tmp, cudaStream_t s) {
  return gemm_tn_f32(A, B, out, K, M, N, tmp, s);
}

// dst (rows x cols f32) = the first cols columns of src (rows x lds)
__global__ void copy_cols_kernel(const float* __restrict__ src, float* __restrict__ dst,
                                 int rows, int cols, int lds) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rows * cols) dst[i] = src[size_t(i / cols) * lds + i % cols];
}

struct WideCall {
  int kind;
  const void *x, *we, *weT, *gamma, *beta, *wh, *y, *welem, *t, *scale;
  void *preds, *dpred, *red, *tap, *dx, *dwe, *work;
  int T, C, F, P, loss_kind;
  float eps, delta;
};

// forward (K3, K6, K8): expand, the row kernel, reduce_rows of its partial rows into red;
// backward (K7, K9): expand, the row kernel (dh over H), dx, dWe, K7's dWh, reduce_rows of
// the partial rows into red ([dWh | dgamma | dbeta], K7's dWh from its TN)
template <class E>
cudaError_t launch_wide(const WideCall& c, cudaStream_t s) {
  const int kind = c.kind, T = c.T, C = c.C, F = c.F, P = c.P;
  if (!wide_takes(T, C, F, P, kind)) return cudaErrorInvalidValue;
  if ((kind == kWDepth || kind == kWDepthBwd) &&
      (c.loss_kind < kL2 || c.loss_kind > kNll || (c.loss_kind == kNll && F != 2)))
    return cudaErrorInvalidValue;
  const WideWork w = wide_work<E>(T, C, F, P, kind);
  if (w.grid < 1) return cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(c.work);
  E* H = reinterpret_cast<E*>(base);
  float* part = reinterpret_cast<float*>(base + w.part);
  float* tmp = reinterpret_cast<float*>(base + w.tmp);
  const int F8 = round_up(F, 8), R = T * P;
  cudaError_t e = expand(static_cast<const E*>(c.x), c.we, c.weT, H, T, C, P, s);
  if (e != cudaSuccess) return e;
  WideRows a;
  a.h = H;
  a.gamma = static_cast<const float*>(c.gamma);
  a.beta = static_cast<const float*>(c.beta);
  a.wh = c.wh;
  a.y = static_cast<const int*>(c.y);
  a.welem = static_cast<const float*>(c.welem);
  a.t = static_cast<const float*>(c.t);
  a.scale = static_cast<const float*>(c.scale);
  a.preds = static_cast<int*>(c.preds);
  a.dpred = c.dpred;
  a.z = base + w.z;
  a.dl = base + w.dl;
  a.part = part;
  a.tap = c.tap;
  a.R = R;
  a.C = C;
  a.F = F;
  a.loss_kind = c.loss_kind;
  a.delta = c.delta;
  a.eps = c.eps;
  e = launch_rows<E>(a, kind, w.grid, s);
  if (e != cudaSuccess) return e;
  const int Wp = wide_part_width(kind, C, F);
  float* red = static_cast<float*>(c.red);
  if (kind == kWPred) return cudaSuccess;
  if (kind == kWCe || kind == kWDepth) return reduce_rows(part, red, w.grid, Wp, tmp, s);
  e = dx_of(H, c.we, c.dx, T, C, P, s);
  if (e == cudaSuccess) e = tn(static_cast<const E*>(c.x), H, static_cast<float*>(c.dwe), T, C,
                               P * C, tmp, s);
  if (e != cudaSuccess) return e;
  if (kind == kWDepthBwd) return reduce_rows(part, red, w.grid, Wp, tmp, s);
  float* dwh = reinterpret_cast<float*>(base + w.dwh);
  e = tn(static_cast<const E*>(a.z), static_cast<const E*>(a.dl), dwh, R, C, F8, tmp, s);
  if (e != cudaSuccess) return e;
  copy_cols_kernel<<<(C * F + 255) / 256, 256, 0, s>>>(dwh, red, C, F, F8);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_rows(part, red + C * F, w.grid, Wp, tmp, s);
}

}  // namespace
}  // namespace hs

extern "C" {

// kind: 0 K3, 1 K6, 2 K7, 3 K8, 4 K9; f32: x's dtype is float32 (else bfloat16)
size_t hs_final_head_wide_workspace(int T, int C, int F, int P, int kind, int f32) {
  return f32 ? hs::wide_work<float>(T, C, F, P, kind).total
             : hs::wide_work<hs::bf16>(T, C, F, P, kind).total;
}

// the row kernel's shared memory (bytes) for a kind at width C and F outputs; the wrappers
// refuse a tail whose figure exceeds a block's opt-in limit
size_t hs_final_head_wide_smem(int C, int F, int kind) {
  return hs::wide_layout(C, F, kind).total;
}

// One entry for the five kernels' wide route.  x (T, C); we (C, p C) and, bf16, weT (p C,
// C) in x's dtype; gamma, beta (C) f32; wh (C, F) in x's dtype.  K3: preds (T p) int32.
// K6: y, welem (T p); red = [sum w*nll, sum w, confusion matrix].  K8: t (T p); red = [sum
// loss, count], dpred (T p F) in x's dtype.  K7 / K9: also scale (device f32); dx (T, C)
// in x's dtype, dwe (C, p C) f32, red = [dWh (C x F) | dgamma | dbeta].  tap (may be
// null): the logits (T p, F), f32 for K3, K8, K9 and in x's dtype for K6, K7.
int hs_final_head_wide(int kind, int f32, const void* x, const void* we, const void* weT,
                       const void* gamma, const void* beta, const void* wh, const void* y,
                       const void* welem, const void* t, const void* scale, void* preds,
                       void* dpred, void* red, void* tap, void* dx, void* dwe, void* work,
                       int T, int C, int F, int P, int loss_kind, float eps, float delta,
                       void* stream) {
  const hs::WideCall c{kind, x, we, weT, gamma, beta, wh, y, welem, t, scale, preds, dpred,
                       red, tap, dx, dwe, work, T, C, F, P, loss_kind, eps, delta};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(f32 ? hs::launch_wide<float>(c, s) : hs::launch_wide<hs::bf16>(c, s));
}

}  // extern "C"
