// Window attention backward of HEAL-SWIN for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of heal_swin_tpu/ops/window_attention.py:
//   K4 hs_window_attention_qkv_epi_bwd <- _bwd_kernel_xw_epi, the backward of K1
//      (qkv projection + cosine attention + output projection + LayerNorm): one block
//      per 64-token window.  Phase 1 recomputes qkv = x Wqkv + b and, per head, the
//      softmax and the attention output o; then u = o Wp + bp, the LayerNorm backward
//      (du), and do = du Wp^T; phase 2 recomputes each head's softmax and runs the
//      attention backward with the cosine tangent projection (dq, dk); finally
//      dx = dqkv Wqkv^T.
//   K5 hs_window_attention_bwd <- _bwd_kernel (_attn_bwd_body_cos_wide for cosine,
//      _attn_bwd_body for scaled-dot), the backward of K2: one block per
//      (window, head), dv, dp, ds and dq, dk from qkv rows and dout.
//
// What bounds it on this card: K4 does about 3x K1's products per window (qkv and
// output projections, QK^T and PV recomputed, PV^T, dP, two ds products, do and dx),
// near or above the bf16 ridge like K1, plus the parameter gradients, which the TPU
// kernel accumulates across its sequential grid: dWqkv = x^T dqkv, dWp = o^T du,
// dbias (h x 64 x 64), dlogit_scale, dbqkv, dbp, dgamma, dbeta.
//
// What the design does about it:
// - Parameter gradients without atomics, in a fixed order: each block writes a
//   partial row per window (its ds for dbias, and column sums for the vectors), and
//   reduce.cu sums the rows; dWqkv and dWp are split-K products over the token axis
//   (reduce.cu gemm_tn) of bf16 x, o, dqkv and du that the kernel leaves in a
//   workspace (the TPU kernel keeps them in VMEM).  Results do not change from run to
//   run.
// - Shared memory: the TPU kernel caches every head's f32 softmax (192 KB at
//   C = 384) beside x, o and dqkv; here phase 2 recomputes p per head from the qkv
//   rows phase 1 left in the workspace (the same f32 values, computed the same way),
//   and the x tile, the f32 projection output u and the phase-2 head scratch share
//   one region (168 KB at C = 384, 103 KB at C = 96).
// - The softmax shift is the row max, as in K1's forward (the Pallas kernels use a
//   static bound); the backward uses the shift its own recomputation uses.
// - bf16 rounding at the Pallas backward's points: qkv; (q/|q|)*scale and k/|k|; p
//   before dv; ds before the q/k products; du before dWp and do; do; dqkv before dx
//   and dW.  Products are 16x16x16 bf16 WMMA tiles with f32 accumulation, weights
//   streamed from L2 as fragments as in K1; wgmma/TMA pipelines are later work.

#include "attention.cuh"

namespace hs {
namespace {

constexpr int MAX_C = 384;
constexpr int MAXJ = MAX_C / 32;    // columns per lane in a row pass

// Per-head scratch of the attention backward (K5's block, K4's phase 2).
struct Head {
  bf16 *qr, *kr, *qs, *kl, *v, *dob;  // q, k as rounded; the score operands; v; do (K5)
  float *s, *dp;                      // scores, then f32 p; dp = do v^T
  float *aq, *bk;                     // dv staging, then ds k_hat; ds^T (q_hat * scale)
  bf16* pl;                           // bf16 p, then bf16 ds
  float *uq, *uk, *red;               // per-row inverse norms; per-warp sums
  int* g;                             // the window's group ids
};

__host__ __device__ inline size_t head_bytes() {
  return 6 * align128(size_t(WS) * LD_HEAD * 2) + 2 * align128(size_t(WS) * LD_S * 4) +
         2 * align128(size_t(WS) * LD_T * 4) + align128(size_t(WS) * LD_P * 2) +
         4 * align128(size_t(WS) * 4);
}

__device__ inline Head carve_head(unsigned char* base) {
  Head h;
  size_t off = 0;
  bf16** bfs[6] = {&h.qr, &h.kr, &h.qs, &h.kl, &h.v, &h.dob};
  for (int i = 0; i < 6; ++i) {
    *bfs[i] = reinterpret_cast<bf16*>(base + off);
    off += align128(size_t(WS) * LD_HEAD * 2);
  }
  h.s = reinterpret_cast<float*>(base + off); off += align128(size_t(WS) * LD_S * 4);
  h.dp = reinterpret_cast<float*>(base + off); off += align128(size_t(WS) * LD_S * 4);
  h.aq = reinterpret_cast<float*>(base + off); off += align128(size_t(WS) * LD_T * 4);
  h.bk = reinterpret_cast<float*>(base + off); off += align128(size_t(WS) * LD_T * 4);
  h.pl = reinterpret_cast<bf16*>(base + off); off += align128(size_t(WS) * LD_P * 2);
  h.uq = reinterpret_cast<float*>(base + off); off += align128(size_t(WS) * 4);
  h.uk = reinterpret_cast<float*>(base + off); off += align128(size_t(WS) * 4);
  h.red = reinterpret_cast<float*>(base + off); off += align128(size_t(WS) * 4);
  h.g = reinterpret_cast<int*>(base + off);
  return h;
}

// Per row: the inverse norms uq = 1/|q|, uk = 1/|k| (rsqrt of the clamped sum of
// squares) and the score operands qs = bf16((q uq) scale), kl = bf16(k uk) for cosine
// attention (_cos_wide_preamble); q and k as they are for scaled-dot.
__device__ void prepare_head(const Head& hd, bool use_cos, float scale) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < WS; r += kWarps) {
    const int i = r * LD_HEAD + lane;
    if (!use_cos) {
      hd.qs[i] = hd.qr[i];
      hd.kl[i] = hd.kr[i];
      continue;
    }
    const float qv = bf(hd.qr[i]);
    const float kv = bf(hd.kr[i]);
    const float iq = rsqrtf(fmaxf(warp_sum(qv * qv), 1e-24f));
    const float ik = rsqrtf(fmaxf(warp_sum(kv * kv), 1e-24f));
    if (lane == 0) {
      hd.uq[r] = iq;
      hd.uk[r] = ik;
    }
    hd.qs[i] = to_bf((qv * iq) * scale);
    hd.kl[i] = to_bf(kv * ik);
  }
  __syncthreads();
}

// The backward of one head of one window, after prepare_head, for do (64 x HD bf16,
// leading dimension ldo).  Writes dq | dk | dv (bf16) into the window's dqkv rows
// (64 x 3C) at this head's columns, ds (f32, 64 x 64) into dbias_part and this head's
// sum_rows <ds k_hat, q_hat> into *dls_part (cosine; 0 for scaled-dot).
__device__ void head_backward(const Head& hd, const bf16* dob, int ldo, bool use_cos,
                              bool masked, const float* __restrict__ bias_h, float scale,
                              float sm_scale, bf16* dqkv_rows, int C, int head,
                              float* dbias_part, float* dls_part) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int C3 = 3 * C;

  mm_abt(hd.qs, LD_HEAD, hd.kl, LD_HEAD, hd.s);
  __syncthreads();
  softmax_rows(hd.s, hd.pl, hd.g, masked, bias_h, use_cos ? 1.f : sm_scale);
  __syncthreads();

  // dv = p^T do (bf16 p), staged in aq; dp = do v^T
  mm_pb<true>(hd.pl, dob, ldo, hd.aq);
  mm_abt(dob, ldo, hd.v, LD_HEAD, hd.dp);
  __syncthreads();

  for (int idx = tid; idx < WS * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    dqkv_rows[size_t(r) * C3 + 2 * C + head * HD + d] = to_bf(hd.aq[r * LD_T + d]);
  }
  // ds = p (dp - sum_j dp p) in f32 -> this window's dbias part; bf16 ds over p
  for (int r = warp; r < WS; r += kWarps) {
    const float p0 = hd.s[r * LD_S + lane], p1 = hd.s[r * LD_S + lane + 32];
    const float d0 = hd.dp[r * LD_S + lane], d1 = hd.dp[r * LD_S + lane + 32];
    const float t = warp_sum(d0 * p0 + d1 * p1);
    const float ds0 = p0 * (d0 - t), ds1 = p1 * (d1 - t);
    dbias_part[r * WS + lane] = ds0;
    dbias_part[r * WS + lane + 32] = ds1;
    hd.pl[r * LD_P + lane] = to_bf(ds0);
    hd.pl[r * LD_P + lane + 32] = to_bf(ds1);
  }
  __syncthreads();

  // aq = ds kl, bk = ds^T qs (one tile of each per warp)
  mm_pb<false>(hd.pl, hd.kl, LD_HEAD, hd.aq);
  mm_pb<true>(hd.pl, hd.qs, LD_HEAD, hd.bk);
  __syncthreads();

  // dq, dk: the tangent projection of the normalization for cosine attention
  // (dq = s uq (aq - q_hat <aq, q_hat>), dk = uk (bk - k_hat <bk, k_hat>)), the score
  // scale for scaled-dot; one warp per row, lane = channel
  float dls = 0.f;
  for (int r = warp; r < WS; r += kWarps) {
    const float a = hd.aq[r * LD_T + lane];
    const float b = hd.bk[r * LD_T + lane];
    float dq, dk;
    if (use_cos) {
      const float uq = hd.uq[r], uk = hd.uk[r];
      const float qh = bf(hd.qr[r * LD_HEAD + lane]) * uq;
      const float kh = bf(hd.kr[r * LD_HEAD + lane]) * uk;
      const float rdq = warp_sum(a * qh);
      const float rdk = warp_sum(b * kh);
      dls += rdq;
      dq = (a - qh * rdq) * (uq * scale);
      dk = (b - kh * rdk) * uk;
    } else {
      dq = a * sm_scale;
      dk = b * sm_scale;
    }
    dqkv_rows[size_t(r) * C3 + head * HD + lane] = to_bf(dq);
    dqkv_rows[size_t(r) * C3 + C + head * HD + lane] = to_bf(dk);
  }
  if (lane == 0) hd.red[warp] = dls;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += hd.red[w];
    *dls_part = s;
  }
  __syncthreads();
}

// the partial row of one window: [dbias (H x 64 x 64) | dls (H)] (+ K4's
// [dbqkv (3C) | dbp (C) | dgamma (C) | dbeta (C)])
__host__ __device__ inline size_t attn_part_width(int H) { return size_t(H) * (WS * WS + 1); }

// ---------------------------------------------------------------------------------
// K5: grid (T/64 windows, C/32 heads).
// ---------------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const bf16* __restrict__ qkv, const int* __restrict__ groups,
                const float* __restrict__ bias, const float* __restrict__ lscale,
                const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                float* __restrict__ part, int C, int use_cos, int has_mask, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Head hd = carve_head(smem);
  const int win = blockIdx.x;
  const int head = blockIdx.y;
  const int tid = threadIdx.x;
  const int H = C / HD;

  // q, k, v slices of this head and its do: 64 rows x 4 parts x 4 16-byte chunks
  for (int idx = tid; idx < WS * 16; idx += kThreads) {
    const int r = idx / 16, part_i = (idx % 16) >> 2, q4 = idx & 3;
    const size_t row = size_t(win) * WS + r;
    const bf16* src = part_i < 3 ? qkv + row * 3 * C + part_i * C + head * HD
                                 : dout + row * C + head * HD;
    bf16* dst = (part_i == 0 ? hd.qr : part_i == 1 ? hd.kr : part_i == 2 ? hd.v : hd.dob) +
                r * LD_HEAD;
    reinterpret_cast<uint4*>(dst)[q4] = reinterpret_cast<const uint4*>(src)[q4];
  }
  if (has_mask && tid < WS) hd.g[tid] = groups[size_t(win) * WS + tid];
  __syncthreads();

  const float scale = use_cos ? lscale[head] : 1.f;
  prepare_head(hd, use_cos != 0, scale);
  float* prow = part + size_t(win) * attn_part_width(H);
  head_backward(hd, hd.dob, LD_HEAD, use_cos != 0, has_mask != 0,
                bias + size_t(head) * WS * WS, scale, sm_scale, dqkv + size_t(win) * WS * 3 * C,
                C, head, prow + size_t(head) * WS * WS, prow + size_t(H) * WS * WS + head);
}

// ---------------------------------------------------------------------------------
// K4: one block per window.  Shared memory: region A (64 x (C+8) bf16: o, then the
// per-warp column sums, du, do) | region B (phase 1: x tile | one head's f32 qkv |
// the head's q_hat, k_hat, v, scores, p; then u / du and the do / dx staging in f32;
// phase 2: Head at its start) | group ids.
// ---------------------------------------------------------------------------------
struct EpiBwdLayout {
  size_t b, qkvf, head1, g, total;
};

__host__ __device__ inline EpiBwdLayout epi_bwd_layout(int C) {
  EpiBwdLayout L;
  const size_t ldx = size_t(C) + 8;
  const size_t a = align128(WS * ldx * 2);
  L.b = a;
  size_t p1 = align128(WS * ldx * 2);
  L.qkvf = L.b + p1;
  p1 += align128(size_t(WS) * LD_QKV * 4);
  L.head1 = L.b + p1;
  p1 += 3 * align128(size_t(WS) * LD_HEAD * 2) + align128(size_t(WS) * LD_S * 4) +
        align128(size_t(WS) * LD_P * 2);
  size_t bsz = p1 > head_bytes() ? p1 : head_bytes();
  const size_t usz = align128(size_t(WS) * (C + 4) * 4);
  bsz = bsz > usz ? bsz : usz;
  L.g = L.b + bsz;
  L.total = L.g + align128(WS * 4);
  return L;
}

__global__ void __launch_bounds__(kThreads)
qkv_epi_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                   const bf16* __restrict__ bqkv, const bf16* __restrict__ wp,
                   const bf16* __restrict__ bp, const float* __restrict__ ln_g,
                   const int* __restrict__ groups, const float* __restrict__ bias,
                   const float* __restrict__ lscale, const bf16* __restrict__ dz,
                   bf16* __restrict__ dx, bf16* qkv_s, bf16* __restrict__ o_s, bf16* dqkv_s,
                   bf16* __restrict__ du_s, float* __restrict__ part, int C, int has_ln,
                   int has_mask, float ln_eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const EpiBwdLayout L = epi_bwd_layout(C);
  const int LDX = C + 8;
  const int LDU = C + 4;
  bf16* as = reinterpret_cast<bf16*>(smem);      // region A as bf16
  float* af = reinterpret_cast<float*>(smem);    // region A as f32
  bf16* xs = reinterpret_cast<bf16*>(smem + L.b);
  float* bf32 = reinterpret_cast<float*>(smem + L.b);  // u, du, staging
  float* qkvf = reinterpret_cast<float*>(smem + L.qkvf);
  bf16* q1 = reinterpret_cast<bf16*>(smem + L.head1);
  bf16* k1 = q1 + WS * LD_HEAD;
  bf16* v1 = k1 + WS * LD_HEAD;
  float* s1 = reinterpret_cast<float*>(smem + L.head1 + 3 * align128(size_t(WS) * LD_HEAD * 2));
  bf16* p1 = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(s1) +
                                     align128(size_t(WS) * LD_S * 4));
  int* g = reinterpret_cast<int*>(smem + L.g);

  const int win = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int H = C / HD;
  const int C3 = 3 * C;
  const size_t row0 = size_t(win) * WS;
  const bool masked = has_mask != 0;
  float* prow = part + size_t(win) * (attn_part_width(H) + 6 * C);
  float* prow_vec = prow + attn_part_width(H);  // dbqkv | dbp | dgamma | dbeta

  // x tile, 16-byte chunks
  const int chunks = C / 8;
  for (int idx = tid; idx < WS * chunks; idx += kThreads) {
    const int r = idx / chunks, q = idx % chunks;
    reinterpret_cast<uint4*>(xs + r * LDX)[q] =
        reinterpret_cast<const uint4*>(x + (row0 + r) * C)[q];
  }
  if (masked && tid < WS) g[tid] = groups[row0 + tid];
  __syncthreads();

  // ---- phase 1: qkv (kept in the workspace), per-head softmax and o
  for (int head = 0; head < H; ++head) {
    project_head_qkv(xs, LDX, wqkv, C, head, qkvf);

    const float scale = lscale[head];
    {
      const float bq = bf(bqkv[head * HD + lane]);
      const float bk = bf(bqkv[C + head * HD + lane]);
      const float bv = bf(bqkv[2 * C + head * HD + lane]);
      for (int r = warp; r < WS; r += kWarps) {
        const float* row = qkvf + r * LD_QKV;
        const float qv = bfr(row[lane] + bq);
        const float kv = bfr(row[HD + lane] + bk);
        const float vv = bfr(row[2 * HD + lane] + bv);
        bf16* grow = qkv_s + (row0 + r) * C3 + head * HD + lane;
        grow[0] = to_bf(qv);
        grow[C] = to_bf(kv);
        grow[2 * C] = to_bf(vv);
        const float iq = rsqrtf(fmaxf(warp_sum(qv * qv), 1e-24f));
        const float ik = rsqrtf(fmaxf(warp_sum(kv * kv), 1e-24f));
        q1[r * LD_HEAD + lane] = to_bf((qv * iq) * scale);
        k1[r * LD_HEAD + lane] = to_bf(kv * ik);
        v1[r * LD_HEAD + lane] = to_bf(vv);
      }
    }
    __syncthreads();
    attend_head(q1, k1, v1, s1, p1, g, masked, bias + size_t(head) * WS * WS, 1.f);
    for (int idx = tid; idx < WS * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      as[r * LDX + head * HD + d] = to_bf(s1[r * LD_T + d]);
    }
    __syncthreads();
  }
  for (int idx = tid; idx < WS * chunks; idx += kThreads) {
    const int r = idx / chunks, q = idx % chunks;
    reinterpret_cast<uint4*>(o_s + (row0 + r) * C)[q] =
        reinterpret_cast<const uint4*>(as + r * LDX)[q];
  }

  // ---- u = o Wp (f32) over region B (x and qkv are no longer needed)
  const int ntiles = 4 * (C / 16);
  for (int t = warp; t < ntiles; t += kWarps) {
    const int rt = t & 3, ct = t >> 2;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < C; kk += 16) {
      FragA a;
      FragB b;
      wmma::load_matrix_sync(a, as + rt * 16 * LDX + kk, LDX);
      wmma::load_matrix_sync(b, wp + size_t(kk) * C + ct * 16, C);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(bf32 + rt * 16 * LDU + ct * 16, acc, LDU, wmma::mem_row_major);
  }
  __syncthreads();

  // ---- LayerNorm backward, one warp per row: du (f32) in place of u; per-lane column
  // sums of du (dbp), dz * xhat (dgamma) and dz (dbeta)
  {
    const int nj = C / 32;
    float acc_p[MAXJ], acc_g[MAXJ], acc_b[MAXJ];
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc_p[j] = acc_g[j] = acc_b[j] = 0.f;
    for (int r = warp; r < WS; r += kWarps) {
      float* urow = bf32 + r * LDU;
      const bf16* dzrow = dz + (row0 + r) * C;
      float uv[MAXJ], dzv[MAXJ];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        if (j < nj) {
          const int c = lane + 32 * j;
          uv[j] = urow[c] + bf(bp[c]);
          dzv[j] = bf(dzrow[c]);
          sum += uv[j];
        }
      }
      if (has_ln) {
        const float mean = warp_sum(sum) / C;
        float sq = 0.f;
#pragma unroll
        for (int j = 0; j < MAXJ; ++j)
          if (j < nj) {
            const float d = uv[j] - mean;
            sq += d * d;
          }
        const float rstd = rsqrtf(warp_sum(sq) / C + ln_eps);
        float s1v = 0.f, s2v = 0.f;
#pragma unroll
        for (int j = 0; j < MAXJ; ++j)
          if (j < nj) {
            const int c = lane + 32 * j;
            const float xh = (uv[j] - mean) * rstd;
            uv[j] = xh;
            acc_g[j] += dzv[j] * xh;
            acc_b[j] += dzv[j];
            const float dgl = dzv[j] * ln_g[c];
            s1v += dgl;
            s2v += dgl * xh;
          }
        const float m1 = warp_sum(s1v) / C;
        const float m2 = warp_sum(s2v) / C;
#pragma unroll
        for (int j = 0; j < MAXJ; ++j)
          if (j < nj) {
            const int c = lane + 32 * j;
            const float du = rstd * (dzv[j] * ln_g[c] - m1 - uv[j] * m2);
            urow[c] = du;
            acc_p[j] += du;
          }
      } else {
#pragma unroll
        for (int j = 0; j < MAXJ; ++j)
          if (j < nj) {
            urow[lane + 32 * j] = dzv[j];
            acc_p[j] += dzv[j];
          }
      }
    }
    // per-warp sums into region A (o is in the workspace now), then across warps
    float* wsum = af + warp * C3;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j)
      if (j < nj) {
        const int c = lane + 32 * j;
        wsum[c] = acc_p[j];
        wsum[C + c] = acc_g[j];
        wsum[2 * C + c] = acc_b[j];
      }
  }
  __syncthreads();
  for (int c = tid; c < C3; c += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += af[w * C3 + c];
    prow_vec[C3 + c] = s;  // dbp | dgamma | dbeta
  }
  __syncthreads();

  // ---- du (bf16) into region A and the workspace; do = du Wp^T (f32 over u)
  for (int idx = tid; idx < WS * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    const bf16 v = to_bf(bf32[r * LDU + c]);
    as[r * LDX + c] = v;
    du_s[(row0 + r) * C + c] = v;
  }
  __syncthreads();
  for (int t = warp; t < ntiles; t += kWarps) {
    const int rt = t & 3, ct = t >> 2;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < C; kk += 16) {
      FragA a;
      FragBt b;  // element (k, n) of Wp^T at wp[n * C + k]
      wmma::load_matrix_sync(a, as + rt * 16 * LDX + kk, LDX);
      wmma::load_matrix_sync(b, wp + size_t(ct) * 16 * C + kk, C);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(bf32 + rt * 16 * LDU + ct * 16, acc, LDU, wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = tid; idx < WS * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    as[r * LDX + c] = to_bf(bf32[r * LDU + c]);  // do (bf16)
  }
  __syncthreads();

  // ---- phase 2: per head, the attention backward from the qkv rows of phase 1
  Head hd = carve_head(smem + L.b);
  hd.g = g;
  for (int head = 0; head < H; ++head) {
    for (int idx = tid; idx < WS * 12; idx += kThreads) {
      const int r = idx / 12, part_i = (idx % 12) >> 2, q4 = idx & 3;
      const bf16* src = qkv_s + (row0 + r) * C3 + part_i * C + head * HD;
      bf16* dst = (part_i == 0 ? hd.qr : part_i == 1 ? hd.kr : hd.v) + r * LD_HEAD;
      reinterpret_cast<uint4*>(dst)[q4] = reinterpret_cast<const uint4*>(src)[q4];
    }
    __syncthreads();
    const float scale = lscale[head];
    prepare_head(hd, true, scale);
    head_backward(hd, as + head * HD, LDX, true, masked, bias + size_t(head) * WS * WS, scale,
                  0.f, dqkv_s + row0 * C3, C, head, prow + size_t(head) * WS * WS,
                  prow + size_t(H) * WS * WS + head);
  }

  // ---- dbqkv (column sums of the bf16 dqkv) and dx = dqkv Wqkv^T
  for (int c = tid; c < C3; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < WS; ++r) s += bf(dqkv_s[(row0 + r) * C3 + c]);
    prow_vec[c] = s;
  }
  for (int t = warp; t < ntiles; t += kWarps) {
    const int rt = t & 3, ct = t >> 2;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < C3; kk += 16) {
      FragA a;
      FragBt b;  // element (k, n) of Wqkv^T at wqkv[n * 3C + k]
      wmma::load_matrix_sync(a, dqkv_s + (row0 + rt * 16) * C3 + kk, C3);
      wmma::load_matrix_sync(b, wqkv + size_t(ct) * 16 * C3 + kk, C3);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(bf32 + rt * 16 * LDU + ct * 16, acc, LDU, wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = tid; idx < WS * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    dx[(row0 + r) * C + c] = to_bf(bf32[r * LDU + c]);
  }
}

// the workspace of K4: qkv, o, dqkv, du (bf16 rows), the per-window partial rows, and
// the reductions' scratch
struct EpiBwdWork {
  size_t qkv, o, dqkv, du, part, tmp, total;
};

inline EpiBwdWork epi_bwd_work(int T, int C) {
  EpiBwdWork w;
  const int nw = T / WS;
  const int W = int(attn_part_width(C / HD)) + 6 * C;
  size_t off = 0;
  w.qkv = off; off += align128(size_t(T) * 3 * C * 2);
  w.o = off; off += align128(size_t(T) * C * 2);
  w.dqkv = off; off += align128(size_t(T) * 3 * C * 2);
  w.du = off; off += align128(size_t(T) * C * 2);
  w.part = off; off += align128(size_t(nw) * W * 4);
  size_t tmp = reduce_rows_tmp_floats(nw, W);
  const size_t g1 = gemm_tn_tmp_floats(T, C, 3 * C);
  const size_t g2 = gemm_tn_tmp_floats(T, C, C);
  tmp = tmp > g1 ? tmp : g1;
  tmp = tmp > g2 ? tmp : g2;
  w.tmp = off; off += align128(tmp * 4);
  w.total = off;
  return w;
}

}  // namespace
}  // namespace hs

extern "C" {

size_t hs_window_attention_bwd_workspace(int T, int C) {
  const int nw = T / hs::WS;
  const int W = int(hs::attn_part_width(C / hs::HD));
  return hs::align128(size_t(nw) * W * 4) + hs::align128(hs::reduce_rows_tmp_floats(nw, W) * 4);
}

int hs_window_attention_bwd(const void* qkv, const void* groups, const void* bias,
                            const void* lscale, const void* dout, void* dqkv, void* red,
                            void* work, int T, int C, int use_cos, int has_mask,
                            float sm_scale, void* stream) {
  using hs::bf16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = hs::head_bytes();
  cudaError_t e = cudaFuncSetAttribute(hs::attn_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const int nw = T / hs::WS;
  const int W = int(hs::attn_part_width(C / hs::HD));
  float* part = static_cast<float*>(work);
  float* tmp = reinterpret_cast<float*>(static_cast<unsigned char*>(work) +
                                        hs::align128(size_t(nw) * W * 4));
  hs::attn_bwd_kernel<<<dim3(nw, C / hs::HD), hs::kThreads, smem, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const int*>(groups),
      static_cast<const float*>(bias), static_cast<const float*>(lscale),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv), part, C, use_cos, has_mask,
      sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  return int(hs::reduce_rows(part, static_cast<float*>(red), nw, W, tmp, s));
}

size_t hs_window_attention_qkv_epi_bwd_workspace(int T, int C) {
  return hs::epi_bwd_work(T, C).total;
}

int hs_window_attention_qkv_epi_bwd(const void* x, const void* wqkv, const void* bqkv,
                                    const void* wp, const void* bp, const void* ln_g,
                                    const void* ln_b, const void* groups, const void* bias,
                                    const void* lscale, const void* dz, void* dx, void* dwqkv,
                                    void* dwp, void* red, void* work, int T, int C,
                                    int has_ln, int has_mask, float ln_eps, void* stream) {
  using hs::bf16;
  (void)ln_b;  // beta does not enter the backward
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = hs::epi_bwd_layout(C).total;
  cudaError_t e = cudaFuncSetAttribute(hs::qkv_epi_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const hs::EpiBwdWork w = hs::epi_bwd_work(T, C);
  unsigned char* base = static_cast<unsigned char*>(work);
  bf16* qkv_s = reinterpret_cast<bf16*>(base + w.qkv);
  bf16* o_s = reinterpret_cast<bf16*>(base + w.o);
  bf16* dqkv_s = reinterpret_cast<bf16*>(base + w.dqkv);
  bf16* du_s = reinterpret_cast<bf16*>(base + w.du);
  float* part = reinterpret_cast<float*>(base + w.part);
  float* tmp = reinterpret_cast<float*>(base + w.tmp);
  const int nw = T / hs::WS;
  hs::qkv_epi_bwd_kernel<<<nw, hs::kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const bf16*>(wp),
      static_cast<const bf16*>(bp), static_cast<const float*>(ln_g),
      static_cast<const int*>(groups), static_cast<const float*>(bias),
      static_cast<const float*>(lscale), static_cast<const bf16*>(dz),
      static_cast<bf16*>(dx), qkv_s, o_s, dqkv_s, du_s, part, C, has_ln, has_mask, ln_eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  const int W = int(hs::attn_part_width(C / hs::HD)) + 6 * C;
  e = hs::reduce_rows(part, static_cast<float*>(red), nw, W, tmp, s);
  if (e != cudaSuccess) return int(e);
  e = hs::gemm_tn(static_cast<const bf16*>(x), dqkv_s, static_cast<float*>(dwqkv), T, C,
                  3 * C, tmp, s);
  if (e != cudaSuccess) return int(e);
  return int(hs::gemm_tn(o_s, du_s, static_cast<float*>(dwp), T, C, C, tmp, s));
}

}  // extern "C"
