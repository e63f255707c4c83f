// The SWIN block MLP and the SWIN-v2 MLP branch of HEAL-SWIN for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of heal_swin_tpu/ops/mlp.py:
//   K12 hs_mlp_fwd        <- _fwd_kernel (fused_mlp, fwd_impl="pallas"):
//       (T, C) -> h = x W1 + b1 -> g = GELU(h) -> g W2 + b2 -> (T, C)
//   K13 hs_mlp_bwd        <- _bwd_kernel (the backward of fused_mlp / fused_mlp_nd):
//       recompute h and g; dh = (dout W2^T) GELU'(h); dx = dh W1^T; dW1, db1, dW2, db2
//   K14 hs_mlp_block_fwd  <- _blk_fwd_kernel (fused_mlp_block):
//       x + dscale * LN(fc2(GELU(fc1 x))), the v2 block's MLP branch with its residual
//   K15 hs_mlp_block_bwd  <- _blk_bwd_kernel: recompute the branch; the LayerNorm
//       backward du; then as K13 with du for dout; dx adds the residual dz;
//       dgamma, dbeta
// with the Pallas kernels' rounding points: h and u summed in f32 with the biases in
// f32; g rounded to bf16; LN statistics in f32 on the unrounded u; the output rounded
// once after the residual add; dh rounded before dx and dW1 while db1 sums the
// unrounded dh; du rounded before dW2 and the hidden's gradient.  Both GELUs (tanh and
// erf) in f32.
//
// What bounds it on this card: the forward does 4 T C H = 16 T C^2 FLOP on 4 T C bytes
// of tokens, H = 4C FLOP per byte (384 at C = 96), above the bf16 ridge (~295): the
// products decide, and the (T, H) hidden that the unfused route writes and reads back
// (f32 h, bf16 g: 6 T H bytes forward, more backward) is what fusion saves.
//
// What the design does about it:
// - One block per row block of 64 tokens (32 above C = 384) keeps its x tile in shared
//   memory and walks the hidden in chunks of 32 columns: each step stages the W1
//   column chunk (C x 32) and the W2 row chunk (32 x C) through shared memory (W1 and
//   W2 are 147 KB at C = 96, 2.36 MB at C = 384, 9.4 MB at C = 768 in bf16: they do
//   not fit whole), computes the chunk's h on the tensor cores, applies GELU, and adds
//   g W2 into the block's (rows x C) f32 sum, which stays in WMMA accumulators in
//   registers (at most 12 16x16 tiles a warp: the row block halves above C = 384).
//   After the last chunk the sum goes to shared memory for the bias, the LayerNorm
//   (K14/K15, one warp per row) and the residual.
// - Parameter gradients without float atomics, in a fixed order (the results do not
//   change from run to run): the backward kernels write g and the rounded dh (and in
//   K15 the rounded du) as bf16 rows into a workspace, and dW1 = x^T dh, dW2 = g^T dout
//   (K15: g^T du) are split-K products over the tokens (reduce.cu gemm_tn); the bias,
//   gamma and beta gradients are one partial row per block, summed by reduce_rows.
//   That costs 4 T H bytes written and read again (201 MB each way at T = 262144,
//   C = 96), which the TPU kernel kept in VMEM.
// - 16x16x16 bf16 WMMA tiles with f32 accumulation, one staging buffer and block-wide
//   barriers: right and simple first; cp.async / TMA pipelines and wgmma are later work.

#include "common.cuh"

namespace hs {
namespace {

constexpr int HC = 32;        // hidden columns per streamed chunk (one lane each)
constexpr int LDH = HC + 8;   // leading dimension of the bf16 chunk tiles (W1 chunk, g / dh)
constexpr int LDHF = HC + 4;  // leading dimension of the f32 chunk tiles (h, dh's dg)
constexpr int MAX_NT = 12;    // 16x16 output tiles a warp holds at most
constexpr int MAX_C = 768;
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kTanhC = 0.044715f;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// token rows per block: the (rows x C) f32 sum lives in registers, C / 16 floats a
// thread at 64 rows, so the row block halves above C = 384
__host__ __device__ inline int mlp_rows(int C) { return C <= 384 ? 64 : 32; }

__device__ __forceinline__ float gelu(float h, bool approx) {
  if (approx) {
    const float u = kSqrt2OverPi * (h + kTanhC * h * h * h);
    return 0.5f * h * (1.f + tanhf(u));
  }
  return 0.5f * h * (1.f + erff(h * kInvSqrt2));
}

__device__ __forceinline__ float gelu_grad(float h, bool approx) {
  if (approx) {
    const float u = kSqrt2OverPi * (h + kTanhC * h * h * h);
    const float t = tanhf(u);
    const float du = kSqrt2OverPi * (1.f + 3.f * kTanhC * h * h);
    return 0.5f * (1.f + t) + 0.5f * h * (1.f - t * t) * du;
  }
  const float cdf = 0.5f * (1.f + erff(h * kInvSqrt2));
  const float pdf = kInvSqrt2Pi * expf(-0.5f * h * h);
  return cdf + h * pdf;
}

// Shared memory: x tile | (backward) dout or du tile | the chunk tiles (W1 chunk, W2
// chunk, f32 h, f32 dg, bf16 g or dh), which the (rows x C) f32 sums U reuse once the
// last chunk is in | per-warp column sums | per-row LayerNorm values.
struct Layout {
  size_t xs, ds, w1s, w2s, hf, dgf, gs, u, red, rows, total;
};

__host__ __device__ inline Layout layout(int C, bool bwd) {
  const size_t R = mlp_rows(C);
  const size_t ldx = size_t(C) + 8;
  Layout L;
  size_t off = 0;
  L.xs = off; off += align128(R * ldx * 2);
  L.ds = off; if (bwd) off += align128(R * ldx * 2);
  const size_t base = off;
  L.w1s = off; off += align128(size_t(C) * LDH * 2);
  L.w2s = off; off += align128(size_t(HC) * ldx * 2);
  L.hf = off; off += align128(R * LDHF * 4);
  L.dgf = off; if (bwd) off += align128(R * LDHF * 4);
  L.gs = off; off += align128(R * LDH * 2);
  L.u = base;
  const size_t uend = base + align128(R * (size_t(C) + 4) * 4);
  off = off > uend ? off : uend;
  L.red = off; off += align128(size_t(kWarps) * HC * 4);
  L.rows = off; off += align128(5 * R * 4);
  L.total = off;
  return L;
}

// This block's geometry and this warp's output tiles: warp w owns row tile w % RT and
// column tiles ct0 + wpr * i, i < nt, of the (rows x C) sums.
struct Geo {
  int R, RT, wpr, nt, rt, ct0, LDX, LDU;
  __device__ explicit Geo(int C) {
    R = mlp_rows(C);
    RT = R / 16;
    wpr = kWarps / RT;
    nt = (C / 16) / wpr;
    const int warp = threadIdx.x >> 5;
    rt = warp % RT;
    ct0 = warp / RT;
    LDX = C + 8;
    LDU = C + 4;
  }
};

// rows x C bf16 (row stride C) -> shared memory (leading dimension ld), 16-byte chunks
__device__ inline void load_rows(const bf16* __restrict__ src, bf16* dst, int rows, int C,
                                 int ld) {
  const int chunks = C / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks, q = idx % chunks;
    reinterpret_cast<uint4*>(dst + r * ld)[q] =
        reinterpret_cast<const uint4*>(src + size_t(r) * C)[q];
  }
}

// W1[:, j0:j0+HC] -> w1s (C x HC, ld LDH); W2[j0:j0+HC, :] -> w2s (HC x C, ld ldx)
__device__ inline void stage_chunk(const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                                   int C, int H, int j0, bf16* w1s, bf16* w2s, int ldx) {
  for (int idx = threadIdx.x; idx < C * (HC / 8); idx += kThreads) {
    const int c = idx / (HC / 8), q = idx % (HC / 8);
    reinterpret_cast<uint4*>(w1s + c * LDH)[q] =
        reinterpret_cast<const uint4*>(w1 + size_t(c) * H + j0)[q];
  }
  load_rows(w2 + size_t(j0) * C, w2s, HC, C, ldx);
}

// One 16x16 tile (rt, ct) of a chunk product (rows x HC, f32, ld LDHF) over K = C:
// A (ld lda) times w1s (kBt false: row-major, ld LDH) or times w2s^T (kBt true: element
// (k, n) at w2s[n * ldb + k]).
template <bool kBt>
__device__ __forceinline__ void chunk_tile(const bf16* A, int lda, const bf16* B, int ldb,
                                           int K, float* out, int rt, int ct) {
  FragC acc;
  wmma::fill_fragment(acc, 0.f);
  for (int kk = 0; kk < K; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, A + rt * 16 * lda + kk, lda);
    if constexpr (kBt) {
      FragBt b;
      wmma::load_matrix_sync(b, B + ct * 16 * ldb + kk, ldb);
      wmma::mma_sync(acc, a, b, acc);
    } else {
      FragB b;
      wmma::load_matrix_sync(b, B + kk * ldb + ct * 16, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
  }
  wmma::store_matrix_sync(out + rt * 16 * LDHF + ct * 16, acc, LDHF, wmma::mem_row_major);
}

// acc += A (rows x HC bf16, ld LDH) times w2s (kBt false: HC x C row-major, ld ldb) or
// times w1s^T (kBt true: element (k, n) at w1s[n * ldb + k]), over this warp's tiles
template <bool kBt>
__device__ __forceinline__ void accumulate(FragC (&acc)[MAX_NT], const Geo& g, const bf16* A,
                                           const bf16* B, int ldb) {
#pragma unroll
  for (int kk = 0; kk < HC; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, A + g.rt * 16 * LDH + kk, LDH);
#pragma unroll
    for (int i = 0; i < MAX_NT; ++i) {
      if (i < g.nt) {
        const int ct = g.ct0 + g.wpr * i;
        if constexpr (kBt) {
          FragBt b;
          wmma::load_matrix_sync(b, B + ct * 16 * ldb + kk, ldb);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        } else {
          FragB b;
          wmma::load_matrix_sync(b, B + kk * ldb + ct * 16, ldb);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
    }
  }
}

__device__ __forceinline__ void store_acc(const FragC (&acc)[MAX_NT], const Geo& g, float* U) {
#pragma unroll
  for (int i = 0; i < MAX_NT; ++i)
    if (i < g.nt)
      wmma::store_matrix_sync(U + g.rt * 16 * g.LDU + (g.ct0 + g.wpr * i) * 16, acc[i], g.LDU,
                              wmma::mem_row_major);
}

struct Smem {
  bf16 *xs, *ds, *w1s, *w2s, *gs;
  float *hf, *dgf, *u, *red, *rows;
};

__device__ inline Smem carve(unsigned char* smem, const Layout& L) {
  Smem s;
  s.xs = reinterpret_cast<bf16*>(smem + L.xs);
  s.ds = reinterpret_cast<bf16*>(smem + L.ds);
  s.w1s = reinterpret_cast<bf16*>(smem + L.w1s);
  s.w2s = reinterpret_cast<bf16*>(smem + L.w2s);
  s.gs = reinterpret_cast<bf16*>(smem + L.gs);
  s.hf = reinterpret_cast<float*>(smem + L.hf);
  s.dgf = reinterpret_cast<float*>(smem + L.dgf);
  s.u = reinterpret_cast<float*>(smem + L.u);
  s.red = reinterpret_cast<float*>(smem + L.red);
  s.rows = reinterpret_cast<float*>(smem + L.rows);
  return s;
}

// The forward's hidden walk: the x tile in s.xs -> this warp's tiles of g W2 (without
// b2) in acc; ends with the chunk region free for U.
__device__ __forceinline__ void forward_sums(FragC (&acc)[MAX_NT], const Geo& g,
                                             const Smem& s, const bf16* __restrict__ w1,
                                             const float* __restrict__ b1,
                                             const bf16* __restrict__ w2, int C, int H,
                                             bool approx) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < MAX_NT; ++i) wmma::fill_fragment(acc[i], 0.f);
  for (int j0 = 0; j0 < H; j0 += HC) {
    __syncthreads();  // the previous chunk's tiles are consumed (and the x tile is in)
    stage_chunk(w1, w2, C, H, j0, s.w1s, s.w2s, g.LDX);
    __syncthreads();
    if (warp < 2 * g.RT) chunk_tile<false>(s.xs, g.LDX, s.w1s, LDH, C, s.hf, warp % g.RT,
                                           warp / g.RT);
    __syncthreads();
    const float bias = b1[j0 + lane];
    for (int r = warp; r < g.R; r += kWarps)
      s.gs[r * LDH + lane] = to_bf(gelu(s.hf[r * LDHF + lane] + bias, approx));
    __syncthreads();
    accumulate<false>(acc, g, s.gs, s.w2s, g.LDX);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------------
// K12 (kBlock false) and K14 (kBlock true): grid T / rows.
// ---------------------------------------------------------------------------------
template <bool kBlock>
__global__ void __launch_bounds__(kThreads)
mlp_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ gamma,
               const float* __restrict__ beta, const float* __restrict__ dscale,
               bf16* __restrict__ out, int C, int H, int approx, float ln_eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geo g(C);
  const Smem s = carve(smem, layout(C, false));
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row0 = size_t(blockIdx.x) * g.R;

  load_rows(x + row0 * C, s.xs, g.R, C, g.LDX);
  FragC acc[MAX_NT];
  forward_sums(acc, g, s, w1, b1, w2, C, H, approx != 0);
  store_acc(acc, g, s.u);
  __syncthreads();

  if constexpr (!kBlock) {
    for (int idx = tid; idx < g.R * C; idx += kThreads) {
      const int r = idx / C, c = idx % C;
      out[(row0 + r) * C + c] = to_bf(s.u[r * g.LDU + c] + b2[c]);
    }
  } else {
    // one warp per row: u = sums + b2, LN statistics in f32, y * dscale + x
    for (int r = warp; r < g.R; r += kWarps) {
      float* ur = s.u + r * g.LDU;
      float sum = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float v = ur[c] + b2[c];
        ur[c] = v;
        sum += v;
      }
      const float mean = warp_sum(sum) / C;
      float sq = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = ur[c] - mean;
        sq += d * d;
      }
      const float rstd = rsqrtf(warp_sum(sq) / C + ln_eps);
      const float dsc = dscale != nullptr ? dscale[row0 + r] : 1.f;
      for (int c = lane; c < C; c += 32) {
        float y = (ur[c] - mean) * rstd * gamma[c] + beta[c];
        if (dscale != nullptr) y *= dsc;
        out[(row0 + r) * C + c] = to_bf(bf(s.xs[r * g.LDX + c]) + y);
      }
    }
  }
}

// ---------------------------------------------------------------------------------
// K13 (kBlock false: go = dout) and K15 (kBlock true: go = dz): grid T / rows.  Writes
// dx, the workspace rows G = g and DH = rounded dh (bf16, T x H), for K15 DU = rounded
// du (T x C), and one partial row per block: db1 (H) | db2 (C) [| dgamma | dbeta].
// ---------------------------------------------------------------------------------
template <bool kBlock>
__global__ void __launch_bounds__(kThreads)
mlp_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ gamma,
               const float* __restrict__ dscale, const bf16* __restrict__ go,
               bf16* __restrict__ dx, bf16* __restrict__ G, bf16* __restrict__ DH,
               bf16* __restrict__ DU, float* __restrict__ part, int C, int H, int approx,
               float ln_eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Geo g(C);
  const Smem s = carve(smem, layout(C, true));
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool ap = approx != 0;
  const size_t row0 = size_t(blockIdx.x) * g.R;
  float* prow = part + size_t(blockIdx.x) * (H + (kBlock ? 3 : 1) * C);

  load_rows(x + row0 * C, s.xs, g.R, C, g.LDX);
  if constexpr (!kBlock) {
    // the gradient of the hidden's output is dout itself; db2 sums it in f32
    load_rows(go + row0 * C, s.ds, g.R, C, g.LDX);
    __syncthreads();
    for (int c = tid; c < C; c += kThreads) {
      float sum = 0.f;
      for (int r = 0; r < g.R; ++r) sum += bf(s.ds[r * g.LDX + c]);
      prow[H + c] = sum;
    }
  } else {
    // recompute u, then the LayerNorm backward: du (rounded) into s.ds and DU
    {
      FragC acc[MAX_NT];
      forward_sums(acc, g, s, w1, b1, w2, C, H, ap);
      store_acc(acc, g, s.u);
    }
    __syncthreads();
    float* mean_r = s.rows;
    float* rstd_r = s.rows + g.R;
    float* m1_r = s.rows + 2 * g.R;
    float* m2_r = s.rows + 3 * g.R;
    float* ds_r = s.rows + 4 * g.R;
    for (int r = warp; r < g.R; r += kWarps) {
      const size_t row = row0 + r;
      float* ur = s.u + r * g.LDU;
      float sum = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float v = ur[c] + b2[c];
        ur[c] = v;
        sum += v;
      }
      const float mean = warp_sum(sum) / C;
      float sq = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float d = ur[c] - mean;
        sq += d * d;
      }
      const float rstd = rsqrtf(warp_sum(sq) / C + ln_eps);
      const float dsc = dscale != nullptr ? dscale[row] : 1.f;
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const float xh = (ur[c] - mean) * rstd;
        float dy = bf(go[row * C + c]);
        if (dscale != nullptr) dy *= dsc;
        const float dgl = dy * gamma[c];
        s1 += dgl;
        s2 += dgl * xh;
      }
      const float m1 = warp_sum(s1) / C;
      const float m2 = warp_sum(s2) / C;
      if (lane == 0) {
        mean_r[r] = mean;
        rstd_r[r] = rstd;
        m1_r[r] = m1;
        m2_r[r] = m2;
        ds_r[r] = dsc;
      }
    }
    __syncthreads();
    // one thread per column: du, and the column sums db2 (unrounded du), dgamma, dbeta
    for (int c = tid; c < C; c += kThreads) {
      const float gm = gamma[c];
      float sdu = 0.f, sg = 0.f, sb = 0.f;
      for (int r = 0; r < g.R; ++r) {
        const float xh = (s.u[r * g.LDU + c] - mean_r[r]) * rstd_r[r];
        float dy = bf(go[(row0 + r) * C + c]);
        if (dscale != nullptr) dy *= ds_r[r];
        sg += dy * xh;
        sb += dy;
        const float du = rstd_r[r] * (dy * gm - m1_r[r] - xh * m2_r[r]);
        sdu += du;
        const bf16 dul = to_bf(du);
        s.ds[r * g.LDX + c] = dul;
        DU[(row0 + r) * C + c] = dul;
      }
      prow[H + c] = sdu;
      prow[H + C + c] = sg;
      prow[H + 2 * C + c] = sb;
    }
  }

  // the hidden's backward, chunk by chunk: h = x W1 + b1 and dg = s.ds W2^T, then g
  // and dh (lane = hidden column, one warp per row), db1, and dx += dh_lo W1^T
  FragC acc[MAX_NT];
#pragma unroll
  for (int i = 0; i < MAX_NT; ++i) wmma::fill_fragment(acc[i], 0.f);
  for (int j0 = 0; j0 < H; j0 += HC) {
    __syncthreads();
    stage_chunk(w1, w2, C, H, j0, s.w1s, s.w2s, g.LDX);
    __syncthreads();
    for (int t = warp; t < 4 * g.RT; t += kWarps) {
      const int tt = t % (2 * g.RT);
      if (t < 2 * g.RT)
        chunk_tile<false>(s.xs, g.LDX, s.w1s, LDH, C, s.hf, tt % g.RT, tt / g.RT);
      else
        chunk_tile<true>(s.ds, g.LDX, s.w2s, g.LDX, C, s.dgf, tt % g.RT, tt / g.RT);
    }
    __syncthreads();
    const float bias = b1[j0 + lane];
    float colsum = 0.f;
    for (int r = warp; r < g.R; r += kWarps) {
      const size_t at = (row0 + r) * H + j0 + lane;
      const float h = s.hf[r * LDHF + lane] + bias;
      G[at] = to_bf(gelu(h, ap));
      const float dh = s.dgf[r * LDHF + lane] * gelu_grad(h, ap);
      colsum += dh;
      const bf16 dhl = to_bf(dh);
      s.gs[r * LDH + lane] = dhl;
      DH[at] = dhl;
    }
    s.red[warp * HC + lane] = colsum;
    __syncthreads();
    if (warp == 0) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += s.red[w * HC + lane];
      prow[j0 + lane] = sum;
    }
    accumulate<true>(acc, g, s.gs, s.w1s, LDH);
  }
  __syncthreads();
  store_acc(acc, g, s.u);
  __syncthreads();
  for (int idx = tid; idx < g.R * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    const size_t at = (row0 + r) * C + c;
    float v = s.u[r * g.LDU + c];
    if constexpr (kBlock) v += bf(go[at]);
    dx[at] = to_bf(v);
  }
}

// The backward's workspace: G and DH (bf16, T x H), DU (K15, bf16, T x C), the
// per-block partial rows, and the reductions' scratch.
struct BwdWork {
  size_t g, dh, du, part, tmp, total;
};

inline BwdWork bwd_work(int T, int C, int H, bool block) {
  const int nb = T / mlp_rows(C);
  const int W = H + (block ? 3 : 1) * C;
  BwdWork w;
  size_t off = 0;
  w.g = off; off += align128(size_t(T) * H * 2);
  w.dh = off; off += align128(size_t(T) * H * 2);
  w.du = off; if (block) off += align128(size_t(T) * C * 2);
  w.part = off; off += align128(size_t(nb) * W * 4);
  size_t tmp = reduce_rows_tmp_floats(nb, W);
  const size_t g1 = gemm_tn_tmp_floats(T, C, H);
  const size_t g2 = gemm_tn_tmp_floats(T, H, C);
  tmp = tmp > g1 ? tmp : g1;
  tmp = tmp > g2 ? tmp : g2;
  w.tmp = off; off += align128(tmp * 4);
  w.total = off;
  return w;
}

template <bool kBlock>
cudaError_t launch_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* gamma, const void* beta,
                       const void* dscale, void* out, int T, int C, int H, int approx,
                       float ln_eps, cudaStream_t s) {
  if (C > MAX_C) return cudaErrorInvalidValue;
  const size_t smem = layout(C, false).total;
  cudaError_t e = cudaFuncSetAttribute(mlp_fwd_kernel<kBlock>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  mlp_fwd_kernel<kBlock><<<T / mlp_rows(C), kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(dscale), static_cast<bf16*>(out), C, H, approx, ln_eps);
  return cudaGetLastError();
}

template <bool kBlock>
cudaError_t launch_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* gamma, const void* dscale, const void* go,
                       void* dx, void* dw1, void* dw2, void* red, void* work, int T, int C,
                       int H, int approx, float ln_eps, cudaStream_t s) {
  if (C > MAX_C) return cudaErrorInvalidValue;
  const size_t smem = layout(C, true).total;
  cudaError_t e = cudaFuncSetAttribute(mlp_bwd_kernel<kBlock>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const BwdWork w = bwd_work(T, C, H, kBlock);
  unsigned char* base = static_cast<unsigned char*>(work);
  bf16* G = reinterpret_cast<bf16*>(base + w.g);
  bf16* DH = reinterpret_cast<bf16*>(base + w.dh);
  bf16* DU = kBlock ? reinterpret_cast<bf16*>(base + w.du) : nullptr;
  float* part = reinterpret_cast<float*>(base + w.part);
  float* tmp = reinterpret_cast<float*>(base + w.tmp);
  const int nb = T / mlp_rows(C);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gob = static_cast<const bf16*>(go);
  mlp_bwd_kernel<kBlock><<<nb, kThreads, smem, s>>>(
      xb, static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(gamma), static_cast<const float*>(dscale), gob,
      static_cast<bf16*>(dx), G, DH, DU, part, C, H, approx, ln_eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = reduce_rows(part, static_cast<float*>(red), nb, H + (kBlock ? 3 : 1) * C, tmp, s);
  if (e != cudaSuccess) return e;
  // dW1 = x^T dh (C x H); dW2 = g^T dout, or g^T du for the branch (H x C)
  e = gemm_tn(xb, DH, static_cast<float*>(dw1), T, C, H, tmp, s);
  if (e != cudaSuccess) return e;
  return gemm_tn(G, kBlock ? DU : gob, static_cast<float*>(dw2), T, H, C, tmp, s);
}

}  // namespace
}  // namespace hs

extern "C" {

int hs_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               void* out, int T, int C, int H, int approx, void* stream) {
  return int(hs::launch_fwd<false>(x, w1, b1, w2, b2, nullptr, nullptr, nullptr, out, T, C, H,
                                   approx, 0.f, static_cast<cudaStream_t>(stream)));
}

int hs_mlp_block_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* gamma, const void* beta, const void* dscale,
                     void* out, int T, int C, int H, int approx, int has_dp, float ln_eps,
                     void* stream) {
  return int(hs::launch_fwd<true>(x, w1, b1, w2, b2, gamma, beta, has_dp ? dscale : nullptr,
                                  out, T, C, H, approx, ln_eps,
                                  static_cast<cudaStream_t>(stream)));
}

size_t hs_mlp_bwd_workspace(int T, int C, int H) { return hs::bwd_work(T, C, H, false).total; }

int hs_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               const void* dout, void* dx, void* dw1, void* dw2, void* red, void* work, int T,
               int C, int H, int approx, void* stream) {
  return int(hs::launch_bwd<false>(x, w1, b1, w2, b2, nullptr, nullptr, dout, dx, dw1, dw2, red,
                                   work, T, C, H, approx, 0.f,
                                   static_cast<cudaStream_t>(stream)));
}

size_t hs_mlp_block_bwd_workspace(int T, int C, int H) {
  return hs::bwd_work(T, C, H, true).total;
}

int hs_mlp_block_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* gamma, const void* beta, const void* dscale,
                     const void* dz, void* dx, void* dw1, void* dw2, void* red, void* work,
                     int T, int C, int H, int approx, int has_dp, float ln_eps, void* stream) {
  (void)beta;  // beta does not enter the backward
  return int(hs::launch_bwd<true>(x, w1, b1, w2, b2, gamma, has_dp ? dscale : nullptr, dz, dx,
                                  dw1, dw2, red, work, T, C, H, approx, ln_eps,
                                  static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
