// The float32 window-attention building blocks of the f32 kernels, shared by the forward
// (window_attention_f32.cu: the f32 K1, K2 and K16) and the backward
// (window_attention_bwd_f32.cu: the f32 K4, K5 and K17), so that a backward recomputes
// its forward through the forward's own functions, bit for bit.
//
// - attn_f32_stage / attn_f32_cos_rows / rows_x_rows_t / attn_f32_softmax / acc_x_rows:
//   the steps of attn_3xtf32_kernel (one (window, head) per block of 4 warps, each warp
//   16 query rows; see window_attention_f32.cu), and tile_t_x_rows, the transposed
//   product the backward adds (dV = P^T dO, dK = dS^T Q).
// - gemm_3xtf32_kernel<AT, BT>: the 3xTF32 product in three layouts: NN (qkv = x Wqkv +
//   b, u = o Wp + bp: the forwards' products, which the backwards recompute), NT and TN
//   (the decoder tail's wide route, final_head_wide.cu), TN split over K into per-split
//   partial matrices summed in a fixed order by reduce_rows.  The backwards' own
//   products (dWqkv, dWp, dx, do) run on the wgmma core (gemm_3xtf32_wgmma.cuh).
// - ln_row_center: the two-pass LayerNorm statistics of a row held by a warp.
// Every product is 3xTF32 on mma.sync m16n8k8 (tf32.cuh); no float atomics.
#pragma once

#include <math_constants.h>

#include "common.cuh"
#include "tf32.cuh"

namespace hs {
namespace {

constexpr int LDT = HD + 4;  // q, k, v, dO tile rows (floats): fragment loads conflict-free
constexpr int kAttnThreads = 128;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// cp.async of a window's q, k, v rows of one head (64 rows x 3 parts x 8 chunks of 16
// bytes) into 64 x LDT tiles, and (masked) its group ids; the caller commits
__device__ __forceinline__ void attn_f32_stage(const float* __restrict__ qkv,
                                               const int* __restrict__ groups, size_t tok0,
                                               int C, int head, float* qs, float* ks,
                                               float* vs, int* gs, bool masked, int tid) {
  for (int i = tid; i < WS * 24; i += kAttnThreads) {
    const int r = i / 24, part = (i % 24) >> 3, ch = i & 7;
    float* dst = (part == 0 ? qs : part == 1 ? ks : vs) + r * LDT + ch * 4;
    cp_async16(dst, qkv + (tok0 + r) * 3 * C + part * C + head * HD + ch * 4);
  }
  if (masked && tid < WS / 4) cp_async16(gs + tid * 4, groups + tok0 + tid * 4);
}

// cosine attention's normalization, a thread a row (t < 64: q row t; t >= 64: k row
// t - 64): q * (rsqrt(|q|^2) * scale) and k * rsqrt(|k|^2), each product one rounding,
// from the src tiles into the dst tiles (the same tiles in the forward); ``inv`` (or
// null) gets each row's rsqrt, q rows at 0-63 and k rows at 64-127
__device__ __forceinline__ void attn_f32_cos_rows(const float* qsrc, const float* ksrc,
                                                  float* qdst, float* kdst, float lscale,
                                                  float* inv_out, int tid) {
  const int r = tid & (WS - 1);
  const float* row = (tid < WS ? qsrc : ksrc) + r * LDT;
  float* out = (tid < WS ? qdst : kdst) + r * LDT;
  float v[HD];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) {
    const float4 a = reinterpret_cast<const float4*>(row)[i];
    v[4 * i] = a.x; v[4 * i + 1] = a.y; v[4 * i + 2] = a.z; v[4 * i + 3] = a.w;
  }
  float ss = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) ss = fmaf(v[d], v[d], ss);
  const float inv = rsqrtf(fmaxf(ss, 1e-24f));
  const float m = tid < WS ? __fmul_rn(inv, lscale) : inv;
  if (inv_out != nullptr) inv_out[tid] = inv;
#pragma unroll
  for (int i = 0; i < HD / 4; ++i)
    reinterpret_cast<float4*>(out)[i] =
        make_float4(__fmul_rn(v[4 * i], m), __fmul_rn(v[4 * i + 1], m),
                    __fmul_rn(v[4 * i + 2], m), __fmul_rn(v[4 * i + 3], m));
}

// s (16 x 64 a warp, accumulator layout: rows r0 + g (s[j][0..1]) and r0 + g + 8
// (s[j][2..3]), columns 8j + 2c, 8j + 2c + 1) = A[r0 .. r0 + 15] B^T over the head's 32
// channels, A and B 64 x LDT tiles: the scores Q K^T, and the backward's dP = dO V^T
__device__ __forceinline__ void rows_x_rows_t(const float* A, const float* B, int r0, int g,
                                              int c, float (&s)[WS / 8][4]) {
#pragma unroll
  for (int j = 0; j < WS / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const float* qa = A + (r0 + g) * LDT + kk * 8 + c;
    uint32_t ah[4], al[4];
    split_tf32(qa[0], ah[0], al[0]);
    split_tf32(qa[8 * LDT], ah[1], al[1]);
    split_tf32(qa[4], ah[2], al[2]);
    split_tf32(qa[8 * LDT + 4], ah[3], al[3]);
    uint32_t bh[WS / 8][2], bl[WS / 8][2];
#pragma unroll
    for (int j = 0; j < WS / 8; ++j) {
      const float* kb = B + (j * 8 + g) * LDT + kk * 8 + c;
      split_tf32(kb[0], bh[j][0], bl[j][0]);
      split_tf32(kb[4], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int j = 0; j < WS / 8; ++j) mma_tf32(s[j], al, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < WS / 8; ++j) mma_tf32(s[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
    for (int j = 0; j < WS / 8; ++j) mma_tf32(s[j], ah, bh[j][0], bh[j][1]);
  }
}

// scores -> e = exp(logit - row max) in place, and 1 / max(row sum, 1e-30) of rows
// r0 + g (i0) and r0 + g + 8 (i1): [* sm_scale (scaled-dot),] + bias, + -100 where the
// group ids differ; P = e * i is the forward's probabilities
__device__ __forceinline__ void attn_f32_softmax(float (&s)[WS / 8][4],
                                                 const float* __restrict__ bias_h,
                                                 const int* gs, bool masked, bool use_cos,
                                                 float sm_scale, int r0, int g, int c,
                                                 float& i0, float& i1) {
  const float* b0 = bias_h + (r0 + g) * WS + 2 * c;
  const float* b1 = b0 + 8 * WS;
  const int gr0 = masked ? gs[r0 + g] : 0, gr1 = masked ? gs[r0 + g + 8] : 0;
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < WS / 8; ++j) {
    const float2 u = __ldg(reinterpret_cast<const float2*>(b0 + 8 * j));
    const float2 w = __ldg(reinterpret_cast<const float2*>(b1 + 8 * j));
    const float bj[4] = {u.x, u.y, w.x, w.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float a = s[j][e];
      if (!use_cos) a = __fmul_rn(a, sm_scale);
      a = __fadd_rn(a, bj[e]);
      if (masked && gs[8 * j + 2 * c + (e & 1)] != (e < 2 ? gr0 : gr1))
        a = __fadd_rn(a, MASK_VALUE);
      s[j][e] = a;
    }
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int j = 0; j < WS / 8; ++j) {
    s[j][0] = expf(__fsub_rn(s[j][0], mx0));
    s[j][1] = expf(__fsub_rn(s[j][1], mx0));
    s[j][2] = expf(__fsub_rn(s[j][2], mx1));
    s[j][3] = expf(__fsub_rn(s[j][3], mx1));
    d0 = __fadd_rn(d0, __fadd_rn(s[j][0], s[j][1]));
    d1 = __fadd_rn(d1, __fadd_rn(s[j][2], s[j][3]));
  }
  i0 = __fdiv_rn(1.f, fmaxf(quad_sum(d0), 1e-30f));
  i1 = __fdiv_rn(1.f, fmaxf(quad_sum(d1), 1e-30f));
}

// o (16 x 32 a warp, accumulator layout) = e B, e (16 x 64) in the accumulator layout of
// rows_x_rows_t and B a 64 x LDT tile: k step j runs over rows 8j + (0, 2, 4, 6, 1, 3,
// 5, 7), so that the A fragment (rows g, g + 8; k c, c + 4) is the accumulator (columns
// 2c, 2c + 1) and B's rows are read in the same order.  O = E V, and the backward's
// dQ = dS K
__device__ __forceinline__ void acc_x_rows(const float (&e)[WS / 8][4], const float* B, int g,
                                           int c, float (&o)[HD / 8][4]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < WS / 8; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(e[j][0], ah[0], al[0]);
    split_tf32(e[j][2], ah[1], al[1]);
    split_tf32(e[j][1], ah[2], al[2]);
    split_tf32(e[j][3], ah[3], al[3]);
    const float* vb = B + (j * 8 + 2 * c) * LDT + g;
    uint32_t bh[HD / 8][2], bl[HD / 8][2];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      split_tf32(vb[n * 8], bh[n][0], bl[n][0]);
      split_tf32(vb[LDT + n * 8], bh[n][1], bl[n][1]);
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) mma_tf32(o[n], al, bh[n][0], bh[n][1]);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) mma_tf32(o[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) mma_tf32(o[n], ah, bh[n][0], bh[n][1]);
  }
}

// o (16 x 32 a warp: rows r0 .. r0 + 15 of P^T) = P[:, r0 .. r0 + 15]^T B, P a 64 x ldp
// tile (query rows, key columns) and B a 64 x LDT tile (query rows): dV = P^T dO and
// dK = dS^T Q.  k step kk runs over queries 8kk + (0, 2, 4, 6, 1, 3, 5, 7), so that the
// strided fragment loads of P (banks 8c + g at ldp = 68) and of B (8c + g at LDT = 36)
// are conflict-free
__device__ __forceinline__ void tile_t_x_rows(const float* P, int ldp, const float* B, int r0,
                                              int g, int c, float (&o)[HD / 8][4]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < WS / 8; ++kk) {
    const float* pa = P + (kk * 8 + 2 * c) * ldp + r0 + g;
    uint32_t ah[4], al[4];
    split_tf32(pa[0], ah[0], al[0]);
    split_tf32(pa[8], ah[1], al[1]);
    split_tf32(pa[ldp], ah[2], al[2]);
    split_tf32(pa[ldp + 8], ah[3], al[3]);
    const float* bb = B + (kk * 8 + 2 * c) * LDT + g;
    uint32_t bh[HD / 8][2], bl[HD / 8][2];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      split_tf32(bb[n * 8], bh[n][0], bl[n][0]);
      split_tf32(bb[LDT + n * 8], bh[n][1], bl[n][1]);
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) mma_tf32(o[n], al, bh[n][0], bh[n][1]);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) mma_tf32(o[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) mma_tf32(o[n], ah, bh[n][0], bh[n][1]);
  }
}

// attn_3xtf32_kernel: the f32 K2 and step 2 of the f32 K1 and K16 (see
// window_attention_f32.cu).  Grid (T / 64, C / 32), 128 threads.
__global__ void __launch_bounds__(kAttnThreads, 4)
attn_3xtf32_kernel(const float* __restrict__ qkv, const int* __restrict__ groups,
                   const float* __restrict__ bias, const float* __restrict__ lscale,
                   float* __restrict__ out, int C, int use_cos, int has_mask, float sm_scale) {
  __shared__ __align__(16) float qs[WS * LDT];
  __shared__ __align__(16) float ks[WS * LDT];
  __shared__ __align__(16) float vs[WS * LDT];
  __shared__ __align__(16) int gs[WS];
  const int head = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int r0 = (tid >> 5) * 16;  // this warp's query rows r0 .. r0 + 15
  const size_t tok0 = size_t(blockIdx.x) * WS;
  const bool masked = has_mask != 0;

  attn_f32_stage(qkv, groups, tok0, C, head, qs, ks, vs, gs, masked, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (use_cos) {
    attn_f32_cos_rows(qs, ks, qs, ks, lscale[head], nullptr, tid);
    __syncthreads();
  }
  float s[WS / 8][4];
  rows_x_rows_t(qs, ks, r0, g, c, s);
  float i0, i1;
  attn_f32_softmax(s, bias + size_t(head) * WS * WS, gs, masked, use_cos != 0, sm_scale, r0,
                   g, c, i0, i1);
  float o[HD / 8][4];
  acc_x_rows(s, vs, g, c, o);

  float* orow = out + (tok0 + r0 + g) * C + head * HD + 2 * c;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<float2*>(orow + n * 8) =
        make_float2(__fmul_rn(o[n][0], i0), __fmul_rn(o[n][1], i0));
    *reinterpret_cast<float2*>(orow + size_t(8) * C + n * 8) =
        make_float2(__fmul_rn(o[n][2], i1), __fmul_rn(o[n][3], i1));
  }
}

inline cudaError_t attention_f32(const float* qkv, const int* groups, const float* bias,
                                 const float* lscale, float* out, int T, int C, int use_cos,
                                 int has_mask, float sm_scale, cudaStream_t s) {
  if (T % WS || T <= 0 || C % HD || C <= 0) return cudaErrorInvalidValue;
  attn_3xtf32_kernel<<<dim3(T / WS, C / HD), kAttnThreads, 0, s>>>(
      qkv, groups, bias, lscale, out, C, use_cos, has_mask, sm_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------------
// gemm_3xtf32_kernel<AT, BT>: out (M x N, row-major f32) = op(A) op(B) [+ bias (N)],
// op(A) (M x K) = A, row-major M x K, or with AT A^T of A row-major K x M; op(B) (K x N)
// = B, row-major K x N, or with BT B^T of B row-major N x K.  128 x 96 output tiles, 8
// warps of 32 x 48, the A and B slices of 32 k in a 3-stage cp.async ring with one
// barrier a stage.  Shared-memory rows are padded so that every 32-bit fragment load of
// a warp hits 32 distinct banks: A as m x k rows of 36 floats (banks 4g + c) or k x m
// rows of 136 (8c + g); B as k x n rows of 104 (8c + g) or n x k rows of 36 (4g + c).
// Each slice of 32 k sums in a zeroed accumulator (12 tensor-core adds, lo_a hi_b,
// hi_a lo_b, hi_a hi_b a k step of 8), added to the tile's running sum with one add
// rounded to nearest: the tensor core's accumulator does not round to nearest, so its
// error grows with the length of the chain, and a chain over all of K (up to 2,048
// tokens a split) left the weight gradients ~1.5e-5 from f32 on an H100.
// Rows past M and columns past N (M % 4 == 0 with AT, N % 4 == 0) are zero-filled by
// cp.async and not stored; K % 32 == 0.  blockIdx.z takes the k range [z kchunk,
// (z + 1) kchunk) and writes out + z M N (kchunk % 32 == 0; an empty range writes
// zeros): the split-K partials of the TN product.  The bias is added after the sum.
// The store is the epilogue Epi's: EpiBias (out = sum + bias) here, and the MLP's
// (mlp_f32.cu), which read or write ``aux``, an M x N matrix laid out as out.
// ---------------------------------------------------------------------------------
struct EpiBias {
  // out[i], out[i + 1] = a0 + b.x, a1 + b.y
  __device__ __forceinline__ static void store(float* out, float* aux, size_t i, float a0,
                                               float a1, float2 b) {
    (void)aux;
    *reinterpret_cast<float2*>(out + i) = make_float2(__fadd_rn(a0, b.x), __fadd_rn(a1, b.y));
  }
};

constexpr int GM_BM = 128, GM_BN = 96, GM_BK = 32, GM_STAGES = 3, GM_THREADS = 256;
constexpr int GM_MT = 2, GM_NT = 6;  // a warp's 32 x 48: 2 x 6 mma tiles (4 x 2 warps)

template <bool AT, bool BT>
struct GemmTile {
  static constexpr int LDA = AT ? GM_BM + 8 : GM_BK + 4;  // A rows (floats)
  static constexpr int LDB = BT ? GM_BK + 4 : GM_BN + 8;  // B rows
  static constexpr int A_FLOATS = AT ? GM_BK * LDA : GM_BM * LDA;
  static constexpr int B_FLOATS = BT ? GM_BN * LDB : GM_BK * LDB;
  static constexpr int STAGE = A_FLOATS + B_FLOATS;  // floats a stage
  static constexpr size_t SMEM = size_t(GM_STAGES) * STAGE * sizeof(float);
};

template <bool AT, bool BT, class Epi = EpiBias, bool KTAIL = false>
__global__ void __launch_bounds__(GM_THREADS, 2)
gemm_3xtf32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ bias, float* out, float* aux, int M, int N,
                   int K, int kchunk) {
  using L = GemmTile<AT, BT>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int n0 = blockIdx.x * GM_BN, m0 = blockIdx.y * GM_BM;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 48;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  out += size_t(blockIdx.z) * M * N;

  // one stage: A 128 x 32 (1,024 chunks of 16 bytes, 4 a thread), B 32 x 96 (768, 3)
  auto load = [&](int slot, int k0) {
    float* As = smem + slot * L::STAGE;
    float* Bs = As + L::A_FLOATS;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + j * GM_THREADS;
      if constexpr (AT) {  // k row r (32), m chunk ch (32)
        const int r = i >> 5, ch = i & 31;
        const bool ok = m0 + ch * 4 < M && (!KTAIL || k0 + r < kend);
        cp_async16_zfill(As + r * L::LDA + ch * 4,
                         ok ? A + size_t(k0 + r) * M + m0 + ch * 4 : A, ok);
      } else {  // m row r (128), k chunk ch (8)
        const int r = i >> 3, ch = i & 7;
        const bool ok = m0 + r < M && (!KTAIL || k0 + ch * 4 < kend);
        cp_async16_zfill(As + r * L::LDA + ch * 4,
                         ok ? A + size_t(m0 + r) * K + k0 + ch * 4 : A, ok);
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int i = tid + j * GM_THREADS;
      if constexpr (BT) {  // n row r (96), k chunk ch (8)
        const int r = i >> 3, ch = i & 7;
        const bool ok = n0 + r < N && (!KTAIL || k0 + ch * 4 < kend);
        cp_async16_zfill(Bs + r * L::LDB + ch * 4,
                         ok ? B + size_t(n0 + r) * K + k0 + ch * 4 : B, ok);
      } else {  // k row r (32), n chunk ch (24)
        const int r = i / 24, ch = i % 24;
        const bool ok = n0 + ch * 4 < N && (!KTAIL || k0 + r < kend);
        cp_async16_zfill(Bs + r * L::LDB + ch * 4,
                         ok ? B + size_t(k0 + r) * N + n0 + ch * 4 : B, ok);
      }
    }
  };

  float acc[GM_MT][GM_NT][4];
#pragma unroll
  for (int a = 0; a < GM_MT; ++a)
#pragma unroll
    for (int b = 0; b < GM_NT; ++b) acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;

  // KTAIL: a last slice of fewer than 32 k, its missing k zero-filled (K % 4 == 0)
  const int KT = kend > kbeg ? (kend - kbeg + (KTAIL ? GM_BK - 1 : 0)) / GM_BK : 0;
#pragma unroll
  for (int s = 0; s < GM_STAGES - 1; ++s) {
    if (s < KT) load(s, kbeg + s * GM_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<GM_STAGES - 2>();  // slice kt has landed (this thread's part)
    __syncthreads();                 // ... every thread's; slot (kt - 1) % STAGES is free
    if (kt + GM_STAGES - 1 < KT)
      load((kt + GM_STAGES - 1) % GM_STAGES, kbeg + (kt + GM_STAGES - 1) * GM_BK);
    cp_async_commit();
    const float* As = smem + (kt % GM_STAGES) * L::STAGE;
    const float* Bs = As + L::A_FLOATS;
#pragma unroll
    for (int mt = 0; mt < GM_MT; ++mt) {
      // the slice's 32 k into a zeroed accumulator, then one add rounded to nearest
      float t[GM_NT][4];
#pragma unroll
      for (int nt = 0; nt < GM_NT; ++nt) t[nt][0] = t[nt][1] = t[nt][2] = t[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < GM_BK / 8; ++kk) {
        uint32_t ah[4], al[4];
        if constexpr (AT) {
          const float* a = As + (kk * 8 + c) * L::LDA + wm + mt * 16 + g;
          split_tf32(a[0], ah[0], al[0]);
          split_tf32(a[8], ah[1], al[1]);
          split_tf32(a[4 * L::LDA], ah[2], al[2]);
          split_tf32(a[4 * L::LDA + 8], ah[3], al[3]);
        } else {
          const float* a = As + (wm + mt * 16 + g) * L::LDA + kk * 8 + c;
          split_tf32(a[0], ah[0], al[0]);
          split_tf32(a[8 * L::LDA], ah[1], al[1]);
          split_tf32(a[4], ah[2], al[2]);
          split_tf32(a[8 * L::LDA + 4], ah[3], al[3]);
        }
        uint32_t bh[GM_NT][2], bl[GM_NT][2];
#pragma unroll
        for (int nt = 0; nt < GM_NT; ++nt) {
          if constexpr (BT) {
            const float* b = Bs + (wn + nt * 8 + g) * L::LDB + kk * 8 + c;
            split_tf32(b[0], bh[nt][0], bl[nt][0]);
            split_tf32(b[4], bh[nt][1], bl[nt][1]);
          } else {
            const float* b = Bs + (kk * 8 + c) * L::LDB + wn + nt * 8 + g;
            split_tf32(b[0], bh[nt][0], bl[nt][0]);
            split_tf32(b[4 * L::LDB], bh[nt][1], bl[nt][1]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < GM_NT; ++nt) mma_tf32(t[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int nt = 0; nt < GM_NT; ++nt) mma_tf32(t[nt], ah, bl[nt][0], bl[nt][1]);
#pragma unroll
        for (int nt = 0; nt < GM_NT; ++nt) mma_tf32(t[nt], ah, bh[nt][0], bh[nt][1]);
      }
#pragma unroll
      for (int nt = 0; nt < GM_NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], t[nt][e]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nt = 0; nt < GM_NT; ++nt) {
    const int n = n0 + wn + nt * 8 + 2 * c;  // even, and N is: n < N means n + 1 < N
    if (n >= N) continue;
    float2 bb = make_float2(0.f, 0.f);
    if (bias != nullptr) bb = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
    for (int mt = 0; mt < GM_MT; ++mt) {
      const int m = m0 + wm + mt * 16 + g;
      if (m < M) Epi::store(out, aux, size_t(m) * N + n, acc[mt][nt][0], acc[mt][nt][1], bb);
      if (m + 8 < M)
        Epi::store(out, aux, size_t(m + 8) * N + n, acc[mt][nt][2], acc[mt][nt][3], bb);
    }
  }
}

template <bool AT, bool BT, class Epi = EpiBias, bool KTAIL = false>
inline cudaError_t gemm_f32_launch(const float* A, const float* B, const float* bias,
                                   float* out, int M, int N, int K, int splits, int kchunk,
                                   cudaStream_t s, float* aux = nullptr) {
  static std::atomic<unsigned> done{0};
  const size_t smem = GemmTile<AT, BT>::SMEM;
  const cudaError_t e = smem_opt_in(
      reinterpret_cast<const void*>(gemm_3xtf32_kernel<AT, BT, Epi, KTAIL>), smem, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + GM_BN - 1) / GM_BN, (M + GM_BM - 1) / GM_BM, splits);
  gemm_3xtf32_kernel<AT, BT, Epi, KTAIL><<<grid, GM_THREADS, smem, s>>>(A, B, bias, out, aux, M,
                                                                        N, K, kchunk);
  return cudaGetLastError();
}

// out (M x N) = A (M x K) B (K x N) [+ bias], stored by Epi; M % 64 == 0, K % 32 == 0,
// N % 4 == 0
template <class Epi = EpiBias>
inline cudaError_t gemm_nn_f32(const float* A, const float* B, const float* bias, float* out,
                               int M, int N, int K, cudaStream_t s, float* aux = nullptr) {
  if (M % 64 || K % GM_BK || N % 4 || M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  return gemm_f32_launch<false, false, Epi>(A, B, bias, out, M, N, K, 1, K, s, aux);
}

// gemm_nn_f32, and out (M x N) = A (M x K) B^T with B (N x K), for any K % 4 == 0 (the
// decoder tail's wide route: K = C or p C, C % 8 == 0): the last 32-k slice zero-filled
// past K
inline cudaError_t gemm_nn_f32_any_k(const float* A, const float* B, float* out, int M, int N,
                                     int K, cudaStream_t s) {
  if (M % 64 || K % 4 || N % 4 || M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  return gemm_f32_launch<false, false, EpiBias, true>(A, B, nullptr, out, M, N, K, 1, K, s);
}

inline cudaError_t gemm_nt_f32_any_k(const float* A, const float* B, float* out, int M, int N,
                                     int K, cudaStream_t s) {
  if (M % 64 || K % 4 || N % 4 || M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  return gemm_f32_launch<false, true, EpiBias, true>(A, B, nullptr, out, M, N, K, 1, K, s);
}

constexpr int GEMM_TN_CHUNK = 2048;  // tokens of a split, at most 128 splits
constexpr int GEMM_TN_MAX_SPLITS = 128;

inline int gemm_tn_f32_splits(int K) {
  const int s = (K + GEMM_TN_CHUNK - 1) / GEMM_TN_CHUNK;
  return s < GEMM_TN_MAX_SPLITS ? s : GEMM_TN_MAX_SPLITS;
}

inline size_t gemm_tn_f32_tmp_floats(int K, int M, int N) {
  const int S = gemm_tn_f32_splits(K);
  return size_t(S) * M * N + reduce_rows_tmp_floats(S, M * N);
}

// out (M x N) = A^T B over K rows: A (K x M), B (K x N), split over K into partial
// matrices in tmp (gemm_tn_f32_tmp_floats floats), then reduce_rows in a fixed order;
// K % 32 == 0, M % 4 == 0, N % 4 == 0
inline cudaError_t gemm_tn_f32(const float* A, const float* B, float* out, int K, int M, int N,
                               float* tmp, cudaStream_t s) {
  if (K % GM_BK || M % 4 || N % 4 || M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const int S = gemm_tn_f32_splits(K);
  int chunk = (K + S - 1) / S;
  chunk = (chunk + GM_BK - 1) / GM_BK * GM_BK;
  const cudaError_t e = gemm_f32_launch<true, false>(A, B, nullptr, tmp, M, N, K, S, chunk, s);
  if (e != cudaSuccess) return e;
  return reduce_rows(tmp, out, S, M * N, tmp + size_t(S) * M * N, s);
}

// ---------------------------------------------------------------------------------
// A row of C (C % 32 == 0, C <= 32 P: 384 for the attention's kLnMaxPer, 768 for the
// MLP's) held by a warp, lane l holding columns l + 32 i in v[i] (i < per = C / 32): its
// mean, then the mean of the squared deviations from the held values; v is left
// centred, and rstd returned (the plain version's _ln_f32 statistics, each step one
// rounding)
// ---------------------------------------------------------------------------------
constexpr int kLnMaxPer = 12;  // C <= 384

template <int P>
__device__ __forceinline__ float ln_row_center(float (&v)[P], int per, int C, float eps) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (i < per) s += v[i];
  const float mean = __fdiv_rn(warp_sum(s), float(C));
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (i < per) {
      v[i] = __fsub_rn(v[i], mean);
      sq = fmaf(v[i], v[i], sq);
    }
  return rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), float(C)), eps));
}

}  // namespace
}  // namespace hs
