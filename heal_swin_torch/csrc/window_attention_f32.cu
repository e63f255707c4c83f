// Window attention of HEAL-SWIN for Hopper (sm_90a) in float32, forward only, for the
// configs that compute in f32 (the paper run configs: dtype None) at eval and predict.
//
// Replaces, in f32, two Pallas TPU kernels of heal_swin_tpu/ops/window_attention.py:
//   K1 hs_window_attention_qkv_epi_f32  <- _fwd_kernel_xw_epi (fused_window_attention_qkv_epi,
//      x f32): x @ Wqkv + b -> cosine attention (rel-pos bias, -100 group mask, f32
//      softmax) -> @ Wp + bp -> optional LayerNorm.
//   K2 hs_window_attention_f32          <- _fwd_kernel / _attn_fwd_body (fused_window_attention,
//      qkv f32): attention from precomputed qkv rows, cosine or scaled-dot.
// With f32 operands every cast of the Pallas bodies is the identity, so nothing is rounded
// below f32 (window_attention_plain and window_attention_qkv_epi_plain run in f32).
//
// Every product runs on the tensor cores in 3xTF32: mma.sync m16n8k8 with tf32 operands
// and f32 sums.  Each operand a is split in registers after its shared-memory load into
// hi = tf32(a) (to nearest, ties away, as cvt.rna rounds) and lo = a - hi, which the
// tensor core reads as tf32 (its low 13 bits dropped), and a b accumulates as lo_a hi_b,
// then hi_a lo_b, then hi_a hi_b (the small terms first), leaving out lo_a lo_b and
// lo's dropped bits (~2^-21 relative in all).  One TF32 pass would not do: the cosine logit scale (up to 100) multiplies
// every error of q_hat . k_hat, and one pass (~5e-4 relative a product) misses the 1e-5
// the kernels are held to by more than 10x (tests/test_torch_tf32_split.py emulates both).
//
// mma.sync and not wgmma: tf32 wgmma takes both operands K-major in shared memory, and
// Wqkv, Wp and the v tile are row-major (k x n), so it would need a transposed copy of
// each; the register split also needs the fragments in registers, where mma.sync has
// them.  wgmma with a transposed weight copy is the step after this one.
//
// What bounds them.  K1 does 512 C^2 + 16384 C FLOPs a window (the two projections and
// the two attention products; the paper predict's 20 launches 386 GFLOP of products,
// 2.70 ms at a third of the 495 TFLOPS TF32 peak) on 512 C bytes of f32 activations in
// and out: bounded by the arithmetic.  In f32 its operands do not fit a block: a 64-token
// x tile at C 384 is 98,304 bytes, the o tile as much, one head's Wqkv columns (C x 96)
// 147,456.  So K1 is a launch sequence from one entry, each step bounded by its own work:
//   1. gemm_3xtf32_kernel: qkv = x Wqkv + bqkv, (T, 3C) f32 into the workspace;
//   2. attn_3xtf32_kernel (K2's kernel, cosine): o (T, C) f32 into the workspace;
//   3. gemm_3xtf32_kernel: u = o Wp + bp, into the output;
//   4. ln_rows_f32 (with LayerNorm): the output's rows normalized in place, f32
//      two-pass statistics.
// The workspace is 16 T C bytes (qkv, o).  K2 moves 16 T C bytes (qkv in, o out) for
// 16384 C FLOPs a window, 32 FLOP/byte: bounded by memory (at the bottleneck, T 4,096
// and C 768, 50 MB: 0.015 ms at 3.35 TB/s).  The sequence moves ~48 T C bytes a launch
// (x 4, qkv 12 + 12, o 4 + 4, out 4, LayerNorm 4 + 4), ~10.9 GB over the paper predict's
// 20 launches, ~3.25 ms at 3.35 TB/s: above the products' 2.70 ms, so once the products
// run on the tensor cores those workspace round trips are the next limit.  A single
// fused f32 K1 (qkv and o kept on chip, the weights streamed) is the remedy, left for a
// later change.
//
// gemm_3xtf32_kernel: 128 x 96 output tiles (96 divides every N of the paper shapes: 3C
// and C at C 96 / 192 / 384), 8 warps of 32 x 48, the A and B slices of 32 k in a
// 3-stage cp.async ring with one barrier a stage.  Shared-memory rows are padded (A 36,
// B 104 floats) so that every 32-bit fragment load of a warp hits 32 distinct banks.
// Rows past M (M % 64 == 0) and columns past N (N % 4 == 0) are zero-filled by cp.async
// and not stored.  The bias is added after the sum (the plain version's matmul, then + b).
//
// attn_3xtf32_kernel: one (window, head) per block of 4 warps, each warp 16 query rows.
// q, k, v rows (64 x 32 each) and the group ids come in by 16-byte cp.async; for cosine a
// thread per q or k row normalizes it in shared memory as the plain version does
// (rsqrt of the clamped sum of squares; q times rsqrt * scale, each product one
// rounding).  S = Q_hat K_hat^T (16 x 64 a warp) in 3xTF32; in registers across the
// quad: [* sm_scale,] + bias, + -100 where the group ids differ, the row max as the
// shift, e = exp, and the sum.  O = E V in 3xTF32, then O / max(sum, 1e-30) (as one
// product by the reciprocal): the plain version divides e before the product, and
// dividing after it moves O by a few f32 ulps, not by the 1e-5 limit.  E comes straight
// from the score accumulators: a thread's accumulator holds keys 2c and 2c + 1 of each
// 8-key tile where the A fragment wants keys c and c + 4, so the product's k index runs
// over the keys in the order (0, 2, 4, 6, 1, 3, 5, 7) of each tile, and the v rows are
// read in the same order (a sum over keys does not depend on their order, and no
// shuffle is needed).  Tiles have rows of 36 floats: every fragment load, the row
// normalization's float4 reads and the permuted v reads are free of bank conflicts.
// A persistent form (one wave of blocks walking the windows of a head, the next
// window's rows loading into a second buffer) was no faster on an H100.  No float
// atomics; every sum in a fixed order, so two launches are bit-equal.

#include <math_constants.h>

#include "common.cuh"
#include "tf32.cuh"

namespace hs {
namespace {

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// ---------------------------------------------------------------------------------
// attn_3xtf32_kernel: see the note at the top.  Grid (T / 64, C / 32), 128 threads.
// ---------------------------------------------------------------------------------
constexpr int LDT = HD + 4;  // q, k, v tile rows (floats)
constexpr int kAttnThreads = 128;

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

  // q, k, v: 64 rows x 3 parts x 8 chunks of 16 bytes
  for (int i = tid; i < WS * 24; i += kAttnThreads) {
    const int r = i / 24, part = (i % 24) >> 3, ch = i & 7;
    float* dst = (part == 0 ? qs : part == 1 ? ks : vs) + r * LDT + ch * 4;
    cp_async16(dst, qkv + (tok0 + r) * 3 * C + part * C + head * HD + ch * 4);
  }
  if (masked && tid < WS / 4) cp_async16(gs + tid * 4, groups + tok0 + tid * 4);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  if (use_cos) {  // thread t < 64: q row t; t >= 64: k row t - 64
    float* row = (tid < WS ? qs : ks) + (tid & (WS - 1)) * LDT;
    float v[HD];
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) {
      const float4 a = reinterpret_cast<const float4*>(row)[i];
      v[4 * i] = a.x; v[4 * i + 1] = a.y; v[4 * i + 2] = a.z; v[4 * i + 3] = a.w;
    }
    float ss = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) ss = fmaf(v[d], v[d], ss);
    // q * (rsqrt(|q|^2) * scale) and k * rsqrt(|k|^2), each product one rounding
    const float inv = rsqrtf(fmaxf(ss, 1e-24f));
    const float m = tid < WS ? __fmul_rn(inv, lscale[head]) : inv;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i)
      reinterpret_cast<float4*>(row)[i] =
          make_float4(__fmul_rn(v[4 * i], m), __fmul_rn(v[4 * i + 1], m),
                      __fmul_rn(v[4 * i + 2], m), __fmul_rn(v[4 * i + 3], m));
    __syncthreads();
  }

  // S = Q_hat K_hat^T: 8 key tiles of 8, k over the head's 32 channels in 4 steps
  float s[WS / 8][4];
#pragma unroll
  for (int j = 0; j < WS / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const float* qa = qs + (r0 + g) * LDT + kk * 8 + c;
    uint32_t ah[4], al[4];
    split_tf32(qa[0], ah[0], al[0]);
    split_tf32(qa[8 * LDT], ah[1], al[1]);
    split_tf32(qa[4], ah[2], al[2]);
    split_tf32(qa[8 * LDT + 4], ah[3], al[3]);
    uint32_t bh[WS / 8][2], bl[WS / 8][2];
#pragma unroll
    for (int j = 0; j < WS / 8; ++j) {
      const float* kb = ks + (j * 8 + g) * LDT + kk * 8 + c;
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

  // scores of rows g (s[j][0..1]) and g + 8 (s[j][2..3]), keys 8j + 2c, 8j + 2c + 1
  const float* b0 = bias + (size_t(head) * WS + r0 + g) * WS + 2 * c;
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
  // 1 / max(sum, 1e-30) of rows g and g + 8, applied to O after the product
  const float i0 = __fdiv_rn(1.f, fmaxf(quad_sum(d0), 1e-30f));
  const float i1 = __fdiv_rn(1.f, fmaxf(quad_sum(d1), 1e-30f));

  // O = E V: k step j runs over keys 8j + (0, 2, 4, 6, 1, 3, 5, 7), so that the A
  // fragment (rows g, g + 8; k c, c + 4) is the accumulator (keys 2c, 2c + 1)
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < WS / 8; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(s[j][0], ah[0], al[0]);
    split_tf32(s[j][2], ah[1], al[1]);
    split_tf32(s[j][1], ah[2], al[2]);
    split_tf32(s[j][3], ah[3], al[3]);
    const float* vb = vs + (j * 8 + 2 * c) * LDT + g;
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

  float* orow = out + (tok0 + r0 + g) * C + head * HD + 2 * c;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<float2*>(orow + n * 8) =
        make_float2(__fmul_rn(o[n][0], i0), __fmul_rn(o[n][1], i0));
    *reinterpret_cast<float2*>(orow + size_t(8) * C + n * 8) =
        make_float2(__fmul_rn(o[n][2], i1), __fmul_rn(o[n][3], i1));
  }
}

cudaError_t attention_f32(const float* qkv, const int* groups, const float* bias,
                          const float* lscale, float* out, int T, int C, int use_cos,
                          int has_mask, float sm_scale, cudaStream_t s) {
  if (T % WS || T <= 0 || C % HD || C <= 0) return cudaErrorInvalidValue;
  attn_3xtf32_kernel<<<dim3(T / WS, C / HD), kAttnThreads, 0, s>>>(
      qkv, groups, bias, lscale, out, C, use_cos, has_mask, sm_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------------
// gemm_3xtf32_kernel: out (M x N) = A (M x K) B (K x N) [+ bias (N)], row-major f32;
// M % 64 == 0, K % 32 == 0, N % 4 == 0, 16-byte aligned rows.  Grid (ceil(N / 96),
// ceil(M / 128)): the blocks of one row band run side by side and share its A slices
// in L2.
// ---------------------------------------------------------------------------------
constexpr int GM_BM = 128, GM_BN = 96, GM_BK = 32, GM_STAGES = 3, GM_THREADS = 256;
constexpr int GM_LDA = GM_BK + 4;  // A (m x k) rows: banks 4 g + c, conflict-free
constexpr int GM_LDB = GM_BN + 8;  // B (k x n) rows: banks 8 c + g, conflict-free
constexpr int GM_MT = 2, GM_NT = 6;  // a warp's 32 x 48: 2 x 6 mma tiles (4 x 2 warps)
constexpr int GM_STAGE = GM_BM * GM_LDA + GM_BK * GM_LDB;  // floats a stage
constexpr size_t GM_SMEM = size_t(GM_STAGES) * GM_STAGE * sizeof(float);  // 95,232

__global__ void __launch_bounds__(GM_THREADS, 2)
gemm_3xtf32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ bias, float* __restrict__ out, int M, int N,
                   int K) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int n0 = blockIdx.x * GM_BN, m0 = blockIdx.y * GM_BM;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 48;

  // one stage: A 128 x 32 (1,024 chunks of 16 bytes, 4 a thread), B 32 x 96 (768, 3)
  auto load = [&](int slot, int k0) {
    float* As = smem + slot * GM_STAGE;
    float* Bs = As + GM_BM * GM_LDA;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + j * GM_THREADS, r = i >> 3, ch = i & 7;
      const bool ok = m0 + r < M;
      cp_async16_zfill(As + r * GM_LDA + ch * 4,
                       ok ? A + size_t(m0 + r) * K + k0 + ch * 4 : A, ok);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int i = tid + j * GM_THREADS, r = i / 24, ch = i % 24;
      const bool ok = n0 + ch * 4 < N;
      cp_async16_zfill(Bs + r * GM_LDB + ch * 4,
                       ok ? B + size_t(k0 + r) * N + n0 + ch * 4 : B, ok);
    }
  };

  float acc[GM_MT][GM_NT][4];
#pragma unroll
  for (int a = 0; a < GM_MT; ++a)
#pragma unroll
    for (int b = 0; b < GM_NT; ++b) acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;

  const int KT = K / GM_BK;
#pragma unroll
  for (int s = 0; s < GM_STAGES - 1; ++s) {
    if (s < KT) load(s, s * GM_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<GM_STAGES - 2>();  // slice kt has landed (this thread's part)
    __syncthreads();                 // ... every thread's; slot (kt - 1) % STAGES is free
    if (kt + GM_STAGES - 1 < KT)
      load((kt + GM_STAGES - 1) % GM_STAGES, (kt + GM_STAGES - 1) * GM_BK);
    cp_async_commit();
    const float* As = smem + (kt % GM_STAGES) * GM_STAGE;
    const float* Bs = As + GM_BM * GM_LDA;
#pragma unroll
    for (int kk = 0; kk < GM_BK / 8; ++kk) {
      uint32_t ah[GM_MT][4], al[GM_MT][4];
#pragma unroll
      for (int mt = 0; mt < GM_MT; ++mt) {
        const float* a = As + (wm + mt * 16 + g) * GM_LDA + kk * 8 + c;
        split_tf32(a[0], ah[mt][0], al[mt][0]);
        split_tf32(a[8 * GM_LDA], ah[mt][1], al[mt][1]);
        split_tf32(a[4], ah[mt][2], al[mt][2]);
        split_tf32(a[8 * GM_LDA + 4], ah[mt][3], al[mt][3]);
      }
      uint32_t bh[GM_NT][2], bl[GM_NT][2];
#pragma unroll
      for (int nt = 0; nt < GM_NT; ++nt) {
        const float* b = Bs + (kk * 8 + c) * GM_LDB + wn + nt * 8 + g;
        split_tf32(b[0], bh[nt][0], bl[nt][0]);
        split_tf32(b[4 * GM_LDB], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < GM_MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < GM_NT; ++nt) mma_tf32(acc[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int mt = 0; mt < GM_MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < GM_NT; ++nt) mma_tf32(acc[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
      for (int mt = 0; mt < GM_MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < GM_NT; ++nt) mma_tf32(acc[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
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
      if (m < M)
        *reinterpret_cast<float2*>(out + size_t(m) * N + n) =
            make_float2(__fadd_rn(acc[mt][nt][0], bb.x), __fadd_rn(acc[mt][nt][1], bb.y));
      if (m + 8 < M)
        *reinterpret_cast<float2*>(out + size_t(m + 8) * N + n) =
            make_float2(__fadd_rn(acc[mt][nt][2], bb.x), __fadd_rn(acc[mt][nt][3], bb.y));
    }
  }
}

cudaError_t gemm_nn_f32(const float* A, const float* B, const float* bias, float* out, int M,
                        int N, int K, cudaStream_t s) {
  if (M % 64 || K % GM_BK || N % 4 || M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  static std::atomic<unsigned> done{0};
  const cudaError_t e =
      smem_opt_in(reinterpret_cast<const void*>(gemm_3xtf32_kernel), GM_SMEM, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + GM_BN - 1) / GM_BN, (M + GM_BM - 1) / GM_BM);
  gemm_3xtf32_kernel<<<grid, GM_THREADS, GM_SMEM, s>>>(A, B, bias, out, M, N, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------------
// ln_rows_f32: each row of u (T x C, C % 32 == 0, C <= 32 kLnMaxPer = 384) LayerNormed in place,
// a warp per row: mean, then the mean of the squared deviations from the held values,
// y = (u - mean) * rstd * gamma + beta with each product and the sum one rounding, as
// the plain version's _ln_f32.
// ---------------------------------------------------------------------------------
constexpr int kLnMaxPer = 12;  // C <= 384

__global__ void __launch_bounds__(256)
ln_rows_f32_kernel(float* __restrict__ u, const float* __restrict__ gamma,
                   const float* __restrict__ beta, int T, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= T) return;
  float* ur = u + size_t(row) * C;
  const int per = C / 32;
  float v[kLnMaxPer];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxPer; ++i)
    if (i < per) {
      v[i] = ur[lane + 32 * i];
      s += v[i];
    }
  const float mean = __fdiv_rn(warp_sum(s), float(C));
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxPer; ++i)
    if (i < per) {
      v[i] = __fsub_rn(v[i], mean);
      sq = fmaf(v[i], v[i], sq);
    }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), float(C)), eps));
#pragma unroll
  for (int i = 0; i < kLnMaxPer; ++i)
    if (i < per) {
      const int c = lane + 32 * i;
      ur[c] = __fadd_rn(__fmul_rn(__fmul_rn(v[i], rstd), gamma[c]), beta[c]);
    }
}

}  // namespace
}  // namespace hs

extern "C" {

// f32 K1's workspace: qkv (T x 3C) and o (T x C), f32
size_t hs_window_attention_qkv_epi_f32_workspace(int T, int C) {
  return hs::align128(size_t(T) * 3 * C * 4) + hs::align128(size_t(T) * C * 4);
}

// f32 K1: gemm_3xtf32 (qkv), attn_3xtf32 (cosine), gemm_3xtf32 (u = o Wp + bp), then
// with has_ln ln_rows_f32 in place, on one stream; every operand f32 but the group ids
int hs_window_attention_qkv_epi_f32(const void* x, const void* wqkv, const void* bqkv,
                                    const void* wp, const void* bp, const void* ln_g,
                                    const void* ln_b, const void* groups, const void* bias,
                                    const void* lscale, void* out, void* work, int T, int C,
                                    int has_ln, int has_mask, float ln_eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % hs::HD || C > 32 * hs::kLnMaxPer || T % hs::WS) return int(cudaErrorInvalidValue);
  float* qkv = static_cast<float*>(work);
  float* o = reinterpret_cast<float*>(static_cast<unsigned char*>(work) +
                                      hs::align128(size_t(T) * 3 * C * 4));
  cudaError_t e = hs::gemm_nn_f32(static_cast<const float*>(x), static_cast<const float*>(wqkv),
                                  static_cast<const float*>(bqkv), qkv, T, 3 * C, C, s);
  if (e != cudaSuccess) return int(e);
  e = hs::attention_f32(qkv, static_cast<const int*>(groups), static_cast<const float*>(bias),
                        static_cast<const float*>(lscale), o, T, C, 1, has_mask, 1.f, s);
  if (e != cudaSuccess) return int(e);
  e = hs::gemm_nn_f32(o, static_cast<const float*>(wp), static_cast<const float*>(bp),
                      static_cast<float*>(out), T, C, C, s);
  if (e != cudaSuccess || !has_ln) return int(e);
  hs::ln_rows_f32_kernel<<<(T + 7) / 8, 256, 0, s>>>(
      static_cast<float*>(out), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), T, C, ln_eps);
  return int(cudaGetLastError());
}

// f32 K2: attention from f32 qkv rows (T, 3C) -> (T, C) f32, cosine or scaled-dot
int hs_window_attention_f32(const void* qkv, const void* groups, const void* bias,
                            const void* lscale, void* out, int T, int C, int use_cos,
                            int has_mask, float sm_scale, void* stream) {
  return int(hs::attention_f32(static_cast<const float*>(qkv), static_cast<const int*>(groups),
                               static_cast<const float*>(bias),
                               static_cast<const float*>(lscale), static_cast<float*>(out), T,
                               C, use_cos, has_mask, sm_scale,
                               static_cast<cudaStream_t>(stream)));
}

// f32 K1's product step alone (no launch of its own on the main path): out (M x N) =
// A (M x K) B (K x N) [+ bias], row-major f32, in 3xTF32; M % 64, K % 32, N % 4 == 0
int hs_gemm_nn_f32(const void* a, const void* b, const void* bias, void* out, int M, int N,
                   int K, void* stream) {
  return int(hs::gemm_nn_f32(static_cast<const float*>(a), static_cast<const float*>(b),
                             static_cast<const float*>(bias), static_cast<float*>(out), M, N, K,
                             static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
