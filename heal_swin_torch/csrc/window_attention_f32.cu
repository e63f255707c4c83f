// Window attention of HEAL-SWIN for Hopper (sm_90a) in float32, the forwards, for the
// configs that compute in f32 (the paper run configs and the JAX config default: dtype
// None).  Their backwards are in window_attention_bwd_f32.cu; the building blocks both
// share (the attention steps, the 3xTF32 products, the LayerNorm statistics) are in
// attention_f32.cuh.
//
// Replaces, in f32, three Pallas TPU kernels of heal_swin_tpu/ops/window_attention.py:
//   K1 hs_window_attention_qkv_epi_f32  <- _fwd_kernel_xw_epi (fused_window_attention_qkv_epi,
//      x f32): x @ Wqkv + b -> cosine attention (rel-pos bias, -100 group mask, f32
//      softmax) -> @ Wp + bp -> optional LayerNorm.
//   K2 hs_window_attention_f32          <- _fwd_kernel / _attn_fwd_body (fused_window_attention,
//      qkv f32): attention from precomputed qkv rows, cosine or scaled-dot.
//   K16 hs_window_attention_qkv_f32     <- _fwd_kernel_xw (fused_window_attention_qkv, x
//      f32): x @ Wqkv + b -> attention, cosine or scaled-dot, before the projection: K1's
//      steps 1 and 2 below, so its o is K1's bit for bit.
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
// gemm_3xtf32_kernel<false, false> (attention_f32.cuh): 128 x 96 output tiles (96
// divides every N of the paper shapes: 3C and C at C 96 / 192 / 384), 8 warps of 32 x
// 48, the A and B slices of 32 k in a 3-stage cp.async ring with one barrier a stage.
// Shared-memory rows are padded (A 36, B 104 floats) so that every 32-bit fragment load
// of a warp hits 32 distinct banks.  Rows past M (M % 64 == 0) and columns past N
// (N % 4 == 0) are zero-filled by cp.async and not stored.  The bias is added after the
// sum (the plain version's matmul, then + b).
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

#include "attention_f32.cuh"

namespace hs {
namespace {

// ---------------------------------------------------------------------------------
// ln_rows_f32: each row of u (T x C, C % 32 == 0, C <= 32 kLnMaxPer = 384) LayerNormed in place,
// a warp per row: ln_row_center's statistics, then y = (u - mean) * rstd * gamma + beta
// with each product and the sum one rounding, as the plain version's _ln_f32.
// ---------------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
ln_rows_f32_kernel(float* __restrict__ u, const float* __restrict__ gamma,
                   const float* __restrict__ beta, int T, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= T) return;
  float* ur = u + size_t(row) * C;
  const int per = C / 32;
  float v[kLnMaxPer];
#pragma unroll
  for (int i = 0; i < kLnMaxPer; ++i)
    if (i < per) v[i] = ur[lane + 32 * i];
  const float rstd = ln_row_center(v, per, C, eps);
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

// f32 K16's workspace: qkv (T x 3C), f32
size_t hs_window_attention_qkv_f32_workspace(int T, int C) {
  return hs::align128(size_t(T) * 3 * C * 4);
}

// f32 K16: gemm_3xtf32 (qkv = x Wqkv + bqkv), then attn_3xtf32, cosine or scaled-dot, on
// one stream: K1's steps 1 and 2
int hs_window_attention_qkv_f32(const void* x, const void* wqkv, const void* bqkv,
                                const void* groups, const void* bias, const void* lscale,
                                void* out, void* work, int T, int C, int use_cos, int has_mask,
                                float sm_scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % hs::HD || T % hs::WS) return int(cudaErrorInvalidValue);
  float* qkv = static_cast<float*>(work);
  cudaError_t e = hs::gemm_nn_f32(static_cast<const float*>(x), static_cast<const float*>(wqkv),
                                  static_cast<const float*>(bqkv), qkv, T, 3 * C, C, s);
  if (e != cudaSuccess) return int(e);
  return int(hs::attention_f32(qkv, static_cast<const int*>(groups),
                               static_cast<const float*>(bias), static_cast<const float*>(lscale),
                               static_cast<float*>(out), T, C, use_cos, has_mask, sm_scale, s));
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
