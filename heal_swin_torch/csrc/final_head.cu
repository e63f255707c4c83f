// Inference decoder tail of HEAL-SWIN for Hopper (sm_90a):
// FinalPatchExpand_X4 -> LayerNorm -> head -> argmax, one kernel.
//
// Replaces the Pallas TPU kernel heal_swin_tpu/ops/final_head.py:_pred_kernel
// (fused_final_head_predict).  For every token row x (C) and each of its p sub-pixels:
//   h_i = x @ We_i (f32 accumulation, rounded to bf16) -> LN in f32 -> z_i (bf16)
//   -> logits_i = z_i @ Wh (f32, not rounded) -> argmax, lowest index on ties,
//   F - 1 for a row holding a NaN.  Output: (T, p) int32 class indices.
//
// What bounds it on this card: at the paper tail (T = 262144, C = 96, p = 4, F = 10)
// it reads 50 MB of tokens and writes 4 MB of indices, against 2*T*p*C*(C+F) = 21
// GFLOP: ~400 FLOP/byte, so the expand products decide, and the (T*p, F) logits that
// the unfused tail writes and reads back never leave the SM.
//
// What the design does about it: one block per 64-row tile holds all p expand slices
// We (p, C, C) bf16 and Wh in shared memory (79 KB + 4 KB at the paper widths, above
// the 48 KB default, so the launch opts in with cudaFuncSetAttribute); the expand
// products run on the tensor cores as 16x16x16 bf16 WMMA tiles with f32 accumulation,
// LN and the narrow head product run one warp per row in f32.

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
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int chunks = C / 8;  // 16-byte chunks per row

  for (int idx = tid; idx < P * C * chunks; idx += kThreads) {
    const int r = idx / chunks, q = idx % chunks;
    reinterpret_cast<uint4*>(wes + size_t(r) * LDW)[q] =
        reinterpret_cast<const uint4*>(we + size_t(r) * C)[q];
  }
  for (int idx = tid; idx < C * F; idx += kThreads) whs[idx] = bf(wh[idx]);
  for (int idx = tid; idx < ROWS * chunks; idx += kThreads) {
    const int r = idx / chunks, q = idx % chunks;
    reinterpret_cast<uint4*>(xs + r * LDW)[q] =
        reinterpret_cast<const uint4*>(x + (size_t(tile) * ROWS + r) * C)[q];
  }
  __syncthreads();

  const int ntiles = (ROWS / 16) * (C / 16);
  for (int i = 0; i < P; ++i) {
    // h_i = x @ We_i, f32 accumulators into shared memory
    const bf16* wei = wes + size_t(i) * C * LDW;
    for (int t = warp; t < ntiles; t += kWarps) {
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
    __syncthreads();

    // per row: h -> bf16, LN (f32 stats) -> z bf16, logits f32, argmax
    for (int r = warp; r < ROWS; r += kWarps) {
      float* hrow = hf + r * LDH;
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

}  // extern "C"
