// Shared helpers of the HEAL-SWIN Hopper kernels: bf16 rounding, warp reductions,
// shared-memory carving, the WMMA fragment types (bf16 inputs, f32 accumulation), and
// the two cross-block passes the backward kernels share (reduce.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

namespace hs {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kThreads = 256;  // 8 warps per block in every kernel
constexpr int kWarps = kThreads / 32;

// window attention geometry (the kernels' fixed window size and head dim)
constexpr int WS = 64;  // tokens per window
constexpr int HD = 32;  // head dim (one lane per head channel)
constexpr float MASK_VALUE = -100.f;

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~size_t(127); }

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf(float v) { return __float2bfloat16_rn(v); }
// round-to-nearest-even through bf16 and back: the kernels' rounding points
__device__ __forceinline__ float bfr(float v) { return bf(to_bf(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// --- cross-block passes (reduce.cu); deterministic: every sum in a fixed order ---

// out[n] = sum over r < R of in[r * N + n] (f32).  ``tmp`` holds
// reduce_rows_tmp_floats(R, N) floats.
size_t reduce_rows_tmp_floats(int R, int N);
cudaError_t reduce_rows(const float* in, float* out, int R, int N, float* tmp,
                        cudaStream_t stream);

// out (M x N, row-major f32) = A^T B over K rows: A (K x M) and B (K x N) row-major
// bf16, K % 64 == 0, M % 16 == 0, N % 16 == 0; split over K, then reduce_rows.
// ``tmp`` holds gemm_tn_tmp_floats(K, M, N) floats.
size_t gemm_tn_tmp_floats(int K, int M, int N);
cudaError_t gemm_tn(const bf16* A, const bf16* B, float* out, int K, int M, int N,
                    float* tmp, cudaStream_t stream);

}  // namespace hs
