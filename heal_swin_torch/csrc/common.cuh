// Shared helpers of the HEAL-SWIN Hopper kernels: bf16 rounding, warp reductions,
// shared-memory carving, the WMMA fragment types (bf16 inputs, f32 accumulation), and
// the cross-block passes and products the backward kernels share (reduce.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace hs {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
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

// --- mma.sync m16n8k16 from ldmatrix fragments, cp.async: the register-resident kernels
// (attention.cuh, reduce.cu gemm_nt)

constexpr int kCoreWarps = 4;                 // warps of one core (a "group")
constexpr int kCoreThreads = kCoreWarps * 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// the same, each matrix transposed: the B fragments of a row-major (k x n) tile
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d (16 x 8 f32) += a (16 x 16 bf16) b (16 x 8 bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// barrier of the 128 threads of core group ``id`` (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(kCoreThreads) : "memory");
}

// barrier of the `threads` threads (a multiple of 32) that name barrier ``id`` (>= 1)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// sum over the 4 lanes of a quad (the lanes holding one accumulator row); every lane
// gets the same bits
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the sum over a warp's 8 row groups (lanes of one lane % 4)
__device__ __forceinline__ float rows8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// (lo, hi) rounded to bf16 in one 32-bit word, lo in the low half
__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// A kernel's opt-in to `bytes` of dynamic shared memory (above 48 KB), once per device
// and process: `done` (one per kernel, a static of the launching entry) keeps a bit per
// device.  `bytes` is the most any launch of the kernel asks for, so one setting serves
// every shape and the host launch path makes no attribute call after the first.
inline cudaError_t smem_opt_in(const void* kernel, size_t bytes, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return e;
}

// the current device's SM count (132 on an H100 SXM where it cannot be read)
inline int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// --- cross-block passes (reduce.cu); deterministic: every sum in a fixed order ---

// out[n] = sum over r < R of in[r * N + n] (f32).  ``tmp`` holds
// reduce_rows_tmp_floats(R, N) floats.
size_t reduce_rows_tmp_floats(int R, int N);
cudaError_t reduce_rows(const float* in, float* out, int R, int N, float* tmp,
                        cudaStream_t stream);

// out (M x N, row-major f32) = A^T B over K rows: A (K x M) and B (K x N) row-major
// bf16, K % 64 == 0, M % 8 == 0, N % 8 == 0; split over K, then reduce_rows.
// ``tmp`` holds gemm_tn_tmp_floats(K, M, N) floats.
size_t gemm_tn_tmp_floats(int K, int M, int N);
cudaError_t gemm_tn(const bf16* A, const bf16* B, float* out, int K, int M, int N,
                    float* tmp, cudaStream_t stream);

// out (M x N, row-major bf16) = A B^T over K: A (M x K) and B (N x K) row-major bf16,
// f32 sums; M % 64 == 0, N % 8 == 0, K % 32 == 0, rows 16-byte aligned.
cudaError_t gemm_nt(const bf16* A, const bf16* B, bf16* out, int M, int N, int K,
                    cudaStream_t stream);

// the same for any K % 8 == 0 (and N % 8 == 0), the last 32-column slice zero-filled
cudaError_t gemm_nt_any_k(const bf16* A, const bf16* B, bf16* out, int M, int N, int K,
                          cudaStream_t stream);

}  // namespace hs
