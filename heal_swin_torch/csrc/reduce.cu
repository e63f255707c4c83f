// Cross-block passes of the HEAL-SWIN backward kernels for Hopper (sm_90a).
//
// The Pallas backward kernels (heal_swin_tpu/ops/window_attention.py
// _bwd_kernel_xw_epi / _bwd_kernel, heal_swin_tpu/ops/final_head.py _bwd_kernel and
// _fwd_kernel) accumulate parameter gradients and loss sums in output blocks that every
// step of their sequential grid adds to.  Blocks of a CUDA grid run in no order, so
// the port's kernels write per-block partial rows instead, and these passes reduce
// them, every sum in a fixed order (the results do not change from run to run):
//
//   reduce_rows: out[n] = sum_r in[r, n]; one block sums 32 columns over a run of
//     rows, one warp per row stride; at most two passes (R / 64 rows per split, then
//     the <= 64 split rows).  Bounded by reading the partials once (bandwidth).
//   gemm_tn: out = A^T B over the token axis (dW = x^T dqkv, dWp = o^T du,
//     dWe = x^T dh), the products the Pallas kernels accumulate across their grid.
//     K is the token count (up to 262144) while M, N <= 1152, so it splits K into
//     2048-token chunks (<= 128 splits), each block a 64 x 64 output tile of one
//     chunk: 32 x 64 bf16 tiles of A and B staged through shared memory with 16-byte
//     loads, 16x16x16 bf16 WMMA with f32 accumulation; the split partials then go
//     through reduce_rows.  At the paper shapes it is 2*T*M*N = 2.9..14.5 GFLOP on
//     T*(M+N)*2 bytes: above the bf16 ridge, so it is bounded by the WMMA issue rate;
//     wgmma/TMA are later work.

#include "common.cuh"

namespace hs {
namespace {

constexpr int RED_SPLITS = 64;  // row splits of a reduction's first pass

// grid (ceil(N / 32), S): block (bx, by) sums rows [by * rps, min(R, (by + 1) * rps))
// of columns bx * 32 .. + 31 into out[by * N + col]
__global__ void __launch_bounds__(kThreads)
reduce_rows_kernel(const float* __restrict__ in, float* __restrict__ out, int R, int N,
                   int rps) {
  __shared__ float part[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * 32 + lane;
  const int r0 = blockIdx.y * rps;
  const int r1 = min(R, r0 + rps);
  float acc = 0.f;
  if (col < N)
    for (int r = r0 + warp; r < r1; r += kWarps) acc += in[size_t(r) * N + col];
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < N) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][lane];
    out[size_t(blockIdx.y) * N + col] = s;
  }
}

constexpr int GT = 64;          // output tile (GT x GT)
constexpr int GK = 32;          // tokens per staged step
constexpr int LDG = GT + 8;     // staged tile leading dimension (bf16)
constexpr int GEMM_CHUNK = 2048;
constexpr int GEMM_MAX_SPLITS = 128;

int gemm_splits(int K) {
  const int s = (K + GEMM_CHUNK - 1) / GEMM_CHUNK;
  return s < GEMM_MAX_SPLITS ? s : GEMM_MAX_SPLITS;
}

// grid (ceil(M / 64), ceil(N / 64), splits): part[z] (M x N) = A[k0:k1]^T B[k0:k1]
__global__ void __launch_bounds__(kThreads)
gemm_tn_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
               float* __restrict__ part, int K, int M, int N, int chunk) {
  __shared__ __align__(128) bf16 As[GK * LDG];
  __shared__ __align__(128) bf16 Bs[GK * LDG];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * GT;
  const int n0 = blockIdx.y * GT;
  const int k0 = blockIdx.z * chunk;
  const int k1 = min(K, k0 + chunk);
  const int rt = warp >> 1;        // output row tile 0..3
  const int ct0 = (warp & 1) * 2;  // output column tiles ct0, ct0 + 1
  FragC acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  // each thread stages one 16-byte chunk of A and of B per step (32 rows x 8 chunks);
  // M and N are multiples of 16, so a chunk is wholly inside or wholly outside
  const int lr = tid >> 3;
  const int lc = (tid & 7) * 8;
  for (int k = k0; k < k1; k += GK) {
    uint4 va = make_uint4(0, 0, 0, 0);
    uint4 vb = va;
    if (m0 + lc < M) va = *reinterpret_cast<const uint4*>(A + size_t(k + lr) * M + m0 + lc);
    if (n0 + lc < N) vb = *reinterpret_cast<const uint4*>(B + size_t(k + lr) * N + n0 + lc);
    *reinterpret_cast<uint4*>(As + lr * LDG + lc) = va;
    *reinterpret_cast<uint4*>(Bs + lr * LDG + lc) = vb;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
      FragAt a;  // A^T tile: element (m, k) at As[k * LDG + m]
      wmma::load_matrix_sync(a, As + kk * LDG + rt * 16, LDG);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, Bs + kk * LDG + (ct0 + j) * 16, LDG);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }
  float* out = part + size_t(blockIdx.z) * M * N;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = m0 + rt * 16;
    const int n = n0 + (ct0 + j) * 16;
    if (m < M && n < N)
      wmma::store_matrix_sync(out + size_t(m) * N + n, acc[j], N, wmma::mem_row_major);
  }
}

}  // namespace

size_t reduce_rows_tmp_floats(int R, int N) {
  if (R <= RED_SPLITS) return 0;
  const int rps = (R + RED_SPLITS - 1) / RED_SPLITS;
  return size_t((R + rps - 1) / rps) * N;
}

cudaError_t reduce_rows(const float* in, float* out, int R, int N, float* tmp,
                        cudaStream_t stream) {
  const int gx = (N + 31) / 32;
  if (R <= RED_SPLITS) {
    reduce_rows_kernel<<<dim3(gx, 1), kThreads, 0, stream>>>(in, out, R, N, R);
    return cudaGetLastError();
  }
  const int rps = (R + RED_SPLITS - 1) / RED_SPLITS;
  const int S = (R + rps - 1) / rps;
  reduce_rows_kernel<<<dim3(gx, S), kThreads, 0, stream>>>(in, tmp, R, N, rps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  reduce_rows_kernel<<<dim3(gx, 1), kThreads, 0, stream>>>(tmp, out, S, N, S);
  return cudaGetLastError();
}

size_t gemm_tn_tmp_floats(int K, int M, int N) {
  const int S = gemm_splits(K);
  return size_t(S) * M * N + reduce_rows_tmp_floats(S, M * N);
}

cudaError_t gemm_tn(const bf16* A, const bf16* B, float* out, int K, int M, int N,
                    float* tmp, cudaStream_t stream) {
  const int S = gemm_splits(K);
  int chunk = (K + S - 1) / S;
  chunk = (chunk + GK - 1) / GK * GK;  // an empty last split writes zeros
  const dim3 grid((M + GT - 1) / GT, (N + GT - 1) / GT, S);
  gemm_tn_kernel<<<grid, kThreads, 0, stream>>>(A, B, tmp, K, M, N, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_rows(tmp, out, S, M * N, tmp + size_t(S) * M * N, stream);
}

}  // namespace hs
