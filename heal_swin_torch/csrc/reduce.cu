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
//   gemm_nt: out = A B^T over the channel axis (K17's dx = dqkv Wqkv^T, K4's do =
//     du Wp^T), bf16 out.  M is the token count, N = C and K = 3C or C, so the output
//     tiles are many (M / 128 x N / 96) and K is short: no split.  A block is one 4-warp
//     core over a 128 x 96 tile; 32-column slices of A and B arrive by cp.async through
//     a 3-stage ring (one block barrier a slice), each warp runs mma.sync m16n8k16 from
//     ldmatrix fragments on its 32 rows x 12 n-tiles (each B fragment serves two
//     m-tiles, which halves the shared-memory reads per product) with f32 sums in
//     registers, and rounds them to bf16 on the way out.  2 M N K FLOPs on 2 (M K + N K
//     + M N) bytes: at the paper shapes above the bf16 ridge, bounded by the mma.sync
//     issue rate.

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
  __shared__ __align__(128) float edge[kWarps][256];  // a partial output tile's staging
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
  // M and N are multiples of 8, so a chunk is wholly inside or wholly outside
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
    if (m + 16 <= M && n + 16 <= N) {
      wmma::store_matrix_sync(out + size_t(m) * N + n, acc[j], N, wmma::mem_row_major);
    } else if (m < M && n < N) {  // M or N % 16 == 8: the tile's rows / columns that exist
      wmma::store_matrix_sync(edge[warp], acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      const int lane = tid & 31;
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = e & 15;
        if (m + r < M && n + c < N) out[size_t(m + r) * N + n + c] = edge[warp][e];
      }
      __syncwarp();
    }
  }
}

constexpr int NT_WM = 2;                  // m-tiles (16 rows) of a warp
constexpr int NT_BM = kCoreWarps * NT_WM * 16;  // output rows of a block (128)
constexpr int NT_BN = 96;                 // output columns of a block (12 n-tiles)
constexpr int NT_BK = 32;                 // K columns of a ring stage
constexpr int NT_LD = NT_BK + 8;          // staged rows: ldmatrix phases conflict-free
constexpr int NT_STAGES = 3;
constexpr size_t kGemmNtSmem = size_t(NT_STAGES) * (NT_BM + NT_BN) * NT_LD * 2;

// grid (ceil(M / 128), ceil(N / 96)): out[m0:m0+128, n0:n0+96] = A[m0:m0+128] B[n0:n0+96]^T;
// M % 64 == 0, so a block has 128 rows or, at the end, 64 (warps 2-3 then only copy).
// KTAIL: K % 8 == 0 only, the last 32-column slice zero-filled past K (the decoder tail's
// wide route, K = C or p C)
template <bool KTAIL>
__global__ void __launch_bounds__(kCoreThreads)
gemm_nt_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, bf16* __restrict__ out,
               int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + NT_STAGES * NT_BM * NT_LD;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * NT_WM * 16;
  const int m0 = blockIdx.x * NT_BM;
  const int n0 = blockIdx.y * NT_BN;
  const int rows_a = min(NT_BM, M - m0);
  const int rows_b = min(NT_BN, N - n0);  // B rows (output columns) of this block
  const int nt = rows_b / 8;
  const int nk = KTAIL ? (K + NT_BK - 1) / NT_BK : K / NT_BK;
  const bool active = row0 < rows_a;

  auto stage = [&](int k) {  // slice k into its ring stage; the caller commits
    if (k >= nk) return;
    bf16* as = As + (k % NT_STAGES) * NT_BM * NT_LD;
    bf16* bs = Bs + (k % NT_STAGES) * NT_BN * NT_LD;
    const int k0 = k * NT_BK;
    for (int idx = tid; idx < rows_a * 4; idx += kCoreThreads) {
      const int r = idx >> 2, c = (idx & 3) * 8;
      if (!KTAIL || k0 + c < K) cp_async16(as + r * NT_LD + c, A + size_t(m0 + r) * K + k0 + c);
      else *reinterpret_cast<uint4*>(as + r * NT_LD + c) = make_uint4(0, 0, 0, 0);
    }
    for (int idx = tid; idx < rows_b * 4; idx += kCoreThreads) {
      const int r = idx >> 2, c = (idx & 3) * 8;
      if (!KTAIL || k0 + c < K) cp_async16(bs + r * NT_LD + c, B + size_t(n0 + r) * K + k0 + c);
      else *reinterpret_cast<uint4*>(bs + r * NT_LD + c) = make_uint4(0, 0, 0, 0);
    }
  };

  float acc[NT_WM][NT_BN / 8][4];
#pragma unroll
  for (int i = 0; i < NT_WM; ++i)
#pragma unroll
    for (int t = 0; t < NT_BN / 8; ++t) acc[i][t][0] = acc[i][t][1] = acc[i][t][2] = acc[i][t][3] = 0.f;
  for (int k = 0; k < NT_STAGES - 1; ++k) {
    stage(k);
    cp_async_commit();
  }
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<NT_STAGES - 2>();
    __syncthreads();  // slice k has landed; slice k - 1's stage is free
    stage(k + NT_STAGES - 1);
    cp_async_commit();
    if (!active) continue;
    const bf16* as = As + (k % NT_STAGES) * NT_BM * NT_LD + (row0 + (lane & 15)) * NT_LD +
                     (lane >> 4) * 8;
    const bf16* bs = Bs + (k % NT_STAGES) * NT_BN * NT_LD + (lane & 7) * NT_LD + (lane >> 3) * 8;
    uint32_t a[NT_WM][2][4];  // m-tile i, k-step j
#pragma unroll
    for (int i = 0; i < NT_WM; ++i) {
      ldsm_x4(a[i][0], as + i * 16 * NT_LD);
      ldsm_x4(a[i][1], as + i * 16 * NT_LD + 16);
    }
#pragma unroll
    for (int t = 0; t < NT_BN / 8; ++t) {
      if (t < nt) {
        uint32_t b[4];  // n-tile t: K columns 0-7, 8-15 (k-step 0), 16-23, 24-31
        ldsm_x4(b, bs + t * 8 * NT_LD);
#pragma unroll
        for (int i = 0; i < NT_WM; ++i) {
          mma_bf16(acc[i][t], a[i][0], b[0], b[1]);
          mma_bf16(acc[i][t], a[i][1], b[2], b[3]);
        }
      }
    }
  }
  if (!active) return;
  const int c2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < NT_WM; ++i) {
    const size_t r0 = size_t(m0 + row0 + i * 16 + (lane >> 2));
#pragma unroll
    for (int t = 0; t < NT_BN / 8; ++t) {
      if (t < nt) {
        const int c = n0 + 8 * t + c2;
        *reinterpret_cast<uint32_t*>(out + r0 * N + c) = pack_bf2(acc[i][t][0], acc[i][t][1]);
        *reinterpret_cast<uint32_t*>(out + (r0 + 8) * N + c) = pack_bf2(acc[i][t][2], acc[i][t][3]);
      }
    }
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

template <bool KTAIL>
cudaError_t gemm_nt_launch(const bf16* A, const bf16* B, bf16* out, int M, int N, int K,
                           cudaStream_t stream) {
  static std::atomic<unsigned> done{0};
  cudaError_t e =
      smem_opt_in(reinterpret_cast<const void*>(gemm_nt_kernel<KTAIL>), kGemmNtSmem, done);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + NT_BM - 1) / NT_BM, (N + NT_BN - 1) / NT_BN);
  gemm_nt_kernel<KTAIL><<<grid, kCoreThreads, kGemmNtSmem, stream>>>(A, B, out, M, N, K);
  return cudaGetLastError();
}

cudaError_t gemm_nt(const bf16* A, const bf16* B, bf16* out, int M, int N, int K,
                    cudaStream_t stream) {
  return gemm_nt_launch<false>(A, B, out, M, N, K, stream);
}

cudaError_t gemm_nt_any_k(const bf16* A, const bf16* B, bf16* out, int M, int N, int K,
                          cudaStream_t stream) {
  if (M % 64 || N % 8 || K % 8 || M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  return gemm_nt_launch<true>(A, B, out, M, N, K, stream);
}

}  // namespace hs

extern "C" {

// out (N f32) = the sum over R rows of in (R x N f32) in a fixed order; work holds
// hs_reduce_rows_workspace bytes
size_t hs_reduce_rows_workspace(int R, int N) { return hs::reduce_rows_tmp_floats(R, N) * 4; }

int hs_reduce_rows(const void* in, void* out, void* work, int R, int N, void* stream) {
  return int(hs::reduce_rows(static_cast<const float*>(in), static_cast<float*>(out), R, N,
                             static_cast<float*>(work), static_cast<cudaStream_t>(stream)));
}

// out (M x N f32) = A^T B over K rows: A (K x M), B (K x N) bf16; the wrapper checks the
// shapes; work holds hs_gemm_tn_workspace bytes
size_t hs_gemm_tn_workspace(int K, int M, int N) { return hs::gemm_tn_tmp_floats(K, M, N) * 4; }

int hs_gemm_tn(const void* A, const void* B, void* out, void* work, int K, int M, int N,
               void* stream) {
  return int(hs::gemm_tn(static_cast<const hs::bf16*>(A), static_cast<const hs::bf16*>(B),
                         static_cast<float*>(out), K, M, N, static_cast<float*>(work),
                         static_cast<cudaStream_t>(stream)));
}

// out (M x N bf16) = A (M x K) B (N x K)^T; the wrapper checks the shapes
int hs_gemm_nt(const void* A, const void* B, void* out, int M, int N, int K, void* stream) {
  return int(hs::gemm_nt(static_cast<const hs::bf16*>(A), static_cast<const hs::bf16*>(B),
                         static_cast<hs::bf16*>(out), M, N, K, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
