// Chamfer folds for Hopper (sm_90a): both nearest-neighbour minima of two f32 point
// clouds.
//
// Replaces two Pallas TPU kernels:
//   K10 chamfer_min_both   <- heal_swin_tpu/ops/chamfer.py _min_both_kernel (the brute
//       fold of every (p, q) pair, chamfer_distance_masked_pallas);
//   K11 chamfer_fold_pairs <- heal_swin_tpu/ops/chamfer_pruned.py
//       _packed_row_min_kernel (the same fold over the surviving (p-tile, q-tile)
//       pairs of 1024 x 1024 points, driven by _fold_rows).
//
// The contract is bit-equality of the per-point minima between K10, K11 and the plain
// versions: every distance is the difference form with one rounding per operation,
// d = (dx*dx + dy*dy) + dz*dz, dx = px - qx, written with the _rn intrinsics, which
// nvcc never contracts into an FMA.  A min is exact and takes no order, so any
// schedule of the folds gives the same bits.  Cross-block minima merge with
// atomicMin on the uint32 bits of the non-negative distance (the order of
// non-negative floats is that of their bits; +inf, 0x7f800000, above every finite
// value): exact, and the same on every run.
//
// Bound: operations, FP32 outside the tensor cores.  A pair costs 3 subtractions, 3
// multiplications and 2 additions (8 FLOP, none of which may fuse) plus the two
// min-folds.  The 67 TFLOP/s f32 peak counts an FMA as two FLOP, so 8 unfused
// operations take 8 issue slots a pair: the least time is 8 FLOP per pair over half
// that peak, 33.5 T operations/s, and the min-folds come on top.  Bytes are
// negligible: a block stages its q points once and reuses each for 1024 p rows.
//
// Design.  A block of 8 warps folds a rectangle of p rows against a chunk of q points
// staged in shared memory (coordinate-major, so lanes read neighbouring words).  It
// walks the rows 64 at a time: each warp holds 8 rows in registers, the same in every
// lane, and each lane 8 of the 256 columns of a q tile, so a thread folds an 8 x 8
// register tile, keeping its 8 row minima across the whole q chunk and merging its 8
// column minima into the block's shared column minima (shared atomicMin) per tile.
// After the chunk the row minima reduce over the lanes by shuffles and merge into the
// global minima; at the end the block merges its column minima.  Invalid rows and
// columns (beyond the valid counts: padding is masked by count, never by
// coordinate) enter the registers and the staged tile as +inf, whose distance to a
// valid point is +inf and never wins (and +inf - +inf = NaN, which fminf drops).
//   K10: grid (ceil(n / 1024), ceil(m / 2048)), a block folds 1024 rows x 2048 q.
//   K11: one block per pair of the list: the p tile's 1024 rows x the q tile's 1024
//        points, from the coordinate-major tile tables; an all-padding tile folds
//        nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace hs {
namespace {

constexpr int CT = 256;         // threads per block, 8 warps
constexpr int RW = 8;           // p rows per warp (registers, the same in every lane)
constexpr int SUB = 8 * RW;     // p rows per step of a block: 64
constexpr int CL = 8;           // q columns per lane per tile
constexpr int QT = 32 * CL;     // q columns per tile: 256
constexpr int QCHUNK = 2048;    // q points a block stages
constexpr int K10_ROWS = 1024;  // p rows per K10 block
constexpr int TILE = 1024;      // the pruned pipeline's tile (both sides)
constexpr unsigned INF_BITS = 0x7f800000u;

struct Stage {
  float x[QCHUNK], y[QCHUNK], z[QCHUNK];
  unsigned colmin[QCHUNK];
};

__device__ __forceinline__ float sq_dist(float px, float py, float pz, float qx, float qy,
                                         float qz) {
  const float dx = __fsub_rn(px, qx);
  const float dy = __fsub_rn(py, qy);
  const float dz = __fsub_rn(pz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// the bits atomicMin merges: distances are never negative; the clamp keeps a -0 out
__device__ __forceinline__ unsigned min_bits(float d) { return __float_as_uint(fmaxf(d, 0.f)); }

// stage q points [0, nq) (QLoad: j -> float3) and +inf up to the last 256-wide tile;
// column minima start at +inf
template <class QLoad>
__device__ void stage_q(Stage& s, int nq, const QLoad& qload) {
  const int end = (nq + QT - 1) / QT * QT;
  for (int j = threadIdx.x; j < end; j += CT) {
    float3 v = make_float3(__int_as_float(INF_BITS), __int_as_float(INF_BITS),
                           __int_as_float(INF_BITS));
    if (j < nq) v = qload(j);
    s.x[j] = v.x;
    s.y[j] = v.y;
    s.z[j] = v.z;
    s.colmin[j] = INF_BITS;
  }
}

// fold p rows [0, np) (PLoad: r -> float3) against the nq staged q points: row minima
// into pmin[r] (global), column minima into s.colmin
template <class PLoad>
__device__ void fold_rows(Stage& s, int np, int nq, const PLoad& pload, unsigned* pmin) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ntiles = (nq + QT - 1) / QT;
  const float inf = __int_as_float(INF_BITS);
  for (int r0 = 0; r0 < np; r0 += SUB) {
    const int rw = r0 + warp * RW;  // this warp's first row
    float px[RW], py[RW], pz[RW], rm[RW];
#pragma unroll
    for (int k = 0; k < RW; ++k) {
      float3 v = make_float3(inf, inf, inf);
      if (rw + k < np) v = pload(rw + k);
      px[k] = v.x;
      py[k] = v.y;
      pz[k] = v.z;
      rm[k] = inf;
    }
    for (int t = 0; t < ntiles; ++t) {
      float qx[CL], qy[CL], qz[CL], cm[CL];
#pragma unroll
      for (int c = 0; c < CL; ++c) {
        const int j = t * QT + c * 32 + lane;
        qx[c] = s.x[j];
        qy[c] = s.y[j];
        qz[c] = s.z[j];
        cm[c] = inf;
      }
#pragma unroll
      for (int k = 0; k < RW; ++k) {
#pragma unroll
        for (int c = 0; c < CL; ++c) {
          const float d = sq_dist(px[k], py[k], pz[k], qx[c], qy[c], qz[c]);
          rm[k] = fminf(rm[k], d);
          cm[c] = fminf(cm[c], d);
        }
      }
#pragma unroll
      for (int c = 0; c < CL; ++c)
        if (cm[c] < inf) atomicMin(&s.colmin[t * QT + c * 32 + lane], min_bits(cm[c]));
    }
#pragma unroll
    for (int k = 0; k < RW; ++k) {
      float v = rm[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (lane == k && rw + k < np && v < inf) atomicMin(&pmin[rw + k], min_bits(v));
    }
  }
}

// merge the block's column minima into qmin[j], j < nq
__device__ void flush_cols(const Stage& s, int nq, unsigned* qmin) {
  for (int j = threadIdx.x; j < nq; j += CT)
    if (s.colmin[j] != INF_BITS) atomicMin(&qmin[j], s.colmin[j]);
}

__global__ void __launch_bounds__(CT, 2)
chamfer_min_both_kernel(const float* __restrict__ p, const float* __restrict__ q,
                        unsigned* __restrict__ pmin, unsigned* __restrict__ qmin, int n,
                        int m) {
  __shared__ Stage s;
  const int p0 = blockIdx.x * K10_ROWS;
  const int q0 = blockIdx.y * QCHUNK;
  const int np = min(K10_ROWS, n - p0);
  const int nq = min(QCHUNK, m - q0);
  stage_q(s, nq, [&](int j) {
    const float* a = q + 3 * size_t(q0 + j);
    return make_float3(a[0], a[1], a[2]);
  });
  __syncthreads();
  fold_rows(s, np, nq, [&](int r) {
    const float* a = p + 3 * size_t(p0 + r);
    return make_float3(a[0], a[1], a[2]);
  }, pmin + p0);
  __syncthreads();
  flush_cols(s, nq, qmin + q0);
}

__global__ void __launch_bounds__(CT, 2)
chamfer_fold_pairs_kernel(const int* __restrict__ pairs, const float* __restrict__ ptab,
                          const float* __restrict__ qtab, unsigned* __restrict__ pmin,
                          unsigned* __restrict__ qmin, int n, int m) {
  __shared__ Stage s;
  const int pt = pairs[2 * blockIdx.x];
  const int qt = pairs[2 * blockIdx.x + 1];
  const int np = min(TILE, n - pt * TILE);
  const int nq = min(TILE, m - qt * TILE);
  if (np <= 0 || nq <= 0) return;  // an all-padding tile: nothing to fold
  const float* pb = ptab + size_t(pt) * 3 * TILE;
  const float* qb = qtab + size_t(qt) * 3 * TILE;
  stage_q(s, nq, [&](int j) { return make_float3(qb[j], qb[TILE + j], qb[2 * TILE + j]); });
  __syncthreads();
  fold_rows(s, np, nq, [&](int r) {
    return make_float3(pb[r], pb[TILE + r], pb[2 * TILE + r]);
  }, pmin + size_t(pt) * TILE);
  __syncthreads();
  flush_cols(s, nq, qmin + size_t(qt) * TILE);
}

}  // namespace
}  // namespace hs

extern "C" {

// K10: p (N, 3) and q (M, 3) f32 row-major, their first n and m points valid; pmin
// (>= n) and qmin (>= m) f32 hold +inf (or earlier minima) and take the minima.
int hs_chamfer_min_both(const void* p, const void* q, void* pmin, void* qmin, int n, int m,
                        void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const dim3 grid((n + hs::K10_ROWS - 1) / hs::K10_ROWS, (m + hs::QCHUNK - 1) / hs::QCHUNK);
  hs::chamfer_min_both_kernel<<<grid, hs::CT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(q),
      static_cast<unsigned*>(pmin), static_cast<unsigned*>(qmin), n, m);
  return static_cast<int>(cudaGetLastError());
}

// K11: pairs (k, 2) int32 (p tile, q tile); ptab / qtab (tiles, 3, 1024) f32; the
// first n / m sorted points valid; pmin / qmin (tiles * 1024) f32, updated in place.
int hs_chamfer_fold_pairs(const void* pairs, int k, const void* ptab, const void* qtab,
                          void* pmin, void* qmin, int n, int m, void* stream) {
  if (k <= 0) return 0;
  hs::chamfer_fold_pairs_kernel<<<k, hs::CT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pairs), static_cast<const float*>(ptab),
      static_cast<const float*>(qtab), static_cast<unsigned*>(pmin),
      static_cast<unsigned*>(qmin), n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
