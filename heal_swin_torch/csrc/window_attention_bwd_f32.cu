// Window attention backward of HEAL-SWIN for Hopper (sm_90a) in float32: the backwards of
// the f32 K1, K2 and K16 (window_attention_f32.cu), for f32 training without attention
// dropout (the JAX config default dtype None, and the paper configs at attn_drop_rate 0).
//
// Replaces, in f32, three Pallas TPU kernels of heal_swin_tpu/ops/window_attention.py:
//   K5 hs_window_attention_bwd_f32 <- _bwd_kernel (fused_window_attention's VJP, qkv f32):
//      attn_bwd_3xtf32_kernel on the given qkv rows, then reduce_rows of its partial
//      rows: dqkv (T, 3C), dbias (h, 64, 64), dlogit_scale (h).
//   K17 hs_window_attention_qkv_bwd_f32 <- _bwd_kernel_xw (fused_window_attention_qkv's
//      VJP, x f32): qkv = x Wqkv + b recomputed by the f32 K16's step 1
//      (gemm_3xtf32_kernel, K16's qkv bit for bit), the core, then dbias | dls and dbqkv
//      (column sums of dqkv) through reduce_rows, dWqkv = x^T dqkv (the wgmma core's TN
//      product, split over the tokens, reduce_rows) and dx = dqkv Wqkv^T (its NT product).
//   K4 hs_window_attention_qkv_epi_bwd_f32 <- _bwd_kernel_xw_epi (the VJP of
//      fused_window_attention_qkv_epi, x f32): a launch sequence from one entry, on one
//      stream: (1) the f32 K16, cosine: qkv and o, K1's bit for bit; (2) the projection /
//      LayerNorm backward: u = o Wp + bp recomputed through the f32 K1's step 3 (K1's u
//      bit for bit), then ln_bwd_rows_f32_kernel: the LayerNorm backward a warp a row on
//      the statistics of K1's ln_rows_f32 (ln_row_center), du and partial rows of dbp,
//      dgamma, dbeta for reduce_rows (without LayerNorm du = dz and dbp = reduce_rows of
//      dz); (3) dWp = o^T du (TN) and do = du Wp^T (NT), on the wgmma core; (4) the f32
//      K17 on (x, do), from step 1's qkv (the bits its own step 1 would compute).
//
// The products a backward alone computes (dWp, do, dWqkv, dx) run on the wgmma 3xTF32
// core of gemm_3xtf32_wgmma.cuh (gemm_3xtf32_wg_kernel: TMA, B split once a slice by a
// producer warpgroup); the recomputed qkv and u stay on the forward's own mma.sync
// product (gemm_nn_f32), so that they are the forward's bits.
//
// attn_bwd_3xtf32_kernel: grid (runs of kRunF windows, heads), one 4-warp block a run of
// one head, each warp 16 query rows and, for dK and dV, 16 keys.  Per window: the head's
// q, k, v rows and its dO slice by cp.async; for cosine K2's normalization
// (attn_f32_cos_rows) into a second pair of tiles, keeping the raw rows and each row's
// rsqrt for the normalization's backward; S = Q K^T (rows_x_rows_t) and the softmax
// (attn_f32_softmax), then P = e * (1 / sum): the forward's own functions, so that the
// backward differentiates the P the forward computed, row-max shift and all (not a
// static shift).  Then in registers dP = dO V^T, dS = P (dP - rowsum(dP P)) (a quad sum),
// dbias += dS, and dQ = dS K; P and dS go to 64 x 68 tiles, and after a barrier each
// warp takes 16 keys for dV = P^T dO and dK = dS^T Q (tile_t_x_rows).  Cosine: dQ and
// dK through the normalization's backward (the tangent projection, per-row dots as quad
// sums), dlogit_scale += <dQ, q_hat> per row; scaled-dot: sm_scale.  Every product is
// 3xTF32 on mma.sync (tf32.cuh); nothing rounds below f32.  dbias (32 registers a
// thread) and dls accumulate over the run and the block writes its slice of the run's
// partial row once; reduce_rows sums the runs in a fixed order.  No float atomics: two
// launches are bit-equal.  Shared memory 90,880 bytes (two blocks an SM).
//
// What bounds them.  The core does 40960 C FLOPs a window (the scores recomputed, dP,
// dQ, dV, dK: five 64 x 64 x 32 products a head) on 28 T C bytes (qkv and dout in,
// dqkv out): ~23 FLOP a byte, under the 3xTF32 ridge (164.9 TFLOPS over 3.35 TB/s,
// ~49): bounded by memory at K5's bottleneck shape (T 4,096, C 768: 88 MB, 0.026 ms a
// launch).  K17 adds the products 1152 C^2 FLOPs a window (the qkv recomputed, dWqkv,
// dx) and K4 1536 C^2 + 49152 C in all: above the ridge at C >= 96, bounded by the
// arithmetic.  In f32 the operands do not fit a block as the bf16 kernels' do (a 64 x C
// f32 tile at C 384 is 98,304 bytes), so every product is its own launch and the
// sequences move qkv, dqkv, o, u and do through device memory.

#include "attention_f32.cuh"
#include "gemm_3xtf32_wgmma.cuh"

namespace hs {
namespace {

constexpr int kRunF = 8;            // windows one core block walks
constexpr int LDP = WS + 4;         // the P and dS tiles' rows (floats)
constexpr int kBwdTile = WS * LDT;  // floats of a 64 x 32 tile
// raw q, k, v, dO; q_hat scale and k_hat (cosine); P, dS; the rows' rsqrt; group ids
constexpr size_t kBwdSmem = (6 * size_t(kBwdTile) + 2 * WS * LDP + 2 * WS + WS) * 4;

// the partial row of a run: [dbias (H x 64 x 64) | dls (H)]
__host__ __device__ inline size_t attn_part_width_f32(int H) { return size_t(H) * (WS * WS + 1); }

inline int bwd_runs(int T) { return (T / WS + kRunF - 1) / kRunF; }

template <bool COS>
__global__ void __launch_bounds__(kAttnThreads)
attn_bwd_3xtf32_kernel(const float* __restrict__ qkv, const int* __restrict__ groups,
                       const float* __restrict__ bias, const float* __restrict__ lscale,
                       const float* __restrict__ dout, float* __restrict__ dqkv,
                       float* __restrict__ part, int T, int C, int has_mask, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kAttnThreads / 32];
  float* qr = smem;
  float* kr = qr + kBwdTile;
  float* vr = kr + kBwdTile;
  float* dr = vr + kBwdTile;
  float* qn = dr + kBwdTile;
  float* kn = qn + kBwdTile;
  float* pt = kn + kBwdTile;
  float* dst = pt + WS * LDP;
  float* inv = dst + WS * LDP;  // rsqrt of q rows (0-63) and k rows (64-127)
  int* gs = reinterpret_cast<int*>(inv + 2 * WS);

  const int head = blockIdx.y, run = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, c = lane & 3;
  const int r0 = warp * 16;  // this warp's query rows, and its keys for dK and dV
  const int w0 = run * kRunF;
  const int n = min(kRunF, T / WS - w0);
  const int H = C / HD, C3 = 3 * C;
  const bool masked = has_mask != 0;
  const float scale = COS ? lscale[head] : 1.f;
  const float* bias_h = bias + size_t(head) * WS * WS;
  const float* qop = COS ? qn : qr;  // the score operands
  const float* kop = COS ? kn : kr;

  float dbias[WS / 8][4];
#pragma unroll
  for (int j = 0; j < WS / 8; ++j) dbias[j][0] = dbias[j][1] = dbias[j][2] = dbias[j][3] = 0.f;
  float dls = 0.f;

  for (int i = 0; i < n; ++i) {
    const size_t tok0 = size_t(w0 + i) * WS;
    __syncthreads();  // every warp is done with the previous window's tiles
    attn_f32_stage(qkv, groups, tok0, C, head, qr, kr, vr, gs, masked, tid);
    for (int idx = tid; idx < WS * 8; idx += kAttnThreads) {
      const int r = idx >> 3, ch = idx & 7;
      cp_async16(dr + r * LDT + ch * 4, dout + (tok0 + r) * C + head * HD + ch * 4);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (COS) {
      attn_f32_cos_rows(qr, kr, qn, kn, scale, inv, tid);
      __syncthreads();
    }

    // P, as the forward computes it
    float p[WS / 8][4];
    rows_x_rows_t(qop, kop, r0, g, c, p);
    float i0, i1;
    attn_f32_softmax(p, bias_h, gs, masked, COS, sm_scale, r0, g, c, i0, i1);
#pragma unroll
    for (int j = 0; j < WS / 8; ++j) {
      p[j][0] = __fmul_rn(p[j][0], i0);
      p[j][1] = __fmul_rn(p[j][1], i0);
      p[j][2] = __fmul_rn(p[j][2], i1);
      p[j][3] = __fmul_rn(p[j][3], i1);
    }
    // dP = dO V^T, then dS = P (dP - rowsum(dP P)) in place
    float ds[WS / 8][4];
    rows_x_rows_t(dr, vr, r0, g, c, ds);
    float t0 = 0.f, t1 = 0.f;
#pragma unroll
    for (int j = 0; j < WS / 8; ++j) {
      t0 += ds[j][0] * p[j][0] + ds[j][1] * p[j][1];
      t1 += ds[j][2] * p[j][2] + ds[j][3] * p[j][3];
    }
    t0 = quad_sum(t0);
    t1 = quad_sum(t1);
#pragma unroll
    for (int j = 0; j < WS / 8; ++j) {
      ds[j][0] = p[j][0] * (ds[j][0] - t0);
      ds[j][1] = p[j][1] * (ds[j][1] - t0);
      ds[j][2] = p[j][2] * (ds[j][2] - t1);
      ds[j][3] = p[j][3] * (ds[j][3] - t1);
#pragma unroll
      for (int e = 0; e < 4; ++e) dbias[j][e] += ds[j][e];
      const int col = 8 * j + 2 * c;
      *reinterpret_cast<float2*>(pt + (r0 + g) * LDP + col) = make_float2(p[j][0], p[j][1]);
      *reinterpret_cast<float2*>(pt + (r0 + g + 8) * LDP + col) = make_float2(p[j][2], p[j][3]);
      *reinterpret_cast<float2*>(dst + (r0 + g) * LDP + col) = make_float2(ds[j][0], ds[j][1]);
      *reinterpret_cast<float2*>(dst + (r0 + g + 8) * LDP + col) =
          make_float2(ds[j][2], ds[j][3]);
    }
    float dq[HD / 8][4];
    acc_x_rows(ds, kop, g, c, dq);  // dQ = dS K (k_hat for cosine)
    __syncthreads();                // the P and dS tiles are whole

    float dv[HD / 8][4], dk[HD / 8][4];
    tile_t_x_rows(pt, LDP, dr, r0, g, c, dv);   // dV = P^T dO, this warp's 16 keys
    tile_t_x_rows(dst, LDP, qop, r0, g, c, dk);  // dK = dS^T Q (q_hat scale for cosine)
    if constexpr (COS) {
      // q_hat = q uq, k_hat = k uk; dq = uq scale (a - q_hat <a, q_hat>), dk = uk (b -
      // k_hat <b, k_hat>); dls += <a, q_hat> a row
      const float uq0 = inv[r0 + g], uq1 = inv[r0 + g + 8];
      const float uk0 = inv[WS + r0 + g], uk1 = inv[WS + r0 + g + 8];
      float2 qh[HD / 8][2], kh[HD / 8][2];
      float rq0 = 0.f, rq1 = 0.f, rk0 = 0.f, rk1 = 0.f;
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn) {
        const int col = 8 * nn + 2 * c;
        const float2 q0 = *reinterpret_cast<const float2*>(qr + (r0 + g) * LDT + col);
        const float2 q1 = *reinterpret_cast<const float2*>(qr + (r0 + g + 8) * LDT + col);
        const float2 k0 = *reinterpret_cast<const float2*>(kr + (r0 + g) * LDT + col);
        const float2 k1 = *reinterpret_cast<const float2*>(kr + (r0 + g + 8) * LDT + col);
        qh[nn][0] = make_float2(__fmul_rn(q0.x, uq0), __fmul_rn(q0.y, uq0));
        qh[nn][1] = make_float2(__fmul_rn(q1.x, uq1), __fmul_rn(q1.y, uq1));
        kh[nn][0] = make_float2(__fmul_rn(k0.x, uk0), __fmul_rn(k0.y, uk0));
        kh[nn][1] = make_float2(__fmul_rn(k1.x, uk1), __fmul_rn(k1.y, uk1));
        rq0 += dq[nn][0] * qh[nn][0].x + dq[nn][1] * qh[nn][0].y;
        rq1 += dq[nn][2] * qh[nn][1].x + dq[nn][3] * qh[nn][1].y;
        rk0 += dk[nn][0] * kh[nn][0].x + dk[nn][1] * kh[nn][0].y;
        rk1 += dk[nn][2] * kh[nn][1].x + dk[nn][3] * kh[nn][1].y;
      }
      rq0 = quad_sum(rq0);
      rq1 = quad_sum(rq1);
      rk0 = quad_sum(rk0);
      rk1 = quad_sum(rk1);
      dls += rq0 + rq1;
      const float mq0 = uq0 * scale, mq1 = uq1 * scale;
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn) {
        dq[nn][0] = (dq[nn][0] - qh[nn][0].x * rq0) * mq0;
        dq[nn][1] = (dq[nn][1] - qh[nn][0].y * rq0) * mq0;
        dq[nn][2] = (dq[nn][2] - qh[nn][1].x * rq1) * mq1;
        dq[nn][3] = (dq[nn][3] - qh[nn][1].y * rq1) * mq1;
        dk[nn][0] = (dk[nn][0] - kh[nn][0].x * rk0) * uk0;
        dk[nn][1] = (dk[nn][1] - kh[nn][0].y * rk0) * uk0;
        dk[nn][2] = (dk[nn][2] - kh[nn][1].x * rk1) * uk1;
        dk[nn][3] = (dk[nn][3] - kh[nn][1].y * rk1) * uk1;
      }
    } else {
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dq[nn][e] *= sm_scale;
          dk[nn][e] *= sm_scale;
        }
    }
    // rows r0 + g and r0 + g + 8: dq of those queries, dk and dv of those keys
    float* row = dqkv + (tok0 + r0 + g) * C3 + head * HD + 2 * c;
#pragma unroll
    for (int nn = 0; nn < HD / 8; ++nn) {
      float* q0 = row + nn * 8;
      float* q1 = q0 + size_t(8) * C3;
      *reinterpret_cast<float2*>(q0) = make_float2(dq[nn][0], dq[nn][1]);
      *reinterpret_cast<float2*>(q1) = make_float2(dq[nn][2], dq[nn][3]);
      *reinterpret_cast<float2*>(q0 + C) = make_float2(dk[nn][0], dk[nn][1]);
      *reinterpret_cast<float2*>(q1 + C) = make_float2(dk[nn][2], dk[nn][3]);
      *reinterpret_cast<float2*>(q0 + 2 * C) = make_float2(dv[nn][0], dv[nn][1]);
      *reinterpret_cast<float2*>(q1 + 2 * C) = make_float2(dv[nn][2], dv[nn][3]);
    }
  }

  // this block's slice of the run's partial row (4-byte stores: the rows' width is odd
  // at odd H)
  float* prow = part + size_t(run) * attn_part_width_f32(H);
  float* pb = prow + size_t(head) * WS * WS;
#pragma unroll
  for (int j = 0; j < WS / 8; ++j) {
    const int col = 8 * j + 2 * c;
    pb[(r0 + g) * WS + col] = dbias[j][0];
    pb[(r0 + g) * WS + col + 1] = dbias[j][1];
    pb[(r0 + g + 8) * WS + col] = dbias[j][2];
    pb[(r0 + g + 8) * WS + col + 1] = dbias[j][3];
  }
  const float dl = warp_sum((lane & 3) == 0 ? dls : 0.f);  // each row's term once
  if (lane == 0) red[warp] = dl;
  __syncthreads();
  if (tid == 0) prow[size_t(H) * WS * WS + head] = red[0] + red[1] + red[2] + red[3];
}

// the core and reduce_rows of its partial rows into red ([dbias | dls]); part holds
// bwd_runs(T) attn_part_width_f32(H) floats, tmp reduce_rows' scratch
cudaError_t attn_bwd_f32(const float* qkv, const int* groups, const float* bias,
                         const float* lscale, const float* dout, float* dqkv, float* part,
                         float* red, float* tmp, int T, int C, bool use_cos, int has_mask,
                         float sm_scale, cudaStream_t s) {
  if (T % WS || T <= 0 || C % HD || C <= 0) return cudaErrorInvalidValue;
  static std::atomic<unsigned> done_cos{0}, done_dot{0};
  auto kernel = use_cos ? attn_bwd_3xtf32_kernel<true> : attn_bwd_3xtf32_kernel<false>;
  cudaError_t e = smem_opt_in(reinterpret_cast<const void*>(kernel), kBwdSmem,
                              use_cos ? done_cos : done_dot);
  if (e != cudaSuccess) return e;
  const int runs = bwd_runs(T);
  kernel<<<dim3(runs, C / HD), kAttnThreads, kBwdSmem, s>>>(
      qkv, groups, bias, lscale, dout, dqkv, part, T, C, has_mask, sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_rows(part, red, runs, int(attn_part_width_f32(C / HD)), tmp, s);
}

// ---------------------------------------------------------------------------------
// ln_bwd_rows_f32_kernel: the LayerNorm backward of u (T x C, C % 32 == 0, C <= 384), a
// warp a row, 8 rows a warp and 64 a block: the row's statistics as the f32 K1 takes
// them (ln_row_center), xhat, then du = rstd (dz gamma - mean(dz gamma) - xhat mean(dz
// gamma xhat)) written over u (du may be u), and the block's column sums of du (dbp),
// dz xhat (dgamma) and dz (dbeta) as one partial row [dbp | dgamma | dbeta], each
// column summed over the 8 warps in order.  Bounded by memory: 12 T C bytes.
// ---------------------------------------------------------------------------------
constexpr int kLnRows = 64;  // rows a block

__global__ void __launch_bounds__(kThreads)
ln_bwd_rows_f32_kernel(const float* u, const float* __restrict__ dz,
                       const float* __restrict__ gamma, float* du, float* __restrict__ part,
                       int C, float eps) {
  __shared__ float cols[kWarps * 3 * 32 * kLnMaxPer];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = C / 32;
  float sb[kLnMaxPer], sg[kLnMaxPer], sz[kLnMaxPer];
#pragma unroll
  for (int i = 0; i < kLnMaxPer; ++i) sb[i] = sg[i] = sz[i] = 0.f;
  for (int rr = 0; rr < kLnRows / kWarps; ++rr) {
    const size_t off = (size_t(blockIdx.x) * kLnRows + warp * (kLnRows / kWarps) + rr) * C;
    float v[kLnMaxPer], z[kLnMaxPer];
#pragma unroll
    for (int i = 0; i < kLnMaxPer; ++i)
      if (i < per) {
        v[i] = u[off + lane + 32 * i];
        z[i] = dz[off + lane + 32 * i];
      }
    const float rstd = ln_row_center(v, per, C, eps);
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < kLnMaxPer; ++i)
      if (i < per) {
        v[i] = __fmul_rn(v[i], rstd);  // xhat
        const float dg = z[i] * gamma[lane + 32 * i];
        a += dg;
        b += dg * v[i];
      }
    a = __fdiv_rn(warp_sum(a), float(C));
    b = __fdiv_rn(warp_sum(b), float(C));
#pragma unroll
    for (int i = 0; i < kLnMaxPer; ++i)
      if (i < per) {
        const float dg = z[i] * gamma[lane + 32 * i];
        const float d = rstd * (dg - a - v[i] * b);
        du[off + lane + 32 * i] = d;
        sb[i] += d;
        sg[i] += z[i] * v[i];
        sz[i] += z[i];
      }
  }
#pragma unroll
  for (int i = 0; i < kLnMaxPer; ++i)
    if (i < per) {
      float* cw = cols + warp * 3 * C + lane + 32 * i;
      cw[0] = sb[i];
      cw[C] = sg[i];
      cw[2 * C] = sz[i];
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 3 * C; idx += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += cols[w * 3 * C + idx];
    part[size_t(blockIdx.x) * 3 * C + idx] = s;
  }
}

inline size_t proj_ln_part_floats_f32(int T, int C) { return size_t(T / kLnRows) * 3 * C; }

inline size_t proj_ln_tmp_floats_f32(int T, int C) {
  const size_t a = reduce_rows_tmp_floats(T, C), b = reduce_rows_tmp_floats(T / kLnRows, 3 * C);
  return a > b ? a : b;
}

// K4's step 2: with LayerNorm u = o Wp + bp into du (the f32 K1's step 3), the row
// kernel (du in place), reduce_rows into red = [dbp | dgamma | dbeta]; without it du is
// dz (not written) and red = [dbp] = reduce_rows of dz
cudaError_t proj_ln_bwd_f32(const float* o, const float* wp, const float* bp, const float* ln_g,
                            const float* dz, float* du, float* part, float* red, float* tmp,
                            int T, int C, int has_ln, float eps, cudaStream_t s) {
  if (T % kLnRows || T <= 0 || C % 32 || C <= 0 || C > 32 * kLnMaxPer)
    return cudaErrorInvalidValue;
  if (!has_ln) return reduce_rows(dz, red, T, C, tmp, s);
  cudaError_t e = gemm_nn_f32(o, wp, bp, du, T, C, C, s);
  if (e != cudaSuccess) return e;
  ln_bwd_rows_f32_kernel<<<T / kLnRows, kThreads, 0, s>>>(du, dz, ln_g, du, part, C, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_rows(part, red, T / kLnRows, 3 * C, tmp, s);
}

// the workspace of the f32 K17: qkv and dqkv (T x 3C), the core's partial rows, and the
// reductions' and the TN product's scratch (its split-K partial rows and their
// reduction's; at least min_tmp floats)
struct QkvBwdF32Work {
  size_t qkv, dqkv, part, tmp, total;
};

inline QkvBwdF32Work qkv_bwd_f32_work(int T, int C, size_t min_tmp = 0) {
  QkvBwdF32Work w;
  const int runs = bwd_runs(T);
  const size_t W = attn_part_width_f32(C / HD);
  const size_t cand[4] = {reduce_rows_tmp_floats(runs, int(W)),
                          reduce_rows_tmp_floats(T, 3 * C), wg_tn_tmp_floats(T, C, 3 * C, 1),
                          min_tmp};
  size_t tmp = 0;
  for (size_t t : cand) tmp = t > tmp ? t : tmp;
  size_t off = 0;
  w.qkv = off; off += align128(size_t(T) * 3 * C * 4);
  w.dqkv = off; off += align128(size_t(T) * 3 * C * 4);
  w.part = off; off += align128(size_t(runs) * W * 4);
  w.tmp = off; off += align128(tmp * 4);
  w.total = off;
  return w;
}

// the f32 K17: (unless have_qkv: the workspace's qkv is already x Wqkv + b) qkv = x Wqkv
// + b, the core into red = [dbias | dls], dbqkv = reduce_rows of dqkv at red +
// attn_part_width_f32(H), dWqkv = x^T dqkv, dx = dqkv Wqkv^T
cudaError_t qkv_bwd_f32(const float* x, const float* wqkv, const float* bqkv, const int* groups,
                        const float* bias, const float* lscale, const float* dout, float* dx,
                        float* dwqkv, float* red, unsigned char* work, int T, int C,
                        bool use_cos, int has_mask, float sm_scale, bool have_qkv,
                        cudaStream_t s) {
  const QkvBwdF32Work w = qkv_bwd_f32_work(T, C);
  float* qkv = reinterpret_cast<float*>(work + w.qkv);
  float* dqkv = reinterpret_cast<float*>(work + w.dqkv);
  float* part = reinterpret_cast<float*>(work + w.part);
  float* tmp = reinterpret_cast<float*>(work + w.tmp);
  cudaError_t e = cudaSuccess;
  if (!have_qkv) e = gemm_nn_f32(x, wqkv, bqkv, qkv, T, 3 * C, C, s);
  if (e != cudaSuccess) return e;
  e = attn_bwd_f32(qkv, groups, bias, lscale, dout, dqkv, part, red, tmp, T, C, use_cos,
                   has_mask, sm_scale, s);
  if (e != cudaSuccess) return e;
  e = reduce_rows(dqkv, red + attn_part_width_f32(C / HD), T, 3 * C, tmp, s);
  if (e != cudaSuccess) return e;
  e = wg_tn(x, dqkv, nullptr, nullptr, dwqkv, T, C, 3 * C, 1, tmp, s);
  if (e != cudaSuccess) return e;
  return wg_nt<WgEpiStore<false>>(dqkv, wqkv, dx, nullptr, T, C, 3 * C, s);
}

// the workspace of the f32 K4: o, du (u first), do (T x C), step 2's partial rows, and
// the f32 K17's workspace, whose qkv is step 1's and whose scratch also serves step 2's
// reductions and the dWp product (the K17 scratch's offset does not depend on its size)
struct EpiBwdF32Work {
  size_t o, du, dout, part, k17, total;
};

inline EpiBwdF32Work epi_bwd_f32_work(int T, int C) {
  EpiBwdF32Work w;
  const size_t tile = align128(size_t(T) * C * 4);
  size_t off = 0;
  w.o = off; off += tile;
  w.du = off; off += tile;
  w.dout = off; off += tile;
  w.part = off; off += align128(proj_ln_part_floats_f32(T, C) * 4);
  const size_t a = proj_ln_tmp_floats_f32(T, C), b = wg_tn_tmp_floats(T, C, C, 1);
  w.k17 = off; off += qkv_bwd_f32_work(T, C, a > b ? a : b).total;
  w.total = off;
  return w;
}

// the token counts and widths the backwards take: whole windows and heads, and the wgmma
// core's products at them (dWqkv and dWp over K = T, dx over K = 3C, do over K = C; with
// T % 64 and C % 32 they always hold)
inline bool takes(int T, int C) {
  return T > 0 && T % WS == 0 && C > 0 && C % HD == 0 && wg_takes(C, 3 * C, T) &&
         wg_takes(T, C, 3 * C) && wg_takes(T, C, C);
}

}  // namespace
}  // namespace hs

extern "C" {

size_t hs_window_attention_bwd_f32_workspace(int T, int C) {
  const int runs = hs::bwd_runs(T);
  const size_t W = hs::attn_part_width_f32(C / hs::HD);
  return hs::align128(size_t(runs) * W * 4) +
         hs::align128(hs::reduce_rows_tmp_floats(runs, int(W)) * 4);
}

// f32 K5: dqkv (T, 3C) and red = [dbias (h x 64 x 64) | dls (h)] from f32 qkv rows and
// dout (T, C)
int hs_window_attention_bwd_f32(const void* qkv, const void* groups, const void* bias,
                                const void* lscale, const void* dout, void* dqkv, void* red,
                                void* work, int T, int C, int use_cos, int has_mask,
                                float sm_scale, void* stream) {
  if (!hs::takes(T, C)) return int(cudaErrorInvalidValue);
  const int runs = hs::bwd_runs(T);
  float* part = static_cast<float*>(work);
  float* tmp = reinterpret_cast<float*>(
      static_cast<unsigned char*>(work) +
      hs::align128(size_t(runs) * hs::attn_part_width_f32(C / hs::HD) * 4));
  return int(hs::attn_bwd_f32(static_cast<const float*>(qkv), static_cast<const int*>(groups),
                              static_cast<const float*>(bias), static_cast<const float*>(lscale),
                              static_cast<const float*>(dout), static_cast<float*>(dqkv), part,
                              static_cast<float*>(red), tmp, T, C, use_cos != 0, has_mask,
                              sm_scale, static_cast<cudaStream_t>(stream)));
}

size_t hs_window_attention_qkv_bwd_f32_workspace(int T, int C) {
  return hs::qkv_bwd_f32_work(T, C).total;
}

// f32 K17: dx (T, C), dWqkv (C, 3C) and red = [dbias | dls | dbqkv (3C)]
int hs_window_attention_qkv_bwd_f32(const void* x, const void* wqkv, const void* bqkv,
                                    const void* groups, const void* bias, const void* lscale,
                                    const void* dout, void* dx, void* dwqkv, void* red,
                                    void* work, int T, int C, int use_cos, int has_mask,
                                    float sm_scale, void* stream) {
  if (!hs::takes(T, C)) return int(cudaErrorInvalidValue);
  return int(hs::qkv_bwd_f32(
      static_cast<const float*>(x), static_cast<const float*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const int*>(groups),
      static_cast<const float*>(bias), static_cast<const float*>(lscale),
      static_cast<const float*>(dout), static_cast<float*>(dx), static_cast<float*>(dwqkv),
      static_cast<float*>(red), static_cast<unsigned char*>(work), T, C, use_cos != 0,
      has_mask, sm_scale, false, static_cast<cudaStream_t>(stream)));
}

size_t hs_window_attention_qkv_epi_bwd_f32_workspace(int T, int C) {
  return hs::epi_bwd_f32_work(T, C).total;
}

// f32 K4: the launch sequence (1) the f32 K16 cosine -> qkv, o; (2) the projection /
// LayerNorm backward -> du and [dbp | dgamma | dbeta] at red + attn_part_width_f32(h) +
// 3C; (3) dWp = o^T du, do = du Wp^T; (4) the f32 K17 cosine on (x, do) from step 1's
// qkv -> dx, dWqkv and [dbias | dls | dbqkv] at red
int hs_window_attention_qkv_epi_bwd_f32(const void* x, const void* wqkv, const void* bqkv,
                                        const void* wp, const void* bp, const void* ln_g,
                                        const void* ln_b, const void* groups, const void* bias,
                                        const void* lscale, const void* dz, void* dx,
                                        void* dwqkv, void* dwp, void* red, void* work, int T,
                                        int C, int has_ln, int has_mask, float ln_eps,
                                        void* stream) {
  (void)ln_b;  // beta does not enter the backward
  if (!hs::takes(T, C) || C > 32 * hs::kLnMaxPer) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const hs::EpiBwdF32Work w = hs::epi_bwd_f32_work(T, C);
  const hs::QkvBwdF32Work k = hs::qkv_bwd_f32_work(T, C);  // offsets within w.k17
  unsigned char* base = static_cast<unsigned char*>(work);
  float* o = reinterpret_cast<float*>(base + w.o);
  float* du = reinterpret_cast<float*>(base + w.du);
  float* dout = reinterpret_cast<float*>(base + w.dout);
  float* part = reinterpret_cast<float*>(base + w.part);
  float* qkv = reinterpret_cast<float*>(base + w.k17 + k.qkv);
  float* tmp = reinterpret_cast<float*>(base + w.k17 + k.tmp);
  float* redf = static_cast<float*>(red);
  const float* xf = static_cast<const float*>(x);
  const float* wq = static_cast<const float*>(wqkv);
  const float* wpf = static_cast<const float*>(wp);
  const int* g = static_cast<const int*>(groups);
  const float* bs = static_cast<const float*>(bias);
  const float* ls = static_cast<const float*>(lscale);
  const float* dzf = static_cast<const float*>(dz);

  cudaError_t e = hs::gemm_nn_f32(xf, wq, static_cast<const float*>(bqkv), qkv, T, 3 * C, C, s);
  if (e != cudaSuccess) return int(e);
  e = hs::attention_f32(qkv, g, bs, ls, o, T, C, 1, has_mask, 1.f, s);
  if (e != cudaSuccess) return int(e);
  e = hs::proj_ln_bwd_f32(o, wpf, static_cast<const float*>(bp), static_cast<const float*>(ln_g),
                          dzf, du, part, redf + hs::attn_part_width_f32(C / hs::HD) + 3 * C, tmp,
                          T, C, has_ln, ln_eps, s);
  if (e != cudaSuccess) return int(e);
  const float* dun = has_ln ? du : dzf;
  e = hs::wg_tn(o, dun, nullptr, nullptr, static_cast<float*>(dwp), T, C, C, 1, tmp, s);
  if (e != cudaSuccess) return int(e);
  e = hs::wg_nt<hs::WgEpiStore<false>>(dun, wpf, dout, nullptr, T, C, C, s);
  if (e != cudaSuccess) return int(e);
  return int(hs::qkv_bwd_f32(xf, wq, nullptr, g, bs, ls, dout, static_cast<float*>(dx),
                             static_cast<float*>(dwqkv), redf, base + w.k17, T, C, true,
                             has_mask, 1.f, true, s));
}

// step 2 of the f32 K4 alone, for its check against its plain version: du (not written
// without LayerNorm) and red = [dbp | dgamma | dbeta] (dbp alone)
size_t hs_proj_ln_bwd_f32_workspace(int T, int C) {
  return hs::align128(hs::proj_ln_part_floats_f32(T, C) * 4) +
         hs::align128(hs::proj_ln_tmp_floats_f32(T, C) * 4);
}

int hs_proj_ln_bwd_f32(const void* o, const void* wp, const void* bp, const void* ln_g,
                       const void* dz, void* du, void* red, void* work, int T, int C,
                       int has_ln, float ln_eps, void* stream) {
  float* part = static_cast<float*>(work);
  float* tmp = reinterpret_cast<float*>(static_cast<unsigned char*>(work) +
                                        hs::align128(hs::proj_ln_part_floats_f32(T, C) * 4));
  return int(hs::proj_ln_bwd_f32(
      static_cast<const float*>(o), static_cast<const float*>(wp), static_cast<const float*>(bp),
      static_cast<const float*>(ln_g), static_cast<const float*>(dz), static_cast<float*>(du),
      part, static_cast<float*>(red), tmp, T, C, has_ln, ln_eps,
      static_cast<cudaStream_t>(stream)));
}

// the f32 K17's and K4's NT product alone (the wgmma core's): out (M x N) = A (M x K)
// B (N x K)^T, f32, in 3xTF32; M % 4, K % 32, N % 4 == 0
int hs_gemm_nt_f32(const void* a, const void* b, void* out, int M, int N, int K, void* stream) {
  return int(hs::wg_nt<hs::WgEpiStore<false>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out),
      nullptr, M, N, K, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
