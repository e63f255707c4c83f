// Window attention backward of HEAL-SWIN for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of heal_swin_tpu/ops/window_attention.py, all on
// one register-resident backward core (qkv_bwd_kernel, described at the kernel):
//   K17 hs_window_attention_qkv_bwd <- _bwd_kernel_xw, the backward of K16 (x @ Wqkv
//      + b -> attention, cosine or scaled-dot): qkv_bwd_kernel<COS, false>, one 4-warp
//      block per head and run of kRun windows, which recomputes the head's qkv from x;
//      then reduce_rows over the runs' partial rows, dWqkv = x^T dqkv (split-K gemm_tn
//      over the tokens) and dx = dqkv Wqkv^T (gemm_nt), both in reduce.cu.  Per window
//      1152*C^2 + 40960*C FLOPs (the qkv products, then five 64x64x32 products per head:
//      QK^T recomputed, dv, dp, dq, dk): near or above the bf16 ridge.
//   K5 hs_window_attention_bwd <- _bwd_kernel (_attn_bwd_body_cos_wide for cosine,
//      _attn_bwd_body for scaled-dot), the backward of K2: qkv_bwd_kernel<COS, true>,
//      the same core with the head's q|k|v slices of the qkv rows copied in by cp.async
//      in place of the projection, K2's probabilities recomputed through K2's own
//      functions (load_q_frags, cos_q_frags, cos_k_frag, head_probs_mma), dq|dk|dv rows
//      out; then reduce_rows.  40960 FLOPs per (window, head) on 16 KB in and out: bound
//      by memory and latency, not by the tensor cores.
//   K4 hs_window_attention_qkv_epi_bwd <- _bwd_kernel_xw_epi, the backward of K1 (x @
//      Wqkv + b -> cosine attention -> @ Wp + bp -> optional LayerNorm): a launch
//      sequence from one entry, on one stream: (1) o = K16 cosine on x (qkv_attention:
//      K1's head loop, so K1's o bit for bit); (2) proj_ln_bwd_kernel: u = o Wp + bp
//      recomputed through K1's weight ring (K1's u bit for bit), the LayerNorm backward
//      in registers, du in bf16 and per-block partials of dbp, dgamma, dbeta for
//      reduce_rows; (3) dWp = o^T du (gemm_tn) and do = bf16(du Wp^T) (gemm_nt); (4) K17
//      cosine on (x, do).  1536*C^2 + 49152*C FLOPs per window in all.
//
// What bounds them on this card, and what the designs do about it:
// - The products are near or above the bf16 ridge at C >= 96, so what bounds them is
//   how the tensor cores are fed: mma.sync from ldmatrix fragments, scores,
//   probabilities, dP, dS and dQ in registers, operands staged by cp.async while the
//   previous window runs, resident weights (K17's Wqkv strips) or K1's weight ring.
// - The parameter gradients, which the TPU kernels accumulate across their sequential
//   grid, become per-block partial rows summed in a fixed order by reduce_rows, and
//   split-K products (gemm_tn): no float atomics, so results do not change from run to
//   run.  A block walks a run of windows and writes its partials once.
// - Each backward recomputes its forward through the forward's own functions (K1/K16's
//   qkv_head_epilogue, K2's cos_q_frags / cos_k_frag, head_probs_mma, K1's gemm_rows),
//   so that it differentiates the probabilities and the projection output the forward
//   computed, bit for bit, and not a function one rounding away.
// - bf16 rounding at the Pallas backward's points: qkv; (q/|q|)*scale and k/|k|; p
//   before dv; ds before the q/k products; du before dWp and do; do; dqkv before dx and
//   dW.  wgmma/TMA pipelines are later work.

#include "attention.cuh"

namespace hs {
namespace {

// the partial row of K5's blocks: [dbias (H x 64 x 64) | dls (H)]
__host__ __device__ inline size_t attn_part_width(int H) { return size_t(H) * (WS * WS + 1); }

// ---------------------------------------------------------------------------------
// K17 and K5: grid (runs of kRun consecutive windows, heads); one core (4 warps, each
// owning 16 rows) per block.  Per window:
// - K17: the head's q|k|v column strips of Wqkv (C x 96 bf16) and its 64 x 64 bias are
//   loaded once per block and stay in shared memory for the run; the x tile and this
//   head's 64 x 32 slice of dout arrive by cp.async; x is free once projected, so the
//   next window's x (and group ids) are copied while this one runs its backward, and
//   the next dout slice once dV has read this one.  Each warp projects its 16 rows
//   (mma.sync from ldmatrix fragments, ascending 16-wide k-steps, as K1 and K16 do) and
//   runs qkv_head_epilogue: the forward's q, k, v, bit for bit.
// - K5 (LOAD_QKV): the head's q, k and v slices of the window's qkv rows arrive by
//   cp.async into one of two buffers, the next window's as soon as this one has landed;
//   no weights, no x.  The query fragments and the cosine norms are K2's: load_q_frags
//   and cos_q_frags, and each warp makes 16 keys of the k_hat tile with cos_k_frag on
//   the B fragments K2's head_probs_mma<true> normalizes, so the k_hat tile holds the
//   fragments K2 multiplies, and head_probs_mma<false> on it gives K2's P bit for bit.
// - Then both: head_probs_mma (P), dP = dO v^T, ds = p (dP - rowsum(dP p)) in f32 (the
//   row sum over a quad) and dQ = dS k (dS repacked from the accumulators, as P in the
//   forward) stay in registers; bf16 P and dS go once to 64 x 64 tiles, and after one
//   barrier each warp takes 16 key rows for dV = P^T dO and dK = dS^T q
//   (ldmatrix.trans).  Cosine: the tangent projection of the normalization and the
//   logit-scale term, per-row dots as quad sums; scaled-dot: sm_scale.  bf16 rounding
//   at the plain version's points (p before dv, ds before the q/k products, dq, dk,
//   dv); the score operand is the forward's bf16(q (uq scale)), where the plain
//   backward rounds (q uq) scale, an f32 ulp apart at most.
// - The f32 ds of every window accumulates in 32 registers a thread (the head's 64 x 64
//   dbias), dls in one, and (K17) the dbqkv column sums of the rounded dq|dk|dv (read
//   back from the staging tile that also gives the 16-byte stores of the dqkv rows) in
//   two: the block writes its slice of the run's partial row once, at its end, so
//   reduce_rows reads kRun times fewer rows.
// Five core barriers per window; nothing is atomic, so results do not change from run
// to run.  Shared memory: K17 201,216 B at C = 384 and 136,704 B at C = 192 (one block
// an SM), 104,448 B at C = 96 (two); K5 101,888 B at any C (two).
// ---------------------------------------------------------------------------------
constexpr int kRun = 8;             // windows one block walks
constexpr int LD_WH = 3 * HD + 8;   // the head's q|k|v rows of Wqkv; the dq|dk|dv staging
constexpr int kTile = WS * LD_HEAD;  // elements of a 64 x HD tile

struct QkvBwdLayout {
  size_t w, x, q, k, v, dout, p, ds, st, bias, g, total;
};

__host__ __device__ inline QkvBwdLayout qkv_bwd_layout(int C, bool load_qkv) {
  QkvBwdLayout L;
  const size_t tile = align128(size_t(kTile) * 2);
  size_t off = 0;
  L.w = off; if (!load_qkv) off += align128(size_t(C) * LD_WH * 2);
  L.x = off;  // K17: the x tile; K5: two windows' q | k | v slices
  off += load_qkv ? 6 * tile : align128(size_t(WS) * (C + 8) * 2);
  L.q = off; off += tile;  // the score operand q_hat (cosine) or q, for dK
  L.k = off; off += tile;  // k_hat or k, for the scores and dQ
  L.v = off; off += tile;
  L.dout = off; off += tile;
  L.p = off; off += align128(size_t(WS) * LD_P * 2);
  L.ds = off; off += align128(size_t(WS) * LD_P * 2);
  L.st = off; off += align128(size_t(WS) * LD_WH * 2);
  L.bias = off; off += align128(size_t(WS) * LD_BIAS * 4);
  L.g = off; off += align128(2 * WS * 4);  // two windows' group ids
  L.total = off;
  return L;
}

// the partial row of one K17 run: [dbias (H x 64 x 64) | dls (H) | dbqkv (3C)]
__host__ __device__ inline size_t qkv_part_width(int C) {
  return attn_part_width(C / HD) + 3 * size_t(C);
}

__host__ __device__ inline int qkv_runs(int T) { return (T / WS + kRun - 1) / kRun; }

template <bool COS, bool LOAD_QKV>
__global__ void __launch_bounds__(kCoreThreads)
qkv_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
               const bf16* __restrict__ bqkv, const int* __restrict__ groups,
               const float* __restrict__ bias, const float* __restrict__ lscale,
               const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
               float* __restrict__ part, int T, int C, int has_mask, float sm_scale) {
  // x: K17 the tokens (T x C); K5 the qkv rows (T x 3C).  wqkv, bqkv: K17 only.
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[kCoreWarps];
  const QkvBwdLayout L = qkv_bwd_layout(C, LOAD_QKV);
  const int LDX = C + 8;
  bf16* ws = reinterpret_cast<bf16*>(smem + L.w);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.x);
  bf16* qt = reinterpret_cast<bf16*>(smem + L.q);
  bf16* kt = reinterpret_cast<bf16*>(smem + L.k);
  bf16* vt = reinterpret_cast<bf16*>(smem + L.v);
  bf16* dt = reinterpret_cast<bf16*>(smem + L.dout);
  bf16* pt = reinterpret_cast<bf16*>(smem + L.p);
  bf16* dst = reinterpret_cast<bf16*>(smem + L.ds);
  bf16* st = reinterpret_cast<bf16*>(smem + L.st);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);
  int* gs = reinterpret_cast<int*>(smem + L.g);

  const int head = blockIdx.y;
  const int run = blockIdx.x;
  const int w0 = run * kRun;
  const int n = min(kRun, T / WS - w0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = warp * 16;
  const int r0 = row0 + (lane >> 2), r1 = r0 + 8, c2 = (lane & 3) * 2;
  const int H = C / HD;
  const int C3 = 3 * C;
  const bool masked = has_mask != 0;
  const float scale = COS ? lscale[head] : 1.f;
  const int chunks = C / 8;

  // cp.async copies of window w's x tile (K5: its q|k|v slices) and group ids (into
  // buffer b), and of its dout slice; the caller commits
  auto stage_x = [&](int w, int b) {
    const size_t tok0 = size_t(w) * WS;
    if constexpr (LOAD_QKV) {
      bf16* t = xs + b * 3 * kTile;
      for (int idx = tid; idx < WS * 12; idx += kCoreThreads) {
        const int r = idx / 12, part_i = (idx % 12) >> 2, c = (idx & 3) * 8;
        cp_async16(t + part_i * kTile + r * LD_HEAD + c,
                   x + (tok0 + r) * C3 + part_i * C + head * HD + c);
      }
    } else {
      for (int idx = tid; idx < WS * chunks; idx += kCoreThreads) {
        const int r = idx / chunks, c = (idx - r * chunks) * 8;
        cp_async16(xs + r * LDX + c, x + (tok0 + r) * C + c);
      }
    }
    if (masked && tid < WS / 4) cp_async16(gs + b * WS + tid * 4, groups + tok0 + tid * 4);
  };
  auto stage_dout = [&](int w) {
    const size_t tok0 = size_t(w) * WS;
    for (int idx = tid; idx < WS * 4; idx += kCoreThreads) {
      const int r = idx >> 2, c = (idx & 3) * 8;
      cp_async16(dt + r * LD_HEAD + c, dout + (tok0 + r) * C + head * HD + c);
    }
  };

  // the run's resident operands: (K17) the head's q|k|v strips of Wqkv, and its bias
  if constexpr (!LOAD_QKV) {
    for (int idx = tid; idx < C * kHeadNT; idx += kCoreThreads) {
      const int r = idx / kHeadNT, t = idx - r * kHeadNT;
      cp_async16(ws + r * LD_WH + t * 8,
                 wqkv + size_t(r) * C3 + (t >> 2) * C + head * HD + (t & 3) * 8);
    }
  }
  const float* bias_h = bias + size_t(head) * WS * WS;
  for (int idx = tid; idx < WS * WS / 4; idx += kCoreThreads) {
    const int r = idx >> 4, c = (idx & 15) * 4;
    cp_async16(bias_s + r * LD_BIAS + c, bias_h + r * WS + c);
  }
  stage_x(w0, 0);
  stage_dout(w0);
  cp_async_commit();

  float dbias[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) dbias[j][0] = dbias[j][1] = dbias[j][2] = dbias[j][3] = 0.f;
  float dls = 0.f;
  float cs0 = 0.f, cs1 = 0.f;  // dbqkv: column pair (tid % 48) over rows of half tid / 48
  const bf16* arow = xs + (row0 + (lane & 15)) * LDX + (lane >> 4) * 8;
  const bf16* wrow = ws + (lane & 15) * LD_WH + (lane >> 4) * 8;

  for (int i = 0; i < n; ++i) {
    const size_t tok0 = size_t(w0 + i) * WS;
    cp_async_wait<0>();
    __syncthreads();  // window i's operands, group ids and dout have landed

    uint32_t qa[2][4];
    float iq[2] = {1.f, 1.f}, ik[2] = {1.f, 1.f};
    uint32_t qraw[4][2], kraw[4][2];  // cosine: the rounded q and k rows of this warp
    const bf16* kop = kt;  // the key operand of the scores and dQ
    const bf16* vop = vt;
    if constexpr (LOAD_QKV) {
      if (i + 1 < n) stage_x(w0 + i + 1, (i + 1) & 1);  // buffer (i + 1) & 1 is free
      cp_async_commit();
      const bf16* qb = xs + (i & 1) * 3 * kTile;
      const bf16* kb = qb + kTile;
      vop = kb + kTile;
      load_q_frags(qa, qb, row0);
      if constexpr (COS) {
        cos_q_frags(qa, scale, iq);
        // k_hat of this warp's 16 keys (key blocks 2 warp, 2 warp + 1: rows r0, r1)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int j = 2 * warp + h2;
          uint32_t kf[4];
          ldsm_x4(kf, kb + (8 * j + (lane & 7)) * LD_HEAD + (lane >> 3) * 8);
          ik[h2] = cos_k_frag(kf);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            *reinterpret_cast<uint32_t*>(kt + (8 * j + (lane >> 2)) * LD_HEAD + 8 * q + c2) = kf[q];
        }
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          qraw[nn][0] = *reinterpret_cast<const uint32_t*>(qb + r0 * LD_HEAD + 8 * nn + c2);
          qraw[nn][1] = *reinterpret_cast<const uint32_t*>(qb + r1 * LD_HEAD + 8 * nn + c2);
          kraw[nn][0] = *reinterpret_cast<const uint32_t*>(kb + r0 * LD_HEAD + 8 * nn + c2);
          kraw[nn][1] = *reinterpret_cast<const uint32_t*>(kb + r1 * LD_HEAD + 8 * nn + c2);
        }
      } else {
        kop = kb;
      }
    } else {
      // qkv = x Wqkv over the head's columns: 16 rows x 12 n-tiles a warp
      float acc[kHeadNT][4];
#pragma unroll
      for (int t = 0; t < kHeadNT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
      for (int kk = 0; kk < C; kk += 16) {
        uint32_t a[4];
        ldsm_x4(a, arow + kk);
#pragma unroll
        for (int np = 0; np < kHeadNT / 2; ++np) {
          uint32_t b[4];
          ldsm_x4_t(b, wrow + kk * LD_WH + np * 16);
          mma_bf16(acc[2 * np], a, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
      __syncthreads();  // every warp has read x: the buffer takes the next window's
      if (i + 1 < n) stage_x(w0 + i + 1, (i + 1) & 1);
      cp_async_commit();

      qkv_head_epilogue<COS>(acc, bqkv + head * HD, C, scale, qa, kt, vt, row0, iq, ik);
      if constexpr (COS) {
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          qraw[nn][0] = pack_bf2(acc[nn][0], acc[nn][1]);
          qraw[nn][1] = pack_bf2(acc[nn][2], acc[nn][3]);
          kraw[nn][0] = pack_bf2(acc[4 + nn][0], acc[4 + nn][1]);
          kraw[nn][1] = pack_bf2(acc[4 + nn][2], acc[4 + nn][3]);
        }
      }
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {  // the score operand for dK, from its A fragments
      const int c = 16 * ks + c2;
      *reinterpret_cast<uint32_t*>(qt + r0 * LD_HEAD + c) = qa[ks][0];
      *reinterpret_cast<uint32_t*>(qt + r1 * LD_HEAD + c) = qa[ks][1];
      *reinterpret_cast<uint32_t*>(qt + r0 * LD_HEAD + c + 8) = qa[ks][2];
      *reinterpret_cast<uint32_t*>(qt + r1 * LD_HEAD + c + 8) = qa[ks][3];
    }
    __syncthreads();  // the q, k, v tiles are whole

    float p[8][4];
    head_probs_mma<false>(qa, kop, bias_s, LD_BIAS, masked ? gs + (i & 1) * WS : nullptr, row0,
                          COS ? 1.f : sm_scale, p);
    uint32_t da[2][4];
    load_q_frags(da, dt, row0);
    float ds[8][4];
    frags_times_tile_t(da, vop, ds);  // dP = dO v^T
    float t0 = 0.f, t1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      t0 += ds[j][0] * p[j][0] + ds[j][1] * p[j][1];
      t1 += ds[j][2] * p[j][2] + ds[j][3] * p[j][3];
    }
    t0 = quad_sum(t0);
    t1 = quad_sum(t1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ds[j][0] = p[j][0] * (ds[j][0] - t0);
      ds[j][1] = p[j][1] * (ds[j][1] - t0);
      ds[j][2] = p[j][2] * (ds[j][2] - t1);
      ds[j][3] = p[j][3] * (ds[j][3] - t1);
#pragma unroll
      for (int e = 0; e < 4; ++e) dbias[j][e] += ds[j][e];
      const int c = 8 * j + c2;
      *reinterpret_cast<uint32_t*>(pt + r0 * LD_P + c) = pack_bf2(p[j][0], p[j][1]);
      *reinterpret_cast<uint32_t*>(pt + r1 * LD_P + c) = pack_bf2(p[j][2], p[j][3]);
      *reinterpret_cast<uint32_t*>(dst + r0 * LD_P + c) = pack_bf2(ds[j][0], ds[j][1]);
      *reinterpret_cast<uint32_t*>(dst + r1 * LD_P + c) = pack_bf2(ds[j][2], ds[j][3]);
    }
    float dq[4][4];
    acc_times_tile(ds, kop, dq);  // dQ = dS k (k_hat for cosine)
    __syncthreads();  // the P and dS tiles are whole

    float dv[4][4], dk[4][4];
    tile_t_times_tile(pt, row0, dt, dv);  // dV = P^T dO, this warp's 16 keys
    tile_t_times_tile(dst, row0, qt, dk);  // dK = dS^T q (q_hat scale for cosine)
    if constexpr (COS) {
      // dq = uq scale (a - q_hat <a, q_hat>), dk = uk (b - k_hat <b, k_hat>), with
      // q_hat = q uq and k_hat = k uk in f32; dls += <a, q_hat> per row
      float2 qh[4][2], kh[4][2];
      float rq0 = 0.f, rq1 = 0.f, rk0 = 0.f, rk1 = 0.f;
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const float2 q0 = unpack_bf2(qraw[nn][0]), q1 = unpack_bf2(qraw[nn][1]);
        const float2 k0 = unpack_bf2(kraw[nn][0]), k1 = unpack_bf2(kraw[nn][1]);
        qh[nn][0] = make_float2(q0.x * iq[0], q0.y * iq[0]);
        qh[nn][1] = make_float2(q1.x * iq[1], q1.y * iq[1]);
        kh[nn][0] = make_float2(k0.x * ik[0], k0.y * ik[0]);
        kh[nn][1] = make_float2(k1.x * ik[1], k1.y * ik[1]);
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
      const float mq0 = iq[0] * scale, mq1 = iq[1] * scale;
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        dq[nn][0] = (dq[nn][0] - qh[nn][0].x * rq0) * mq0;
        dq[nn][1] = (dq[nn][1] - qh[nn][0].y * rq0) * mq0;
        dq[nn][2] = (dq[nn][2] - qh[nn][1].x * rq1) * mq1;
        dq[nn][3] = (dq[nn][3] - qh[nn][1].y * rq1) * mq1;
        dk[nn][0] = (dk[nn][0] - kh[nn][0].x * rk0) * ik[0];
        dk[nn][1] = (dk[nn][1] - kh[nn][0].y * rk0) * ik[0];
        dk[nn][2] = (dk[nn][2] - kh[nn][1].x * rk1) * ik[1];
        dk[nn][3] = (dk[nn][3] - kh[nn][1].y * rk1) * ik[1];
      }
    } else {
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dq[nn][e] *= sm_scale;
          dk[nn][e] *= sm_scale;
        }
    }
    // dq | dk | dv rounded, staged for the 16-byte stores and the column sums
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      const int c = 8 * nn + c2;
      *reinterpret_cast<uint32_t*>(st + r0 * LD_WH + c) = pack_bf2(dq[nn][0], dq[nn][1]);
      *reinterpret_cast<uint32_t*>(st + r1 * LD_WH + c) = pack_bf2(dq[nn][2], dq[nn][3]);
      *reinterpret_cast<uint32_t*>(st + r0 * LD_WH + HD + c) = pack_bf2(dk[nn][0], dk[nn][1]);
      *reinterpret_cast<uint32_t*>(st + r1 * LD_WH + HD + c) = pack_bf2(dk[nn][2], dk[nn][3]);
      *reinterpret_cast<uint32_t*>(st + r0 * LD_WH + 2 * HD + c) = pack_bf2(dv[nn][0], dv[nn][1]);
      *reinterpret_cast<uint32_t*>(st + r1 * LD_WH + 2 * HD + c) = pack_bf2(dv[nn][2], dv[nn][3]);
    }
    __syncthreads();  // the staging is whole; every warp has read this window's operands
    if (i + 1 < n) stage_dout(w0 + i + 1);
    cp_async_commit();
    for (int idx = tid; idx < WS * kHeadNT; idx += kCoreThreads) {
      const int r = idx / kHeadNT, t = idx - r * kHeadNT;
      *reinterpret_cast<uint4*>(dqkv + (tok0 + r) * C3 + (t >> 2) * C + head * HD + (t & 3) * 8) =
          *reinterpret_cast<const uint4*>(st + r * LD_WH + t * 8);
    }
    if (!LOAD_QKV && tid < 3 * HD) {
      const int half = tid / (3 * HD / 2), pair = tid - half * (3 * HD / 2);
#pragma unroll 8
      for (int r = half * (WS / 2); r < (half + 1) * (WS / 2); ++r) {
        const float2 v = unpack_bf2(*reinterpret_cast<const uint32_t*>(st + r * LD_WH + 2 * pair));
        cs0 += v.x;
        cs1 += v.y;
      }
    }
  }

  // this block's slice of the run's partial row (odd widths at odd H: 4-byte stores)
  float* prow = part + size_t(run) * (LOAD_QKV ? attn_part_width(H) : qkv_part_width(C));
  float* pb = prow + size_t(head) * WS * WS;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + c2;
    pb[r0 * WS + c] = dbias[j][0];
    pb[r0 * WS + c + 1] = dbias[j][1];
    pb[r1 * WS + c] = dbias[j][2];
    pb[r1 * WS + c + 1] = dbias[j][3];
  }
  const float dl = warp_sum((lane & 3) == 0 ? dls : 0.f);  // each row's term once
  if (lane == 0) red[warp] = dl;
  __syncthreads();  // every thread is done with the staging tile
  if constexpr (!LOAD_QKV) {
    float* colsum = reinterpret_cast<float*>(st);
    if (tid < 3 * HD) *reinterpret_cast<float2*>(colsum + 2 * tid) = make_float2(cs0, cs1);
    __syncthreads();
    if (tid < 3 * HD) {  // column tid of the head's q|k|v: half 0 (rows 0-31) + half 1
      prow[attn_part_width(H) + (tid / HD) * C + head * HD + tid % HD] =
          colsum[tid] + colsum[3 * HD + tid];
    }
  }
  if (tid == 0) prow[size_t(H) * WS * WS + head] = red[0] + red[1] + red[2] + red[3];
}

// the workspace of K17: dqkv (bf16 rows), the per-run partial rows, and the
// reductions' scratch (at least min_tmp floats)
struct QkvBwdWork {
  size_t dqkv, part, tmp, total;
};

inline QkvBwdWork qkv_bwd_work(int T, int C, size_t min_tmp = 0) {
  QkvBwdWork w;
  const int runs = qkv_runs(T);
  const int W = int(qkv_part_width(C));
  size_t off = 0;
  w.dqkv = off; off += align128(size_t(T) * 3 * C * 2);
  w.part = off; off += align128(size_t(runs) * W * 4);
  size_t tmp = reduce_rows_tmp_floats(runs, W);
  const size_t g = gemm_tn_tmp_floats(T, C, 3 * C);
  tmp = tmp > g ? tmp : g;
  tmp = tmp > min_tmp ? tmp : min_tmp;
  w.tmp = off; off += align128(tmp * 4);
  w.total = off;
  return w;
}

// K17 in full: the main kernel, reduce_rows into red ([dbias | dls | dbqkv]), dWqkv
// (gemm_tn) and dx (gemm_nt).  K4's launch sequence ends with its cosine flavour.
cudaError_t qkv_bwd(const bf16* x, const bf16* wqkv, const bf16* bqkv, const int* groups,
                    const float* bias, const float* lscale, const bf16* dout, bf16* dx,
                    float* dwqkv, float* red, unsigned char* work, int T, int C, bool use_cos,
                    int has_mask, float sm_scale, cudaStream_t s) {
  static std::atomic<unsigned> done_cos{0}, done_dot{0};
  auto kernel = use_cos ? qkv_bwd_kernel<true, false> : qkv_bwd_kernel<false, false>;
  cudaError_t e = smem_opt_in(reinterpret_cast<const void*>(kernel),
                              qkv_bwd_layout(QKV_MAX_C, false).total,
                              use_cos ? done_cos : done_dot);
  if (e != cudaSuccess) return e;
  const QkvBwdWork w = qkv_bwd_work(T, C);
  bf16* dqkv_s = reinterpret_cast<bf16*>(work + w.dqkv);
  float* part = reinterpret_cast<float*>(work + w.part);
  float* tmp = reinterpret_cast<float*>(work + w.tmp);
  const int runs = qkv_runs(T);
  kernel<<<dim3(runs, C / HD), kCoreThreads, qkv_bwd_layout(C, false).total, s>>>(
      x, wqkv, bqkv, groups, bias, lscale, dout, dqkv_s, part, T, C, has_mask, sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = reduce_rows(part, red, runs, int(qkv_part_width(C)), tmp, s);
  if (e != cudaSuccess) return e;
  e = gemm_tn(x, dqkv_s, dwqkv, T, C, 3 * C, tmp, s);
  if (e != cudaSuccess) return e;
  return gemm_nt(dqkv_s, wqkv, dx, T, C, 3 * C, s);
}

// ---------------------------------------------------------------------------------
// K4's projection/LayerNorm backward (step 2 of its sequence): grid (runs of windows);
// one block of two cores (8 warps) per run, the cores splitting the columns as K1's do
// (core 0 column blocks 0, 2, ..., core 1 blocks 1, 3, ...; WPB blocks of C / (16 WPB)
// n-tiles each), each warp 16 rows.  Per window, the o and dz tiles arrive by cp.async;
// u = o Wp runs through K1's weight ring (gemm_rows: the same chunks in the same
// ascending 16-wide k-steps from zero sums), bp is added after, and the row statistics
// are K1's (two passes, the cores' halves through a 64 x 2 buffer), so u, its mean and
// its rstd are K1's bits.  Then in registers: xhat, the row sums of dz gamma and
// dz gamma xhat (two more exchanges), du = rstd (dz gamma - mean(dz gamma) - xhat
// mean(dz gamma xhat)); du goes out rounded to bf16 through the dz tile, 16 bytes a
// store.  The column sums of the f32 du (dbp), dz xhat (dgamma) and dz (dbeta) over
// the window's rows are shuffle sums over each warp's 8 row groups, kept per warp in
// shared memory over the run; the block writes its partial row once.  Without
// LayerNorm du = dz: no product, no du, and the partial row holds dbp = sum dz alone.
// Per window 2 * 64 * C^2 FLOPs on 6 * 64 * C bytes (o, dz, du): about C / 3 FLOP per
// byte, below the bf16 ridge at every C; the run length keeps at least ~2 blocks an
// SM busy.  Shared memory 160,768 B at C = 384 (one block an SM), 102,400 B at C = 192,
// 78,336 B at C = 96 (two).
// ---------------------------------------------------------------------------------
struct ProjLnLayout {
  size_t o, dz, ring, stats, cols, total;
};

__host__ __device__ inline ProjLnLayout proj_ln_layout(int C) {
  ProjLnLayout L;
  const size_t tile = align128(size_t(WS) * (C + 8) * 2);
  size_t off = 0;
  L.o = off; off += tile;
  L.dz = off; off += tile;  // dz, then du
  L.ring = off; off += align128(size_t(2) * kStages * KC * LD_W * 2);
  L.stats = off; off += align128(4 * WS * 2 * 4);  // [pass][row][core]
  L.cols = off; off += align128(size_t(kWarps) * 3 * (C / 2) * 4);  // [warp][3][C / 2]
  L.total = off;
  return L;
}

// windows per block: up to 8, fewer where that would leave under ~2 blocks an SM
inline int proj_ln_run(int windows) {
  const int r = windows / 264;
  return r < 1 ? 1 : (r > 8 ? 8 : r);
}

inline int proj_ln_blocks(int T) {
  const int windows = T / WS;
  const int run = proj_ln_run(windows);
  return (windows + run - 1) / run;
}

template <int WPB>
__global__ void __launch_bounds__(kThreads, WPB == 1 ? 2 : 1)
proj_ln_bwd_kernel(const bf16* __restrict__ o, const bf16* __restrict__ wp,
                   const bf16* __restrict__ bp, const float* __restrict__ ln_g,
                   const bf16* __restrict__ dz, bf16* __restrict__ du,
                   float* __restrict__ part, int T, int C, int run, int has_ln, float ln_eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ProjLnLayout L = proj_ln_layout(C);
  const int LDX = C + 8;
  bf16* os = reinterpret_cast<bf16*>(smem + L.o);
  bf16* zs = reinterpret_cast<bf16*>(smem + L.dz);
  float* stats = reinterpret_cast<float*>(smem + L.stats);
  float* cols = reinterpret_cast<float*>(smem + L.cols);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int core = tid / kCoreThreads;
  const int gtid = tid % kCoreThreads;
  const int row0 = (warp & 3) * 16;
  const int r0 = row0 + (lane >> 2), r1 = r0 + 8, c2 = (lane & 3) * 2;
  const int w0 = blockIdx.x * run;
  const int n = min(run, T / WS - w0);
  const int half = C / 2;  // the columns of a core
  const int chunks = C / 8;
  const bool ln = has_ln != 0;

  WeightStream<WPB> st;
  st.wqkv = nullptr;
  st.wp = wp;
  st.ring = reinterpret_cast<bf16*>(smem + L.ring) + core * kStages * KC * LD_W;
  st.C = C;
  st.core = core;
  st.nk = C / KC;
  st.n_head_jobs = 0;
  st.nt_p = C / (16 * WPB);
  st.total = ln ? n * WPB * st.nk : 0;
  const int bw = st.nt_p * 8;  // columns of a column block

  for (int idx = tid; idx < kWarps * 3 * half; idx += kThreads) cols[idx] = 0.f;
  for (int s = 0; s < kStages - 1; ++s) {
    st.fetch(s, gtid);
    cp_async_commit();
  }
  float* cw = cols + warp * 3 * half;  // this warp's column sums: dbp | dgamma | dbeta
  int s = 0;

  for (int i = 0; i < n; ++i) {
    const size_t tok0 = size_t(w0 + i) * WS;
    __syncthreads();  // the previous window's tiles are free
    for (int idx = tid; idx < WS * chunks; idx += kThreads) {
      const int r = idx / chunks, c = (idx - r * chunks) * 8;
      if (ln) cp_async16(os + r * LDX + c, o + (tok0 + r) * C + c);
      cp_async16(zs + r * LDX + c, dz + (tok0 + r) * C + c);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // the o and dz tiles have landed

    float u[WPB][kMaxNT][4];
    float rstd0 = 1.f, rstd1 = 1.f, m10 = 0.f, m11 = 0.f, m20 = 0.f, m21 = 0.f;
    if (ln) {
      // u = o Wp + bp and its row statistics, as K1 computes them
#pragma unroll
      for (int j = 0; j < WPB; ++j) {
#pragma unroll
        for (int t = 0; t < kMaxNT; ++t) u[j][t][0] = u[j][t][1] = u[j][t][2] = u[j][t][3] = 0.f;
        gemm_rows(u[j], os, LDX, st.nt_p, st, s, gtid, row0);
      }
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < WPB; ++j) {
        const int col0 = (core + 2 * j) * bw + c2;
#pragma unroll
        for (int t = 0; t < kMaxNT; ++t) {
          if (t < st.nt_p) {
            const float2 b = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(bp + col0 + 8 * t));
            u[j][t][0] += b.x;
            u[j][t][1] += b.y;
            u[j][t][2] += b.x;
            u[j][t][3] += b.y;
            sum0 += u[j][t][0] + u[j][t][1];
            sum1 += u[j][t][2] + u[j][t][3];
          }
        }
      }
      const bool writer = (lane & 3) == 0;
      sum0 = quad_sum(sum0);
      sum1 = quad_sum(sum1);
      if (writer) {
        stats[r0 * 2 + core] = sum0;
        stats[r1 * 2 + core] = sum1;
      }
      __syncthreads();
      const float mean0 = (stats[r0 * 2] + stats[r0 * 2 + 1]) / C;
      const float mean1 = (stats[r1 * 2] + stats[r1 * 2 + 1]) / C;
      float sq0 = 0.f, sq1 = 0.f;
#pragma unroll
      for (int j = 0; j < WPB; ++j) {
#pragma unroll
        for (int t = 0; t < kMaxNT; ++t) {
          if (t < st.nt_p) {
            const float d0 = u[j][t][0] - mean0, d1 = u[j][t][1] - mean0;
            const float d2 = u[j][t][2] - mean1, d3 = u[j][t][3] - mean1;
            sq0 += d0 * d0 + d1 * d1;
            sq1 += d2 * d2 + d3 * d3;
          }
        }
      }
      sq0 = quad_sum(sq0);
      sq1 = quad_sum(sq1);
      if (writer) {
        stats[2 * WS + r0 * 2 + core] = sq0;
        stats[2 * WS + r1 * 2 + core] = sq1;
      }
      __syncthreads();
      rstd0 = rsqrtf((stats[2 * WS + r0 * 2] + stats[2 * WS + r0 * 2 + 1]) / C + ln_eps);
      rstd1 = rsqrtf((stats[2 * WS + r1 * 2] + stats[2 * WS + r1 * 2 + 1]) / C + ln_eps);

      // xhat in place of u; the row sums of dz gamma and dz gamma xhat
      float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll
      for (int j = 0; j < WPB; ++j) {
        const int col0 = (core + 2 * j) * bw + c2;
#pragma unroll
        for (int t = 0; t < kMaxNT; ++t) {
          if (t < st.nt_p) {
            const int col = col0 + 8 * t;
            const float2 z0 = unpack_bf2(*reinterpret_cast<const uint32_t*>(zs + r0 * LDX + col));
            const float2 z1 = unpack_bf2(*reinterpret_cast<const uint32_t*>(zs + r1 * LDX + col));
            const float2 gm = *reinterpret_cast<const float2*>(ln_g + col);
            u[j][t][0] = (u[j][t][0] - mean0) * rstd0;
            u[j][t][1] = (u[j][t][1] - mean0) * rstd0;
            u[j][t][2] = (u[j][t][2] - mean1) * rstd1;
            u[j][t][3] = (u[j][t][3] - mean1) * rstd1;
            const float g00 = z0.x * gm.x, g01 = z0.y * gm.y;
            const float g10 = z1.x * gm.x, g11 = z1.y * gm.y;
            a0 += g00 + g01;
            a1 += g10 + g11;
            b0 += g00 * u[j][t][0] + g01 * u[j][t][1];
            b1 += g10 * u[j][t][2] + g11 * u[j][t][3];
          }
        }
      }
      a0 = quad_sum(a0);
      a1 = quad_sum(a1);
      b0 = quad_sum(b0);
      b1 = quad_sum(b1);
      if (writer) {
        stats[4 * WS + r0 * 2 + core] = a0;
        stats[4 * WS + r1 * 2 + core] = a1;
        stats[6 * WS + r0 * 2 + core] = b0;
        stats[6 * WS + r1 * 2 + core] = b1;
      }
      __syncthreads();
      m10 = (stats[4 * WS + r0 * 2] + stats[4 * WS + r0 * 2 + 1]) / C;
      m11 = (stats[4 * WS + r1 * 2] + stats[4 * WS + r1 * 2 + 1]) / C;
      m20 = (stats[6 * WS + r0 * 2] + stats[6 * WS + r0 * 2 + 1]) / C;
      m21 = (stats[6 * WS + r1 * 2] + stats[6 * WS + r1 * 2 + 1]) / C;
    }

    // du (bf16 into the dz tile, each element by the thread that read its dz), and the
    // window's column sums of du, dz xhat and dz
#pragma unroll
    for (int j = 0; j < WPB; ++j) {
      const int col0 = (core + 2 * j) * bw + c2;
#pragma unroll
      for (int t = 0; t < kMaxNT; ++t) {
        if (t < st.nt_p) {
          const int col = col0 + 8 * t;
          const int lc = j * bw + 8 * t + c2;
          const float2 z0 = unpack_bf2(*reinterpret_cast<const uint32_t*>(zs + r0 * LDX + col));
          const float2 z1 = unpack_bf2(*reinterpret_cast<const uint32_t*>(zs + r1 * LDX + col));
          float2 d0 = z0, d1 = z1;
          if (ln) {
            const float2 gm = *reinterpret_cast<const float2*>(ln_g + col);
            d0.x = rstd0 * (z0.x * gm.x - m10 - u[j][t][0] * m20);
            d0.y = rstd0 * (z0.y * gm.y - m10 - u[j][t][1] * m20);
            d1.x = rstd1 * (z1.x * gm.x - m11 - u[j][t][2] * m21);
            d1.y = rstd1 * (z1.y * gm.y - m11 - u[j][t][3] * m21);
            *reinterpret_cast<uint32_t*>(zs + r0 * LDX + col) = pack_bf2(d0.x, d0.y);
            *reinterpret_cast<uint32_t*>(zs + r1 * LDX + col) = pack_bf2(d1.x, d1.y);
          }
          const float px = rows8(d0.x + d1.x), py = rows8(d0.y + d1.y);
          if (ln) {
            const float gx = rows8(z0.x * u[j][t][0] + z1.x * u[j][t][2]);
            const float gy = rows8(z0.y * u[j][t][1] + z1.y * u[j][t][3]);
            const float bx = rows8(z0.x + z1.x), by = rows8(z0.y + z1.y);
            if (lane < 4) {
              cw[half + lc] += gx;
              cw[half + lc + 1] += gy;
              cw[2 * half + lc] += bx;
              cw[2 * half + lc + 1] += by;
            }
          }
          if (lane < 4) {
            cw[lc] += px;
            cw[lc + 1] += py;
          }
        }
      }
    }
    if (ln) {
      __syncthreads();  // the du tile is whole
      for (int idx = tid; idx < WS * chunks; idx += kThreads) {
        const int r = idx / chunks, c = (idx - r * chunks) * 8;
        *reinterpret_cast<uint4*>(du + (tok0 + r) * C + c) =
            *reinterpret_cast<const uint4*>(zs + r * LDX + c);
      }
    }
  }

  // this block's partial row [dbp | dgamma | dbeta] (dbp alone without LayerNorm): each
  // column summed over the 4 warps of the core that holds it, in order
  __syncthreads();
  const int nvec = ln ? 3 : 1;
  float* prow = part + size_t(blockIdx.x) * nvec * C;
  for (int idx = tid; idx < nvec * C; idx += kThreads) {
    const int k = idx / C, col = idx - k * C;
    const int b = col / bw;
    const float* src = cols + (b & 1) * kCoreWarps * 3 * half + k * half + (b >> 1) * bw +
                       (col - b * bw);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kCoreWarps; ++w) sum += src[w * 3 * half];
    prow[idx] = sum;
  }
}

// step 2 in full: the kernel, then reduce_rows of its partial rows into out ([dbp |
// dgamma | dbeta], or dbp alone without LayerNorm); du is not written without it
cudaError_t proj_ln_bwd(const bf16* o, const bf16* wp, const bf16* bp, const float* ln_g,
                        const bf16* dz, bf16* du, float* part, float* out, float* tmp, int T,
                        int C, int has_ln, float ln_eps, cudaStream_t s) {
  static std::atomic<unsigned> done1{0}, done2{0};
  const bool wide = C > 192;  // two column blocks per core, as K1
  auto kernel = wide ? proj_ln_bwd_kernel<2> : proj_ln_bwd_kernel<1>;
  cudaError_t e = smem_opt_in(reinterpret_cast<const void*>(kernel),
                              proj_ln_layout(wide ? QKV_MAX_C : 192).total, wide ? done2 : done1);
  if (e != cudaSuccess) return e;
  const int blocks = proj_ln_blocks(T);
  kernel<<<blocks, kThreads, proj_ln_layout(C).total, s>>>(
      o, wp, bp, ln_g, dz, du, part, T, C, proj_ln_run(T / WS), has_ln, ln_eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_rows(part, out, blocks, (has_ln ? 3 : 1) * C, tmp, s);
}

inline size_t proj_ln_part_floats(int T, int C) { return size_t(proj_ln_blocks(T)) * 3 * C; }

inline size_t proj_ln_tmp_floats(int T, int C) {
  return reduce_rows_tmp_floats(proj_ln_blocks(T), 3 * C);
}

// the workspace of K4: o, du, do (bf16 rows), step 2's partial rows, and K17's
// workspace, whose scratch also serves step 2's reduction and the dWp product
struct EpiBwdWork {
  size_t o, du, dout, part, k17, total;
};

inline EpiBwdWork epi_bwd_work(int T, int C) {
  EpiBwdWork w;
  size_t off = 0;
  w.o = off; off += align128(size_t(T) * C * 2);
  w.du = off; off += align128(size_t(T) * C * 2);
  w.dout = off; off += align128(size_t(T) * C * 2);
  w.part = off; off += align128(proj_ln_part_floats(T, C) * 4);
  size_t tmp = proj_ln_tmp_floats(T, C);
  const size_t g = gemm_tn_tmp_floats(T, C, C);
  w.k17 = off; off += qkv_bwd_work(T, C, tmp > g ? tmp : g).total;
  w.total = off;
  return w;
}

}  // namespace
}  // namespace hs

extern "C" {

size_t hs_window_attention_bwd_workspace(int T, int C) {
  const int runs = hs::qkv_runs(T);
  const int W = int(hs::attn_part_width(C / hs::HD));
  return hs::align128(size_t(runs) * W * 4) +
         hs::align128(hs::reduce_rows_tmp_floats(runs, W) * 4);
}

int hs_window_attention_bwd(const void* qkv, const void* groups, const void* bias,
                            const void* lscale, const void* dout, void* dqkv, void* red,
                            void* work, int T, int C, int use_cos, int has_mask,
                            float sm_scale, void* stream) {
  using hs::bf16;
  static std::atomic<unsigned> done_cos{0}, done_dot{0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = use_cos ? hs::qkv_bwd_kernel<true, true> : hs::qkv_bwd_kernel<false, true>;
  const size_t smem = hs::qkv_bwd_layout(C, true).total;  // the same at every C
  cudaError_t e = hs::smem_opt_in(reinterpret_cast<const void*>(kernel), smem,
                                  use_cos ? done_cos : done_dot);
  if (e != cudaSuccess) return int(e);
  const int runs = hs::qkv_runs(T);
  const int W = int(hs::attn_part_width(C / hs::HD));
  float* part = static_cast<float*>(work);
  float* tmp = reinterpret_cast<float*>(static_cast<unsigned char*>(work) +
                                        hs::align128(size_t(runs) * W * 4));
  kernel<<<dim3(runs, C / hs::HD), hs::kCoreThreads, smem, s>>>(
      static_cast<const bf16*>(qkv), nullptr, nullptr, static_cast<const int*>(groups),
      static_cast<const float*>(bias), static_cast<const float*>(lscale),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv), part, T, C, has_mask, sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  return int(hs::reduce_rows(part, static_cast<float*>(red), runs, W, tmp, s));
}

size_t hs_window_attention_qkv_bwd_workspace(int T, int C) {
  return hs::qkv_bwd_work(T, C).total;
}

int hs_window_attention_qkv_bwd(const void* x, const void* wqkv, const void* bqkv,
                                const void* groups, const void* bias, const void* lscale,
                                const void* dout, void* dx, void* dwqkv, void* red, void* work,
                                int T, int C, int use_cos, int has_mask, float sm_scale,
                                void* stream) {
  using hs::bf16;
  return int(hs::qkv_bwd(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const int*>(groups),
      static_cast<const float*>(bias), static_cast<const float*>(lscale),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dx), static_cast<float*>(dwqkv),
      static_cast<float*>(red), static_cast<unsigned char*>(work), T, C, use_cos != 0,
      has_mask, sm_scale, static_cast<cudaStream_t>(stream)));
}

size_t hs_window_attention_qkv_epi_bwd_workspace(int T, int C) {
  return hs::epi_bwd_work(T, C).total;
}

// K4: the launch sequence (1) K16 cosine -> o, (2) the projection/LayerNorm backward ->
// du and [dbp | dgamma | dbeta] at red + qkv_part_width(C), (3) dWp = o^T du and do =
// du Wp^T, (4) K17 cosine on (x, do) -> dx, dWqkv and [dbias | dls | dbqkv] at red
int hs_window_attention_qkv_epi_bwd(const void* x, const void* wqkv, const void* bqkv,
                                    const void* wp, const void* bp, const void* ln_g,
                                    const void* ln_b, const void* groups, const void* bias,
                                    const void* lscale, const void* dz, void* dx, void* dwqkv,
                                    void* dwp, void* red, void* work, int T, int C,
                                    int has_ln, int has_mask, float ln_eps, void* stream) {
  using hs::bf16;
  (void)ln_b;  // beta does not enter the backward
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const hs::EpiBwdWork w = hs::epi_bwd_work(T, C);
  unsigned char* base = static_cast<unsigned char*>(work);
  bf16* o_s = reinterpret_cast<bf16*>(base + w.o);
  bf16* du_s = reinterpret_cast<bf16*>(base + w.du);
  bf16* do_s = reinterpret_cast<bf16*>(base + w.dout);
  float* part = reinterpret_cast<float*>(base + w.part);
  unsigned char* k17 = base + w.k17;
  float* tmp = reinterpret_cast<float*>(k17 + hs::qkv_bwd_work(T, C).tmp);
  float* redf = static_cast<float*>(red);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wq = static_cast<const bf16*>(wqkv);
  const bf16* bq = static_cast<const bf16*>(bqkv);
  const bf16* wpb = static_cast<const bf16*>(wp);
  const int* g = static_cast<const int*>(groups);
  const float* bs = static_cast<const float*>(bias);
  const float* ls = static_cast<const float*>(lscale);

  cudaError_t e = hs::qkv_attention(xb, wq, bq, g, bs, ls, o_s, T, C, true, has_mask, 1.f, s);
  if (e != cudaSuccess) return int(e);
  e = hs::proj_ln_bwd(o_s, wpb, static_cast<const bf16*>(bp), static_cast<const float*>(ln_g),
                      static_cast<const bf16*>(dz), du_s, part, redf + hs::qkv_part_width(C),
                      tmp, T, C, has_ln, ln_eps, s);
  if (e != cudaSuccess) return int(e);
  const bf16* du = has_ln ? du_s : static_cast<const bf16*>(dz);
  e = hs::gemm_tn(o_s, du, static_cast<float*>(dwp), T, C, C, tmp, s);
  if (e != cudaSuccess) return int(e);
  e = hs::gemm_nt(du, wpb, do_s, T, C, C, s);
  if (e != cudaSuccess) return int(e);
  return int(hs::qkv_bwd(xb, wq, bq, g, bs, ls, do_s, static_cast<bf16*>(dx),
                         static_cast<float*>(dwqkv), redf, k17, T, C, true, has_mask, 1.f, s));
}

// step 2 of K4 alone, for its check against its plain version: du (not written without
// LayerNorm) and [dbp | dgamma | dbeta] (dbp alone) into red
size_t hs_proj_ln_bwd_workspace(int T, int C) {
  return hs::align128(hs::proj_ln_part_floats(T, C) * 4) +
         hs::align128(hs::proj_ln_tmp_floats(T, C) * 4);
}

int hs_proj_ln_bwd(const void* o, const void* wp, const void* bp, const void* ln_g,
                   const void* dz, void* du, void* red, void* work, int T, int C, int has_ln,
                   float ln_eps, void* stream) {
  using hs::bf16;
  float* part = static_cast<float*>(work);
  float* tmp = reinterpret_cast<float*>(static_cast<unsigned char*>(work) +
                                        hs::align128(hs::proj_ln_part_floats(T, C) * 4));
  return int(hs::proj_ln_bwd(static_cast<const bf16*>(o), static_cast<const bf16*>(wp),
                             static_cast<const bf16*>(bp), static_cast<const float*>(ln_g),
                             static_cast<const bf16*>(dz), static_cast<bf16*>(du), part,
                             static_cast<float*>(red), tmp, T, C, has_ln, ln_eps,
                             static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
