// Window attention of HEAL-SWIN for Hopper (sm_90a), forward (the backward kernels are
// in window_attention_bwd.cu; the per-head building blocks in attention.cuh).
//
// Replaces three Pallas TPU kernels of heal_swin_tpu/ops/window_attention.py:
//   K1 hs_window_attention_qkv_epi  <- _fwd_kernel_xw_epi (fused_window_attention_qkv_epi):
//      x @ Wqkv + b -> cosine attention (rel-pos bias, -100 group mask, f32 softmax)
//      -> @ Wp + bp -> optional LayerNorm, one block per 64-token window.
//   K2 hs_window_attention          <- _fwd_kernel / _attn_fwd_body (fused_window_attention):
//      attention from precomputed qkv rows, cosine or scaled-dot, one 4-warp block per
//      head and run of kAttnPairs windows.
//   K16 hs_window_attention_qkv     <- _fwd_kernel_xw (fused_window_attention_qkv):
//      x @ Wqkv + b -> attention, cosine or scaled-dot, the (T, C) result before the
//      output projection: K1's kernel with the projection and LayerNorm epilogue off
//      (qkv_epi_kernel<1, false, COS>), one block per window.  Per window 384*C^2 +
//      16384*C FLOPs on 4*C*64 bytes of activations: bounded by the tensor cores' issue
//      rate like K1.
//
// What bounds them on this card: per window K1 does 512*C^2 + 16384*C FLOPs (qkv and
// proj products, QK^T and PV) on 256*C bytes of activations in and out, i.e. about
// 2*C + 64 FLOP/byte (256..832 at C = 96..384) -- near or above the bf16 ridge
// (~295), so it is bounded by how well it feeds the tensor cores, not by HBM.  K2 does
// 32 FLOP/byte and is bounded by memory and latency.  The weights (C x 3C and C x C
// bf16, up to 885 KB + 295 KB) do not fit in shared memory.
//
// What the designs do about it.  K1, K2 and K16 run on attend_head_mma (attention.cuh):
// mma.sync products from ldmatrix fragments, scores, probabilities and the head output
// in registers, no block barrier inside a head.  K1 and K16 stream their weights
// through a cp.async ring per core into shared memory and keep the x tile, the o tile
// and (K1) the projection output u (registers) on chip; K2 overlaps the next pair's
// copy with the current pair.  bf16 rounding happens at the same points as in the
// Pallas kernels: qkv, q_hat = q*scale/|q| and k_hat = k/|k|, p before PV (normalized in
// f32 first), o before the projection, and the output.  Dynamic shared memory is above
// 48 KB, so each kernel opts in once per device (smem_opt_in), at the most any of its
// launches asks for.  wgmma and TMA pipelines are later work, once a kernel runs near a
// third of the peak.

#include "attention.cuh"

namespace hs {
namespace {

// ---------------------------------------------------------------------------------
// K2: attention from qkv rows (T, 3C), cosine or scaled-dot.  Per (window, head) pair
// 4 * 64 * 64 * 32 FLOPs on 16 KB in and out (32 FLOP/byte): bound by memory and
// latency, not by the tensor cores; at the bottleneck (T = 4096, 24 heads) 1536 pairs.
// A block is one core (4 warps) that walks kAttnPairs windows of one head: the head's
// bias (16 KiB) is staged once per block, and the next pair's q, k, v slices and group
// ids (12.25 KiB) are copied by cp.async while the current pair runs, so each pair costs
// one block barrier.  The cosine flavour normalizes q in its A fragments and k in its B
// fragments (attend_head_mma<true>): rsqrt of the clamped sum of squares, rounded.  The
// head output goes out as bf16 through the warp's own q rows, 16 bytes a store.
// ---------------------------------------------------------------------------------
constexpr int kAttnPairs = 4;

struct PairTile {
  bf16 q[WS * LD_HEAD];
  bf16 k[WS * LD_HEAD];
  bf16 v[WS * LD_HEAD];
  int g[WS];
};

constexpr size_t kAttnSmem = 2 * sizeof(PairTile) + size_t(WS) * LD_BIAS * 4;

// cp.async copies of one pair's q, k, v slices (64 rows x 3 parts x 4 16-byte chunks)
// and, masked, its window's group ids; the caller commits
__device__ __forceinline__ void stage_pair(PairTile& t, const bf16* __restrict__ qkv,
                                           const int* __restrict__ groups, int win, int head,
                                           int C, bool masked) {
  const int tid = threadIdx.x;
  const size_t tok0 = size_t(win) * WS;
  for (int idx = tid; idx < WS * 12; idx += kCoreThreads) {
    const int r = idx / 12, part = (idx % 12) >> 2, c = idx & 3;
    bf16* dst = (part == 0 ? t.q : part == 1 ? t.k : t.v) + r * LD_HEAD + c * 8;
    cp_async16(dst, qkv + (tok0 + r) * 3 * C + part * C + head * HD + c * 8);
  }
  if (masked && tid < WS / 4) cp_async16(t.g + tid * 4, groups + tok0 + tid * 4);
}

// this warp's 16 x HD head output (f32 fragments, rows row0..row0+15) as bf16 to the
// same rows of dst (row stride ldd), 16 bytes a store, through the same rows of the
// warp's 64 x HD staging tile st (ld LD_HEAD)
__device__ __forceinline__ void store_head_rows(const float (&o)[4][4], bf16* st,
                                                bf16* __restrict__ dst, int ldd, int row0) {
  const int lane = threadIdx.x & 31;
  const int r0 = row0 + (lane >> 2), c2 = (lane & 3) * 2;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    *reinterpret_cast<uint32_t*>(st + r0 * LD_HEAD + 8 * n + c2) = pack_bf2(o[n][0], o[n][1]);
    *reinterpret_cast<uint32_t*>(st + (r0 + 8) * LD_HEAD + 8 * n + c2) =
        pack_bf2(o[n][2], o[n][3]);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * 4; i += 32) {
    const int r = row0 + (i >> 2), c = (i & 3) * 8;
    *reinterpret_cast<uint4*>(dst + size_t(r) * ldd + c) =
        *reinterpret_cast<const uint4*>(st + r * LD_HEAD + c);
  }
}

__global__ void __launch_bounds__(kCoreThreads)
attn_kernel(const bf16* __restrict__ qkv, const int* __restrict__ groups,
            const float* __restrict__ bias, const float* __restrict__ lscale,
            bf16* __restrict__ out, int T, int C, int use_cos, int has_mask, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  PairTile* tiles = reinterpret_cast<PairTile*>(smem);
  float* bias_s = reinterpret_cast<float*>(smem + 2 * sizeof(PairTile));
  const int head = blockIdx.y;
  const int w0 = blockIdx.x * kAttnPairs;
  const int n = min(kAttnPairs, T / WS - w0);
  const int tid = threadIdx.x;
  const int row0 = (tid >> 5) * 16;
  const bool masked = has_mask != 0;

  const float* bias_h = bias + size_t(head) * WS * WS;
  for (int idx = tid; idx < WS * WS / 4; idx += kCoreThreads) {
    const int r = idx >> 4, c = (idx & 15) * 4;
    cp_async16(bias_s + r * LD_BIAS + c, bias_h + r * WS + c);
  }
  stage_pair(tiles[0], qkv, groups, w0, head, C, masked);
  cp_async_commit();
  const float scale = use_cos ? lscale[head] : 1.f;
  const float mul = use_cos ? 1.f : sm_scale;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // pair i has landed for every thread; pair i - 1's tile is free
    if (i + 1 < n) {
      stage_pair(tiles[(i + 1) & 1], qkv, groups, w0 + i + 1, head, C, masked);
      cp_async_commit();
    }
    PairTile& t = tiles[i & 1];
    const int* g = masked ? t.g : nullptr;
    uint32_t qa[2][4];
    load_q_frags(qa, t.q, row0);
    float o[4][4];
    if (use_cos) {
      float iq[2];
      cos_q_frags(qa, scale, iq);
      attend_head_mma<true>(qa, t.k, t.v, bias_s, LD_BIAS, g, row0, mul, o);
    } else {
      attend_head_mma<false>(qa, t.k, t.v, bias_s, LD_BIAS, g, row0, mul, o);
    }
    store_head_rows(o, t.q, out + size_t(w0 + i) * WS * C + head * HD, C, row0);
  }
}

// ---------------------------------------------------------------------------------
// K1: qkv projection + cosine attention + output projection (+ LayerNorm), and K16: qkv
// projection + cosine or scaled-dot attention; one block of two cores (8 warps) per
// 64-token window.  Per window 512 C^2 + 16384 C FLOPs on 256 C
// bytes in and out (2 C + 64 FLOP/byte): at C >= 192 above the bf16 ridge, so what
// bounds it is how well the tensor cores are fed.
//
// The window's x tile (64 x C bf16) stays in shared memory.  The cores take the heads in
// turns (core 0 heads 0, 2, ..., core 1 heads 1, 3, ...; an odd head count leaves core
// 0 one head alone, and at C = 32 core 1 has no head: without the epilogue it streams
// nothing and waits only at the block barrier).  For a head, each warp projects its 16
// rows onto the head's q|k|v columns (16 x C x 96, mma.sync from ldmatrix fragments in
// ascending 16-wide k-steps), and qkv_head_epilogue adds the bias, rounds,
// cosine-normalizes with quad shuffles (or not: scaled-dot), keeps q_hat as A fragments
// and writes k_hat and v once as bf16 tiles; attend_head_mma then leaves the head output
// in registers, which go rounded into the o tile (64 x C bf16).  K16 (EPI false) writes
// the o tile out, 16 bytes a store.  Weights are never read as fragments from
// L2: each core streams its weight chunks (KC rows of a head's q|k|v strips of Wqkv, then
// of its column blocks of Wp) through its own kStages-deep cp.async ring, so the next
// head's first chunks land while the current head attends, and a chunk costs one core
// barrier.  After a block barrier each warp computes u = o Wp for its 16 rows over the
// core's column blocks (WPB of C / (16 WPB) n-tiles each), in registers, + bp, and the
// LayerNorm's f32 row statistics (two passes) meet through a 64 x 2 buffer.  The bf16
// output is staged in the x tile and written 16 bytes a store.  Shared memory: 158 KiB
// at C = 384 (one block per SM), 110 KiB at C = 192 (two).
// ---------------------------------------------------------------------------------
struct EpiLayout {
  size_t o, x, ring, kv, g, stats, total;
};

__host__ __device__ inline EpiLayout epi_layout(int C) {
  EpiLayout L;
  const size_t ldx = size_t(C) + 8;
  size_t off = 0;
  L.o = off; off += align128(WS * ldx * 2);
  L.x = off; off += align128(WS * ldx * 2);  // then the output staging
  L.ring = off; off += align128(size_t(2) * kStages * KC * LD_W * 2);
  L.kv = off; off += align128(size_t(2) * 2 * WS * LD_HEAD * 2);  // each core's k_hat, v
  L.g = off; off += align128(WS * 4);
  L.stats = off; off += align128(2 * WS * 2 * 4);  // [pass][row][core]
  L.total = off;
  return L;
}

template <int WPB, bool EPI, bool COS>
__global__ void __launch_bounds__(kThreads, WPB == 1 ? 2 : 1)
qkv_epi_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
               const bf16* __restrict__ bqkv, const bf16* __restrict__ wp,
               const bf16* __restrict__ bp, const float* __restrict__ ln_g,
               const float* __restrict__ ln_b, const int* __restrict__ groups,
               const float* __restrict__ bias, const float* __restrict__ lscale,
               bf16* __restrict__ out, int C, int has_ln, int has_mask, float ln_eps,
               float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const EpiLayout L = epi_layout(C);
  const int LDX = C + 8;
  bf16* os = reinterpret_cast<bf16*>(smem + L.o);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.x);
  int* gs = reinterpret_cast<int*>(smem + L.g);
  float* stats = reinterpret_cast<float*>(smem + L.stats);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int core = tid / kCoreThreads;
  const int gtid = tid % kCoreThreads;
  const int row0 = ((tid >> 5) & 3) * 16;
  const int r0 = row0 + (lane >> 2), r1 = r0 + 8, c2 = (lane & 3) * 2;
  const int H = C / HD;
  const bool masked = has_mask != 0;
  const size_t tok0 = size_t(blockIdx.x) * WS;
  bf16* kt = reinterpret_cast<bf16*>(smem + L.kv) + core * 2 * WS * LD_HEAD;
  bf16* vt = kt + WS * LD_HEAD;

  WeightStream<> st;
  st.wqkv = wqkv;
  st.wp = wp;
  st.ring = reinterpret_cast<bf16*>(smem + L.ring) + core * kStages * KC * LD_W;
  st.C = C;
  st.core = core;
  st.nk = C / KC;
  st.n_head_jobs = (H - core + 1) / 2;
  st.nt_p = C / (16 * WPB);
  st.total = (st.n_head_jobs + (EPI ? WPB : 0)) * st.nk;

  // the x tile and group ids (one cp.async group), then each ring's first chunks
  const int chunks = C / 8;
  for (int idx = tid; idx < WS * chunks; idx += kThreads) {
    const int r = idx / chunks, c = (idx - r * chunks) * 8;
    cp_async16(xs + r * LDX + c, x + (tok0 + r) * C + c);
  }
  if (masked && tid < WS / 4) cp_async16(gs + tid * 4, groups + tok0 + tid * 4);
  cp_async_commit();
  for (int s = 0; s < kStages - 1; ++s) {
    st.fetch(s, gtid);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();

  int s = 0;
  for (int h = core; h < H; h += 2) {
    float acc[kMaxNT][4];
#pragma unroll
    for (int t = 0; t < kMaxNT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    gemm_rows(acc, xs, LDX, kMaxNT, st, s, gtid, row0);

    // qkv rounded; q_hat (or q) as A fragments, k_hat (or k) and v as the core's tiles
    uint32_t qa[2][4];
    float iq[2], ik[2];
    qkv_head_epilogue<COS>(acc, bqkv + h * HD, C, COS ? lscale[h] : 1.f, qa, kt, vt, row0,
                           iq, ik);
    group_sync(1 + core);  // the core's k_hat and v tiles are whole

    float o[4][4];
    attend_head_mma<false>(qa, kt, vt, bias + size_t(h) * WS * WS, WS, masked ? gs : nullptr,
                           row0, COS ? 1.f : sm_scale, o);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = h * HD + 8 * n + c2;
      *reinterpret_cast<uint32_t*>(os + r0 * LDX + c) = pack_bf2(o[n][0], o[n][1]);
      *reinterpret_cast<uint32_t*>(os + r1 * LDX + c) = pack_bf2(o[n][2], o[n][3]);
    }
  }
  if constexpr (!EPI) {  // K16: the o tile out, 16 bytes a store
    __syncthreads();
    for (int idx = tid; idx < WS * chunks; idx += kThreads) {
      const int r = idx / chunks, c = (idx - r * chunks) * 8;
      *reinterpret_cast<uint4*>(out + (tok0 + r) * C + c) =
          *reinterpret_cast<const uint4*>(os + r * LDX + c);
    }
    return;
  }
  __syncthreads();  // the o tile is whole; the x tile is free

  // u = o Wp + bp over the core's column blocks, in registers
  float u[WPB][kMaxNT][4];
#pragma unroll
  for (int j = 0; j < WPB; ++j) {
#pragma unroll
    for (int t = 0; t < kMaxNT; ++t) u[j][t][0] = u[j][t][1] = u[j][t][2] = u[j][t][3] = 0.f;
    gemm_rows(u[j], os, LDX, st.nt_p, st, s, gtid, row0);
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < WPB; ++j) {
    const int col0 = (core + 2 * j) * st.nt_p * 8 + c2;
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

  if (has_ln) {  // f32 row statistics in two passes, the cores' halves through smem
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
    float* stats2 = stats + 2 * WS;
    if (writer) {
      stats2[r0 * 2 + core] = sq0;
      stats2[r1 * 2 + core] = sq1;
    }
    __syncthreads();
    const float rstd0 = rsqrtf((stats2[r0 * 2] + stats2[r0 * 2 + 1]) / C + ln_eps);
    const float rstd1 = rsqrtf((stats2[r1 * 2] + stats2[r1 * 2 + 1]) / C + ln_eps);
#pragma unroll
    for (int j = 0; j < WPB; ++j) {
      const int col0 = (core + 2 * j) * st.nt_p * 8 + c2;
#pragma unroll
      for (int t = 0; t < kMaxNT; ++t) {
        if (t < st.nt_p) {
          const float2 gm = *reinterpret_cast<const float2*>(ln_g + col0 + 8 * t);
          const float2 bt = *reinterpret_cast<const float2*>(ln_b + col0 + 8 * t);
          u[j][t][0] = (u[j][t][0] - mean0) * rstd0 * gm.x + bt.x;
          u[j][t][1] = (u[j][t][1] - mean0) * rstd0 * gm.y + bt.y;
          u[j][t][2] = (u[j][t][2] - mean1) * rstd1 * gm.x + bt.x;
          u[j][t][3] = (u[j][t][3] - mean1) * rstd1 * gm.y + bt.y;
        }
      }
    }
  }

  // bf16 out, staged in the x tile, 16 bytes a store
#pragma unroll
  for (int j = 0; j < WPB; ++j) {
    const int col0 = (core + 2 * j) * st.nt_p * 8 + c2;
#pragma unroll
    for (int t = 0; t < kMaxNT; ++t) {
      if (t < st.nt_p) {
        *reinterpret_cast<uint32_t*>(xs + r0 * LDX + col0 + 8 * t) =
            pack_bf2(u[j][t][0], u[j][t][1]);
        *reinterpret_cast<uint32_t*>(xs + r1 * LDX + col0 + 8 * t) =
            pack_bf2(u[j][t][2], u[j][t][3]);
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < WS * chunks; idx += kThreads) {
    const int r = idx / chunks, c = (idx - r * chunks) * 8;
    *reinterpret_cast<uint4*>(out + (tok0 + r) * C + c) =
        *reinterpret_cast<const uint4*>(xs + r * LDX + c);
  }
}

}  // namespace

cudaError_t qkv_attention(const bf16* x, const bf16* wqkv, const bf16* bqkv, const int* groups,
                          const float* bias, const float* lscale, bf16* out, int T, int C,
                          bool use_cos, int has_mask, float sm_scale, cudaStream_t stream) {
  static std::atomic<unsigned> done_cos{0}, done_dot{0};
  auto kernel = use_cos ? qkv_epi_kernel<1, false, true> : qkv_epi_kernel<1, false, false>;
  cudaError_t e = smem_opt_in(reinterpret_cast<const void*>(kernel), epi_layout(QKV_MAX_C).total,
                              use_cos ? done_cos : done_dot);
  if (e != cudaSuccess) return e;
  kernel<<<T / WS, kThreads, epi_layout(C).total, stream>>>(
      x, wqkv, bqkv, nullptr, nullptr, nullptr, nullptr, groups, bias, lscale, out, C, 0,
      has_mask, 0.f, sm_scale);
  return cudaGetLastError();
}

}  // namespace hs

extern "C" {

int hs_window_attention_qkv_epi(const void* x, const void* wqkv, const void* bqkv,
                                const void* wp, const void* bp, const void* ln_g,
                                const void* ln_b, const void* groups, const void* bias,
                                const void* lscale, void* out, int T, int C, int has_ln,
                                int has_mask, float ln_eps, void* stream) {
  using hs::bf16;
  static std::atomic<unsigned> done1{0}, done2{0};
  // two column blocks of Wp per core past C = 192 (each at most kMaxNT n-tiles); each
  // instantiation opts in once at the widest C it launches
  const bool wide = C > 192;
  auto kernel = wide ? hs::qkv_epi_kernel<2, true, true> : hs::qkv_epi_kernel<1, true, true>;
  cudaError_t e = hs::smem_opt_in(reinterpret_cast<const void*>(kernel),
                                  hs::epi_layout(wide ? hs::QKV_MAX_C : 192).total,
                                  wide ? done2 : done1);
  if (e != cudaSuccess) return int(e);
  kernel<<<T / hs::WS, hs::kThreads, hs::epi_layout(C).total,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const bf16*>(wp),
      static_cast<const bf16*>(bp), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<const int*>(groups),
      static_cast<const float*>(bias), static_cast<const float*>(lscale),
      static_cast<bf16*>(out), C, has_ln, has_mask, ln_eps, 1.f);
  return int(cudaGetLastError());
}

int hs_window_attention(const void* qkv, const void* groups, const void* bias,
                        const void* lscale, void* out, int T, int C, int use_cos,
                        int has_mask, float sm_scale, void* stream) {
  using hs::bf16;
  static std::atomic<unsigned> done{0};
  const cudaError_t e =
      hs::smem_opt_in(reinterpret_cast<const void*>(hs::attn_kernel), hs::kAttnSmem, done);
  if (e != cudaSuccess) return int(e);
  const int windows = T / hs::WS;
  const dim3 grid((windows + hs::kAttnPairs - 1) / hs::kAttnPairs, C / hs::HD);
  hs::attn_kernel<<<grid, hs::kCoreThreads, hs::kAttnSmem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const int*>(groups),
      static_cast<const float*>(bias), static_cast<const float*>(lscale),
      static_cast<bf16*>(out), T, C, use_cos, has_mask, sm_scale);
  return int(cudaGetLastError());
}

int hs_window_attention_qkv(const void* x, const void* wqkv, const void* bqkv,
                            const void* groups, const void* bias, const void* lscale, void* out,
                            int T, int C, int use_cos, int has_mask, float sm_scale,
                            void* stream) {
  using hs::bf16;
  return int(hs::qkv_attention(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const int*>(groups),
      static_cast<const float*>(bias), static_cast<const float*>(lscale), static_cast<bf16*>(out),
      T, C, use_cos != 0, has_mask, sm_scale, static_cast<cudaStream_t>(stream)));
}

const char* hs_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
