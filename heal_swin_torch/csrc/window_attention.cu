// Window attention of HEAL-SWIN for Hopper (sm_90a), forward (the backward kernels are
// in window_attention_bwd.cu; the per-head building blocks in attention.cuh).
//
// Replaces two Pallas TPU kernels of heal_swin_tpu/ops/window_attention.py:
//   K1 hs_window_attention_qkv_epi  <- _fwd_kernel_xw_epi (fused_window_attention_qkv_epi):
//      x @ Wqkv + b -> cosine attention (rel-pos bias, -100 group mask, f32 softmax)
//      -> @ Wp + bp -> optional LayerNorm, one block per 64-token window.
//   K2 hs_window_attention          <- _fwd_kernel / _attn_fwd_body (fused_window_attention):
//      attention from precomputed qkv rows, cosine or scaled-dot, one block per
//      (window, head).
//
// What bounds it on this card: per window K1 does 512*C^2 + 16384*C FLOPs (qkv and
// proj products, QK^T and PV) on 256*C bytes of activations in and out, i.e. about
// 2*C + 64 FLOP/byte (256..832 at C = 96..384) -- near or above the bf16 ridge
// (~295), so a kernel is bounded by how well it feeds the tensor cores, not by HBM.
// The weights (C x 3C and C x C bf16, up to 885 KB + 295 KB) do not fit in shared
// memory.
//
// What the design does about it: the window's x tile and the attention output o stay
// in shared memory for the whole block (64 x C bf16 each, 48 KB at C=384); the
// weights are streamed as WMMA fragments straight from global memory, where every
// block of a launch reads the same bytes, so they are served from L2.  All products
// run on the tensor cores as 16x16x16 bf16 WMMA tiles with f32 accumulation; scores,
// softmax and LayerNorm statistics stay in f32.  bf16 rounding happens at the same
// points as in the Pallas kernel: qkv, q_hat = q*scale/|q| and k_hat = k/|k|, p before
// PV, o before the projection, and the output.  Dynamic shared memory is above 48 KB
// (164 KB at C=384), so the launch opts in with cudaFuncSetAttribute.  wgmma/TMA
// pipelines are later work.

#include "attention.cuh"

namespace hs {
namespace {

struct HeadSmem {
  bf16* q;
  bf16* k;
  bf16* v;
  float* s;  // scores, then the head output o (f32, ld LD_T)
  bf16* p;
  int* g;    // the window's group ids (read only when masked)
};

__host__ __device__ inline size_t head_smem_bytes() {
  return 3 * align128(size_t(WS) * LD_HEAD * 2) + align128(size_t(WS) * LD_S * 4) +
         align128(size_t(WS) * LD_P * 2) + align128(size_t(WS) * 4);
}

__device__ inline HeadSmem carve_head(unsigned char* base) {
  HeadSmem h;
  size_t off = 0;
  h.q = reinterpret_cast<bf16*>(base + off); off += align128(size_t(WS) * LD_HEAD * 2);
  h.k = reinterpret_cast<bf16*>(base + off); off += align128(size_t(WS) * LD_HEAD * 2);
  h.v = reinterpret_cast<bf16*>(base + off); off += align128(size_t(WS) * LD_HEAD * 2);
  h.s = reinterpret_cast<float*>(base + off); off += align128(size_t(WS) * LD_S * 4);
  h.p = reinterpret_cast<bf16*>(base + off); off += align128(size_t(WS) * LD_P * 2);
  h.g = reinterpret_cast<int*>(base + off);
  return h;
}

// Cosine flavour: q_hat = q * scale / |q| and k_hat = k / |k| per row (rsqrt of the
// clamped sum of squares), rounded to bf16 in place.  One warp per row, lane = channel.
__device__ void cos_normalize(const HeadSmem& sh, float scale) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < WS; r += kWarps) {
    const float qv = bf(sh.q[r * LD_HEAD + lane]);
    const float kv = bf(sh.k[r * LD_HEAD + lane]);
    const float iq = rsqrtf(fmaxf(warp_sum(qv * qv), 1e-24f));
    const float ik = rsqrtf(fmaxf(warp_sum(kv * kv), 1e-24f));
    sh.q[r * LD_HEAD + lane] = to_bf(qv * (iq * scale));
    sh.k[r * LD_HEAD + lane] = to_bf(kv * ik);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------------
// K2: attention from qkv rows (T, 3C); grid (T/64 windows, C/32 heads).  Per block
// 4*64*64*32 FLOPs on 16 KB in and out (32 FLOP/byte): bound by memory and launch
// latency; at the bottleneck (T = 4096, 24 heads) it is 1536 small blocks.
// ---------------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
attn_kernel(const bf16* __restrict__ qkv, const int* __restrict__ groups,
            const float* __restrict__ bias, const float* __restrict__ lscale,
            bf16* __restrict__ out, int C, int use_cos, int has_mask, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const HeadSmem sh = carve_head(smem);
  const int win = blockIdx.x;
  const int head = blockIdx.y;
  const int tid = threadIdx.x;

  // q, k, v slices of this head: 64 rows x 3 parts x 4 16-byte chunks
  for (int idx = tid; idx < WS * 12; idx += kThreads) {
    const int r = idx / 12, part = (idx % 12) >> 2, q4 = idx & 3;
    const uint4* src = reinterpret_cast<const uint4*>(
        qkv + (size_t(win) * WS + r) * 3 * C + part * C + head * HD) + q4;
    bf16* dst = (part == 0 ? sh.q : part == 1 ? sh.k : sh.v) + r * LD_HEAD;
    reinterpret_cast<uint4*>(dst)[q4] = *src;
  }
  if (has_mask && tid < WS) sh.g[tid] = groups[size_t(win) * WS + tid];
  __syncthreads();

  float mul = sm_scale;
  if (use_cos) {
    cos_normalize(sh, lscale[head]);
    mul = 1.f;
  }
  attend_head(sh.q, sh.k, sh.v, sh.s, sh.p, sh.g, has_mask != 0,
              bias + size_t(head) * WS * WS, mul);

  for (int idx = tid; idx < WS * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    out[(size_t(win) * WS + r) * C + head * HD + d] = to_bf(sh.s[r * LD_T + d]);
  }
}

// ---------------------------------------------------------------------------------
// K1: qkv projection + cosine attention + output projection (+ LayerNorm); one block
// per window.  Shared memory: o tile | x tile + per-head scratch (aliased by the f32
// projection output u after the head loop) | group ids.
// ---------------------------------------------------------------------------------
struct EpiLayout {
  size_t o, x, qkvf, head, u, total;
};

__host__ __device__ inline EpiLayout epi_layout(int C) {
  EpiLayout L;
  const size_t ldx = size_t(C) + 8;
  size_t off = 0;
  L.o = off; off += align128(WS * ldx * 2);
  L.x = off; L.u = off;
  off += align128(WS * ldx * 2);
  L.qkvf = off; off += align128(size_t(WS) * LD_QKV * 4);
  L.head = off; off += head_smem_bytes();
  const size_t u_end = L.u + align128(size_t(WS) * (C + 4) * 4);
  L.total = off > u_end ? off : u_end;
  return L;
}

__global__ void __launch_bounds__(kThreads)
qkv_epi_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
               const bf16* __restrict__ bqkv, const bf16* __restrict__ wp,
               const bf16* __restrict__ bp, const float* __restrict__ ln_g,
               const float* __restrict__ ln_b, const int* __restrict__ groups,
               const float* __restrict__ bias, const float* __restrict__ lscale,
               bf16* __restrict__ out, int C, int has_ln, int has_mask, float ln_eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const EpiLayout L = epi_layout(C);
  const int LDX = C + 8;
  const int LDU = C + 4;
  bf16* os = reinterpret_cast<bf16*>(smem + L.o);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.x);
  float* qkvf = reinterpret_cast<float*>(smem + L.qkvf);
  float* u = reinterpret_cast<float*>(smem + L.u);
  const HeadSmem sh = carve_head(smem + L.head);

  const int win = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int H = C / HD;

  // x tile, 16-byte chunks
  const int chunks = C / 8;
  for (int idx = tid; idx < WS * chunks; idx += kThreads) {
    const int r = idx / chunks, q = idx % chunks;
    reinterpret_cast<uint4*>(xs + r * LDX)[q] =
        reinterpret_cast<const uint4*>(x + (size_t(win) * WS + r) * C)[q];
  }
  if (has_mask && tid < WS) sh.g[tid] = groups[size_t(win) * WS + tid];
  __syncthreads();

  for (int head = 0; head < H; ++head) {
    project_head_qkv(xs, LDX, wqkv, C, head, qkvf);

    // + b, round qkv to bf16, cosine-normalize q and k (one warp per row)
    {
      const float scale = lscale[head];
      const float bq = bf(bqkv[head * HD + lane]);
      const float bk = bf(bqkv[C + head * HD + lane]);
      const float bv = bf(bqkv[2 * C + head * HD + lane]);
      for (int r = warp; r < WS; r += kWarps) {
        const float* row = qkvf + r * LD_QKV;
        const float qv = bfr(row[lane] + bq);
        const float kv = bfr(row[HD + lane] + bk);
        const float vv = row[2 * HD + lane] + bv;
        const float iq = rsqrtf(fmaxf(warp_sum(qv * qv), 1e-24f));
        const float ik = rsqrtf(fmaxf(warp_sum(kv * kv), 1e-24f));
        sh.q[r * LD_HEAD + lane] = to_bf(qv * (iq * scale));
        sh.k[r * LD_HEAD + lane] = to_bf(kv * ik);
        sh.v[r * LD_HEAD + lane] = to_bf(vv);
      }
    }
    __syncthreads();

    attend_head(sh.q, sh.k, sh.v, sh.s, sh.p, sh.g, has_mask != 0,
                bias + size_t(head) * WS * WS, 1.f);

    for (int idx = tid; idx < WS * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      os[r * LDX + head * HD + d] = to_bf(sh.s[r * LD_T + d]);
    }
    __syncthreads();
  }

  // u = o @ Wp (f32) into the region the x tile and head scratch used
  const int ntiles = 4 * (C / 16);
  for (int t = warp; t < ntiles; t += kWarps) {
    const int rt = t & 3, ct = t >> 2;
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < C; kk += 16) {
      FragA a;
      FragB b;
      wmma::load_matrix_sync(a, os + rt * 16 * LDX + kk, LDX);
      wmma::load_matrix_sync(b, wp + size_t(kk) * C + ct * 16, C);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(u + rt * 16 * LDU + ct * 16, acc, LDU, wmma::mem_row_major);
  }
  __syncthreads();

  // + bp, LayerNorm with f32 statistics, bf16 out; one warp per row
  for (int r = warp; r < WS; r += kWarps) {
    float* urow = u + r * LDU;
    bf16* orow = out + (size_t(win) * WS + r) * C;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = urow[c] + bf(bp[c]);
      urow[c] = v;
      sum += v;
    }
    if (!has_ln) {
      for (int c = lane; c < C; c += 32) orow[c] = to_bf(urow[c]);
      continue;
    }
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = urow[c] - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / C + ln_eps);
    for (int c = lane; c < C; c += 32)
      orow[c] = to_bf((urow[c] - mean) * rstd * ln_g[c] + ln_b[c]);
  }
}

}  // namespace
}  // namespace hs

extern "C" {

int hs_window_attention_qkv_epi(const void* x, const void* wqkv, const void* bqkv,
                                const void* wp, const void* bp, const void* ln_g,
                                const void* ln_b, const void* groups, const void* bias,
                                const void* lscale, void* out, int T, int C, int has_ln,
                                int has_mask, float ln_eps, void* stream) {
  using hs::bf16;
  const size_t smem = hs::epi_layout(C).total;
  cudaError_t e = cudaFuncSetAttribute(hs::qkv_epi_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  hs::qkv_epi_kernel<<<T / hs::WS, hs::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const bf16*>(wp),
      static_cast<const bf16*>(bp), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<const int*>(groups),
      static_cast<const float*>(bias), static_cast<const float*>(lscale),
      static_cast<bf16*>(out), C, has_ln, has_mask, ln_eps);
  return int(cudaGetLastError());
}

int hs_window_attention(const void* qkv, const void* groups, const void* bias,
                        const void* lscale, void* out, int T, int C, int use_cos,
                        int has_mask, float sm_scale, void* stream) {
  using hs::bf16;
  const size_t smem = hs::head_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(hs::attn_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid(T / hs::WS, C / hs::HD);
  hs::attn_kernel<<<grid, hs::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const int*>(groups),
      static_cast<const float*>(bias), static_cast<const float*>(lscale),
      static_cast<bf16*>(out), C, use_cos, has_mask, sm_scale);
  return int(cudaGetLastError());
}

const char* hs_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
