// The SWIN block MLP and the SWIN-v2 MLP branch of HEAL-SWIN for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of heal_swin_tpu/ops/mlp.py:
//   K12 hs_mlp_fwd        <- _fwd_kernel (fused_mlp, fwd_impl="pallas"):
//       (T, C) -> h = x W1 + b1 -> g = GELU(h) -> g W2 + b2 -> (T, C)
//   K13 hs_mlp_bwd        <- _bwd_kernel (the backward of fused_mlp / fused_mlp_nd):
//       recompute h and g; dh = (dout W2^T) GELU'(h); dx = dh W1^T; dW1, db1, dW2, db2
//   K14 hs_mlp_block_fwd  <- _blk_fwd_kernel (fused_mlp_block):
//       x + dscale * LN(fc2(GELU(fc1 x))), the v2 block's MLP branch with its residual
//   K15 hs_mlp_block_bwd  <- _blk_bwd_kernel: recompute the branch; the LayerNorm
//       backward du; then as K13 with du for dout; dx adds the residual dz;
//       dgamma, dbeta
// with the Pallas kernels' rounding points: h and u summed in f32 with the biases in
// f32; g rounded to bf16; the output summed in f32, + b2, rounded once (K14: LN
// statistics in f32 on the unrounded u, rounded once after the residual add); dh
// rounded before dx and dW1 while db1 sums the unrounded dh; dW2 from the bf16 g and
// dout (K15: du rounded before dW2 and the hidden's gradient, db2 over the unrounded
// du).  Both GELUs (tanh and erf) in f32.
//
// What bounds it on this card: the forward does 4 T C H FLOP on 4 T C bytes of tokens,
// H = 4C FLOP per byte (384 at C = 96), above the bf16 ridge (~295): the products
// decide, and the (T, H) hidden that the unfused route writes and reads back is what
// fusion saves.
//
// All four run on the register-resident row core of mlp_core.cuh: mma.sync m16n8k16
// from ldmatrix fragments, a warp's 16 token rows and their output sums in registers,
// GELU and its gradient on the accumulators, g and dh repacked as A fragments, the
// weights streamed as 32-column chunks through a cp.async ring that a block of 128 rows
// (64 at C <= 384, 32 above) shares.  K14 is K12's kernel with the LayerNorm forward
// epilogue (mlp_fwd_kernel<NT, kLnFwd>): the row statistics on the accumulators, x from
// the block's x tile, one rounding.  K13 is a launch sequence from one entry, on one
// stream: the dx kernel (token-parallel), then the weight-gradient kernel (hidden slice
// x token split, the slice's weights resident, h and dg recomputed by the core's
// functions, dW1 and dW2 summed in registers), then reduce_rows over its partial rows.
// K15 is one too: K12's kernel with the LayerNorm backward epilogue (u and its
// statistics recomputed, so K14's xhat; du rounded to a T x C workspace row, one
// partial row of db2 | dgamma | dbeta per block), then K13's dx kernel on du with the
// residual dz added before the rounding, K13's weight-gradient kernel on du (its db2
// sum off: db2 sums the unrounded du, from the first kernel), and reduce_rows.
// Nothing of size T x H is written; no float atomics, so the results do not change
// from run to run.

#include <type_traits>

#include "mlp_core.cuh"

namespace hs {
namespace {

constexpr int MAX_C = 768;

// ---------------------------------------------------------------------------------
// K12, K14, K15's first step and the dx kernel on the row core (mlp_core.cuh).  Block: 8
// warps in row groups of WPR warps (1 up to C 192, 2 up to 384, 4 above), 16 rows a
// group, so a warp holds at most 24 n-tiles (96 floats a thread) of its group's output
// columns; each warp of a group recomputes the group's hidden tiles.  The weights arrive as items through a
// cp.async ring of `slots` stages that the block's warps share (one block barrier an
// item): for each 32-column chunk j of the hidden, W1[:, 32j : 32j + 32] (C x 32, ld
// MLP_LDC) and W2[32j : 32j + 32, :] (32 x C, ld C + 8); the dx kernel takes W2's first.
// ---------------------------------------------------------------------------------
constexpr size_t kMaxSmem = 232448;  // an H100 block's opt-in shared memory

struct RowGeo {
  int wpr, rows, ntw;  // warps a row group, rows a block, n-tiles a warp
};

__host__ __device__ inline RowGeo row_geo(int C) {
  RowGeo g;
  g.wpr = C <= 192 ? 1 : (C <= 384 ? 2 : 4);
  g.rows = 16 * (kWarps / g.wpr);
  g.ntw = C / g.wpr / 8;
  return g;
}

// the row kernel's epilogue: none (K12), the LayerNorm forward (K14) or backward (K15's
// first step)
enum Epi { kNoEpi, kLnFwd, kLnBwd };

// shared memory: x tile | (dx kernel) dout tile | (LayerNorm epilogues) the row groups'
// exchange areas | (backward) their column sums, 3C floats a group | the ring's stages
struct RowLayout {
  size_t dout, xch, red, ring, slot, total;
  int slots;
};

__host__ __device__ inline RowLayout row_layout(int C, bool dx, Epi epi = kNoEpi) {
  const RowGeo g = row_geo(C);
  const size_t tile = align128(size_t(g.rows) * (C + 8) * 2);
  const size_t w1c = size_t(C) * MLP_LDC * 2, w2c = size_t(MLP_HC) * (C + 8) * 2;
  RowLayout L;
  L.dout = tile;
  L.xch = dx ? 2 * tile : tile;
  L.red = L.xch + (epi == kNoEpi ? 0 : align128(size_t(kWarps) * LN_XCH_FLOATS * 4));
  L.ring = L.red + (epi == kLnBwd ? align128(size_t(kWarps / g.wpr) * 3 * C * 4) : 0);
  L.slot = align128(w1c > w2c ? w1c : w2c);
  // the ring's depth: up to C 96 an item is short work and the dx kernel waits on a
  // 4-stage ring (an H100 read a third more time with 4 than with 6); above, 4 do
  L.slots = C <= 96 ? 6 : 4;
  while (L.slots > 2 && L.ring + L.slots * L.slot > kMaxSmem) --L.slots;
  L.total = L.ring + L.slots * L.slot;
  return L;
}

struct HiddenRing {
  const bf16* w1;
  const bf16* w2;
  unsigned char* base;
  size_t slot;
  int C, H, slots, total;
  bool w2_first;

  __device__ __forceinline__ bool is_w1(int s) const { return ((s & 1) == 0) != w2_first; }
  __device__ __forceinline__ bf16* stage(int s) const {
    return reinterpret_cast<bf16*>(base + (s % slots) * slot);
  }
  // item s's cp.async copies by the block's threads (none past the end); the caller commits
  __device__ __forceinline__ void fetch(int s) const {
    if (s >= total) return;
    const int j0 = (s >> 1) * MLP_HC;
    bf16* dst = stage(s);
    if (is_w1(s)) {
      for (int idx = threadIdx.x; idx < C * 4; idx += kThreads) {
        const int r = idx >> 2, q = (idx & 3) * 8;
        cp_async16(dst + r * MLP_LDC + q, w1 + size_t(r) * H + j0 + q);
      }
    } else {
      fetch_rows(dst, C + 8, w2 + size_t(j0) * C, MLP_HC, C);
    }
  }
};

// the LayerNorm epilogues' operands (K14: gamma, beta, dscale; K15's first step:
// gamma, dscale, dz and the partial rows, one row of db2 | dgamma | dbeta a block)
struct LnArgs {
  const float* gamma;
  const float* beta;
  const float* dscale;  // (T,) or null: no DropPath scale
  const bf16* dz;
  float* part;
  float eps;
};

// K12: out = bf16(sum over the hidden of bf16(GELU(x W1 + b1)) W2 + b2).  K14 (EPI
// kLnFwd): out = bf16(x + dscale (LN(u) gamma + beta)), u that sum + b2.  K15's first
// step (kLnBwd): out = du_lo, and the block's partial row.  Grid T / rows.
template <int NT, Epi EPI>
__global__ void __launch_bounds__(kThreads)
mlp_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
               const float* __restrict__ b1, const bf16* __restrict__ w2,
               const float* __restrict__ b2, bf16* __restrict__ out, int T, int C, int H,
               int approx, LnArgs ln) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RowGeo geo = row_geo(C);
  const RowLayout L = row_layout(C, false, EPI);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int base = blockIdx.x * geo.rows;
  const int rows = min(geo.rows, T - base);
  const int row0 = (warp / geo.wpr) * 16;
  const int col0 = (warp % geo.wpr) * geo.ntw * 8;
  const bool active = row0 < rows;
  const bool ap = approx != 0;
  const int ldx = C + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  const HiddenRing ring{w1, w2, smem + L.ring, L.slot, C, H, L.slots, 2 * (H / MLP_HC), false};

  fetch_rows(xs, ldx, x + size_t(base) * C, rows, C);
  for (int s = 0; s < L.slots - 1; ++s) {  // the x tile comes with item 0
    ring.fetch(s);
    cp_async_commit();
  }
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  uint32_t g[2][4];
  for (int s = 0; s < ring.total; ++s) {
    cp_async_wait_upto(L.slots - 2);
    __syncthreads();  // item s has landed; item s - 1's stage is free
    ring.fetch(s + L.slots - 1);
    cp_async_commit();
    if (!active) continue;
    const bf16* w = ring.stage(s);
    if ((s & 1) == 0) {
      float h[4][4];
      hidden_tile(h, xs, ldx, row0, w, MLP_LDC, C, b1 + (s >> 1) * MLP_HC);
      ap ? gelu_tile<true>(h) : gelu_tile<false>(h);
      pack_a_frags(g, h);
    } else {
      frags_times_rows<NT>(acc, g, w + col0, ldx, geo.ntw);
    }
  }
  if constexpr (EPI == kNoEpi) {
    if (!active) return;
    const int c2 = (lane & 3) * 2;
    const size_t r0 = size_t(base + row0 + (lane >> 2));
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (t < geo.ntw) {
        const int c = col0 + 8 * t + c2;
        const float lo = b2[c], hi = b2[c + 1];
        *reinterpret_cast<uint32_t*>(out + r0 * C + c) =
            pack_bf2(acc[t][0] + lo, acc[t][1] + hi);
        *reinterpret_cast<uint32_t*>(out + (r0 + 8) * C + c) =
            pack_bf2(acc[t][2] + lo, acc[t][3] + hi);
      }
    }
  } else {
    // row group `group` exchanges under named barrier 1 + group (0 is __syncthreads)
    const int group = warp / geo.wpr;
    float* xch = reinterpret_cast<float*>(smem + L.xch) + group * geo.wpr * LN_XCH_FLOATS;
    float* red = reinterpret_cast<float*>(smem + L.red);
    if (active) {
      const LnRows r = ln_rows<NT>(acc, geo.ntw, col0, b2, C, ln.eps, xch, geo.wpr, 1 + group);
      const size_t grow0 = size_t(base + row0);
      if constexpr (EPI == kLnFwd)
        ln_fwd_store<NT>(acc, r, geo.ntw, col0, ln.gamma, ln.beta, ln.dscale, xs, ldx, row0,
                         grow0, out, C);
      else
        ln_bwd_store<NT>(acc, r, geo.ntw, col0, ln.gamma, ln.dscale, ln.dz, grow0, out, C, xch,
                         geo.wpr, 1 + group, red + group * 3 * C);
    }
    if constexpr (EPI == kLnBwd) {
      // the block's partial row: the active groups' column sums in group order
      __syncthreads();
      const int groups = (rows + 15) / 16;
      float* prow = ln.part + size_t(blockIdx.x) * 3 * C;
      for (int j = threadIdx.x; j < 3 * C; j += kThreads) {
        float sum = red[j];
        for (int i = 1; i < groups; ++i) sum += red[i * 3 * C + j];
        prow[j] = sum;
      }
    }
  }
}

// K13 step 1: dx = bf16(sum over the hidden of bf16(dg GELU'(h)) W1^T), dg = dout W2^T,
// with h as K12 computes it; K15 step 2 (RES): dx = bf16(resid + that sum), resid = dz
// in f32.  Grid T / rows; nothing else is written.
template <int NT, bool RES>
__global__ void __launch_bounds__(kThreads)
mlp_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
              const float* __restrict__ b1, const bf16* __restrict__ w2,
              const bf16* __restrict__ dout, const bf16* __restrict__ resid,
              bf16* __restrict__ dx, int T, int C, int H, int approx) {
  extern __shared__ __align__(128) unsigned char smem[];
  const RowGeo geo = row_geo(C);
  const RowLayout L = row_layout(C, true);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int base = blockIdx.x * geo.rows;
  const int rows = min(geo.rows, T - base);
  const int row0 = (warp / geo.wpr) * 16;
  const int col0 = (warp % geo.wpr) * geo.ntw * 8;
  const bool active = row0 < rows;
  const bool ap = approx != 0;
  const int ldx = C + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ds = reinterpret_cast<bf16*>(smem + L.dout);
  const HiddenRing ring{w1, w2, smem + L.ring, L.slot, C, H, L.slots, 2 * (H / MLP_HC), true};

  fetch_rows(xs, ldx, x + size_t(base) * C, rows, C);
  fetch_rows(ds, ldx, dout + size_t(base) * C, rows, C);
  for (int s = 0; s < L.slots - 1; ++s) {  // the x and dout tiles come with item 0
    ring.fetch(s);
    cp_async_commit();
  }
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  float dg[4][4];
  for (int s = 0; s < ring.total; ++s) {
    cp_async_wait_upto(L.slots - 2);
    __syncthreads();  // item s has landed; item s - 1's stage is free
    ring.fetch(s + L.slots - 1);
    cp_async_commit();
    if (!active) continue;
    const bf16* w = ring.stage(s);
    if ((s & 1) == 0) {
      hidden_grad_tile(dg, ds, ldx, row0, w, ldx, C);
    } else {
      float h[4][4];
      hidden_tile(h, xs, ldx, row0, w, MLP_LDC, C, b1 + (s >> 1) * MLP_HC);
      ap ? dh_tile<true>(dg, h) : dh_tile<false>(dg, h);
      uint32_t dh[2][4];
      pack_a_frags(dh, dg);
      frags_times_rows_t<NT>(acc, dh, w + col0 * MLP_LDC, MLP_LDC, geo.ntw);
    }
  }
  if (!active) return;
  const int c2 = (lane & 3) * 2;
  const size_t r0 = size_t(base + row0 + (lane >> 2));
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < geo.ntw) {
      const int c = col0 + 8 * t + c2;
      if constexpr (RES) {
        const float2 z0 = unpack_bf2(*reinterpret_cast<const uint32_t*>(resid + r0 * C + c));
        const float2 z1 =
            unpack_bf2(*reinterpret_cast<const uint32_t*>(resid + (r0 + 8) * C + c));
        acc[t][0] += z0.x;
        acc[t][1] += z0.y;
        acc[t][2] += z1.x;
        acc[t][3] += z1.y;
      }
      *reinterpret_cast<uint32_t*>(dx + r0 * C + c) = pack_bf2(acc[t][0], acc[t][1]);
      *reinterpret_cast<uint32_t*>(dx + (r0 + 8) * C + c) = pack_bf2(acc[t][2], acc[t][3]);
    }
  }
}

// ---------------------------------------------------------------------------------
// K13 step 2 (K15 step 3), the weight gradients, flash-backward style.  Grid (slices x
// column parts, token splits), the slice fastest, so that the slices of one token range
// read x and dout from L2.  A block keeps its slice's weights resident (W1[:, slice], C x
// HS, and W2[slice, :], HS x C), walks its token range in steps of R rows with the x and
// dout tiles double-buffered by cp.async, recomputes h and dg of its slice with the row
// core's functions (so g and dh_lo are K12's and the dx kernel's bits), keeps g and
// dh_lo as bf16 tiles, and accumulates in registers dW1[:, slice] += x^T dh_lo and
// dW2[slice, :]^T += dout^T g (A^T by ldmatrix.trans), db1 over the unrounded dh and,
// in slice 0, db2 over dout (K13; K15 gets db2 from its first step, and slice 0 writes
// zeros there).  Each block writes its part of its split's partial rows;
// reduce_rows sums the splits in a fixed order.  HS is 64 up to C 192 and 32 above;
// above C 384 the C rows of the two products are cut in two column parts.  A step's
// hidden block (R rows x HS) is recomputed by the warps in units of 16 rows x NTH
// n-tiles (NTH 4 up to C 192, 1 above, so that 8 warps share it wherever R x HS allows;
// one n-tile's sums are the same bits on any warp).  Warps tile the (C / parts) x HS
// products WM x WN, each warp 2 n-tiles by at most MW m-tiles.
// ---------------------------------------------------------------------------------
struct DwGeo {
  int hs, parts, R, wn, wm, mt, nslices;
};

__host__ __device__ inline DwGeo dw_geo(int C, int H) {
  DwGeo g;
  g.hs = C <= 192 ? 64 : 32;
  g.parts = C <= 384 ? 1 : 2;
  g.R = C <= 192 ? 64 : (C <= 384 ? 32 : 16);
  g.wn = g.hs / 16;
  g.wm = kWarps / g.wn;
  g.mt = C / g.parts / 16;
  g.nslices = (H + g.hs - 1) / g.hs;
  return g;
}

// shared memory: W1 slice | W2 slice | 2 stages of (x tile, dout tile) | g | dh_lo |
// db2 sums | db1 warp sums
struct DwLayout {
  size_t w2s, st, tile, gs, dhs, db2, red, total;
};

__host__ __device__ inline DwLayout dw_layout(int C, int H) {
  const DwGeo g = dw_geo(C, H);
  DwLayout L;
  size_t off = align128(size_t(C) * (g.hs + 8) * 2);
  L.w2s = off; off += align128(size_t(g.hs) * (C + 8) * 2);
  L.tile = align128(size_t(g.R) * (C + 8) * 2);
  L.st = off; off += 4 * L.tile;
  L.gs = off; off += align128(size_t(g.R) * (g.hs + 8) * 2);
  L.dhs = off; off += align128(size_t(g.R) * (g.hs + 8) * 2);
  L.db2 = off; off += align128(size_t(C) * 4);
  L.red = off; off += align128(size_t(kWarps) * MLP_HC * 4);
  L.total = off;
  return L;
}

template <int MW, int NTH>
__global__ void __launch_bounds__(kThreads, 1)
mlp_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
              const float* __restrict__ b1, const bf16* __restrict__ w2,
              const bf16* __restrict__ dout, float* __restrict__ pw1, float* __restrict__ pw2,
              float* __restrict__ pb, int T, int C, int H, int approx, int steps_per_split,
              int db2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DwGeo geo = dw_geo(C, H);
  const DwLayout L = dw_layout(C, H);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool ap = approx != 0;
  const int slice = blockIdx.x % geo.nslices;
  const int part = blockIdx.x / geo.nslices;
  const int split = blockIdx.y;
  const int s0 = slice * geo.hs;
  const int hcols = min(geo.hs, H - s0);
  const int ldx = C + 8, ldw1 = geo.hs + 8, ldh = geo.hs + 8;
  const bool db2_row = slice == 0 && part == 0;  // this block writes its split's db2
  const bool sums_db2 = db2_row && db2 != 0;
  bf16* w1s = reinterpret_cast<bf16*>(smem);
  bf16* w2s = reinterpret_cast<bf16*>(smem + L.w2s);
  bf16* gs = reinterpret_cast<bf16*>(smem + L.gs);
  bf16* dhs = reinterpret_cast<bf16*>(smem + L.dhs);
  float* db2s = reinterpret_cast<float*>(smem + L.db2);
  float* red = reinterpret_cast<float*>(smem + L.red);
  auto xs = [&](int i) { return reinterpret_cast<bf16*>(smem + L.st + (2 * (i & 1)) * L.tile); };
  auto ds = [&](int i) {
    return reinterpret_cast<bf16*>(smem + L.st + (2 * (i & 1) + 1) * L.tile);
  };
  const int step0 = split * steps_per_split;
  const int nsteps = max(0, min(T / geo.R - step0, steps_per_split));
  auto fetch = [&](int i) {  // token step i of this block's range; the caller commits
    if (i >= nsteps) return;
    const size_t r = size_t(step0 + i) * geo.R;
    fetch_rows(xs(i), ldx, x + r * C, geo.R, C);
    fetch_rows(ds(i), ldx, dout + r * C, geo.R, C);
  };

  // the slice's weights and the first token step
  const int hq = hcols / 8;
  for (int idx = tid; idx < C * hq; idx += kThreads) {
    const int r = idx / hq, q = (idx - r * hq) * 8;
    cp_async16(w1s + r * ldw1 + q, w1 + size_t(r) * H + s0 + q);
  }
  fetch_rows(w2s, ldx, w2 + size_t(s0) * C, hcols, C);
  fetch(0);  // with the weights
  cp_async_commit();
  for (int c = tid; c < C; c += kThreads) db2s[c] = 0.f;

  // this warp's part of a step's hidden block: row tile rt, the NTH n-tiles of column
  // group cg; and its tiles of the two products
  const int rts = geo.R / 16;
  const int rt = warp % rts, cg = warp / rts;
  const int gc0 = cg * 8 * NTH;  // the group's first column in the slice
  const bool recomputes = gc0 < hcols;
  const int wn = warp % geo.wn, wm = warp / geo.wn;
  const int n0 = wn * 16;
  const bool products = n0 < hcols;
  const int mw = (geo.mt - wm + geo.wm - 1) / geo.wm;
  const int m_first = part * geo.mt + wm;
  float aw1[MW][2][4], aw2[MW][2][4];
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) aw1[i][j][e] = aw2[i][j][e] = 0.f;
  float db1[NTH][2] = {};  // rows g and g + 8 summed, columns 8n + 2c, + 1
  const int c2 = (lane & 3) * 2;
  const int gr = lane >> 2;

  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // step i has landed; step i - 1's tiles are consumed
    fetch(i + 1);
    cp_async_commit();
    const bf16* xt = xs(i);
    const bf16* dt = ds(i);
    if (recomputes) {
      float h[NTH][4], dg[NTH][4];
      hidden_tile<NTH>(h, xt, ldx, rt * 16, w1s + gc0, ldw1, C, b1 + s0 + gc0);
      hidden_grad_tile<NTH>(dg, dt, ldx, rt * 16, w2s + gc0 * ldx, ldx, C);
      ap ? gelu_dh_tile<true>(h, dg) : gelu_dh_tile<false>(h, dg);
      const int r0 = rt * 16 + gr;
#pragma unroll
      for (int n = 0; n < NTH; ++n) {
        const int c = gc0 + 8 * n + c2;
        db1[n][0] += dg[n][0] + dg[n][2];
        db1[n][1] += dg[n][1] + dg[n][3];
        *reinterpret_cast<uint32_t*>(gs + r0 * ldh + c) = pack_bf2(h[n][0], h[n][1]);
        *reinterpret_cast<uint32_t*>(gs + (r0 + 8) * ldh + c) = pack_bf2(h[n][2], h[n][3]);
        *reinterpret_cast<uint32_t*>(dhs + r0 * ldh + c) = pack_bf2(dg[n][0], dg[n][1]);
        *reinterpret_cast<uint32_t*>(dhs + (r0 + 8) * ldh + c) = pack_bf2(dg[n][2], dg[n][3]);
      }
    }
    if (sums_db2) {
      for (int c = tid; c < C; c += kThreads) {
        float sum = db2s[c];
        for (int r = 0; r < geo.R; ++r) sum += bf(dt[r * ldx + c]);
        db2s[c] = sum;
      }
    }
    __syncthreads();  // g and dh_lo are in
    if (products) {
      tile_t_times_tile_cols<MW>(aw1, xt, ldx, mw, m_first, geo.wm, dhs, ldh, n0, geo.R);
      tile_t_times_tile_cols<MW>(aw2, dt, ldx, mw, m_first, geo.wm, gs, ldh, n0, geo.R);
    }
  }

  // this block's part of its split's partial rows: dW1 (C x H), dW2 (H x C), db1 | db2
  if (products) {
    float* p1 = pw1 + size_t(split) * C * H;
    float* p2 = pw2 + size_t(split) * H * C;
#pragma unroll
    for (int i = 0; i < MW; ++i) {
      if (i < mw) {
        const int m = (m_first + geo.wm * i) * 16 + gr;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = s0 + n0 + 8 * j + c2;
          p1[size_t(m) * H + n] = aw1[i][j][0];
          p1[size_t(m) * H + n + 1] = aw1[i][j][1];
          p1[size_t(m + 8) * H + n] = aw1[i][j][2];
          p1[size_t(m + 8) * H + n + 1] = aw1[i][j][3];
          p2[size_t(n) * C + m] = aw2[i][j][0];
          p2[size_t(n + 1) * C + m] = aw2[i][j][1];
          p2[size_t(n) * C + m + 8] = aw2[i][j][2];
          p2[size_t(n + 1) * C + m + 8] = aw2[i][j][3];
        }
      }
    }
  }
  if (part != 0) return;
  float* pbrow = pb + size_t(split) * (H + C);
  if (recomputes) {
#pragma unroll
    for (int n = 0; n < NTH; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = db1[n][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gr == 0) red[warp * MLP_HC + 8 * n + c2 + e] = v;
      }
    }
  }
  __syncthreads();
  if (tid < hcols) {  // column tid: its group's warps, row tiles in ascending order
    const int w0 = (tid / (8 * NTH)) * rts;
    float sum = 0.f;
    for (int r = 0; r < rts; ++r) sum += red[(w0 + r) * MLP_HC + tid % (8 * NTH)];
    pbrow[s0 + tid] = sum;
  }
  if (db2_row)
    for (int c = tid; c < C; c += kThreads) pbrow[H + c] = db2s[c];
}

// K13's workspace: the weight-gradient kernel's partial rows (per token split: dW1,
// dW2, db1 | db2) and the reductions' scratch; no T x H tensor
struct DwWork {
  size_t pw2, pb, tmp, total;
  int splits;
};

inline int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// token splits: about one block an SM in all, at least one step of R rows a split
inline int dw_splits(int T, int C, int H) {
  const DwGeo g = dw_geo(C, H);
  int s = sm_count() / (g.nslices * g.parts);
  s = s < 1 ? 1 : s;
  const int steps = T / g.R;
  return s < steps ? s : steps;
}

inline DwWork dw_work(int T, int C, int H) {
  DwWork w;
  w.splits = dw_splits(T, C, H);
  const size_t S = w.splits, WH = size_t(C) * H;
  size_t off = align128(S * WH * 4);
  w.pw2 = off; off += align128(S * WH * 4);
  w.pb = off; off += align128(S * (H + C) * 4);
  size_t tmp = reduce_rows_tmp_floats(w.splits, int(WH));
  const size_t tb = reduce_rows_tmp_floats(w.splits, H + C);
  tmp = tmp > tb ? tmp : tb;
  w.tmp = off; off += align128(tmp * 4);
  w.total = off;
  return w;
}

// the most shared memory any supported C asks of a kernel: its one opt-in per device
template <typename F>
size_t widest(F bytes) {
  size_t m = 0;
  for (int C = 32; C <= MAX_C; C += 32) {
    const size_t b = bytes(C);
    m = b > m ? b : m;
  }
  return m;
}

inline int row_blocks(int T, int C) { return (T + row_geo(C).rows - 1) / row_geo(C).rows; }

inline bool row_shape_ok(int T, int C, int H) {
  return T > 0 && T % 64 == 0 && C > 0 && C % 32 == 0 && C <= MAX_C && (C <= 384 || C % 64 == 0) &&
         H > 0 && H % MLP_HC == 0;
}

// f(std::integral_constant<int, NT>) with NT the row kernels' n-tiles a warp for C
template <typename F>
cudaError_t with_nt(int C, F f) {
  return C <= 96 ? f(std::integral_constant<int, 12>{}) : f(std::integral_constant<int, 24>{});
}

// K12 (kNoEpi), K14 (kLnFwd) or K15's first step (kLnBwd)
template <Epi EPI>
cudaError_t launch_row(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, int T, int C, int H, int approx,
                       const LnArgs& ln, cudaStream_t s) {
  if (!row_shape_ok(T, C, H)) return cudaErrorInvalidValue;
  return with_nt(C, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    static std::atomic<unsigned> done{0};
    const void* k = reinterpret_cast<const void*>(mlp_fwd_kernel<NT, EPI>);
    cudaError_t e = smem_opt_in(k, widest([](int c) { return row_layout(c, false, EPI).total; }),
                                done);
    if (e != cudaSuccess) return e;
    mlp_fwd_kernel<NT, EPI><<<row_blocks(T, C), kThreads, row_layout(C, false, EPI).total, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<bf16*>(out), T,
        C, H, approx, ln);
    return cudaGetLastError();
  });
}

// K13's dx kernel; with resid (K15's second step) dz is added before the rounding
cudaError_t launch_dx(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* dout, const void* resid, void* dx, int T, int C, int H,
                      int approx, cudaStream_t s) {
  if (!row_shape_ok(T, C, H)) return cudaErrorInvalidValue;
  auto go = [&](auto nt, auto res) {
    constexpr int NT = decltype(nt)::value;
    constexpr bool RES = decltype(res)::value;
    static std::atomic<unsigned> done{0};
    const void* k = reinterpret_cast<const void*>(mlp_dx_kernel<NT, RES>);
    cudaError_t e = smem_opt_in(k, widest([](int c) { return row_layout(c, true).total; }), done);
    if (e != cudaSuccess) return e;
    mlp_dx_kernel<NT, RES><<<row_blocks(T, C), kThreads, row_layout(C, true).total, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const bf16*>(w2), static_cast<const bf16*>(dout),
        static_cast<const bf16*>(resid), static_cast<bf16*>(dx), T, C, H, approx);
    return cudaGetLastError();
  };
  return with_nt(C, [&](auto nt) {
    return resid != nullptr ? go(nt, std::true_type{}) : go(nt, std::false_type{});
  });
}

template <int MW, int NTH>
cudaError_t launch_dw_kernel(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                             const bf16* dout, float* pw1, float* pw2, float* pb, int T, int C,
                             int H, int approx, int splits, bool db2, cudaStream_t s) {
  static std::atomic<unsigned> done{0};
  // H only sets the slice count, not the layout
  cudaError_t e = smem_opt_in(reinterpret_cast<const void*>(mlp_dw_kernel<MW, NTH>),
                              widest([](int c) { return dw_layout(c, 64).total; }), done);
  if (e != cudaSuccess) return e;
  const DwGeo g = dw_geo(C, H);
  const int steps = T / g.R;
  const int per = (steps + splits - 1) / splits;
  mlp_dw_kernel<MW, NTH><<<dim3(g.nslices * g.parts, splits), kThreads, dw_layout(C, H).total,
                           s>>>(
      x, w1, b1, w2, dout, pw1, pw2, pb, T, C, H, approx, per, int(db2));
  return cudaGetLastError();
}

// K13's weight-gradient kernel and its reductions: dW1, dW2, red = db1 | db2 (db2 zero
// unless `db2`)
cudaError_t launch_dw(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* dout, void* dw1, void* dw2, void* red, void* work, int T,
                      int C, int H, int approx, bool db2, cudaStream_t s) {
  if (!row_shape_ok(T, C, H)) return cudaErrorInvalidValue;
  const DwWork w = dw_work(T, C, H);
  unsigned char* base = static_cast<unsigned char*>(work);
  float* pw1 = reinterpret_cast<float*>(base);
  float* pw2 = reinterpret_cast<float*>(base + w.pw2);
  float* pb = reinterpret_cast<float*>(base + w.pb);
  float* tmp = reinterpret_cast<float*>(base + w.tmp);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  const bf16* db = static_cast<const bf16*>(dout);
  cudaError_t e =
      C <= 96    ? launch_dw_kernel<3, 4>(xb, w1b, b1f, w2b, db, pw1, pw2, pb, T, C, H, approx,
                                          w.splits, db2, s)
      : C <= 192 ? launch_dw_kernel<6, 4>(xb, w1b, b1f, w2b, db, pw1, pw2, pb, T, C, H, approx,
                                          w.splits, db2, s)
                 : launch_dw_kernel<6, 1>(xb, w1b, b1f, w2b, db, pw1, pw2, pb, T, C, H, approx,
                                          w.splits, db2, s);
  if (e != cudaSuccess) return e;
  const int WH = C * H;
  e = reduce_rows(pw1, static_cast<float*>(dw1), w.splits, WH, tmp, s);
  if (e != cudaSuccess) return e;
  e = reduce_rows(pw2, static_cast<float*>(dw2), w.splits, WH, tmp, s);
  if (e != cudaSuccess) return e;
  return reduce_rows(pb, static_cast<float*>(red), w.splits, H + C, tmp, s);
}

// K15's workspace: du_lo (bf16, T x C), its first step's partial rows (db2 | dgamma |
// dbeta, one a row block) and their reduction's scratch, then K13's weight-gradient
// workspace (dw_work)
struct BlockBwdWork {
  size_t part, tmp, dw, total;
};

inline BlockBwdWork block_bwd_work(int T, int C, int H) {
  const int nb = row_blocks(T, C);
  BlockBwdWork w;
  size_t off = align128(size_t(T) * C * 2);
  w.part = off; off += align128(size_t(nb) * 3 * C * 4);
  w.tmp = off; off += align128(reduce_rows_tmp_floats(nb, 3 * C) * 4);
  w.dw = off; off += dw_work(T, C, H).total;
  w.total = off;
  return w;
}

// K15's first step alone: du_lo, and red = db2 | dgamma | dbeta
cudaError_t launch_block_du(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, const void* gamma, const void* dscale,
                            const void* dz, void* du_lo, void* red, void* work, int T, int C,
                            int H, int approx, float ln_eps, cudaStream_t s) {
  const BlockBwdWork w = block_bwd_work(T, C, H);
  unsigned char* base = static_cast<unsigned char*>(work);
  float* part = reinterpret_cast<float*>(base + w.part);
  const LnArgs ln{static_cast<const float*>(gamma), nullptr, static_cast<const float*>(dscale),
                  static_cast<const bf16*>(dz), part, ln_eps};
  cudaError_t e = launch_row<kLnBwd>(x, w1, b1, w2, b2, du_lo, T, C, H, approx, ln, s);
  if (e != cudaSuccess) return e;
  return reduce_rows(part, static_cast<float*>(red), row_blocks(T, C), 3 * C,
                     reinterpret_cast<float*>(base + w.tmp), s);
}

// K15: the row kernel with the LayerNorm backward epilogue (du_lo, db2 | dgamma |
// dbeta), K13's dx kernel on du_lo with the residual, K13's weight-gradient kernel on
// du_lo with its db2 off, and the reductions; red = db1 | db2 | dgamma | dbeta
cudaError_t launch_block_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* gamma, const void* dscale,
                             const void* dz, void* dx, void* dw1, void* dw2, void* red,
                             void* work, int T, int C, int H, int approx, float ln_eps,
                             cudaStream_t s) {
  const BlockBwdWork w = block_bwd_work(T, C, H);
  unsigned char* base = static_cast<unsigned char*>(work);
  float* r = static_cast<float*>(red);
  // the weight-gradient reduction writes db1 | zeros first; step 1's goes over the zeros
  cudaError_t e = launch_row<kLnBwd>(
      x, w1, b1, w2, b2, base, T, C, H, approx,
      LnArgs{static_cast<const float*>(gamma), nullptr, static_cast<const float*>(dscale),
             static_cast<const bf16*>(dz), reinterpret_cast<float*>(base + w.part), ln_eps},
      s);
  if (e != cudaSuccess) return e;
  e = launch_dx(x, w1, b1, w2, base, dz, dx, T, C, H, approx, s);
  if (e != cudaSuccess) return e;
  e = launch_dw(x, w1, b1, w2, base, dw1, dw2, red, base + w.dw, T, C, H, approx, false, s);
  if (e != cudaSuccess) return e;
  return reduce_rows(reinterpret_cast<float*>(base + w.part), r + H, row_blocks(T, C), 3 * C,
                     reinterpret_cast<float*>(base + w.tmp), s);
}

}  // namespace
}  // namespace hs

extern "C" {

int hs_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               void* out, int T, int C, int H, int approx, void* stream) {
  return int(hs::launch_row<hs::kNoEpi>(x, w1, b1, w2, b2, out, T, C, H, approx, hs::LnArgs{},
                                        static_cast<cudaStream_t>(stream)));
}

int hs_mlp_block_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* gamma, const void* beta, const void* dscale,
                     void* out, int T, int C, int H, int approx, int has_dp, float ln_eps,
                     void* stream) {
  const hs::LnArgs ln{static_cast<const float*>(gamma), static_cast<const float*>(beta),
                      static_cast<const float*>(has_dp ? dscale : nullptr), nullptr, nullptr,
                      ln_eps};
  return int(hs::launch_row<hs::kLnFwd>(x, w1, b1, w2, b2, out, T, C, H, approx, ln,
                                        static_cast<cudaStream_t>(stream)));
}

size_t hs_mlp_bwd_workspace(int T, int C, int H) { return hs::dw_work(T, C, H).total; }

// the token splits of K13's weight-gradient kernel (one partial row set each)
int hs_mlp_bwd_splits(int T, int C, int H) { return hs::dw_splits(T, C, H); }

// K13 step 1 alone: dx; with resid (may be null) K15 step 2: dx + resid before the rounding
int hs_mlp_bwd_dx(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* dout, const void* resid, void* dx, int T, int C, int H, int approx,
                  void* stream) {
  return int(hs::launch_dx(x, w1, b1, w2, dout, resid, dx, T, C, H, approx,
                           static_cast<cudaStream_t>(stream)));
}

// K13 step 2 alone: dW1, dW2, db1 | db2 (red); work holds hs_mlp_bwd_workspace bytes
int hs_mlp_bwd_dw(const void* x, const void* w1, const void* b1, const void* w2,
                  const void* dout, void* dw1, void* dw2, void* red, void* work, int T, int C,
                  int H, int approx, void* stream) {
  return int(hs::launch_dw(x, w1, b1, w2, dout, dw1, dw2, red, work, T, C, H, approx, true,
                           static_cast<cudaStream_t>(stream)));
}

// K13: the dx kernel, then the weight-gradient kernel and its reductions, on one stream
// (b2 does not enter the backward)
int hs_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               const void* dout, void* dx, void* dw1, void* dw2, void* red, void* work, int T,
               int C, int H, int approx, void* stream) {
  (void)b2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = hs::launch_dx(x, w1, b1, w2, dout, nullptr, dx, T, C, H, approx, s);
  if (e != cudaSuccess) return int(e);
  return int(hs::launch_dw(x, w1, b1, w2, dout, dw1, dw2, red, work, T, C, H, approx, true, s));
}

// K15's workspace: du_lo, the partial rows of its steps and their reductions' scratch
size_t hs_mlp_block_bwd_workspace(int T, int C, int H) {
  return hs::block_bwd_work(T, C, H).total;
}

// K15 step 1 alone: du_lo (T x C bf16) and red = db2 | dgamma | dbeta; work holds
// hs_mlp_block_bwd_workspace bytes
int hs_mlp_block_bwd_du(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* gamma, const void* dscale, const void* dz,
                        void* du_lo, void* red, void* work, int T, int C, int H, int approx,
                        int has_dp, float ln_eps, void* stream) {
  return int(hs::launch_block_du(x, w1, b1, w2, b2, gamma, has_dp ? dscale : nullptr, dz,
                                 du_lo, red, work, T, C, H, approx, ln_eps,
                                 static_cast<cudaStream_t>(stream)));
}

int hs_mlp_block_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* gamma, const void* beta, const void* dscale,
                     const void* dz, void* dx, void* dw1, void* dw2, void* red, void* work,
                     int T, int C, int H, int approx, int has_dp, float ln_eps, void* stream) {
  (void)beta;  // beta does not enter the backward
  return int(hs::launch_block_bwd(x, w1, b1, w2, b2, gamma, has_dp ? dscale : nullptr, dz, dx,
                                  dw1, dw2, red, work, T, C, H, approx, ln_eps,
                                  static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
