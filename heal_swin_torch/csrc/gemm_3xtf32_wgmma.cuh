// The 3xTF32 product core on Hopper's warpgroup MMA (wgmma.mma_async, sm_90a): the f32
// K13's and K15's products (mlp_f32.cu).
//
// gemm_3xtf32_wg_kernel: out (M x N) = op(A) op(B) over K, f32 operands taken as 3xTF32
// (tf32.cuh: hi = tf32(a), lo = a - hi; lo_a hi_b, hi_a lo_b, hi_a hi_b, the small terms
// first).  op(A) is M x K, op(B) K x N; each operand comes K-contiguous ("KC": A row-major
// M x K, B row-major N x K, i.e. B^T) or M/N-contiguous ("MC": A row-major K x M, B
// row-major K x N), so that x W1 (NN), dout W2^T and dh W1^T (NT) and x^T dh, g^T dout
// (TN) are one kernel: no operand is copied transposed to device memory.
//
// - A block is 3 warpgroups: two consumers, each 64 rows of a 128 x 96 output tile on
//   wgmma m64n96k8 (A from registers, B K-major from shared memory: tf32 takes no
//   transposed operand), and a producer that loads and splits B (setmaxnreg: 216 or, in
//   DUAL, 232 registers a consumer thread, 72 or 40 a producer thread).
// - Raw slices of 32 k (A 128 x 32, B 96 x 32 f32, 28 KiB) arrive by TMA (one thread
//   issues a slice's 2-8 boxes and its mbarrier counts the bytes in) in a ring of 5,
//   3 slices ahead, with the 128-byte swizzle, rows past M, N or K zero-filled.  Each
//   operand element is split once: A by the consumer thread whose wgmma fragment holds
//   it, in registers as it loads the fragment from the raw slice; B by the producer into
//   hi and lo planes, each row's 32 k in one 128-byte row, 16-byte chunks swizzled (chunk
//   ^ row % 8: the 128-byte swizzle a wgmma descriptor names, and TMA's: a K-contiguous B
//   splits in place, an N-contiguous one is transposed in registers on the way).  Two
//   split slices (24 KiB each) alternate, handed over by named barriers (full: landed and
//   split; empty: its wgmmas done, so its planes and raw slot are free), so the producer
//   loads and splits ahead while the consumers multiply.  On the way, splitting both
//   operands into planes (on the consumers' warps, then on the producer alone) and
//   loading by cp.async each held the products far from their tensor-core time on an
//   H100: a warp that issues wgmmas does little else until they are done.
// - A slice's 3 x 4 wgmmas sum into a zeroed accumulator t (scale-d 0 on its first),
//   added to the tile's running sum with one add rounded to nearest once they are done:
//   the tensor core's accumulator does not round to nearest, so a chain over all of K
//   drifts (PR 26's lesson, kept from gemm_3xtf32_kernel).
// - Persistent: a grid of at most one block an SM walks its tiles (n fastest, then m,
//   then the split and the group), their slices one flat sequence, so that the producer
//   loads and splits the next tile's slices while the consumers store the last tile.
// - Modes: DUAL (two products of one tile, op set 0 then 1, into two accumulators, for
//   the f32 K13's h = x W1 and dg = dout W2^T), and groups (a tile's group picks its op
//   set: the TN pair dW2 = g^T dout, dW1^T = dh^T x in one launch).  Split-K: blockIdx
//   walks splits of kchunk k each, written as fixed-order partial rows for reduce_rows
//   (no float atomics: two launches give the same bits).
// - The epilogue is a type (Epi::store on the consumers' finished accumulators,
//   Epi::on_split in the producer on a landed raw slice), as gemm_3xtf32_kernel's.
// Shared memory: 140 KiB of raw ring, 48 KiB of B planes, 30 KiB of epilogue scratch:
// one block an SM; 144 accumulator registers a consumer thread in DUAL, 96 else, and 32
// for a slice's A fragments.
#pragma once

#include <cuda.h>

#include "common.cuh"
#include "tf32.cuh"

namespace hs {
namespace {

constexpr int WG_BM = 128;           // block rows: two warpgroups of 64
constexpr int WG_BN = 96;            // block columns: wgmma n96
constexpr int WG_BK = 32;            // k of a slice: 128 bytes of f32, one swizzle row
constexpr int WG_STAGES = 5;         // raw slices in the ring
constexpr int WG_AHEAD = WG_STAGES - 2;  // slices loaded ahead of the split (the ring's
                                         // other two: the consumers' last two slices)
// registers a thread after setmaxnreg (384 x 168 at launch, 2 x 128 x 232 + 128 x 40 =
// 2 x 128 x 216 + 128 x 72): DUAL's consumers hold two accumulators, the others' producer
// gets room for the split's loads in flight
template <bool DUAL>
__host__ __device__ constexpr int wg_consumer_regs() { return DUAL ? 232 : 216; }
template <bool DUAL>
__host__ __device__ constexpr int wg_producer_regs() { return DUAL ? 40 : 72; }
constexpr int WG_CONSUMERS = 256;    // two warpgroups of wgmma (threads 0-255)
constexpr int WG_PRODUCER = 128;     // one warpgroup of loads and splits (256-383)
constexpr int WG_THREADS = WG_CONSUMERS + WG_PRODUCER;
constexpr int WG_ACC = WG_BN / 2;    // accumulator floats a thread (64 x 96 over 128)
constexpr int WG_MAX_K2 = 768;       // DUAL's second sums: the K (C) a scratch row holds

// a raw slice as TMA lands it: A then B, each KC (rows of 32 k, 128 bytes) or MC (boxes
// of 32 k-rows x 32 columns), 128-byte swizzled (wg_kc, wg_mc)
constexpr int WG_RAW_A = WG_BM * WG_BK;           // floats of a raw A slice
constexpr int WG_RAW = WG_RAW_A + WG_BN * WG_BK;  // floats of a raw slice
constexpr int WG_PLANE_B = WG_BN * 128;           // bytes of B's hi or lo plane
constexpr int WG_PLANES = 2 * WG_PLANE_B;         // a split slice: Bhi Blo
// floats: the consumers' column sums a warp for each of two tiles (a warpgroup may store
// tile t + 1's while the other still sums tile t's: the two meet only at the consumers'
// barrier of each epilogue), and two tiles' producer column sums a warp
constexpr int WG_SCRATCH = 2 * 8 * WG_BN + 2 * 4 * WG_MAX_K2;
// named barriers (0 is __syncthreads): a split slice full, one for each consumer
// warpgroup (1 + 2 b + wg: the producer and that warpgroup, so that the two run apart)
// or empty (5 + b: all three), the consumers alone (7), the producer alone (8)
constexpr int WG_BAR_FULL = 1, WG_BAR_EMPTY = 5, WG_BAR_CONSUMERS = 7, WG_BAR_PRODUCER = 8;
constexpr size_t WG_SMEM = 1024 + size_t(WG_STAGES) * WG_RAW * 4 + 2 * size_t(WG_PLANES) +
                           size_t(WG_SCRATCH) * 4 + WG_STAGES * 8;  // + 1 KiB to align to 1 KiB
static_assert(WG_SMEM <= 227 * 1024, "a block's shared memory on sm_90");

// float offsets in a 128-byte-swizzled raw operand (TMA's SWIZZLE_128B, the wgmma
// descriptor's 128-byte swizzle): KC, row r's k at chunk (k / 4) ^ (r % 8); MC, column
// m's k-row k in box m / 32 at chunk (m % 32 / 4) ^ (k % 8)
__device__ __forceinline__ int wg_kc(int r, int k) {
  return r * WG_BK + ((((k >> 2) ^ r) & 7) << 2) + (k & 3);
}
__device__ __forceinline__ int wg_mc(int k, int m) {
  return (m >> 5) * 1024 + k * 32 + (((((m & 31) >> 2) ^ k) & 7) << 2) + (m & 3);
}

// the operands and outputs of one launch
struct WgArgs {
  CUtensorMap tA[2], tB[2];  // the operands' TMA maps (wg_launch encodes them)
  const float* A[2];  // op set s: DUAL's product s, or group s's
  const float* B[2];
  float* out[2];      // the epilogue's outputs
  float* aux;         // an M x N matrix laid out as out[0] (a residual, GELU'(h))
  const float* bias;  // N, or null
  float* part;        // partial rows: a row block's column sums (DUAL), a split's products (TN)
  int M, N, K;
  int kchunk;         // k of a split (K without one); a multiple of 32
  int splits, groups, mt, nt, tiles;
  int ld_part;        // floats of a partial row
};

// a slice of the block's flat sequence: its tile (group, split z, row block mb, column
// block nb), DUAL's product (phase), its first k, last of the tile
struct WgSlice {
  int group, z, mb, nb, phase, k0;
  bool last;
};

// a tile's coordinates (group, z, mb, nb) in v
__device__ __forceinline__ void wg_tile_of(const WgArgs& a, int tile, WgSlice& v) {
  v.nb = tile % a.nt;
  int r = tile / a.nt;
  v.mb = r % a.mt;
  r /= a.mt;
  v.z = r % a.splits;
  v.group = r / a.splits;
}

// a walk over the block's slices: the tile's coordinates divided out once a tile, the
// slice's advanced by one (no integer division a slice)
struct WgWalk {
  WgSlice v;
  int s, tile, tiles_done;  // slice of the tile, the tile, the block's tiles before it

  __device__ __forceinline__ void at_tile(const WgArgs& a) { wg_tile_of(a, tile, v); }
  __device__ __forceinline__ void at_slice(const WgArgs& a, int kt, bool dual) {
    v.phase = dual && s >= kt ? 1 : 0;
    const int ks = s - v.phase * kt;
    v.k0 = v.z * a.kchunk + ks * WG_BK;
    v.last = s == (dual ? 2 * kt : kt) - 1;
  }
  // the block's first slice
  __device__ __forceinline__ void begin(const WgArgs& a, int kt, bool dual) {
    s = 0;
    tile = int(blockIdx.x);
    tiles_done = 0;
    at_tile(a);
    at_slice(a, kt, dual);
  }
  __device__ __forceinline__ void next(const WgArgs& a, int kt, bool dual) {
    if (v.last) {
      s = 0;
      tile += int(gridDim.x);
      ++tiles_done;
      at_tile(a);
    } else {
      ++s;
    }
    at_slice(a, kt, dual);
  }
};

// --- wgmma (PTX ISA 8: tf32 takes both operands K-major from shared memory)

// a shared-memory matrix descriptor: start address >> 4, leading byte offset 16 (unused
// by a swizzled K-major operand), stride byte offset 1024 (8 rows of 128 bytes), 128-byte
// swizzle (layout type 1 in bits 62-63)
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr) {
  return uint64_t((saddr & 0x3FFFFu) >> 4) | (uint64_t(1) << 16) | (uint64_t(64) << 32) |
         (uint64_t(1) << 62);
}

// d (64 x 96 f32 over the warpgroup) = A (64 x 8 tf32) B (8 x 96) [+ d when scale_d], A
// from registers (a: 4 tf32 a thread, rows g, g + 8 and k c, c + 4 of the warp's 16 rows,
// mma.sync m16n8k8's A layout), B from shared memory
__device__ __forceinline__ void wgmma_n96_tf32_rs(float (&d)[WG_ACC], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
// arrive at named barrier ``id`` of ``threads`` without waiting (the barrier's other
// threads wait with named_sync)
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// --- mbarriers and TMA
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// the barrier's phase completes when this arrival and ``bytes`` of TMA writes are in
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// a box of a 2-D map at (c0 innermost, c1) into dst, counted by bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// the generic proxy's shared-memory writes (the split) made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the accumulator's registers read only after the wait (the compiler may not move the
// reads above it)
__device__ __forceinline__ void wg_fence_regs(float (&d)[WG_ACC]) {
#pragma unroll
  for (int i = 0; i < WG_ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// A's fragment registers held until the wait (the wgmmas read them asynchronously)
__device__ __forceinline__ void wg_hold_frags(const uint32_t (&f)[WG_BK / 8][4]) {
#pragma unroll
  for (int k = 0; k < WG_BK / 8; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(f[k][e]) : "memory");
}

// --- the raw ring and the split pass

// a raw operand slice of ROWS rows (the tile's m or n at r0) and 32 k (at k0) by TMA into
// raw: KC one box of 32 k x ROWS rows, MC ROWS / 32 boxes of 32 columns x 32 k-rows
template <int ROWS, bool KC>
__device__ __forceinline__ void wg_tma(float* raw, const CUtensorMap* map, int r0, int k0,
                                       uint64_t* bar) {
  if constexpr (KC) {
    tma_load_2d(raw, map, k0, r0, bar);
  } else {
#pragma unroll
    for (int j = 0; j < ROWS / 32; ++j) tma_load_2d(raw + j * 1024, map, r0 + 32 * j, k0, bar);
  }
}

// B's hi and lo planes (ROWS x 128 bytes each, 16-byte chunk kq of row r at chunk kq ^ (r
// % 8)) of its raw slice: KC has that layout already and splits in place, a float4 a
// thread; MC reads 4 k-rows of one column (32 threads a box row: conflict-free) and
// writes them as the column's 4 k (8 distinct chunks a quarter warp).  UNROLL: the units a
// thread has in flight (all of them with 72 registers, 3 with 40).
template <int ROWS, bool KC, int UNROLL>
__device__ __forceinline__ void wg_split(const float* raw, unsigned char* hi, unsigned char* lo,
                                         int tid) {
#pragma unroll UNROLL
  for (int j = 0; j < ROWS * 8 / WG_PRODUCER; ++j) {
    const int i = tid + j * WG_PRODUCER;
    int off;
    float4 v;
    if constexpr (KC) {
      off = i * 16;
      v = *reinterpret_cast<const float4*>(raw + i * 4);
    } else {
      const int r = i % ROWS, kq = i / ROWS;
      off = r * 128 + ((kq ^ (r & 7)) << 4);
      v = make_float4(raw[wg_mc(4 * kq, r)], raw[wg_mc(4 * kq + 1, r)],
                      raw[wg_mc(4 * kq + 2, r)], raw[wg_mc(4 * kq + 3, r)]);
    }
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

// the thread's A fragments of a raw slice (row r = wg_row, k c and c + 4 of each 8),
// split: ah (hi) and al (lo) for each of the slice's 4 k steps
template <bool KC>
__device__ __forceinline__ void wg_a_frags(const float* ra, int r, int c,
                                           uint32_t (&ah)[WG_BK / 8][4],
                                           uint32_t (&al)[WG_BK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < WG_BK / 8; ++kk) {
    const int k = kk * 8 + c;
    float v[4];
    if constexpr (KC) {  // banks 4 (chunk ^ g) + c: conflict-free
      v[0] = ra[wg_kc(r, k)];
      v[1] = ra[wg_kc(r + 8, k)];
      v[2] = ra[wg_kc(r, k + 4)];
      v[3] = ra[wg_kc(r + 8, k + 4)];
    } else {  // two lanes a bank
      v[0] = ra[wg_mc(k, r)];
      v[1] = ra[wg_mc(k, r + 8)];
      v[2] = ra[wg_mc(k + 4, r)];
      v[3] = ra[wg_mc(k + 4, r + 8)];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(v[e], ah[kk][e], al[kk][e]);
  }
}

// acc = t (the tile's first slice of a product) or acc + t rounded to nearest
__device__ __forceinline__ void wg_fold(float (&acc)[WG_ACC], const float (&t)[WG_ACC],
                                        bool first) {
#pragma unroll
  for (int i = 0; i < WG_ACC; ++i) acc[i] = first ? t[i] : __fadd_rn(acc[i], t[i]);
}

// A thread's accumulator element 4 j + 2 h + e sits at tile row wg_row(tid) + 8 h and tile
// column 8 j + wg_col(tid) + e (j < 12, h, e < 2): wgmma's f32 accumulator layout, warp w
// of a warpgroup holding its rows 16 w .. 16 w + 15 as mma.sync m16n8 would.
__device__ __forceinline__ int wg_row(int tid) {
  return (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
}
__device__ __forceinline__ int wg_col(int tid) { return 2 * (tid & 3); }

// ---------------------------------------------------------------------------------
// gemm_3xtf32_wg_kernel<AKC, B0KC, B1KC, DUAL, Epi>: see the top of this file.  B1KC is
// op set 1's B layout (DUAL's second product); A's layout is both sets'.  Every block
// runs at least one tile (grid <= tiles).  Threads 0-255 consume (wgmma, epilogue),
// 256-383 produce (loads, splits); Epi::store runs on the consumers (tid 0-255),
// Epi::on_split on the producer (its tid 0-127).
// ---------------------------------------------------------------------------------
template <bool AKC, bool B0KC, bool B1KC, bool DUAL, class Epi>
__global__ void __launch_bounds__(WG_THREADS, 1)
gemm_3xtf32_wg_kernel(const __grid_constant__ WgArgs a) {
  extern __shared__ unsigned char wg_dyn[];
  unsigned char* sm = wg_dyn + ((1024u - (smem_u32(wg_dyn) & 1023u)) & 1023u);
  float* raw = reinterpret_cast<float*>(sm);
  unsigned char* planes = sm + size_t(WG_STAGES) * WG_RAW * 4;
  float* scratch = reinterpret_cast<float*>(planes + 2 * WG_PLANES);
  float* psum = scratch + 2 * 8 * WG_BN;  // the producer's column sums, two tiles' rows
  uint64_t* landed = reinterpret_cast<uint64_t*>(scratch + WG_SCRATCH);  // a raw slot's bytes in
  const int kt = a.kchunk / WG_BK;
  const int spt = DUAL ? 2 * kt : kt;
  const int Q = ((a.tiles - 1 - int(blockIdx.x)) / int(gridDim.x) + 1) * spt;
  if (threadIdx.x == 0) {
    for (int i = 0; i < WG_STAGES; ++i) mbar_init(landed + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= WG_CONSUMERS) {  // the producer
    setmaxnreg_dec<wg_producer_regs<DUAL>()>();
    const int tid = threadIdx.x - WG_CONSUMERS;
    WgWalk lw, sw;  // the loads' walk (WG_AHEAD slices ahead) and the splits'
    lw.begin(a, kt, DUAL);
    sw.begin(a, kt, DUAL);
    auto load = [&](int q) {  // slice q by TMA into its raw slot (one thread)
      const WgSlice& v = lw.v;
      const int o = DUAL ? v.phase : v.group;
      float* ra = raw + (q % WG_STAGES) * WG_RAW;
      uint64_t* bar = landed + q % WG_STAGES;
      mbar_expect_tx(bar, WG_RAW * 4);
      wg_tma<WG_BM, AKC>(ra, &a.tA[o], v.mb * WG_BM, v.k0, bar);
      if (o == 0)
        wg_tma<WG_BN, B0KC>(ra + WG_RAW_A, &a.tB[0], v.nb * WG_BN, v.k0, bar);
      else
        wg_tma<WG_BN, B1KC>(ra + WG_RAW_A, &a.tB[1], v.nb * WG_BN, v.k0, bar);
    };
    if (tid == 0)
      for (int q = 0; q < WG_AHEAD && q < Q; ++q) {
        load(q);
        lw.next(a, kt, DUAL);
      }
#pragma unroll 1
    for (int q = 0; q < Q; ++q) {
      // slice q - 2's wgmmas done: its planes and raw slot free
      if (q >= 2) named_sync(WG_BAR_EMPTY + (q & 1), WG_THREADS);
      if (tid == 0 && q + WG_AHEAD < Q) {  // into slice q - 2's slot
        load(q + WG_AHEAD);
        lw.next(a, kt, DUAL);
      }
      mbar_wait(landed + q % WG_STAGES, (q / WG_STAGES) & 1);  // slice q has landed
      const WgSlice& v = sw.v;
      const float* ra = raw + (q % WG_STAGES) * WG_RAW;
      unsigned char* pb = planes + (q & 1) * WG_PLANES;
      constexpr int unroll = DUAL ? 3 : WG_BN * 8 / WG_PRODUCER;
      if ((DUAL ? v.phase : v.group) == 0)
        wg_split<WG_BN, B0KC, unroll>(ra + WG_RAW_A, pb, pb + WG_PLANE_B, tid);
      else
        wg_split<WG_BN, B1KC, unroll>(ra + WG_RAW_A, pb, pb + WG_PLANE_B, tid);
      Epi::on_split(a, v, ra, psum + (sw.tiles_done & 1) * 4 * WG_MAX_K2, tid);
      fence_proxy_async();
      named_arrive(WG_BAR_FULL + 2 * (q & 1), WG_PRODUCER + 128);
      named_arrive(WG_BAR_FULL + 2 * (q & 1) + 1, WG_PRODUCER + 128);
      sw.next(a, kt, DUAL);
    }
    return;
  }

  setmaxnreg_inc<wg_consumer_regs<DUAL>()>();
  const int tid = threadIdx.x;
  float acc0[WG_ACC], acc1[WG_ACC], t[WG_ACC];
#pragma unroll
  for (int i = 0; i < WG_ACC; ++i) acc0[i] = acc1[i] = t[i] = 0.f;
  const int r = wg_row(tid), c = tid & 3;  // the thread's A fragment rows r, r + 8; k c, c + 4
  // the walk kept lean (the accumulators take the registers): the slice s of the tile,
  // the tile, the block's tiles done
  int s = 0, tile = int(blockIdx.x), tiles_done = 0;
#pragma unroll 1
  for (int q = 0; q < Q; ++q) {
    // slice q landed, B split into planes q % 2 (each warpgroup with the producer alone)
    named_sync(WG_BAR_FULL + 2 * (q & 1) + (tid >> 7), WG_PRODUCER + 128);
    mbar_wait(landed + q % WG_STAGES, (q / WG_STAGES) & 1);  // (seen by the producer too)
    uint32_t ah[WG_BK / 8][4], al[WG_BK / 8][4];
    wg_a_frags<AKC>(raw + (q % WG_STAGES) * WG_RAW, r, c, ah, al);
    {  // the slice's 12 wgmmas into t
      const uint32_t bhi = smem_u32(planes + (q & 1) * WG_PLANES), blo = bhi + WG_PLANE_B;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 8; ++kk) {
        wgmma_n96_tf32_rs(t, al[kk], wg_desc(bhi + 32 * kk), kk != 0);
        wgmma_n96_tf32_rs(t, ah[kk], wg_desc(blo + 32 * kk), 1);
        wgmma_n96_tf32_rs(t, ah[kk], wg_desc(bhi + 32 * kk), 1);
      }
      wg_commit();
    }
    wg_wait_all();
    wg_fence_regs(t);
    wg_hold_frags(ah);
    wg_hold_frags(al);
    if (q + 2 < Q) named_arrive(WG_BAR_EMPTY + (q & 1), WG_THREADS);  // its planes, raw slot free
    if (!DUAL || s < kt)
      wg_fold(acc0, t, s == 0);
    else
      wg_fold(acc1, t, s == kt);
    if (s == spt - 1) {  // the tile's epilogue, its sums done (with the wgmmas' registers
                         // free: run while the next slice's wgmmas were issued, it took as long
                         // and spilled)
      WgSlice v;
      wg_tile_of(a, tile, v);
      Epi::store(a, v, acc0, acc1, scratch + (tiles_done & 1) * 8 * WG_BN,
                 psum + (tiles_done & 1) * 4 * WG_MAX_K2, tid);
      s = 0;
      tile += int(gridDim.x);
      ++tiles_done;
    } else {
      ++s;
    }
  }
}

// --- the TMA maps, encoded on the host through the driver's cuTensorMapEncodeTiled (its
// entry point from the runtime: no link to the driver library)
using TmapEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline TmapEncode tmap_encoder() {
  static const TmapEncode fn = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<TmapEncode>(fn)
               : nullptr;
  }();
  return fn;
}

// a row-major f32 matrix (rows x cols) in boxes of 32 columns x box_rows rows, 128-byte
// swizzle, zeros past its edges
inline bool tmap_2d(CUtensorMap* map, const float* p, int rows, int cols, int box_rows) {
  const TmapEncode encode = tmap_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t pitch[1] = {cuuint64_t(cols) * 4};
  const cuuint32_t box[2] = {32, cuuint32_t(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims, pitch,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// an operand's map: KC (rows x K, boxes of 32 k x rows), MC (K x cols, boxes 32 x 32)
inline bool wg_tmap(CUtensorMap* map, const float* p, bool kc, int rows, int K, int box_rows) {
  return kc ? tmap_2d(map, p, rows, K, box_rows) : tmap_2d(map, p, K, rows, 32);
}

// the launch: a grid of min(tiles, SMs) blocks, WG_SMEM bytes of shared memory each
template <bool AKC, bool B0KC, bool B1KC, bool DUAL, class Epi>
inline cudaError_t wg_launch(WgArgs a, cudaStream_t s) {
  static std::atomic<unsigned> done{0};
  const cudaError_t e = smem_opt_in(
      reinterpret_cast<const void*>(gemm_3xtf32_wg_kernel<AKC, B0KC, B1KC, DUAL, Epi>),
      WG_SMEM, done);
  if (e != cudaSuccess) return e;
  for (int o = 0; o < (DUAL || a.groups == 2 ? 2 : 1); ++o)
    if (!wg_tmap(&a.tA[o], a.A[o], AKC, a.M, a.K, WG_BM) ||
        !wg_tmap(&a.tB[o], a.B[o], o == 0 ? B0KC : B1KC, a.N, a.K, WG_BN))
      return cudaErrorInvalidValue;
  a.mt = (a.M + WG_BM - 1) / WG_BM;
  a.nt = (a.N + WG_BN - 1) / WG_BN;
  a.tiles = a.groups * a.splits * a.mt * a.nt;
  const int grid = a.tiles < sm_count() ? a.tiles : sm_count();
  gemm_3xtf32_wg_kernel<AKC, B0KC, B1KC, DUAL, Epi><<<grid, WG_THREADS, WG_SMEM, s>>>(a);
  return cudaGetLastError();
}

// the shapes every mode takes: K % 32 == 0 (and kchunk), M % 4 == 0, N % 4 == 0
inline bool wg_takes(int M, int N, int K) {
  return M > 0 && N > 0 && K > 0 && M % 4 == 0 && N % 4 == 0 && K % WG_BK == 0;
}

// ---------------------------------------------------------------------------------
// The generic epilogues
// ---------------------------------------------------------------------------------

// no work on a landed slice
struct WgNoHooks {
  __device__ __forceinline__ static void on_split(const WgArgs&, const WgSlice&, const float*,
                                                  float*, int) {}
};

// An epilogue reads its inputs (a bias, a residual, a stored factor) a chunk of column
// groups ahead of the chunk's stores: a load that may alias an earlier store waits for it,
// so in store order each would take a global load's latency.
constexpr int WG_EPI_CHUNK = 4;  // column groups j of a chunk (WG_BN / 8 / 3)

// bias pairs of the chunk's column groups J0 .. J0 + 3 (zeros past N or without a bias)
template <int J0>
__device__ __forceinline__ void wg_bias_pairs(const WgArgs& a, int n0,
                                              float2 (&b)[WG_EPI_CHUNK]) {
#pragma unroll
  for (int jj = 0; jj < WG_EPI_CHUNK; ++jj) {
    const int n = n0 + 8 * (J0 + jj);
    b[jj] = a.bias != nullptr && n < a.N ? *reinterpret_cast<const float2*>(a.bias + n)
                                         : make_float2(0.f, 0.f);
  }
}

// pairs of an M x N matrix p (laid out as out[0]) at the chunk's elements: rows m0, m0 + 8
template <int J0>
__device__ __forceinline__ void wg_matrix_pairs(const float* p, const WgArgs& a, int m0, int n0,
                                                float2 (&v)[WG_EPI_CHUNK][2]) {
#pragma unroll
  for (int jj = 0; jj < WG_EPI_CHUNK; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 8 * (J0 + jj), m = m0 + 8 * h;
      v[jj][h] = n < a.N && m < a.M ? *reinterpret_cast<const float2*>(p + size_t(m) * a.N + n)
                                    : make_float2(0.f, 0.f);
    }
}

// out[0] = sum [+ bias] (RESIDUAL: out[0] = aux + sum), M x N row-major
template <bool RESIDUAL>
struct WgEpiStore : WgNoHooks {
  template <int J0>
  __device__ __forceinline__ static void chunk(const WgArgs& a, const float (&acc)[WG_ACC],
                                               int m0, int n0) {
    float2 b[WG_EPI_CHUNK], r[WG_EPI_CHUNK][2];
    if constexpr (RESIDUAL)
      wg_matrix_pairs<J0>(a.aux, a, m0, n0, r);
    else
      wg_bias_pairs<J0>(a, n0, b);
#pragma unroll
    for (int jj = 0; jj < WG_EPI_CHUNK; ++jj) {
      const int j = J0 + jj, n = n0 + 8 * j;  // even, and N is: n < N means n + 1 < N
      if (n >= a.N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 8 * h;
        if (m >= a.M) continue;
        const float s0 = acc[4 * j + 2 * h], s1 = acc[4 * j + 2 * h + 1];
        *reinterpret_cast<float2*>(a.out[0] + size_t(m) * a.N + n) =
            RESIDUAL ? make_float2(__fadd_rn(r[jj][h].x, s0), __fadd_rn(r[jj][h].y, s1))
                     : make_float2(__fadd_rn(s0, b[jj].x), __fadd_rn(s1, b[jj].y));
      }
    }
  }
  __device__ __forceinline__ static void store(const WgArgs& a, const WgSlice& v,
                                               const float (&acc)[WG_ACC],
                                               const float (&)[WG_ACC], float*,
                                               const float*, int tid) {
    const int m0 = v.mb * WG_BM + wg_row(tid), n0 = v.nb * WG_BN + wg_col(tid);
    chunk<0>(a, acc, m0, n0);
    chunk<WG_EPI_CHUNK>(a, acc, m0, n0);
    chunk<2 * WG_EPI_CHUNK>(a, acc, m0, n0);
  }
};

// split-K partials of the TN products: split z's row of part (ld_part floats) holds group
// 0's M x N product row-major, then group 1's transposed (N x M row-major: x^T dh from
// dh^T x), for reduce_rows in a fixed order
struct WgEpiPartial : WgNoHooks {
  __device__ __forceinline__ static void store(const WgArgs& a, const WgSlice& v,
                                               const float (&acc)[WG_ACC],
                                               const float (&)[WG_ACC], float*,
                                               const float*, int tid) {
    float* base = a.part + size_t(v.z) * a.ld_part;
    const size_t MN = size_t(a.M) * a.N;
    const int m0 = v.mb * WG_BM + wg_row(tid), n0 = v.nb * WG_BN + wg_col(tid);
#pragma unroll
    for (int j = 0; j < WG_BN / 8; ++j) {
      const int n = n0 + 8 * j;
      if (n >= a.N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 8 * h;
        if (m >= a.M) continue;
        const float s0 = acc[4 * j + 2 * h], s1 = acc[4 * j + 2 * h + 1];
        if (v.group == 0) {
          *reinterpret_cast<float2*>(base + size_t(m) * a.N + n) = make_float2(s0, s1);
        } else {
          base[MN + size_t(n) * a.M + m] = s0;
          base[MN + size_t(n + 1) * a.M + m] = s1;
        }
      }
    }
  }
};

// --- the core's products alone (and the f32 K13's, K15's TN pair)

// out (M x N) = A (M x K) B (K x N) [+ bias]: NN, stored by Epi
template <class Epi>
inline cudaError_t wg_nn(const float* A, const float* B, const float* bias, float* out,
                         float* aux, int M, int N, int K, cudaStream_t s) {
  if (!wg_takes(M, N, K)) return cudaErrorInvalidValue;
  WgArgs a{};
  a.A[0] = A; a.B[0] = B; a.out[0] = out; a.aux = aux; a.bias = bias;
  a.M = M; a.N = N; a.K = K; a.kchunk = K; a.splits = 1; a.groups = 1;
  return wg_launch<true, false, false, false, Epi>(a, s);
}

// out (M x N) = A (M x K) B^T, B (N x K): NT, stored by Epi (aux: the residual)
template <class Epi>
inline cudaError_t wg_nt(const float* A, const float* B, float* out, float* aux, int M, int N,
                         int K, cudaStream_t s) {
  if (!wg_takes(M, N, K)) return cudaErrorInvalidValue;
  WgArgs a{};
  a.A[0] = A; a.B[0] = B; a.out[0] = out; a.aux = aux;
  a.M = M; a.N = N; a.K = K; a.kchunk = K; a.splits = 1; a.groups = 1;
  return wg_launch<true, true, true, false, Epi>(a, s);
}

constexpr int WG_TN_MAX_SPLITS = 64;  // reduce_rows sums them in one pass

// the TN products' k range of a split (a multiple of 32): the fewest splits whose tiles
// fill at least two waves of the card's SMs with the last wave 95% full, else the fullest
// (at the paper's stages 44, 11, 4 and 1 split of 2 x 3 x 1 .. 2 x 24 x 8 tiles); each
// split's partial products a row of the scratch
inline int wg_tn_chunk(int K, int M, int N, int groups) {
  const int tiles = groups * ((M + WG_BM - 1) / WG_BM) * ((N + WG_BN - 1) / WG_BN);
  const int sms = sm_count();
  const int most = K / WG_BK < WG_TN_MAX_SPLITS ? K / WG_BK : WG_TN_MAX_SPLITS;
  int S = 1;
  double best = 0.0;
  for (int s = 1; s <= most; ++s) {
    const int waves = (s * tiles + sms - 1) / sms;
    const double full = double(s) * tiles / (double(waves) * sms);
    if (s * tiles >= 2 * sms && full >= 0.95) {
      S = s;
      break;
    }
    if (full > best + 1e-9) {
      best = full;
      S = s;
    }
  }
  const int c = (K + S - 1) / S;
  return (c + WG_BK - 1) / WG_BK * WG_BK;
}
inline int wg_tn_splits(int K, int M, int N, int groups) {
  const int c = wg_tn_chunk(K, M, N, groups);
  return (K + c - 1) / c;
}

// floats of the TN products' scratch: the partial rows, then reduce_rows' (none for one
// split, written straight to the output)
inline size_t wg_tn_tmp_floats(int K, int M, int N, int groups) {
  const int S = wg_tn_splits(K, M, N, groups);
  const size_t row = size_t(groups) * M * N;
  return S == 1 ? 0 : S * row + reduce_rows_tmp_floats(S, int(row));
}

// out = [A0^T B0 (M x N) | (A1^T B1)^T (N x M)] over K rows (A* K x M, B* K x N; with one
// group only the first): split over K into partial rows in tmp, then reduce_rows in a
// fixed order.  K % 32 == 0, M % 4 == 0, N % 4 == 0.
inline cudaError_t wg_tn(const float* A0, const float* B0, const float* A1, const float* B1,
                         float* out, int K, int M, int N, int groups, float* tmp,
                         cudaStream_t s) {
  if (!wg_takes(M, N, K) || groups < 1 || groups > 2) return cudaErrorInvalidValue;
  WgArgs a{};
  a.A[0] = A0; a.B[0] = B0; a.A[1] = A1; a.B[1] = B1;
  a.M = M; a.N = N; a.K = K; a.kchunk = wg_tn_chunk(K, M, N, groups);
  a.splits = wg_tn_splits(K, M, N, groups);
  a.groups = groups;
  a.part = a.splits == 1 ? out : tmp;
  a.ld_part = groups * M * N;
  const cudaError_t e = wg_launch<false, false, false, false, WgEpiPartial>(a, s);
  if (e != cudaSuccess || a.splits == 1) return e;
  return reduce_rows(tmp, out, a.splits, a.ld_part, tmp + size_t(a.splits) * a.ld_part, s);
}

}  // namespace
}  // namespace hs
