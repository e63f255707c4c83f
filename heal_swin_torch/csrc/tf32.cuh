// 3xTF32 on mma.sync m16n8k8: the f32-accurate tensor-core product of the f32 kernels
// (window_attention_f32.cu: the f32 K1 and K2; tail_f32.cuh: the f32 K3 and K6-K9).
//
// Fragment layouts (PTX ISA, g = lane / 4, c = lane % 4): A (16 x 8, row) a0 (g, c),
// a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4); B (8 x 8, col) b0 (k c, n g), b1
// (k c + 4, n g); C (16 x 8) c0 (g, 2c), c1 (g, 2c + 1), c2 (g + 8, 2c), c3 (g + 8, 2c + 1).
// Each operand a is split in registers into hi = tf32(a) and lo = a - hi, and a b is
// taken as lo_a hi_b, then hi_a lo_b, then hi_a hi_b (the small terms first), leaving out
// lo_a lo_b and lo's dropped bits (~2^-21 relative in all).
#pragma once

#include "common.cuh"

namespace hs {
namespace {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (to nearest, ties away from
// zero): half of the 13 dropped bits' range added to the magnitude, then the 13 bits
// cleared.  Two integer operations where nvcc lowers cvt.rna.tf32.f32 to a longer
// compare-and-select sequence on sm_90a; the kernels split every operand they load.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(x) and lo = x - hi (exact), which the tensor core reads as tf32, its low 13
// bits dropped: hi + lo is x within ~2^-21 |x|.  A NaN or inf x gives a NaN lo, so
// that the products carry it (hi alone may round a NaN's bits to zero).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// d (16 x 8 f32) += a (16 x 8 tf32) b (8 x 8 tf32)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, a and b already split: lo_a hi_b, hi_a lo_b, hi_a hi_b
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// the same with the small terms lo_a hi_b and hi_a lo_b into their own accumulator dl and
// hi_a hi_b into dh: the accumulator of a tensor-core product is not rounded to nearest,
// and each add into a large sum loses up to an ulp of it, so a small term added there
// leaves as much error as a large one; kept apart, the small terms' sum is ~2^-11 of the
// large one and its adds lose ~2^-11 as much.  The caller adds the two (rounded to
// nearest) when the k loop is done.
__device__ __forceinline__ void mma_3xtf32_apart(float (&dh)[4], float (&dl)[4],
                                                 const uint32_t (&ah)[4],
                                                 const uint32_t (&al)[4], uint32_t bh0,
                                                 uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(dl, al, bh0, bh1);
  mma_tf32(dl, ah, bl0, bl1);
  mma_tf32(dh, ah, bh0, bh1);
}

// 16 bytes global -> shared, zero-filled where !valid (nothing read then)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

}  // namespace
}  // namespace hs
