"""TF32 products in plain PyTorch: what the f32 window-attention kernels compute on the
tensor cores, for the tests on the CPU.  No kernel and no main path calls this module.

The f32 K1 and K2 (``csrc/window_attention_f32.cu``) run every product as 3xTF32: each
f32 operand a is split into hi = tf32(a), rounded to nearest (ties away from zero, as
cvt.rna), and lo = a - hi, which the tensor core reads as TF32 by dropping its low 13
bits; a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b with f32 sums.  A product of
two TF32 values (11 significant bits each) is exact in f32, so an f32 matmul of the
parts is that product summed in f32.  ``matmul_tf32`` is a single TF32 pass (both
operands rounded to nearest), for comparison.
"""

from __future__ import annotations

import torch

_TF32_DROP = 13  # f32 keeps 23 mantissa bits, TF32 10


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32 by integer operations on its bits: add half of the
    dropped part's range to the magnitude, then clear the dropped bits (round to
    nearest, ties away from zero, as cvt.rna.tf32.f32).  Inf and NaN stay as they are."""
    x = x.float().contiguous()
    half = 1 << (_TF32_DROP - 1)
    bits = torch.bitwise_and(x.view(torch.int32) + half, -(1 << _TF32_DROP))
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) with its low 13 mantissa bits cleared: how the tensor core reads an
    f32 operand as TF32 (toward zero)."""
    return torch.bitwise_and(x.float().contiguous().view(torch.int32),
                             -(1 << _TF32_DROP)).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) as the kernels' tensor cores see them: hi = tf32(x) rounded to nearest,
    lo = x - hi (exact) read as TF32, so that hi + lo is x within ~2^-21 |x|."""
    hi = round_tf32(x)
    return hi, truncate_tf32(x.float() - hi)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in one TF32 pass: both operands rounded to TF32, f32 sums."""
    return round_tf32(a) @ round_tf32(b)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in 3xTF32: (lo_a hi_b + hi_a lo_b) + hi_a hi_b, f32 sums (the small
    terms first, as the kernels accumulate them); ``torch.matmul`` broadcasting."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh
