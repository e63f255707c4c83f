"""Inference decoder tail: FinalPatchExpand -> LayerNorm -> head -> argmax (K3).

Counterpart of ``fused_final_head_predict`` in ``heal_swin_tpu/ops/final_head.py``.
The p sub-rows of the expand reshape (T, p*C) -> (T*p, C) are the p column slices of
the expand output, so the tail is p independent (C, C) products per token.  Per
sub-row: h = x @ We_i (f32 accumulation, rounded to x's dtype) -> LayerNorm with f32
statistics -> z in x's dtype -> f32 logits z @ Wh (not rounded) -> argmax with the
lowest index on ties; a row holding a NaN gives F - 1.  Returns (T, p) int32.

``final_head_predict`` dispatches on ``impl`` like the attention wrappers
(``heal_swin_torch.ops._dispatch.use_kernel``).
"""

from __future__ import annotations

from collections import Counter

import torch

from heal_swin_torch import _build
from heal_swin_torch.ops._dispatch import check, stream, use_kernel

LN_EPS = 1e-5
KERNEL_ROWS = 64  # token rows per block
KERNEL_MAX_F = 32  # one lane per class
KERNEL_SMEM_LIMIT = 232448  # bytes a block may opt in to on sm_90

# launch counters, bumped only where the kernel launches: per kernel, and per
# (kernel, T, C)
launches = {"final_head_predict": 0}
launches_by_shape: Counter = Counter()


def argmax_lowest(lf: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis, lowest index on ties, F - 1 for any row with a NaN
    (the max is NaN there, no lane compares >= it, and the index clamps)."""
    F = lf.shape[-1]
    mx = lf.amax(-1, keepdim=True)
    lane = torch.arange(F, device=lf.device)
    idx = torch.where(lf >= mx, lane, torch.full_like(lane, F)).amin(-1)
    return torch.clamp_max(idx, F - 1).to(torch.int32)


def final_head_logits_plain(x, we, gamma, beta, wh, *, patch_size):
    """x: (T, C); we: (C, p*C) (JAX layout); gamma/beta: (C,); wh: (C, F) ->
    (T, p, F) float32 logits, rounded like the kernel up to the head product."""
    T, C = x.shape
    p = patch_size
    dt = x.dtype
    we_s = we.to(dt).float().reshape(C, p, C)
    whf = wh.to(dt).float()
    xf = x.float()
    out = []
    for i in range(p):
        h = (xf @ we_s[:, i]).to(dt).float()
        mean = h.mean(-1, keepdim=True)
        xc = h - mean
        var = (xc * xc).mean(-1, keepdim=True)
        z = (xc * torch.rsqrt(var + LN_EPS) * gamma.float() + beta.float()).to(dt).float()
        out.append(z @ whf)
    return torch.stack(out, dim=1)


def final_head_predict_plain(x, we, gamma, beta, wh, *, patch_size):
    """Plain version of K3: (T, p) int32 class indices."""
    return argmax_lowest(final_head_logits_plain(x, we, gamma, beta, wh,
                                                 patch_size=patch_size))


def final_head_predict(x, we, gamma, beta, wh, *, patch_size, impl="auto"):
    """K3 wrapper; operands as ``final_head_predict_plain``."""
    if not use_kernel(x, impl):
        return final_head_predict_plain(x, we, gamma, beta, wh, patch_size=patch_size)
    what = "final_head_predict"
    T, C = x.shape
    p = patch_size
    F = wh.shape[-1]
    dt = torch.bfloat16
    if x.dtype != dt:
        raise ValueError(f"{what}: the kernel takes bfloat16 x")
    if (tuple(we.shape) != (C, p * C) or tuple(wh.shape) != (C, F)
            or tuple(gamma.shape) != (C,) or tuple(beta.shape) != (C,)):
        raise ValueError(f"{what}: operands must be we (C, p*C), wh (C, F), gamma/beta (C,)")
    if C % 16 or not 1 <= F <= KERNEL_MAX_F:
        raise ValueError(f"{what}: the kernel takes C % 16 == 0 and F <= {KERNEL_MAX_F}, "
                         f"got C={C}, F={F}")
    if T % KERNEL_ROWS:
        raise ValueError(f"{what}: T={T} is not a multiple of {KERNEL_ROWS}")
    lib = _build.lib()
    smem = lib.hs_final_head_predict_smem(C, F, p)
    if smem > KERNEL_SMEM_LIMIT:
        raise ValueError(f"{what}: C={C}, p={p} needs {smem} bytes of shared memory")
    # (C, p*C) -> (p, C, C): slice i is the contiguous (C, C) expand of sub-pixel i
    we_s = we.to(dt).reshape(C, p, C).permute(1, 0, 2).contiguous()
    whb = wh.to(dt).contiguous()
    g = gamma.float().contiguous()
    b = beta.float().contiguous()
    ops = (x, we_s, g, b, whb)
    if not all(t.is_cuda and t.device == x.device for t in ops):
        raise ValueError(f"{what}: every operand must be on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        raise ValueError(f"{what}: the kernel is forward only; call it under "
                         "torch.no_grad()")
    preds = torch.empty((T, p), dtype=torch.int32, device=x.device)
    code = lib.hs_final_head_predict(x.data_ptr(), we_s.data_ptr(), g.data_ptr(),
                                     b.data_ptr(), whb.data_ptr(), preds.data_ptr(), T, C, F,
                                     p, LN_EPS, stream(x))
    check(code, what)
    launches[what] += 1
    launches_by_shape[(what, T, C)] += 1
    return preds
