"""Decoder tail: FinalPatchExpand -> LayerNorm -> head, fused with the argmax (K3,
serving) or with the weighted cross entropy and the confusion matrix (K6 forward, K7
backward, training).

Counterpart of ``fused_final_head_predict`` and ``fused_final_head`` in
``heal_swin_tpu/ops/final_head.py``.  The p sub-rows of the expand reshape
(T, p*C) -> (T*p, C) are the p column slices of the expand output, so the tail is p
independent (C, C) products per token.  Per sub-row: h = x @ We_i (f32 accumulation,
rounded to x's dtype) -> LayerNorm with f32 statistics -> z in x's dtype -> logits
z @ Wh in f32.

- Predict (K3): the f32 logits, not rounded -> argmax with the lowest index on ties;
  a row holding a NaN gives F - 1.  Returns (T, p) int32.
- Loss (K6/K7): the logits rounded to x's dtype -> log-softmax -> weighted NLL.
  Returns loss = sum w*nll / max(sum w, 1e-12) and the (F, F) f32 confusion matrix
  (target rows, argmax columns, lowest index on ties) over every element; a row
  holding a NaN counts in no cell.  The backward scales dlogits = w * (softmax -
  onehot) by gloss / max(sum w, 1e-12), rounds it, and rounds the LayerNorm
  backward's dh before the expand products.

Every wrapper dispatches on ``impl`` like the attention wrappers
(``heal_swin_torch.ops._dispatch.use_kernel``); the loss's backward takes the same
route as its forward.
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
KERNEL_MAX_C_LOSS_BWD = 128  # K7 keeps C / 32 columns of a row per lane in registers

# launch counters, bumped only where a kernel launches: per kernel, and per
# (kernel, T, C)
launches = {"final_head_predict": 0, "final_head_loss": 0, "final_head_loss_bwd": 0}
launches_by_shape: Counter = Counter()


def _count(what, T, C):
    launches[what] += 1
    launches_by_shape[(what, T, C)] += 1


def argmax_lowest(lf: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis, lowest index on ties, F - 1 for any row with a NaN
    (the max is NaN there, no lane compares >= it, and the index clamps)."""
    F = lf.shape[-1]
    mx = lf.amax(-1, keepdim=True)
    lane = torch.arange(F, device=lf.device)
    idx = torch.where(lf >= mx, lane, torch.full_like(lane, F)).amin(-1)
    return torch.clamp_max(idx, F - 1).to(torch.int32)


def _split_we(we, dt, patch_size):
    """(C, p*C) JAX-layout expand weight -> (p, C, C) in ``dt``: slice i is the expand
    of sub-pixel i."""
    C = we.shape[0]
    return we.to(dt).reshape(C, patch_size, C).permute(1, 0, 2)


def _ln_rows(hf, gamma, beta):
    """f32 LayerNorm over the last axis: (y, xhat, rstd)."""
    mean = hf.mean(-1, keepdim=True)
    xc = hf - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + LN_EPS)
    xhat = xc * rstd
    return xhat * gamma.float() + beta.float(), xhat, rstd


def _sub_rows(x, we_s, gamma, beta, i):
    """Sub-pixel i of every token: (z f32 of the rounded LN output, xhat, rstd)."""
    dt = x.dtype
    h = (x.float() @ we_s[i].float()).to(dt).float()
    z, xhat, rstd = _ln_rows(h, gamma, beta)
    return z.to(dt).float(), xhat, rstd


def final_head_logits_plain(x, we, gamma, beta, wh, *, patch_size):
    """x: (T, C); we: (C, p*C) (JAX layout); gamma/beta: (C,); wh: (C, F) ->
    (T, p, F) float32 logits, rounded like the kernel up to the head product."""
    we_s = _split_we(we, x.dtype, patch_size)
    whf = wh.to(x.dtype).float()
    return torch.stack([_sub_rows(x, we_s, gamma, beta, i)[0] @ whf
                        for i in range(patch_size)], dim=1)


def final_head_predict_plain(x, we, gamma, beta, wh, *, patch_size):
    """Plain version of K3: (T, p) int32 class indices."""
    return argmax_lowest(final_head_logits_plain(x, we, gamma, beta, wh,
                                                 patch_size=patch_size))


def _ce_rows(lf, yi):
    """Cross entropy on (rows, F) f32 logits and (rows,) targets: (softmax, onehot,
    nll, argmax index with F for a row holding a NaN), as ``_slice_ce``."""
    F = lf.shape[-1]
    mx = lf.amax(-1, keepdim=True)  # NaN where the row holds one
    e = torch.exp(lf - mx)
    se = e.sum(-1, keepdim=True)
    lane = torch.arange(F, device=lf.device)
    onehot = (lane == yi[:, None]).float()
    nll = mx[:, 0] + torch.log(se[:, 0]) - (lf * onehot).sum(-1)
    pred = torch.where(lf >= mx, lane, torch.full_like(lane, F)).amin(-1)
    return e / se, onehot, nll, pred


def final_head_loss_plain(x, we, gamma, beta, wh, y, welem, *, patch_size):
    """Plain version of K6.  y: (T, p) int targets; welem: (T, p) f32 per-element
    weights.  Returns (sum w*nll, sum w, confusion matrix (F, F)), all f32."""
    F = wh.shape[-1]
    we_s = _split_we(we, x.dtype, patch_size)
    whf = wh.to(x.dtype).float()
    num = torch.zeros((), dtype=torch.float32, device=x.device)
    den = torch.zeros((), dtype=torch.float32, device=x.device)
    cm = torch.zeros(F * F, dtype=torch.float32, device=x.device)
    for i in range(patch_size):
        z, _, _ = _sub_rows(x, we_s, gamma, beta, i)
        lf = (z @ whf).to(x.dtype).float()
        yi = y[:, i].long()
        wi = welem[:, i].float()
        _, _, nll, pred = _ce_rows(lf, yi)
        num = num + (wi * nll).sum()
        den = den + wi.sum()
        counted = (pred < F) & (yi >= 0) & (yi < F)
        cm = cm + torch.bincount((yi * F + pred)[counted], minlength=F * F).float()
    return num, den, cm.reshape(F, F)


def final_head_loss_bwd_plain(x, we, gamma, beta, wh, y, welem, scale, *, patch_size):
    """Plain version of K7, the backward of K6 for loss gradient ``gloss``:
    scale = gloss / max(sum w, 1e-12) (a 0-d f32 tensor).  Returns (dx (T, C) in x's
    dtype, dwe (C, p*C), dgamma (C,), dbeta (C,), dwh (C, F)), the last four f32."""
    T, C = x.shape
    dt = x.dtype
    we_s = _split_we(we, dt, patch_size)
    whf = wh.to(dt).float()
    g = gamma.float()
    dx = torch.zeros((T, C), dtype=torch.float32, device=x.device)
    dwh = torch.zeros_like(whf)
    dg = torch.zeros(C, dtype=torch.float32, device=x.device)
    db = torch.zeros_like(dg)
    dwe = []
    for i in range(patch_size):
        z, xhat, rstd = _sub_rows(x, we_s, gamma, beta, i)
        lf = (z @ whf).to(dt).float()
        sm, onehot, _, _ = _ce_rows(lf, y[:, i].long())
        dlog = ((scale * welem[:, i].float())[:, None] * (sm - onehot)).to(dt).float()
        dwh = dwh + z.t() @ dlog
        dz = dlog @ whf.t()
        dg = dg + (dz * xhat).sum(0)
        db = db + dz.sum(0)
        dzh = dz * g
        dh = rstd * (dzh - dzh.mean(-1, keepdim=True)
                     - xhat * (dzh * xhat).mean(-1, keepdim=True))
        dh = dh.to(dt).float()
        dx = dx + dh @ we_s[i].float().t()
        dwe.append(x.float().t() @ dh)
    return dx.to(dt), torch.cat(dwe, dim=1), dg, db, dwh


def _tail_operands(what, x, we, gamma, beta, wh, patch_size):
    """The kernels' checked operands: (T, C, F, we_s (p, C, C), gamma, beta, wh)."""
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
    ops = (x, _split_we(we, dt, p).contiguous(), gamma.float().contiguous(),
           beta.float().contiguous(), wh.to(dt).contiguous())
    if not all(t.is_cuda and t.device == x.device for t in ops):
        raise ValueError(f"{what}: every operand must be on {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be contiguous and 16-byte aligned")
    return (T, C, F) + ops[1:]


def _check_smem(what, smem, C, p):
    if smem > KERNEL_SMEM_LIMIT:
        raise ValueError(f"{what}: C={C}, p={p} needs {smem} bytes of shared memory")


def _targets(what, y, welem, T, p, device):
    if tuple(y.shape) != (T, p) or tuple(welem.shape) != (T, p):
        raise ValueError(f"{what}: y and welem must be (T, p) = {(T, p)}")
    y = y.to(device=device, dtype=torch.int32).contiguous()
    welem = welem.to(device=device, dtype=torch.float32).contiguous()
    return y, welem


def final_head_predict(x, we, gamma, beta, wh, *, patch_size, impl="auto"):
    """K3 wrapper; operands as ``final_head_predict_plain``."""
    if not use_kernel(x, impl):
        return final_head_predict_plain(x, we, gamma, beta, wh, patch_size=patch_size)
    what = "final_head_predict"
    T, C, F, we_s, g, b, whb = _tail_operands(what, x, we, gamma, beta, wh, patch_size)
    p = patch_size
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, we, gamma, beta, wh)):
        raise ValueError(f"{what}: the kernel has no backward; call it under "
                         "torch.no_grad()")
    lib = _build.lib()
    _check_smem(what, lib.hs_final_head_predict_smem(C, F, p), C, p)
    preds = torch.empty((T, p), dtype=torch.int32, device=x.device)
    code = lib.hs_final_head_predict(x.data_ptr(), we_s.data_ptr(), g.data_ptr(),
                                     b.data_ptr(), whb.data_ptr(), preds.data_ptr(), T, C, F,
                                     p, LN_EPS, stream(x))
    check(code, what)
    _count(what, T, C)
    return preds


def final_head_loss_sums(x, we, gamma, beta, wh, y, welem, *, patch_size, impl="auto"):
    """K6 wrapper: (sum w*nll, sum w, confusion matrix); operands as
    ``final_head_loss_plain``."""
    if not use_kernel(x, impl):
        return final_head_loss_plain(x, we, gamma, beta, wh, y, welem, patch_size=patch_size)
    what = "final_head_loss"
    T, C, F, we_s, g, b, whb = _tail_operands(what, x, we, gamma, beta, wh, patch_size)
    p = patch_size
    y, welem = _targets(what, y, welem, T, p, x.device)
    lib = _build.lib()
    _check_smem(what, lib.hs_final_head_loss_smem(C, F, p), C, p)
    red = torch.empty(2 + F * F, dtype=torch.float32, device=x.device)
    work = torch.empty(lib.hs_final_head_loss_workspace(T, F), dtype=torch.uint8,
                       device=x.device)
    code = lib.hs_final_head_loss(x.data_ptr(), we_s.data_ptr(), g.data_ptr(), b.data_ptr(),
                                  whb.data_ptr(), y.data_ptr(), welem.data_ptr(),
                                  red.data_ptr(), work.data_ptr(), T, C, F, p, LN_EPS,
                                  stream(x))
    check(code, what)
    _count(what, T, C)
    return red[0], red[1], red[2:].reshape(F, F)


def final_head_loss_bwd(x, we, gamma, beta, wh, y, welem, scale, *, patch_size, impl="auto"):
    """K7 wrapper: the backward of K6; operands and results as
    ``final_head_loss_bwd_plain``."""
    if not use_kernel(x, impl):
        return final_head_loss_bwd_plain(x, we, gamma, beta, wh, y, welem, scale,
                                         patch_size=patch_size)
    what = "final_head_loss_bwd"
    T, C, F, we_s, g, b, whb = _tail_operands(what, x, we, gamma, beta, wh, patch_size)
    p = patch_size
    y, welem = _targets(what, y, welem, T, p, x.device)
    scale = scale.to(device=x.device, dtype=torch.float32).reshape(1).contiguous()
    if C > KERNEL_MAX_C_LOSS_BWD:
        raise ValueError(f"{what}: the kernel takes C <= {KERNEL_MAX_C_LOSS_BWD}, got C={C}")
    lib = _build.lib()
    _check_smem(what, lib.hs_final_head_loss_bwd_smem(C, F, p), C, p)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dwe = torch.empty((C, p * C), **f32)
    red = torch.empty(C * F + 2 * C, **f32)
    work = torch.empty(lib.hs_final_head_loss_bwd_workspace(T, C, F, p), dtype=torch.uint8,
                       device=x.device)
    code = lib.hs_final_head_loss_bwd(
        x.data_ptr(), we_s.data_ptr(), g.data_ptr(), b.data_ptr(), whb.data_ptr(),
        y.data_ptr(), welem.data_ptr(), scale.data_ptr(), dx.data_ptr(), dwe.data_ptr(),
        red.data_ptr(), work.data_ptr(), T, C, F, p, LN_EPS, stream(x))
    check(code, what)
    _count(what, T, C)
    dwh, dg, db = red.split([C * F, C, C])
    return dx, dwe, dg, db, dwh.reshape(C, F)


class _FinalHeadLoss(torch.autograd.Function):
    """K6 forward, K7 backward (or their plain versions, by ``impl`` and device)."""

    @staticmethod
    def forward(ctx, x, we, gamma, beta, wh, y, welem, patch_size, impl):
        num, den, cm = final_head_loss_sums(x, we, gamma, beta, wh, y, welem,
                                            patch_size=patch_size, impl=impl)
        den_s = torch.clamp_min(den, 1e-12)
        ctx.save_for_backward(x, we, gamma, beta, wh, y, welem, den_s)
        ctx.patch_size, ctx.impl = patch_size, impl
        ctx.mark_non_differentiable(cm)
        return num / den_s, cm

    @staticmethod
    def backward(ctx, gloss, _gcm):
        x, we, gamma, beta, wh, y, welem, den_s = ctx.saved_tensors
        scale = (gloss / den_s).float()
        dx, dwe, dg, db, dwh = final_head_loss_bwd(x, we, gamma, beta, wh, y, welem, scale,
                                                   patch_size=ctx.patch_size, impl=ctx.impl)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dwe.to(we.dtype) if need[1] else None,
                dg.to(gamma.dtype) if need[2] else None,
                db.to(beta.dtype) if need[3] else None,
                dwh.to(wh.dtype) if need[4] else None, None, None, None, None)


def final_head_loss(x, we, gamma, beta, wh, y, welem, *, patch_size, impl="auto"):
    """Fused expand -> LN -> head -> weighted CE: (loss, confusion matrix (F, F) f32).
    x: (T, C) tokens after ``norm_up``; we: (C, p*C) expand weight (JAX layout);
    gamma/beta: (C,) LN parameters; wh: (C, F) head weight; y: (T, p) int targets;
    welem: (T, p) f32 per-element weights.  K6 forward, K7 backward; the weights'
    gradients come back in their own dtype (f32 parameters stay f32)."""
    return _FinalHeadLoss.apply(x, we, gamma, beta, wh, y, welem, patch_size, impl)
