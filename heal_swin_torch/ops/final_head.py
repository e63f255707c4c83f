"""Decoder tail: FinalPatchExpand -> LayerNorm -> head, fused with the argmax (K3,
serving), with the weighted cross entropy and the confusion matrix (K6 forward, K7
backward, segmentation training), or with the masked depth loss (K8 forward, K9
backward, depth training).

Counterpart of ``fused_final_head_predict``, ``fused_final_head`` and
``fused_final_head_depth`` in ``heal_swin_tpu/ops/final_head.py``.  The p sub-rows of
the expand reshape (T, p*C) -> (T*p, C) are the p column slices of the expand output,
so the tail is p independent (C, C) products per token.  Per sub-row: h = x @ We_i
(f32 accumulation, rounded to x's dtype) -> LayerNorm with f32 statistics -> z in x's
dtype -> logits z @ Wh in f32.

- Predict (K3): the f32 logits, not rounded -> argmax with the lowest index on ties;
  a row holding a NaN gives F - 1.  Returns (T, p) int32.
- Loss (K6/K7): the logits rounded to x's dtype -> log-softmax -> weighted NLL.
  Returns loss = sum w*nll / max(sum w, 1e-12) and the (F, F) f32 confusion matrix
  (target rows, argmax columns, lowest index on ties) over every element; a row
  holding a NaN counts in no cell.  The backward scales dlogits = w * (softmax -
  onehot) by gloss / max(sum w, 1e-12), rounds it, and rounds the LayerNorm
  backward's dh before the expand products.
- Depth loss (K8/K9): F in {1, 2} output channels (mean, logvar); targets (T, p) f32
  with a non-finite value marking background.  The loss of kind l2 / l1 / huber /
  nll takes the f32 logits (not rounded; only the emitted predictions are rounded to
  x's dtype) and selects an invalid target to 0 before the subtraction, so it never
  enters the arithmetic.  Returns loss = sum loss / max(count, 1) and the (T, p*F)
  predictions.  The backward's dlogits = (gloss / max(count, 1)) * dloss/dlogits
  stay f32; dh is rounded before the expand products.

Every wrapper dispatches on ``impl`` like the attention wrappers
(``heal_swin_torch.ops._dispatch.use_kernel``); a loss's backward takes the same
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
KERNEL_MAX_C_LOSS_BWD = 128  # K7 and K9 keep C / 32 columns of a row per lane in registers
DEPTH_KINDS = ("l2", "l1", "huber", "nll")  # K8/K9's loss kinds, in their launch ids

# launch counters, bumped only where a kernel launches: per kernel, and per
# (kernel, T, C), or (kernel, T, C, F, kind) for K8/K9
launches = {"final_head_predict": 0, "final_head_loss": 0, "final_head_loss_bwd": 0,
            "final_head_depth_loss": 0, "final_head_depth_loss_bwd": 0}
launches_by_shape: Counter = Counter()


def _count(what, *shape):
    launches[what] += 1
    launches_by_shape[(what,) + shape] += 1


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


def _tail_bwd_plain(x, we, gamma, beta, wh, dlogits_of, *, patch_size):
    """The backward of the tail from the dlogits of each sub-pixel: ``dlogits_of(i, z,
    whf)`` -> (T, F) f32 dlogits of sub-pixel i from its (T, C) z and the f32 head
    (C, F).  dWh += z^T dlogits, dz = dlogits Wh^T, LN backward, dh rounded to x's
    dtype, dx = sum_i dh_i We_i^T, dWe_i = x^T dh_i.  Returns (dx (T, C) in x's dtype,
    dwe (C, p*C), dgamma (C,), dbeta (C,), dwh (C, F)), the last four f32."""
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
        dlog = dlogits_of(i, z, whf)
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


def final_head_loss_bwd_plain(x, we, gamma, beta, wh, y, welem, scale, *, patch_size):
    """Plain version of K7, the backward of K6 for loss gradient ``gloss``:
    scale = gloss / max(sum w, 1e-12) (a 0-d f32 tensor).  Results as
    ``_tail_bwd_plain``."""
    dt = x.dtype

    def dlogits_of(i, z, whf):
        lf = (z @ whf).to(dt).float()
        sm, onehot, _, _ = _ce_rows(lf, y[:, i].long())
        return ((scale * welem[:, i].float())[:, None] * (sm - onehot)).to(dt).float()

    return _tail_bwd_plain(x, we, gamma, beta, wh, dlogits_of, patch_size=patch_size)


def _sign(d):
    """jnp.sign: +-1, and d itself at 0 and NaN (torch.sign sends NaN to 0)."""
    return torch.where(d > 0, 1.0, torch.where(d < 0, -1.0, d))


def _depth_diff(lf, ti):
    """(d, valid) of one sub-pixel: valid = isfinite(target); d = logit 0 - target
    with an invalid target selected to 0 first, and d = 0 where invalid."""
    valid = torch.isfinite(ti)
    return torch.where(valid, lf[:, 0] - torch.where(valid, ti, 0.0), 0.0), valid


def _depth_loss_vals(lf, ti, kind, delta):
    """Per-element loss of one sub-pixel, 0 where invalid.  lf: (T, F) f32 logits;
    ti: (T,) f32 targets.  As ``_depth_loss_vals`` of the JAX package."""
    d, valid = _depth_diff(lf, ti)
    if kind == "l2":
        v = 0.5 * d * d
    elif kind == "l1":
        v = torch.abs(d)
    elif kind == "huber":
        ad = torch.abs(d)
        v = torch.where(ad < delta, 0.5 * ad * ad / delta, ad - 0.5 * delta)
    elif kind == "nll":
        lv = torch.where(valid, lf[:, 1], 0.0)
        v = 0.5 * lv + (0.5 * d * d) * torch.exp(-lv)
    else:
        raise ValueError(f"unknown depth loss kind {kind!r}")
    return torch.where(valid, v, 0.0), valid


def _depth_loss_grads(lf, ti, kind, delta):
    """d loss / d logits of one sub-pixel: (T, F) f32, 0 where invalid.  With F = 2
    and a kind other than nll the logvar channel gets 0."""
    d, valid = _depth_diff(lf, ti)
    g1 = torch.zeros_like(d)
    if kind == "l2":
        g0 = d
    elif kind == "l1":
        g0 = _sign(d)
    elif kind == "huber":
        g0 = torch.where(torch.abs(d) < delta, d / delta, _sign(d))
    elif kind == "nll":
        e = torch.exp(-torch.where(valid, lf[:, 1], 0.0))
        g0 = d * e
        g1 = torch.where(valid, 0.5 - (0.5 * d * d) * e, 0.0)
    else:
        raise ValueError(f"unknown depth loss kind {kind!r}")
    g = torch.stack([torch.where(valid, g0, 0.0), g1], dim=-1)
    return g[:, :lf.shape[-1]]


def final_head_depth_loss_plain(x, we, gamma, beta, wh, t, *, patch_size, loss_kind,
                                huber_delta=1.0):
    """Plain version of K8.  wh: (C, F), F in {1, 2}; t: (T, p) f32 targets, a
    non-finite value marking background.  Returns (sum loss, count of valid targets,
    both 0-d f32, and the predictions (T, p*F) in x's dtype, column i*F + f holding
    channel f of sub-pixel i)."""
    we_s = _split_we(we, x.dtype, patch_size)
    whf = wh.to(x.dtype).float()
    num = torch.zeros((), dtype=torch.float32, device=x.device)
    den = torch.zeros((), dtype=torch.float32, device=x.device)
    preds = []
    for i in range(patch_size):
        lf = _sub_rows(x, we_s, gamma, beta, i)[0] @ whf
        vals, valid = _depth_loss_vals(lf, t[:, i].float(), loss_kind, huber_delta)
        num = num + vals.sum()
        den = den + valid.float().sum()
        preds.append(lf)
    return num, den, torch.stack(preds, dim=1).reshape(x.shape[0], -1).to(x.dtype)


def final_head_depth_loss_bwd_plain(x, we, gamma, beta, wh, t, scale, *, patch_size,
                                    loss_kind, huber_delta=1.0):
    """Plain version of K9, the backward of K8 for loss gradient ``gloss``:
    scale = gloss / max(count, 1) (a 0-d f32 tensor); dlogits = scale * dloss/dlogits
    stay f32.  Results as ``_tail_bwd_plain``."""

    def dlogits_of(i, z, whf):
        return scale * _depth_loss_grads(z @ whf, t[:, i].float(), loss_kind, huber_delta)

    return _tail_bwd_plain(x, we, gamma, beta, wh, dlogits_of, patch_size=patch_size)


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


def _depth_refusal(what, T, C, F, kind, bwd):
    """Why K8 (``bwd`` False) or K9 (``bwd`` True) does not take these operands, or
    None where it does (apart from the shared-memory bound, checked at launch)."""
    if kind not in DEPTH_KINDS:
        return f"{what}: unknown loss kind {kind!r}; the kernel takes {DEPTH_KINDS}"
    if F not in (1, 2):
        return f"{what}: the kernel takes F in (1, 2) output channels, got F={F}"
    if kind == "nll" and F != 2:
        return f"{what}: the nll loss needs F=2 (mean, logvar), got F={F}"
    if T % KERNEL_ROWS:
        return f"{what}: T={T} is not a multiple of {KERNEL_ROWS}"
    if C % 16:
        return f"{what}: the kernel takes C % 16 == 0, got C={C}"
    if bwd and C > KERNEL_MAX_C_LOSS_BWD:
        return f"{what}: the kernel takes C <= {KERNEL_MAX_C_LOSS_BWD}, got C={C}"
    return None


def depth_kernels_take(T, C, F, kind) -> bool:
    """Whether K8 and K9 take a depth tail of T tokens of width C, F output channels
    and loss ``kind`` (apart from the shared-memory bound, checked at launch)."""
    return _depth_refusal("", T, C, F, kind, bwd=True) is None


def _depth_operands(what, x, we, gamma, beta, wh, t, patch_size, kind, bwd):
    msg = _depth_refusal(what, x.shape[0], x.shape[-1], wh.shape[-1], kind, bwd)
    if msg is not None:
        raise ValueError(msg)
    ops = _tail_operands(what, x, we, gamma, beta, wh, patch_size)
    if tuple(t.shape) != (ops[0], patch_size):
        raise ValueError(f"{what}: t must be (T, p) = {(ops[0], patch_size)}")
    return ops + (t.to(device=x.device, dtype=torch.float32).contiguous(),)


def final_head_depth_loss_sums(x, we, gamma, beta, wh, t, *, patch_size, loss_kind,
                               huber_delta=1.0, impl="auto"):
    """K8 wrapper: (sum loss, count of valid targets, predictions (T, p*F)); operands
    as ``final_head_depth_loss_plain``."""
    kw = dict(patch_size=patch_size, loss_kind=loss_kind, huber_delta=huber_delta)
    if not use_kernel(x, impl):
        return final_head_depth_loss_plain(x, we, gamma, beta, wh, t, **kw)
    what = "final_head_depth_loss"
    T, C, F, we_s, g, b, whb, t = _depth_operands(what, x, we, gamma, beta, wh, t,
                                                  patch_size, loss_kind, bwd=False)
    p = patch_size
    lib = _build.lib()
    _check_smem(what, lib.hs_final_head_depth_loss_smem(C, F, p), C, p)
    red = torch.empty(2, dtype=torch.float32, device=x.device)
    preds = torch.empty((T, p * F), dtype=x.dtype, device=x.device)
    work = torch.empty(lib.hs_final_head_depth_loss_workspace(T), dtype=torch.uint8,
                       device=x.device)
    code = lib.hs_final_head_depth_loss(
        x.data_ptr(), we_s.data_ptr(), g.data_ptr(), b.data_ptr(), whb.data_ptr(),
        t.data_ptr(), red.data_ptr(), preds.data_ptr(), work.data_ptr(), T, C, F, p,
        DEPTH_KINDS.index(loss_kind), LN_EPS, float(huber_delta), stream(x))
    check(code, what)
    _count(what, T, C, F, loss_kind)
    return red[0], red[1], preds


def final_head_depth_loss_bwd(x, we, gamma, beta, wh, t, scale, *, patch_size, loss_kind,
                              huber_delta=1.0, impl="auto"):
    """K9 wrapper: the backward of K8; operands and results as
    ``final_head_depth_loss_bwd_plain``."""
    kw = dict(patch_size=patch_size, loss_kind=loss_kind, huber_delta=huber_delta)
    if not use_kernel(x, impl):
        return final_head_depth_loss_bwd_plain(x, we, gamma, beta, wh, t, scale, **kw)
    what = "final_head_depth_loss_bwd"
    T, C, F, we_s, g, b, whb, t = _depth_operands(what, x, we, gamma, beta, wh, t,
                                                  patch_size, loss_kind, bwd=True)
    p = patch_size
    scale = scale.to(device=x.device, dtype=torch.float32).reshape(1).contiguous()
    lib = _build.lib()
    _check_smem(what, lib.hs_final_head_depth_loss_bwd_smem(C, F, p), C, p)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dwe = torch.empty((C, p * C), **f32)
    red = torch.empty(C * F + 2 * C, **f32)
    work = torch.empty(lib.hs_final_head_depth_loss_bwd_workspace(T, C, F, p),
                       dtype=torch.uint8, device=x.device)
    code = lib.hs_final_head_depth_loss_bwd(
        x.data_ptr(), we_s.data_ptr(), g.data_ptr(), b.data_ptr(), whb.data_ptr(),
        t.data_ptr(), scale.data_ptr(), dx.data_ptr(), dwe.data_ptr(), red.data_ptr(),
        work.data_ptr(), T, C, F, p, DEPTH_KINDS.index(loss_kind), LN_EPS,
        float(huber_delta), stream(x))
    check(code, what)
    _count(what, T, C, F, loss_kind)
    dwh, dg, db = red.split([C * F, C, C])
    return dx, dwe, dg, db, dwh.reshape(C, F)


def _tail_grads(ctx, operands, grads):
    """The tail operands' gradients, each in its operand's dtype (f32 parameters stay
    f32), None where autograd needs none."""
    return tuple(g.to(o.dtype) if need else None
                 for need, o, g in zip(ctx.needs_input_grad, operands, grads))


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
        grads = final_head_loss_bwd(x, we, gamma, beta, wh, y, welem, scale,
                                    patch_size=ctx.patch_size, impl=ctx.impl)
        return _tail_grads(ctx, (x, we, gamma, beta, wh), grads) + (None,) * 4


def final_head_loss(x, we, gamma, beta, wh, y, welem, *, patch_size, impl="auto"):
    """Fused expand -> LN -> head -> weighted CE: (loss, confusion matrix (F, F) f32).
    x: (T, C) tokens after ``norm_up``; we: (C, p*C) expand weight (JAX layout);
    gamma/beta: (C,) LN parameters; wh: (C, F) head weight; y: (T, p) int targets;
    welem: (T, p) f32 per-element weights.  K6 forward, K7 backward; the weights'
    gradients come back in their own dtype (f32 parameters stay f32)."""
    return _FinalHeadLoss.apply(x, we, gamma, beta, wh, y, welem, patch_size, impl)


class _FinalHeadDepthLoss(torch.autograd.Function):
    """K8 forward, K9 backward (or their plain versions, by ``impl`` and device)."""

    @staticmethod
    def forward(ctx, x, we, gamma, beta, wh, t, patch_size, loss_kind, huber_delta, impl):
        ctx.kw = dict(patch_size=patch_size, loss_kind=loss_kind, huber_delta=huber_delta,
                      impl=impl)
        num, den, preds = final_head_depth_loss_sums(x, we, gamma, beta, wh, t, **ctx.kw)
        den_s = torch.clamp_min(den, 1.0)  # the unfused losses' max(count, 1)
        ctx.save_for_backward(x, we, gamma, beta, wh, t, den_s)
        ctx.mark_non_differentiable(preds)  # a metrics tap
        return num / den_s, preds

    @staticmethod
    def backward(ctx, gloss, _gpreds):
        x, we, gamma, beta, wh, t, den_s = ctx.saved_tensors
        scale = (gloss / den_s).float()  # stays on the device: no host sync
        grads = final_head_depth_loss_bwd(x, we, gamma, beta, wh, t, scale, **ctx.kw)
        return _tail_grads(ctx, (x, we, gamma, beta, wh), grads) + (None,) * 5


def final_head_depth_loss(x, we, gamma, beta, wh, t, *, patch_size, loss_kind,
                          huber_delta=1.0, impl="auto"):
    """Fused expand -> LN -> head -> masked depth loss: (loss, predictions (T, p*F) in
    x's dtype, no gradient).  x, we, gamma, beta as ``final_head_loss``; wh: (C, F)
    head weight, F in {1, 2}; t: (T, p) f32 network-space targets, a non-finite value
    marking background; loss_kind: "l2" | "l1" | "huber" | "nll" (nll needs F = 2;
    with F = 2 and another kind the logvar channel gets no gradient).  The loss is
    sum loss / max(count of valid targets, 1).  K8 forward, K9 backward."""
    return _FinalHeadDepthLoss.apply(x, we, gamma, beta, wh, t, patch_size, loss_kind,
                                     huber_delta, impl)
