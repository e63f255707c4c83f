"""Window multi-head self-attention: plain PyTorch versions and the CUDA kernels.

Counterpart of ``heal_swin_tpu/ops/window_attention.py``.  Two entry points, each an
autograd-capable function on the JAX kernels' operand layout, whose forward and
backward are each a kernel wrapper beside its plain version:

- ``window_attention`` (K2 forward, K5 backward): attention from precomputed qkv rows
  (T, 3C) -> (T, C), cosine or scaled-dot (Pallas ``fused_window_attention``).
- ``window_attention_qkv_epi`` (K1 forward, K4 backward): x @ Wqkv + b -> cosine
  attention -> @ Wp + bp -> optional LayerNorm, (T, C) -> (T, C) (Pallas
  ``fused_window_attention_qkv_epi``).

Operands: ``groups`` (T/ws, ws) int32 mask group ids (attention between tokens of
different groups gets an additive -100); ``bias`` (h, ws, ws) f32 relative-position
bias or None; ``logit_scale`` (h,) f32, already exp(min(., ln 100)).  Weights are in
the JAX layout (in, out).

Rounding follows the Pallas kernels, so that kernel and plain version agree closely
in bf16.  Forward: qkv -> dtype; q_hat = q * scale / |q| and k_hat = k / |k| ->
dtype; softmax in f32, p -> dtype; o -> dtype; the projection and LayerNorm in f32,
output -> dtype.  Backward (``_cos_wide_preamble`` / ``_cos_wide_head_bwd`` /
``_bwd_kernel_xw_epi``): qkv recomputed and rounded; (q/|q|)*scale and k/|k| rounded;
p rounded before dv; ds rounded before the q/k products; the LayerNorm backward's du
rounded before dWp and do; do rounded; dqkv rounded before dx and dW.  The softmax
shift is the row max (the Pallas kernels use a static bound; softmax is
shift-invariant, and forward and backward here use the same one).

Dispatch (``impl``): "auto" runs the kernel for a CUDA tensor and the plain version
for a CPU tensor; "xla" runs the plain version on any device (the JAX package's name
for its non-kernel path); "pallas" demands the kernel and raises on a CPU tensor.  A
CUDA tensor the kernel does not take raises; nothing falls back.  The backward takes
the same route as the forward.  The autograd functions take the weights already cast
to the compute dtype and return their gradients in that dtype, as the JAX custom VJPs
do; the LayerNorm parameters, bias and logit scale get f32 gradients.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Optional

import torch

from heal_swin_torch import _build
from heal_swin_torch.ops._dispatch import check, input_grads, stream, use_kernel

MASK_VALUE = -100.0
KERNEL_WS = 64  # the kernels' window size
KERNEL_HD = 32  # the kernels' head dim
KERNEL_MAX_C = 384  # K1's and K4's shared-memory bound (x, o tiles of 64 x C bf16)

# launch counters, bumped only where a kernel launches: per kernel, and per
# (kernel, T, C, has_mask)
launches = {"window_attention": 0, "window_attention_qkv_epi": 0,
            "window_attention_bwd": 0, "window_attention_qkv_epi_bwd": 0}
launches_by_shape: Counter = Counter()


def _count(what, T, C, has_mask):
    launches[what] += 1
    launches_by_shape[(what, T, C, bool(has_mask))] += 1


def _mask(groups: torch.Tensor) -> torch.Tensor:
    """(nw, ws) group ids -> (nw, 1, ws, ws) additive f32 mask."""
    diff = groups[:, :, None] != groups[:, None, :]
    return (diff.to(torch.float32) * MASK_VALUE)[:, None]


def _softmax(s):
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / torch.clamp_min(e.sum(-1, keepdim=True), 1e-30)


def _scores(q, k, groups, bias, has_mask, mul=None):
    """(nw, ws, h, hd) operands -> (nw, h, ws, ws) f32 scores [* mul] + bias + mask."""
    s = torch.einsum("wihd,wjhd->whij", q, k)
    if mul is not None:
        s = s * mul
    if bias is not None:
        s = s + bias.float()[None]
    if has_mask:
        s = s + _mask(groups)
    return s


def window_attention_plain(qkv, groups, bias, logit_scale, *, ws, num_heads, use_cos,
                           sm_scale, has_mask=True):
    """Plain version of K2.  qkv: (T, 3C) -> (T, C) in qkv's dtype."""
    T, C3 = qkv.shape
    C = C3 // 3
    h = num_heads
    hd = C // h
    nw = T // ws
    dt = qkv.dtype
    parts = qkv.reshape(nw, ws, 3, h, hd)
    q, k, v = parts[:, :, 0].float(), parts[:, :, 1].float(), parts[:, :, 2].float()
    if use_cos:
        iq = torch.rsqrt(torch.clamp_min((q * q).sum(-1, keepdim=True), 1e-24))
        ik = torch.rsqrt(torch.clamp_min((k * k).sum(-1, keepdim=True), 1e-24))
        scale = logit_scale.float().reshape(1, 1, h, 1)
        q = (q * (iq * scale)).to(dt).float()
        k = (k * ik).to(dt).float()
    mul = None if use_cos else sm_scale
    p = _softmax(_scores(q, k, groups, bias, has_mask, mul)).to(dt).float()
    o = torch.einsum("whij,wjhd->wihd", p, v)
    return o.reshape(T, C).to(dt)


def _ln_f32(u, gamma, beta, eps):
    mean = u.mean(-1, keepdim=True)
    xc = u - mean
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * gamma.float() + beta.float()


def _qkv_rows(x, wqkv, bqkv):
    """qkv = x @ Wqkv + b, f32 accumulation, rounded to x's dtype; returned as f32."""
    dt = x.dtype
    qkv = x.float() @ wqkv.to(dt).float()
    if bqkv is not None:
        qkv = qkv + bqkv.to(dt).float()
    return qkv.to(dt).float()


def window_attention_qkv_epi_plain(x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias,
                                   logit_scale, *, ws, num_heads, sm_scale, has_mask=True,
                                   ln_eps=1e-5):
    """Plain version of K1 (cosine attention only, like the Pallas kernel).
    x: (T, C); wqkv: (C, 3C); wp: (C, C) -> (T, C) in x's dtype."""
    dt = x.dtype
    qkv = _qkv_rows(x, wqkv, bqkv)
    o = window_attention_plain(qkv.to(dt), groups, bias, logit_scale, ws=ws,
                               num_heads=num_heads, use_cos=True, sm_scale=sm_scale,
                               has_mask=has_mask)
    u = o.float() @ wp.to(dt).float()
    if bp is not None:
        u = u + bp.to(dt).float()
    if ln_scale is not None:
        u = _ln_f32(u, ln_scale, ln_bias, ln_eps)
    return u.to(dt)


# --------------------------------------------------------------------------- backward


def _cos_preamble(q, k, logit_scale, dt):
    """The backward's normalized operands (``_cos_wide_preamble``): per row and head
    the inverse norms uq, uk, the f32 q_hat = q*uq and k_hat = k*uk, and the rounded
    product operands (q_hat*scale) and k_hat."""
    h = q.shape[2]
    uq = torch.rsqrt(torch.clamp_min((q * q).sum(-1, keepdim=True), 1e-24))
    uk = torch.rsqrt(torch.clamp_min((k * k).sum(-1, keepdim=True), 1e-24))
    qhat, khat = q * uq, k * uk
    scale = logit_scale.float().reshape(1, 1, h, 1)
    return uq, uk, qhat, khat, (qhat * scale).to(dt).float(), khat.to(dt).float(), scale


def _attention_bwd(q, k, v, do, groups, bias, logit_scale, *, use_cos, sm_scale, has_mask,
                   dt):
    """Attention backward on (nw, ws, h, hd) f32 operands (q, k, v of dt-rounded
    values; do rounded).  Returns dq, dk, dv (f32, not rounded), dbias (h, ws, ws) f32
    and dls (h,) f32 or None.  The softmax is recomputed as the forward computes it."""
    if use_cos:
        uq, uk, qhat, khat, qs, kl, scale = _cos_preamble(q, k, logit_scale, dt)
        p = _softmax(_scores(qs, kl, groups, bias, has_mask))
    else:
        p = _softmax(_scores(q, k, groups, bias, has_mask, sm_scale))
    p_lo = p.to(dt).float()
    dv = torch.einsum("whij,wihd->wjhd", p_lo, do)
    dp = torch.einsum("wihd,wjhd->whij", do, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dbias = ds.sum(0)
    ds_lo = ds.to(dt).float()
    if not use_cos:
        dq = torch.einsum("whij,wjhd->wihd", ds_lo, k) * sm_scale
        dk = torch.einsum("whij,wihd->wjhd", ds_lo, q) * sm_scale
        return dq, dk, dv, dbias, None
    aq = torch.einsum("whij,wjhd->wihd", ds_lo, kl)
    bk = torch.einsum("whij,wihd->wjhd", ds_lo, qs)
    rdq = (aq * qhat).sum(-1, keepdim=True)
    rdk = (bk * khat).sum(-1, keepdim=True)
    dq = (aq - qhat * rdq) * (uq * scale)
    dk = (bk - khat * rdk) * uk
    return dq, dk, dv, dbias, rdq.sum((0, 1, 3))


def window_attention_bwd_plain(qkv, groups, bias, logit_scale, dout, *, ws, num_heads,
                               use_cos, sm_scale, has_mask=True):
    """Plain version of K5, the backward of K2.  qkv: (T, 3C); dout: (T, C).
    Returns dqkv (T, 3C) in qkv's dtype, dbias (h, ws, ws) f32 and dlogit_scale (h,)
    f32 (None for scaled-dot)."""
    T, C3 = qkv.shape
    C = C3 // 3
    h = num_heads
    nw = T // ws
    dt = qkv.dtype
    parts = qkv.reshape(nw, ws, 3, h, C // h).float()
    do = dout.to(dt).float().reshape(nw, ws, h, C // h)
    dq, dk, dv, dbias, dls = _attention_bwd(
        parts[:, :, 0], parts[:, :, 1], parts[:, :, 2], do, groups, bias, logit_scale,
        use_cos=use_cos, sm_scale=sm_scale, has_mask=has_mask, dt=dt)
    dqkv = torch.stack([dq, dk, dv], dim=2).reshape(T, C3).to(dt)
    return dqkv, dbias, dls


def window_attention_qkv_epi_bwd_plain(x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups,
                                       bias, logit_scale, dz, *, ws, num_heads, sm_scale,
                                       has_mask=True, ln_eps=1e-5):
    """Plain version of K4, the backward of K1.  dz: (T, C), the output's gradient.
    Returns (dx (T, C) in x's dtype, dwqkv (C, 3C), dbqkv (3C,), dwp (C, C), dbp (C,),
    dgamma (C,), dbeta (C,), dbias (h, ws, ws), dlogit_scale (h,)), the weight and
    bias gradients in f32 as the kernel accumulates them; dgamma/dbeta are None
    without LayerNorm."""
    dt = x.dtype
    T, C = x.shape
    h = num_heads
    hd = C // h
    nw = T // ws
    wq = wqkv.to(dt).float()
    wpf = wp.to(dt).float()
    qkv = _qkv_rows(x, wqkv, bqkv)
    parts = qkv.reshape(nw, ws, 3, h, hd)
    q, k, v = parts[:, :, 0], parts[:, :, 1], parts[:, :, 2]
    # forward recomputation up to the projection output u
    _, _, _, _, qs, kl, _ = _cos_preamble(q, k, logit_scale, dt)
    p_lo = _softmax(_scores(qs, kl, groups, bias, has_mask)).to(dt).float()
    o = torch.einsum("whij,wjhd->wihd", p_lo, v).to(dt).float().reshape(T, C)
    u = o @ wpf
    if bp is not None:
        u = u + bp.to(dt).float()
    # LayerNorm and projection backward
    dzf = dz.to(dt).float()
    dg = dbe = None
    if ln_scale is not None:
        mean = u.mean(-1, keepdim=True)
        xc = u - mean
        rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + ln_eps)
        xhat = xc * rstd
        dg = (dzf * xhat).sum(0)
        dbe = dzf.sum(0)
        dgl = dzf * ln_scale.float()
        du = rstd * (dgl - dgl.mean(-1, keepdim=True)
                     - xhat * (dgl * xhat).mean(-1, keepdim=True))
    else:
        du = dzf
    du_lo = du.to(dt).float()
    dwp = o.t() @ du_lo
    dbp = du.sum(0)
    do = (du_lo @ wpf.t()).to(dt).float().reshape(nw, ws, h, hd)
    # attention backward, then the qkv projection's
    dq, dk, dv, dbias, dls = _attention_bwd(q, k, v, do, groups, bias, logit_scale,
                                            use_cos=True, sm_scale=sm_scale,
                                            has_mask=has_mask, dt=dt)
    dqkv = torch.stack([dq, dk, dv], dim=2).reshape(T, 3 * C).to(dt).float()
    dx = (dqkv @ wq.t()).to(dt)
    return dx, x.float().t() @ dqkv, dqkv.sum(0), dwp, dbp, dg, dbe, dbias, dls


# --------------------------------------------------------------------------- kernels


def _check_cuda_operands(what, tensors, T, ws):
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{what}: every operand must be a CUDA tensor")
    dev = tensors[0].device
    if not all(t.device == dev for t in tensors):
        raise ValueError(f"{what}: operands on different devices")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError(f"{what}: operands must be contiguous and 16-byte aligned")
    if ws != KERNEL_WS:
        raise ValueError(f"{what}: the kernel takes ws={KERNEL_WS}, got {ws}")
    if T % ws:
        raise ValueError(f"{what}: T={T} is not a multiple of ws={ws}")


def _bias_operand(bias, h, ws, ref):
    if bias is None:
        return torch.zeros((h, ws, ws), dtype=torch.float32, device=ref.device)
    if bias.dtype != torch.float32 or tuple(bias.shape) != (h, ws, ws):
        raise ValueError(f"bias must be (h, ws, ws) = {(h, ws, ws)} float32")
    return bias.contiguous()


def _groups_operand(groups, has_mask, T, ws):
    if not has_mask:
        return None
    if (groups is None or groups.dtype != torch.int32
            or tuple(groups.shape) != (T // ws, ws)):
        raise ValueError(f"groups must be (T/ws, ws) = {(T // ws, ws)} int32")
    return groups.contiguous()


def _check_logit_scale(what, logit_scale, h):
    if (logit_scale is None or tuple(logit_scale.shape) != (h,)
            or logit_scale.dtype != torch.float32):
        raise ValueError(f"{what}: cosine attention needs a (h,) float32 logit_scale")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _attn_operands(what, qkv, groups, bias, logit_scale, num_heads, use_cos, has_mask, ws):
    """K2/K5's checked operands: (T, C, bias, groups, logit_scale or None)."""
    T, C3 = qkv.shape
    C = C3 // 3
    h = num_heads
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the kernel takes bfloat16 qkv")
    if C3 != 3 * C or C != h * KERNEL_HD:
        raise ValueError(f"{what}: the kernel takes head dim {KERNEL_HD}, got C={C}, "
                         f"heads={h}")
    bias_t = _bias_operand(bias, h, ws, qkv)
    groups_t = _groups_operand(groups, has_mask, T, ws)
    ls = None
    if use_cos:
        _check_logit_scale(what, logit_scale, h)
        ls = logit_scale.contiguous()
    return T, C, bias_t, groups_t, ls


def window_attention_fwd(qkv, groups, bias, logit_scale, *, ws, num_heads, use_cos, sm_scale,
                         has_mask=True, impl="auto"):
    """K2 wrapper (no autograd): attention from qkv rows (T, 3C) -> (T, C)."""
    if not use_kernel(qkv, impl):
        return window_attention_plain(qkv, groups, bias, logit_scale, ws=ws,
                                      num_heads=num_heads, use_cos=use_cos,
                                      sm_scale=sm_scale, has_mask=has_mask)
    what = "window_attention"
    T, C, bias_t, groups_t, ls = _attn_operands(what, qkv, groups, bias, logit_scale,
                                                num_heads, use_cos, has_mask, ws)
    _check_cuda_operands(what, [t for t in (qkv, groups_t, bias_t, ls) if t is not None],
                         T, ws)
    out = torch.empty((T, C), dtype=qkv.dtype, device=qkv.device)
    code = _build.lib().hs_window_attention(
        qkv.data_ptr(), _ptr(groups_t), bias_t.data_ptr(), _ptr(ls), out.data_ptr(), T, C,
        int(use_cos), int(has_mask), float(sm_scale), stream(qkv))
    check(code, what)
    _count(what, T, C, has_mask)
    return out


def window_attention_bwd(qkv, groups, bias, logit_scale, dout, *, ws, num_heads, use_cos,
                         sm_scale, has_mask=True, impl="auto"):
    """K5 wrapper: the backward of K2; operands and results as
    ``window_attention_bwd_plain``."""
    if not use_kernel(qkv, impl):
        return window_attention_bwd_plain(qkv, groups, bias, logit_scale, dout, ws=ws,
                                          num_heads=num_heads, use_cos=use_cos,
                                          sm_scale=sm_scale, has_mask=has_mask)
    what = "window_attention_bwd"
    T, C, bias_t, groups_t, ls = _attn_operands(what, qkv, groups, bias, logit_scale,
                                                num_heads, use_cos, has_mask, ws)
    h = num_heads
    if dout.dtype != torch.bfloat16 or tuple(dout.shape) != (T, C):
        raise ValueError(f"{what}: dout must be (T, C) = {(T, C)} bfloat16")
    dout = dout.contiguous()
    _check_cuda_operands(what, [t for t in (qkv, groups_t, bias_t, ls, dout) if t is not None],
                         T, ws)
    lib = _build.lib()
    dqkv = torch.empty_like(qkv)
    red = torch.empty(h * (KERNEL_WS * KERNEL_WS + 1), dtype=torch.float32, device=qkv.device)
    work = torch.empty(lib.hs_window_attention_bwd_workspace(T, C), dtype=torch.uint8,
                       device=qkv.device)
    code = lib.hs_window_attention_bwd(
        qkv.data_ptr(), _ptr(groups_t), bias_t.data_ptr(), _ptr(ls), dout.data_ptr(),
        dqkv.data_ptr(), red.data_ptr(), work.data_ptr(), T, C, int(use_cos), int(has_mask),
        float(sm_scale), stream(qkv))
    check(code, what)
    _count(what, T, C, has_mask)
    nb = h * KERNEL_WS * KERNEL_WS
    return (dqkv, red[:nb].reshape(h, KERNEL_WS, KERNEL_WS),
            red[nb:] if use_cos else None)


def _epi_operands(what, x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias,
                  logit_scale, num_heads, has_mask, ws):
    """K1/K4's checked operands in the kernels' dtypes."""
    T, C = x.shape
    h = num_heads
    dt = torch.bfloat16
    if x.dtype != dt:
        raise ValueError(f"{what}: the kernel takes bfloat16 x")
    if C != h * KERNEL_HD or C > KERNEL_MAX_C:
        raise ValueError(f"{what}: the kernel takes head dim {KERNEL_HD} and "
                         f"C <= {KERNEL_MAX_C}, got C={C}, heads={h}")
    if tuple(wqkv.shape) != (C, 3 * C) or tuple(wp.shape) != (C, C):
        raise ValueError(f"{what}: weights must be wqkv (C, 3C) and wp (C, C)")
    _check_logit_scale(what, logit_scale, h)
    ops = dict(
        wq=wqkv.to(dt).contiguous(), wp=wp.to(dt).contiguous(),
        bq=(torch.zeros(3 * C, dtype=dt, device=x.device) if bqkv is None
            else bqkv.to(dt).contiguous()),
        bp=torch.zeros(C, dtype=dt, device=x.device) if bp is None else bp.to(dt).contiguous(),
        g=None if ln_scale is None else ln_scale.float().contiguous(),
        b=None if ln_scale is None else ln_bias.float().contiguous(),
        groups=_groups_operand(groups, has_mask, T, ws),
        bias=_bias_operand(bias, h, ws, x), ls=logit_scale.contiguous())
    return T, C, ops


def window_attention_qkv_epi_fwd(x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias,
                                 logit_scale, *, ws, num_heads, sm_scale, has_mask=True,
                                 ln_eps=1e-5, impl="auto"):
    """K1 wrapper (no autograd): [LN](cos_attn(x @ wqkv + bqkv) @ wp + bp), (T, C)."""
    if not use_kernel(x, impl):
        return window_attention_qkv_epi_plain(
            x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias, logit_scale, ws=ws,
            num_heads=num_heads, sm_scale=sm_scale, has_mask=has_mask, ln_eps=ln_eps)
    what = "window_attention_qkv_epi"
    T, C, o = _epi_operands(what, x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias,
                            logit_scale, num_heads, has_mask, ws)
    _check_cuda_operands(what, [x] + [t for t in o.values() if t is not None], T, ws)
    out = torch.empty((T, C), dtype=x.dtype, device=x.device)
    code = _build.lib().hs_window_attention_qkv_epi(
        x.data_ptr(), o["wq"].data_ptr(), o["bq"].data_ptr(), o["wp"].data_ptr(),
        o["bp"].data_ptr(), _ptr(o["g"]), _ptr(o["b"]), _ptr(o["groups"]),
        o["bias"].data_ptr(), o["ls"].data_ptr(), out.data_ptr(), T, C,
        int(o["g"] is not None), int(has_mask), float(ln_eps), stream(x))
    check(code, what)
    _count(what, T, C, has_mask)
    return out


def window_attention_qkv_epi_bwd(x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias,
                                 logit_scale, dz, *, ws, num_heads, sm_scale, has_mask=True,
                                 ln_eps=1e-5, impl="auto"):
    """K4 wrapper: the backward of K1; operands and results as
    ``window_attention_qkv_epi_bwd_plain``."""
    if not use_kernel(x, impl):
        return window_attention_qkv_epi_bwd_plain(
            x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias, logit_scale, dz, ws=ws,
            num_heads=num_heads, sm_scale=sm_scale, has_mask=has_mask, ln_eps=ln_eps)
    what = "window_attention_qkv_epi_bwd"
    T, C, o = _epi_operands(what, x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias,
                            logit_scale, num_heads, has_mask, ws)
    if dz.dtype != x.dtype or tuple(dz.shape) != (T, C):
        raise ValueError(f"{what}: dz must be (T, C) = {(T, C)} bfloat16")
    dz = dz.contiguous()
    _check_cuda_operands(what, [x, dz] + [t for t in o.values() if t is not None], T, ws)
    h = num_heads
    lib = _build.lib()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dwq = torch.empty((C, 3 * C), **f32)
    dwp = torch.empty((C, C), **f32)
    nb = h * KERNEL_WS * KERNEL_WS
    red = torch.empty(nb + h + 6 * C, **f32)
    work = torch.empty(lib.hs_window_attention_qkv_epi_bwd_workspace(T, C), dtype=torch.uint8,
                       device=x.device)
    has_ln = o["g"] is not None
    code = lib.hs_window_attention_qkv_epi_bwd(
        x.data_ptr(), o["wq"].data_ptr(), o["bq"].data_ptr(), o["wp"].data_ptr(),
        o["bp"].data_ptr(), _ptr(o["g"]), _ptr(o["b"]), _ptr(o["groups"]),
        o["bias"].data_ptr(), o["ls"].data_ptr(), dz.data_ptr(), dx.data_ptr(),
        dwq.data_ptr(), dwp.data_ptr(), red.data_ptr(), work.data_ptr(), T, C, int(has_ln),
        int(has_mask), float(ln_eps), stream(x))
    check(code, what)
    _count(what, T, C, has_mask)
    dbias = red[:nb].reshape(h, KERNEL_WS, KERNEL_WS)
    dls = red[nb:nb + h]
    dbq, dbp, dg, dbe = red[nb + h:].split([3 * C, C, C, C])
    return (dx, dwq, dbq, dwp, dbp, dg if has_ln else None, dbe if has_ln else None,
            dbias, dls)


# --------------------------------------------------------------------------- autograd


class _WindowAttention(torch.autograd.Function):
    """K2 forward, K5 backward (or their plain versions, by ``impl`` and device)."""

    @staticmethod
    def forward(ctx, qkv, groups, bias, logit_scale, kw):
        ctx.kw = kw
        ctx.save_for_backward(qkv, groups, bias, logit_scale)
        return window_attention_fwd(qkv, groups, bias, logit_scale, **kw)

    @staticmethod
    def backward(ctx, dout):
        qkv, groups, bias, logit_scale = ctx.saved_tensors
        dqkv, dbias, dls = window_attention_bwd(qkv, groups, bias, logit_scale,
                                                dout.to(qkv.dtype), **ctx.kw)
        return input_grads(ctx, [(dqkv, qkv), (None, groups), (dbias, bias),
                                 (dls, logit_scale), (None, None)])


class _WindowAttentionQkvEpi(torch.autograd.Function):
    """K1 forward, K4 backward (or their plain versions, by ``impl`` and device)."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias, logit_scale,
                kw):
        ctx.kw = kw
        ctx.save_for_backward(x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias,
                              logit_scale)
        return window_attention_qkv_epi_fwd(x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups,
                                            bias, logit_scale, **kw)

    @staticmethod
    def backward(ctx, dz):
        saved = ctx.saved_tensors
        x = saved[0]
        grads = window_attention_qkv_epi_bwd(*saved, dz.to(x.dtype), **ctx.kw)
        dx, dwq, dbq, dwp, dbp, dg, dbe, dbias, dls = grads
        return input_grads(ctx, list(zip(
            (dx, dwq, dbq, dwp, dbp, dg, dbe, None, dbias, dls, None), saved + (None,))))


def window_attention(qkv, groups, bias, logit_scale, *, ws, num_heads, use_cos, sm_scale,
                     has_mask=True, impl="auto"):
    """Attention from qkv rows (T, 3C) -> (T, C): K2 forward, K5 backward."""
    kw = dict(ws=ws, num_heads=num_heads, use_cos=use_cos, sm_scale=sm_scale,
              has_mask=has_mask, impl=impl)
    return _WindowAttention.apply(qkv, groups, bias, logit_scale, kw)


def window_attention_qkv_epi(x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias,
                             logit_scale, *, ws, num_heads, sm_scale, has_mask=True,
                             ln_eps=1e-5, impl="auto"):
    """[LN](cos_attn(x @ wqkv + bqkv) @ wp + bp), (T, C) -> (T, C): K1 forward, K4
    backward.  Pass the weights already cast to x's dtype to get their gradients in
    that dtype, as the model does."""
    kw = dict(ws=ws, num_heads=num_heads, sm_scale=sm_scale, has_mask=has_mask,
              ln_eps=ln_eps, impl=impl)
    return _WindowAttentionQkvEpi.apply(x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups,
                                        bias, logit_scale, kw)


def clamped_logit_scale(logit_scale: torch.Tensor) -> torch.Tensor:
    """exp(min(logit_scale, ln 100)) as (h,) float32."""
    return torch.exp(torch.clamp_max(logit_scale.float(), math.log(1.0 / 0.01))).reshape(-1)
