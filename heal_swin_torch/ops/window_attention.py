"""Window multi-head self-attention: plain PyTorch versions and the CUDA kernels.

Counterpart of ``heal_swin_tpu/ops/window_attention.py``.  Three entry points, each an
autograd-capable function on the JAX kernels' operand layout, whose forward and
backward are each a kernel wrapper beside its plain version:

- ``window_attention`` (K2 forward, K5 backward): attention from precomputed qkv rows
  (T, 3C) -> (T, C), cosine or scaled-dot (Pallas ``fused_window_attention``).
- ``window_attention_qkv_epi`` (K1 forward, K4 backward): x @ Wqkv + b -> cosine
  attention -> @ Wp + bp -> optional LayerNorm, (T, C) -> (T, C) (Pallas
  ``fused_window_attention_qkv_epi``).
- ``window_attention_qkv`` (K16 forward, K17 backward): x @ Wqkv + b -> attention,
  cosine or scaled-dot, (T, C) -> the (T, C) result before the output projection
  (Pallas ``fused_window_attention_qkv``).

K4 is a launch sequence from one C entry: K16's cosine kernel (o, K1's bits), the
projection/LayerNorm backward (du and dbp, dgamma, dbeta), ``gemm_tn`` (dWp) and
``gemm_nt`` (do), then K17's cosine kernel on (x, do).  Two of its steps can be held to
their plain twins alone: ``gemm_nt`` (also K17's dx product dqkv Wqkv^T,
``csrc/reduce.cu``) beside ``gemm_nt_plain``, and ``qkv_epi_proj_ln_bwd`` beside
``qkv_epi_proj_ln_bwd_plain``.  Neither counts a launch: inside K4 and K17 they are
those kernels' launches.

Operands: ``groups`` (T/ws, ws) int32 mask group ids (attention between tokens of
different groups gets an additive -100); ``bias`` (h, ws, ws) f32 relative-position
bias or None; ``logit_scale`` (h,) f32, already exp(min(., ln 100)).  Weights are in
the JAX layout (in, out).

Rounding follows the Pallas kernels, so that kernel and plain version agree closely
in bf16.  Forward: qkv -> dtype; q_hat = q * scale / |q| and k_hat = k / |k| ->
dtype; softmax in f32, p -> dtype; o -> dtype; the projection and LayerNorm in f32,
output -> dtype.  Backward (``_cos_wide_preamble`` / ``_cos_wide_head_bwd`` /
``_bwd_kernel_xw_epi``, ``_bwd_kernel_xw``): qkv recomputed and rounded; (q/|q|)*scale
and k/|k| rounded; p rounded before dv; ds rounded before the q/k products (scaled-dot
multiplies sm_scale in after them); the LayerNorm backward's du rounded before dWp and
do; do rounded; dqkv rounded before dx, dW and db.  The softmax shift is the row max
(the Pallas kernels use a static bound for cosine attention; softmax is
shift-invariant, and forward and backward here use the same one).

Float32: f32 operands run the f32 kernels, nothing rounded below f32, as the Pallas
kernels compute with f32 operands.  Forwards (``csrc/window_attention_f32.cu``): K2 four
warps per (window, head); K16 the qkv product ``gemm_nn_f32`` then K2's kernel; K1 those
two, the output product and the LayerNorm's rows.  Backwards
(``csrc/window_attention_bwd_f32.cu``): K5 one 4-warp block per run of windows of a head
that recomputes the forward's P through K2's own functions, then ``reduce_rows`` of its
partial rows; K17 K16's qkv product, K5's core, the column sums, the TN product (dWqkv,
split over the tokens, ``reduce_rows``) and the NT product (dx, ``gemm_nt``); K4 K16, the
projection/LayerNorm backward (``qkv_epi_proj_ln_bwd``), dWp (TN) and do (NT), then K17
on K16's qkv.  Every product on the tensor cores in 3xTF32 (each operand split into two
TF32 parts, three products summed in f32: ``ops/tf32.py`` emulates it): the forwards' and
the recomputed qkv and u on mma.sync, the backwards' own TN and NT products (dWqkv, dx,
dWp, do) on the wgmma core of ``csrc/gemm_3xtf32_wgmma.cuh``.

Dispatch (``impl``): "auto" runs the kernel for a CUDA tensor and the plain version
for a CPU tensor; "xla" runs the plain version on any device (the JAX package's name
for its non-kernel path); "pallas" demands the kernel and raises on a CPU tensor.  On a
CUDA tensor a wrapper runs its kernel or raises: operands the kernel was not written
for (``kernels_take``: bf16 or f32; ws 64, head dim 32, T % 64, C <= 384 for the
fused-qkv kernels) raise under "auto" as under "pallas", naming "xla"
as the plain route, and a kernel that fails to build or launch raises; nothing falls
back.  The backward takes the same route as the forward (a family's kernels take the
same operands).  The autograd functions take the weights already cast to the compute
dtype and return their gradients in that dtype, as the JAX custom VJPs do; the
LayerNorm parameters, bias and logit scale get f32 gradients.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Optional

import torch

from heal_swin_torch import _build
from heal_swin_torch.ops._dispatch import (check, f32_suffix, input_grads, refuse, stream,
                                           use_kernel)

MASK_VALUE = -100.0
KERNEL_WS = 64  # the kernels' window size
KERNEL_HD = 32  # the kernels' head dim
KERNEL_MAX_C = 384  # K1/K4/K16/K17's shared-memory bound (x tile of 64 x C bf16)
# the widest C each family's kernels take (None: any multiple of the head dim)
FAMILY_MAX_C = {"window_attention": None, "window_attention_qkv_epi": KERNEL_MAX_C,
                "window_attention_qkv": KERNEL_MAX_C}

# launch counters, bumped only where a kernel launches: per kernel, and per
# (kernel, T, C, has_mask); the f32 kernels count as "<kernel>_f32"
launches = {"window_attention": 0, "window_attention_qkv_epi": 0, "window_attention_qkv": 0,
            "window_attention_bwd": 0, "window_attention_qkv_epi_bwd": 0,
            "window_attention_qkv_bwd": 0, "window_attention_f32": 0,
            "window_attention_qkv_epi_f32": 0, "window_attention_qkv_f32": 0,
            "window_attention_bwd_f32": 0, "window_attention_qkv_bwd_f32": 0,
            "window_attention_qkv_epi_bwd_f32": 0}
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


def window_attention_qkv_plain(x, wqkv, bqkv, groups, bias, logit_scale, *, ws, num_heads,
                               use_cos, sm_scale, has_mask=True):
    """Plain version of K16: qkv = x @ wqkv + bqkv (the bias added to the f32 product,
    then rounded, as ``_fwd_kernel_xw``), then K2's attention.  x: (T, C); wqkv:
    (C, 3C) -> (T, C) in x's dtype, before the output projection."""
    return window_attention_plain(_qkv_rows(x, wqkv, bqkv).to(x.dtype), groups, bias,
                                  logit_scale, ws=ws, num_heads=num_heads, use_cos=use_cos,
                                  sm_scale=sm_scale, has_mask=has_mask)


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


def window_attention_qkv_bwd_plain(x, wqkv, bqkv, groups, bias, logit_scale, dout, *, ws,
                                   num_heads, use_cos, sm_scale, has_mask=True):
    """Plain version of K17, the backward of K16 (``_bwd_kernel_xw``): qkv recomputed
    and rounded, K5's attention backward, then over the rounded dqkv dx = dqkv Wqkv^T,
    dW = x^T dqkv and db = sum dqkv.  Returns (dx (T, C) in x's dtype, dwqkv (C, 3C),
    dbqkv (3C,), dbias (h, ws, ws), dlogit_scale (h,) or None for scaled-dot), the
    last four f32 as the kernel accumulates them."""
    dt = x.dtype
    dqkv, dbias, dls = window_attention_bwd_plain(
        _qkv_rows(x, wqkv, bqkv).to(dt), groups, bias, logit_scale, dout, ws=ws,
        num_heads=num_heads, use_cos=use_cos, sm_scale=sm_scale, has_mask=has_mask)
    dqkv = dqkv.float()
    dx = gemm_nt_plain(dqkv, wqkv.to(dt))
    return dx, x.float().t() @ dqkv, dqkv.sum(0), dbias, dls


def gemm_nt_plain(a, b):
    """Plain twin of ``gemm_nt``: a (M, K) @ b (N, K)^T in f32 from the operands as
    they are, rounded to b's dtype."""
    return (a.float() @ b.float().t()).to(b.dtype)


def qkv_epi_proj_ln_bwd_plain(o, wp, bp, ln_scale, dz, ln_eps=1e-5):
    """Plain version of K4's projection/LayerNorm backward, the second step of K4's
    launch sequence and the part of ``window_attention_qkv_epi_bwd_plain`` from the
    projection output u to its gradient du.  o: (T, C) attention output in the compute
    dtype; wp: (C, C); dz: (T, C), the output's gradient.  With LayerNorm (``ln_scale``
    given) u = o @ wp + bp is recomputed in f32 and du is LayerNorm's backward (f32 row
    statistics, as the forward takes them); without it du = dz.  Returns (du (T, C)
    rounded to o's dtype, dbp (C,) summed from the f32 du, dgamma (C,), dbeta (C,)),
    the last three f32; dgamma and dbeta are None without LayerNorm."""
    dt = o.dtype
    dzf = dz.to(dt).float()
    if ln_scale is None:
        return dzf.to(dt), dzf.sum(0), None, None
    u = o.float() @ wp.to(dt).float()
    if bp is not None:
        u = u + bp.to(dt).float()
    mean = u.mean(-1, keepdim=True)
    xc = u - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + ln_eps)
    xhat = xc * rstd
    dgl = dzf * ln_scale.float()
    du = rstd * (dgl - dgl.mean(-1, keepdim=True) - xhat * (dgl * xhat).mean(-1, keepdim=True))
    return du.to(dt), du.sum(0), (dzf * xhat).sum(0), dzf.sum(0)


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
    # LayerNorm and projection backward
    du, dbp, dg, dbe = qkv_epi_proj_ln_bwd_plain(o.to(dt), wp, bp, ln_scale, dz, ln_eps)
    du_lo = du.float()
    dwp = o.t() @ du_lo
    do = (du_lo @ wpf.t()).to(dt).float().reshape(nw, ws, h, hd)
    # attention backward, then the qkv projection's
    dq, dk, dv, dbias, dls = _attention_bwd(q, k, v, do, groups, bias, logit_scale,
                                            use_cos=True, sm_scale=sm_scale,
                                            has_mask=has_mask, dt=dt)
    dqkv = torch.stack([dq, dk, dv], dim=2).reshape(T, 3 * C).to(dt).float()
    dx = (dqkv @ wq.t()).to(dt)
    return dx, x.float().t() @ dqkv, dqkv.sum(0), dwp, dbp, dg, dbe, dbias, dls


# --------------------------------------------------------------------------- kernels


def _refusal(family, what, T, C, num_heads, ws, dtype):
    """Why the kernels of ``family`` (a key of FAMILY_MAX_C) do not take tokens of
    this shape and dtype, or None where they do: the wrappers' refusal and
    ``kernels_take``.  A family's forward and backward take the same operands."""
    max_c = FAMILY_MAX_C[family]
    if dtype not in (torch.bfloat16, torch.float32):
        return f"{what}: the kernel takes bfloat16 or float32 operands, got {dtype}"
    if ws != KERNEL_WS:
        return f"{what}: the kernel takes ws={KERNEL_WS}, got {ws}"
    if T % ws:
        return f"{what}: T={T} is not a multiple of ws={ws}"
    if C != num_heads * KERNEL_HD or (max_c is not None and C > max_c):
        bound = "" if max_c is None else f" and C <= {max_c}"
        return (f"{what}: the kernel takes head dim {KERNEL_HD}{bound}, got C={C}, "
                f"heads={num_heads}")
    return None


def kernels_take(family, T, C, num_heads, ws, dtype) -> bool:
    """Whether the kernels of ``family`` -- "window_attention" (K2/K5),
    "window_attention_qkv_epi" (K1/K4) or "window_attention_qkv" (K16/K17) -- take T
    tokens of width C in ``num_heads`` heads, windows of ``ws`` and ``dtype``, forward
    and backward alike: bf16 or f32.  Exactly the wrappers' shape and dtype checks:
    where False, a CUDA tensor raises under "auto" and "pallas" and needs impl="xla",
    the plain version."""
    return _refusal(family, "", T, C, num_heads, ws, dtype) is None


def _refuse(family, what, T, C, num_heads, ws, dtype):
    msg = _refusal(family, what, T, C, num_heads, ws, dtype)
    if msg is not None:
        refuse(msg)


def _check_cuda_operands(what, tensors):
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{what}: every operand must be a CUDA tensor")
    dev = tensors[0].device
    if not all(t.device == dev for t in tensors):
        raise ValueError(f"{what}: operands on different devices")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError(f"{what}: operands must be contiguous and 16-byte aligned")


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


def _attn_shape(qkv):
    """(T, C) of qkv rows (T, 3C); C is -1 where the width is not a multiple of 3."""
    T, C3 = qkv.shape
    return T, C3 // 3 if C3 % 3 == 0 else -1


def _attn_operands(what, qkv, groups, bias, logit_scale, num_heads, use_cos, has_mask, ws):
    """K2/K5's checked operands: (T, C, bias, groups, logit_scale or None)."""
    T, C = _attn_shape(qkv)
    h = num_heads
    _refuse("window_attention", what, T, C, h, ws, qkv.dtype)
    bias_t = _bias_operand(bias, h, ws, qkv)
    groups_t = _groups_operand(groups, has_mask, T, ws)
    ls = None
    if use_cos:
        _check_logit_scale(what, logit_scale, h)
        ls = logit_scale.contiguous()
    return T, C, bias_t, groups_t, ls


def window_attention_fwd(qkv, groups, bias, logit_scale, *, ws, num_heads, use_cos, sm_scale,
                         has_mask=True, impl="auto"):
    """K2 wrapper (no autograd): attention from qkv rows (T, 3C) -> (T, C); bf16 qkv, or
    f32 (the f32 kernel, counted as "window_attention_f32")."""
    if not use_kernel(qkv, impl):
        return window_attention_plain(qkv, groups, bias, logit_scale, ws=ws,
                                      num_heads=num_heads, use_cos=use_cos,
                                      sm_scale=sm_scale, has_mask=has_mask)
    what = "window_attention"
    T, C, bias_t, groups_t, ls = _attn_operands(what, qkv, groups, bias, logit_scale,
                                                num_heads, use_cos, has_mask, ws)
    _check_cuda_operands(what, [t for t in (qkv, groups_t, bias_t, ls) if t is not None])
    sfx = f32_suffix(qkv)
    out = torch.empty((T, C), dtype=qkv.dtype, device=qkv.device)
    code = getattr(_build.lib(), f"hs_window_attention{sfx}")(
        qkv.data_ptr(), _ptr(groups_t), bias_t.data_ptr(), _ptr(ls), out.data_ptr(), T, C,
        int(use_cos), int(has_mask), float(sm_scale), stream(qkv))
    check(code, what + sfx)
    _count(what + sfx, T, C, has_mask)
    return out


def window_attention_bwd(qkv, groups, bias, logit_scale, dout, *, ws, num_heads, use_cos,
                         sm_scale, has_mask=True, impl="auto"):
    """K5 wrapper: the backward of K2; operands and results as
    ``window_attention_bwd_plain``; bf16, or f32 (counted as "window_attention_bwd_f32")."""
    if not use_kernel(qkv, impl):
        return window_attention_bwd_plain(qkv, groups, bias, logit_scale, dout, ws=ws,
                                          num_heads=num_heads, use_cos=use_cos,
                                          sm_scale=sm_scale, has_mask=has_mask)
    what = "window_attention_bwd"
    T, C, bias_t, groups_t, ls = _attn_operands(what, qkv, groups, bias, logit_scale,
                                                num_heads, use_cos, has_mask, ws)
    h = num_heads
    if dout.dtype != qkv.dtype or tuple(dout.shape) != (T, C):
        raise ValueError(f"{what}: dout must be (T, C) = {(T, C)} {qkv.dtype}")
    dout = dout.contiguous()
    _check_cuda_operands(what, [t for t in (qkv, groups_t, bias_t, ls, dout) if t is not None])
    lib = _build.lib()
    sfx = f32_suffix(qkv)
    dqkv = torch.empty_like(qkv)
    red = torch.empty(h * (KERNEL_WS * KERNEL_WS + 1), dtype=torch.float32, device=qkv.device)
    work = torch.empty(getattr(lib, f"hs_window_attention_bwd{sfx}_workspace")(T, C),
                       dtype=torch.uint8, device=qkv.device)
    code = getattr(lib, f"hs_window_attention_bwd{sfx}")(
        qkv.data_ptr(), _ptr(groups_t), bias_t.data_ptr(), _ptr(ls), dout.data_ptr(),
        dqkv.data_ptr(), red.data_ptr(), work.data_ptr(), T, C, int(use_cos), int(has_mask),
        float(sm_scale), stream(qkv))
    check(code, what + sfx)
    _count(what + sfx, T, C, has_mask)
    nb = h * KERNEL_WS * KERNEL_WS
    return (dqkv, red[:nb].reshape(h, KERNEL_WS, KERNEL_WS),
            red[nb:] if use_cos else None)


def _epi_operands(what, x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias,
                  logit_scale, num_heads, has_mask, ws):
    """K1/K4's checked operands in the kernels' dtypes."""
    T, C = x.shape
    if tuple(wp.shape) != (C, C):
        raise ValueError(f"{what}: wp must be (C, C) = {(C, C)}")
    dt = x.dtype
    ops = _qkv_operands("window_attention_qkv_epi", what, x, wqkv, bqkv, groups, bias,
                        logit_scale, num_heads, True, has_mask, ws)
    ops.update(
        wp=wp.to(dt).contiguous(),
        bp=torch.zeros(C, dtype=dt, device=x.device) if bp is None else bp.to(dt).contiguous(),
        g=None if ln_scale is None else ln_scale.float().contiguous(),
        b=None if ln_scale is None else ln_bias.float().contiguous())
    return T, C, ops


def _qkv_operands(family, what, x, wqkv, bqkv, groups, bias, logit_scale, num_heads, use_cos,
                  has_mask, ws):
    """The checked operands the kernels with the qkv projection inside (K1/K4,
    K16/K17) share, in the kernels' dtypes (x's: bf16 or f32): x, wq, bq, groups, bias,
    ls (None for scaled-dot)."""
    T, C = x.shape
    h = num_heads
    _refuse(family, what, T, C, h, ws, x.dtype)
    if tuple(wqkv.shape) != (C, 3 * C):
        raise ValueError(f"{what}: wqkv must be (C, 3C) = {(C, 3 * C)}")
    ls = None
    if use_cos:
        _check_logit_scale(what, logit_scale, h)
        ls = logit_scale.contiguous()
    dt = x.dtype
    return dict(
        x=x.contiguous(), wq=wqkv.to(dt).contiguous(),
        bq=(torch.zeros(3 * C, dtype=dt, device=x.device) if bqkv is None
            else bqkv.to(dt).contiguous()),
        groups=_groups_operand(groups, has_mask, T, ws),
        bias=_bias_operand(bias, h, ws, x), ls=ls)


def window_attention_qkv_epi_fwd(x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias,
                                 logit_scale, *, ws, num_heads, sm_scale, has_mask=True,
                                 ln_eps=1e-5, impl="auto"):
    """K1 wrapper (no autograd): [LN](cos_attn(x @ wqkv + bqkv) @ wp + bp), (T, C); bf16
    x, or f32 (the f32 launch sequence, counted as "window_attention_qkv_epi_f32")."""
    if not use_kernel(x, impl):
        return window_attention_qkv_epi_plain(
            x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias, logit_scale, ws=ws,
            num_heads=num_heads, sm_scale=sm_scale, has_mask=has_mask, ln_eps=ln_eps)
    what = "window_attention_qkv_epi"
    T, C, o = _epi_operands(what, x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias,
                            logit_scale, num_heads, has_mask, ws)
    x = o.pop("x")
    _check_cuda_operands(what, [x] + [t for t in o.values() if t is not None])
    lib = _build.lib()
    sfx = f32_suffix(x)
    out = torch.empty((T, C), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), o["wq"].data_ptr(), o["bq"].data_ptr(), o["wp"].data_ptr(),
            o["bp"].data_ptr(), _ptr(o["g"]), _ptr(o["b"]), _ptr(o["groups"]),
            o["bias"].data_ptr(), o["ls"].data_ptr(), out.data_ptr())
    if sfx:  # the f32 launch sequence's workspace: qkv and o
        work = torch.empty(lib.hs_window_attention_qkv_epi_f32_workspace(T, C),
                           dtype=torch.uint8, device=x.device)
        args += (work.data_ptr(),)
    code = getattr(lib, f"hs_window_attention_qkv_epi{sfx}")(
        *args, T, C, int(o["g"] is not None), int(has_mask), float(ln_eps), stream(x))
    check(code, what + sfx)
    _count(what + sfx, T, C, has_mask)
    return out


def window_attention_qkv_epi_bwd(x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias,
                                 logit_scale, dz, *, ws, num_heads, sm_scale, has_mask=True,
                                 ln_eps=1e-5, impl="auto"):
    """K4 wrapper: the backward of K1; operands and results as
    ``window_attention_qkv_epi_bwd_plain``; bf16, or f32 (counted as
    "window_attention_qkv_epi_bwd_f32")."""
    if not use_kernel(x, impl):
        return window_attention_qkv_epi_bwd_plain(
            x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias, logit_scale, dz, ws=ws,
            num_heads=num_heads, sm_scale=sm_scale, has_mask=has_mask, ln_eps=ln_eps)
    what = "window_attention_qkv_epi_bwd"
    T, C, o = _epi_operands(what, x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias,
                            logit_scale, num_heads, has_mask, ws)
    x = o.pop("x")
    if dz.dtype != x.dtype or tuple(dz.shape) != (T, C):
        raise ValueError(f"{what}: dz must be (T, C) = {(T, C)} {x.dtype}")
    dz = dz.contiguous()
    _check_cuda_operands(what, [x, dz] + [t for t in o.values() if t is not None])
    h = num_heads
    lib = _build.lib()
    sfx = f32_suffix(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dwq = torch.empty((C, 3 * C), **f32)
    dwp = torch.empty((C, C), **f32)
    nb = h * KERNEL_WS * KERNEL_WS
    red = torch.empty(nb + h + 6 * C, **f32)
    work = torch.empty(getattr(lib, f"hs_window_attention_qkv_epi_bwd{sfx}_workspace")(T, C),
                       dtype=torch.uint8, device=x.device)
    has_ln = o["g"] is not None
    code = getattr(lib, f"hs_window_attention_qkv_epi_bwd{sfx}")(
        x.data_ptr(), o["wq"].data_ptr(), o["bq"].data_ptr(), o["wp"].data_ptr(),
        o["bp"].data_ptr(), _ptr(o["g"]), _ptr(o["b"]), _ptr(o["groups"]),
        o["bias"].data_ptr(), o["ls"].data_ptr(), dz.data_ptr(), dx.data_ptr(),
        dwq.data_ptr(), dwp.data_ptr(), red.data_ptr(), work.data_ptr(), T, C, int(has_ln),
        int(has_mask), float(ln_eps), stream(x))
    check(code, what + sfx)
    _count(what + sfx, T, C, has_mask)
    dbias = red[:nb].reshape(h, KERNEL_WS, KERNEL_WS)
    dls = red[nb:nb + h]
    dbq, dbp, dg, dbe = red[nb + h:].split([3 * C, C, C, C])
    return (dx, dwq, dbq, dwp, dbp, dg if has_ln else None, dbe if has_ln else None,
            dbias, dls)


def window_attention_qkv_fwd(x, wqkv, bqkv, groups, bias, logit_scale, *, ws, num_heads,
                             use_cos, sm_scale, has_mask=True, impl="auto"):
    """K16 wrapper (no autograd): attn(x @ wqkv + bqkv), (T, C) -> (T, C), before the
    output projection; bf16, or f32 (the f32 launch sequence, counted as
    "window_attention_qkv_f32")."""
    kw = dict(ws=ws, num_heads=num_heads, use_cos=use_cos, sm_scale=sm_scale,
              has_mask=has_mask)
    if not use_kernel(x, impl):
        return window_attention_qkv_plain(x, wqkv, bqkv, groups, bias, logit_scale, **kw)
    what = "window_attention_qkv"
    T, C = x.shape
    o = _qkv_operands(what, what, x, wqkv, bqkv, groups, bias, logit_scale, num_heads,
                      use_cos, has_mask, ws)
    _check_cuda_operands(what, [t for t in o.values() if t is not None])
    lib = _build.lib()
    sfx = f32_suffix(x)
    out = torch.empty((T, C), dtype=x.dtype, device=x.device)
    args = (o["x"].data_ptr(), o["wq"].data_ptr(), o["bq"].data_ptr(), _ptr(o["groups"]),
            o["bias"].data_ptr(), _ptr(o["ls"]), out.data_ptr())
    if sfx:  # the f32 launch sequence's workspace: qkv
        work = torch.empty(lib.hs_window_attention_qkv_f32_workspace(T, C), dtype=torch.uint8,
                           device=x.device)
        args += (work.data_ptr(),)
    code = getattr(lib, f"hs_window_attention_qkv{sfx}")(
        *args, T, C, int(use_cos), int(has_mask), float(sm_scale), stream(x))
    check(code, what + sfx)
    _count(what + sfx, T, C, has_mask)
    return out


def window_attention_qkv_bwd(x, wqkv, bqkv, groups, bias, logit_scale, dout, *, ws,
                             num_heads, use_cos, sm_scale, has_mask=True, impl="auto"):
    """K17 wrapper: the backward of K16; operands and results as
    ``window_attention_qkv_bwd_plain``; bf16, or f32 (counted as
    "window_attention_qkv_bwd_f32")."""
    kw = dict(ws=ws, num_heads=num_heads, use_cos=use_cos, sm_scale=sm_scale,
              has_mask=has_mask)
    if not use_kernel(x, impl):
        return window_attention_qkv_bwd_plain(x, wqkv, bqkv, groups, bias, logit_scale, dout,
                                              **kw)
    what = "window_attention_qkv_bwd"
    T, C = x.shape
    o = _qkv_operands("window_attention_qkv", what, x, wqkv, bqkv, groups, bias, logit_scale,
                      num_heads, use_cos, has_mask, ws)
    if dout.dtype != x.dtype or tuple(dout.shape) != (T, C):
        raise ValueError(f"{what}: dout must be (T, C) = {(T, C)} {x.dtype}")
    dout = dout.contiguous()
    _check_cuda_operands(what, [dout] + [t for t in o.values() if t is not None])
    h = num_heads
    lib = _build.lib()
    sfx = f32_suffix(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dwq = torch.empty((C, 3 * C), **f32)
    nb = h * KERNEL_WS * KERNEL_WS
    red = torch.empty(nb + h + 3 * C, **f32)
    work = torch.empty(getattr(lib, f"hs_window_attention_qkv_bwd{sfx}_workspace")(T, C),
                       dtype=torch.uint8, device=x.device)
    code = getattr(lib, f"hs_window_attention_qkv_bwd{sfx}")(
        o["x"].data_ptr(), o["wq"].data_ptr(), o["bq"].data_ptr(), _ptr(o["groups"]),
        o["bias"].data_ptr(), _ptr(o["ls"]), dout.data_ptr(), dx.data_ptr(), dwq.data_ptr(),
        red.data_ptr(), work.data_ptr(), T, C, int(use_cos), int(has_mask), float(sm_scale),
        stream(x))
    check(code, what + sfx)
    _count(what + sfx, T, C, has_mask)
    return (dx, dwq, red[nb + h:], red[:nb].reshape(h, KERNEL_WS, KERNEL_WS),
            red[nb:nb + h] if use_cos else None)


def gemm_nt(a, b, *, impl="auto"):
    """a (M, K) @ b (N, K)^T -> (M, N) through ``gemm_nt`` of ``csrc/reduce.cu`` (bf16) or
    the NT ``gemm_3xtf32_wg_kernel`` of ``csrc/gemm_3xtf32_wgmma.cuh`` (f32, 3xTF32), the
    product K17 runs for dx = dqkv Wqkv^T and K4 for do = du Wp^T (inside their entries,
    counted as their launches); bf16 or f32 operands of one dtype, M % 64 == 0, K % 32
    == 0, N % 8 == 0.  Plain twin: ``gemm_nt_plain``."""
    if not use_kernel(a, impl):
        return gemm_nt_plain(a, b)
    what = "gemm_nt"
    (M, K), (N, Kb) = a.shape, b.shape
    if a.dtype not in (torch.bfloat16, torch.float32) or b.dtype != a.dtype:
        refuse(f"{what}: the kernel takes bfloat16 or float32 operands of one dtype, got "
               f"{a.dtype}, {b.dtype}")
    if K != Kb or M % 64 or K % 32 or N % 8:
        refuse(f"{what}: the kernel takes M % 64 == 0, K % 32 == 0 and N % 8 == 0, got "
               f"a {tuple(a.shape)}, b {tuple(b.shape)}")
    a, b = a.contiguous(), b.contiguous()
    _check_cuda_operands(what, [a, b])
    sfx = f32_suffix(a)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    check(getattr(_build.lib(), f"hs_gemm_nt{sfx}")(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                                    M, N, K, stream(a)), what + sfx)
    return out


def gemm_nn_f32_plain(a, b, bias=None):
    """Plain twin of ``gemm_nn_f32``: a (M, K) @ b (K, N) [+ bias] in f32 (TF32 off)."""
    out = a.float() @ b.float()
    return out if bias is None else out + bias.float()


def gemm_nn_f32(a, b, bias=None, *, impl="auto"):
    """a (M, K) @ b (K, N) [+ bias (N,)] -> (M, N) f32 through ``gemm_3xtf32_kernel`` of
    ``csrc/window_attention_f32.cu`` (3xTF32 mma.sync), the product the f32 K1 runs for
    qkv = x Wqkv + bqkv and u = o Wp + bp (inside its entry, counted as its launch); f32
    operands, M % 64 == 0, K % 32 == 0, N % 4 == 0.  Plain twin: ``gemm_nn_f32_plain``."""
    if not use_kernel(a, impl):
        return gemm_nn_f32_plain(a, b, bias)
    what = "gemm_nn_f32"
    (M, K), (Kb, N) = a.shape, b.shape
    if any(t is not None and t.dtype != torch.float32 for t in (a, b, bias)):
        refuse(f"{what}: the kernel takes float32 operands")
    if K != Kb or M % 64 or K % 32 or N % 4 or (bias is not None and bias.shape != (N,)):
        refuse(f"{what}: the kernel takes M % 64 == 0, K % 32 == 0, N % 4 == 0 and a (N,) "
               f"bias, got a {tuple(a.shape)}, b {tuple(b.shape)}")
    a, b = a.contiguous(), b.contiguous()
    bias = None if bias is None else bias.contiguous()
    _check_cuda_operands(what, [t for t in (a, b, bias) if t is not None])
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    check(_build.lib().hs_gemm_nn_f32(a.data_ptr(), b.data_ptr(), _ptr(bias), out.data_ptr(),
                                      M, N, K, stream(a)), what)
    return out


def qkv_epi_proj_ln_bwd(o, wp, bp, ln_scale, dz, *, ln_eps=1e-5, impl="auto"):
    """K4's projection/LayerNorm backward alone (bf16: ``proj_ln_bwd_kernel`` and its
    ``reduce_rows``, ``csrc/window_attention_bwd.cu``; f32: the output product
    ``gemm_nn_f32``, ``ln_bwd_rows_f32_kernel`` and ``reduce_rows``,
    ``csrc/window_attention_bwd_f32.cu``); operands and results as
    ``qkv_epi_proj_ln_bwd_plain``: bf16 or f32 o and dz (T, C), T % 64 == 0, C a multiple
    of the head dim up to 384.  Without LayerNorm du is dz itself."""
    if not use_kernel(o, impl):
        return qkv_epi_proj_ln_bwd_plain(o, wp, bp, ln_scale, dz, ln_eps)
    what = "qkv_epi_proj_ln_bwd"
    T, C = o.shape
    _refuse("window_attention_qkv_epi", what, T, C, C // KERNEL_HD, KERNEL_WS, o.dtype)
    if tuple(wp.shape) != (C, C) or dz.dtype != o.dtype or tuple(dz.shape) != (T, C):
        raise ValueError(f"{what}: wp must be (C, C) and dz (T, C) {o.dtype}, C = {C}")
    dt = o.dtype
    o, dz = o.contiguous(), dz.contiguous()
    wp = wp.to(dt).contiguous()
    bp = torch.zeros(C, dtype=dt, device=o.device) if bp is None else bp.to(dt).contiguous()
    g = None if ln_scale is None else ln_scale.float().contiguous()
    _check_cuda_operands(what, [t for t in (o, wp, bp, g, dz) if t is not None])
    lib = _build.lib()
    sfx = f32_suffix(o)
    du = torch.empty_like(o) if g is not None else None
    red = torch.empty(3 * C, dtype=torch.float32, device=o.device)
    work = torch.empty(getattr(lib, f"hs_proj_ln_bwd{sfx}_workspace")(T, C), dtype=torch.uint8,
                       device=o.device)
    check(getattr(lib, f"hs_proj_ln_bwd{sfx}")(
        o.data_ptr(), wp.data_ptr(), bp.data_ptr(), _ptr(g), dz.data_ptr(), _ptr(du),
        red.data_ptr(), work.data_ptr(), T, C, int(g is not None), float(ln_eps), stream(o)),
        what + sfx)
    if g is None:
        return dz, red[:C], None, None
    return du, red[:C], red[C:2 * C], red[2 * C:]


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
    def forward(ctx, x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias, logit_scale, kw):
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
            (dx, dwq, dbq, dwp, dbp, dg, dbe, None, dbias, dls, None),
            saved + (None,))))


class _WindowAttentionQkv(torch.autograd.Function):
    """K16 forward, K17 backward (or their plain versions, by ``impl`` and device)."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, groups, bias, logit_scale, kw):
        ctx.kw = kw
        ctx.save_for_backward(x, wqkv, bqkv, groups, bias, logit_scale)
        return window_attention_qkv_fwd(x, wqkv, bqkv, groups, bias, logit_scale, **kw)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        dx, dwq, dbq, dbias, dls = window_attention_qkv_bwd(*saved, dout.to(saved[0].dtype),
                                                            **ctx.kw)
        return input_grads(ctx, list(zip((dx, dwq, dbq, None, dbias, dls, None),
                                          saved + (None,))))


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


def window_attention_qkv(x, wqkv, bqkv, groups, bias, logit_scale, *, ws, num_heads, use_cos,
                         sm_scale, has_mask=True, impl="auto"):
    """attn(x @ wqkv + bqkv), (T, C) -> (T, C) before the output projection, cosine or
    scaled-dot: K16 forward, K17 backward (counterpart of ``fused_window_attention_qkv``).
    Pass the weights already cast to x's dtype to get their gradients in that dtype, as
    the model does; bias and logit scale get f32 gradients."""
    kw = dict(ws=ws, num_heads=num_heads, use_cos=use_cos, sm_scale=sm_scale,
              has_mask=has_mask, impl=impl)
    return _WindowAttentionQkv.apply(x, wqkv, bqkv, groups, bias, logit_scale, kw)


def clamped_logit_scale(logit_scale: torch.Tensor) -> torch.Tensor:
    """exp(min(logit_scale, ln 100)) as (h,) float32."""
    return torch.exp(torch.clamp_max(logit_scale.float(), math.log(1.0 / 0.01))).reshape(-1)
