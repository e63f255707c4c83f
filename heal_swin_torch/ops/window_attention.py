"""Window multi-head self-attention: plain PyTorch versions and the CUDA kernels.

Counterpart of ``heal_swin_tpu/ops/window_attention.py``.  Two entry points, each a
kernel wrapper beside its plain version, on the JAX kernels' operand layout:

- ``window_attention`` (K2): attention from precomputed qkv rows (T, 3C) -> (T, C),
  cosine or scaled-dot (Pallas ``fused_window_attention``).
- ``window_attention_qkv_epi`` (K1): x @ Wqkv + b -> cosine attention -> @ Wp + bp ->
  optional LayerNorm, (T, C) -> (T, C) (Pallas ``fused_window_attention_qkv_epi``).

Operands: ``groups`` (T/ws, ws) int32 mask group ids (attention between tokens of
different groups gets an additive -100); ``bias`` (h, ws, ws) f32 relative-position
bias or None; ``logit_scale`` (h,) f32, already exp(min(., ln 100)).  Weights are in
the JAX layout (in, out).

Rounding follows the Pallas kernels, so that kernel and plain version agree closely
in bf16: qkv -> dtype; q_hat = q * scale / |q| and k_hat = k / |k| -> dtype; softmax
in f32, p -> dtype; o -> dtype; the projection and LayerNorm in f32, output -> dtype.

Dispatch (``impl``): "auto" runs the kernel for a CUDA tensor and the plain version
for a CPU tensor; "xla" runs the plain version on any device (the JAX package's name
for its non-kernel path); "pallas" demands the kernel and raises on a CPU tensor.  A
CUDA tensor the kernel does not take raises; nothing falls back.  The kernels are
forward only: a call that would need a gradient raises.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Optional

import torch

from heal_swin_torch import _build
from heal_swin_torch.ops._dispatch import check, stream, use_kernel

MASK_VALUE = -100.0
KERNEL_WS = 64  # the kernels' window size
KERNEL_HD = 32  # the kernels' head dim
KERNEL_MAX_C = 384  # K1's shared-memory bound (x and o tiles of 64 x C bf16)

# launch counters, bumped only where a kernel launches: per kernel, and per
# (kernel, T, C, has_mask)
launches = {"window_attention": 0, "window_attention_qkv_epi": 0}
launches_by_shape: Counter = Counter()


def _count(what, T, C, has_mask):
    launches[what] += 1
    launches_by_shape[(what, T, C, bool(has_mask))] += 1


def _mask(groups: torch.Tensor) -> torch.Tensor:
    """(nw, ws) group ids -> (nw, 1, ws, ws) additive f32 mask."""
    diff = groups[:, :, None] != groups[:, None, :]
    return (diff.to(torch.float32) * MASK_VALUE)[:, None]


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
        s = torch.einsum("wihd,wjhd->whij", q, k)
    else:
        s = torch.einsum("wihd,wjhd->whij", q, k) * sm_scale
    if bias is not None:
        s = s + bias.float()[None]
    if has_mask:
        s = s + _mask(groups)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / torch.clamp_min(e.sum(-1, keepdim=True), 1e-30)).to(dt).float()
    o = torch.einsum("whij,wjhd->wihd", p, v)
    return o.reshape(T, C).to(dt)


def _ln_f32(u, gamma, beta, eps):
    mean = u.mean(-1, keepdim=True)
    xc = u - mean
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * gamma.float() + beta.float()


def window_attention_qkv_epi_plain(x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias,
                                   logit_scale, *, ws, num_heads, sm_scale, has_mask=True,
                                   ln_eps=1e-5):
    """Plain version of K1 (cosine attention only, like the Pallas kernel).
    x: (T, C); wqkv: (C, 3C); wp: (C, C) -> (T, C) in x's dtype."""
    dt = x.dtype
    qkv = x.float() @ wqkv.to(dt).float()
    if bqkv is not None:
        qkv = qkv + bqkv.to(dt).float()
    o = window_attention_plain(qkv.to(dt), groups, bias, logit_scale, ws=ws,
                               num_heads=num_heads, use_cos=True, sm_scale=sm_scale,
                               has_mask=has_mask)
    u = o.float() @ wp.to(dt).float()
    if bp is not None:
        u = u + bp.to(dt).float()
    if ln_scale is not None:
        u = _ln_f32(u, ln_scale, ln_bias, ln_eps)
    return u.to(dt)


def _check_cuda_operands(what, tensors, T, ws):
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{what}: every operand must be a CUDA tensor")
    dev = tensors[0].device
    if not all(t.device == dev for t in tensors):
        raise ValueError(f"{what}: operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: operands must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{what}: the kernel is forward only (no backward yet); call it "
                         "under torch.no_grad()")
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


def window_attention(qkv, groups, bias, logit_scale, *, ws, num_heads, use_cos, sm_scale,
                     has_mask=True, impl="auto"):
    """K2 wrapper: attention from qkv rows (T, 3C) -> (T, C)."""
    if not use_kernel(qkv, impl):
        return window_attention_plain(qkv, groups, bias, logit_scale, ws=ws,
                                      num_heads=num_heads, use_cos=use_cos,
                                      sm_scale=sm_scale, has_mask=has_mask)
    what = "window_attention"
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
    ops = [t for t in (qkv, groups_t, bias_t, ls) if t is not None]
    _check_cuda_operands(what, ops, T, ws)
    out = torch.empty((T, C), dtype=qkv.dtype, device=qkv.device)
    code = _build.lib().hs_window_attention(
        qkv.data_ptr(), _ptr(groups_t), bias_t.data_ptr(), _ptr(ls), out.data_ptr(), T, C,
        int(use_cos), int(has_mask), float(sm_scale), stream(qkv))
    check(code, what)
    _count(what, T, C, has_mask)
    return out


def window_attention_qkv_epi(x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias,
                             logit_scale, *, ws, num_heads, sm_scale, has_mask=True,
                             ln_eps=1e-5, impl="auto"):
    """K1 wrapper: [LN](cos_attn(x @ wqkv + bqkv) @ wp + bp), (T, C) -> (T, C)."""
    if not use_kernel(x, impl):
        return window_attention_qkv_epi_plain(
            x, wqkv, bqkv, wp, bp, ln_scale, ln_bias, groups, bias, logit_scale, ws=ws,
            num_heads=num_heads, sm_scale=sm_scale, has_mask=has_mask, ln_eps=ln_eps)
    what = "window_attention_qkv_epi"
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
    wq = wqkv.to(dt).contiguous()
    wpp = wp.to(dt).contiguous()
    bq = (torch.zeros(3 * C, dtype=dt, device=x.device) if bqkv is None
          else bqkv.to(dt).contiguous())
    bpp = torch.zeros(C, dtype=dt, device=x.device) if bp is None else bp.to(dt).contiguous()
    has_ln = ln_scale is not None
    if has_ln:
        g = ln_scale.float().contiguous()
        b = ln_bias.float().contiguous()
    else:
        g = b = None
    bias_t = _bias_operand(bias, h, ws, x)
    groups_t = _groups_operand(groups, has_mask, T, ws)
    ls = logit_scale.contiguous()
    ops = [t for t in (x, wq, bq, wpp, bpp, g, b, groups_t, bias_t, ls) if t is not None]
    _check_cuda_operands(what, ops, T, ws)
    out = torch.empty((T, C), dtype=dt, device=x.device)
    code = _build.lib().hs_window_attention_qkv_epi(
        x.data_ptr(), wq.data_ptr(), bq.data_ptr(), wpp.data_ptr(), bpp.data_ptr(), _ptr(g),
        _ptr(b), _ptr(groups_t), bias_t.data_ptr(), ls.data_ptr(), out.data_ptr(), T, C,
        int(has_ln), int(has_mask), float(ln_eps), stream(x))
    check(code, what)
    _count(what, T, C, has_mask)
    return out


def clamped_logit_scale(logit_scale: torch.Tensor) -> torch.Tensor:
    """exp(min(logit_scale, ln 100)) as (h,) float32."""
    return torch.exp(torch.clamp_max(logit_scale.float(), math.log(1.0 / 0.01))).reshape(-1)

