"""The SWIN block MLP (fc1 -> GELU -> fc2) and the SWIN-v2 MLP branch
(x + dscale * LN(mlp(x))): plain PyTorch versions and the CUDA kernels.

Counterpart of ``heal_swin_tpu/ops/mlp.py``.  Four kernels, each beside its plain
version:

- K12 ``mlp_fwd`` (Pallas ``_fwd_kernel``): (T, C) -> fc1 -> GELU -> fc2 -> (T, C).
- K13 ``mlp_bwd`` (``_bwd_kernel``): recomputes the hidden; dx, dW1, db1, dW2, db2.
  On the card a launch sequence from one entry: the dx kernel (``mlp_bwd_dx``), then
  the weight-gradient kernel with its reductions (``mlp_bwd_dw``), each beside its
  plain version (``mlp_bwd_dx_plain``, ``mlp_bwd_dw_plain``).
- K14 ``mlp_block_fwd`` (``_blk_fwd_kernel``): x + dscale * LN(fc2(GELU(fc1 x))),
  K12's kernel with a LayerNorm epilogue.
- K15 ``mlp_block_bwd`` (``_blk_bwd_kernel``): its backward, with the residual.  On the
  card a launch sequence from one entry: K12's kernel with the LayerNorm backward
  epilogue (``mlp_block_bwd_du``: du, rounded, and the db2, dgamma, dbeta sums), then
  K13's dx kernel on du with the residual (``mlp_bwd_dx(..., residual=dz)``) and K13's
  weight-gradient kernel on du, each beside its plain version (``mlp_block_du_plain``,
  ``mlp_bwd_dx_plain``, ``mlp_bwd_dw_plain``).

Each takes bfloat16 or float32 x.  For f32 x the same entries launch the f32 kernels
(``csrc/mlp_f32.cu``, launches counted as "mlp_fwd_f32" ... "mlp_block_bwd_f32"): launch
sequences of 3xTF32 tensor-core products with nothing rounded below f32 (K12 and K14 on
the mma.sync core, K13 and K15 on the wgmma core of ``csrc/gemm_3xtf32_wgmma.cuh``), whose
own steps have wrappers and plain twins of their own: K12's and K14's first step g =
GELU(x W1 + b1) (``mlp_hidden``, ``mlp_hidden_plain``), K13's dual product (g and dh =
(dout W2^T) GELU'(h), db1 and db2 from x and dout in one pass: ``mlp_dual``,
``mlp_dual_plain``, which takes dh from ``mlp_dh_plain``), the wgmma core's NN, NT and TN
products alone (``gemm_wg_f32``, ``gemm_wg_f32_plain``), K14's LayerNorm with the
DropPath scale and the residual (``mlp_block_ln``, ``mlp_block_ln_plain``) and K15's
LayerNorm backward (``mlp_block_ln_bwd``, ``mlp_block_ln_bwd_plain``).

Entry points, on the JAX layout (weights (in, out)) and with the JAX package's
semantics:

- ``fused_mlp(x (T, C), ..., fwd_impl)``: forward ``mlp_plain`` ("xla") or K12
  ("pallas"), backward K13.  ``fwd_impl`` mirrors the JAX entry point's switch, so
  that the parity tests can hold each forward to its Pallas counterpart; the model
  reaches K13 through ``fused_mlp_nd``.  The weights are cast to x's dtype and the
  biases to f32 before the autograd function, so the weight gradients round to x's
  dtype on the way back, as the JAX custom VJP returns them.
- ``fused_mlp_nd(x (..., C), ...)``: the forward is the plain dense route on the
  native shape (the ops of ``Mlp``'s plain path); the backward is K13 on the
  flattened view.  The weights enter as the parameters; the backward casts them to
  x's dtype (the biases to f32) and returns the kernel's f32 sums in the parameters'
  dtype.
- ``fused_mlp_block(x (T, C), ..., gamma, beta, dscale)``: K14 forward, K15 backward.
  ``dscale`` is a (T, 1) f32 DropPath scale or None; it gets a zero gradient.

``fused_mlp`` and ``fused_mlp_nd`` share one autograd function.  Where its backward
will launch K13, its forward checks first that K13 takes x, so a CUDA tensor the
kernel refuses (float16, say) raises at the call, not in the backward.

Rounding follows the Pallas kernels (for f32 x every rounding to x's dtype is the
identity): h = x W1 summed in f32, + b1 in f32; g = GELU(h)
in f32 (tanh or erf), rounded to x's dtype; o / u = g W2 summed in f32, + b2; the
branch's LayerNorm statistics in f32 on the unrounded u, y * dscale, + x in f32,
rounded once.  Backward: dh rounded before dx and dW1 while db1 sums the unrounded
dh; db2 sums dout in f32; in the branch du rounded before dW2 and the hidden's
gradient, and dx adds the residual dz in f32.

Dispatch (``impl``) as in ``ops/window_attention.py``: "auto" runs the kernel for a
CUDA tensor and the plain version for a CPU tensor, "xla" the plain version, "pallas"
demands the kernel.  A CUDA tensor the kernel does not take raises (the kernels take
bfloat16 or float32 x, and ``supported`` says which shapes); nothing falls back.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F

from heal_swin_torch import _build
from heal_swin_torch.ops._dispatch import (check, f32_suffix, input_grads, refuse, stream,
                                           use_kernel)

_SQRT_2_OVER_PI = 0.7978845608028654
_TANH_C = 0.044715
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327

KERNEL_ROWS = 64  # T must be a multiple of the weight-gradient kernel's token steps
KERNEL_HC = 32  # the kernels stream the hidden in chunks of 32 columns
KERNEL_MAX_C = 768  # registers: a row group's output columns over at most 4 warps

# launch counters, bumped only where a kernel launches: per kernel (the f32 kernels'
# with the suffix "_f32"), and per (kernel, T, C, H, approximate[, has_dscale])
launches = {k + sfx: 0 for sfx in ("", "_f32")
            for k in ("mlp_fwd", "mlp_bwd", "mlp_block_fwd", "mlp_block_bwd")}
launches_by_shape: Counter = Counter()


def _count(what, key):
    launches[what] += 1
    launches_by_shape[(what,) + key] += 1


def _gelu_f32(h, approximate: bool):
    if approximate:
        u = _SQRT_2_OVER_PI * (h + _TANH_C * h * h * h)
        return 0.5 * h * (1.0 + torch.tanh(u))
    return 0.5 * h * (1.0 + torch.erf(h * _INV_SQRT2))


def _gelu_grad_f32(h, approximate: bool):
    if approximate:
        u = _SQRT_2_OVER_PI * (h + _TANH_C * h * h * h)
        t = torch.tanh(u)
        du = _SQRT_2_OVER_PI * (1.0 + 3.0 * _TANH_C * h * h)
        return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * du
    cdf = 0.5 * (1.0 + torch.erf(h * _INV_SQRT2))
    pdf = _INV_SQRT_2PI * torch.exp(-0.5 * h * h)
    return cdf + h * pdf


def supported(T: int, C: int, H: int) -> bool:
    """True where K12/K13 take the shape: T a multiple of the row block, C a multiple
    of 32 up to 768 (of 64 above 384, where the row block halves), H a multiple of the
    hidden chunk.  Both GELUs and every C up to 768 are taken; the JAX gate's TPU
    cut-offs (C <= 96, tanh only) are measurements of that chip, not of this one."""
    if T <= 0 or T % KERNEL_ROWS or H <= 0 or H % KERNEL_HC:
        return False
    if C <= 0 or C % 32 or C > KERNEL_MAX_C:
        return False
    return C <= 384 or C % 64 == 0


block_supported = supported  # K14/K15 take the same shapes as K12/K13 (the JAX gate's name)


# --------------------------------------------------------------------- plain versions


def mlp_hidden_plain(x, w1, b1, *, approximate: bool):
    """h = x W1 + b1 (f32 sums of dt-rounded operands) and g = GELU(h) rounded to x's
    dtype dt, both as f32 (T, H).  For f32 x its g is the twin of the f32 K12's and K14's
    first step (``mlp_hidden``)."""
    dt = x.dtype
    h = x.float() @ w1.to(dt).float() + b1.float()
    return h, _gelu_f32(h, approximate).to(dt).float()


def mlp_plain(x, w1, b1, w2, b2, *, approximate: bool):
    """Plain version of K12 (``reference_mlp``).  x: (T, C); w1: (C, H); b1: (H,);
    w2: (H, C); b2: (C,).  Returns (T, C) in x's dtype."""
    dt = x.dtype
    _, g = mlp_hidden_plain(x, w1, b1, approximate=approximate)
    return (g @ w2.to(dt).float() + b2.float()).to(dt)


def mlp_dh_plain(h, w2, dout, *, approximate: bool):
    """dh = (dout W2^T) GELU'(h), f32 sums, unrounded (T, H): the GELU-gradient product
    of the plain backwards and of ``mlp_dual_plain``.  h (T, H), w2 (H, C), dout (T, C)."""
    return (dout.float() @ w2.float().t()) * _gelu_grad_f32(h.float(), approximate)


def mlp_dual_plain(x, w1, b1, w2, dout, *, approximate: bool):
    """The f32 K13's dual product in plain steps: g = GELU(h) and dh = (dout W2^T)
    GELU'(h) with h = x W1 + b1 (T, H), and db1 = the sum of dh, db2 = the sum of dout,
    all f32: the twin of ``mlp_dual``.  x, dout (T, C); w1 (C, H); w2 (H, C)."""
    h, g = mlp_hidden_plain(x, w1, b1, approximate=approximate)
    do = dout.float()
    dh = mlp_dh_plain(h, w2, do, approximate=approximate)
    return g, dh, dh.sum(0), do.sum(0)


GEMM_LAYOUTS = ("nn", "nt", "tn")


def gemm_wg_f32_plain(a, b, layout: str):
    """The wgmma core's product in f32 (TF32 off): "nn" a (M, K) @ b (K, N); "nt" a @ b^T,
    b (N, K); "tn" a^T @ b, a (K, M), b (K, N).  The twin of ``gemm_wg_f32``."""
    a, b = a.float(), b.float()
    if layout == "nn":
        return a @ b
    if layout == "nt":
        return a @ b.t()
    if layout == "tn":
        return a.t() @ b
    raise ValueError(f"unknown layout {layout!r}: expected one of {GEMM_LAYOUTS}")


def _hidden_grads(x, w1, b1, w2, dout, approximate):
    """g (dt-rounded, as f32), dout in f32 and the unrounded dh = (dout W2^T) GELU'(h)."""
    dt = x.dtype
    h, g = mlp_hidden_plain(x, w1, b1, approximate=approximate)
    do = dout.to(dt).float()
    return g, do, mlp_dh_plain(h, w2.to(dt), do, approximate=approximate)


def mlp_bwd_dx_plain(x, w1, b1, w2, dout, *, approximate: bool, residual=None):
    """Plain version of K13's dx kernel: dx = bf16(dh) W1^T, (T, C) in x's dtype.  With
    ``residual`` (K15's second step, the residual dz) it is added in f32 before the
    rounding: dx = residual + bf16(dh) W1^T."""
    dt = x.dtype
    _, _, dh = _hidden_grads(x, w1, b1, w2, dout, approximate)
    dx = dh.to(dt).float() @ w1.to(dt).float().t()
    if residual is not None:
        dx = residual.to(dt).float() + dx
    return dx.to(dt)


def mlp_bwd_dw_plain(x, w1, b1, w2, dout, *, approximate: bool):
    """Plain version of K13's weight-gradient kernel: dW1 = x^T bf16(dh) (C, H), db1 =
    the sum of the unrounded dh (H,), dW2 = g^T dout (H, C), db2 = the sum of dout (C,),
    all f32 sums."""
    g, do, dh = _hidden_grads(x, w1, b1, w2, dout, approximate)
    return x.float().t() @ dh.to(x.dtype).float(), dh.sum(0), g.t() @ do, do.sum(0)


def mlp_bwd_plain(x, w1, b1, w2, b2, dout, *, approximate: bool):
    """Plain version of K13 (what ``_bwd_kernel`` computes), its two steps composed.
    Returns dx (T, C) in x's dtype and dW1 (C, H), db1 (H,), dW2 (H, C), db2 (C,) as f32
    sums."""
    return (mlp_bwd_dx_plain(x, w1, b1, w2, dout, approximate=approximate),
            *mlp_bwd_dw_plain(x, w1, b1, w2, dout, approximate=approximate))


def _ln_stats(u, ln_eps):
    mean = u.mean(-1, keepdim=True)
    xc = u - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + ln_eps)
    return xc * rstd, rstd


def mlp_block_ln_plain(u, x, gamma, beta, dscale, *, ln_eps: float = 1e-5):
    """x + dscale * LN(u) in f32, the LayerNorm statistics in f32 on u (T, C): the twin
    of the f32 K14's last step (``mlp_block_ln``).  dscale: (T, 1) f32 or None."""
    xhat, _ = _ln_stats(u.float(), ln_eps)
    y = xhat * gamma.float() + beta.float()
    if dscale is not None:
        y = y * dscale.float()
    return x.float() + y


def mlp_block_plain(x, w1, b1, w2, b2, gamma, beta, dscale, *, approximate: bool,
                    ln_eps: float = 1e-5):
    """Plain version of K14 (``reference_mlp_block``): x + dscale * LN(mlp(x)), with
    LN in f32 on the unrounded u.  dscale: (T, 1) f32 or None.  (T, C) in x's dtype."""
    dt = x.dtype
    _, g = mlp_hidden_plain(x, w1, b1, approximate=approximate)
    return mlp_block_ln_plain(g @ w2.to(dt).float() + b2.float(), x, gamma, beta, dscale,
                              ln_eps=ln_eps).to(dt)


def mlp_block_ln_bwd_plain(u, dz, gamma, dscale, *, ln_eps: float = 1e-5):
    """The LayerNorm backward of the branch at u (T, C), f32: du (unrounded) and db2 =
    sum du, dgamma = sum dy xhat, dbeta = sum dy, dy = dz dscale.  The twin of the f32
    K15's LayerNorm step (``mlp_block_ln_bwd``)."""
    xhat, rstd = _ln_stats(u.float(), ln_eps)
    dzf = dz.float()
    dy = dzf * dscale.float() if dscale is not None else dzf
    dgl = dy * gamma.float()
    du = rstd * (dgl - dgl.mean(-1, keepdim=True)
                 - xhat * (dgl * xhat).mean(-1, keepdim=True))
    return du, du.sum(0), (dy * xhat).sum(0), dy.sum(0)


def mlp_block_du_plain(x, w1, b1, w2, b2, gamma, dscale, dz, *, approximate: bool,
                       ln_eps: float = 1e-5):
    """Plain version of K15's first step: the branch recomputed and the LayerNorm
    backward.  Returns du rounded to x's dtype (T, C) and db2 (the sum of the unrounded
    du), dgamma = sum dy xhat and dbeta = sum dy as f32 sums, dy = dz dscale."""
    dt = x.dtype
    _, g = mlp_hidden_plain(x, w1, b1, approximate=approximate)
    du, db2, dgamma, dbeta = mlp_block_ln_bwd_plain(g @ w2.to(dt).float() + b2.float(),
                                                    dz.to(dt), gamma, dscale, ln_eps=ln_eps)
    return du.to(dt), db2, dgamma, dbeta


def mlp_block_bwd_plain(x, w1, b1, w2, b2, gamma, beta, dscale, dz, *, approximate: bool,
                        ln_eps: float = 1e-5):
    """Plain version of K15 (``_blk_bwd_kernel``), its three steps composed: du
    (``mlp_block_du_plain``), then dx with the residual dz (``mlp_bwd_dx_plain``) and
    the weight gradients (``mlp_bwd_dw_plain``, its db2 replaced by the first step's)
    on the rounded du.  dz: (T, C), the output's gradient.  Returns dx (T, C) in x's
    dtype and dW1, db1, dW2, db2, dgamma, dbeta as f32 sums."""
    kw = dict(approximate=approximate)
    du_lo, db2, dgamma, dbeta = mlp_block_du_plain(x, w1, b1, w2, b2, gamma, dscale, dz,
                                                   ln_eps=ln_eps, **kw)
    dx = mlp_bwd_dx_plain(x, w1, b1, w2, du_lo, residual=dz, **kw)
    dw1, db1, dw2, _ = mlp_bwd_dw_plain(x, w1, b1, w2, du_lo, **kw)
    return dx, dw1, db1, dw2, db2, dgamma, dbeta


# --------------------------------------------------------------------------- kernels
_TAKES = (torch.bfloat16, torch.float32)


def _dtype_names(dtypes):
    return " or ".join(str(d).replace("torch.", "") for d in dtypes)


def _check_takes(what, x, H, dtypes=_TAKES):
    """Refuse (``_dispatch.refuse``) unless the kernels take x at hidden width H: (T, C)
    of one of ``dtypes`` (K12-K15: bfloat16 or float32; the bf16 sequences' own steps:
    bfloat16), with ``supported(T, C, H)``."""
    if x.dtype not in dtypes or x.dim() != 2:
        refuse(f"{what}: the kernel takes a (T, C) {_dtype_names(dtypes)} x, not "
               f"{tuple(x.shape)} {x.dtype}")
    T, C = x.shape
    if not supported(T, C, H):
        refuse(f"{what}: the kernel does not take T={T}, C={C}, H={H} (T a multiple of "
               f"{KERNEL_ROWS}, C a multiple of 32 up to {KERNEL_MAX_C} and of 64 above 384, "
               f"H a multiple of {KERNEL_HC})")


def _operands(what, x, w1, b1, w2, b2, extra=(), dtypes=_TAKES):
    """The kernels' checked operands: x and the weights in x's dtype (bf16 or f32; an
    f32 x keeps f32 weights), the biases (and the f32 ``extra`` vectors: gamma, beta) in
    f32, all contiguous on x's device."""
    H = w1.shape[1]
    _check_takes(what, x, H, dtypes)
    T, C = x.shape
    if tuple(w1.shape) != (C, H) or tuple(w2.shape) != (H, C) or b1.numel() != H \
            or b2.numel() != C or any(t.numel() != C for t in extra):
        raise ValueError(f"{what}: weights must be w1 (C, H), b1 (H,), w2 (H, C), b2 (C,)")
    dt = x.dtype
    ops = [x.contiguous(), w1.to(dt).contiguous(), b1.float().contiguous(),
           w2.to(dt).contiguous(), b2.float().contiguous()]
    ops += [t.float().contiguous() for t in extra]
    _on_card(what, ops, x)
    _check_aligned(what, ops[0], ops[1], ops[3])
    return T, C, H, ops


def _on_card(what, ops, x):
    """Raise unless every operand is a CUDA tensor on x's device."""
    if not all(t.is_cuda and t.device == x.device for t in ops):
        raise ValueError(f"{what}: every operand must be a CUDA tensor on x's device")


def _check_aligned(what, *tiles):
    """The kernels load rows 16 bytes at a time."""
    if any(t.data_ptr() % 16 for t in tiles):
        raise ValueError(f"{what}: x, the weights and the output gradient must be 16-byte "
                         f"aligned")


def _dscale_operand(what, dscale, T, x):
    if dscale is None:
        return None
    if dscale.dtype != torch.float32 or dscale.numel() != T:
        raise ValueError(f"{what}: dscale must be (T, 1) = {(T, 1)} float32")
    _on_card(what, [dscale], x)
    return dscale.contiguous()


def _grad_operand(what, g, T, C, dtype):
    """An output gradient (or residual) of x's shape (T, C) and dtype ``dtype``."""
    if g.dtype != dtype or tuple(g.shape) != (T, C):
        raise ValueError(f"{what}: the output gradient must be (T, C) = {(T, C)} "
                         f"{_dtype_names((dtype,))}")
    g = g.contiguous()
    _check_aligned(what, g)
    return g


def _ptrs(ts):
    return [None if t is None else t.data_ptr() for t in ts]


def _work(nbytes, x):
    return torch.empty(nbytes, dtype=torch.uint8, device=x.device)


def mlp_fwd(x, w1, b1, w2, b2, *, approximate: bool, impl="auto"):
    """K12 wrapper (no autograd): fc2(GELU(fc1 x)), (T, C) -> (T, C); bf16 x runs K12,
    f32 x the f32 K12 (its workspace: g, T x H f32)."""
    if not use_kernel(x, impl):
        return mlp_plain(x, w1, b1, w2, b2, approximate=approximate)
    what = "mlp_fwd"
    T, C, H, ops = _operands(what, x, w1, b1, w2, b2)
    sfx = f32_suffix(x)
    lib = _build.lib()
    out = torch.empty_like(ops[0])
    if sfx:
        work = _work(lib.hs_mlp_fwd_f32_workspace(T, C, H), x)
        code = lib.hs_mlp_fwd_f32(*_ptrs(ops + [out, work]), T, C, H, int(approximate),
                                  stream(x))
    else:
        code = lib.hs_mlp_fwd(*_ptrs(ops), out.data_ptr(), T, C, H, int(approximate),
                              stream(x))
    check(code, what + sfx)
    _count(what + sfx, (T, C, H, bool(approximate)))
    return out


def _dw_outputs(x, T, C, H, workspace):
    """K13's weight gradients and its workspace (``workspace(T, C, H)`` bytes: the bf16
    weight-gradient kernel's partial rows and the reductions' scratch, or the f32
    sequence's hidden and scratch): dw1 (C, H), dw2 (H, C), red = db1 | db2, work."""
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty((C, H), **f32), torch.empty((H, C), **f32), torch.empty(H + C, **f32),
            _work(workspace(T, C, H), x))


def _dw_f32(x, C, H):
    """The f32 K13's and K15's weight gradients in one buffer, as their TN pair's
    reduction writes them: dw = [dW2 (H, C) | dW1 (C, H)] and the two views."""
    dw = torch.empty(2 * C * H, dtype=torch.float32, device=x.device)
    return dw, dw[:C * H].view(H, C), dw[C * H:].view(C, H)


def mlp_bwd(x, w1, b1, w2, b2, dout, *, approximate: bool, impl="auto"):
    """K13 wrapper: the backward of K12, one entry that launches its sequence (bf16: the
    dx kernel, then the weight-gradient kernel and its reductions; f32: the 3xTF32
    products and reductions of ``csrc/mlp_f32.cu``); results as ``mlp_bwd_plain``."""
    if not use_kernel(x, impl):
        return mlp_bwd_plain(x, w1, b1, w2, b2, dout, approximate=approximate)
    what = "mlp_bwd"
    T, C, H, ops = _operands(what, x, w1, b1, w2, b2)
    sfx = f32_suffix(x)
    dout = _grad_operand(what, dout, T, C, x.dtype)
    lib = _build.lib()
    dx = torch.empty_like(ops[0])
    if sfx:
        dw, dw2, dw1 = _dw_f32(x, C, H)
        red = torch.empty(H + C, dtype=torch.float32, device=x.device)
        work = _work(lib.hs_mlp_bwd_f32_workspace(T, C, H), x)
        code = lib.hs_mlp_bwd_f32(*_ptrs(ops + [dout, dx, dw, red, work]), T, C, H,
                                  int(approximate), stream(x))
    else:
        dw1, dw2, red, work = _dw_outputs(x, T, C, H, lib.hs_mlp_bwd_workspace)
        code = lib.hs_mlp_bwd(*_ptrs(ops + [dout, dx, dw1, dw2, red, work]), T, C, H,
                              int(approximate), stream(x))
    check(code, what + sfx)
    _count(what + sfx, (T, C, H, bool(approximate)))
    db1, db2 = red.split([H, C])
    return dx, dw1, db1, dw2, db2


_BF16 = (torch.bfloat16,)


def mlp_bwd_dx(x, w1, b1, w2, dout, *, approximate: bool, residual=None, impl="auto"):
    """The bf16 K13's dx kernel alone (the first step of its launch sequence, and with
    ``residual`` the second of K15's; not counted, as K13's and K15's launches count
    their sequences); results as ``mlp_bwd_dx_plain``."""
    if not use_kernel(x, impl):
        return mlp_bwd_dx_plain(x, w1, b1, w2, dout, approximate=approximate,
                                residual=residual)
    what = "mlp_bwd_dx"
    T, C, H, ops = _operands(what, x, w1, b1, w2, torch.zeros(w2.shape[1], device=x.device),
                             dtypes=_BF16)
    dout = _grad_operand(what, dout, T, C, x.dtype)
    res = None if residual is None else _grad_operand(what, residual, T, C, x.dtype)
    dx = torch.empty_like(ops[0])
    check(_build.lib().hs_mlp_bwd_dx(*_ptrs(ops[:4] + [dout, res, dx]), T, C, H,
                                     int(approximate), stream(x)), what)
    return dx


def mlp_bwd_dw(x, w1, b1, w2, dout, *, approximate: bool, impl="auto"):
    """The bf16 K13's weight-gradient kernel and its reductions alone (the second step
    of its launch sequence; not counted); results as ``mlp_bwd_dw_plain``."""
    if not use_kernel(x, impl):
        return mlp_bwd_dw_plain(x, w1, b1, w2, dout, approximate=approximate)
    what = "mlp_bwd_dw"
    T, C, H, ops = _operands(what, x, w1, b1, w2, torch.zeros(w2.shape[1], device=x.device),
                             dtypes=_BF16)
    dout = _grad_operand(what, dout, T, C, x.dtype)
    dw1, dw2, red, work = _dw_outputs(x, T, C, H, _build.lib().hs_mlp_bwd_workspace)
    check(_build.lib().hs_mlp_bwd_dw(*_ptrs(ops[:4] + [dout, dw1, dw2, red, work]), T, C, H,
                                     int(approximate), stream(x)), what)
    db1, db2 = red.split([H, C])
    return dw1, db1, dw2, db2


def mlp_block_fwd(x, w1, b1, w2, b2, gamma, beta, dscale, *, approximate: bool,
                  ln_eps: float = 1e-5, impl="auto"):
    """K14 wrapper (no autograd): x + dscale * LN(mlp(x)), (T, C) -> (T, C); f32 x runs
    the f32 K14."""
    if not use_kernel(x, impl):
        return mlp_block_plain(x, w1, b1, w2, b2, gamma, beta, dscale,
                               approximate=approximate, ln_eps=ln_eps)
    what = "mlp_block_fwd"
    T, C, H, ops = _operands(what, x, w1, b1, w2, b2, (gamma, beta))
    ds = _dscale_operand(what, dscale, T, x)
    sfx = f32_suffix(x)
    lib = _build.lib()
    out = torch.empty_like(ops[0])
    if sfx:
        work = _work(lib.hs_mlp_fwd_f32_workspace(T, C, H), x)
        code = lib.hs_mlp_block_fwd_f32(*_ptrs(ops + [ds, out, work]), T, C, H,
                                        int(approximate), int(ds is not None), float(ln_eps),
                                        stream(x))
    else:
        code = lib.hs_mlp_block_fwd(*_ptrs(ops + [ds, out]), T, C, H, int(approximate),
                                    int(ds is not None), float(ln_eps), stream(x))
    check(code, what + sfx)
    _count(what + sfx, (T, C, H, bool(approximate), ds is not None))
    return out


def mlp_block_bwd_du(x, w1, b1, w2, b2, gamma, dscale, dz, *, approximate: bool,
                     ln_eps: float = 1e-5, impl="auto"):
    """The bf16 K15's first kernel alone, with the reduction of its partial rows (not
    counted, as K15's launches count the sequence); results as ``mlp_block_du_plain``:
    du_lo (T, C) and db2, dgamma, dbeta."""
    if not use_kernel(x, impl):
        return mlp_block_du_plain(x, w1, b1, w2, b2, gamma, dscale, dz,
                                  approximate=approximate, ln_eps=ln_eps)
    what = "mlp_block_bwd_du"
    T, C, H, ops = _operands(what, x, w1, b1, w2, b2, (gamma,), dtypes=_BF16)
    ds = _dscale_operand(what, dscale, T, x)
    dz = _grad_operand(what, dz, T, C, x.dtype)
    lib = _build.lib()
    du = torch.empty_like(ops[0])
    red = torch.empty(3 * C, dtype=torch.float32, device=x.device)  # db2 | dgamma | dbeta
    work = _work(lib.hs_mlp_block_bwd_workspace(T, C, H), x)
    check(lib.hs_mlp_block_bwd_du(*_ptrs(ops + [ds, dz, du, red, work]), T, C, H,
                                  int(approximate), int(ds is not None), float(ln_eps),
                                  stream(x)), what)
    return (du, *red.split([C, C, C]))


def mlp_block_bwd(x, w1, b1, w2, b2, gamma, beta, dscale, dz, *, approximate: bool,
                  ln_eps: float = 1e-5, impl="auto"):
    """K15 wrapper: the backward of K14, one entry that launches its sequence (bf16: the
    row kernel with the LayerNorm backward, K13's dx kernel with the residual, K13's
    weight-gradient kernel, the reductions; f32: ``csrc/mlp_f32.cu``'s); results as
    ``mlp_block_bwd_plain``."""
    if not use_kernel(x, impl):
        return mlp_block_bwd_plain(x, w1, b1, w2, b2, gamma, beta, dscale, dz,
                                   approximate=approximate, ln_eps=ln_eps)
    what = "mlp_block_bwd"
    T, C, H, ops = _operands(what, x, w1, b1, w2, b2, (gamma, beta))
    ds = _dscale_operand(what, dscale, T, x)
    sfx = f32_suffix(x)
    dz = _grad_operand(what, dz, T, C, x.dtype)
    lib = _build.lib()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(ops[0])
    red = torch.empty(H + 3 * C, **f32)  # db1 | db2 | dgamma | dbeta
    work = _work(getattr(lib, f"hs_mlp_block_bwd{sfx}_workspace")(T, C, H), x)
    if sfx:
        dw, dw2, dw1 = _dw_f32(x, C, H)
        grads = [dw]
    else:
        dw1, dw2 = torch.empty((C, H), **f32), torch.empty((H, C), **f32)
        grads = [dw1, dw2]
    code = getattr(lib, f"hs_mlp_block_bwd{sfx}")(
        *_ptrs(ops + [ds, dz, dx] + grads + [red, work]), T, C, H, int(approximate),
        int(ds is not None), float(ln_eps), stream(x))
    check(code, what + sfx)
    _count(what + sfx, (T, C, H, bool(approximate), ds is not None))
    db1, db2, dg, dbe = red.split([H, C, C, C])
    return dx, dw1, db1, dw2, db2, dg, dbe


# ------------------------------------------- the f32 sequences' own steps (not counted)
_F32 = (torch.float32,)


def _f32_rows(what, t, T, C):
    """An f32 (T, C) operand of a step, contiguous, on the card and 16-byte aligned."""
    if t.dtype != torch.float32 or tuple(t.shape) != (T, C) or not t.is_cuda:
        raise ValueError(f"{what}: expected a (T, C) = {(T, C)} float32 CUDA tensor, not "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    t = t.contiguous()
    _check_aligned(what, t)
    return t


def mlp_hidden(x, w1, b1, *, approximate: bool, impl="auto"):
    """The f32 K12's and K14's first step alone: g = GELU(x W1 + b1), (T, H) f32; the
    result as the g of ``mlp_hidden_plain``."""
    if not use_kernel(x, impl):
        return mlp_hidden_plain(x, w1, b1, approximate=approximate)[1]
    what = "mlp_hidden"
    H = w1.shape[1]
    _check_takes(what, x, H, _F32)
    T, C = x.shape
    x, w1 = _f32_rows(what, x, T, C), _f32_rows(what, w1, C, H)
    b1 = b1.float().contiguous()
    _on_card(what, [b1], x)
    g = torch.empty((T, H), dtype=torch.float32, device=x.device)
    check(_build.lib().hs_mlp_hidden_f32(*_ptrs([x, w1, b1, g]), T, C, H, int(approximate),
                                         stream(x)), what)
    return g


def mlp_dual(x, w1, b1, w2, dout, *, approximate: bool, impl="auto"):
    """The f32 K13's dual product alone, with the reduction of its partial rows: g, dh
    (T, H) f32 and db1 (H,), db2 (C,); results as ``mlp_dual_plain``."""
    if not use_kernel(x, impl):
        return mlp_dual_plain(x, w1, b1, w2, dout, approximate=approximate)
    what = "mlp_dual"
    H = w1.shape[1]
    _check_takes(what, x, H, _F32)
    T, C = x.shape
    x, w1, w2 = _f32_rows(what, x, T, C), _f32_rows(what, w1, C, H), _f32_rows(what, w2, H, C)
    dout = _f32_rows(what, dout, T, C)
    b1 = b1.float().contiguous()
    _on_card(what, [b1], x)
    lib = _build.lib()
    g, dh = (torch.empty((T, H), dtype=torch.float32, device=x.device) for _ in range(2))
    red = torch.empty(H + C, dtype=torch.float32, device=x.device)
    work = _work(lib.hs_mlp_dual_f32_workspace(T, C, H), x)
    check(lib.hs_mlp_dual_f32(*_ptrs([x, w1, b1, w2, dout, g, dh, red, work]), T, C, H,
                              int(approximate), stream(x)), what)
    db1, db2 = red.split([H, C])
    return g, dh, db1, db2


def gemm_wg_f32(a, b, layout: str, *, impl="auto"):
    """The wgmma core's product alone (``gemm_wg_f32_plain``'s layouts), f32 3xTF32: M, N
    multiples of 4, K of 32; 16-byte aligned rows.  Results as ``gemm_wg_f32_plain``."""
    if not use_kernel(a, impl):
        return gemm_wg_f32_plain(a, b, layout)
    what = "gemm_wg_f32"
    if layout not in GEMM_LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}: expected one of {GEMM_LAYOUTS}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"{what}: two matrices, not {tuple(a.shape)} and {tuple(b.shape)}")
    (M, K), (K2, N) = (a.shape[::-1] if layout == "tn" else a.shape,
                       b.shape[::-1] if layout == "nt" else b.shape)
    if K != K2 or M % 4 or N % 4 or K % 32:
        raise ValueError(f"{what}: {layout} takes M, N multiples of 4 and K of 32 that "
                         f"agree, not {tuple(a.shape)} and {tuple(b.shape)}")
    a, b = _f32_rows(what, a, *a.shape), _f32_rows(what, b, *b.shape)
    _on_card(what, [b], a)
    lib = _build.lib()
    code = GEMM_LAYOUTS.index(layout)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    work = _work(lib.hs_gemm_wg_f32_workspace(M, N, K, code), a)
    check(lib.hs_gemm_wg_f32(*_ptrs([a, b, out, work]), M, N, K, code, stream(a)), what)
    return out


def mlp_block_ln(u, x, gamma, beta, dscale, *, ln_eps: float = 1e-5, impl="auto"):
    """The f32 K14's LayerNorm step alone: x + dscale * LN(u), (T, C) f32; results as
    ``mlp_block_ln_plain``."""
    if not use_kernel(x, impl):
        return mlp_block_ln_plain(u, x, gamma, beta, dscale, ln_eps=ln_eps)
    what = "mlp_block_ln"
    _check_takes(what, x, KERNEL_HC, _F32)
    T, C = x.shape
    u, x = _f32_rows(what, u, T, C), _f32_rows(what, x, T, C)
    gamma, beta = gamma.float().contiguous(), beta.float().contiguous()
    _on_card(what, [gamma, beta], x)
    ds = _dscale_operand(what, dscale, T, x)
    out = torch.empty_like(x)
    check(_build.lib().hs_mlp_block_ln_f32(*_ptrs([u, x, gamma, beta, ds, out]), T, C,
                                           float(ln_eps), stream(x)), what)
    return out


def mlp_block_ln_bwd(u, dz, gamma, dscale, *, ln_eps: float = 1e-5, impl="auto"):
    """The f32 K15's LayerNorm backward step alone, with the reduction of its partial
    rows: du (T, C) f32, db2, dgamma, dbeta; results as ``mlp_block_ln_bwd_plain``."""
    if not use_kernel(dz, impl):
        return mlp_block_ln_bwd_plain(u, dz, gamma, dscale, ln_eps=ln_eps)
    what = "mlp_block_ln_bwd"
    _check_takes(what, dz, KERNEL_HC, _F32)
    T, C = dz.shape
    u, dz = _f32_rows(what, u, T, C), _f32_rows(what, dz, T, C)
    gamma = gamma.float().contiguous()
    _on_card(what, [gamma], dz)
    ds = _dscale_operand(what, dscale, T, dz)
    lib = _build.lib()
    du = torch.empty_like(u)
    red = torch.empty(3 * C, dtype=torch.float32, device=dz.device)
    work = _work(lib.hs_mlp_block_ln_bwd_f32_workspace(T, C), dz)
    check(lib.hs_mlp_block_ln_bwd_f32(*_ptrs([u, dz, gamma, ds, du, red, work]), T, C,
                                      float(ln_eps), stream(dz)), what)
    return (du, *red.split([C, C, C]))


# --------------------------------------------------------------------------- autograd


class _Mlp(torch.autograd.Function):
    """fc1 -> GELU -> fc2 on x (..., C).  Forward ``kw["fwd"]``: "dense", the plain
    dense route on the native shape; "xla", ``mlp_plain``; "pallas", K12.  Backward:
    K13 on the flattened view, with the weights cast to x's dtype and the biases to
    f32, each gradient returned in its operand's dtype."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, kw):
        ctx.kw = kw
        ctx.save_for_backward(x, w1, b1, w2, b2)
        dt, C = x.dtype, x.shape[-1]
        x2 = x.reshape(-1, C)
        if use_kernel(x, kw["impl"]):  # the backward launches K13: refuse x now
            _check_takes("mlp_bwd", x2, w1.shape[1])
        if kw["fwd"] == "dense":
            h = F.linear(x, w1.t().to(dt), b1.to(dt))
            g = F.gelu(h, approximate="tanh" if kw["approximate"] else "none")
            return F.linear(g, w2.t().to(dt), b2.to(dt))
        if kw["fwd"] == "xla":
            out = mlp_plain(x2, w1, b1, w2, b2, approximate=kw["approximate"])
        else:
            out = mlp_fwd(x2, w1, b1, w2, b2, approximate=kw["approximate"], impl=kw["impl"])
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        x, w1, b1, w2, b2 = saved
        dt, C = x.dtype, x.shape[-1]
        dx, *dparams = mlp_bwd(x.reshape(-1, C), w1.to(dt), b1.float(), w2.to(dt), b2.float(),
                               dout.reshape(-1, C).to(dt), approximate=ctx.kw["approximate"],
                               impl=ctx.kw["impl"])
        return input_grads(ctx, list(zip([dx.reshape(x.shape)] + dparams + [None],
                                    saved + (None,))))


class _MlpBlock(torch.autograd.Function):
    """K14 forward, K15 backward; ``dscale`` gets a zero gradient."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, gamma, beta, dscale, kw):
        ctx.kw = kw
        ctx.save_for_backward(x, w1, b1, w2, b2, gamma, beta, dscale)
        return mlp_block_fwd(x, w1, b1, w2, b2, gamma, beta, dscale, **kw)

    @staticmethod
    def backward(ctx, dz):
        saved = ctx.saved_tensors
        x, dscale = saved[0], saved[7]
        grads = mlp_block_bwd(*saved, dz.to(x.dtype), **ctx.kw)
        dds = None if dscale is None else torch.zeros_like(dscale)
        return input_grads(ctx, list(zip(grads + (dds, None), saved + (None,))))


def fused_mlp(x, w1, b1, w2, b2, *, approximate: bool, fwd_impl: str = "xla", impl="auto"):
    """Fused fc1 -> GELU -> fc2.  x: (T, C); w1: (C, H); b1: (H,); w2: (H, C); b2: (C,).
    Returns (T, C) in x's dtype.  ``fwd_impl`` "xla": ``mlp_plain`` forward, K13
    backward (the JAX package's production split); "pallas": K12 forward, K13
    backward.  The switch mirrors the JAX entry point for the parity tests."""
    if fwd_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown fwd_impl {fwd_impl!r}: expected 'xla' or 'pallas'")
    kw = dict(approximate=bool(approximate), fwd=fwd_impl, impl=impl)
    return _Mlp.apply(x, w1.to(x.dtype), b1.float(), w2.to(x.dtype), b2.float(), kw)


def fused_mlp_nd(x, w1, b1, w2, b2, *, approximate: bool, impl="auto"):
    """In-model entry point: x (..., C), the parameters w1 (C, H), b1, w2 (H, C), b2 as
    they are; forward the plain dense route on the native shape, backward K13 on the
    flattened view."""
    return _Mlp.apply(x, w1, b1, w2, b2,
                      dict(approximate=bool(approximate), fwd="dense", impl=impl))


def fused_mlp_block(x, w1, b1, w2, b2, gamma, beta, dscale=None, *, approximate: bool,
                    ln_eps: float = 1e-5, impl="auto"):
    """z = x + dscale * LN(mlp(x)) fused.  x: (T, C); dscale: (T, 1) f32 or None (no
    DropPath scaling).  Returns (T, C) in x's dtype: K14 forward, K15 backward."""
    kw = dict(approximate=bool(approximate), ln_eps=float(ln_eps), impl=impl)
    return _MlpBlock.apply(x, w1.to(x.dtype), b1.float(), w2.to(x.dtype), b2.float(), gamma,
                           beta, dscale, kw)
