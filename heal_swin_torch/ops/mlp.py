"""The SWIN block MLP (fc1 -> GELU -> fc2) and the SWIN-v2 MLP branch
(x + dscale * LN(mlp(x))): plain PyTorch versions and the CUDA kernels.

Counterpart of ``heal_swin_tpu/ops/mlp.py``.  Four kernels, each beside its plain
version:

- K12 ``mlp_fwd`` (Pallas ``_fwd_kernel``): (T, C) -> fc1 -> GELU -> fc2 -> (T, C).
- K13 ``mlp_bwd`` (``_bwd_kernel``): recomputes the hidden; dx, dW1, db1, dW2, db2.
  On the card a launch sequence from one entry: the dx kernel (``mlp_bwd_dx``), then
  the weight-gradient kernel with its reductions (``mlp_bwd_dw``), each beside its
  plain version (``mlp_bwd_dx_plain``, ``mlp_bwd_dw_plain``).
- K14 ``mlp_block_fwd`` (``_blk_fwd_kernel``): x + dscale * LN(fc2(GELU(fc1 x))).
- K15 ``mlp_block_bwd`` (``_blk_bwd_kernel``): its backward, with the residual.

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
kernel refuses (float32, say) raises at the call, not in the backward.

Rounding follows the Pallas kernels: h = x W1 summed in f32, + b1 in f32; g = GELU(h)
in f32 (tanh or erf), rounded to x's dtype; o / u = g W2 summed in f32, + b2; the
branch's LayerNorm statistics in f32 on the unrounded u, y * dscale, + x in f32,
rounded once.  Backward: dh rounded before dx and dW1 while db1 sums the unrounded
dh; db2 sums dout in f32; in the branch du rounded before dW2 and the hidden's
gradient, and dx adds the residual dz in f32.

Dispatch (``impl``) as in ``ops/window_attention.py``: "auto" runs the kernel for a
CUDA tensor and the plain version for a CPU tensor, "xla" the plain version, "pallas"
demands the kernel.  A CUDA tensor the kernel does not take raises (the kernels take
bfloat16 x, and ``supported`` says which shapes); nothing falls back.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F

from heal_swin_torch import _build
from heal_swin_torch.ops._dispatch import check, input_grads, stream, use_kernel

_SQRT_2_OVER_PI = 0.7978845608028654
_TANH_C = 0.044715
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327

KERNEL_ROWS = 64  # T must be a multiple of K14/K15's row block (64; 32 above C 384)
KERNEL_HC = 32  # the kernels stream the hidden in chunks of 32 columns
KERNEL_MAX_C = 768  # shared memory: x (and dout / du) tiles of the row block + one chunk

# launch counters, bumped only where a kernel launches: per kernel, and per
# (kernel, T, C, H, approximate[, has_dscale])
launches = {"mlp_fwd": 0, "mlp_bwd": 0, "mlp_block_fwd": 0, "mlp_block_bwd": 0}
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


def _hidden(x, w1, b1, approximate):
    """h = x W1 + b1 (f32 sums of dt-rounded operands) and g = GELU(h) rounded to dt,
    both as f32."""
    dt = x.dtype
    h = x.float() @ w1.to(dt).float() + b1.float()
    return h, _gelu_f32(h, approximate).to(dt).float()


def mlp_plain(x, w1, b1, w2, b2, *, approximate: bool):
    """Plain version of K12 (``reference_mlp``).  x: (T, C); w1: (C, H); b1: (H,);
    w2: (H, C); b2: (C,).  Returns (T, C) in x's dtype."""
    dt = x.dtype
    _, g = _hidden(x, w1, b1, approximate)
    return (g @ w2.to(dt).float() + b2.float()).to(dt)


def _hidden_grads(x, w1, b1, w2, dout, approximate):
    """g (dt-rounded, as f32), dout in f32 and the unrounded dh = (dout W2^T) GELU'(h)."""
    dt = x.dtype
    h, g = _hidden(x, w1, b1, approximate)
    do = dout.to(dt).float()
    return g, do, (do @ w2.to(dt).float().t()) * _gelu_grad_f32(h, approximate)


def mlp_bwd_dx_plain(x, w1, b1, w2, dout, *, approximate: bool):
    """Plain version of K13's dx kernel: dx = bf16(dh) W1^T, (T, C) in x's dtype."""
    dt = x.dtype
    _, _, dh = _hidden_grads(x, w1, b1, w2, dout, approximate)
    return (dh.to(dt).float() @ w1.to(dt).float().t()).to(dt)


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


def mlp_block_plain(x, w1, b1, w2, b2, gamma, beta, dscale, *, approximate: bool,
                    ln_eps: float = 1e-5):
    """Plain version of K14 (``reference_mlp_block``): x + dscale * LN(mlp(x)), with
    LN in f32 on the unrounded u.  dscale: (T, 1) f32 or None.  (T, C) in x's dtype."""
    dt = x.dtype
    _, g = _hidden(x, w1, b1, approximate)
    xhat, _ = _ln_stats(g @ w2.to(dt).float() + b2.float(), ln_eps)
    y = xhat * gamma.float() + beta.float()
    if dscale is not None:
        y = y * dscale.float()
    return (x.float() + y).to(dt)


def mlp_block_bwd_plain(x, w1, b1, w2, b2, gamma, beta, dscale, dz, *, approximate: bool,
                        ln_eps: float = 1e-5):
    """Plain version of K15 (``_blk_bwd_kernel``).  dz: (T, C), the output's gradient.
    Returns dx (T, C) in x's dtype (the residual included) and dW1, db1, dW2, db2,
    dgamma, dbeta as f32 sums."""
    dt = x.dtype
    w1f, w2f = w1.to(dt).float(), w2.to(dt).float()
    h, g = _hidden(x, w1, b1, approximate)
    xhat, rstd = _ln_stats(g @ w2f + b2.float(), ln_eps)
    dzf = dz.to(dt).float()
    dy = dzf * dscale.float() if dscale is not None else dzf
    dgl = dy * gamma.float()
    du = rstd * (dgl - dgl.mean(-1, keepdim=True)
                 - xhat * (dgl * xhat).mean(-1, keepdim=True))
    du_lo = du.to(dt).float()
    dh = (du_lo @ w2f.t()) * _gelu_grad_f32(h, approximate)
    dh_lo = dh.to(dt).float()
    dx = (dzf + dh_lo @ w1f.t()).to(dt)
    return (dx, x.float().t() @ dh_lo, dh.sum(0), g.t() @ du_lo, du.sum(0),
            (dy * xhat).sum(0), dy.sum(0))


# --------------------------------------------------------------------------- kernels


def _check_takes(what, x, H):
    """Raise unless the kernels take x at hidden width H: (T, C) bfloat16, with
    ``supported(T, C, H)``."""
    if x.dtype != torch.bfloat16 or x.dim() != 2:
        raise ValueError(f"{what}: the kernel takes a (T, C) bfloat16 x, not "
                         f"{tuple(x.shape)} {x.dtype}")
    T, C = x.shape
    if not supported(T, C, H):
        raise ValueError(f"{what}: the kernel does not take T={T}, C={C}, H={H} (T a "
                         f"multiple of {KERNEL_ROWS}, C a multiple of 32 up to "
                         f"{KERNEL_MAX_C} and of 64 above 384, H a multiple of "
                         f"{KERNEL_HC})")


def _operands(what, x, w1, b1, w2, b2, extra=()):
    """The kernels' checked operands: x and the weights in bf16, the biases (and the
    f32 ``extra`` vectors: gamma, beta) in f32, all contiguous on x's device."""
    H = w1.shape[1]
    _check_takes(what, x, H)
    T, C = x.shape
    if tuple(w1.shape) != (C, H) or tuple(w2.shape) != (H, C) or b1.numel() != H \
            or b2.numel() != C or any(t.numel() != C for t in extra):
        raise ValueError(f"{what}: weights must be w1 (C, H), b1 (H,), w2 (H, C), b2 (C,)")
    bf = torch.bfloat16
    ops = [x.contiguous(), w1.to(bf).contiguous(), b1.float().contiguous(),
           w2.to(bf).contiguous(), b2.float().contiguous()]
    ops += [t.float().contiguous() for t in extra]
    if not all(t.is_cuda and t.device == x.device for t in ops):
        raise ValueError(f"{what}: every operand must be a CUDA tensor on x's device")
    _check_aligned(what, ops[0], ops[1], ops[3])
    return T, C, H, ops


def _check_aligned(what, *tiles):
    """The kernels load bf16 rows 16 bytes at a time."""
    if any(t.data_ptr() % 16 for t in tiles):
        raise ValueError(f"{what}: x, the weights and the output gradient must be 16-byte "
                         f"aligned")


def _dscale_operand(what, dscale, T, x):
    if dscale is None:
        return None
    if dscale.dtype != torch.float32 or dscale.numel() != T:
        raise ValueError(f"{what}: dscale must be (T, 1) = {(T, 1)} float32")
    if not dscale.is_cuda or dscale.device != x.device:
        raise ValueError(f"{what}: dscale must be a CUDA tensor on x's device")
    return dscale.contiguous()


def _grad_operand(what, g, T, C):
    if g.dtype != torch.bfloat16 or tuple(g.shape) != (T, C):
        raise ValueError(f"{what}: the output gradient must be (T, C) = {(T, C)} bfloat16")
    g = g.contiguous()
    _check_aligned(what, g)
    return g


def _ptrs(ts):
    return [None if t is None else t.data_ptr() for t in ts]


def mlp_fwd(x, w1, b1, w2, b2, *, approximate: bool, impl="auto"):
    """K12 wrapper (no autograd): fc2(GELU(fc1 x)), (T, C) -> (T, C)."""
    if not use_kernel(x, impl):
        return mlp_plain(x, w1, b1, w2, b2, approximate=approximate)
    what = "mlp_fwd"
    T, C, H, ops = _operands(what, x, w1, b1, w2, b2)
    out = torch.empty_like(ops[0])
    code = _build.lib().hs_mlp_fwd(*_ptrs(ops), out.data_ptr(), T, C, H, int(approximate),
                                   stream(x))
    check(code, what)
    _count(what, (T, C, H, bool(approximate)))
    return out


def _dw_outputs(x, T, C, H):
    """K13's weight gradients and its workspace (the weight-gradient kernel's partial
    rows and the reductions' scratch): dw1 (C, H), dw2 (H, C), red = db1 | db2, work."""
    f32 = dict(dtype=torch.float32, device=x.device)
    work = torch.empty(_build.lib().hs_mlp_bwd_workspace(T, C, H), dtype=torch.uint8,
                       device=x.device)
    return (torch.empty((C, H), **f32), torch.empty((H, C), **f32), torch.empty(H + C, **f32),
            work)


def mlp_bwd(x, w1, b1, w2, b2, dout, *, approximate: bool, impl="auto"):
    """K13 wrapper: the backward of K12, one entry that launches the dx kernel, then the
    weight-gradient kernel and its reductions; results as ``mlp_bwd_plain``."""
    if not use_kernel(x, impl):
        return mlp_bwd_plain(x, w1, b1, w2, b2, dout, approximate=approximate)
    what = "mlp_bwd"
    T, C, H, ops = _operands(what, x, w1, b1, w2, b2)
    dout = _grad_operand(what, dout, T, C)
    dx = torch.empty_like(ops[0])
    dw1, dw2, red, work = _dw_outputs(x, T, C, H)
    code = _build.lib().hs_mlp_bwd(*_ptrs(ops + [dout, dx, dw1, dw2, red, work]), T, C, H,
                                   int(approximate), stream(x))
    check(code, what)
    _count(what, (T, C, H, bool(approximate)))
    db1, db2 = red.split([H, C])
    return dx, dw1, db1, dw2, db2


def mlp_bwd_dx(x, w1, b1, w2, dout, *, approximate: bool, impl="auto"):
    """K13's dx kernel alone (the first step of its launch sequence; not counted, as
    K13's launches count the sequence); results as ``mlp_bwd_dx_plain``."""
    if not use_kernel(x, impl):
        return mlp_bwd_dx_plain(x, w1, b1, w2, dout, approximate=approximate)
    what = "mlp_bwd_dx"
    T, C, H, ops = _operands(what, x, w1, b1, w2, torch.zeros(w2.shape[1], device=x.device))
    dout = _grad_operand(what, dout, T, C)
    dx = torch.empty_like(ops[0])
    check(_build.lib().hs_mlp_bwd_dx(*_ptrs(ops[:4] + [dout, dx]), T, C, H, int(approximate),
                                     stream(x)), what)
    return dx


def mlp_bwd_dw(x, w1, b1, w2, dout, *, approximate: bool, impl="auto"):
    """K13's weight-gradient kernel and its reductions alone (the second step of its
    launch sequence; not counted); results as ``mlp_bwd_dw_plain``."""
    if not use_kernel(x, impl):
        return mlp_bwd_dw_plain(x, w1, b1, w2, dout, approximate=approximate)
    what = "mlp_bwd_dw"
    T, C, H, ops = _operands(what, x, w1, b1, w2, torch.zeros(w2.shape[1], device=x.device))
    dout = _grad_operand(what, dout, T, C)
    dw1, dw2, red, work = _dw_outputs(x, T, C, H)
    check(_build.lib().hs_mlp_bwd_dw(*_ptrs(ops[:4] + [dout, dw1, dw2, red, work]), T, C, H,
                                     int(approximate), stream(x)), what)
    db1, db2 = red.split([H, C])
    return dw1, db1, dw2, db2


def mlp_block_fwd(x, w1, b1, w2, b2, gamma, beta, dscale, *, approximate: bool,
                  ln_eps: float = 1e-5, impl="auto"):
    """K14 wrapper (no autograd): x + dscale * LN(mlp(x)), (T, C) -> (T, C)."""
    if not use_kernel(x, impl):
        return mlp_block_plain(x, w1, b1, w2, b2, gamma, beta, dscale,
                               approximate=approximate, ln_eps=ln_eps)
    what = "mlp_block_fwd"
    T, C, H, ops = _operands(what, x, w1, b1, w2, b2, (gamma, beta))
    ds = _dscale_operand(what, dscale, T, x)
    out = torch.empty_like(ops[0])
    code = _build.lib().hs_mlp_block_fwd(*_ptrs(ops + [ds, out]), T, C, H, int(approximate),
                                         int(ds is not None), float(ln_eps), stream(x))
    check(code, what)
    _count(what, (T, C, H, bool(approximate), ds is not None))
    return out


def mlp_block_bwd(x, w1, b1, w2, b2, gamma, beta, dscale, dz, *, approximate: bool,
                  ln_eps: float = 1e-5, impl="auto"):
    """K15 wrapper: the backward of K14; results as ``mlp_block_bwd_plain``."""
    if not use_kernel(x, impl):
        return mlp_block_bwd_plain(x, w1, b1, w2, b2, gamma, beta, dscale, dz,
                                   approximate=approximate, ln_eps=ln_eps)
    what = "mlp_block_bwd"
    T, C, H, ops = _operands(what, x, w1, b1, w2, b2, (gamma, beta))
    ds = _dscale_operand(what, dscale, T, x)
    dz = _grad_operand(what, dz, T, C)
    lib = _build.lib()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(ops[0])
    dw1, dw2 = torch.empty((C, H), **f32), torch.empty((H, C), **f32)
    red = torch.empty(H + 3 * C, **f32)  # db1 | db2 | dgamma | dbeta
    work = torch.empty(lib.hs_mlp_block_bwd_workspace(T, C, H), dtype=torch.uint8,
                       device=x.device)
    code = lib.hs_mlp_block_bwd(*_ptrs(ops + [ds, dz, dx, dw1, dw2, red, work]), T, C, H,
                                int(approximate), int(ds is not None), float(ln_eps),
                                stream(x))
    check(code, what)
    _count(what, (T, C, H, bool(approximate), ds is not None))
    db1, db2, dg, dbe = red.split([H, C, C, C])
    return dx, dw1, db1, dw2, db2, dg, dbe


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
