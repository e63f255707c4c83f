"""Float32 window-attention training: the plain versions the f32 K16/K17, K4 and K5
kernels are held to on the card, against the JAX package, and the kernels' 3xTF32
arithmetic, emulated on the CPU.

1. The f32 plain versions at the kernels' own operand shape (ws 64, head dim 32, C 64 or
   96, 3 windows), cosine and scaled-dot, with and without the mask, K4 with and without
   LayerNorm, against ``jax.vjp`` of ``fused_window_attention_qkv`` (K16/K17),
   ``fused_window_attention_qkv_epi`` (K1/K4) and ``fused_window_attention`` (K2/K5) run
   with ``interpret=True`` on the same numpy inputs: the forward within 2e-5, every
   gradient within 5e-6 of its largest entry (the same f32 math in another order).
2. The kernels' backward composed on the CPU with every product in 3xTF32
   (``ops/tf32.py``: hi/lo split, lo_a hi_b + hi_a lo_b + hi_a hi_b) at the logit-scale
   clamp (100), against the f32 plain versions: every output within the card's limit,
   relative L2 1e-5, and a single TF32 pass outside it (by more than 10x but for
   dlogit_scale).  The one
   exception is dlogit_scale: a sum over every row of every window (4,096 windows at
   stage 0) of terms <dQ, q_hat> whose signs cancel, so its relative error is the
   terms' error times their condition number sum |term| / |sum term|, which the data
   set and nothing bounds.  At the clamp the f32 plain version itself sits up to 3.2e-4
   from the float64 value in relative terms (``test_dls_f32_plain_leaves_1e5_at_the_clamp``,
   the largest of four draws), so no f32 summation order can be held to 1e-5 of another
   relative to the sum.  dlogit_scale is held to 1e-5 of the sum of its terms' magnitudes
   instead (DLS_SCALE_TOL), per head; on the card's inputs (logit scales near their
   init) it also meets 1e-5 relative, and ``chip_smoke.py`` holds it there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch.ops import tf32
from heal_swin_torch.ops import window_attention as wa
from heal_swin_tpu.ops.window_attention import (
    fused_window_attention,
    fused_window_attention_qkv,
    fused_window_attention_qkv_epi,
)

F32_FWD = dict(rtol=2e-5, atol=2e-5)
F32_GRAD = 5e-6
TOL = 1e-5  # the f32 kernels against their plain versions on the card, relative L2
DLS_SCALE_TOL = 1e-5  # dlogit_scale's error over the sum of its terms' magnitudes
WS, HD, NW = 64, 32, 3
T = WS * NW


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _operands(C, seed):
    """numpy f32 inputs at width C: tokens and qkv rows N(0, 1), weights at std C^-1/2,
    biases 0.02, LayerNorm near identity, rel-pos bias N(0, 0.5^2), 3 mask groups,
    logit scales within a factor 1.1 below 10 (the init), upstream gradients N(0, 1)."""
    rng = np.random.default_rng(seed)
    f, h = np.float32, C // HD
    return dict(
        x=rng.normal(size=(T, C)).astype(f), qkv=rng.normal(size=(T, 3 * C)).astype(f),
        wq=(rng.normal(size=(C, 3 * C)) * C ** -0.5).astype(f),
        bq=(rng.normal(size=3 * C) * 0.02).astype(f),
        wp=(rng.normal(size=(C, C)) * C ** -0.5).astype(f),
        bp=(rng.normal(size=C) * 0.02).astype(f),
        gam=(1 + 0.1 * rng.normal(size=C)).astype(f), bet=(0.1 * rng.normal(size=C)).astype(f),
        groups=rng.integers(0, 3, (NW, WS)).astype(np.int32),
        bias=(0.5 * rng.normal(size=(h, WS, WS))).astype(f),
        ls=(10.0 / (1 + 0.1 * rng.random(h))).astype(f),
        dout=rng.normal(size=(T, C)).astype(f))


def _assert_grad(got, want, name):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy().reshape(want.shape)
    assert np.isfinite(got).all(), name
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=F32_GRAD, err_msg=name)


@pytest.mark.parametrize("C,use_cos,has_mask", [(96, True, True), (96, True, False),
                                                (64, False, True), (64, False, False)])
def test_qkv_f32_plain_matches_pallas_vjp(C, use_cos, has_mask):
    """The f32 K16 and K17 plain versions: the forward, dx and the gradients of Wqkv,
    bqkv, the bias and (cosine) the logit scale."""
    o, h, j = _operands(C, C + use_cos), C // HD, jnp.asarray
    kw = dict(num_heads=h, use_cos=use_cos, sm_scale=HD ** -0.5, has_mask=has_mask)
    names = ["x", "wq", "bq", "bias"] + ["ls"] * use_cos

    def fn(*args):
        a = dict(zip(names, args))
        return fused_window_attention_qkv(a["x"], a["wq"], a["bq"], j(o["groups"]), a["bias"],
                                          a.get("ls"), ws=WS, wblk=NW, interpret=True, **kw)

    out, vjp = jax.vjp(fn, *(j(o[k]) for k in names))
    want = vjp(j(o["dout"]))
    args = (_t(o["x"]), _t(o["wq"]), _t(o["bq"]), _t(o["groups"]), _t(o["bias"]),
            _t(o["ls"]) if use_cos else None)
    np.testing.assert_allclose(wa.window_attention_qkv_plain(*args, ws=WS, **kw).numpy(),
                               np.asarray(out), **F32_FWD)
    got = wa.window_attention_qkv_bwd_plain(*args, _t(o["dout"]), ws=WS, **kw)
    assert (got[4] is None) == (not use_cos)
    for name, g, w in zip(("dx", "dwq", "dbq", "dbias", "dls"), got, want):
        _assert_grad(g, w, name)


@pytest.mark.parametrize("C,has_ln,has_mask", [(96, True, True), (96, False, False),
                                               (64, True, False), (64, False, True)])
def test_qkv_epi_f32_plain_matches_pallas_vjp(C, has_ln, has_mask):
    """The f32 K1 and K4 plain versions: the forward, dx and the gradients of Wqkv,
    bqkv, Wp, bp, the LayerNorm's gamma and beta, the bias and the logit scale."""
    o, h, j = _operands(C, C + 7), C // HD, jnp.asarray
    kw = dict(num_heads=h, sm_scale=1.0, has_mask=has_mask)
    names = ("x", "wq", "bq", "wp", "bp", "gam", "bet", "bias", "ls")

    def fn(x, wq, bq, wp, bp, g, b, bias, ls):
        return fused_window_attention_qkv_epi(
            x, wq, bq, wp, bp, g if has_ln else None, b if has_ln else None, j(o["groups"]),
            bias, ls, ws=WS, wblk=NW, interpret=True, **kw)

    out, vjp = jax.vjp(fn, *(j(o[k]) for k in names))
    want = vjp(j(o["dout"]))
    args = [_t(o[k]) for k in names]
    if not has_ln:
        args[5] = args[6] = None
    args.insert(7, _t(o["groups"]))
    np.testing.assert_allclose(wa.window_attention_qkv_epi_plain(*args, ws=WS, **kw).numpy(),
                               np.asarray(out), **F32_FWD)
    got = wa.window_attention_qkv_epi_bwd_plain(*args, _t(o["dout"]), ws=WS, **kw)
    for name, g, w in zip(("dx", "dwq", "dbq", "dwp", "dbp", "dgamma", "dbeta", "dbias", "dls"),
                          got, want):
        if g is None:
            assert not has_ln and name in ("dgamma", "dbeta")
            continue
        _assert_grad(g, w, name)


@pytest.mark.parametrize("C,use_cos,has_mask", [(96, True, True), (64, True, False),
                                                (96, False, True), (64, False, False)])
def test_attention_f32_plain_matches_pallas_vjp(C, use_cos, has_mask):
    """The f32 K2 and K5 plain versions: the forward, dqkv, dbias and (cosine)
    dlogit_scale."""
    o, h, j = _operands(C, C + 11), C // HD, jnp.asarray
    kw = dict(num_heads=h, use_cos=use_cos, sm_scale=HD ** -0.5, has_mask=has_mask)

    def fn(qkv, bias, ls):
        return fused_window_attention(qkv, j(o["groups"]), bias, ls if use_cos else None,
                                      ws=WS, wblk=NW, interpret=True, **kw)

    out, vjp = jax.vjp(fn, j(o["qkv"]), j(o["bias"]), j(o["ls"]))
    want = vjp(j(o["dout"]))
    args = (_t(o["qkv"]), _t(o["groups"]), _t(o["bias"]), _t(o["ls"]) if use_cos else None)
    np.testing.assert_allclose(wa.window_attention_plain(*args, ws=WS, **kw).numpy(),
                               np.asarray(out), **F32_FWD)
    got = wa.window_attention_bwd_plain(*args, _t(o["dout"]), ws=WS, **kw)
    assert got[0].dtype == torch.float32 and (got[2] is None) == (not use_cos)
    for name, g, w in zip(("dqkv", "dbias", "dls"), got, want):
        if g is not None:
            _assert_grad(g, w, name)


# --------------------------------------------------- the kernels' arithmetic, emulated


def _core(q, k, v, do, groups, bias, ls, *, use_cos, sm_scale, masked, mm):
    """The f32 K5 core (``attn_bwd_3xtf32_kernel``) on (nw, h, ws, hd) operands with every
    product through ``mm``: P as the forward computes it (e = exp(s - row max), times
    1 / sum), dP = dO V^T, dS = P (dP - rowsum(dP P)), dQ = dS K, dV = P^T dO, dK = dS^T
    Q, the cosine normalization's backward.  Returns dq, dk, dv, dbias, and for cosine
    dls and the sum of its terms' magnitudes (h,), else None, None."""
    if use_cos:
        uq = torch.rsqrt(torch.clamp_min((q * q).sum(-1, keepdim=True), 1e-24))
        uk = torch.rsqrt(torch.clamp_min((k * k).sum(-1, keepdim=True), 1e-24))
        scale = ls.reshape(1, -1, 1, 1)
        qs, ks = q * (uq * scale), k * uk
    else:
        qs, ks = q, k
    s = mm(qs, ks.transpose(-1, -2))
    if not use_cos:
        s = s * sm_scale
    s = s + bias[None]
    if masked:
        s = s + wa._mask(groups).to(s.dtype)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e * (1 / torch.clamp_min(e.sum(-1, keepdim=True), 1e-30))
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    aq, bk = mm(ds, ks), mm(ds.transpose(-1, -2), qs)
    dv = mm(p.transpose(-1, -2), do)
    if not use_cos:
        return aq * sm_scale, bk * sm_scale, dv, ds.sum(0), None, None
    qh, kh = q * uq, k * uk
    rq, rk = (aq * qh).sum(-1, keepdim=True), (bk * kh).sum(-1, keepdim=True)
    return ((aq - qh * rq) * (uq * scale), (bk - kh * rk) * uk, dv, ds.sum(0),
            rq.sum((0, 2, 3)), rq.abs().sum((0, 2, 3)))


def _split(rows, nw, h):
    """(T, n C) rows -> n (nw, h, ws, hd) parts."""
    n = rows.shape[1] // (h * HD)
    return rows.reshape(nw, WS, n, h, HD).permute(2, 0, 3, 1, 4)


def _rows(*parts):
    """(nw, h, ws, hd) parts -> (T, n C) rows."""
    nw, h = parts[0].shape[:2]
    return torch.stack([p.permute(0, 2, 1, 3) for p in parts], 2).reshape(nw * WS, -1)


def _k5(qkv, dout, groups, bias, ls, *, h, use_cos, masked, mm):
    """The f32 K5: (dqkv, dbias, dls), and the sum of dls's terms' magnitudes."""
    nw = qkv.shape[0] // WS
    q, k, v = _split(qkv, nw, h)
    dq, dk, dv, dbias, dls, mag = _core(q, k, v, _split(dout, nw, h)[0], groups, bias, ls,
                                        use_cos=use_cos, sm_scale=HD ** -0.5, masked=masked,
                                        mm=mm)
    return (_rows(dq, dk, dv), dbias, dls), mag


def _k4(x, wq, bq, wp, bp, gam, groups, bias, ls, dz, *, h, masked, mm):
    """The f32 K4 launch sequence: K16 (qkv, o), the projection/LayerNorm backward (u
    recomputed), dWp = o^T du, do = du Wp^T, then K17 from K16's qkv: the core, dbqkv,
    dWqkv = x^T dqkv, dx = dqkv Wqkv^T.  Returns K4's outputs in
    ``window_attention_qkv_epi_bwd_plain``'s order, and the sum of dls's terms'
    magnitudes."""
    nw = x.shape[0] // WS
    qkv = mm(x, wq) + bq
    q, k, v = _split(qkv, nw, h)
    uq = torch.rsqrt(torch.clamp_min((q * q).sum(-1, keepdim=True), 1e-24))
    uk = torch.rsqrt(torch.clamp_min((k * k).sum(-1, keepdim=True), 1e-24))
    s = mm(q * (uq * ls.reshape(1, -1, 1, 1)), (k * uk).transpose(-1, -2)) + bias[None]
    if masked:
        s = s + wa._mask(groups).to(s.dtype)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = _rows(mm(e, v) * (1 / torch.clamp_min(e.sum(-1, keepdim=True), 1e-30)))
    if gam is not None:
        u = mm(o, wp) + bp
        uc = u - u.mean(-1, keepdim=True)
        rstd = torch.rsqrt((uc * uc).mean(-1, keepdim=True) + 1e-5)
        xh = uc * rstd
        dg = dz * gam
        du = rstd * (dg - dg.mean(-1, keepdim=True) - xh * (dg * xh).mean(-1, keepdim=True))
        dgam, dbet = (dz * xh).sum(0), dz.sum(0)
    else:
        du, dgam, dbet = dz, None, None
    dwp, dout = mm(o.t(), du), mm(du, wp.t())
    dq, dk, dv, dbias, dls, mag = _core(q, k, v, _split(dout, nw, h)[0], groups, bias, ls,
                                        use_cos=True, sm_scale=1.0, masked=masked, mm=mm)
    dqkv = _rows(dq, dk, dv)
    return (mm(dqkv, wq.t()), mm(x.t(), dqkv), dqkv.sum(0), dwp, du.sum(0), dgam, dbet, dbias,
            dls), mag


def _rel(got, want):
    return float(torch.linalg.vector_norm(got.double() - want.double())
                 / torch.linalg.vector_norm(want.double()))


def _dls_err(got, want, mag):
    """dls's error per head over the sum of its terms' magnitudes, the largest head."""
    return float(((got.double() - want.double()).abs() / mag.double()).max())


@functools.lru_cache(maxsize=None)
def _k5_case(use_cos, masked, seed):
    """K5 at the clamp over 4,096 windows of one head (T 262,144, C 32: the stage-0 window
    count): the f32 plain version, the float64 composition (and its dls terms'
    magnitudes), and the 3xTF32 and TF32 emulations."""
    rng = np.random.default_rng(seed)
    nw, h = 4096, 1
    qkv = rng.normal(size=(nw * WS, 3 * HD)).astype(np.float32)
    dout = rng.normal(size=(nw * WS, HD)).astype(np.float32)
    groups = torch.from_numpy(rng.integers(0, 3, (nw, WS)).astype(np.int32))
    bias = (0.5 * rng.normal(size=(h, WS, WS))).astype(np.float32)
    ls = np.full(h, 100.0, np.float32)
    plain = wa.window_attention_bwd_plain(
        _t(qkv), groups, _t(bias), _t(ls) if use_cos else None, _t(dout), ws=WS, num_heads=h,
        use_cos=use_cos, sm_scale=HD ** -0.5, has_mask=masked)
    kw = dict(h=h, use_cos=use_cos, masked=masked)
    f64, mag = _k5(*(_t(a).double() for a in (qkv, dout)), groups, _t(bias).double(),
                   _t(ls).double(), mm=torch.matmul, **kw)
    args = (_t(qkv), _t(dout), groups, _t(bias), _t(ls))
    return (plain, f64, mag, _k5(*args, mm=tf32.matmul_3xtf32, **kw)[0],
            _k5(*args, mm=tf32.matmul_tf32, **kw)[0])


K5_CLAMP = [(True, True, 0), (True, True, 1), (True, False, 1), (False, True, 0)]


@pytest.mark.parametrize("use_cos,masked,seed", K5_CLAMP)
def test_k5_3xtf32_at_the_clamp(use_cos, masked, seed):
    """The f32 K5's arithmetic at the clamp over 4,096 windows: dqkv and dbias within 1e-5
    of the f32 plain version in 3xTF32 and outside 1e-4 in one TF32 pass; dlogit_scale
    within DLS_SCALE_TOL of the plain version over its terms' magnitudes in 3xTF32, and
    outside it in one pass."""
    plain, _, mag, three, one = _k5_case(use_cos, masked, seed)
    assert (plain[2] is None) == (not use_cos)
    for name, p, a, b in zip(("dqkv", "dbias"), plain, three, one):
        assert _rel(a, p) <= TOL, (name, _rel(a, p))
        assert _rel(b, p) > 10 * TOL, (name, _rel(b, p))
    if use_cos:
        assert _dls_err(three[2], plain[2], mag) <= DLS_SCALE_TOL, _dls_err(three[2], plain[2], mag)
        assert _dls_err(one[2], plain[2], mag) > DLS_SCALE_TOL, _dls_err(one[2], plain[2], mag)


def test_dls_f32_plain_leaves_1e5_at_the_clamp():
    """The figure behind dlogit_scale's limit: over the cosine draws at the clamp the f32
    plain version's dls is more than 1e-5 (relative) from the float64 value in the worst
    draw, while its error over the terms' magnitudes stays within DLS_SCALE_TOL in every
    draw: the relative error is the sum's condition number at work, not the f32 terms."""
    rel, scaled = [], []
    for use_cos, masked, seed in K5_CLAMP:
        if use_cos:
            plain, f64, mag, _, _ = _k5_case(use_cos, masked, seed)
            rel.append(_rel(plain[2], f64[2]))
            scaled.append(_dls_err(plain[2], f64[2], mag))
    assert max(rel) > TOL, rel
    assert max(scaled) <= DLS_SCALE_TOL, scaled


@pytest.mark.parametrize("has_ln,masked", [(True, True), (False, False)])
def test_k4_k17_3xtf32_at_the_clamp(has_ln, masked):
    """The f32 K4's arithmetic (and so K16's and K17's, its steps) at the clamp, 256
    windows at C 64: every output within 1e-5 of the f32 plain version in 3xTF32 (dls
    over its terms' magnitudes), and every output that goes through a product outside
    ten times that in one TF32 pass (dls: outside it; dbeta, and dbp without LayerNorm,
    are column sums of dz: no product)."""
    rng = np.random.default_rng(50 + has_ln)
    nw, C = 256, 64
    h, n = C // HD, nw * WS
    f = np.float32
    a = dict(x=rng.normal(size=(n, C)), wq=rng.normal(size=(C, 3 * C)) * C ** -0.5,
             bq=rng.normal(size=3 * C) * 0.02, wp=rng.normal(size=(C, C)) * C ** -0.5,
             bp=rng.normal(size=C) * 0.02, gam=1 + 0.1 * rng.normal(size=C),
             bet=0.1 * rng.normal(size=C), bias=0.5 * rng.normal(size=(h, WS, WS)),
             ls=np.full(h, 100.0), dz=rng.normal(size=(n, C)))
    a = {k: _t(v.astype(f)) for k, v in a.items()}
    groups = torch.from_numpy(rng.integers(0, 3, (nw, WS)).astype(np.int32))
    gam = a["gam"] if has_ln else None
    plain = wa.window_attention_qkv_epi_bwd_plain(
        a["x"], a["wq"], a["bq"], a["wp"], a["bp"], gam, a["bet"] if has_ln else None, groups,
        a["bias"], a["ls"], a["dz"], ws=WS, num_heads=h, sm_scale=1.0, has_mask=masked)
    args = (a["x"], a["wq"], a["bq"], a["wp"], a["bp"], gam, groups, a["bias"], a["ls"], a["dz"])
    _, mag = _k4(*(None if t is None else t.double() for t in args[:6]), groups,
                 *(t.double() for t in args[7:]), h=h, masked=masked, mm=torch.matmul)
    three, _ = _k4(*args, h=h, masked=masked, mm=tf32.matmul_3xtf32)
    one, _ = _k4(*args, h=h, masked=masked, mm=tf32.matmul_tf32)
    names = ("dx", "dwq", "dbq", "dwp", "dbp", "dgamma", "dbeta", "dbias", "dls")
    for name, p, x3, x1 in zip(names, plain, three, one):
        if p is None:
            assert not has_ln and name in ("dgamma", "dbeta")
            continue
        if name == "dls":
            assert _dls_err(x3, p, mag) <= DLS_SCALE_TOL, _dls_err(x3, p, mag)
            assert _dls_err(x1, p, mag) > DLS_SCALE_TOL, _dls_err(x1, p, mag)
            continue
        assert _rel(x3, p) <= TOL, (name, _rel(x3, p))
        if name == "dbeta" or (name == "dbp" and not has_ln):
            continue
        assert _rel(x1, p) > 10 * TOL, (name, _rel(x1, p))
