"""K4's launch sequence on the CPU, through the plain versions of its steps, against
the JAX package.

K4 (the backward of K1, ``window_attention_qkv_epi_bwd``) runs on the card as a
sequence: K16's cosine forward recomputes o, the projection/LayerNorm backward gives du
and dbp, dgamma, dbeta, then dWp = o^T du and do = du Wp^T, then K17's cosine backward
on (x, do).  Here each step is its plain version:

- (a) ``qkv_epi_proj_ln_bwd_plain`` against ``jax.vjp`` of ``_proj_ln_fwd``, the
  forward epilogue of the Pallas kernel (u = o Wp + bp, optional LayerNorm), taken with
  a per-token bias so that its gradient is du itself;
- (b) the whole sequence ``window_attention_qkv_plain(use_cos=True)`` ->
  ``qkv_epi_proj_ln_bwd_plain`` -> ``o^T du``, ``gemm_nt_plain(du, Wp)`` ->
  ``window_attention_qkv_bwd_plain(use_cos=True)`` against the plain K4
  (``window_attention_qkv_epi_bwd_plain``) and against the VJP of the Pallas kernel
  ``fused_window_attention_qkv_epi(..., interpret=True)``: the forward and all nine
  gradients.

Operands are made with numpy from a seed, ws 16, C 32, 2 heads, as in
``test_torch_train_kernels.py``.  Tolerances, as its K4 test: float32, each result
normalized by its largest entry, forward within 2e-5 and gradients within 5e-6 (the
same f32 math in another order); bfloat16, relative L2 within 2e-3 (both sides round
at the same points and differ where an f32 sum in another order flips a rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_swin_torch.ops import window_attention as wa
from heal_swin_tpu.ops.window_attention import _proj_ln_fwd, fused_window_attention_qkv_epi

F32_FWD_TOL = 2e-5
F32_TOL = 5e-6
BF16_REL_L2 = 2e-3
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
WS, H, C, NW = 16, 2, 32, 16
T = WS * NW
SM_SCALE = 0.18
LN_EPS = 1e-5
GRADS = ("dx", "dwq", "dbq", "dwp", "dbp", "dgamma", "dbeta", "dbias", "dls")


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_close(got, want, dtype, name, f32_tol=F32_TOL):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy().reshape(want.shape)
    assert np.isfinite(got).all(), name
    if dtype == "float32":
        scale = np.abs(want).max() + 1e-12
        np.testing.assert_allclose(got / scale, want / scale, atol=f32_tol, err_msg=name)
    else:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= BF16_REL_L2, (name, err)


def _operands(seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.normal(size=(T, C)).astype(f),
        wq=(rng.normal(size=(C, 3 * C)) * 0.1).astype(f),
        bq=(rng.normal(size=(3 * C,)) * 0.1).astype(f),
        wp=(rng.normal(size=(C, C)) * 0.2).astype(f),
        bp=(rng.normal(size=(C,)) * 0.1).astype(f),
        gam=(1.0 + 0.3 * rng.normal(size=C)).astype(f),
        bet=(0.2 * rng.normal(size=C)).astype(f),
        groups=rng.integers(0, 3, (NW, WS)).astype(np.int32),
        bias=rng.normal(size=(H, WS, WS)).astype(f),
        ls=np.exp(rng.normal(size=H)).astype(f),
        dz=rng.normal(size=(T, C)).astype(f),
        o=rng.normal(size=(T, C)).astype(f),
    )


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("has_ln", [True, False])
def test_proj_ln_bwd_plain_matches_jax_vjp(has_ln, dtype):
    """The projection/LayerNorm backward: du (against the VJP's gradient of a per-token
    bias, rounded to the compute dtype as the kernel rounds du), dbp, dgamma, dbeta."""
    jdt, tdt = DTYPES[dtype]
    o = _operands(7)
    # the plain version's operands, and the same values for JAX: o, wp, bp and dz in the
    # compute dtype, gamma and beta f32; bp broadcast over the tokens
    lo = {k: jnp.asarray(o[k], jdt) for k in ("o", "wp", "bp", "dz")}

    def fn(o3, wp, bp_tok, g, be):
        return _proj_ln_fwd(o3, wp, bp_tok, g, be, has_ln=has_ln, ln_eps=LN_EPS)

    args = (lo["o"].reshape(1, T, C), lo["wp"],
            jnp.broadcast_to(lo["bp"].astype(jnp.float32), (T, C)),
            jnp.asarray(o["gam"]), jnp.asarray(o["bet"]))
    z, vjp = jax.vjp(fn, *args)
    _, _, du_f32, dg_w, dbe_w = vjp(lo["dz"].astype(jnp.float32).reshape(1, T, C))
    du_w = du_f32.astype(jdt)  # the gradient of u, rounded where the kernel rounds it
    du, dbp, dg, dbe = wa.qkv_epi_proj_ln_bwd_plain(
        _t(o["o"]).to(tdt), _t(o["wp"]).to(tdt), _t(o["bp"]).to(tdt),
        _t(o["gam"]) if has_ln else None, _t(o["dz"]).to(tdt), LN_EPS)
    assert z.shape == (1, T, C) and du.dtype == tdt and dbp.dtype == torch.float32
    _assert_close(du, du_w, dtype, "du")
    _assert_close(dbp, du_f32.sum(0), dtype, "dbp")
    if has_ln:
        _assert_close(dg, dg_w, dtype, "dgamma")
        _assert_close(dbe, dbe_w, dtype, "dbeta")
    else:
        assert dg is None and dbe is None
        assert torch.equal(du, _t(o["dz"]).to(tdt))


def _sequence(x, wq, bq, wp, bp, g, groups, bias, ls, dz, *, has_mask):
    """K4 as its launch sequence, each step's plain version.  Returns the nine
    gradients in the plain K4's order and the forward's attention output o."""
    kw = dict(ws=WS, num_heads=H, use_cos=True, sm_scale=SM_SCALE, has_mask=has_mask)
    o = wa.window_attention_qkv_plain(x, wq, bq, groups, bias, ls, **kw)
    du, dbp, dg, dbe = wa.qkv_epi_proj_ln_bwd_plain(o, wp, bp, g, dz, LN_EPS)
    dwp = o.float().t() @ du.float()
    do = wa.gemm_nt_plain(du, wp.to(x.dtype))
    dx, dwq, dbq, dbias, dls = wa.window_attention_qkv_bwd_plain(x, wq, bq, groups, bias, ls,
                                                                 do, **kw)
    return (dx, dwq, dbq, dwp, dbp, dg, dbe, dbias, dls), o


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("has_mask", [True, False])
@pytest.mark.parametrize("has_ln", [True, False])
def test_sequence_matches_plain_k4_and_pallas_vjp(has_ln, has_mask, dtype):
    """The plain sequence: its forward (o, projected and normalized) against the
    Pallas forward, and its nine gradients against the plain K4's and the Pallas
    kernel's VJP (weight and bias gradients in the compute dtype, as the JAX custom VJP
    returns them)."""
    jdt, tdt = DTYPES[dtype]
    o = _operands(5)
    low = ("x", "wq", "bq", "wp", "bp")

    def fn(x, wq, bq, wp, bp, g, b, bias, ls):
        return fused_window_attention_qkv_epi(
            x, wq, bq, wp, bp, g if has_ln else None, b if has_ln else None,
            jnp.asarray(o["groups"]), bias, ls, ws=WS, wblk=4, interpret=True, num_heads=H,
            sm_scale=SM_SCALE, has_mask=has_mask)

    args = [jnp.asarray(o[k], jdt) for k in low] + [jnp.asarray(o[k]) for k in
                                                    ("gam", "bet", "bias", "ls")]
    z_want, vjp = jax.vjp(fn, *args)
    want = vjp(jnp.asarray(o["dz"], jdt))

    x, wq, bq, wp, bp = (_t(o[k]).to(tdt) for k in low)
    g = _t(o["gam"]) if has_ln else None
    b = _t(o["bet"]) if has_ln else None
    groups, bias, ls, dz = _t(o["groups"]), _t(o["bias"]), _t(o["ls"]), _t(o["dz"]).to(tdt)
    got, o_seq = _sequence(x, wq, bq, wp, bp, g, groups, bias, ls, dz, has_mask=has_mask)
    plain = wa.window_attention_qkv_epi_bwd_plain(
        x, wq, bq, wp, bp, g, b, groups, bias, ls, dz, ws=WS, num_heads=H, sm_scale=SM_SCALE,
        has_mask=has_mask, ln_eps=LN_EPS)

    u = o_seq.float() @ wp.float() + bp.float()
    z = (wa._ln_f32(u, g, b, LN_EPS) if has_ln else u).to(tdt)
    _assert_close(z, z_want, dtype, "forward", f32_tol=F32_FWD_TOL)
    for i, (name, s, p, w) in enumerate(zip(GRADS, got, plain, want)):
        if s is None:
            assert not has_ln and name in ("dgamma", "dbeta") and p is None
            continue
        low_dtype = 1 <= i <= 4
        _assert_close(s.to(tdt) if low_dtype else s, w, dtype, name)
        _assert_close(s.to(tdt) if low_dtype else s,
                      np.asarray(p.to(tdt).float() if low_dtype else p.float()), dtype,
                      f"{name} vs plain K4")
