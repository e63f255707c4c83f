"""The arithmetic of the f32 window-attention kernels, held against the JAX package.

The f32 K1 and K2 (``csrc/window_attention_f32.cu``) run every product on the tensor
cores in 3xTF32 (``heal_swin_torch.ops.tf32``).  Here their functions are composed on the
CPU with every product through ``matmul_3xtf32`` -- f32 K1: the qkv projection, the
scores, E V (normalized after the product, as the kernel) and the output projection;
f32 K2: the scores and E V -- and held to the Pallas kernels
(``fused_window_attention_qkv_epi`` / ``fused_window_attention``) with f32 operands in
interpret mode and to the JAX package's jnp reference
(``reference_window_attention``), at ws 64 and head dim 32, logit scales at init (10) and
at the clamp (100).  The limit is the kernels' own on the card, relative L2 1e-5.  The
same composition with a single TF32 pass (``matmul_tf32``) misses it: those cases assert
the miss, so that the test guards the choice of 3xTF32.  At the clamp the Pallas cosine
kernels lose rows to f32 underflow (``_static_bound_rows``), so there they are held on
the rows they compute and the reference on all.
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
    fused_window_attention_qkv_epi,
    reference_window_attention,
)

TOL = 1e-5  # F32_TAIL_TOL of chip_smoke.py: the f32 kernels against their plain versions
WS, HD, NW = 64, 32, 3  # window, head dim, windows
MATMULS = {3: tf32.matmul_3xtf32, 1: tf32.matmul_tf32}


@functools.lru_cache(maxsize=None)
def _operands(C, scale, seed):
    """numpy inputs: x (NW ws, C) and qkv rows (NW ws, 3C) ~ N(0, 1), weights at
    std C^-1/2, biases 0.02, LayerNorm near identity, rel-pos bias N(0, 0.5^2),
    3 mask groups, logit scales within a factor 1.1 below ``scale``."""
    rng = np.random.default_rng(seed)
    f, h, T = np.float32, C // HD, NW * WS
    return dict(
        x=rng.normal(size=(T, C)).astype(f), qkv=rng.normal(size=(T, 3 * C)).astype(f),
        wq=(rng.normal(size=(C, 3 * C)) * C ** -0.5).astype(f),
        bq=(rng.normal(size=3 * C) * 0.02).astype(f),
        wp=(rng.normal(size=(C, C)) * C ** -0.5).astype(f),
        bp=(rng.normal(size=C) * 0.02).astype(f),
        gam=(1 + 0.1 * rng.normal(size=C)).astype(f), bet=(0.1 * rng.normal(size=C)).astype(f),
        groups=rng.integers(0, 3, (NW, WS)).astype(np.int32),
        bias=(0.5 * rng.normal(size=(h, WS, WS))).astype(f),
        ls=(scale / (1 + 0.1 * rng.random(h))).astype(f))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _attention(qkv, groups, bias, ls, *, h, use_cos, sm_scale, masked, mm):
    """K2's function with every product through ``mm``; (T, 3C) -> (T, C) f32."""
    T = qkv.shape[0]
    q, k, v = qkv.reshape(T // WS, WS, 3, h, HD).permute(2, 0, 3, 1, 4)  # (nw, h, ws, hd)
    if use_cos:  # q * (rsqrt(|q|^2) * scale), k * rsqrt(|k|^2), as the kernel
        iq = torch.rsqrt(torch.clamp_min((q * q).sum(-1, keepdim=True), 1e-24))
        q = q * (iq * ls.reshape(1, h, 1, 1))
        k = k * torch.rsqrt(torch.clamp_min((k * k).sum(-1, keepdim=True), 1e-24))
    s = mm(q, k.transpose(-1, -2))
    if not use_cos:
        s = s * sm_scale
    s = s + bias[None]
    if masked:
        s = s + wa._mask(groups)
    e = torch.exp(s - s.amax(-1, keepdim=True))  # normalized after E V, as the kernel
    o = mm(e, v) * (1 / torch.clamp_min(e.sum(-1, keepdim=True), 1e-30))
    return o.permute(0, 2, 1, 3).reshape(T, h * HD)


def _epi(x, wq, bq, wp, bp, gam, bet, groups, bias, ls, *, h, masked, mm):
    """f32 K1's function with every product through ``mm``: [LN](attn(x Wqkv + b) Wp + bp)."""
    qkv = mm(x, wq) + bq
    o = _attention(qkv, groups, bias, ls, h=h, use_cos=True, sm_scale=1.0, masked=masked,
                   mm=mm)
    return wa._ln_f32(mm(o, wp) + bp, gam, bet, 1e-5)


def _static_bound_rows(o, kernel, h, use_cos, masked):
    """The token rows on which the Pallas cosine kernels' softmax loses no key that counts.

    Those kernels shift the scores by a static bound, max(bias) + logit scale, and not by
    the row max (``_shift_bias``).  At the clamp (scale 100) a row whose best key has a
    cosine well below 1 then sits ~90 below the bound, and exp of it, under f32's smallest
    normal (e^-87.3), is flushed to 0: the row's keys drop out, the whole row where the
    best one does.  The port shifts by the row max and keeps them.  Rows where the best
    key of any head sits within 20 of the flush (e^-20 ~ 2e-9: 64 flushed keys move the
    result by < 1e-6) are left out of the comparison; at init (scale 10) none is."""
    if not use_cos:
        return np.ones(NW * WS, bool)
    f = np.float64
    x = o["qkv"].astype(f) if kernel == "K2" else o["x"].astype(f) @ o["wq"] + o["bq"]
    q, k = (x.reshape(NW, WS, 3, h, HD)[:, :, i] for i in (0, 1))
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    s = np.einsum("wihd,wjhd->whij", q, k) * o["ls"][:, None, None] + o["bias"]
    if masked:
        g = o["groups"]
        s = s + np.where(g[:, :, None] != g[:, None, :], -100.0, 0.0)[:, None]
    bound = (o["bias"].max((1, 2)) + o["ls"])[:, None, None]
    top = (s - bound).max(-1)  # (nw, h, ws): the row's best key against the bound
    return (top > np.log(np.finfo(np.float32).tiny) + 20).all(1).reshape(-1)


def _jax_reference(kernel, o, h, use_cos, masked):
    """The JAX package's jnp attention (``reference_window_attention``, softmax shifted
    by the row max), for K1 between jnp products and LayerNorm in f32 as the Pallas K1
    composes them."""
    j, hi = jnp.asarray, jax.lax.Precision.HIGHEST
    kw = dict(ws=WS, num_heads=h, has_mask=masked)
    if kernel == "K2":
        return np.asarray(reference_window_attention(
            j(o["qkv"]), j(o["groups"]), j(o["bias"]), j(o["ls"]) if use_cos else None,
            use_cos=use_cos, sm_scale=HD ** -0.5, **kw))
    qkv = jnp.dot(j(o["x"]), j(o["wq"]), precision=hi) + j(o["bq"])
    a = reference_window_attention(qkv, j(o["groups"]), j(o["bias"]), j(o["ls"]),
                                   use_cos=True, sm_scale=1.0, **kw)
    u = jnp.dot(a, j(o["wp"]), precision=hi) + j(o["bp"])
    uc = u - u.mean(-1, keepdims=True)
    y = uc * jax.lax.rsqrt((uc * uc).mean(-1, keepdims=True) + 1e-5) * j(o["gam"]) + j(o["bet"])
    return np.asarray(y)


@functools.lru_cache(maxsize=None)
def _references(kernel, C, scale, use_cos, masked):
    """The Pallas kernel's f32 result in interpret mode, the rows it computes without
    underflow (``_static_bound_rows``), the JAX package's jnp reference, the operands."""
    o = _operands(C, scale, C + int(scale))
    h, j = C // HD, jnp.asarray
    kw = dict(ws=WS, num_heads=h, has_mask=masked, wblk=NW, interpret=True)
    if kernel == "K1":
        out = fused_window_attention_qkv_epi(
            j(o["x"]), j(o["wq"]), j(o["bq"]), j(o["wp"]), j(o["bp"]), j(o["gam"]),
            j(o["bet"]), j(o["groups"]), j(o["bias"]), j(o["ls"]), sm_scale=1.0, **kw)
    else:
        out = fused_window_attention(j(o["qkv"]), j(o["groups"]), j(o["bias"]),
                                     j(o["ls"]) if use_cos else None, use_cos=use_cos,
                                     sm_scale=HD ** -0.5, **kw)
    return (np.asarray(out, np.float32), _static_bound_rows(o, kernel, h, use_cos, masked),
            _jax_reference(kernel, o, h, use_cos, masked), o)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# (kernel, C, logit scale, cosine, masked, TF32 passes): 3xTF32 within the limit at
# every shape; one pass outside it
CASES = ([("K1", C, s, True, m, 3) for C in (96, 384) for s in (10.0, 100.0)
          for m in (False, True)]
         + [("K2", C, s, True, m, 3) for C in (96, 384, 768) for s in (10.0, 100.0)
            for m in (False, True)]
         + [("K2", C, 10.0, False, m, 3) for C in (96, 768) for m in (False, True)]
         + [("K1", 96, s, True, True, 1) for s in (10.0, 100.0)]
         + [("K2", 768, 100.0, True, True, 1), ("K2", 768, 10.0, False, True, 1)])


@pytest.mark.parametrize("kernel,C,scale,use_cos,masked,passes", CASES)
def test_tf32_split_matches_pallas(kernel, C, scale, use_cos, masked, passes):
    """Within 1e-5 of the Pallas kernel on every row it computes without underflow (all
    rows at init) and of the JAX package's jnp reference on every row; one TF32 pass
    outside 1e-4 of the reference."""
    pallas, rows, ref, o = _references(kernel, C, scale, use_cos, masked)
    h, mm = C // HD, MATMULS[passes]
    if kernel == "K1":
        got = _epi(*(_t(o[k]) for k in ("x", "wq", "bq", "wp", "bp", "gam", "bet", "groups",
                                        "bias", "ls")), h=h, masked=masked, mm=mm)
    else:
        got = _attention(_t(o["qkv"]), _t(o["groups"]), _t(o["bias"]), _t(o["ls"]), h=h,
                         use_cos=use_cos, sm_scale=HD ** -0.5, masked=masked, mm=mm)
    got = got.numpy()
    err = _rel_l2(got, ref)
    if passes == 1:  # the error 3xTF32 exists to remove
        assert err > 10 * TOL, err
        return
    assert err <= TOL, err
    if scale == 10.0:
        assert rows.all()
    if rows.any():
        assert _rel_l2(got[rows], pallas[rows]) <= TOL


def test_round_tf32_bits():
    """round_tf32 keeps 10 mantissa bits, rounds to nearest with ties away from zero,
    keeps inf and NaN; truncate_tf32 rounds toward zero; split_tf32's parts are TF32
    values that sum to x within 2^-21 |x|."""
    one = 1.0 + 2.0 ** -10
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      one + 2.0 ** -11, float("inf"), float("nan"), 0.0])
    r = tf32.round_tf32(x)
    assert r[:4].tolist() == [one, -one, 1.0, one + 2.0 ** -10]
    assert r[4] == float("inf") and r[5].isnan() and r[6] == 0.0
    assert not (r[:4].view(torch.int32) & 0x1FFF).any()
    y = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    assert tf32.truncate_tf32(x[:4]).tolist() == [1.0, -1.0, 1.0, one]
    hi, lo = tf32.split_tf32(y)
    assert not ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).any()
    assert ((hi + lo - y).abs() <= 2.0 ** -21 * y.abs()).all()


def test_gemm_nn_f32_runs_its_plain_twin_on_the_cpu():
    """The f32 K1's product step on CPU tensors is its plain twin (f32 matmul + bias);
    "pallas" demands the kernel and raises."""
    rng = np.random.default_rng(1)
    a, b, bias = (_t(rng.normal(size=s).astype(np.float32)) for s in ((128, 64), (64, 100),
                                                                     (100,)))
    assert torch.equal(wa.gemm_nn_f32(a, b, bias), a @ b + bias)
    assert torch.equal(wa.gemm_nn_f32(a, b), wa.gemm_nn_f32_plain(a, b))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        wa.gemm_nn_f32(a, b, impl="pallas")


@pytest.mark.parametrize("kernel,C,masked,dropped,above", [("K1", 96, False, 52, 0.1),
                                                           ("K1", 96, True, 152, 0.4),
                                                           ("K2", 768, True, 192, 0.4)])
def test_pallas_static_shift_loses_rows_at_the_clamp(kernel, C, masked, dropped, above):
    """The JAX-package fault the port must not copy: at logit scale 100 the Pallas cosine
    kernels' static softmax shift flushes ``dropped`` of the 192 rows to f32 underflow
    (``_static_bound_rows``), and their result leaves the JAX package's jnp reference by
    more than ``above`` relative L2; the port's plain version, shifted by the row max,
    stays within 1e-5 of the reference."""
    pallas, rows, ref, o = _references(kernel, C, 100.0, True, masked)
    assert int((~rows).sum()) == dropped
    assert _rel_l2(pallas, ref) > above
    h = C // HD
    if kernel == "K1":
        plain = wa.window_attention_qkv_epi_plain(
            *(_t(o[k]) for k in ("x", "wq", "bq", "wp", "bp", "gam", "bet")),
            _t(o["groups"]) if masked else None, _t(o["bias"]), _t(o["ls"]), ws=WS,
            num_heads=h, sm_scale=1.0, has_mask=masked)
    else:
        plain = wa.window_attention_plain(_t(o["qkv"]), _t(o["groups"]), _t(o["bias"]),
                                          _t(o["ls"]), ws=WS, num_heads=h, use_cos=True,
                                          sm_scale=1.0, has_mask=masked)
    assert _rel_l2(plain.numpy(), ref) <= TOL
